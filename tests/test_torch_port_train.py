"""The Pipeline-A training step of the PyTorch port against JAX.

On the CPU, in float32 on both sides:

- ``unsupervised_loss(training=True)`` and ``supervised_loss`` (with
  ``SupervisedPart`` from converted params): values (rtol 1e-4) and
  gradients against ``jax.grad`` of the JAX losses on their XLA path, at
  B=2, V=2, K=2, N=256, S=32 with one numpy keep mask.  Gradient tolerance
  atol 1e-4 * max|ref|, rtol 1e-4 per array (read: at most 3.0e-6 of
  max|ref|).
- The learner from converted JAX params with keep-prob pinned to 1: the
  step-0 parameter gradients against ``jax.grad`` of the JAX ``_loss_fn``
  (same tolerance; read 2.5e-5 of max|ref|), and the losses of 3
  ``train_step`` calls against the JAX learner's (rtol 1e-3, read 3.1e-4;
  Adam's g / (|g| + eps) is steep where a gradient is near 0, so parameters
  are not compared after a step).
- One ``torch.optim.AdamW`` update against one ``optax.adamw`` update on
  identical gradient arrays (atol 1e-6, read 3e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from im23d_tpu.data.synthetic import SyntheticSilhouettes as JSynthetic
from im23d_tpu.losses.effective import supervised_loss as j_supervised
from im23d_tpu.losses.effective import unsupervised_loss as j_unsupervised
from im23d_tpu.models.pointcloud_nets import SupervisedPart as JSupervised
from im23d_tpu.train.shapenet_learner import ShapeNetConfig as JConfig
from im23d_tpu.train.shapenet_learner import ShapeNetLearner as JLearner
from im23d_tpu_torch.core.convert import (
    supervised_part_state_dict,
    unsupervised_part_state_dict,
)
from im23d_tpu_torch.losses.effective import supervised_loss, unsupervised_loss
from im23d_tpu_torch.models.pointcloud_nets import SupervisedPart
from im23d_tpu_torch.train.shapenet_learner import (
    ShapeNetConfig,
    ShapeNetLearner,
)

B, V, K, N, S, H = 2, 2, 2, 256, 32, 64
SIGMA = 1.1
RTOL = 1e-4


def _close(got, ref, rtol=RTOL):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=1e-4 * float(np.abs(ref).max()))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _loss_inputs(seed=0):
    rng = np.random.RandomState(seed)
    outputs = dict(
        point_cloud=((rng.rand(B, N, 3) - 0.5) * 0.7).astype(np.float32),
        scale=(0.3 + 0.6 * rng.rand(B, 1)).astype(np.float32),
        ensemble_q=rng.randn(B * V, K, 4).astype(np.float32),
        student_q=rng.randn(B * V, 4).astype(np.float32),
    )
    masks = rng.rand(B * V, H, H).astype(np.float32)
    keep = (rng.rand(B, N) > 0.4).astype(np.float32)
    return outputs, masks, keep


def test_unsupervised_loss_gradients_match_jax():
    outputs, masks, keep = _loss_inputs()
    names = tuple(outputs)

    def j_total(*arrays):
        losses, aux = j_unsupervised(
            dict(zip(names, arrays)), jnp.asarray(masks), jnp.float32(SIGMA),
            jnp.asarray(keep), V, voxel_size=S, training=True)
        return losses["total_loss"], (losses, aux["min_indexes"])

    (_, (ref_l, ref_idx)), ref_g = jax.value_and_grad(
        j_total, argnums=tuple(range(4)), has_aux=True
    )(*(jnp.asarray(outputs[k]) for k in names))

    ins = {k: torch.from_numpy(v).requires_grad_() for k, v in outputs.items()}
    losses, aux = unsupervised_loss(ins, torch.from_numpy(masks),
                                    torch.tensor(SIGMA), torch.from_numpy(keep),
                                    V, voxel_size=S, training=True)
    losses["total_loss"].backward()
    for k in ref_l:
        np.testing.assert_allclose(float(losses[k].detach()), float(ref_l[k]),
                                   rtol=RTOL)
    np.testing.assert_array_equal(aux["min_indexes"].numpy(),
                                  np.asarray(ref_idx))
    for k, g in zip(names, ref_g):
        _close(ins[k].grad.numpy(), g)
    # only the argmin heads get a projection gradient
    eq = ins["ensemble_q"].grad.numpy()
    picked = np.zeros((B * V, K), bool)
    picked[np.arange(B * V), aux["min_indexes"].numpy()] = True
    assert np.all(eq[~picked] == 0) and np.abs(eq[picked]).max() > 0


def test_supervised_loss_and_model_gradients_match_jax():
    rng = np.random.RandomState(4)
    images = rng.rand(B, H, H, 3).astype(np.float32)
    poses = rng.randn(B * V, 4).astype(np.float32)
    masks = rng.rand(B * V, H, H).astype(np.float32)
    keep = (rng.rand(B, N) > 0.4).astype(np.float32)
    jm = JSupervised(num_points=N)
    params = jm.init(jax.random.PRNGKey(3), jnp.asarray(images))

    def j_total(prm):
        losses, _ = j_supervised(jm.apply(prm, jnp.asarray(images)),
                                 jnp.asarray(poses), jnp.asarray(masks),
                                 jnp.float32(SIGMA), jnp.asarray(keep), V,
                                 voxel_size=S)
        return losses["total_loss"]

    ref_loss, ref_g = jax.jit(jax.value_and_grad(j_total))(params)

    model = SupervisedPart(image_size=H, num_points=N)
    model.load_state_dict(supervised_part_state_dict(_np_tree(params)))
    losses, aux = supervised_loss(model(torch.from_numpy(images)),
                                  torch.from_numpy(poses),
                                  torch.from_numpy(masks), torch.tensor(SIGMA),
                                  torch.from_numpy(keep), V, voxel_size=S)
    losses["total_loss"].backward()
    np.testing.assert_allclose(float(losses["total_loss"].detach()),
                               float(ref_loss), rtol=RTOL)
    assert aux["projection"].shape == (B * V, S, S)
    want = supervised_part_state_dict(_np_tree(ref_g))
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert set(grads) == set(want)
    for k, g in want.items():
        _close(grads[k].numpy(), g.numpy())


def _learners():
    fields = dict(image_size=H, voxel_size=S, num_points=N, num_views=V,
                  num_candidates=K, batch_size=B, p_schedule=(1.0, 1.0))
    jl = JLearner(JConfig(**fields))
    port = ShapeNetLearner(ShapeNetConfig(**fields), device="cpu")
    port.load_params(_np_tree(jl.state.params))
    return jl, port


def test_learner_step0_gradients_match_jax():
    jl, port = _learners()
    batch = JSynthetic(B, H, V, n_points=128, seed=3).next_batch()
    p, sigma = jl._schedules(jnp.int32(0))
    ref_g = jax.jit(jax.grad(
        lambda prm: jl._loss_fn(prm, {k: jnp.asarray(v)
                                      for k, v in batch.items()},
                                jax.random.PRNGKey(0), p, sigma, True)[0]
    ))(jl.state.params)
    port.train_step(batch)
    want = unsupervised_part_state_dict(_np_tree(ref_g), K)
    grads = {k: q.grad for k, q in port.model.named_parameters()}
    assert set(grads) == set(want)
    for k, g in want.items():
        _close(grads[k].numpy(), g.numpy())


def test_learner_three_step_losses_match_jax():
    jl, port = _learners()
    data = JSynthetic(B, H, V, n_points=128, seed=8)
    for _ in range(3):
        batch = data.next_batch()
        ref = jl.train_step(batch)
        got = port.train_step(batch)
        for k in ref:
            np.testing.assert_allclose(float(got[k]), float(ref[k]),
                                       rtol=1e-3)
    assert port.step == int(jl.state.step) == 3


def test_adamw_update_matches_optax():
    rng = np.random.RandomState(9)
    shapes = {"w": (5, 7), "b": (7,), "k": (3, 3, 2, 4)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads["b"][:3] = 0.0       # exact zeros and near-zeros: Adam's steep
    grads["w"][0] = 1e-9       # region around g = 0
    lr, wd = 1e-3, 1e-3

    tx = optax.adamw(lr, weight_decay=wd)
    upd, _ = tx.update({k: jnp.asarray(v) for k, v in grads.items()},
                       tx.init({k: jnp.asarray(v) for k, v in params.items()}),
                       {k: jnp.asarray(v) for k, v in params.items()})
    ref = optax.apply_updates({k: jnp.asarray(v) for k, v in params.items()},
                              upd)

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = torch.optim.AdamW(tp.values(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=wd)
    for k, p in tp.items():
        p.grad = torch.from_numpy(grads[k])
    opt.step()
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(ref[k]),
                                   atol=1e-6, rtol=0)


@pytest.mark.parametrize("device_batch", [False, True])
def test_train_step_returns_detached_losses(device_batch):
    """The step's result is a dict of 0-d tensors off the graph; a batch
    already put on the device gives the same step as the host batch."""
    cfg = ShapeNetConfig(image_size=H, voxel_size=S, num_points=N,
                         num_views=V, num_candidates=K, batch_size=B)
    port, ref = (ShapeNetLearner(cfg, device="cpu") for _ in range(2))
    batch = JSynthetic(B, H, V, n_points=128, seed=3).next_batch()
    want = ref.train_step(batch)
    losses = port.train_step(port.put_batch(batch) if device_batch else batch)
    assert set(losses) == {"projection_loss", "student_loss", "total_loss"}
    for k, v in losses.items():
        assert v.dim() == 0 and not v.requires_grad
        assert torch.equal(v, want[k])
    assert port._last_min_idx.shape == (B * V,)
    assert port.step == 1
