"""The Pipeline-B training step of the PyTorch port against the JAX
``ReconTrainer.train_step``, on the CPU, and the port's training state:
the warm-up and learning-rate schedule, checkpoints with optimizer state,
``--continue_train`` and checkpoints of the inference slice.

Both trainers start from the same parameters (the JAX trainer's init with a
mesh head that moves the sphere, perturbed batch statistics and
``DatasetParams``, converted to the port) at 64² images, a 64² texture,
``MeshTemplate(16, 8)``, and take 3 steps on 3 fixed batches of 4
fabricated photos.

Why lr = lr_dataset = 1e-7 there: the train-mode batch norm over 4 images
leaves the float32 gradients of the two frameworks about 1 % apart
(relative L2 of Adam's moments, measured 0.7-1.5 % for the first moment and
0.7-3.3 % for the second), and Adam's first steps move every parameter by
about lr whatever its gradient's size, so a parameter whose gradient is at
that noise level steps the other way; at lr 1e-4 the two runs part within
2 steps (losses 3 % apart at step 3, measured), at 1e-7 they stay together.

Tolerances: the three losses rtol 1e-4; batch statistics atol 1e-5
(running moments up to ~10, float32); parameters and ``DatasetParams``
atol 1e-6 (the trajectories stay together: at most one opposite step of lr
per step, plus rounding).  After each step, for each optimizer:

- Adam's first and second moments against optax's ``mu`` and ``nu``,
  relative L2 below 0.1;
- the applied update, ``p_after - p_before``, against the JAX trainer's,
  per element within 0.06 lr plus one float32 spacing at the parameter's
  magnitude (the rounding of both sides' additions).  The rule for the
  noise floor: an element is held where both of its moments agree with
  optax's within 3 %, since the update is a function of the moments alone;
  that bounds the update's difference by 4.6 % of its size (at most 1.05 lr)
  and leaves out the elements whose gradient the batch-norm noise reaches.
  At least 60 % of each optimizer's elements must be held (measured
  72-89 %).

A resumed run is bit-equal to the uninterrupted one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from im23d_tpu.geometry.mesh_template import MeshTemplate as JTemplate
from im23d_tpu.parallel.mesh import make_mesh
from im23d_tpu.train.recon_trainer import ReconConfig as JConfig
from im23d_tpu.train.recon_trainer import ReconTrainer as JTrainer
from im23d_tpu_torch.cli.run_reconstruction import main
from im23d_tpu_torch.core.checkpoint import save_checkpoint
from im23d_tpu_torch.core.convert import (
    dataset_params_state_dict,
    reconstruction_state_dict,
)
from im23d_tpu_torch.data.fabricate import StructuredReconSet
from im23d_tpu_torch.geometry.mesh_template import MeshTemplate
from im23d_tpu_torch.geometry.objio import save_obj, uv_sphere
from im23d_tpu_torch.train.recon_trainer import (
    ReconConfig,
    ReconTrainer,
    _flat_warmup_after,
)

RES, TEX, BS, DS = 64, 64, 2, 12
LOSS_RTOL, PARAM_ATOL, STATS_ATOL, MOMENT_RL2 = 1e-4, 1e-6, 1e-5, 0.1
UPDATE_ATOL, MOMENT_AGREE, MIN_HELD = 0.06, 0.03, 0.6
PARITY_BS, PARITY_LR = 4, 1e-7


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port_trainer(seed=0, lr=1e-4):
    return ReconTrainer(ReconConfig(image_resolution=RES,
                                    texture_resolution=TEX, batch_size=BS,
                                    seed=seed, lr=lr, lr_dataset=lr),
                        dataset_size=DS,
                        template=MeshTemplate(segments=16, rings=8),
                        device="cpu")


def _trainers(lr=1e-4):
    jt = JTrainer(JConfig(image_resolution=RES, texture_resolution=TEX,
                          batch_size=BS, lr=lr, lr_dataset=lr),
                  dataset_size=DS,
                  template=JTemplate(segments=16, rings=8),
                  mesh=make_mesh(jax.devices()[:1]))
    rng = np.random.RandomState(6)
    params = _np_tree(jt.params)
    params["conv_mesh"]["kernel"] = rng.randn(
        *params["conv_mesh"]["kernel"].shape).astype(np.float32) * 0.02
    stats = jax.tree.map(
        lambda s: (s + 0.1 * np.abs(rng.randn(*s.shape))).astype(np.float32),
        _np_tree(jt.batch_stats))
    dp = jax.tree.map(
        lambda p: (rng.randn(*p.shape) * 0.05).astype(np.float32),
        _np_tree(jt.dp_params))
    jt.params, jt.batch_stats, jt.dp_params = (
        jax.tree.map(jnp.asarray, t) for t in (params, stats, dp))
    pt = _port_trainer(lr=lr)
    pt.load_params({"params": params, "batch_stats": stats}, dp)
    return jt, pt


def _batch(seed):
    rng = np.random.RandomState(seed)
    img = rng.uniform(-1, 1, (BS, RES, RES, 4)).astype(np.float32)
    img[..., 3] = (rng.rand(BS, RES, RES) > 0.5).astype(np.float32)
    rot = rng.randn(BS, 4).astype(np.float32)
    return dict(image=img,
                scale=(0.6 + 0.2 * rng.rand(BS)).astype(np.float32),
                translation=(rng.randn(BS, 3) * 0.05).astype(np.float32),
                rotation=rot / np.linalg.norm(rot, axis=-1, keepdims=True),
                idx=rng.randint(0, 2 * DS, size=(BS,)).astype(np.int32))


def _max_diffs(jt, pt):
    ref = reconstruction_state_dict({"params": _np_tree(jt.params),
                                     "batch_stats": _np_tree(jt.batch_stats)})
    sd = pt.model.state_dict()
    params = {n for n, _ in pt.model.named_parameters()}
    dp_ref = dataset_params_state_dict(_np_tree(jt.dp_params))
    d_param = max(float((sd[k] - v).abs().max()) for k, v in ref.items()
                  if k in params)
    d_stats = max(float((sd[k] - v).abs().max()) for k, v in ref.items()
                  if k not in params)
    d_dp = max(float((pt.dp_model.state_dict()[k] - v).abs().max())
               for k, v in dp_ref.items())
    return d_param, d_stats, d_dp


def _jax_adam(jt):
    """(parameters, mu, nu) of the network and of ``DatasetParams``, as
    float64 numpy arrays under the port's names."""
    stats = _np_tree(jt.batch_stats)
    net = [reconstruction_state_dict({"params": _np_tree(t),
                                      "batch_stats": stats})
           for t in (jt.params, jt.opt.inner_state[0].mu,
                     jt.opt.inner_state[0].nu)]
    dp = [dataset_params_state_dict(_np_tree(t))
          for t in (jt.dp_params, jt.opt_dp[0].mu, jt.opt_dp[0].nu)]
    return [[{k: np.asarray(v, np.float64) for k, v in d.items()}
             for d in group] for group in (net, dp)]


def _port_adam(pt):
    """The port's counterpart of ``_jax_adam``."""
    out = []
    for opt, module in ((pt.opt, pt.model), (pt.opt_dp, pt.dp_model)):
        group = [{}, {}, {}]
        for name, p in module.named_parameters():
            st = opt.state.get(p, {})
            for d, v in zip(group, (p, st.get("exp_avg", torch.zeros_like(p)),
                                    st.get("exp_avg_sq",
                                           torch.zeros_like(p)))):
                d[name] = v.detach().double().numpy().copy()
        out.append(group)
    return out


def _check_adam_step(step, lr, jax_before, jax_after, port_before,
                     port_after):
    """Holds one step's Adam moments and applied update, for each
    optimizer, against optax's, by the rule of the module docstring."""
    for group, (jb, ja, pb, pa) in enumerate(
            zip(jax_before, jax_after, port_before, port_after)):
        err, ref = np.zeros(2), np.zeros(2)
        held = total = 0
        for name in pa[0]:
            agree = np.ones(pa[0][name].shape, bool)
            for i in (1, 2):
                got, want = pa[i][name], ja[i][name]
                err[i - 1] += ((got - want) ** 2).sum()
                ref[i - 1] += (want ** 2).sum()
                agree &= np.abs(got - want) <= MOMENT_AGREE * np.abs(want)
            d_port = pa[0][name] - pb[0][name]
            d_jax = ja[0][name] - jb[0][name]
            mag = np.maximum.reduce([np.abs(x[0][name])
                                     for x in (jb, ja, pb, pa)])
            limit = UPDATE_ATOL * lr + np.spacing(mag.astype(np.float32))
            off = agree & (np.abs(d_port - d_jax) > limit)
            assert not off.any(), (step, name, int(off.sum()),
                                   float(np.abs(d_port - d_jax)[off].max()))
            held += int(agree.sum())
            total += agree.size
        rl2 = np.sqrt(err / ref)
        assert (rl2 < MOMENT_RL2).all(), (step, group, rl2)
        assert held >= MIN_HELD * total, (step, group, held / total)


def test_train_steps_match_jax():
    jt, pt = _trainers(PARITY_LR)
    n = 3 * PARITY_BS
    ds = StructuredReconSet(MeshTemplate(segments=16, rings=8), n,
                            photo_res=RES, texture_resolution=32, batch=n)
    jax_adam, port_adam = _jax_adam(jt), _port_adam(pt)
    for step in range(3):
        sel = slice(step * PARITY_BS, (step + 1) * PARITY_BS)
        batch = dict(image=ds.images[sel], scale=ds.scale[sel],
                     translation=ds.translation[sel],
                     rotation=ds.rotation[sel],
                     idx=np.arange(n, dtype=np.int32)[sel])
        ref = jt.train_step(batch)
        got = pt.train_step(batch)
        for k in ("recon_loss", "flat_loss", "iou"):
            np.testing.assert_allclose(float(got[k]), float(ref[k]),
                                       rtol=LOSS_RTOL, err_msg=(step, k))
        d_param, d_stats, d_dp = _max_diffs(jt, pt)
        assert d_param < PARAM_ATOL, (step, d_param)
        assert d_stats < STATS_ATOL, (step, d_stats)
        assert d_dp < PARAM_ATOL, (step, d_dp)
        jax_next, port_next = _jax_adam(jt), _port_adam(pt)
        _check_adam_step(step, PARITY_LR, jax_adam, jax_next, port_adam,
                         port_next)
        jax_adam, port_adam = jax_next, port_next
    assert pt.total_it == jt.total_it == 3
    assert pt.flat_warmup == jt.flat_warmup
    assert float(np.abs(np.asarray(jt.opt_dp[0].mu["ds_scale"])).max()) > 0


def test_warmup_and_lr_schedule():
    pt = _port_trainer()
    assert pt._lr_factor() == 1.0
    pt.epoch = 250
    assert pt._lr_factor() == 0.5
    pt.epoch = 500
    assert pt._lr_factor() == 0.25
    pt.train_step(_batch(1))
    assert pt.opt.param_groups[0]["lr"] == pytest.approx(0.25e-4)
    assert pt.opt_dp.param_groups[0]["lr"] == pytest.approx(1e-4)
    w = 10.0
    for n in range(1, 100):
        w = max(w - 0.1, 1.0)
        assert _flat_warmup_after(n) == w
    assert _flat_warmup_after(1000) == 1.0
    assert pt.flat_warmup == _flat_warmup_after(1)


def test_checkpoint_roundtrip_with_optimizer_state(tmp_path):
    pt = _port_trainer()
    for s in range(2):
        pt.train_step(_batch(30 + s))
    pt.epoch = 1
    pt.save(str(tmp_path))
    other = _port_trainer(seed=1)
    other.restore(str(tmp_path))
    assert (other.epoch, other.total_it) == (1, 2)
    assert other.flat_warmup == pt.flat_warmup
    torch.testing.assert_close(other.model.state_dict(),
                               pt.model.state_dict(), atol=0, rtol=0)
    for a, b in ((other.opt, pt.opt), (other.opt_dp, pt.opt_dp)):
        sa, sb = a.state_dict()["state"], b.state_dict()["state"]
        assert sa.keys() == sb.keys() and len(sa) > 0
        for k in sa:
            for name in ("exp_avg", "exp_avg_sq", "step"):
                torch.testing.assert_close(sa[k][name], sb[k][name], atol=0,
                                           rtol=0)
    # the next step of both is the same
    batch = _batch(40)
    ga, gb = other.train_step(batch), pt.train_step(batch)
    assert float(ga["recon_loss"]) == float(gb["recon_loss"])
    torch.testing.assert_close(other.model.state_dict(),
                               pt.model.state_dict(), atol=0, rtol=0)


def test_restores_an_inference_checkpoint(tmp_path):
    """A checkpoint without optimizer state (the format of the inference
    slice) loads; the optimizers start fresh."""
    pt = _port_trainer()
    params, stats, dp = pt._split_state()
    save_checkpoint(str(tmp_path), 7, dict(params=params, batch_stats=stats,
                                           dp_params=dp, epoch=2,
                                           total_it=7))
    other = _port_trainer(seed=1)
    other.restore(str(tmp_path))
    assert (other.epoch, other.total_it) == (2, 7)
    assert not other.opt.state_dict()["state"]
    torch.testing.assert_close(other.model.state_dict(),
                               pt.model.state_dict(), atol=0, rtol=0)
    assert np.isfinite(float(other.train_step(_batch(2))["recon_loss"]))


def test_continue_train_is_bit_equal_to_an_uninterrupted_run(
        tmp_path, monkeypatch):
    tpl = MeshTemplate(segments=16, rings=8)
    ds = StructuredReconSet(tpl, 5, photo_res=RES, texture_resolution=32,
                            batch=5)
    sphere = uv_sphere(16, 8)
    save_obj(str(tmp_path / "sphere"), sphere, sphere.vertices)
    flags = ["--dataset", "cub", "--batch_size", str(BS),
             "--image_resolution", str(RES), "--texture_resolution", "64",
             "--compute_dtype", "float32", "--num_workers", "1", "--device",
             "cpu", "--mesh_path", str(tmp_path / "sphere.obj"),
             "--evaluate_freq", "100", "--image_freq", "100", "--save_freq",
             "1"]
    monkeypatch.chdir(tmp_path)
    assert main(["--name", "a", "--epochs", "2", *flags],
                datasets=(ds, ds)) == 0
    assert main(["--name", "b", "--epochs", "1", *flags],
                datasets=(ds, ds)) == 0
    assert main(["--name", "b", "--epochs", "2", "--continue_train", *flags],
                datasets=(ds, ds)) == 0
    a = torch.load(tmp_path / "checkpoints_recon" / "a" / "checkpoint_4.pt",
                   weights_only=True)
    b = torch.load(tmp_path / "checkpoints_recon" / "b" / "checkpoint_4.pt",
                   weights_only=True)
    assert (a["epoch"], a["total_it"]) == (b["epoch"], b["total_it"]) == (2, 4)
    for key in ("params", "batch_stats", "dp_params"):
        torch.testing.assert_close(a[key], b[key], atol=0, rtol=0)
    for key in ("opt", "opt_dp"):
        for k, st in a[key]["state"].items():
            for name, v in st.items():
                torch.testing.assert_close(v, b[key]["state"][k][name],
                                           atol=0, rtol=0)
