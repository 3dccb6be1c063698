"""The GAN trainer of the PyTorch port against the JAX trainer, on the CPU.

Both start from the JAX trainer's initial variables (``core/convert.py``)
and take the same z, so the port's steps are held to the reference's:

  * one G step and one D step, at lr_g 1e-6 and lr_d 5e-7 (distinct, so
    a swapped rate shows) halfway through the linear LR decay (factor
    0.5, so a dropped factor shows): losses rtol 1e-4; the gradients,
    read as Adam's first moments (beta1 = 0, so after one step the moment
    is the gradient) against optax's ``mu``, relative L2 <= 1e-3; the
    second moments against ``nu`` <= 2e-3; the updated parameters within
    3e-6 (an update is lr·g / (|g| + eps): a gradient whose sign the two
    frameworks' roundings part moves a parameter by 2 lr); the applied
    update ``p_after - p_before`` against the JAX trainer's per element
    within 0.06 lr plus one float32 spacing at the parameter's magnitude,
    where both moments agree with optax's within 3 % (the update is a
    function of the moments alone, so it then differs by at most 4.6 % of
    its size), on at least 60 % of each optimizer's elements, as
    ``tests/test_torch_port_recon_train.py`` holds it; batch-norm
    statistics, spectral-norm ``u`` and the EMA generator within 1e-5;
  * the FID evaluator's activations for the same EMA weights and the same
    truncated z (a tail batch padded and cut back, the three variants),
    relative L2 <= 1e-4, with a 4 × 4 average-pool of the renders standing
    in for Inception on both sides (the port's Inception is held to JAX's
    in ``tests/test_torch_port_pseudogt.py``);
  * save, restore and one more step: bit-equal to the uninterrupted run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from im23d_tpu.geometry.mesh_template import MeshTemplate as JTemplate
from im23d_tpu.models.gan import GANConfig as JGANConfig
from im23d_tpu.parallel.mesh import make_mesh
from im23d_tpu.train.gan_eval import FIDEvaluator as JFIDEvaluator
from im23d_tpu.train.gan_trainer import GANTrainConfig as JTrainConfig
from im23d_tpu.train.gan_trainer import GANTrainer as JTrainer
from im23d_tpu_torch.core.convert import generator_state_dict
from im23d_tpu_torch.geometry.mesh_template import MeshTemplate
from im23d_tpu_torch.models.gan import GANConfig
from im23d_tpu_torch.train.gan_eval import FIDEvaluator
from im23d_tpu_torch.train.gan_trainer import GANTrainConfig, GANTrainer

RES, LR_G, LR_D = 128, 1e-6, 5e-7
UPDATE_ATOL, MOMENT_AGREE, MIN_HELD = 0.06, 0.03, 0.6
# the steps run at EPOCH of EPOCHS, the LR decaying after DECAY_AFTER
EPOCHS, DECAY_AFTER, EPOCH, LR_FACTOR = 4, 2, 3, 0.5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The suite runs this file beside five other workers on a shared
    machine: with one intra-op thread, torch's parallel regions never wait
    on a descheduled thread (with the default eight, the GAN test files ran
    3 to 60 times slower there than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(seed=0, n=2):
    rng = np.random.RandomState(seed)
    return dict(
        texture=rng.rand(n, RES, RES, 3).astype(np.float32) * 2 - 1,
        alpha=(rng.rand(n, RES, RES, 1) > 0.4).astype(np.float32),
        mesh=rng.randn(n, 32, 32, 3).astype(np.float32) * 0.02,
        c=np.array([[1], [3]], np.int32)[:n])


def _configs():
    kw = dict(texture_resolution=RES, mesh_resolution=32, n_classes=(5,),
              conditional_class=True)
    tkw = dict(batch_size=2, lr_g=LR_G, lr_d=LR_D, epochs=EPOCHS,
               lr_decay_after=DECAY_AFTER)
    return (JTrainConfig(model=JGANConfig(**kw), **tkw),
            GANTrainConfig(model=GANConfig(**kw), **tkw))


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = _configs()
    jt = JTrainer(jcfg, template=JTemplate(segments=16, rings=8),
                  mesh=make_mesh(jax.devices()[:1]))
    pt = GANTrainer(tcfg, template=MeshTemplate(segments=16, rings=8),
                    device="cpu")
    pt.load_variables({"params": _np(jt.g_params),
                       "batch_stats": _np(jt.g_stats)},
                      {"params": _np(jt.d_params),
                       "batch_stats": _np(jt.d_stats)})
    return jt, pt


def _rel(got: dict, want: dict) -> float:
    num = sum(float(((got[k] - want[k]) ** 2).sum()) for k in want)
    return (num / sum(float((v ** 2).sum()) for v in want.values())) ** 0.5


def _moments(opt, module, key):
    return {n: opt.state[p][key] for n, p in module.named_parameters()}


def _close(got: dict, want: dict, atol: float, what: str):
    for k, v in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), v.numpy(),
                                   atol=atol,
                                   rtol=0, err_msg=f"{what}: {k}")


def _check_update(lr, before, after, jax_before, jax_after, moments,
                  jax_moments):
    """Holds one step's applied update against the JAX trainer's, by the
    rule of the module docstring."""
    held = total = 0
    for name, ja in jax_after.items():
        agree = np.ones(ja.shape, bool)
        for got, want in zip(moments, jax_moments):
            g, w = got[name].numpy(), want[name].numpy()
            agree &= np.abs(g - w) <= MOMENT_AGREE * np.abs(w)
        pb, pa = before[name].numpy(), after[name].detach().numpy()
        jb, ja = jax_before[name].numpy(), ja.numpy()
        mag = np.maximum.reduce([np.abs(x) for x in (pb, pa, jb, ja)])
        limit = UPDATE_ATOL * lr + np.spacing(mag.astype(np.float32))
        diff = np.abs((pa - pb) - (ja - jb))
        off = agree & (diff > limit)
        assert not off.any(), (name, int(off.sum()), float(diff[off].max()))
        held += int(agree.sum())
        total += agree.size
    assert held >= MIN_HELD * total, held / total


def _gen(tree):
    return generator_state_dict(_np(tree))


def _disc(params, stats):
    from im23d_tpu_torch.core.convert import discriminator_state_dict

    return discriminator_state_dict({"params": _np(params),
                                     "batch_stats": _np(stats)})


def _z(jt):
    return jax.random.normal(jax.random.fold_in(jt._rng, jt.total_it),
                             (2, jt.mcfg.latent_dim))


def test_g_and_d_steps_match_jax(pair):
    jt, pt = pair
    jt.epoch = pt.epoch = EPOCH
    assert jt._lr_factor() == pt._lr_factor() == LR_FACTOR
    batch = _batch()
    for step, lr in (("g", LR_G * LR_FACTOR), ("d", LR_D * LR_FACTOR)):
        net = pt.generator if step == "g" else pt.discriminator
        before = {n: p.detach().clone() for n, p in net.named_parameters()}
        jax_before = (_gen({"params": jt.g_params}) if step == "g"
                      else _disc(jt.d_params, {}))
        z = torch.from_numpy(np.array(_z(jt)))
        jl = {k: float(v) for k, v in jt.train_step(batch).items()}
        tl = {k: float(v) for k, v in pt.train_step(batch, z=z).items()}
        assert jl.keys() == tl.keys()
        for k in jl:
            np.testing.assert_allclose(tl[k], jl[k], rtol=1e-4, err_msg=k)

        opt = pt.opt_g if step == "g" else pt.opt_d
        jopt = jt.opt_g if step == "g" else jt.opt_d
        adam = jopt.inner_state[0]
        if step == "g":
            mu, nu = _gen({"params": adam.mu}), _gen({"params": adam.nu})
            params = _gen({"params": jt.g_params})
        else:
            mu, nu = _disc(adam.mu, {}), _disc(adam.nu, {})
            params = _disc(jt.d_params, {})
        moments = (_moments(opt, net, "exp_avg"),
                   _moments(opt, net, "exp_avg_sq"))
        assert _rel(moments[0], mu) <= 1e-3
        assert _rel(moments[1], nu) <= 2e-3
        _close(dict(net.named_parameters()), params, 3e-6, "params")
        _check_update(lr, before, dict(net.named_parameters()), jax_before,
                      params, moments, (mu, nu))

        # the statistics both steps move: G's batch norms and u, D's u
        g_stats = _gen({"params": jt.g_params, "batch_stats": jt.g_stats})
        _close(pt.generator.state_dict(),
               {k: v for k, v in g_stats.items() if "running" in k
                or "weight_u" in k}, 1e-5, "G stats")
        d_stats = _disc(jt.d_params, jt.d_stats)
        _close(pt.discriminator.state_dict(),
               {k: v for k, v in d_stats.items() if "weight_u" in k}, 1e-5,
               "D u")
    _close(pt.g_ema.state_dict(), _gen(jt.g_ema), 1e-5, "EMA")
    assert pt.total_it == jt.total_it == 2


def test_fid_activations_match_jax(pair, monkeypatch):
    jt, pt = pair
    pt.g_ema.load_state_dict(_gen(jt.g_ema))
    res, sigma = 32, 0.8

    def pool(img):  # (B, R, R, 3) -> (B, 48)
        B = img.shape[0]
        return img.reshape(B, 4, res // 4, 4, res // 4, 3).mean((2, 4)
                                                                ).reshape(B, -1)

    jev = JFIDEvaluator(jt, jt.template, evaluation_res=res,
                        inception_variables={})
    monkeypatch.setattr(jev, "_act", jax.jit(pool))
    port_pool = torch.nn.Module()
    port_pool.forward = pool
    pev = FIDEvaluator(pt, pt.template, evaluation_res=res,
                       inception=port_pool)

    rng = np.random.RandomState(5)
    batches = []
    for n in (2, 1):  # a tail batch, padded to 2 and cut back
        rot = rng.randn(n, 4).astype(np.float32)
        rot /= np.linalg.norm(rot, axis=-1, keepdims=True)
        b = _batch(6, n)
        batches.append(dict(
            scale=np.full((n, 1), 0.7, np.float32),
            translation=(rng.randn(n, 3) * 0.05).astype(np.float32),
            rotation=rot, c=b["c"], texture=b["texture"], mesh=b["mesh"]))
    key = jax.random.PRNGKey(0)
    zs = [np.asarray(jt.truncation_sample(jax.random.fold_in(key, i), 2,
                                          sigma)) for i in range(2)]
    ref = jev.activations_for_batches(batches, sigma, variants=True, rng=key)
    got = pev.activations_for_batches(batches, sigma, variants=True,
                                      z_batches=zs)
    assert ref.keys() == got.keys() == {"combined", "texture_only",
                                        "mesh_only"}
    for k in ref:
        assert got[k].shape == ref[k].shape == (3, 48)
        rel = np.linalg.norm(got[k] - ref[k]) / np.linalg.norm(ref[k])
        assert rel <= 1e-4, (k, rel)


def test_save_restore_continue_is_bit_equal(tmp_path):
    _, tcfg = _configs()
    template = MeshTemplate(segments=16, rings=8)
    batches = [_batch(10 + i) for i in range(4)]
    a = GANTrainer(tcfg, template=template, workdir=str(tmp_path),
                   device="cpu")
    for b in batches[:3]:
        a.train_step(b)
    a.record_curves({"g_loss": 1.5})
    a.save()
    a.train_step(batches[3])

    b = GANTrainer(tcfg, template=template, workdir=str(tmp_path),
                   device="cpu")
    b.restore()
    assert b.total_it == 3 and b.curves["g_loss"] == [1.5]
    b.train_step(batches[3])
    for x, y in ((a.generator, b.generator), (a.discriminator,
                                              b.discriminator),
                 (a.g_ema, b.g_ema)):
        for (k, v), w in zip(x.state_dict().items(),
                             y.state_dict().values()):
            assert torch.equal(v, w), k
    for oa, ob in ((a.opt_g, b.opt_g), (a.opt_d, b.opt_d)):
        for sa, sb in zip(oa.state.values(), ob.state.values()):
            assert all(torch.equal(sa[k], sb[k]) for k in sa)
