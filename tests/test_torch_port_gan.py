"""The GAN models of the PyTorch port against the JAX reference, on the CPU:
the head conv's plain version (K8's reference) against the JAX package's
``head_conv_tanh`` in Pallas interpret mode, the generator and the critics
against flax with converted variables, ``gan_loss``, and the reference
torch layout.

Same numpy inputs through both, float32.  Tolerances:
  * head conv: values atol 2e-6, dx / dW / db atol 1e-4, the limits of
    ``tests/test_conv_pallas.py``; K8's plain dW for bfloat16 x against
    the JAX VJP's dW (bf16 products of x and the upstream rounded to
    bf16, float32 sums) by relative L2 1e-5: the same bf16 operands, the
    plain sum in float64;
  * generator and critics: outputs within 1e-4 × max(1, max |ref|) (a
    texture sums 1600 products per pixel through eight conditional batch
    norms, in another order than XLA's); updated batch-norm statistics and
    spectral-norm ``u`` within 1e-5;
  * ``gan_loss``: 1e-6.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from im23d_tpu.losses import gan_losses as jlosses
from im23d_tpu.models import gan as jgan
from im23d_tpu.ops import conv_pallas
from im23d_tpu.ops.conv_pallas import head_conv_tanh as j_head_conv
from im23d_tpu_torch.core.convert import (
    discriminator_state_dict,
    generator_state_dict,
)
from im23d_tpu_torch.losses.gan_losses import gan_loss
from im23d_tpu_torch.models import gan as tgan
from im23d_tpu_torch.ops.conv import head_conv_dw_torch, head_conv_tanh

RES = 128  # the generator's smallest texture resolution


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


@pytest.mark.parametrize("pad_mode", ["replicate", "circular"])
@pytest.mark.parametrize("shape", [(2, 16, 16, 8), (1, 8, 16, 8)])
def test_head_conv_plain_matches_pallas_interpret(shape, pad_mode):
    rng = np.random.default_rng(0)
    B, H, W, C = shape
    x = rng.standard_normal(shape).astype(np.float32)
    k = (rng.standard_normal((5, 5, C, 3)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(3) * 0.1).astype(np.float32)
    co = rng.standard_normal((B, H, W, 3)).astype(np.float32)

    def jloss(x, k, b):
        return jnp.sum(j_head_conv(x, k, b, True, pad_mode)[..., :3] * co)

    ref = np.asarray(j_head_conv(jnp.asarray(x), jnp.asarray(k),
                                 jnp.asarray(b), True, pad_mode))[..., :3]
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x),
                                                jnp.asarray(k), jnp.asarray(b))

    tx = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_()
    tw = torch.from_numpy(k.transpose(3, 2, 0, 1).copy()).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    y = head_conv_tanh(tx, tw, tb, pad_mode)
    np.testing.assert_allclose(y.detach().numpy().transpose(0, 2, 3, 1), ref,
                               atol=2e-6, rtol=0)
    (y * torch.from_numpy(co.transpose(0, 3, 1, 2).copy())).sum().backward()
    got = (tx.grad.numpy().transpose(0, 2, 3, 1),
           tw.grad.numpy().transpose(2, 3, 1, 0), tb.grad.numpy())
    for name, g, r in zip(("dx", "dW", "db"), got, jgrads):
        np.testing.assert_allclose(g, np.asarray(r), atol=1e-4, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("pad_mode", ["replicate", "circular"])
@pytest.mark.parametrize("shape", [(2, 16, 16, 8), (1, 12, 24, 16)])
def test_head_conv_dw_bf16_matches_jax_vjp(shape, pad_mode):
    """K8's plain dW rounds the float32 upstream g = dy (1 - y^2) to x's
    type before its sum, as the JAX VJP does (``conv_pallas.py:316-322``):
    for bfloat16 x both sum the same bf16 products."""
    rng = np.random.default_rng(1)
    B, H, W, C = shape
    x = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
    k = jnp.asarray(rng.standard_normal((5, 5, C, 3)) * 0.1, jnp.float32)
    b = jnp.asarray(rng.standard_normal(3) * 0.1, jnp.float32)
    dy = rng.standard_normal((B, H, W, 3)).astype(np.float32)

    def jloss(k):
        y = j_head_conv(x, k, b, True, pad_mode)[..., :3]
        return jnp.sum(y.astype(jnp.float32) * dy)

    jdw = np.asarray(jax.grad(jloss)(k))  # (5, 5, C, 3)
    y = np.asarray(j_head_conv(x, k, b, True, pad_mode)[..., :3],
                   np.float32)
    # the VJP's float32 upstream: the cotangent reaches the bf16 output
    # rounded to bf16
    dyb = np.asarray(jnp.asarray(dy, jnp.bfloat16), np.float32)
    g = dyb * (1.0 - y * y)
    tx = torch.from_numpy(np.asarray(x, np.float32).transpose(0, 3, 1, 2)
                          .copy()).to(torch.bfloat16)
    tg = torch.from_numpy(g.transpose(0, 3, 1, 2).copy())
    got = head_conv_dw_torch(tx, tg, pad_mode).numpy().transpose(2, 3, 1, 0)
    rel = np.linalg.norm(got - jdw) / np.linalg.norm(jdw)
    assert rel <= 1e-5, rel
    # without the rounding the sums differ by the upstream's bf16 rounding
    raw = head_conv_dw_torch(tx.float(), tg, pad_mode).numpy()
    assert np.linalg.norm(raw.transpose(2, 3, 1, 0) - jdw) > 10 * rel * \
        np.linalg.norm(jdw)


def _configs(**kw):
    j = jgan.GANConfig(texture_resolution=RES, mesh_resolution=32,
                       n_classes=(5,), **kw)
    t = tgan.GANConfig(texture_resolution=RES, mesh_resolution=32,
                       n_classes=(5,), **kw)
    return j, t


@functools.lru_cache(maxsize=None)
def _generator_init(cond: bool) -> dict:
    """The flax generator's initial variables (numpy), one per config."""
    jg = jgan.Generator(_configs(conditional_class=cond)[0])
    c = jnp.zeros((2, 1), jnp.int32) if cond else None
    return _np(jax.jit(lambda r: jg.init(r, jnp.zeros((2, 64)), c,
                                         train=False))(jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _critics_init(n_d: int, cond: bool) -> dict:
    """The flax critics' initial variables (numpy), one per config."""
    jd = jgan.MultiScaleDiscriminator(
        _configs(conditional_class=cond, num_discriminators=n_d)[0])
    c = jnp.zeros((2, 1), jnp.int32) if cond else None
    return _np(jax.jit(lambda r: jd.init(
        r, jnp.zeros((2, RES, RES, 4)), jnp.zeros((2, 32, 32, 3)), c,
        train=False))(jax.random.PRNGKey(1)))


def _perturb(tree, rng, scale=0.1):
    """Random values for the zero-initialised leaves (biases, conv_mesh)
    and positive ones for the variances, so every layer is exercised."""
    def leaf(path, x):
        key = jax.tree_util.keystr(path)
        x = np.asarray(x)
        if key.endswith("['var']"):
            return (np.abs(x) + rng.uniform(0.5, 1.5, x.shape)).astype(x.dtype)
        if key.endswith("['mean']") or "conv_mesh" in key or key.endswith(
                "['bias']"):
            return (x + rng.standard_normal(x.shape) * scale).astype(x.dtype)
        return x
    return jax.tree_util.tree_map_with_path(leaf, tree)


@pytest.mark.parametrize("cond,train,route", [
    (False, False, "xla"), (False, True, "xla"), (True, False, "xla"),
    (True, True, "xla"), (False, False, "pallas"),
])
def test_generator_matches_flax(cond, train, route, monkeypatch):
    if route == "pallas":
        monkeypatch.setattr(conv_pallas, "_FORCE_PALLAS_HEAD", True)
    jcfg, tcfg = _configs(conditional_class=cond)
    rng = np.random.default_rng(1)
    z = rng.standard_normal((2, 64)).astype(np.float32)
    c = np.array([[1], [3]], np.int32) if cond else None
    jg = jgan.Generator(jcfg)
    v = _perturb(_generator_init(cond), rng)
    (tex, mesh), new = jg.apply(v, jnp.asarray(z),
                                None if c is None else jnp.asarray(c),
                                train=train, mutable=["batch_stats"])

    port = tgan.Generator(tcfg)
    port.load_state_dict(generator_state_dict(v))
    port.train(train)
    with torch.no_grad():
        ttex, tmesh = port(torch.from_numpy(z),
                           None if c is None else torch.from_numpy(c))
    for got, ref in ((ttex, tex), (tmesh, mesh)):
        ref = np.asarray(ref)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-4 * max(1.0, np.abs(ref).max()))
    want = generator_state_dict({"params": v["params"],
                                 "batch_stats": _np(new["batch_stats"])})
    have = port.state_dict()
    keys = [k for k in want if "running" in k or "weight_u" in k]
    assert len(keys) == 16 + 24  # spectral-norm u; batch-norm mean, var
    for k in keys:
        np.testing.assert_allclose(have[k].numpy(), want[k].numpy(),
                                   atol=1e-5, rtol=0, err_msg=k)


@pytest.mark.parametrize("n_d,cond,train", [
    (2, False, False), (2, True, True), (3, False, True), (3, True, False),
    (3, True, True),
])
def test_critics_match_flax(n_d, cond, train):
    jcfg, tcfg = _configs(conditional_class=cond, num_discriminators=n_d)
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (2, RES, RES, 4)).astype(np.float32)
    x[..., 3] = (rng.random((2, RES, RES)) > 0.3).astype(np.float32)
    mesh = (rng.standard_normal((2, 32, 32, 3)) * 0.05).astype(np.float32)
    c = np.array([[0], [4]], np.int32) if cond else None
    jd = jgan.MultiScaleDiscriminator(jcfg)
    v = _perturb(_critics_init(n_d, cond), rng)
    jc = None if c is None else jnp.asarray(c)
    (outs, masks), new = jd.apply(v, jnp.asarray(x), jnp.asarray(mesh), jc,
                                  train=train, alpha=jnp.asarray(x[..., 3:]),
                                  mutable=["batch_stats"])

    port = tgan.MultiScaleDiscriminator(tcfg)
    port.load_state_dict(discriminator_state_dict(v))
    port.train(train)
    with torch.no_grad():
        touts, tmasks = port(torch.from_numpy(x), torch.from_numpy(mesh),
                             None if c is None else torch.from_numpy(c),
                             alpha=torch.from_numpy(x[..., 3:]))
    assert len(touts) == n_d
    for got, ref in zip(touts + tmasks, list(outs) + list(masks)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy().reshape(ref.shape), ref,
                                   rtol=0,
                                   atol=1e-4 * max(1.0, np.abs(ref).max()))
    want = discriminator_state_dict({"params": v["params"],
                                     "batch_stats": _np(new["batch_stats"])})
    have = port.state_dict()
    for k in (k for k in want if "weight_u" in k):
        np.testing.assert_allclose(have[k].numpy(), want[k].numpy(),
                                   atol=1e-5, rtol=0, err_msg=k)


@pytest.mark.parametrize("mode", ["hinge", "ls", "original", "w"])
@pytest.mark.parametrize("real,for_d", [(True, True), (False, True),
                                        (True, False)])
def test_gan_loss_matches_jax(mode, real, for_d):
    rng = np.random.default_rng(3)
    preds = [rng.standard_normal((2, 1, 8, 8)).astype(np.float32),
             rng.standard_normal((2, 1, 4, 4)).astype(np.float32)]
    masks = [rng.random((2, 1, 8, 8)).astype(np.float32),
             rng.random((2, 1, 4, 4)).astype(np.float32)]
    weights = [2.0, 1.0] if mode == "hinge" else None
    ref = jlosses.gan_loss([jnp.asarray(p) for p in preds], real, for_d,
                           [jnp.asarray(m) for m in masks], weights, mode)
    got = gan_loss([torch.from_numpy(p) for p in preds], real, for_d,
                   [torch.from_numpy(m) for m in masks], weights, mode)
    np.testing.assert_allclose(float(got), float(ref), atol=1e-6, rtol=0)
    single = gan_loss(torch.from_numpy(preds[0]), real, for_d,
                      torch.from_numpy(masks[0]), mode=mode)
    ref1 = jlosses.gan_loss(jnp.asarray(preds[0]), real, for_d,
                            jnp.asarray(masks[0]), mode=mode)
    np.testing.assert_allclose(float(single), float(ref1), atol=1e-6, rtol=0)


def test_reference_generator_state_dict_loads():
    """A reference-layout ``Generator`` state dict (``weight_orig`` /
    ``weight_u``, ``normX.norm.running_*``, a CHW ``fc``) loads strictly
    into the port's generator and runs; the zero ``conv_mesh`` gives a zero
    mesh map."""
    from test_torch_convert import make_generator_state_dict

    sd = make_generator_state_dict(np.random.RandomState(2))
    _, tcfg = _configs(conditional_class=True)
    port = tgan.Generator(tcfg)
    port.load_state_dict({k: torch.from_numpy(np.asarray(v))
                          for k, v in sd.items()})
    port.eval()
    with torch.no_grad():
        tex, mesh = port(torch.zeros((2, 64)), torch.zeros((2, 1),
                                                           dtype=torch.long))
    assert tex.shape == (2, RES, RES, 3) and torch.isfinite(tex).all()
    assert float(mesh.abs().max()) == 0.0


@pytest.mark.parametrize("ny,nx", [(16, 8), (8, 8)])
def test_positional_encoding_and_pooling_match_jax(ny, nx):
    np.testing.assert_array_equal(tgan.positional_encoding(ny, nx),
                                  jgan.positional_encoding(ny, nx))
    x = np.random.default_rng(4).random((2, 16, 8, 3)).astype(np.float32)
    ref = np.asarray(jgan.avg_pool_box(jnp.asarray(x), 4))
    got = tgan.avg_pool_box(torch.from_numpy(x).permute(0, 3, 1, 2), 4)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref,
                               atol=1e-6, rtol=0)

