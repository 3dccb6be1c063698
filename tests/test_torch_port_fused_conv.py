"""The folded affine + leaky ReLU + 3×3 conv of the PyTorch port (K9's
plain version and the backward formula its autograd Function uses) and the
``ResBlockUp`` that routes through it, against the JAX reference on the
CPU.

Same numpy inputs through both, NHWC on the JAX side and NCHW in the port,
float32.  Tolerances:
  * ``fused_affine_conv3x3``: values atol 3e-6, the limit of
    ``tests/test_conv_pallas.py``'s test of the Pallas kernel (interpret
    mode here); dx, da, db and dW relative L2 <= 1e-5 each, against
    ``jax.grad`` of the JAX op (its VJP ``_fused_bwd``), through the
    public wrapper's autograd and through ``_FusedConv``'s own backward;
  * ``ResBlockUp``: outputs within 1e-4 × max(1, max |ref|) (norm1 folded
    into one multiply-add rounds differently from norm-then-affine),
    running statistics and spectral-norm ``u`` after the forward within
    1e-5, parameter gradients relative L2 <= 1e-4 per parameter.
  * ``_FusedConv``'s bfloat16 backward (its convs take bf16 operands, as
    the JAX model's own conv VJP in bf16) against autograd of the plain
    version in float64 on the same values: relative L2 <= 6e-3 per
    gradient (readings 2.7e-3 to 3.5e-3, from the bf16 rounding of dy,
    the weight, the activation and each conv's output; a dropped W-pad
    fold reads 1.4e-1 and the slope at pre = 0 reads 9.0e-2 on dx).
  * ``ConditionalNorm.fold`` and ``ResBlockUp`` against the port's own
    unfused forward (norm → affine → leaky ReLU → pad → conv2; flax's
    instance norm raises, so the port is the reference there): values
    within 1e-5 × max(1, max |ref|), buffers within 1e-6, gradients
    relative L2 <= 1e-5.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from im23d_tpu.models import gan as jgan
from im23d_tpu.models.reconstruction import circular_pad_w as j_circ
from im23d_tpu.models.reconstruction import replicate_pad_w as j_repl
from im23d_tpu.ops.conv_pallas import fused_affine_conv3x3 as j_fused
from im23d_tpu_torch.core.convert import generator_state_dict
from im23d_tpu_torch.models import gan as tgan
from im23d_tpu_torch.ops.conv import (
    _FusedConv,
    fused_affine_conv3x3,
    fused_affine_conv3x3_torch,
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread beside the suite's other workers (as the GAN
    test files)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _rel_l2(got: np.ndarray, ref: np.ndarray) -> float:
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _operands(seed, B, H, W, cin, cout, tie=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, cin)).astype(np.float32)
    k = (rng.standard_normal((3, 3, cin, cout)) * 0.1).astype(np.float32)
    a = (1.0 + 0.1 * rng.standard_normal((B, cin))).astype(np.float32)
    b = (0.1 * rng.standard_normal((B, cin))).astype(np.float32)
    co = rng.standard_normal((B, H, W, cout)).astype(np.float32)
    if tie:  # pre = x·a + b exactly 0 on a quarter of channel 0's pixels
        b[:, 0] = 0.0
        x[:, ::2, ::2, 0] = 0.0
    return x, a, b, k, co


@pytest.mark.parametrize("pad_mode", ["replicate", "circular"])
@pytest.mark.parametrize("affine,tie", [(True, False), (False, False),
                                        (True, True)])
@pytest.mark.parametrize("shape", [(2, 8, 16, 8, 32), (2, 8, 16, 16, 16)])
def test_fused_conv_matches_jax(shape, affine, tie, pad_mode):
    """Four affine × pad-mode cases at two shapes, and the affine with
    some pre exactly 0 (JAX's rule ``pre >= 0`` passes the gradient whole
    there; ``F.leaky_relu``'s autograd would pass the slope)."""
    x, a, b, k, co = _operands(7, *shape, tie=tie)
    ja = jnp.asarray(a) if affine else None
    jb = jnp.asarray(b) if affine else None
    ref = np.asarray(j_fused(jnp.asarray(x), ja, jb, jnp.asarray(k), None,
                             pad_mode))
    argnums = (0, 1, 2, 3) if affine else (0, 3)
    jgrads = jax.grad(
        lambda *s: jnp.sum(j_fused(*s, None, pad_mode) * co),
        argnums=argnums)(jnp.asarray(x), ja, jb, jnp.asarray(k))
    jgrads = dict(zip(("dx", "da", "db", "dW") if affine else ("dx", "dW"),
                      (np.asarray(g) for g in jgrads)))
    if tie:  # the tie's pixels carry gradient: JAX passes it whole
        assert np.abs(jgrads["dx"][:, ::2, ::2, 0]).max() > 0

    for fn in (fused_affine_conv3x3, _FusedConv.apply):
        tx = _nchw(x).requires_grad_()
        tw = torch.from_numpy(k.transpose(3, 2, 0, 1).copy()).requires_grad_()
        ta = torch.from_numpy(a).requires_grad_() if affine else None
        tb = torch.from_numpy(b).requires_grad_() if affine else None
        y = fn(tx, ta, tb, tw, pad_mode)
        np.testing.assert_allclose(y.detach().numpy().transpose(0, 2, 3, 1),
                                   ref, atol=3e-6, rtol=0)
        (y * _nchw(co)).sum().backward()
        got = {"dx": tx.grad.numpy().transpose(0, 2, 3, 1),
               "dW": tw.grad.numpy().transpose(2, 3, 1, 0)}
        if affine:
            got.update(da=ta.grad.numpy(), db=tb.grad.numpy())
        for name, r in jgrads.items():
            assert _rel_l2(got[name], r) <= 1e-5, (fn, name)


def test_fused_conv_rejects_half_an_affine():
    x = torch.zeros((1, 16, 4, 4))
    with pytest.raises(ValueError):
        fused_affine_conv3x3(x, torch.ones((1, 16)), None,
                             torch.zeros((16, 16, 3, 3)))


def _block_variables(jblock, x, z, rng):
    """flax ``ResBlockUp`` variables with random norm biases, running
    statistics and spectral-norm ``u``, so every term is exercised."""
    v = jax.tree_util.tree_map(np.asarray, jblock.init(
        jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(z), train=False))

    def leaf(path, t):
        key = jax.tree_util.keystr(path)
        if key.endswith("['var']"):
            return (rng.uniform(0.5, 1.5, t.shape)).astype(t.dtype)
        if key.endswith("['mean']") or key.endswith("['bias']"):
            return (t + rng.standard_normal(t.shape) * 0.1).astype(t.dtype)
        return t
    return jax.tree_util.tree_map_with_path(leaf, v)


def _port_state(tree: dict, z_dim: int) -> dict:
    """The block's entries of ``generator_state_dict`` (the block as blk1
    of a generator whose base layer is a stand-in)."""
    fc = {"kernel": np.zeros((z_dim, 8 * 512), np.float32),
          "bias": np.zeros(8 * 512, np.float32)}
    sd = generator_state_dict({
        "params": {"fc": fc, "blk1": tree["params"]},
        "batch_stats": {"blk1": tree.get("batch_stats", {})}})
    return {k[5:]: v for k, v in sd.items() if k.startswith("blk1.")}


@pytest.mark.parametrize("pad_mode", ["replicate", "circular"])
@pytest.mark.parametrize("norm", ["batch", "none"])
@pytest.mark.parametrize("train", [True, False])
def test_resblockup_matches_flax(train, norm, pad_mode):
    B, H, W, cin, cout, zd = 2, 8, 8, 16, 32, 8
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, H, W, cin)).astype(np.float32)
    z = rng.standard_normal((B, zd)).astype(np.float32)
    co = rng.standard_normal((B, H, W, cout)).astype(np.float32)
    jpad = j_repl if pad_mode == "replicate" else j_circ
    jblock = jgan.ResBlockUp(cout, norm, jpad)
    v = _block_variables(jblock, x, z, rng)

    def jloss(params):
        out, new = jblock.apply({**v, "params": params}, jnp.asarray(x),
                                jnp.asarray(z), train=train,
                                mutable=["batch_stats"])
        return jnp.sum(out * co), (out, new)

    grad_fn = jax.jit(jax.value_and_grad(jloss, has_aux=True))
    (_, (ref, new)), jgrads = grad_fn(v["params"])
    ref = np.asarray(ref)

    port = tgan.ResBlockUp(cin, cout, zd, norm, pad_mode)
    port.load_state_dict(_port_state(v, zd))
    port.train(train)
    out = port(_nchw(x), torch.from_numpy(z))
    got = out.detach().numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-4 * max(1.0, np.abs(ref).max()))

    want = _port_state({"params": v["params"],
                        "batch_stats": jax.tree_util.tree_map(
                            np.asarray, new["batch_stats"])}, zd)
    have = port.state_dict()
    keys = [k for k in want if "running" in k or "weight_u" in k]
    assert len(keys) == 3 + 4 * (norm == "batch")
    for k in keys:
        np.testing.assert_allclose(have[k].numpy(), want[k].numpy(),
                                   atol=1e-5, rtol=0, err_msg=k)

    (out * _nchw(co)).sum().backward()
    jg = _port_state({"params": jax.tree_util.tree_map(np.asarray, jgrads)},
                     zd)
    for name, p in port.named_parameters():
        assert _rel_l2(p.grad.numpy(), jg[name].numpy()) <= 1e-4, name


@pytest.mark.parametrize("pad_mode", ["replicate", "circular"])
@pytest.mark.parametrize("shape", [(2, 16, 8, 16, 32), (2, 64, 4, 8, 64)])
def test_fused_conv_bf16_backward_matches_float64(shape, pad_mode):
    """The bf16 branch of ``_FusedConv``'s backward, with some pre exactly
    0: dx in bf16, da, db and dW in float32, each near float64 autograd of
    the plain version on the same values."""
    B, H, W, cin, cout = shape
    x, a, b, k, co = _operands(13, B, H, W, cin, cout, tie=True)
    tx = _nchw(x).bfloat16()
    tw = torch.from_numpy(k.transpose(3, 2, 0, 1).copy())
    inputs = (tx, torch.from_numpy(a), torch.from_numpy(b), tw)
    tco = _nchw(co)
    args = [t.clone().requires_grad_() for t in inputs]
    y = _FusedConv.apply(*args, pad_mode)
    assert y.dtype == torch.bfloat16
    got = torch.autograd.grad((y.float() * tco).sum(), args)
    assert [g.dtype for g in got] == [torch.bfloat16] + [torch.float32] * 3
    args = [t.double().requires_grad_() for t in inputs]
    ref = torch.autograd.grad((fused_affine_conv3x3_torch(*args, pad_mode)
                               * tco.double()).sum(), args)
    for name, g, r in zip(("dx", "da", "db", "dW"), got, ref):
        assert _rel_l2(g.double().numpy(), r.numpy()) <= 6e-3, name


def _unfused_block(block, x, z):
    """``ResBlockUp.forward`` without the fold: norm1, its leaky ReLU, the
    pad and conv2 one after another."""
    shortcut = x if block.shortcut is None else block.shortcut(x)
    h = tgan.leaky_relu(block.norm1(block.conv1(block.pad_fn(x, 1)), z))
    h = tgan.leaky_relu(block.norm2(block.conv2(block.pad_fn(h, 1)), z))
    return h + shortcut


def _against_unfused(module, fused, unfused, inputs, co):
    """Run ``fused`` on ``module`` and ``unfused`` on a copy, from the same
    state and inputs; hold values, buffers and the gradients of the inputs
    and parameters."""
    ref_module = copy.deepcopy(module)
    ins = [torch.from_numpy(t).requires_grad_() for t in inputs]
    ref_ins = [torch.from_numpy(t).requires_grad_() for t in inputs]
    got = fused(module, *ins)
    ref = unfused(ref_module, *ref_ins)
    np.testing.assert_allclose(
        got.detach().numpy(), ref.detach().numpy(), rtol=0,
        atol=1e-5 * max(1.0, float(ref.detach().abs().max())))
    for (name, t), r in zip(module.named_buffers(), ref_module.buffers()):
        np.testing.assert_allclose(t.numpy(), r.numpy(), atol=1e-6, rtol=0,
                                   err_msg=name)
    tco = torch.from_numpy(co)
    params = list(module.parameters())
    grads = torch.autograd.grad((got * tco).sum(), ins + params)
    ref_grads = torch.autograd.grad((ref * tco).sum(),
                                    ref_ins + list(ref_module.parameters()))
    for i, (g, r) in enumerate(zip(grads, ref_grads)):
        assert _rel_l2(g.numpy(), r.numpy()) <= 1e-5, i


def _random_stats(module, rng):
    """Running statistics away from (0, 1), so eval mode reads them, and
    non-zero biases of γ and β."""
    with torch.no_grad():
        for name, t in module.named_parameters():
            if name.endswith("bias"):
                t.copy_(torch.from_numpy(
                    rng.standard_normal(t.shape).astype(np.float32) * 0.1))
        for name, t in module.named_buffers():
            if name.endswith("running_mean"):
                t.copy_(torch.from_numpy(
                    rng.standard_normal(t.shape).astype(np.float32) * 0.3))
            elif name.endswith("running_var"):
                t.copy_(torch.from_numpy(
                    rng.uniform(0.5, 1.5, t.shape).astype(np.float32)))


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("norm", ["batch", "instance", "none"])
def test_fold_matches_conditional_norm(norm, train):
    """fold(x, z) -> (a, b), then x·a + b, against ``forward(x, z)``."""
    B, C, H, W, zd = 3, 16, 6, 8, 8
    rng = np.random.default_rng(17)
    x = (rng.standard_normal((B, C, H, W)) * 1.5 + 0.4).astype(np.float32)
    z = rng.standard_normal((B, zd)).astype(np.float32)
    co = rng.standard_normal((B, C, H, W)).astype(np.float32)
    mod = tgan.ConditionalNorm(C, zd, norm)
    tgan.gan_init_(mod, torch.Generator().manual_seed(17))
    _random_stats(mod, rng)
    mod.train(train)

    def fused(m, tx, tz):
        a, b = m.fold(tx, tz)
        assert a.dtype == b.dtype == torch.float32
        assert a.shape == b.shape == (B, C)
        return tx * a[:, :, None, None] + b[:, :, None, None]

    _against_unfused(mod, fused, lambda m, tx, tz: m(tx, tz), (x, z), co)


@pytest.mark.parametrize("pad_mode", ["replicate", "circular"])
@pytest.mark.parametrize("norm", ["batch", "instance", "none"])
@pytest.mark.parametrize("train", [True, False])
def test_resblockup_matches_unfused(train, norm, pad_mode):
    """The block through the fold and the fused conv against the unfused
    chain, with its running statistics and spectral-norm ``u``."""
    B, H, W, cin, cout, zd = 2, 8, 8, 16, 32, 8
    rng = np.random.default_rng(19)
    x = rng.standard_normal((B, cin, H, W)).astype(np.float32)
    z = rng.standard_normal((B, zd)).astype(np.float32)
    co = rng.standard_normal((B, cout, H, W)).astype(np.float32)
    block = tgan.ResBlockUp(cin, cout, zd, norm, pad_mode)
    tgan.gan_init_(block, torch.Generator().manual_seed(19))
    _random_stats(block, rng)
    block.train(train)
    _against_unfused(block, lambda m, tx, tz: m(tx, tz), _unfused_block,
                     (x, z), co)
