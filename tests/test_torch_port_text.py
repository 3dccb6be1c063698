"""The GAN's text conditioning in the PyTorch port against the JAX
reference, on the CPU, at the JAX tests' small sizes (128² textures,
``text_embedding_dim`` 32, a vocabulary of 50, captions of 6 tokens).

Same numpy inputs through both; flax variables carried across by
``core/convert.py``.  Tolerances:
  * the caption cache: ``tokens``, ``lengths``, ``n_words`` and ``vocab``
    equal to the JAX writer's;
  * ``TextEncoder`` (converted flax cells, tokens with tail padding and an
    all-pad row): words and sentence within 1e-5 (float32 LSTM steps in
    another order of sums); an AttnGAN-shaped ``.pth`` through
    ``set_text_encoder`` against JAX's ``convert_text_encoder`` of the
    same state dict, the same limit;
  * ``SpatialAttention`` with its mask, against JAX in float32 and in
    bfloat16: the attention map within 1e-5 (float32 logits of the same
    operands: bf16 logits read 5e-3 to 1.5e-2), the output within 1e-5 in
    float32 and one bfloat16 spacing of its largest value in bfloat16;
    the masked words' weight below 1e-4;
  * the text generator (with ``return_attention``) and critics, train and
    eval: outputs within 1e-4 × max(1, max |ref|), batch-norm statistics
    and spectral-norm ``u`` within 1e-5, as ``tests/test_torch_port_gan.py``;
  * dataset items and batches: bit-equal to JAX's ``PseudoGTDataset``;
  * one G and one D step against the JAX ``GANTrainer`` with captions: the
    rules of ``tests/test_torch_port_gan_train.py`` (losses rtol 1e-4,
    moments relative L2 1e-3 / 2e-3, parameters 3e-6, each applied update);
  * save, restore and one more step: bit-equal, the text encoder included;
  * the CLI with ``--conditional_text`` on a tiny cache (FID at 32² with a
    pooling stand-in for Inception, as ``tests/test_torch_port_gan_cli.py``):
    finite losses, the grid's decoded captions in the log, the pretrained
    encoder loaded, ``--save_results``.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from im23d_tpu.core.torch_convert import convert_text_encoder
from im23d_tpu.data import captions as jcaptions
from im23d_tpu.data.pseudogt import CubGANDataset as JCub
from im23d_tpu.data.pseudogt import gan_batch_iterator as j_batches
from im23d_tpu.geometry.mesh_template import MeshTemplate as JTemplate
from im23d_tpu.models import gan as jgan
from im23d_tpu.models.text_encoder import TextEncoder as JTextEncoder
from im23d_tpu.parallel.mesh import make_mesh
from im23d_tpu.train.gan_trainer import GANTrainConfig as JTrainConfig
from im23d_tpu.train.gan_trainer import GANTrainer as JTrainer
from im23d_tpu_torch.cli import main as cli
from im23d_tpu_torch.core.convert import (
    discriminator_state_dict,
    generator_state_dict,
    text_encoder_state_dict,
)
from im23d_tpu_torch.data import captions as tcaptions
from im23d_tpu_torch.data.device_cache import DeviceGANCache
from im23d_tpu_torch.data.pseudogt import CubGANDataset
from im23d_tpu_torch.data.pseudogt import gan_batch_iterator
from im23d_tpu_torch.geometry.mesh_template import MeshTemplate
from im23d_tpu_torch.metrics import inception
from im23d_tpu_torch.models import gan as tgan
from im23d_tpu_torch.models.text_encoder import TextEncoder, caption_mask
from im23d_tpu_torch.train.gan_trainer import GANTrainConfig, GANTrainer
from test_cli_main import make_synthetic_cub_cache
from test_torch_port_gan import _np, _perturb
from test_torch_port_gan_cli import _PoolFeatures
from test_torch_port_gan_train import (
    _check_update,
    _close,
    _disc,
    _gen,
    _moments,
    _rel,
)

RES, DIM, VOCAB, L = 128, 32, 50, 6
# tail padding, an all-pad row, a full row
TOKENS = np.array([[3, 7, 2, 9, 0, 0], [0, 0, 0, 0, 0, 0],
                   [1, 4, 8, 12, 44, 5]], np.int32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread beside the suite's other workers (as the GAN
    test files)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _text_tree(root):
    """A cache's ``poses_metadata.npz`` for 4 images and a caption tree:
    two files of several captions (one line with no letters), one of fewer
    captions than kept (cycled), one image without a file (all pad)."""
    cache = os.path.join(root, "cache", "cub")
    os.makedirs(cache)
    paths = ["001.A/b.jpg", "001.A/c.jpg", "002.B/d.jpg", "002.B/e.jpg"]
    np.savez(os.path.join(cache, "poses_metadata.npz"),
             data=dict(path=paths, scale=np.zeros((4, 1)),
                       translation=np.zeros((4, 3)),
                       rotation=np.zeros((4, 4))))
    text = os.path.join(root, "text")
    for d in ("001.A", "002.B"):
        os.makedirs(os.path.join(text, d))
    files = {"001.A/b.txt": "A small BLUE bird, with a long tail.\n"
                            "the bird's wings are blue and white\n123\n"
                            "this bird has a very very very long pointed "
                            "beak and short legs\n",
             "001.A/c.txt": "a red bird\n",
             "002.B/e.txt": "grey bird\nyellow belly, black crown\n"
                            "tiny bird\nwhite bird\n"}
    for name, body in files.items():
        with open(os.path.join(text, name), "w") as fh:
            fh.write(body)
    return cache, text


@pytest.mark.parametrize("sentence", [
    "This bird's wings are BLUE, really blue!", "", "123 -- ..",
    "éa bird\twith\ntabs"])
def test_tokenize_matches_jax(sentence):
    assert tcaptions.tokenize(sentence) == jcaptions.tokenize(sentence)


@pytest.mark.parametrize("embeddings_num,max_length", [(3, 5), (10, 18)])
def test_caption_cache_matches_jax(tmp_path, embeddings_num, max_length):
    cache, text = _text_tree(str(tmp_path))
    ref = jcaptions.build_caption_cache(cache, text, embeddings_num,
                                        max_length, out_name="jax.npz")
    got = tcaptions.build_caption_cache(cache, text, embeddings_num,
                                        max_length, out_name="port.npz")
    assert tcaptions.main(["--cache_dir", cache, "--text_dir", text,
                           "--embeddings_num", str(embeddings_num),
                           "--max_length", str(max_length)]) == 0
    cli_out = os.path.join(cache, "captions_tokens.npz")
    with np.load(ref) as r, np.load(got) as g, np.load(cli_out) as c:
        assert sorted(r.files) == sorted(g.files) == sorted(c.files)
        for k in r.files:
            for other in (g, c):
                assert other[k].dtype == r[k].dtype, k
                np.testing.assert_array_equal(other[k], r[k], err_msg=k)
        assert r["tokens"].shape == (4, embeddings_num, max_length)
        assert r["tokens"][2].sum() == 0 and r["tokens"][1, 1].sum() > 0


def _encoder_pair(E, H, seed):
    jenc = JTextEncoder(vocab_size=VOCAB, embedding_dim=E, hidden_dim=H)
    params = _np(jenc.init(jax.random.PRNGKey(seed),
                           jnp.asarray(TOKENS))["params"])
    rng = np.random.default_rng(seed)
    # non-zero biases, so the bias mapping is exercised
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: x + rng.standard_normal(x.shape).astype(x.dtype) * 0.1
        if jax.tree_util.keystr(p).endswith("['bias']") else x, params)
    tenc = TextEncoder(VOCAB, E, H)
    tenc.load_state_dict(text_encoder_state_dict(params))
    return jenc, params, tenc


@pytest.mark.parametrize("E,H", [(DIM, DIM // 2), (12, 7)])
def test_text_encoder_matches_flax(E, H):
    jenc, params, tenc = _encoder_pair(E, H, 0)
    words, sent = jenc.apply({"params": params}, jnp.asarray(TOKENS))
    with torch.no_grad():
        twords, tsent = tenc(torch.from_numpy(TOKENS))
    np.testing.assert_allclose(twords.numpy(), np.asarray(words), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(tsent.numpy(), np.asarray(sent), atol=1e-5,
                               rtol=0)
    assert float(twords[1].abs().max()) == float(tsent[1].abs().max()) == 0
    assert torch.equal(caption_mask(torch.from_numpy(TOKENS)),
                       torch.from_numpy(TOKENS == 0))


def _attngan_state_dict(V, E, H, seed):
    """An AttnGAN ``RNN_Encoder``-shaped state dict with random weights and
    biases (both LSTM bias vectors non-zero)."""
    gen = torch.Generator().manual_seed(seed)
    sd = {"encoder.weight": torch.randn((V, E), generator=gen)}
    for sfx in ("", "_reverse"):
        sd[f"rnn.weight_ih_l0{sfx}"] = torch.randn((4 * H, E),
                                                   generator=gen) * 0.3
        sd[f"rnn.weight_hh_l0{sfx}"] = torch.randn((4 * H, H),
                                                   generator=gen) * 0.3
        sd[f"rnn.bias_ih_l0{sfx}"] = torch.randn((4 * H,), generator=gen)
        sd[f"rnn.bias_hh_l0{sfx}"] = torch.randn((4 * H,), generator=gen)
    return sd


def _text_trainer_configs(**kw):
    model = dict(texture_resolution=RES, mesh_resolution=32,
                 conditional_text=True, text_embedding_dim=DIM)
    tkw = dict(batch_size=2, text_vocab_size=VOCAB, text_max_length=L, **kw)
    return (JTrainConfig(model=jgan.GANConfig(**model), **tkw),
            GANTrainConfig(model=tgan.GANConfig(**model), **tkw))


def test_pretrained_encoder_matches_jax_convert(tmp_path):
    """A ``.pth`` through the port's ``set_text_encoder`` against the JAX
    encoder on ``convert_text_encoder`` of the same state dict; a width
    that does not match the GAN's raises ``ValueError``."""
    V, E, H = 23, 12, DIM // 2
    sd = _attngan_state_dict(V, E, H, 3)
    path = tmp_path / "text_encoder.pth"
    torch.save(sd, path)
    params, jcfg = convert_text_encoder({k: v.numpy() for k, v in sd.items()})
    assert jcfg == dict(vocab_size=V, embedding_dim=E, hidden_dim=H)
    tokens = np.minimum(TOKENS, V - 1)
    words, sent = JTextEncoder(**jcfg).apply(
        {"params": jax.tree_util.tree_map(jnp.asarray, params)},
        jnp.asarray(tokens))

    trainer = GANTrainer(_text_trainer_configs()[1],
                         template=MeshTemplate(segments=8, rings=4),
                         device="cpu")
    trainer.set_text_encoder(torch.load(path, weights_only=True), V, E, H)
    twords, tmask = trainer.encode_caption(torch.from_numpy(tokens).long())
    np.testing.assert_allclose(twords.numpy(), np.asarray(words), atol=1e-5,
                               rtol=0)
    _, tsent = trainer.text_encoder(torch.from_numpy(tokens))
    np.testing.assert_allclose(tsent.detach().numpy(), np.asarray(sent),
                               atol=1e-5, rtol=0)
    assert torch.equal(tmask, torch.from_numpy(tokens == 0))
    assert not any(p.requires_grad for p in trainer.text_encoder.parameters())
    with pytest.raises(ValueError):
        trainer.set_text_encoder(_attngan_state_dict(V, E, 8, 4), V, E, 8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spatial_attention_matches_flax(dtype):
    rng = np.random.default_rng(5)
    B, H, W, C, Cd = 2, 4, 6, 16, 8
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    ctx = rng.standard_normal((B, L, Cd)).astype(np.float32)
    mask = TOKENS[[0, 2]] == 0
    jdt = jnp.dtype(dtype)
    jatt = jgan.SpatialAttention(jdt)
    v = _np(jatt.init(jax.random.PRNGKey(0), jnp.asarray(x, jdt),
                      jnp.asarray(ctx, jdt)))
    out, attn = jatt.apply(v, jnp.asarray(x, jdt), jnp.asarray(ctx, jdt),
                           jnp.asarray(mask))
    tdt = getattr(torch, dtype)
    att = tgan.SpatialAttention(Cd, C, tdt)
    sd = {}
    tgan_conv = v["params"]["conv_context"]["kernel"]
    sd["conv_context.weight"] = torch.from_numpy(
        np.asarray(tgan_conv, np.float32).transpose(3, 2, 0, 1).copy())
    att.load_state_dict(sd)
    tx = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).to(tdt)
    with torch.no_grad():
        tout, tattn = att(tx, torch.from_numpy(ctx).to(tdt),
                          torch.from_numpy(mask))
    assert tout.dtype == tdt and tattn.dtype == torch.float32
    ref = np.asarray(out, np.float32)
    atol = 1e-5 if dtype == "float32" else 2.0 ** -7 * np.abs(ref).max()
    np.testing.assert_allclose(tout.float().numpy().transpose(0, 2, 3, 1),
                               ref, atol=atol, rtol=0)
    np.testing.assert_allclose(tattn.numpy(), np.asarray(attn, np.float32),
                               atol=1e-5, rtol=0)
    a = tattn.numpy().reshape(B, H * W, L)
    assert a[np.broadcast_to(mask[:, None], a.shape)].max() < 1e-4
    np.testing.assert_allclose(a.sum(-1), 1.0, atol=1e-5)


def _configs(**kw):
    base = dict(texture_resolution=RES, mesh_resolution=32, n_classes=(5,),
                conditional_text=True, text_embedding_dim=DIM)
    base.update(kw)
    return jgan.GANConfig(**base), tgan.GANConfig(**base)


@functools.lru_cache(maxsize=None)
def _caption():
    """Word features of TOKENS[:2] from a seeded flax encoder, and the
    padding mask, numpy."""
    jenc, params, _ = _encoder_pair(DIM, DIM // 2, 1)
    words, _ = jenc.apply({"params": params}, jnp.asarray(TOKENS[:2]))
    return np.asarray(words), TOKENS[:2] == 0


def _tcap(cap):
    return torch.from_numpy(cap[0]), torch.from_numpy(cap[1])


def _jcap(cap):
    return jnp.asarray(cap[0]), jnp.asarray(cap[1])


@functools.lru_cache(maxsize=None)
def _generator_init(cond: bool) -> dict:
    jg = jgan.Generator(_configs(conditional_class=cond)[0])
    c = jnp.zeros((2, 1), jnp.int32) if cond else None
    return _np(jax.jit(lambda r: jg.init(
        r, jnp.zeros((2, 64)), c, _jcap(_caption()), train=False))(
            jax.random.PRNGKey(0)))


@pytest.mark.parametrize("cond,train", [(False, False), (False, True),
                                        (True, True)])
def test_text_generator_matches_flax(cond, train):
    jcfg, tcfg = _configs(conditional_class=cond)
    rng = np.random.default_rng(6)
    z = rng.standard_normal((2, 64)).astype(np.float32)
    c = np.array([[1], [3]], np.int32) if cond else None
    cap = _caption()
    v = _perturb(_generator_init(cond), rng)
    (tex, mesh, attn), new = jgan.Generator(jcfg).apply(
        v, jnp.asarray(z), None if c is None else jnp.asarray(c),
        _jcap(cap), train=train, return_attention=True,
        mutable=["batch_stats"])
    port = tgan.Generator(tcfg)
    port.load_state_dict(generator_state_dict(v))
    port.train(train)
    with torch.no_grad():
        out = port(torch.from_numpy(z),
                   None if c is None else torch.from_numpy(c), _tcap(cap),
                   return_attention=True)
        plain = port.eval()(torch.from_numpy(z),
                            None if c is None else torch.from_numpy(c))
    assert out[2].shape == (2, 16, 16, L)
    for got, ref in zip(out, (tex, mesh, attn)):
        ref = np.asarray(ref)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-4 * max(1.0, np.abs(ref).max()))
    assert len(plain) == 2  # no caption: the attention is skipped
    want = generator_state_dict({"params": v["params"],
                                 "batch_stats": _np(new["batch_stats"])})
    have = port.state_dict()
    assert "att.conv_context.weight" in have
    for k in (k for k in want if "running" in k or "weight_u" in k):
        np.testing.assert_allclose(have[k].numpy(), want[k].numpy(),
                                   atol=1e-5, rtol=0, err_msg=k)


@pytest.mark.parametrize("texture_only,train", [
    (False, True), (False, False), (True, True)])
def test_text_critics_match_flax(texture_only, train):
    n_d = 2
    jcfg, tcfg = _configs(num_discriminators=n_d, texture_only=texture_only)
    res = RES
    rng = np.random.default_rng(7)
    x = rng.uniform(-1, 1, (2, res, res, 4)).astype(np.float32)
    x[..., 3] = (rng.random((2, res, res)) > 0.3).astype(np.float32)
    mesh = (rng.standard_normal((2, 32, 32, 3)) * 0.05).astype(np.float32)
    cap = _caption()
    jd = jgan.MultiScaleDiscriminator(jcfg)
    v = _perturb(_np(jax.jit(lambda r: jd.init(
        r, jnp.zeros((2, res, res, 4)), jnp.zeros((2, 32, 32, 3)), None,
        train=False, caption=_jcap(cap)))(jax.random.PRNGKey(1))), rng)
    (outs, masks), new = jd.apply(v, jnp.asarray(x), jnp.asarray(mesh), None,
                                  train=train, caption=_jcap(cap),
                                  alpha=jnp.asarray(x[..., 3:]),
                                  mutable=["batch_stats"])
    port = tgan.MultiScaleDiscriminator(tcfg)
    port.load_state_dict(discriminator_state_dict(v))
    port.train(train)
    assert port.d1.stride_first
    with torch.no_grad():
        touts, tmasks = port(torch.from_numpy(x), torch.from_numpy(mesh),
                             alpha=torch.from_numpy(x[..., 3:]),
                             caption=_tcap(cap))
    assert len(touts) == n_d
    for got, ref in zip(touts + tmasks, list(outs) + list(masks)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy().reshape(ref.shape), ref,
                                   rtol=0,
                                   atol=1e-4 * max(1.0, np.abs(ref).max()))
    want = discriminator_state_dict({"params": v["params"],
                                     "batch_stats": _np(new["batch_stats"])})
    have = port.state_dict()
    assert sum(k.endswith("att.conv_context.weight") for k in have) == n_d
    for k in (k for k in want if "weight_u" in k):
        np.testing.assert_allclose(have[k].numpy(), want[k].numpy(),
                                   atol=1e-5, rtol=0, err_msg=k)


@pytest.fixture(scope="module")
def text_cache(tmp_path_factory):
    root = tmp_path_factory.mktemp("text_cache")
    return make_synthetic_cub_cache(str(root), captions=True)


@pytest.mark.parametrize("augment,evaluate", [(True, False), (False, False),
                                              (True, True)])
def test_dataset_caption_items_match_jax(text_cache, augment, evaluate):
    kw = dict(texture_resolution=RES, conditional_text=True, augment=augment,
              evaluate=evaluate)
    for seed in (0, 3):
        j = JCub(text_cache, seed=seed, **kw)
        t = CubGANDataset(text_cache, seed=seed, **kw)
        assert t.n_words == j.n_words == 30
        assert t.caption_vocab == j.caption_vocab
        for epoch in (0, 1, 5):
            for idx in range(len(j)):
                ji, ti = j.item(idx, epoch), t.item(idx, epoch)
                assert ji.keys() == ti.keys() and "caption" in ti
                for k in ji:
                    assert np.asarray(ti[k]).dtype == np.asarray(ji[k]).dtype
                    np.testing.assert_array_equal(ti[k], ji[k], err_msg=k)
    for epoch in (0, 2):
        jb = list(j_batches(j, 2, seed=epoch, num_workers=1))
        tb = list(gan_batch_iterator(t, 2, seed=epoch, num_workers=1))
        assert len(jb) == len(tb) == 2
        for a, b in zip(jb, tb):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def test_caption_refusals(text_cache):
    """p3d with ``--conditional_text`` and the device cache with captions
    raise ``ValueError``."""
    ds = CubGANDataset(text_cache, texture_resolution=RES,
                       conditional_text=True)
    with pytest.raises(ValueError):
        DeviceGANCache(ds, 2, "cpu")
    with pytest.raises(ValueError):
        cli.main(["--name", "x", "--dataset", "p3d", "--conditional_text",
                  "--cache_dir", text_cache, "--device", "cpu"])


@pytest.fixture(scope="module")
def text_pair():
    jcfg, tcfg = _text_trainer_configs(lr_g=1e-6, lr_d=5e-7)
    jt = JTrainer(jcfg, template=JTemplate(segments=16, rings=8),
                  mesh=make_mesh(jax.devices()[:1]))
    pt = GANTrainer(tcfg, template=MeshTemplate(segments=16, rings=8),
                    device="cpu")
    pt.load_variables({"params": _np(jt.g_params),
                       "batch_stats": _np(jt.g_stats)},
                      {"params": _np(jt.d_params),
                       "batch_stats": _np(jt.d_stats)},
                      te_params=_np(jt.te_params))
    return jt, pt


def _text_batch(seed=0):
    rng = np.random.RandomState(seed)
    return dict(
        texture=rng.rand(2, RES, RES, 3).astype(np.float32) * 2 - 1,
        alpha=(rng.rand(2, RES, RES, 1) > 0.4).astype(np.float32),
        mesh=rng.randn(2, 32, 32, 3).astype(np.float32) * 0.02,
        caption=np.concatenate([TOKENS[:1], rng.randint(
            1, VOCAB, (1, L))]).astype(np.int32))


def test_text_g_and_d_steps_match_jax(text_pair):
    jt, pt = text_pair
    batch = _text_batch()
    for step, lr in (("g", 1e-6), ("d", 5e-7)):
        net = pt.generator if step == "g" else pt.discriminator
        before = {n: p.detach().clone() for n, p in net.named_parameters()}
        jax_before = (_gen({"params": jt.g_params}) if step == "g"
                      else _disc(jt.d_params, {}))
        z = torch.from_numpy(np.array(jax.random.normal(
            jax.random.fold_in(jt._rng, jt.total_it), (2, 64))))
        jl = {k: float(v) for k, v in jt.train_step(batch).items()}
        tl = {k: float(v) for k, v in pt.train_step(batch, z=z).items()}
        assert jl.keys() == tl.keys()
        for k in jl:
            np.testing.assert_allclose(tl[k], jl[k], rtol=1e-4, err_msg=k)
        opt = pt.opt_g if step == "g" else pt.opt_d
        adam = (jt.opt_g if step == "g" else jt.opt_d).inner_state[0]
        if step == "g":
            mu, nu = _gen({"params": adam.mu}), _gen({"params": adam.nu})
            params = _gen({"params": jt.g_params})
        else:
            mu, nu = _disc(adam.mu, {}), _disc(adam.nu, {})
            params = _disc(jt.d_params, {})
        assert any("att.conv_context" in k for k in mu)
        moments = (_moments(opt, net, "exp_avg"),
                   _moments(opt, net, "exp_avg_sq"))
        assert _rel(moments[0], mu) <= 1e-3
        assert _rel(moments[1], nu) <= 2e-3
        _close(dict(net.named_parameters()), params, 3e-6, "params")
        _check_update(lr, before, dict(net.named_parameters()), jax_before,
                      params, moments, (mu, nu))
    _close(pt.g_ema.state_dict(), _gen(jt.g_ema), 1e-5, "EMA")
    # the frozen encoder did not move, and generate() reads the captions
    _close(pt.text_encoder.state_dict(), text_encoder_state_dict(
        _np(jt.te_params)), 0, "text encoder")
    z = np.random.RandomState(2).randn(2, 64).astype(np.float32)
    jtex, jmesh = jt.generate(jnp.asarray(z),
                              caption_tokens=batch["caption"])
    ttex, tmesh = pt.generate(torch.from_numpy(z),
                              caption_tokens=batch["caption"])
    for got, ref in ((ttex, jtex), (tmesh, jmesh)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-4)


def test_text_save_restore_continue_is_bit_equal(tmp_path):
    _, tcfg = _text_trainer_configs()
    template = MeshTemplate(segments=8, rings=4)
    batches = [_text_batch(10 + i) for i in range(4)]
    a = GANTrainer(tcfg, template=template, workdir=str(tmp_path),
                   device="cpu")
    for b in batches[:3]:
        a.train_step(b)
    a.save()
    a.train_step(batches[3])
    b = GANTrainer(tcfg, template=template, workdir=str(tmp_path),
                   device="cpu", )
    with torch.no_grad():  # a different encoder before the restore
        b.text_encoder.encoder.weight.add_(1.0)
    b.restore()
    assert b.total_it == 3
    b.train_step(batches[3])
    for x, y in ((a.generator, b.generator),
                 (a.discriminator, b.discriminator), (a.g_ema, b.g_ema),
                 (a.text_encoder, b.text_encoder)):
        for (k, v), w in zip(x.state_dict().items(),
                             y.state_dict().values()):
            assert torch.equal(v, w), k


def test_gan_cli_text_conditional(text_cache, tmp_path, monkeypatch):
    """``--conditional_text`` through the CLI: one epoch with FID and the
    grid, the grid's captions decoded in the log; the pretrained encoder
    (a seeded AttnGAN-shaped ``.pth``, 30 words) loaded and used; then
    ``--save_results``."""
    root = os.path.dirname(os.path.dirname(text_cache))
    monkeypatch.chdir(root)
    monkeypatch.setattr(cli, "EVALUATION_RES", 32)
    monkeypatch.setattr(cli, "GRID_RES", 32)
    monkeypatch.setattr(inception, "init_inception",
                        lambda device: _PoolFeatures())
    pth = str(tmp_path / "text_encoder200.pth")
    torch.save(_attngan_state_dict(30, 20, 128, 9), pth)
    args = ["--name", "txt", "--dataset", "cub", "--texture_resolution",
            str(RES), "--batch_size", "2", "--num_discriminators", "2",
            "--device", "cpu", "--num_workers", "1", "--conditional_text",
            "--text_pretrained_encoder", pth]
    assert cli.main([*args, "--epochs", "1", "--evaluate_freq", "1",
                     "--save_freq", "1"]) == 0
    workdir = os.path.join(root, "gan_weights", "txt")
    with open(os.path.join(workdir, "log.txt")) as fh:
        log = fh.read()
    assert "sample captions:" in log and "word" in log
    with open(os.path.join(workdir, "metrics_gan.jsonl")) as fh:
        assert "g_loss" in fh.read()
    ckpt = torch.load(os.path.join(workdir, "checkpoints",
                                   "checkpoint_2.pt"), weights_only=True)
    want = _attngan_state_dict(30, 20, 128, 9)
    assert ckpt["te"].keys() == want.keys()
    for k in want:
        assert torch.equal(ckpt["te"][k], want[k]), k
    assert "att.conv_context.weight" in ckpt["g"]
    assert cli.main([*args, "--save_results"]) == 0
    assert len([f for f in os.listdir(os.path.join(root, "results", "txt"))
                if f.endswith(".obj")]) == 2
