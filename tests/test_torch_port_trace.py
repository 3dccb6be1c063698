"""The port's spans and copy counters (``core/profiler.py``) on the CPU.

* Under ``torch.profiler`` a GAN G step, a GAN D step and a recon step
  each record one ``im23d.train.step`` range with its phases nested in it
  as siblings, in the order the step runs them; the FID path records its
  five spans in order, and the threaded feed one ``im23d.feed.wait`` a
  batch.
* With no profiler recording, ``span`` returns the one shared null
  context.
* ``COUNTERS`` count a host-to-CUDA copy's bytes and nothing else (the
  rule through ``copy_bytes``; no card needed); a marked test checks
  ``h2d_bytes`` against the recon trainer's ``_put`` on a card.
* ``StepProfiler``'s Chrome trace holds the program's spans.
* K9's autograd backward counts its formula's calls
  (``_fused_conv_backward.launches``).

The trainers are the smallest of ``tests/test_torch_port_gan_train.py``
and ``tests/test_torch_port_recon_train.py``.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from im23d_tpu_torch.core import profiler as prof_mod
from im23d_tpu_torch.core.profiler import (
    COUNTERS,
    StepProfiler,
    copy_bytes,
    span,
    to_device,
    to_host,
)
from im23d_tpu_torch.data.prefetch import prefetched_batches
from im23d_tpu_torch.geometry.mesh_template import MeshTemplate
from im23d_tpu_torch.models.gan import GANConfig
from im23d_tpu_torch.ops import conv
from im23d_tpu_torch.train.gan_eval import FIDEvaluator
from im23d_tpu_torch.train.gan_trainer import GANTrainConfig, GANTrainer
from im23d_tpu_torch.train.recon_trainer import ReconConfig, ReconTrainer

GAN_RES, RECON_RES, BS = 128, 64, 2
PHASES = {
    "gan_g": ["put", "sample_z", "forward", "optimizer", "backward",
              "optimizer", "ema"],
    "gan_d": ["put", "sample_z", "forward", "optimizer", "backward",
              "optimizer"],
    "recon": ["put", "forward", "render", "loss", "optimizer", "backward",
              "optimizer"],
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread beside the suite's other workers (as the GAN
    and recon train test files)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def gan():
    kw = dict(texture_resolution=GAN_RES, mesh_resolution=32,
              n_classes=(5,), conditional_class=True)
    return GANTrainer(GANTrainConfig(model=GANConfig(**kw), batch_size=BS),
                      template=MeshTemplate(segments=16, rings=8),
                      device="cpu")


@pytest.fixture(scope="module")
def recon():
    return ReconTrainer(ReconConfig(image_resolution=RECON_RES,
                                    texture_resolution=RECON_RES,
                                    batch_size=BS),
                        dataset_size=4,
                        template=MeshTemplate(segments=16, rings=8),
                        device="cpu")


def _gan_batch():
    rng = np.random.RandomState(0)
    return dict(
        texture=rng.rand(BS, GAN_RES, GAN_RES, 3).astype(np.float32) * 2 - 1,
        alpha=(rng.rand(BS, GAN_RES, GAN_RES, 1) > 0.4).astype(np.float32),
        mesh=rng.randn(BS, 32, 32, 3).astype(np.float32) * 0.02,
        c=np.array([[1], [3]], np.int32))


def _recon_batch():
    rng = np.random.RandomState(1)
    img = rng.uniform(-1, 1, (BS, RECON_RES, RECON_RES, 4)).astype(
        np.float32)
    img[..., 3] = (rng.rand(BS, RECON_RES, RECON_RES) > 0.5).astype(
        np.float32)
    rot = rng.randn(BS, 4).astype(np.float32)
    return dict(image=img, scale=np.full(BS, 0.7, np.float32),
                translation=(rng.randn(BS, 3) * 0.05).astype(np.float32),
                rotation=rot / np.linalg.norm(rot, axis=-1, keepdims=True),
                idx=np.arange(BS, dtype=np.int32))


def _ranges(p):
    """The program's ranges of a profile, (start, end, name), by start."""
    return sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in p.profiler.kineto_results.events()
                  if e.is_user_annotation()
                  and e.name().startswith(prof_mod.PREFIX))


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as p:
        fn()
    return _ranges(p)


@pytest.mark.parametrize("kind", sorted(PHASES))
def test_step_records_its_phases_in_order(kind, gan, recon):
    if kind == "recon":
        trainer, batch = recon, _recon_batch()
    else:
        trainer, batch = gan, _gan_batch()
        while (trainer.total_it % 3 == 0) != (kind == "gan_g"):
            trainer.train_step(batch)
    ranges = _traced(lambda: trainer.train_step(batch))
    steps = [r for r in ranges if r[2] == "im23d.train.step"]
    assert len(steps) == 1
    s0, s1, _ = steps[0]
    phases = [r for r in ranges if r[2] != "im23d.train.step"]
    assert all(s0 <= a and b <= s1 for a, b, _ in phases)
    assert [n for _, _, n in phases] == [
        "im23d.train." + p for p in PHASES[kind]]
    for (_, b, _), (a, _, _) in zip(phases, phases[1:]):
        assert b <= a  # siblings: none nested in another


def test_fid_path_records_its_spans_in_order(gan):
    class MeanPool(torch.nn.Module):  # stands in for Inception
        def forward(self, img):
            return img.mean(dim=(1, 2))

    ev = FIDEvaluator(gan, gan.template, evaluation_res=32,
                      inception=MeanPool())
    rng = np.random.RandomState(2)
    rot = rng.randn(BS, 4).astype(np.float32)
    batch = dict(scale=np.full(BS, 0.7, np.float32),
                 translation=np.zeros((BS, 3), np.float32),
                 rotation=rot / np.linalg.norm(rot, axis=-1, keepdims=True),
                 c=np.array([1, 3]))
    before = dict(COUNTERS)
    ranges = _traced(lambda: ev.activations_for_batches(
        [batch], truncation_sigma=1.0))
    assert [n for _, _, n in ranges] == [
        "im23d.infer." + p for p in ("sample_z", "generate", "render",
                                     "embed", "to_host")]
    assert COUNTERS == before  # no copy between host and a CUDA device


def test_threaded_feed_records_each_wait():
    ranges = _traced(lambda: list(prefetched_batches(
        [[i] for i in range(6)], lambda idx: idx, num_workers=2,
        lookahead=1)))
    assert [n for _, _, n in ranges] == ["im23d.feed.wait"] * 6


def test_span_is_the_shared_null_context_when_not_recording():
    assert not torch._C._autograd._profiler_enabled()
    assert span("train.step") is span("train.forward", 3)
    with span("train.step") as out:
        assert out is None
    with profile(activities=[ProfilerActivity.CPU]):
        assert span("train.step") is not span("train.step")


@pytest.mark.parametrize("src,dst,counted", [
    ("cpu", "cuda", True), ("cpu", "cuda:1", True), ("cpu", "cpu", False),
    ("meta", "cuda", False)])
def test_copy_bytes_counts_host_to_cuda_only(src, dst, counted):
    t = torch.empty((3, 5), dtype=torch.float16, device=src)
    assert copy_bytes(t, torch.device(dst)) == (30 if counted else 0)
    assert copy_bytes(t, dst) == (30 if counted else 0)


def test_host_copies_are_not_counted():
    before = dict(COUNTERS)
    t = torch.ones(7, dtype=torch.float64)
    assert to_device(t, "cpu") is t
    assert to_host(t) is t
    assert COUNTERS == before


def test_step_profiler_trace_holds_the_spans(tmp_path, recon):
    sp = StepProfiler(str(tmp_path), start=0, steps=2)
    for _ in range(3):
        sp.tick()
        recon.train_step(_recon_batch())
    sp.close()
    (path,) = tmp_path.glob("trace_steps_*.json")
    names = [e.get("name") for e in json.loads(path.read_text())
             ["traceEvents"]]
    assert names.count("im23d.train.step") == 2
    assert names.count("im23d.train.render") == 2


def test_k9_backward_counts_its_calls():
    x = torch.randn(2, 16, 4, 8, requires_grad=True)
    a = torch.rand(2, 16, requires_grad=True)
    b = torch.randn(2, 16, requires_grad=True)
    w = torch.randn(16, 16, 3, 3, requires_grad=True)
    before = conv._fused_conv_backward.launches
    conv._fused_conv_op(x, a, b, w, "replicate").sum().backward()
    assert conv._fused_conv_backward.launches == before + 1
    with torch.no_grad():
        conv._fused_conv_op(x, a, b, w, "replicate")
    assert conv._fused_conv_backward.launches == before + 1


@pytest.mark.cuda
def test_put_counts_its_host_to_device_bytes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    trainer = ReconTrainer(ReconConfig(image_resolution=RECON_RES,
                                       texture_resolution=RECON_RES,
                                       batch_size=BS), dataset_size=4,
                           template=MeshTemplate(segments=16, rings=8),
                           device="cuda")
    batch = _recon_batch()
    before = COUNTERS["h2d_bytes"]
    nb = trainer._put(batch)
    assert COUNTERS["h2d_bytes"] - before == sum(
        v.nbytes for v in batch.values())
    before = COUNTERS["h2d_bytes"]
    trainer._put(nb)  # already on the card: no copy
    assert COUNTERS["h2d_bytes"] == before
