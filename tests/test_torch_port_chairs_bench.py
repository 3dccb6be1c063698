"""The chairs benchmark cell (``portbench``'s ``shapenet_chairs.train``)
and what it reads of the port, on the CPU at a small size in float32.

* The plain reference ``portbench/reference/pointcloud.py`` against the
  port's ``UnsupervisedPart`` + ``unsupervised_loss`` + AdamW
  (``ShapeNetLearner``) on seeded random weights: forward outputs, the
  K-way sweep's silhouettes, the losses, every parameter's gradient and
  the parameters after three steps.  Both compute in float32 from the
  same weights and batches; what is left is the order of sums (band
  matmul against convolution for the blur, the splat's order of adds,
  the rotation as a cross product against a matrix), so each number is
  held near float32's rounding, and a bfloat16 trunk fails them.
* The cell driven through ``portbench.run.measure`` at a tiny size: a
  sound run reads under 1e-4 on every number it compares, and each fault
  the calibration plants comes out not correct.
* The learner's spans, nested as the step runs them, the batch's bytes in
  ``COUNTERS["h2d_bytes"]`` through ``_normalize`` (value unchanged), and
  the projection's ``projected_clouds`` / ``reused_silhouettes``.
* K1's and K2's kernel files reproduce ``chip_smoke.py``'s bounds at the
  chairs shapes (0.248 and 0.242 ms).
"""

import copy
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from im23d_tpu_torch.core import profiler as prof_mod
from im23d_tpu_torch.core.profiler import COUNTERS
from im23d_tpu_torch.data.shapenet import DataBunch
from im23d_tpu_torch.losses.effective import unsupervised_loss
from im23d_tpu_torch.train import shapenet_learner
from im23d_tpu_torch.train.shapenet_learner import (
    ShapeNetConfig,
    ShapeNetLearner,
)
from portbench.lib.bounds import seconds
from portbench.lib.chairs_inputs import ChairRenders
from portbench.lib.common import first_moment, rel_l2, seeded_state
from portbench.lib.harness import load_cell
from portbench.lib.trace import KernelWraps, kernel_spec
from portbench.reference import pointcloud as ref_pc
from portbench.run import measure

B, V, K, N, IMG, S = 2, 2, 2, 64, 32, 16
MODEL = dict(image_size=IMG, voxel_size=S, num_points=N, num_views=V,
             num_candidates=K)
TRAIN = dict(learning_rate=1e-3, weight_decay=1e-3, total_steps=130_000,
             p_schedule=(0.07, 1.0), sigma_schedule=(3.0, 0.2),
             student_weight=20.0)
# float32 against float32 from the same weights: a few ulps of each
# output, grown through the tanh, the nine convs and the 3-tap
# interpolations
OUT_TOL = 1e-5
# the sweep: the splat's adds in another order, the blur convolved where
# the port multiplies by a band matrix, the rotation as a matrix
SWEEP_TOL = 1e-5
LOSS_TOL = 1e-5
# every leaf's gradient, relative L2: the projection's VJP adds over
# 16³ voxels and 64 points in another order, then through the network
GRAD_TOL = 1e-4
# after three AdamW steps: m / sqrt(v) of one or two steps divides out
# the gradients' scale, so an element whose gradient is near zero moves
# by a share of lr on rounding alone; relative L2 of the parameters
STEP_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _learner(dtype: str = "float32") -> ShapeNetLearner:
    cfg = ShapeNetConfig(**MODEL, **TRAIN, batch_size=B, seed=7,
                         compute_dtype=dtype)
    learner = ShapeNetLearner(cfg, device="cpu")
    learner.model.load_state_dict(_state(learner.model))
    return learner


def _state(model) -> dict:
    return seeded_state(model, 11, torch.device("cpu"))


def _host_batches(n: int) -> list:
    data = ChairRenders(5, 6, IMG, V, torch.device("cpu"))
    it = DataBunch((data, data), batch_size=B, use_camera=False,
                   seed=3, num_workers=2).train_iter()
    try:
        return [next(it) for _ in range(n)]
    finally:
        it.close()


def _float(batch: dict) -> dict:
    return {k: torch.as_tensor(v).float() / 255.0 for k, v in batch.items()}


@pytest.fixture(scope="module")
def parity():
    """The port and the reference from one state over three batches: the
    first step's outputs, sweep, losses and gradients, then the
    parameters after three steps."""
    batches = _host_batches(3)
    port = _learner()
    ref = ref_pc.ChairsSteps(MODEL, TRAIN, _state(port.model), 7, "cpu")
    kept = {}

    def keep(outputs, masks, sigma, keep_w, *a, **kw):
        if not kept:
            kept["out"] = {k: v.detach().clone() for k, v in outputs.items()}
            kept["keep"] = keep_w.clone()
            losses, aux = unsupervised_loss(outputs, masks, sigma, keep_w,
                                            *a, **kw)
            kept["sweep"] = aux["projection"].clone()
            kept["losses"] = {k: float(v.detach())
                              for k, v in losses.items()}
            return losses, aux
        return unsupervised_loss(outputs, masks, sigma, keep_w, *a, **kw)

    grads = {}  # Adam's first moment after one step over 1 - beta1
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(shapenet_learner, "unsupervised_loss", keep)
        port.train_step(batches[0])
    grads["port"] = first_moment(port.opt, port.model, scale=0.1)
    for b in batches[1:]:
        port.train_step(b)
    fb = _float(batches[0])
    ref_losses = ref.train_step(fb)
    grads["ref"] = first_moment(ref.opt, ref.net, scale=0.1)
    ref_out = ref.last_out
    _, sigma = ref.schedules(0)
    masks_s = ref_pc.resize_masks(fb["masks"], S)
    ref_keep = ref.keep(0, B)
    with torch.no_grad():
        ref_sweep = ref_pc.sweep(kept["out"]["point_cloud"],
                                 kept["out"]["ensemble_q"],
                                 kept["out"]["scale"], ref_keep, sigma, S)
    for b in batches[1:]:
        ref.train_step(_float(b))
    return dict(kept=kept, ref_out=ref_out, ref_keep=ref_keep,
                ref_sweep=ref_sweep, ref_losses=ref_losses, grads=grads,
                port=dict(port.model.named_parameters()),
                ref=dict(ref.net.named_parameters()), batches=batches)


def test_outputs(parity):
    for k, want in parity["ref_out"].items():
        assert rel_l2(parity["kept"]["out"][k], want) <= OUT_TOL, k


def test_keep_mask_and_sweep(parity):
    assert torch.equal(parity["kept"]["keep"], parity["ref_keep"])
    assert rel_l2(parity["kept"]["sweep"], parity["ref_sweep"]) <= SWEEP_TOL


def test_losses(parity):
    for k, want in parity["ref_losses"].items():
        got = parity["kept"]["losses"][k]
        assert abs(got - want) <= LOSS_TOL * abs(want), (k, got, want)


def test_gradients_of_every_parameter(parity):
    port, ref = parity["grads"]["port"], parity["grads"]["ref"]
    assert set(port) == set(ref)
    for k in ref:
        assert rel_l2(port[k], ref[k]) <= GRAD_TOL, k


def test_parameters_after_three_steps(parity):
    for k, want in parity["ref"].items():
        assert rel_l2(parity["port"][k], want) <= STEP_TOL, k


def test_a_bfloat16_trunk_fails_the_outputs(parity):
    port = _learner("bfloat16")
    fb = _float(parity["batches"][0])
    with torch.no_grad():
        out = port.model(fb["images"], fb["pose_input"])
    worst = max(rel_l2(out[k], v) for k, v in parity["ref_out"].items())
    assert worst > 10 * OUT_TOL


# --- the cell through the harness ------------------------------------------

def _tiny_cell():
    traffic, config, entry = load_cell("shapenet_chairs.train")
    config = copy.deepcopy(config)
    config["dataset_size"] = 8
    config["model"].update(MODEL, compute_dtype="float32")
    traffic = dict(traffic, batch_size=B, feed_threads=2, warmup_steps=1)
    return traffic, config, entry


@pytest.mark.parametrize("fault", [None, "unchanged", "half_batch",
                                   "dense_keep", "no_winner_grad", "argmax"],
                         ids=lambda f: f or "sound")
def test_cell_on_the_cpu(fault):
    result, rows, _, detail = measure(
        "shapenet_chairs.train", 2147483911, 1.0, False,
        torch.device("cpu"), fault=fault, files=_tiny_cell())
    assert result["attempted"] >= 1
    assert result["correct"] is (fault is None), rows
    if fault is None:
        for name, value, _ in rows:
            assert value <= 1e-4, (name, value)
        assert detail["argmin_agrees"] == 1.0


def test_cell_counts_its_flops():
    traffic, config, entry = _tiny_cell()
    cell = entry.Cell(config, traffic, 3, "cpu")
    assert cell.flops_per_call() > 0


# --- spans and counters ------------------------------------------------------

def _ranges(p):
    return sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in p.profiler.kineto_results.events()
                  if e.is_user_annotation()
                  and e.name().startswith(prof_mod.PREFIX))


def test_step_records_its_phases_nested():
    learner = _learner()
    host = _host_batches(2)
    pending = learner.put_batch(host[0])
    with profile(activities=[ProfilerActivity.CPU]) as p:
        nxt = learner.put_batch(host[1])
        learner.train_step(pending)
    ranges = _ranges(p)
    assert ranges[0][2] == "im23d.train.put"  # the next batch, outside
    (s0, s1, _), = [r for r in ranges if r[2] == "im23d.train.step"]
    inner = [r for r in ranges if s0 <= r[0] and r[1] <= s1
             and r[2] != "im23d.train.step"]
    (p0, p1, _), = [r for r in inner if r[2] == "im23d.train.project"]
    (l0, l1, _), = [r for r in inner if r[2] == "im23d.train.loss"]
    assert l0 <= p0 and p1 <= l1
    phases = [r[2] for r in inner if r[2] != "im23d.train.project"]
    assert phases == ["im23d.train." + n for n in (
        "put", "forward", "loss", "optimizer", "backward", "optimizer")]
    assert nxt["images"].dtype == torch.float32


def test_feed_records_each_wait():
    data = ChairRenders(5, 6, IMG, V, torch.device("cpu"))
    it = DataBunch((data, data), batch_size=B, use_camera=False,
                   num_workers=2).train_iter()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as p:
            for _ in range(3):
                next(it)
    finally:
        it.close()
    assert [n for _, _, n in _ranges(p)] == ["im23d.feed.wait"] * 3


def test_step_counts_its_copies_and_projections(monkeypatch):
    """``copy_bytes`` counts only host-to-CUDA copies; counting every
    copy's bytes here shows what ``_normalize`` hands it."""
    monkeypatch.setattr(prof_mod, "copy_bytes",
                        lambda t, device: t.numel() * t.element_size())
    learner = _learner()
    host = _host_batches(1)[0]
    before = dict(COUNTERS)
    learner.train_step(host)
    grew = {k: COUNTERS[k] - before[k] for k in before}
    assert grew["h2d_bytes"] == sum(v.nbytes for v in host.values())
    assert grew["projected_clouds"] == B * V * K
    assert grew["reused_silhouettes"] == B * V
    assert grew["d2h_bytes"] == 0


def test_normalize_copies_through_to_device_unchanged(monkeypatch):
    calls = []

    def counted(t, device, non_blocking=False):
        calls.append(t.dtype)
        return t.to(device, non_blocking=non_blocking)

    monkeypatch.setattr(shapenet_learner, "to_device", counted)
    learner = _learner()
    host = _host_batches(1)[0]
    out = learner._normalize(host)
    assert calls == [torch.uint8] * len(host)
    for k, v in host.items():
        assert torch.equal(out[k], torch.from_numpy(np.asarray(v)).float()
                           / 255.0)
    again = learner._normalize(out)
    assert all(torch.equal(again[k], out[k]) for k in out)


# --- K1's and K2's bounds ----------------------------------------------------

def test_k1_bound_at_the_sweep():
    C, Np = 480, 8000
    plane = torch.empty(C, Np, device="meta")
    taps = torch.empty(21, device="meta")
    scale = torch.empty(C, device="meta")
    out = torch.empty(C, 64, 64, device="meta")
    args = (plane, plane, plane, plane, taps, scale, 64, 1e-5)
    nbytes, ops, peak = kernel_spec("k1").bound(args, out)
    assert 1e3 * seconds(nbytes, ops, peak) == pytest.approx(0.248, abs=5e-4)
    assert nbytes == 4 * C * Np * 4 + 21 * 4 + C * 4 + C * 64 * 64 * 4


@pytest.mark.parametrize("split", [True, False], ids=["split", "unsplit"])
def test_k1_entry_where_the_program_has_it(split, monkeypatch):
    """K1 is timed at ``_projection_forward``; a program without it (an
    earlier one) wraps nothing that runs, so a traced run there reads no
    ``k1_roofline.train`` and does not fail."""
    from im23d_tpu_torch.ops import projection

    if not split:
        monkeypatch.delattr(projection, "_projection_forward")
    spec = kernel_spec("k1")
    assert (spec.ENTRY == "im23d_tpu_torch.ops.projection:"
            "_projection_forward") is split
    wraps = KernelWraps(["k1"])
    try:
        assert wraps.counters() == {"k1": projection.projection_kernel.launches
                                    if split else 0}
    finally:
        wraps.remove()
    assert hasattr(projection, "_projection_forward") is split


def test_k2_bound_at_the_winners():
    C, Np = 120, 8000
    plane = torch.empty(C, Np, device="meta")
    ctx = SimpleNamespace(saved_tensors=(
        plane, plane, plane, plane, torch.empty(21, device="meta"),
        torch.empty(C, device="meta")))
    gsil = torch.empty(C, 64, 64, device="meta")
    nbytes, ops, peak = kernel_spec("k2").bound((ctx, gsil), None)
    assert 1e3 * seconds(nbytes, ops, peak) == pytest.approx(0.242, abs=5e-4)
    assert nbytes == 7 * C * Np * 4 + 21 * 4 + 2 * C * 4 + C * 64 * 64 * 4
