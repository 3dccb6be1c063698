"""The recon network's forward and backward replayed from CUDA graphs in
``ReconTrainer.train_step`` (``train/recon_graph.py``).

On the CPU (no card needed):

* ``train_step`` takes the eager path: ``recon_eager_steps`` counts each
  step, ``recon_graph_steps`` stays 0, and the module's own ``forward``
  runs (nothing is installed over it);
* ``graph_action``, the rule that decides replay against eager, one case
  per condition: device, data group, mode, input shape and dtype,
  parameter and buffer storages;
* ``storages`` follows a parameter replaced by a new tensor, not one
  copied into;
* a forward hook on ``trainer.model`` sees each step's outputs.

A marked test (``-m cuda``, on a card) runs ``chip_smoke.py``'s phase 41
comparison at the ``cub_recon`` cell's shapes: graphed steps against eager
steps from the same weights and batches, a ``restore()`` and a step, an
``eval_step``, a tail batch (eager) and a new capture after a parameter's
storage was replaced, held bit-equal (or within ``GRAPH_RL2``) where every
kernel of the step is deterministic.
"""

import numpy as np
import pytest
import torch

from im23d_tpu_torch.core.profiler import COUNTERS
from im23d_tpu_torch.geometry.mesh_template import MeshTemplate
from im23d_tpu_torch.models.reconstruction import ReconstructionNetwork
from im23d_tpu_torch.train.recon_graph import (
    CAPTURE,
    EAGER,
    REPLAY,
    graph_action,
    input_spec,
    storages,
)
from im23d_tpu_torch.train.recon_trainer import ReconConfig, ReconTrainer

RES, BS = 64, 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread beside the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trainer():
    return ReconTrainer(ReconConfig(image_resolution=RES,
                                    texture_resolution=RES, batch_size=BS),
                        dataset_size=4,
                        template=MeshTemplate(segments=16, rings=8),
                        device="cpu")


def _batch(seed: int):
    rng = np.random.RandomState(seed)
    img = rng.uniform(-1, 1, (BS, RES, RES, 4)).astype(np.float32)
    img[..., 3] = (rng.rand(BS, RES, RES) > 0.5).astype(np.float32)
    rot = rng.randn(BS, 4).astype(np.float32)
    return dict(image=img, scale=np.full(BS, 0.7, np.float32),
                translation=(rng.randn(BS, 3) * 0.05).astype(np.float32),
                rotation=rot / np.linalg.norm(rot, axis=-1, keepdims=True),
                idx=np.arange(BS, dtype=np.int32))


def test_cpu_steps_run_eagerly(trainer):
    before = dict(COUNTERS)
    for seed in range(3):
        trainer.train_step(_batch(seed))
    assert COUNTERS["recon_eager_steps"] - before["recon_eager_steps"] == 3
    assert COUNTERS["recon_graph_steps"] == before["recon_graph_steps"]
    assert trainer.graphs.captured is None
    assert "forward" not in vars(trainer.model)


def _net():
    return ReconstructionNetwork(texture_res=64, image_res=32)


NET = _net()
IMAGE = torch.zeros(BS, 32, 32, 4)
SPEC, STORES = input_spec(IMAGE), storages(NET)
CAPTURED = (SPEC, STORES)
MOVED = STORES[:1] + ((STORES[1][0] + 4,) + STORES[1][1:],) + STORES[2:]


@pytest.mark.parametrize("device, group, training, spec, stores, captured, "
                         "want", [
    ("cpu", None, True, SPEC, STORES, CAPTURED, EAGER),  # the CPU
    ("cuda", object(), True, SPEC, STORES, CAPTURED, EAGER),  # --multihost
    ("cuda", None, False, SPEC, STORES, CAPTURED, EAGER),  # eval mode
    ("cuda", None, True, SPEC, STORES, None, CAPTURE),  # first step
    ("cuda", None, True, SPEC, STORES, CAPTURED, REPLAY),  # same again
    ("cuda", None, True, input_spec(IMAGE[:1]), STORES, CAPTURED,
     EAGER),  # a tail batch
    ("cuda", None, True, input_spec(IMAGE.double()), STORES, CAPTURED,
     EAGER),  # another dtype
    ("cuda", None, True, SPEC, MOVED, CAPTURED, CAPTURE),  # a new storage
    ("cuda", None, True, SPEC, STORES[:-1], CAPTURED,
     CAPTURE),  # a buffer fewer
], ids=["cpu", "data_group", "eval", "first", "replay", "tail_batch",
        "dtype", "storage", "buffers"])
def test_graph_action(device, group, training, spec, stores, captured,
                      want):
    assert graph_action(device, group, training, spec, stores,
                        captured) == want


@pytest.mark.parametrize("change, moved", [
    ("copy_into", False), ("new_tensor", True), ("new_parameter", True),
    ("frozen", True), ("buffer_copy", False)])
def test_storages_follow_replacement(change, moved):
    net = _net()
    before = storages(net)
    w = net.conv_mesh.weight
    with torch.no_grad():
        if change == "copy_into":
            w.copy_(torch.ones_like(w))
        elif change == "new_tensor":
            w.data = w.data.clone()
        elif change == "new_parameter":
            net.conv_mesh.weight = torch.nn.Parameter(w.detach().clone())
        elif change == "frozen":
            w.requires_grad_(False)
        else:
            net.bn1e.running_mean.fill_(2.0)
    assert (storages(net) != before) == moved


def test_forward_hook_sees_each_step(trainer):
    seen = []

    def keep(module, args, out):
        seen.append([o.detach().clone() for o in out])
        for o in out:
            o.retain_grad()
        keep.out = out

    hook = trainer.model.register_forward_hook(keep)
    try:
        for seed in range(2):
            trainer.train_step(_batch(seed))
            tex, mesh_map = keep.out
            assert tex.shape == (BS, RES, RES, 3)
            assert mesh_map.shape == (BS, 32, 32, 3)
            # the outputs the step rendered and took the loss through
            assert tex.grad is not None and mesh_map.grad is not None
    finally:
        hook.remove()
    assert len(seen) == 2
    assert not torch.equal(seen[0][0], seen[1][0])


@pytest.mark.cuda
def test_graphed_steps_match_eager(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from chip_smoke import GRAPH_RL2, GRAPH_STEPS, recon_graph_readings

    readings = recon_graph_readings(MeshTemplate(segments=32, rings=16),
                                    str(tmp_path))
    for got in readings.values():
        assert got["counts"][0] == dict(
            recon_graph_steps=GRAPH_STEPS + 3, recon_eager_steps=1)
    gaps = readings["deterministic"]["graphed_eager"]
    assert gaps["counters"]
    assert gaps["losses"] <= GRAPH_RL2
    for key in ("steps", "restored", "tail", "replaced", "seen",
                "eval_render"):
        assert gaps[key][1] <= GRAPH_RL2, (key, gaps[key])
