"""The GAN CLI of the PyTorch port (``im23d_tpu_torch.cli.main``) on a tiny
reference-format pseudo-ground-truth cache, on the CPU: 2 training epochs
then a resumed third, bit-equal to 3 uninterrupted epochs; ``--evaluate``
(finite FIDs, the three variants and the val split; ``--which_epoch best``
sweeps the numbered checkpoints); ``--save_results`` (obj / mtl / png per
sample and the grid).

The suite runs this file beside five other workers, so the FID path is cut
to what the CLI itself decides: FID and grid renders at 32²
(``EVALUATION_RES``, ``GRID_RES``: 299² and 256² on the card, with the
plain rasterizer on the CPU), and a 288-d average-pool of the render in
place of the
Inception extractor (held to JAX in ``tests/test_torch_port_pseudogt.py``),
which matches the cache's 288-d statistics.
"""

import math
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from im23d_tpu_torch.cli import main as cli
from im23d_tpu_torch.metrics import inception
from test_cli_main import make_synthetic_cub_cache


class _PoolFeatures(torch.nn.Module):
    """(B, R, R, 3) in [0, 1] -> (B, 288): a 12 × 8 average-pool per
    channel."""

    def forward(self, img):
        x = F.adaptive_avg_pool2d(img.permute(0, 3, 1, 2), (12, 8))
        return x.reshape(x.shape[0], -1)

ARGS = ["--dataset", "cub", "--texture_resolution", "128", "--batch_size",
        "2", "--num_discriminators", "2", "--device", "cpu",
        "--num_workers", "1", "--save_freq", "1", "--checkpoint_freq", "1"]


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



@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The cache, a 2 + 1 epoch run "resumed" and a 3 epoch run "straight";
    FID after epoch 2 in both."""
    root = tmp_path_factory.mktemp("gan_cli")
    make_synthetic_cub_cache(str(root))
    mp = pytest.MonkeyPatch()
    mp.chdir(root)
    mp.setattr(cli, "EVALUATION_RES", 32)
    mp.setattr(cli, "GRID_RES", 32)
    mp.setattr(inception, "init_inception", lambda device: _PoolFeatures())
    logs = {}
    try:
        for name, legs in (("resumed", (["--epochs", "2"],
                                        ["--epochs", "3",
                                         "--continue_train"])),
                           ("straight", (["--epochs", "3"],))):
            for leg in legs:
                assert cli.main(["--name", name, "--evaluate_freq", "2",
                                 *ARGS, *leg]) == 0
            with open(os.path.join("gan_weights", name,
                                   "metrics_gan.jsonl")) as fh:
                logs[name] = fh.read()
        yield root, mp, logs
    finally:
        mp.undo()


def _ckpt(root, name, step):
    return torch.load(os.path.join(root, "gan_weights", name, "checkpoints",
                                   f"checkpoint_{step}.pt"),
                      weights_only=True)


def test_training_resume_is_bit_equal(runs):
    root, _, logs = runs
    a, b = _ckpt(root, "resumed", 6), _ckpt(root, "straight", 6)
    assert a["total_it"] == b["total_it"] == 6 and a["epoch"] == 3
    for key in ("g", "d", "g_ema"):
        assert a[key].keys() == b[key].keys()
        for k in a[key]:
            assert torch.equal(a[key][k], b[key][k]), (key, k)
    for key in ("opt_g", "opt_d"):
        for sa, sb in zip(a[key]["state"].values(),
                          b[key]["state"].values()):
            assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert "fid_uncalibrated/combined_val" in logs["resumed"]
    assert os.path.exists(os.path.join(
        root, "gan_weights", "resumed", "images",
        "samples_render_00000004.png"))


def test_evaluate_prints_finite_fids(runs, capsys):
    capsys.readouterr()
    for extra in ([], ["--which_epoch", "best"]):
        assert cli.main(["--name", "resumed", *ARGS, "--evaluate",
                         *extra]) == 0
        out = capsys.readouterr().out
        fids = {line.split(": ")[0]: float(line.split(": ")[1])
                for line in out.splitlines()
                if line.startswith("fid_uncalibrated/")}
        assert set(fids) == {f"fid_uncalibrated/{k}{s}" for k in (
            "combined", "texture_only", "mesh_only") for s in ("", "_val")}
        assert all(math.isfinite(v) for v in fids.values())
    assert "best checkpoint:" in out


def test_save_results_writes_samples_and_grid(runs):
    root = runs[0]
    assert cli.main(["--name", "resumed", *ARGS, "--save_results"]) == 0
    out = os.path.join(root, "results", "resumed")
    names = sorted(os.listdir(out))
    assert names == sorted(f"mesh_{i}.{e}" for i in range(2)
                           for e in ("obj", "mtl", "png"))
    with open(os.path.join(out, "mesh_0.obj")) as fh:
        verts = [line for line in fh if line.startswith("v ")]
    assert len(verts) == 482  # MeshTemplate(32, 16), the CUB template
    with open(os.path.join(root, "results", "resumed.png"), "rb") as fh:
        assert fh.read(8) == b"\x89PNG\r\n\x1a\n"


@pytest.mark.parametrize("flag", ["--multihost"])
def test_unported_modes_raise(flag):
    with pytest.raises(NotImplementedError):
        cli.main(["--name", "x", "--dataset", "cub", flag])
