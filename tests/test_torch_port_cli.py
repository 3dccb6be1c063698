"""The PyTorch port's training loop, checkpoints and CLIs on the CPU, at a
tiny config (B=2, V=2, K=2, N=128, 32² images, S=16).

Checkpoints carry the optimizer state, so a resumed run continues with the
loss of an uninterrupted one; ``fit`` writes ``metrics_shapenet.jsonl`` and
a projection grid; the training CLI then the eval CLI run end to end and the
loss curves come out as CSV where matplotlib is missing.  The eval CLI's
``gt_masks.png`` resize is held to ``jax.image.resize(..., "linear")``
(atol 1e-6).
"""

import json
import sys

import jax.image
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from im23d_tpu_torch.cli import evaluation_test_shape_net as eval_cli
from im23d_tpu_torch.cli import training_test_shape_net as train_cli
from im23d_tpu_torch.core.metrics_logger import write_png
from im23d_tpu_torch.data.synthetic import SyntheticSilhouettes
from im23d_tpu_torch.train.shapenet_learner import (
    ShapeNetConfig,
    ShapeNetLearner,
)

B, V, K, N, H, S = 2, 2, 2, 128, 32, 16
FLAGS = ["--image_size", str(H), "--voxel_size", str(S), "--num_points",
         str(N), "--num_views", str(V), "--num_candidates", str(K),
         "--batch_size", str(B), "--device", "cpu"]


def _cfg(**kw):
    return ShapeNetConfig(image_size=H, voxel_size=S, num_points=N,
                          num_views=V, num_candidates=K, batch_size=B,
                          total_steps=20, **kw)


def _batches(n, seed=4):
    data = SyntheticSilhouettes(B, H, V, n_points=64, seed=seed)
    return [data.next_batch() for _ in range(n)]


def test_resume_from_checkpoint_continues_the_run(tmp_path):
    batches = _batches(3)
    a = ShapeNetLearner(_cfg(), device="cpu")
    for b in batches[:2]:
        a.train_step(b)
    a.save(str(tmp_path))
    want = float(a.train_step(batches[2])["total_loss"])

    b = ShapeNetLearner(_cfg(seed=1), device="cpu")
    b.restore(str(tmp_path))
    assert b.step == 2
    assert b.opt.state_dict()["state"], "optimizer state was not restored"
    got = float(b.train_step(batches[2])["total_loss"])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    torch.testing.assert_close(b.model.state_dict(), a.model.state_dict())


def test_latest_tag_is_rolling_and_newest_wins(tmp_path):
    ln = ShapeNetLearner(_cfg(), device="cpu")
    ln.step = 4
    ln.save(str(tmp_path))
    ln.step = 5
    path = ln.save(str(tmp_path), tag="latest")
    assert path.endswith("checkpoint_latest.pt")
    other = ShapeNetLearner(_cfg(seed=2), device="cpu")
    other.restore(str(tmp_path))          # the newer file: latest
    assert other.step == 5
    other.restore(str(tmp_path), step=4)  # a numbered one by its step
    assert other.step == 4
    other.restore(str(tmp_path), step="latest")
    assert other.step == 5
    with pytest.raises(ValueError):
        ln.save(str(tmp_path), tag="best")


def test_fit_logs_metrics_images_and_checkpoints(tmp_path):
    cfg = _cfg(log_every=2, eval_every=4)
    ln = ShapeNetLearner(cfg, workdir=str(tmp_path), device="cpu")
    data = SyntheticSilhouettes(B, H, V, n_points=64, seed=6)
    losses = ln.fit(iter(data), num_steps=4,
                    valid_batches=lambda: _batches(1, seed=7))
    assert ln.step == 4 and np.isfinite(losses["total_loss"])
    recs = [json.loads(line) for line in
            (tmp_path / "metrics_shapenet.jsonl").read_text().splitlines()]
    train = [r for r in recs if "total_loss" in r]
    assert [r["step"] for r in train] == [2, 4]
    assert all(r["steps_per_sec"] > 0 for r in train)
    assert any("valid/projection_loss" in r for r in recs)
    png = tmp_path / "images" / "renders_00000004.png"
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert (tmp_path / "checkpoint_4.pt").exists()


def test_train_then_eval_cli_on_cpu(tmp_path, monkeypatch):
    work, out = tmp_path / "run", tmp_path / "eval"
    rc = train_cli.main(["--synthetic", "--steps", "3", "--workdir",
                         str(work), *FLAGS])
    assert rc == 0
    tree = torch.load(work / "checkpoint_3.pt", weights_only=True)
    assert tree["step"] == 3 and tree["opt_state"]["state"]

    monkeypatch.setitem(sys.modules, "matplotlib", None)  # as on the card
    rc = eval_cli.main(["--workdir", str(work), "--synthetic",
                        "--num_batches", "1", "--out_dir", str(out), *FLAGS])
    assert rc == 0
    metrics = json.loads((out / "eval_metrics.json").read_text())
    assert metrics["step"] == 3
    header, *rows = (out / "loss_curves.csv").read_text().splitlines()
    assert header.startswith("step,") and "valid/total_loss" in header
    assert rows
    for name in ("student_projections", "candidate_projections", "gt_masks"):
        assert (out / f"{name}.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_train_cli_interrupt_saves_latest(tmp_path, monkeypatch):
    def interrupted(self, *a, **kw):
        self.step = 2
        raise KeyboardInterrupt

    monkeypatch.setattr(ShapeNetLearner, "fit", interrupted)
    rc = train_cli.main(["--synthetic", "--workdir", str(tmp_path), *FLAGS])
    assert rc == 130
    assert torch.load(tmp_path / "checkpoint_latest.pt",
                      weights_only=True)["step"] == 2


def test_train_cli_needs_synthetic(tmp_path):
    with pytest.raises(SystemExit):
        train_cli.main(["--workdir", str(tmp_path), *FLAGS])


def test_gt_mask_resize_matches_jax_image_resize():
    masks = np.random.RandomState(0).rand(3, 128, 128).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(masks), (3, 64, 64), "linear")
    got = eval_cli.resize_masks(torch.from_numpy(masks), 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("shape", [(5, 7), (4, 6, 3)])
def test_write_png_layout(tmp_path, shape):
    """Gray and RGB PNGs: signature, IHDR size and colour type."""
    img = np.arange(np.prod(shape), dtype=np.uint8).reshape(shape)
    path = tmp_path / "x.png"
    write_png(str(path), img)
    raw = path.read_bytes()
    assert raw[:8] == b"\x89PNG\r\n\x1a\n" and raw[12:16] == b"IHDR"
    w, h = int.from_bytes(raw[16:20], "big"), int.from_bytes(raw[20:24], "big")
    assert (h, w) == shape[:2]
    assert raw[25] == (2 if len(shape) == 3 else 0)
