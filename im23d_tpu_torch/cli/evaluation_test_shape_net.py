"""ShapeNet checkpoint evaluation on synthetic data (PyTorch / CUDA).

Counterpart of the ``--synthetic`` path of
``im23d_tpu/cli/evaluation_test_shape_net.py``: restore a learner
checkpoint, report the eval projection losses, Chamfer-L2 and 3D IoU of the
predicted clouds against random synthetic clouds, and with ``--out_dir``
save the student and per-candidate projection grids plus the numbers as
``eval_metrics.json``.

Example:
    python -m im23d_tpu_torch.cli.evaluation_test_shape_net \
        --workdir runs/chairs --synthetic --out_dir runs/chairs/eval
"""

from __future__ import annotations

import argparse
import json
import os
import struct
import zlib

import numpy as np
import torch

from im23d_tpu_torch.cli.flags import (
    add_shapenet_overrides,
    apply_shapenet_overrides,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workdir", type=str, required=True)
    p.add_argument("--category", choices=("chairs", "planes", "cars"),
                   default="chairs")
    p.add_argument("--synthetic", action="store_true",
                   help="evaluate on synthetic batches (the only data path "
                        "ported so far)")
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--num_batches", type=int, default=4)
    p.add_argument("--out_dir", type=str, default=None,
                   help="save projection grids and eval_metrics.json here")
    p.add_argument("--batch_size", type=int, default=None,
                   help="override the per-category batch size")
    p.add_argument("--device", type=str, default="cuda")
    add_shapenet_overrides(p)
    return p


def _write_png(path: str, img: np.ndarray) -> None:
    """Write an (H, W) uint8 array as an 8-bit grayscale PNG."""
    h, w = img.shape
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n"
                 + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                 + chunk(b"IDAT", zlib.compress(raw))
                 + chunk(b"IEND", b""))


def _save_grid(path: str, tiles: np.ndarray, ncol: int) -> None:
    """Tile (N, H, W) floats in [0, 1] into one grayscale PNG."""
    arr = np.clip(np.asarray(tiles, np.float32), 0.0, 1.0)
    n, h, w = arr.shape
    nrows = -(-n // ncol)
    grid = np.zeros((nrows * h, ncol * w), np.float32)
    for i in range(n):
        r, c = divmod(i, ncol)
        grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = arr[i]
    _write_png(path, (grid * 255).astype(np.uint8))


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if not args.synthetic:
        parser.error("only the --synthetic data path is ported")

    from im23d_tpu_torch.data.synthetic import (
        SyntheticSilhouettes,
        _random_shapes,
    )
    from im23d_tpu_torch.losses.effective import unsupervised_loss
    from im23d_tpu_torch.metrics.chamfer import chamfer_distance
    from im23d_tpu_torch.metrics.iou import iou_3d
    from im23d_tpu_torch.ops.sampling import resize_bilinear
    from im23d_tpu_torch.train.shapenet_learner import (
        ShapeNetConfig,
        ShapeNetLearner,
    )

    cfg = getattr(ShapeNetConfig, args.category)()
    if args.batch_size is not None:
        cfg = ShapeNetConfig(**{**cfg.__dict__, "batch_size": args.batch_size})
    cfg = apply_shapenet_overrides(cfg, args)
    learner = ShapeNetLearner(cfg, workdir=args.workdir, device=args.device)
    learner.restore(step=args.step)
    print(f"restored step {learner.step}")

    data = SyntheticSilhouettes(cfg.batch_size, cfg.image_size,
                                cfg.num_views, n_points=512, seed=1)
    batches = [data.next_batch() for _ in range(args.num_batches)]

    # projection losses (reference parity: projection-MSE eval)
    means = learner.evaluate(batches)
    print("projection eval:", {k: round(v, 5) for k, v in means.items()})

    # Chamfer + 3D IoU against random clouds, NOT the checkpoint's targets
    gt = torch.as_tensor(
        _random_shapes(np.random.RandomState(123), cfg.batch_size, 512),
        device=learner.device,
    )
    with torch.no_grad():
        nb = learner._normalize(batches[0])
        model_out = learner.model(nb["images"], nb["pose_input"])
        pred = model_out["point_cloud"]
        total, _, _ = chamfer_distance(pred, gt)
        iou = iou_3d(pred, gt, voxel_size=32)
    chamfer, iou = float(total.mean()), float(iou.mean())
    print(f"chamfer_l2 {chamfer:.5f} iou_3d {iou:.4f} "
          "(note: synthetic clouds are NOT the checkpoint's training targets)")

    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        sigma = torch.tensor(0.3, device=learner.device)
        with torch.no_grad():
            # student projections (eval mode)
            _, aux = unsupervised_loss(
                model_out, nb["masks"], sigma, None, cfg.num_views,
                voxel_size=cfg.voxel_size, training=False,
            )
            # every pose candidate's projection (the K-way sweep)
            _, aux_k = unsupervised_loss(
                model_out, nb["masks"], sigma, None, cfg.num_views,
                voxel_size=cfg.voxel_size, training=True,
            )
            masks_s = resize_bilinear(nb["masks"][:8], cfg.voxel_size,
                                      cfg.voxel_size)
        proj = aux["projection"].cpu().numpy()
        cand = aux_k["projection"].cpu().numpy()  # (B*V, K, S, S)
        _save_grid(os.path.join(args.out_dir, "student_projections.png"),
                   proj[:16], ncol=4)
        _save_grid(os.path.join(args.out_dir, "candidate_projections.png"),
                   cand[:8].reshape(-1, *cand.shape[2:]), ncol=cand.shape[1])
        _save_grid(os.path.join(args.out_dir, "gt_masks.png"),
                   masks_s.cpu().numpy(), ncol=4)
        with open(os.path.join(args.out_dir, "eval_metrics.json"), "w") as fh:
            json.dump(dict(step=learner.step, **means, chamfer_l2=chamfer,
                           iou_3d=iou,
                           student_projection_shape=list(proj.shape),
                           candidate_projection_shape=list(cand.shape)), fh)
        print(f"saved projection grids to {args.out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
