"""ShapeNet checkpoint evaluation (PyTorch / CUDA).

Counterpart of ``im23d_tpu/cli/evaluation_test_shape_net.py``: restore a
learner checkpoint, report the eval projection losses on the valid split
of a ShapeNet tree (``--data_root``) or on synthetic batches
(``--synthetic``), and Chamfer-L2 and 3D IoU of the predicted clouds: on a
tree, against each valid model's ground truth (a points file or an OBJ
mesh, ``data/shapenet.py:load_gt_points``), both clouds normalized to zero
mean and max radius 0.5; on synthetic data, against random clouds.  With
``--out_dir`` it saves the student and per-candidate projection grids, the
numbers as ``eval_metrics.json`` and the training loss curves of the
workdir's ``metrics_shapenet.jsonl`` (``loss_curves.png`` where matplotlib
imports, ``loss_curves.csv`` where it does not).

Examples:
    python -m im23d_tpu_torch.cli.evaluation_test_shape_net \
        --workdir runs/chairs --data_root data --out_dir runs/chairs/eval
    python -m im23d_tpu_torch.cli.evaluation_test_shape_net \
        --workdir runs/chairs --synthetic --out_dir runs/chairs/eval
"""

from __future__ import annotations

import argparse
import itertools
import json
import os

import numpy as np
import torch
import torch.nn.functional as F

from im23d_tpu_torch.cli.flags import (
    add_shapenet_overrides,
    apply_shapenet_overrides,
)
from im23d_tpu_torch.core.metrics_logger import tile_grid, write_png
from im23d_tpu_torch.metrics.chamfer import chamfer_distance
from im23d_tpu_torch.metrics.iou import iou_3d

IOU_RES = 32  # the 3D IoU's grid


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workdir", type=str, required=True)
    p.add_argument("--category", choices=("chairs", "planes", "cars"),
                   default="chairs")
    p.add_argument("--data_root", type=str, default="data")
    p.add_argument("--synthetic", action="store_true",
                   help="evaluate on synthetic batches (no assets needed)")
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--num_batches", type=int, default=4)
    p.add_argument("--gt_points", type=int, default=2048,
                   help="points per ground-truth cloud for Chamfer/IoU")
    p.add_argument("--max_models", type=int, default=256,
                   help="cap on valid-split models scored for Chamfer/IoU")
    p.add_argument("--out_dir", type=str, default=None,
                   help="save projection grids and eval_metrics.json here")
    p.add_argument("--batch_size", type=int, default=None,
                   help="override the per-category batch size")
    p.add_argument("--device", type=str, default="cuda")
    add_shapenet_overrides(p)
    return p


def _save_grid(path: str, tiles: np.ndarray, ncol: int) -> None:
    """Tile (N, H, W) floats in [0, 1] into one grayscale PNG."""
    grid = tile_grid(tiles, ncol)[..., 0]
    write_png(path, (grid * 255).astype(np.uint8))


def resize_masks(masks: torch.Tensor, size: int) -> torch.Tensor:
    """(N, H, W) -> (N, size, size) by antialiased bilinear resampling with
    half-pixel centres: the semantics of ``jax.image.resize(..., "linear")``."""
    return F.interpolate(masks[:, None], size=(size, size), mode="bilinear",
                         align_corners=False, antialias=True)[:, 0]


_CURVES = ("total_loss", "projection_loss", "student_loss")


def export_loss_curves(workdir: str, out_dir: str) -> str | None:
    """Plot the losses of ``<workdir>/metrics_shapenet.jsonl`` into
    ``loss_curves.png``, or write them to ``loss_curves.csv`` where
    matplotlib does not import.  Returns the path written, or None when the
    workdir has no metrics file."""
    src = os.path.join(os.path.abspath(workdir), "metrics_shapenet.jsonl")
    if not os.path.exists(src):
        return None
    with open(src) as fh:
        recs = [json.loads(line) for line in fh if line.strip()]
    keys = [k for base in _CURVES for k in (base, f"valid/{base}")
            if any(k in r for r in recs)]
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        path = os.path.join(out_dir, "loss_curves.csv")
        with open(path, "w") as fh:
            fh.write("step," + ",".join(keys) + "\n")
            for r in recs:
                if any(k in r for k in keys):
                    fh.write(f"{r['step']},"
                             + ",".join(str(r.get(k, "")) for k in keys)
                             + "\n")
        return path
    fig, ax = plt.subplots(figsize=(8, 5))
    for k in keys:
        ax.plot(*zip(*[(r["step"], r[k]) for r in recs if k in r]), label=k)
    ax.set_xlabel("step")
    ax.set_yscale("log")
    if keys:
        ax.legend()
    path = os.path.join(out_dir, "loss_curves.png")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def normalize_clouds(points: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) -> zero mean, max radius 0.5: ``normalize_cloud`` of
    ``data/shapenet.py`` on the device."""
    points = points - points.mean(dim=-2, keepdim=True)
    radius = torch.linalg.vector_norm(points, dim=-1).amax(dim=-1,
                                                           keepdim=True)
    return points / radius.clamp(min=1e-8)[..., None] * 0.5


@torch.no_grad()
def evaluate_gt_clouds(learner, pairs, batch_size: int):
    """Chamfer-L2 and 3D IoU (at ``IOU_RES``³) of the predicted clouds
    against GT clouds, for (image (H, W, 3) uint8, GT cloud (P, 3)) pairs.

    The pose branch is fed the image itself (its output is unused); a
    partial last batch is padded by repeating its last pair.  One
    ``chamfer_distance`` and one ``iou_3d`` a batch.  Returns
    (chamfer_mean, iou_mean, n_scored), NaNs and 0 without pairs."""
    learner.model.eval()
    chamfers, ious, images, gts = [], [], [], []

    def flush():
        n = len(images)
        images.extend(images[-1:] * (batch_size - n))
        gts.extend(gts[-1:] * (batch_size - n))
        nb = learner._normalize(dict(images=np.stack(images),
                                     gt=np.stack(gts)))
        pred = learner.model(nb["images"], nb["images"])["point_cloud"]
        pred = normalize_clouds(pred.float())
        total, _, _ = chamfer_distance(pred, nb["gt"])
        iou = iou_3d(pred, nb["gt"], voxel_size=IOU_RES)
        chamfers.extend(total[:n].tolist())
        ious.extend(iou[:n].tolist())
        images.clear()
        gts.clear()

    for img, gt in pairs:
        images.append(img)
        gts.append(gt)
        if len(images) == batch_size:
            flush()
    if images:
        flush()
    if not chamfers:
        return float("nan"), float("nan"), 0
    return float(np.mean(chamfers)), float(np.mean(ious)), len(chamfers)


def main(argv=None, datasets=None) -> int:
    """Run the CLI.  ``datasets`` is an optional (train, valid) pair with
    ``data/shapenet.py:ShapeNetRenders``' item contract and a
    ``gt_pairs(n_points)`` method (``data/fabricate.py:ShapeNetRenderSet``),
    used in place of the tree under ``--data_root``."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if not (args.synthetic or datasets is not None
            or os.path.isdir(args.data_root)):
        parser.error(f"no ShapeNet tree at --data_root {args.data_root!r}; "
                     "pass --data_root or --synthetic")

    from im23d_tpu_torch.losses.effective import unsupervised_loss
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

    if args.synthetic:
        from im23d_tpu_torch.data.synthetic import SyntheticSilhouettes

        data = SyntheticSilhouettes(cfg.batch_size, cfg.image_size,
                                    cfg.num_views, n_points=512, seed=1)
        batches = [data.next_batch() for _ in range(args.num_batches)]
    else:
        from im23d_tpu_torch.data.shapenet import DataBunch

        bunch = DataBunch(
            datasets if datasets is not None else args.data_root,
            args.category, cfg.batch_size, cfg.image_size, use_camera=False)
        batches = list(itertools.islice(bunch.valid_batches(),
                                        args.num_batches))
        if not batches:
            parser.error("the valid split holds fewer models than one "
                         f"valid batch ({2 * cfg.batch_size})")

    # projection losses (reference parity: projection-MSE eval)
    means = learner.evaluate(batches)
    print("projection eval:", {k: round(v, 5) for k, v in means.items()})

    with torch.no_grad():
        nb = learner._normalize(batches[0])
        model_out = learner.model(nb["images"], nb["pose_input"])
    scored = {}
    if args.synthetic:
        # random clouds, NOT the checkpoint's training targets
        from im23d_tpu_torch.data.synthetic import _random_shapes

        gt = torch.as_tensor(
            _random_shapes(np.random.RandomState(123), cfg.batch_size, 512),
            device=learner.device,
        )
        with torch.no_grad():
            pred = model_out["point_cloud"]
            total, _, _ = chamfer_distance(pred, gt)
            iou = iou_3d(pred, gt, voxel_size=IOU_RES)
        chamfer, iou = float(total.mean()), float(iou.mean())
        print(f"chamfer_l2 {chamfer:.5f} iou_3d {iou:.4f} (note: synthetic "
              "clouds are NOT the checkpoint's training targets)")
    else:
        if datasets is not None:
            pairs = itertools.islice(datasets[1].gt_pairs(args.gt_points),
                                     args.max_models)
        else:
            from im23d_tpu_torch.data.shapenet import (
                SYNSET_IDS,
                get_model_dirs,
                gt_cloud_pairs,
            )

            model_dirs = get_model_dirs(args.data_root,
                                        SYNSET_IDS[args.category], "valid")
            pairs = gt_cloud_pairs(model_dirs[:args.max_models],
                                   args.gt_points, cfg.image_size)
        chamfer, iou, n = evaluate_gt_clouds(learner, pairs, cfg.batch_size)
        scored = dict(n_scored=n, gt_points=args.gt_points)
        if n:
            print(f"chamfer_l2 {chamfer:.5f} iou_3d {iou:.4f} ({n} models, "
                  f"{args.gt_points} GT points, normalized frame)")
        else:
            print("no GT point clouds / meshes found under model dirs; "
                  "skipping Chamfer/IoU (add points.npy or model OBJs)")

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
            masks_s = resize_masks(nb["masks"][:8], cfg.voxel_size)
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
                           iou_3d=iou, **scored,
                           student_projection_shape=list(proj.shape),
                           candidate_projection_shape=list(cand.shape)), fh)
        curves = export_loss_curves(args.workdir, args.out_dir)
        if curves:
            print(f"loss curves: {curves}")
        print(f"saved projection grids to {args.out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
