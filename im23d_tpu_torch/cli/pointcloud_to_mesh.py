"""Point cloud -> triangle mesh conversion CLI (PyTorch / CUDA).

Counterpart of ``im23d_tpu/cli/pointcloud_to_mesh.py``, with the same flags
and defaults plus ``--device``.  The occupancy field is the splat + Gaussian
smooth of ``ops/splat.splat_blur`` (the kernel K7 on CUDA), the surface
comes from the marching-tetrahedra extractor of ``geometry/marching.py``.

Input formats: .npy (N, 3), .npz (first array), or a ShapeNet-learner
checkpoint of the port + an image (predict the cloud, then mesh it).
Returns 1 when no surface is found.

Examples:
    python -m im23d_tpu_torch.cli.pointcloud_to_mesh --input cloud.npy \
        --output mesh.obj --voxel_size 96 --sigma 1.5
    python -m im23d_tpu_torch.cli.pointcloud_to_mesh --workdir runs/chairs \
        --image render_0.png --output chair.obj
"""

from __future__ import annotations

import argparse

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input", type=str, default=None,
                   help=".npy/.npz point cloud (N, 3) in [-0.5, 0.5]")
    p.add_argument("--workdir", type=str, default=None,
                   help="ShapeNet learner checkpoint dir (with --image)")
    p.add_argument("--image", type=str, default=None,
                   help="input image to predict a cloud from")
    p.add_argument("--category", choices=("chairs", "planes", "cars"),
                   default="chairs")
    p.add_argument("--output", type=str, required=True, help="output .obj")
    p.add_argument("--voxel_size", type=int, default=96)
    p.add_argument("--sigma", type=float, default=1.5)
    p.add_argument("--level", type=float, default=0.2,
                   help="iso level in [0, 1] of the normalized occupancy")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the network and the splat")
    return p


def load_points(path: str) -> np.ndarray:
    raw = np.load(path)
    if hasattr(raw, "files"):
        raw = raw[raw.files[0]]
    pts = np.asarray(raw, np.float32).reshape(-1, 3)
    # clamp into the splat's valid cube
    return np.clip(pts, -0.5 + 1e-4, 0.5 - 1e-4)


def predict_points(workdir: str, image_path: str, category: str,
                   device: str = "cuda") -> np.ndarray:
    """Restore the port's ``ShapeNetLearner`` checkpoint under ``workdir``
    and predict the (N, 3) cloud of one image (resized to the category's
    image size, in [0, 1], also the pose input)."""
    import torch
    from PIL import Image

    from im23d_tpu_torch.train.shapenet_learner import (
        ShapeNetConfig,
        ShapeNetLearner,
    )

    cfg = getattr(ShapeNetConfig, category)()
    learner = ShapeNetLearner(cfg, workdir=workdir, device=device)
    learner.restore()
    img = Image.open(image_path).convert("RGB").resize(
        (cfg.image_size, cfg.image_size)
    )
    x = torch.as_tensor(np.asarray(img, np.float32)[None] / 255.0,
                        device=learner.device)
    with torch.no_grad():
        out = learner.model(x, x)
    return out["point_cloud"][0].float().cpu().numpy()


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if (args.input is None) == (args.workdir is None):
        raise SystemExit("pass exactly one of --input / --workdir")

    from im23d_tpu_torch.geometry.marching import (
        point_cloud_to_mesh,
        save_obj_simple,
    )

    if args.input:
        pts = load_points(args.input)
    else:
        if not args.image:
            raise SystemExit("--workdir needs --image")
        pts = predict_points(args.workdir, args.image, args.category,
                             args.device)

    verts, faces = point_cloud_to_mesh(
        pts, voxel_size=args.voxel_size, sigma=args.sigma, level=args.level,
        device=args.device,
    )
    if len(faces) == 0:
        print("no surface found — try lowering --level or raising --sigma")
        return 1
    save_obj_simple(args.output, verts, faces)
    print(f"wrote {args.output}: {len(verts)} vertices, {len(faces)} faces")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
