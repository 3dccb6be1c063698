"""Shared CLI flag helpers (counterpart of ``im23d_tpu/cli/flags.py``):
booleans given as words, and the ShapeNet config overrides."""

from __future__ import annotations

import argparse

def str2bool(v: str) -> bool:
    """argparse type for yes/no, true/false, 1/0 and the like."""
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


_SHAPENET_OVERRIDES = (
    "image_size", "voxel_size", "num_points", "num_views", "num_candidates",
)


def add_shapenet_overrides(p: argparse.ArgumentParser) -> None:
    """Optional per-category config overrides (train and eval must agree for
    checkpoints to restore)."""
    for flag in _SHAPENET_OVERRIDES:
        p.add_argument(f"--{flag}", type=int, default=None,
                       help="override the per-category config value")


def apply_shapenet_overrides(cfg, args):
    """Return cfg with any non-None override flags applied."""
    overrides = {
        k: getattr(args, k) for k in _SHAPENET_OVERRIDES
        if getattr(args, k, None) is not None
    }
    if overrides:
        cfg = type(cfg)(**{**cfg.__dict__, **overrides})
    return cfg
