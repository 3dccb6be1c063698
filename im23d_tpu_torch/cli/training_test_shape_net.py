"""ShapeNet unsupervised training on synthetic data (PyTorch / CUDA).

Counterpart of ``im23d_tpu/cli/training_test_shape_net.py`` on one device:
the chairs / planes / cars configs, the ``--synthetic`` data path, restore,
eval-only, a checkpoint at the end and a rolling ``latest`` checkpoint on
Ctrl-C.  The real ShapeNet data path is not ported yet.

Example:
    python -m im23d_tpu_torch.cli.training_test_shape_net --category chairs \
        --synthetic --steps 200 --workdir runs/smoke
"""

from __future__ import annotations

import argparse

from im23d_tpu_torch.cli.flags import (
    add_shapenet_overrides,
    apply_shapenet_overrides,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--category", choices=("chairs", "planes", "cars"),
                   default="chairs")
    p.add_argument("--synthetic", action="store_true",
                   help="train on generated silhouette data (the only data "
                        "path ported so far)")
    p.add_argument("--workdir", type=str, required=True)
    p.add_argument("--steps", type=int, default=None,
                   help="override the per-category step count (the p/sigma "
                        "schedules span it)")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--restore", type=str, default=None,
                   help="workdir to restore the latest checkpoint from")
    p.add_argument("--eval_only", action="store_true")
    p.add_argument("--compute_dtype", type=str, default="auto",
                   choices=("auto", "float32", "bfloat16"),
                   help="encoder/pose-trunk compute dtype (auto = bfloat16 "
                        "on CUDA); heads and the projection loss stay f32")
    p.add_argument("--device", type=str, default="cuda")
    add_shapenet_overrides(p)
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if not args.synthetic:
        parser.error("only the --synthetic data path is ported; the ShapeNet "
                     "loader (data/shapenet.py) is not")

    from im23d_tpu_torch.data.synthetic import SyntheticSilhouettes
    from im23d_tpu_torch.train.shapenet_learner import (
        ShapeNetConfig,
        ShapeNetLearner,
    )

    cfg = getattr(ShapeNetConfig, args.category)()
    overrides = {}
    if args.steps is not None:
        overrides["total_steps"] = args.steps
    if args.batch_size is not None:
        overrides["batch_size"] = args.batch_size
    if args.compute_dtype != "auto":
        overrides["compute_dtype"] = args.compute_dtype
    if overrides:
        cfg = ShapeNetConfig(**{**cfg.__dict__, **overrides})
    cfg = apply_shapenet_overrides(cfg, args)

    learner = ShapeNetLearner(cfg, workdir=args.workdir, device=args.device)
    if args.restore:
        learner.restore(args.restore)

    data = SyntheticSilhouettes(cfg.batch_size, cfg.image_size, cfg.num_views,
                                n_points=512)
    train_iter = iter(data)
    valid_batches = lambda: [data.next_batch() for _ in range(2)]  # noqa: E731

    if args.eval_only:
        means = learner.evaluate(valid_batches)
        print({k: round(v, 5) for k, v in means.items()})
        return 0

    try:
        losses = learner.fit(train_iter, num_steps=cfg.total_steps,
                             valid_batches=valid_batches)
    except KeyboardInterrupt:
        print("KeyboardInterrupt: saving final checkpoint")
        learner.save(tag="latest")
        return 130
    learner.save()
    print({k: round(v, 5) for k, v in losses.items()})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
