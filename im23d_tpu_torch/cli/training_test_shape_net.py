"""ShapeNet unsupervised training (PyTorch / CUDA).

Counterpart of ``im23d_tpu/cli/training_test_shape_net.py``: the chairs /
planes / cars configs on a ShapeNet render tree
(``--data_root``: ``<synset>.{train,valid}`` split files and model dirs of
``render*.png`` and ``camera*.mat``; PIL and scipy read them) or on
generated silhouettes (``--synthetic``), restore, eval-only, a
``torch.profiler`` trace of a window of steps (``--profile_dir``), a
checkpoint at the end and a rolling ``latest`` checkpoint on Ctrl-C.

``--multihost`` (or ``IM23D_MULTIHOST=1``) joins the process group that
``torchrun`` describes, one process a GPU; ``--batch_size`` is then per
process and each rank reads its own rows.  ``--tp N`` splits the wide
dense layers column-wise over groups of N ranks (``parallel/mesh.py``).
Rank 0 prints, logs and writes the checkpoints, at full width.

Examples:
    python -m im23d_tpu_torch.cli.training_test_shape_net --category chairs \
        --data_root data --workdir runs/chairs
    python -m im23d_tpu_torch.cli.training_test_shape_net --category chairs \
        --synthetic --steps 200 --workdir runs/smoke
    torchrun --nproc_per_node=4 -m im23d_tpu_torch.cli.training_test_shape_net \
        --multihost --tp 2 --batch_size 12 --data_root data --workdir runs/dp
"""

from __future__ import annotations

import argparse
import os

from im23d_tpu_torch.cli.flags import (
    add_shapenet_overrides,
    apply_shapenet_overrides,
)

PROFILE_START = 12  # the trace's first step: past the warm-up steps
PROFILE_STEPS = 5


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--category", choices=("chairs", "planes", "cars"),
                   default="chairs")
    p.add_argument("--data_root", type=str, default="data",
                   help="directory with <synset>.{train,valid} splits + "
                        "renders")
    p.add_argument("--no_ram_cache", action="store_true",
                   help="stream renders from disk instead of caching the "
                        "decoded uint8 views in RAM (~325 KB/model at 128^2)")
    p.add_argument("--synthetic", action="store_true",
                   help="train on generated silhouette data (no assets "
                        "needed)")
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
    p.add_argument("--multihost", action="store_true",
                   help="join the torchrun process group (one process a "
                        "GPU; --batch_size per process)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel width: the wide dense layers split "
                        "column-wise over groups of this many ranks")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace of a window of "
                        "steady-state steps to this directory")
    p.add_argument("--device", type=str, default="cuda")
    add_shapenet_overrides(p)
    return p


def _ticking(train_iter, profiler):
    """Yield from ``train_iter``, ticking ``profiler`` once a batch: the
    learner takes one batch a step."""
    for batch in train_iter:
        profiler.tick()
        yield batch


def main(argv=None, datasets=None) -> int:
    """Run the CLI.  ``datasets`` is an optional (train, valid) pair with
    ``data/shapenet.py:ShapeNetRenders``' item contract, used in place of
    the tree under ``--data_root``."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if not (args.synthetic or datasets is not None
            or os.path.isdir(args.data_root)):
        parser.error(f"no ShapeNet tree at --data_root {args.data_root!r}; "
                     "pass --data_root or --synthetic")

    from im23d_tpu_torch.parallel import mesh as pmesh

    multihost = pmesh.multihost_requested(args.multihost)
    device = pmesh.init_multihost(multihost, args.device)
    try:
        mesh = (pmesh.make_2d_mesh(args.tp) if multihost or args.tp > 1
                else None)
        return _run(args, datasets, device, mesh)
    finally:
        if multihost:
            pmesh.shutdown()


def _run(args, datasets, device, mesh) -> int:
    from im23d_tpu_torch.parallel.mesh import (
        data_position,
        is_main,
        shard_rows,
    )
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

    learner = ShapeNetLearner(cfg, workdir=args.workdir, device=device,
                              mesh=mesh)
    if args.restore:
        learner.restore(args.restore)
    main_rank = is_main(mesh)
    d, dp = data_position(mesh)

    if args.synthetic:
        from im23d_tpu_torch.data.synthetic import SyntheticSilhouettes

        # every rank draws the global batch and keeps its rows
        data = SyntheticSilhouettes(cfg.batch_size * dp, cfg.image_size,
                                    cfg.num_views, n_points=512)
        train_iter = (shard_rows(b, d, dp) for b in data)
        valid_batches = lambda: [shard_rows(data.next_batch(), d, dp)  # noqa: E731
                                 for _ in range(2)]
    else:
        from im23d_tpu_torch.data.shapenet import DataBunch

        bunch = DataBunch(
            datasets if datasets is not None else args.data_root,
            args.category, cfg.batch_size, cfg.image_size, use_camera=False,
            cache_in_ram=not args.no_ram_cache, rank=d, world=dp)
        train_iter = bunch.train_iter()
        valid_batches = bunch.valid_batches

    if args.eval_only:
        means = learner.evaluate(valid_batches)
        if main_rank:
            print({k: round(v, 5) for k, v in means.items()})
        return 0

    profiler = None
    if args.profile_dir and main_rank:
        from im23d_tpu_torch.core.profiler import StepProfiler

        # a short run traces its last steps
        start = min(PROFILE_START, max(cfg.total_steps - PROFILE_STEPS, 0))
        profiler = StepProfiler(args.profile_dir, start=start,
                                steps=PROFILE_STEPS)
    try:
        losses = learner.fit(
            _ticking(train_iter, profiler) if profiler else train_iter,
            num_steps=cfg.total_steps, valid_batches=valid_batches)
    except KeyboardInterrupt:
        if main_rank:
            print("KeyboardInterrupt: saving final checkpoint")
        learner.save(tag="latest")
        return 130
    finally:
        if profiler is not None:
            profiler.close()
        close = getattr(train_iter, "close", None)
        if close is not None:
            close()
    learner.save()
    if main_rank:
        print({k: round(v, 5) for k, v in losses.items()})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
