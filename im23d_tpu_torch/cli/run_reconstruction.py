"""Mesh-estimation training, evaluation and pseudo-ground-truth CLI
(counterpart of ``im23d_tpu/cli/run_reconstruction.py``, with the same flags
and defaults, plus ``--device``).

Without a mode flag it trains (checkpoints under ``checkpoints_recon/<name>``:
a permanent one every ``--checkpoint_freq`` epochs, the rolling ``latest``
every ``--save_freq``; validation every ``--evaluate_freq``, a multi-view
render every ``--image_freq``; Ctrl-C saves ``latest`` and exits 130).
``--continue_train`` resumes, ``--evaluate`` prints the validation means,
``--generate_pseudogt`` writes the pseudo-ground-truth cache under
``cache/<dataset>`` (its FID statistics from ``--inception_weights`` where
given, so that the GAN CLI with the same file can read them).
``--data_processes N`` decodes the training and pseudo-GT items in N
worker processes beside the ``--num_workers`` threads.
``--export_serving PATH`` restores the checkpoint and writes a
``torch.export`` artifact of the network alone for each of
``--export_platforms`` (``serve/export.py``), then exits.
``--multihost`` raises ``NotImplementedError`` naming the slice that
brings it.

Examples:
    python -m im23d_tpu_torch.cli.run_reconstruction --name cub_recon \
        --dataset cub
    python -m im23d_tpu_torch.cli.run_reconstruction --name cub_recon \
        --dataset cub --generate_pseudogt
"""

from __future__ import annotations

import argparse
import os
import time

from im23d_tpu_torch.cli.flags import str2bool


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--name", type=str, required=True)
    p.add_argument("--dataset", type=str, required=True, help="(p3d|cub)")
    p.add_argument("--mesh_path", type=str, default="autodetect")
    p.add_argument("--batch_size", type=int, default=50)
    p.add_argument("--image_resolution", type=int, default=256)
    p.add_argument("--symmetric", type=str2bool, default=True)
    p.add_argument("--texture_resolution", type=int, default=128)
    p.add_argument("--mesh_resolution", type=int, default=32)
    p.add_argument("--loss", type=str, default="mse", help="(mse|l1)")
    p.add_argument("--checkpoint_freq", type=int, default=100)
    p.add_argument("--evaluate_freq", type=int, default=10)
    p.add_argument("--save_freq", type=int, default=10)
    p.add_argument("--tensorboard", action="store_true")
    p.add_argument("--no_augmentation", action="store_true")
    p.add_argument("--optimize_deltas", type=str2bool, default=True)
    p.add_argument("--optimize_z0", action="store_true")
    p.add_argument("--generate_pseudogt", action="store_true")
    p.add_argument("--pseudogt_resolution", type=int, default=512)
    p.add_argument("--inception_weights", type=str, default=None,
                   help="torchvision inception_v3 state dict (.pth or .npz) "
                        "for the pseudo-GT FID statistics (2048-d pool3, as "
                        "the GAN CLI's flag of the same name); without it "
                        "the calibrated random extractor (288-d)")
    p.add_argument("--evaluate", action="store_true")
    p.add_argument("--continue_train", action="store_true")
    p.add_argument("--which_epoch", type=str, default="latest")
    p.add_argument("--export_serving", type=str, default=None,
                   help="write a torch.export serving artifact of the "
                        "restored network to this path and exit")
    p.add_argument("--export_platforms", type=str, default="cuda,cpu",
                   help="the artifact's programs (cuda, cpu)")
    p.add_argument("--mesh_regularization", type=float, default=5e-5)
    p.add_argument("--epochs", type=int, default=1000)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--lr_dataset", type=float, default=1e-4)
    p.add_argument("--lr_decay_every", type=int, default=250)
    p.add_argument("--datasets_root", type=str, default="datasets")
    p.add_argument("--image_freq", type=int, default=10)
    p.add_argument("--compute_dtype", type=str, default="auto",
                   choices=("auto", "float32", "bfloat16"),
                   help="network compute dtype (auto = bfloat16 on CUDA, "
                        "float32 on the CPU); losses and renderer stay "
                        "float32")
    p.add_argument("--num_workers", type=int, default=4,
                   help="data-loading threads")
    p.add_argument("--data_processes", type=int, default=0,
                   help="worker processes decoding the training and "
                        "pseudo-GT items (0: the threads decode)")
    p.add_argument("--multihost", action="store_true")
    p.add_argument("--profile_dir", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the network and the renderer")
    return p


# modes of the JAX CLI that later slices of the port bring
_NOT_PORTED = (
    ("multihost", "--multihost comes with the multi-GPU slice"),
)


def main(argv=None, datasets=None) -> int:
    """Run the CLI.  ``datasets`` is an optional (train, val) pair of
    indexable datasets with the CMR item contract, used in place of the
    CUB / P3D loaders.  For ``--generate_pseudogt`` the train items carry
    ``image_299`` and ``image_<renderer res>`` and the val items
    ``image_299`` (or a 299² ``image``)."""
    args = build_parser().parse_args(argv)
    for flag, why in _NOT_PORTED:
        if getattr(args, flag):
            raise NotImplementedError(why)

    from im23d_tpu_torch.core.metrics_logger import MetricsLogger
    from im23d_tpu_torch.data.cmr import (
        CUBDataset,
        P3dDataset,
        batch_iterator,
        close_process_pools,
    )
    from im23d_tpu_torch.geometry.mesh_template import MeshTemplate
    from im23d_tpu_torch.metrics.inception import load_inception
    from im23d_tpu_torch.train.recon_trainer import ReconConfig, ReconTrainer

    if args.mesh_path == "autodetect":
        rings = 31 if args.dataset == "p3d" else 16
        template = MeshTemplate(segments=32, rings=rings)
    else:
        template = MeshTemplate(args.mesh_path)

    inception_res = 299
    renderer_res = max(1024, 2 * args.pseudogt_resolution)
    if datasets is not None:
        train_ds, val_ds = datasets
    else:
        sizes = ([args.image_resolution, inception_res, renderer_res]
                 if args.generate_pseudogt else args.image_resolution)
        is_train = not (args.no_augmentation or args.evaluate
                        or args.generate_pseudogt)
        val_res = (inception_res if args.generate_pseudogt
                   else args.image_resolution)
        if args.dataset == "cub":
            train_ds = CUBDataset(args.datasets_root, "train", is_train, sizes)
            val_ds = CUBDataset(args.datasets_root, "testval", False, val_res)
        elif args.dataset == "p3d":
            train_ds = P3dDataset(args.datasets_root, "train", is_train, sizes)
            val_ds = (None if args.generate_pseudogt else P3dDataset(
                args.datasets_root, "val", False, args.image_resolution))
        else:
            raise ValueError("Invalid dataset")

    cfg = ReconConfig(
        compute_dtype=args.compute_dtype,
        image_resolution=args.image_resolution,
        texture_resolution=args.texture_resolution,
        mesh_resolution=args.mesh_resolution,
        symmetric=args.symmetric,
        loss=args.loss,
        mesh_regularization=args.mesh_regularization,
        optimize_deltas=args.optimize_deltas,
        optimize_z0=args.optimize_z0,
        lr=args.lr,
        lr_dataset=args.lr_dataset,
        lr_decay_every=args.lr_decay_every,
        epochs=args.epochs,
        batch_size=args.batch_size,
    )
    workdir = os.path.join("checkpoints_recon", args.name)
    trainer = ReconTrainer(cfg, dataset_size=len(train_ds), template=template,
                           workdir=workdir, device=args.device)
    if (args.evaluate or args.generate_pseudogt or args.continue_train
            or args.export_serving):
        trainer.restore(step=None if args.which_epoch in ("latest", "best")
                        else int(args.which_epoch))

    if args.export_serving:
        from im23d_tpu_torch.serve import export_reconstruction_inference

        export_reconstruction_inference(
            trainer, args.batch_size, args.export_serving,
            platforms=tuple(args.export_platforms.split(",")))
        print(f"wrote serving artifact to {args.export_serving}")
        return 0
    train_keys = ("image", "scale", "translation", "rotation", "idx")

    if args.generate_pseudogt:
        cache_dir = os.path.join("cache", args.dataset)
        os.makedirs(cache_dir, exist_ok=True)

        def loader():
            for batch in batch_iterator(train_ds, args.batch_size,
                                        shuffle=False, drop_last=False,
                                        num_workers=args.num_workers,
                                        process_workers=args.data_processes):
                batch["hd_image"] = (batch.pop(f"image_{renderer_res}") / 2.0
                                     + 0.5)
                batch["inception_image"] = batch.pop("image_299")
                yield batch

        def val_loader():
            for batch in batch_iterator(val_ds, args.batch_size,
                                        shuffle=False, drop_last=False,
                                        num_workers=args.num_workers):
                key = "image_299" if "image_299" in batch else "image"
                yield {"inception_image": batch[key]}

        try:
            trainer.generate_pseudogt(
                loader(), cache_dir, args.dataset,
                pseudogt_resolution=args.pseudogt_resolution,
                inception_resolution=inception_res,
                paths=train_ds.get_paths(),
                val_loader=val_loader() if args.dataset == "cub" else None,
                renderer_resolution=renderer_res,
                inception=load_inception(args.inception_weights, trainer.device))
        finally:
            close_process_pools(train_ds)
        return 0

    def val_batches():
        # drop_last=False: the evaluator pads the tail batch and weighs the
        # pads 0, so every validation image scores
        return batch_iterator(val_ds, args.batch_size, shuffle=False,
                              drop_last=False, keys=train_keys,
                              num_workers=args.num_workers)

    if args.evaluate:
        means = trainer.evaluate(val_batches())
        print({k: round(v, 5) for k, v in means.items()})
        return 0

    logger = MetricsLogger(workdir, "recon", tensorboard=args.tensorboard)
    # the same sample is rendered every image_freq epochs
    viz_batch = next(iter(batch_iterator(train_ds, args.batch_size,
                                         shuffle=False, keys=train_keys,
                                         num_workers=args.num_workers)))
    profiler = None
    if args.profile_dir:
        from im23d_tpu_torch.core.profiler import StepProfiler

        profiler = StepProfiler(args.profile_dir)
    try:
        for epoch in range(trainer.epoch, args.epochs):
            trainer.epoch = epoch
            t0 = time.time()
            for it_in_epoch, batch in enumerate(batch_iterator(
                    train_ds, args.batch_size, seed=epoch, keys=train_keys,
                    num_workers=args.num_workers,
                    process_workers=args.data_processes)):
                if profiler is not None:
                    profiler.tick()
                losses = trainer.train_step(batch)
                if it_in_epoch % 10 == 0:
                    logger.log(trainer.total_it,
                               {k: float(v) for k, v in losses.items()})
            logger.log_text(f"epoch {epoch}: {time.time() - t0:.1f}s")
            trainer.epoch = epoch + 1
            if (epoch + 1) % args.checkpoint_freq == 0:
                trainer.save()
            elif (epoch + 1) % args.save_freq == 0:
                trainer.save(tag="latest")
            if (epoch + 1) % args.evaluate_freq == 0 and val_ds is not None:
                means = trainer.evaluate(val_batches())
                logger.log(trainer.total_it,
                           {f"val/{k}": v for k, v in means.items()})
            if (epoch + 1) % args.image_freq == 0:
                tex, mesh_map = trainer.predict(viz_batch["image"])
                grid = trainer.render_multiview(
                    trainer.template.get_vertex_positions(mesh_map), tex,
                    idx=0)
                logger.log_images(trainer.total_it, "render_multiview",
                                  grid[None], nrow=1)
    except KeyboardInterrupt:
        logger.log_text("KeyboardInterrupt: saving final checkpoint")
        trainer.save(tag="latest")
        return 130
    finally:
        if profiler is not None:
            profiler.close()
        close_process_pools(train_ds)
    trainer.save()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
