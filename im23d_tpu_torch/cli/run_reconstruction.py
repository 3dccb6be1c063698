"""Mesh-estimation CLI (counterpart of ``im23d_tpu/cli/run_reconstruction.py``,
with the same flags and defaults, plus ``--device``).

This slice runs the evaluation path: ``--evaluate`` restores the checkpoint
of ``--which_epoch`` from ``checkpoints_recon/<name>`` and prints the mean
recon loss, flatness loss and mIoU over the validation split.  The other
modes raise ``NotImplementedError`` naming the slice that brings them.

Example:
    python -m im23d_tpu_torch.cli.run_reconstruction --name cub_recon \\
        --dataset cub --evaluate
"""

from __future__ import annotations

import argparse
import os

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
    p.add_argument("--evaluate", action="store_true")
    p.add_argument("--continue_train", action="store_true")
    p.add_argument("--which_epoch", type=str, default="latest")
    p.add_argument("--export_serving", type=str, default=None)
    p.add_argument("--export_platforms", type=str, default="tpu,cpu")
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
    p.add_argument("--data_processes", type=int, default=0)
    p.add_argument("--multihost", action="store_true")
    p.add_argument("--profile_dir", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the network and the renderer")
    return p


# modes of the JAX CLI that later slices of the port bring
_NOT_PORTED = (
    ("generate_pseudogt", "--generate_pseudogt comes with the Pipeline-B "
     "training slice (it needs K5's backward and the Inception network)"),
    ("export_serving", "--export_serving comes with the serving slice "
     "(torch.export)"),
    ("multihost", "--multihost comes with the multi-GPU slice"),
    ("profile_dir", "--profile_dir comes with the Pipeline-B training slice"),
    ("tensorboard", "--tensorboard comes with the Pipeline-B training "
     "slice"),
)


def main(argv=None, datasets=None) -> int:
    """Run the CLI.  ``datasets`` is an optional (train, val) pair of
    indexable datasets with the CMR item contract, used in place of the
    CUB / P3D loaders (the train split only sizes ``DatasetParams``)."""
    args = build_parser().parse_args(argv)
    for flag, why in _NOT_PORTED:
        if getattr(args, flag):
            raise NotImplementedError(why)
    if not args.evaluate:
        raise NotImplementedError(
            "the training loop comes with the Pipeline-B training slice; "
            "this slice runs --evaluate")

    from im23d_tpu_torch.data.cmr import (
        CUBDataset,
        P3dDataset,
        batch_iterator,
    )
    from im23d_tpu_torch.geometry.mesh_template import MeshTemplate
    from im23d_tpu_torch.train.recon_trainer import ReconConfig, ReconTrainer

    if args.mesh_path == "autodetect":
        rings = 31 if args.dataset == "p3d" else 16
        template = MeshTemplate(segments=32, rings=rings)
    else:
        template = MeshTemplate(args.mesh_path)

    if datasets is not None:
        train_ds, val_ds = datasets
    elif args.dataset == "cub":
        train_ds = CUBDataset(args.datasets_root, "train", False,
                              args.image_resolution)
        val_ds = CUBDataset(args.datasets_root, "testval", False,
                            args.image_resolution)
    elif args.dataset == "p3d":
        train_ds = P3dDataset(args.datasets_root, "train", False,
                              args.image_resolution)
        val_ds = P3dDataset(args.datasets_root, "val", False,
                            args.image_resolution)
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
    trainer.restore(step=None if args.which_epoch in ("latest", "best")
                    else int(args.which_epoch))
    # drop_last=False: the evaluator pads the tail batch and weighs the pads
    # 0, so every validation image scores
    means = trainer.evaluate(batch_iterator(
        val_ds, args.batch_size, shuffle=False, drop_last=False,
        keys=("image", "scale", "translation", "rotation", "idx"),
        num_workers=args.num_workers))
    print({k: round(v, 5) for k, v in means.items()})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
