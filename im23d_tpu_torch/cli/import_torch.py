"""Import the reference's pretrained checkpoints into the port's
checkpoints (counterpart of ``im23d_tpu/cli/import_torch.py``, with the
same flags, plus ``--device``).

The reference deploys its weights as ``torch.save`` dicts
(``pretrained_weights_{cub,p3d}`` for the GAN,
``pretrained_reconstruction_{cub,p3d}`` for the mesh-estimation network).
This tool writes one of them as the port's rolling ``latest`` checkpoint
under ``gan_weights/<name>`` or ``checkpoints_recon/<name>``, the
directories the port's CLIs restore from:

    python -m im23d_tpu_torch.cli.import_torch --checkpoint \\
        gan_weights/pretrained_weights_cub/checkpoint_latest.pth \\
        --weights pretrained_weights_cub
    python -m im23d_tpu_torch.cli.main --dataset cub --conditional_class \\
        --batch_size 16 --weights pretrained_weights_cub --save_results

The port's layers carry the reference's names, so the state dicts are
copied entry by entry (``core/convert.py:graft_reference``).  The model's
hyperparameters come from the ``args`` snapshot in the checkpoint; class
and colour conditioning and the class counts from the embedding weights;
the recon net's ``optimize_deltas`` / ``optimize_z0`` and dataset size from
its ``dataset_params``.  What transfers: the generator and EMA generator
(and the text encoder, when the model is text-conditional) or the recon
network and its ``DatasetParams``; the epoch and iteration counters; the
GAN's four loss curves.  What starts fresh: the critics and both
optimizers' moments, so importing is for inference, evaluation and
pseudo-ground truth, and continued GAN training warms the critics up from
their initialisation.  The CLIs rebuild the model from their own flags and
load strictly: flags that build another model raise at the restore,
naming the mismatched entries.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import torch

from im23d_tpu_torch.core.convert import (
    REFERENCE_CURVES,
    graft_reference,
    load_reference_checkpoint,
    reference_args,
)
from im23d_tpu_torch.data.pseudogt import suggested_num_discriminators
from im23d_tpu_torch.geometry.mesh_template import MeshTemplate


def _template(dataset: str) -> MeshTemplate:
    """The CLIs' autodetected template: 31 rings for p3d, 16 otherwise."""
    return MeshTemplate(segments=32, rings=31 if dataset == "p3d" else 16)


def _config_fields(cls, ref_args: dict) -> dict:
    return {f.name: ref_args[f.name] for f in dataclasses.fields(cls)
            if f.name in ref_args}


def make_gan_trainer(chk: dict, name: str, out_root: str, dataset: str,
                     device: str | torch.device = "cuda"):
    """A ``GANTrainer`` on ``device`` holding the checkpoint's generator,
    EMA generator, text encoder, counters and curves, its config inferred
    from the checkpoint; fresh critics and optimizers."""
    from im23d_tpu_torch.models.gan import GANConfig
    from im23d_tpu_torch.train.gan_trainer import GANTrainConfig, GANTrainer

    ref_args = reference_args(chk)
    gen_sd, ema_sd = chk["generator"], chk["generator_running_avg"]
    cfg = _config_fields(GANConfig, ref_args)
    # conditioning comes from the weights: the reference's snapshot holds a
    # truthy string for --conditional_class even when it was off
    n_classes = [tuple(gen_sd[k].shape)[0]
                 for k in ("emb_class.weight", "emb_color.weight")
                 if k in gen_sd]
    cfg["conditional_class"] = bool(n_classes)
    cfg["conditional_color"] = "emb_color.weight" in gen_sd
    if n_classes:
        cfg["n_classes"] = tuple(n_classes)
    # the port's CLI rules: syncbatch is batch norm over the global batch,
    # and -1 critics is the dataset's suggestion
    if cfg.get("norm_g") == "syncbatch":
        cfg["norm_g"] = "batch"
    if cfg.get("num_discriminators") not in (2, 3):
        cfg["num_discriminators"] = suggested_num_discriminators(
            dataset, cfg.get("texture_resolution",
                             GANConfig.texture_resolution))
    mcfg = GANConfig(**cfg)
    trainer = GANTrainer(GANTrainConfig(model=mcfg, batch_size=2),
                         template=_template(dataset),
                         workdir=os.path.join(out_root, name), device=device)
    graft_reference(trainer.generator, gen_sd, "generator")
    graft_reference(trainer.g_ema, ema_sd, "generator_running_avg")

    te_sd = chk.get("text_encoder") or chk.get("text_encoder_g")
    if te_sd is not None and mcfg.conditional_text:
        vocab, emb = tuple(te_sd["encoder.weight"].shape)
        hidden = tuple(te_sd["rnn.weight_hh_l0"].shape)[1]
        trainer.set_text_encoder(te_sd, vocab, emb, hidden)
        print(f"text encoder: {vocab} words")

    trainer.epoch = int(chk.get("epoch", 0))
    trainer.total_it = int(chk.get("iteration", 0))
    for ref_key, key in REFERENCE_CURVES:
        if ref_key in chk:
            trainer.curves[key] = [float(v) for v in chk[ref_key]]
    return trainer


def make_recon_trainer(chk: dict, name: str, out_root: str, dataset: str,
                       device: str | torch.device = "cuda"):
    """A ``ReconTrainer`` on ``device`` holding the checkpoint's network,
    ``DatasetParams`` and counters, its config inferred from the
    checkpoint; fresh optimizers."""
    from im23d_tpu_torch.train.recon_trainer import ReconConfig, ReconTrainer

    ref_args = reference_args(chk)
    dp_sd = dict(chk.get("dataset_params") or {})
    cfg = _config_fields(ReconConfig, ref_args)
    # optimize_* mirror the weights, not the ReconConfig defaults: a
    # checkpoint without dataset_params would otherwise save a size-1
    # DatasetParams that a restore at the dataset's size cannot load
    cfg["optimize_deltas"] = "ds_translation" in dp_sd
    cfg["optimize_z0"] = "ds_z0" in dp_sd
    dataset_size = (tuple(next(iter(dp_sd.values())).shape)[0] if dp_sd
                    else 1)
    trainer = ReconTrainer(ReconConfig(**{"batch_size": 2, **cfg}),
                           dataset_size=dataset_size,
                           template=_template(dataset),
                           workdir=os.path.join(out_root, name), device=device)
    graft_reference(trainer.model, chk["generator"], "reconstruction net")
    if dp_sd:
        graft_reference(trainer.dp_model, dp_sd, "dataset_params")
    trainer.epoch = int(chk.get("epoch", 0))
    trainer.total_it = int(chk.get("iteration", 0))
    return trainer


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint", type=str, required=True,
                   help="reference checkpoint_*.pth file")
    p.add_argument("--name", "--weights", dest="name", type=str, required=True,
                   help="run name to import into (gan_weights/<name> or "
                        "checkpoints_recon/<name>)")
    p.add_argument("--kind", choices=("auto", "gan", "recon"), default="auto",
                   help="checkpoint family; auto: gan when the dict has "
                        "generator_running_avg")
    p.add_argument("--dataset", type=str, default=None,
                   help="(cub|p3d); default: the checkpoint's args snapshot")
    p.add_argument("--out_root", type=str, default=None,
                   help="default: gan_weights/ or checkpoints_recon/")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device the trainer is built on")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    chk = load_reference_checkpoint(args.checkpoint)
    kind = args.kind
    if kind == "auto":
        kind = "gan" if "generator_running_avg" in chk else "recon"
    dataset = args.dataset or reference_args(chk).get("dataset", "cub")
    if kind == "gan":
        trainer = make_gan_trainer(chk, args.name,
                                   args.out_root or "gan_weights", dataset,
                                   args.device)
    else:
        trainer = make_recon_trainer(chk, args.name,
                                     args.out_root or "checkpoints_recon",
                                     dataset, args.device)
    path = trainer.save(tag="latest")
    print(f"imported {kind} checkpoint -> {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
