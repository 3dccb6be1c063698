"""Texture+mesh GAN training and evaluation CLI (counterpart of
``im23d_tpu/cli/main.py``, with the same flags and defaults, plus
``--device``).

Without a mode flag it trains on the pseudo-ground-truth cache
``cache/<dataset>`` (checkpoints under ``gan_weights/<name>/checkpoints``:
a permanent one every ``--checkpoint_freq`` epochs, the rolling ``latest``
every ``--save_freq``; FID and sample grids every ``--evaluate_freq``;
Ctrl-C saves ``latest`` and exits 130).  ``--continue_train`` resumes,
``--evaluate`` prints the FIDs of the EMA generator (``--which_epoch best``
sweeps the numbered checkpoints), ``--save_results`` exports obj / mtl /
png samples and a grid of renders under ``results/<name>``.
``--device_cache`` stages the cache's maps on the card once and builds the
training batches there (``ValueError`` if they exceed
``data/device_cache.py:HBM_BUDGET_BYTES``).  ``--conditional_text``
conditions the GAN on the cache's captions (``captions_tokens.npz``,
``data/captions.py``) through a frozen text encoder, the pretrained
AttnGAN state dict ``--text_pretrained_encoder`` where that file exists;
as in the JAX CLI, ``--text_train_encoder``, ``--text_attention`` and
``--text_embedding_dim`` are parsed and not read.  ``--export_serving PATH``
writes a ``torch.export`` artifact of the EMA generator for each of
``--export_platforms`` (``serve/export.py``) and exits.  ``--multihost``
raises ``NotImplementedError``.

Examples:
    python -m im23d_tpu_torch.cli.main --name cub_512x512_class \
        --conditional_class --dataset cub --batch_size 32 --epochs 600
    python -m im23d_tpu_torch.cli.main --name cub_512x512_class \
        --conditional_class --dataset cub --evaluate
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from im23d_tpu_torch.cli.flags import str2bool


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--texture_resolution", type=int, default=512)
    p.add_argument("--mesh_resolution", type=int, default=32)
    p.add_argument("--symmetric_g", type=str2bool, default=True)
    p.add_argument("--texture_only", action="store_true")
    p.add_argument("--conditional_class", action="store_true")
    p.add_argument("--conditional_color", action="store_true")
    p.add_argument("--conditional_text", action="store_true")
    p.add_argument("--norm_g", type=str, default="syncbatch",
                   help="(syncbatch|batch|instance|none); syncbatch is batch "
                        "on one device")
    p.add_argument("--latent_dim", type=int, default=64)
    p.add_argument("--mesh_path", type=str, default="autodetect")
    p.add_argument("--epochs", type=int, default=600)
    p.add_argument("--norm_d", type=str, default="none")
    p.add_argument("--mesh_regularization", type=float, default=1e-4)
    p.add_argument("--lr_g", type=float, default=1e-4)
    p.add_argument("--lr_d", type=float, default=4e-4)
    p.add_argument("--d_steps_per_g", type=int, default=2)
    p.add_argument("--g_running_average_alpha", type=float, default=0.999)
    p.add_argument("--lr_decay_after", type=int, default=1000)
    p.add_argument("--loss", type=str, default="hinge")
    p.add_argument("--mask_output", type=str2bool, default=True)
    p.add_argument("--num_discriminators", type=int, default=-1)
    p.add_argument("--compute_dtype", type=str, default="auto",
                   choices=("auto", "float32", "bfloat16"),
                   help="conv-stack compute dtype (auto = bfloat16 on CUDA, "
                        "float32 on the CPU)")
    p.add_argument("--name", "--weights", dest="name", type=str,
                   required=True)
    p.add_argument("--dataset", type=str, required=True, help="(p3d|cub)")
    p.add_argument("--cache_dir", type=str, default=None,
                   help="default: cache/<dataset>")
    p.add_argument("--checkpoint_freq", type=int, default=20)
    p.add_argument("--save_freq", type=int, default=5)
    p.add_argument("--evaluate_freq", type=int, default=20)
    p.add_argument("--tensorboard", action="store_true")
    p.add_argument("--continue_train", action="store_true")
    p.add_argument("--evaluate", action="store_true")
    p.add_argument("--save_results", action="store_true")
    p.add_argument("--which_epoch", type=str, default="latest")
    p.add_argument("--export_serving", type=str, default=None,
                   help="write a torch.export serving artifact of the EMA "
                        "generator to this path and exit; implies "
                        "--evaluate")
    p.add_argument("--export_platforms", type=str, default="cuda,cpu",
                   help="the artifact's programs (cuda, cpu)")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--truncation_sigma", type=float, default=-1)
    p.add_argument("--gpu_ids", type=str, default="0",
                   help="accepted for reference parity; see --device")
    p.add_argument("--num_workers", type=int, default=4,
                   help="data-loading threads")
    p.add_argument("--device_cache", action="store_true",
                   help="stage the cache in device memory once and build "
                        "each training batch there")
    p.add_argument("--text_max_length", type=int, default=18)
    p.add_argument("--text_pretrained_encoder", type=str,
                   default="cache/cub/text_encoder200.pth")
    p.add_argument("--text_train_encoder", action="store_true")
    p.add_argument("--text_attention", type=str2bool, default=True)
    p.add_argument("--text_embedding_dim", type=int, default=256)
    p.add_argument("--inception_weights", type=str, default=None,
                   help="torchvision inception_v3 state dict (.pth or .npz)")
    p.add_argument("--multihost", action="store_true")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace of a window of "
                        "steady-state steps to this directory")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the networks and the renderer")
    return p


EVALUATION_RES = 299  # FID renders and Inception input, as the reference
GRID_RES = 256  # the in-training sample grids' renders, as the JAX CLI

# modes of the JAX CLI that later slices of the port bring
_NOT_PORTED = (
    ("multihost", "--multihost comes with the multi-GPU slice"),
)


def load_dataset(args):
    from im23d_tpu_torch.data.pseudogt import CubGANDataset, Pascal3DGANDataset

    cache_dir = args.cache_dir or os.path.join("cache", args.dataset)
    common = dict(texture_resolution=args.texture_resolution,
                  evaluate=args.evaluate,
                  conditional_class=args.conditional_class,
                  conditional_text=args.conditional_text)
    if args.dataset == "cub":
        if args.conditional_color:
            raise ValueError("--conditional_color is not supported for cub")
        return CubGANDataset(cache_dir, **common)
    if args.dataset == "p3d":
        if args.conditional_text:
            raise ValueError("--conditional_text is not supported for p3d")
        return Pascal3DGANDataset(
            cache_dir, conditional_color=args.conditional_color, **common)
    raise ValueError("Invalid dataset")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    for flag, why in _NOT_PORTED:
        if getattr(args, flag):
            raise NotImplementedError(why)
    if args.save_results or args.export_serving:
        args.evaluate = True

    import torch

    from im23d_tpu_torch.core.checkpoint import numbered_steps
    from im23d_tpu_torch.core.metrics_logger import MetricsLogger
    from im23d_tpu_torch.data.cmr import batch_iterator
    from im23d_tpu_torch.data.pseudogt import EvalDataset, gan_batch_iterator
    from im23d_tpu_torch.geometry.mesh_template import MeshTemplate
    from im23d_tpu_torch.metrics.inception import load_inception
    from im23d_tpu_torch.models.gan import GANConfig
    from im23d_tpu_torch.train.gan_eval import (
        FIDEvaluator,
        export_results,
        load_precomputed_stats,
        load_val_stats,
        render_generated,
        val_fids,
    )
    from im23d_tpu_torch.train.gan_trainer import GANTrainConfig, GANTrainer

    ds = load_dataset(args)
    if args.num_discriminators == -1:
        args.num_discriminators = ds.suggest_num_discriminators()
    if args.truncation_sigma < 0:
        args.truncation_sigma = ds.suggest_truncation_sigma()
    if args.num_discriminators >= 3 and args.texture_resolution < 512:
        raise ValueError("3 discriminators need --texture_resolution >= 512")
    if args.mesh_path == "autodetect":
        segments, rings = ds.suggest_mesh_template()
        template = MeshTemplate(segments=segments, rings=rings)
    else:
        template = MeshTemplate(args.mesh_path)
    device = torch.device(args.device)
    if args.compute_dtype == "auto":
        args.compute_dtype = ("bfloat16" if device.type == "cuda"
                              else "float32")

    mcfg = GANConfig(
        compute_dtype=args.compute_dtype,
        texture_resolution=args.texture_resolution,
        mesh_resolution=args.mesh_resolution,
        symmetric_g=args.symmetric_g,
        texture_only=args.texture_only,
        conditional_class=args.conditional_class,
        conditional_color=args.conditional_color,
        conditional_text=args.conditional_text,
        norm_g="batch" if args.norm_g == "syncbatch" else args.norm_g,
        norm_d=args.norm_d,
        latent_dim=args.latent_dim,
        num_discriminators=args.num_discriminators,
        mask_output=args.mask_output,
        n_classes=tuple(getattr(ds, "n_classes", (1,))))
    tcfg = GANTrainConfig(
        model=mcfg, lr_g=args.lr_g, lr_d=args.lr_d,
        text_vocab_size=max(ds.n_words, 2),
        text_max_length=args.text_max_length,
        d_steps_per_g=args.d_steps_per_g,
        g_ema_alpha=args.g_running_average_alpha,
        mesh_regularization=args.mesh_regularization, loss=args.loss,
        epochs=args.epochs, lr_decay_after=args.lr_decay_after,
        batch_size=args.batch_size)
    workdir = os.path.join("gan_weights", args.name)
    trainer = GANTrainer(tcfg, template=template, workdir=workdir,
                         device=device)
    if (args.conditional_text
            and os.path.exists(args.text_pretrained_encoder)):
        sd = torch.load(args.text_pretrained_encoder, map_location="cpu",
                        weights_only=True)
        vocab, emb = sd["encoder.weight"].shape
        hidden = sd["rnn.weight_hh_l0"].shape[1]
        trainer.set_text_encoder(sd, vocab, emb, hidden)
        print(f"loaded pretrained text encoder ({vocab} words) from "
              f"{args.text_pretrained_encoder}")
    if args.continue_train or args.evaluate:
        if args.which_epoch not in ("latest", "best"):
            trainer.restore(step=int(args.which_epoch))
        elif args.which_epoch == "latest" or not args.evaluate:
            trainer.restore()
    if (args.export_serving or args.save_results) \
            and args.which_epoch == "best":
        # the best sweep runs in --evaluate: exporting here would write
        # the unrestored initial generator
        flag = ("--export_serving" if args.export_serving
                else "--save_results")
        raise SystemExit(f"{flag} requires --which_epoch latest or a "
                         "numeric epoch (run --evaluate --which_epoch best "
                         "first to identify the best epoch)")

    if args.export_serving:
        from im23d_tpu_torch.serve import export_gan_inference

        export_gan_inference(
            trainer, args.batch_size, args.export_serving,
            platforms=tuple(args.export_platforms.split(",")))
        print(f"wrote serving artifact to {args.export_serving}")
        return 0

    def sample_conditioning(n, seed=0):
        """Random dataset indices -> (classes, poses, caption tokens,
        indices)."""
        idx = np.random.RandomState(seed).randint(0, len(ds), size=n)
        classes = (np.stack([np.atleast_1d(ds.classes[i]) for i in idx])
                   if args.conditional_class else None)
        poses = {k: np.asarray(ds.data[k])[idx]
                 for k in ("scale", "translation", "rotation")}
        captions = (ds.caption_tokens[idx, 0]
                    if ds.caption_tokens is not None else None)
        return classes, poses, captions, idx

    if args.save_results:
        out = os.path.join("results", args.name)
        classes, poses, captions, _ = sample_conditioning(args.batch_size)
        files = export_results(trainer, template, out,
                               n_samples=args.batch_size,
                               truncation_sigma=args.truncation_sigma,
                               classes=classes, poses=poses,
                               caption_tokens=captions,
                               render_res=min(args.texture_resolution, 512))
        print(f"exported {len(files)} samples to {out}")
        return 0

    eval_ds = EvalDataset(ds)
    cache_dir = args.cache_dir or os.path.join("cache", args.dataset)
    stats_path = os.path.join(cache_dir, "precomputed_fid_299x299_train.npz")

    def eval_batches():
        # every image scores: the evaluator pads the tail batch
        return batch_iterator(eval_ds, args.batch_size, shuffle=False,
                              drop_last=False, num_workers=args.num_workers)

    def make_evaluator():
        return FIDEvaluator(trainer, template, EVALUATION_RES,
                            load_inception(args.inception_weights, device))

    if args.evaluate:
        m_real, s_real, _, _ = load_precomputed_stats(stats_path)
        val_stats = load_val_stats(cache_dir)
        evaluator = make_evaluator()

        def fid_now(variants: bool = True):
            acts = evaluator.activations_for_batches(
                eval_batches(), args.truncation_sigma, variants=variants)
            fids = {key: evaluator.fid_against_stats(act, m_real, s_real)
                    for key, act in acts.items()}
            if val_stats is not None and variants:
                fids.update(val_fids(acts, val_stats,
                                     np.random.RandomState(1234)))
            return fids

        if args.which_epoch == "best":
            steps = numbered_steps(os.path.join(workdir, "checkpoints"))
            if not steps:
                raise SystemExit(
                    f"--which_epoch best: no numbered checkpoints to sweep "
                    f"under {workdir}/checkpoints (only the rolling latest "
                    f"exists; pass --which_epoch latest)")
            best = (None, float("inf"))
            for step in steps:
                trainer.restore(step=step)
                fid = fid_now(variants=False)["combined"]
                print(f"checkpoint {step}: {evaluator.metric_prefix}/combined "
                      f"{fid:.3f}")
                if fid < best[1]:
                    best = (step, fid)
            print(f"best checkpoint: {best[0]} (fid {best[1]:.3f})")
            trainer.restore(step=best[0])
        for key, fid in fid_now().items():
            print(f"{evaluator.metric_prefix}/{key}: {fid:.3f}")
        return 0

    logger = MetricsLogger(workdir, "gan", tensorboard=args.tensorboard)
    evaluator = fid_real = val_stats = None
    if os.path.exists(stats_path):
        evaluator = make_evaluator()
        fid_real = load_precomputed_stats(stats_path)[:2]
        val_stats = load_val_stats(cache_dir)
    else:
        logger.log_text(f"no FID stats at {stats_path}; in-training eval "
                        "logs image grids only")

    # the same classes and poses in every grid
    viz_n = min(args.batch_size, 16)
    viz_classes, viz_poses, viz_captions, viz_idx = sample_conditioning(
        viz_n, seed=1234)
    viz_real = None
    if ds.has_pseudo_ground_truth:
        items = [ds.load_pseudo_ground_truth(int(i)) for i in viz_idx]
        viz_real = {k: np.stack([it[k] for it in items]).astype(np.float32)
                    for k in ("image", "texture", "mesh")}

    def evaluate_during_training(epoch):
        if evaluator is not None:
            acts = evaluator.activations_for_batches(
                eval_batches(), args.truncation_sigma, variants=True)
            prefix = evaluator.metric_prefix
            fids = {f"{prefix}/{key}": evaluator.fid_against_stats(act,
                                                                   *fid_real)
                    for key, act in acts.items()}
            if val_stats is not None:
                fids.update({f"{prefix}/{k}": v for k, v in val_fids(
                    acts, val_stats, np.random.RandomState(epoch)).items()})
            logger.log(trainer.total_it, fids)
            logger.log_text(f"epoch {epoch} " + " ".join(
                f"{k} {v:.3f}" for k, v in fids.items()))
        z = trainer.truncation_sample(1234, viz_n, args.truncation_sigma)
        tex, mesh_map = trainer.generate(z, viz_classes, viz_captions)

        def f32(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                   device=device)

        poses = (f32(viz_poses["scale"]).reshape(-1),
                 f32(viz_poses["translation"]), f32(viz_poses["rotation"]))

        def render(m, t):
            with torch.no_grad():
                img, alpha = render_generated(template, GRID_RES, m, t,
                                              *poses)
            return torch.where(alpha > 0, img, torch.ones_like(img)).cpu()

        it = trainer.total_it
        logger.log_images(it, "samples/render", render(mesh_map, tex))
        logger.log_images(it, "samples/texture", tex.cpu() / 2.0 + 0.5)
        m = mesh_map.cpu().numpy()
        lo = m.min(axis=(1, 2), keepdims=True)
        hi = m.max(axis=(1, 2), keepdims=True)
        logger.log_images(it, "samples/mesh_map",
                          (m - lo) / np.maximum(hi - lo, 1e-8))
        if viz_real is not None:
            logger.log_images(it, "samples/real_image", viz_real["image"])
            logger.log_images(it, "samples/real_texture",
                              viz_real["texture"] / 2.0 + 0.5)
            logger.log_images(it, "samples/render_fake_texture",
                              render(f32(viz_real["mesh"]), tex))
            logger.log_images(it, "samples/render_fake_mesh",
                              render(mesh_map, f32(viz_real["texture"])))
        vocab = getattr(ds, "caption_vocab", None)
        if viz_captions is not None and vocab is not None:
            lines = [f"{i}. " + " ".join(vocab[w] for w in row.tolist()
                                         if w != 0)
                     for i, row in enumerate(viz_captions)]
            logger.log_text("sample captions:\n" + "\n".join(lines))

    profiler = None
    if args.profile_dir:
        from im23d_tpu_torch.core.profiler import StepProfiler

        profiler = StepProfiler(args.profile_dir)

    dev_cache = None
    if args.device_cache:
        from im23d_tpu_torch.data.device_cache import DeviceGANCache

        if not DeviceGANCache.fits_in_hbm(ds):
            raise ValueError("--device_cache: the cache's maps exceed the "
                             "device budget (data/device_cache.py:"
                             "HBM_BUDGET_BYTES)")
        dev_cache = DeviceGANCache(ds, args.batch_size, device)
        logger.log_text(f"device_cache: staged {len(ds)} items "
                        f"({dev_cache.nbytes() / 1e6:.0f} MB) in device "
                        "memory")

    def epoch_batches(epoch):
        if dev_cache is not None:
            return dev_cache.epoch_batches(epoch)
        return gan_batch_iterator(ds, args.batch_size, seed=epoch,
                                  num_workers=args.num_workers)

    try:
        for epoch in range(trainer.epoch, args.epochs):
            trainer.epoch = epoch
            t0 = time.time()
            # a loss fetch stalls the device: the first 1G + 2D group of an
            # epoch and every 10th iteration after
            for it_in_epoch, batch in enumerate(epoch_batches(epoch)):
                if profiler is not None:
                    profiler.tick()
                losses = trainer.train_step(batch)
                if it_in_epoch < 3 or it_in_epoch % 10 == 0:
                    scalars = {k: float(v) for k, v in losses.items()}
                    logger.log(trainer.total_it, scalars)
                    trainer.record_curves(scalars)
            logger.log_text(f"epoch {epoch}: {time.time() - t0:.1f}s")
            trainer.epoch = epoch + 1
            if (epoch + 1) % args.checkpoint_freq == 0:
                trainer.save()
            elif (epoch + 1) % args.save_freq == 0:
                trainer.save(tag="latest")
            if (epoch + 1) % args.evaluate_freq == 0:
                evaluate_during_training(epoch)
    except KeyboardInterrupt:
        logger.log_text("KeyboardInterrupt: saving final checkpoint")
        trainer.save(tag="latest")
        return 130
    finally:
        if profiler is not None:
            profiler.close()
    trainer.save()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
