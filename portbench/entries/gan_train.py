"""The GAN's training loop as the GAN CLI runs it with ``--device_cache``:
``GANTrainer.train_step`` over ``DeviceGANCache.epoch_batches``, epoch
after epoch, the losses fetched on the CLI's schedule (the first 3
iterations of an epoch, then every 10th).

Set-up makes the cache and the weights from the seed, builds the trainer,
and drives its first three iterations (a G step, two D steps) through the
window's own call and feed, keeping what the check compares: each step's
losses, the first gradient of each network (Adam's first moment after its
first step: beta1 is 0) and the state after the three steps.  The check
runs the plain reference through the same three steps from the same
weights, batches (worked out again from the raw cache) and z.
"""

from __future__ import annotations

from contextlib import nullcontext

import torch

from portbench.lib.common import (
    first_moment,
    moving_leaves,
    rel_gap,
    seeded_state,
    subseed,
    worst_leaf_gap,
)
from portbench.lib.inputs import GANCacheSet
from portbench.reference import nets
from portbench.reference.fp8 import Fp8Mode
from portbench.reference.render import MeshTemplate as RefTemplate
from portbench.reference.steps import (
    GANSteps,
    gan_epoch_batches,
    gan_mirror,
    gan_z,
    mirror_nhwc,
)

KIND = "train"
FIRST_STEPS = 3


def mesh_gain(config: dict) -> dict:
    """The mesh head's weight scale (``weights.conv_mesh_gain``): a trained
    mesh moves smoothly, by hundredths of the sphere."""
    return {"conv_mesh": config["weights"]["conv_mesh_gain"]}


def model_config(config: dict, dtype: str | None = None) -> dict:
    m = dict(config["model"])
    m["n_classes"] = tuple(m["n_classes"])
    if dtype is not None:
        m["compute_dtype"] = dtype
    return m


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 fault: str | None = None):
        self.config, self.traffic = config, traffic
        self.seed = int(seed)
        self.device = torch.device(device)
        self.fault = fault
        self.batch_size = traffic["batch_size"]
        self.samples_per_call = self.batch_size
        self.train_seed = subseed(seed, 1) % 2**31

    # -- set-up ---------------------------------------------------------------

    def setup(self, spans) -> None:
        from im23d_tpu_torch.data.device_cache import DeviceGANCache
        from im23d_tpu_torch.geometry.mesh_template import MeshTemplate
        from im23d_tpu_torch.models.gan import GANConfig
        from im23d_tpu_torch.train.gan_trainer import (
            GANTrainConfig,
            GANTrainer,
        )

        cfg, tr = self.config, self.traffic
        m = cfg["model"]
        self.data = GANCacheSet(self.seed, cfg["dataset_size"],
                                m["texture_resolution"],
                                m["mesh_resolution"], m["n_classes"][0],
                                self.device)
        tcfg = GANTrainConfig(model=GANConfig(**model_config(cfg)),
                              batch_size=self.batch_size,
                              seed=self.train_seed, **cfg["train"])
        self.tcfg = tcfg
        self.trainer = GANTrainer(tcfg, MeshTemplate(**cfg["template"]),
                                  device=self.device)
        t = self.trainer
        g0 = seeded_state(t.generator, subseed(self.seed, 2), self.device,
                          mesh_gain(cfg))
        d0 = seeded_state(t.discriminator, subseed(self.seed, 3),
                          self.device)
        t.generator.load_state_dict(g0)
        t.g_ema.load_state_dict(g0)
        t.discriminator.load_state_dict(d0)
        self.g0 = {k: v.cpu() for k, v in g0.items()}
        self.d0 = {k: v.cpu() for k, v in d0.items()}
        del g0, d0
        self.cache = DeviceGANCache(self.data, self.batch_size, self.device)
        if self.fault == "unchanged":
            t.opt_g.step = t.opt_d.step = lambda *a, **k: None
        self.batches = self._batches()
        self.losses = []
        for i in range(FIRST_STEPS):
            self.losses.append(self.step(spans, fetch_all=True))
            if i == 0:
                self.g_grad = first_moment(t.opt_g, t.generator)
            if i == 1:
                self.d_grad = first_moment(t.opt_d, t.discriminator)
        self.after = dict(
            g={k: v.detach().clone() for k, v in
               t.generator.named_parameters()},
            d={k: v.detach().clone() for k, v in
               t.discriminator.named_parameters()},
            ema={k: v.clone() for k, v in t.g_ema.state_dict().items()
                 if v.is_floating_point()})
        for _ in range(tr["warmup_steps"]):
            self.step(spans)
        self.sync()

    def _batches(self):
        epoch = 0
        while True:
            self.trainer.epoch = epoch
            for it, batch in enumerate(self.cache.epoch_batches(epoch)):
                yield it, batch
            epoch += 1

    # -- the window's call ----------------------------------------------------

    def step(self, spans, fetch_all: bool = False):
        tr = self.traffic
        with spans("feed_wait"):
            it, batch = next(self.batches)
        batch = self._planted(batch)
        with spans("dispatch"):
            losses = self.trainer.train_step(batch)
        if fetch_all or it < tr["fetch_first"] or it % tr["fetch_every"] == 0:
            with spans("fetch"):
                return {k: float(v) for k, v in losses.items()}
        return None

    def _planted(self, batch: dict) -> dict:
        """The faults a check of ``correct`` must catch, planted in the
        timed path (``fault`` is set only by the calibration script)."""
        if self.fault == "half_batch":
            return {k: v[: len(v) // 2] for k, v in batch.items()}
        if self.fault == "altered_row":
            batch = dict(batch)
            batch["texture"] = batch["texture"].clone()
            batch["texture"][0] = -batch["texture"][0]
            return batch
        return batch

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def release(self) -> None:
        del self.trainer, self.cache, self.batches
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- model FLOPs ----------------------------------------------------------

    def flops_per_call(self) -> float:
        """Conv and matmul FLOPs of one iteration (a third of a G step and
        two D steps), counted on the reference on the meta device."""
        from torch.utils.flop_counter import FlopCounterMode

        mcfg = nets.GANConfig(**model_config(self.config, "float32"))
        B, m = self.batch_size, mcfg.mesh_resolution
        T = mcfg.texture_resolution
        with torch.device("meta"):
            G, D = nets.Generator(mcfg), nets.MultiScaleDiscriminator(mcfg)
            z = torch.randn(B, mcfg.latent_dim)
            c = torch.zeros(B, 1, dtype=torch.long)
            alpha = torch.ones(B, T, T, 1)
            real = torch.ones(B, T, T, 3)
            mesh_real = torch.ones(B, m, m, 3)
        G.train()
        D.train()
        with FlopCounterMode(display=False) as fc:
            D.requires_grad_(False)
            tex, mesh = G(z, c)
            p, _ = D(torch.cat([tex * alpha, alpha], -1), mesh, c, alpha=alpha)
            sum(x.sum() for x in p).backward()
            D.requires_grad_(True)
            for _ in range(2):
                with torch.no_grad():
                    tex, mesh = G(z, c)
                x = torch.cat([torch.cat([tex * alpha, alpha], -1),
                               torch.cat([real, alpha], -1)])
                p, _ = D(x, torch.cat([mesh, mesh_real]), torch.cat([c, c]),
                         alpha=torch.cat([alpha, alpha]))
                sum(x.sum() for x in p).backward()
        return fc.get_total_flops() / 3

    # -- the check ------------------------------------------------------------

    def _ref_batch(self, epoch: int, idx) -> dict:
        d, dev = self.data, self.device
        mirror = torch.tensor(gan_mirror(d.data_seed, epoch, idx),
                              device=dev)[:, None, None, None]

        def maps(a):
            t = torch.as_tensor(a[idx]).to(dev).float()
            return torch.where(mirror, mirror_nhwc(t), t)

        return dict(texture=maps(d.texture), alpha=maps(d.alpha),
                    mesh=maps(d.mesh),
                    c=torch.as_tensor(d.class_ids[idx], device=dev)[:, None])

    def check(self, control: bool = False) -> dict:
        """Program against the reference (or the control: the reference in
        float8): the critics' first gradient, the change of every parameter
        after three steps and of every EMA entry (parameters and the
        batch-norm statistics and spectral-norm vectors it follows), each
        by the worst leaf.  The steps' losses and the generator's first
        gradient go to ``detail`` only: their gaps swing from seed to seed
        with the mesh branch's flatness term (``PERF.md``)."""
        cfg, tcfg = self.config, self.tcfg
        mcfg = nets.GANConfig(**model_config(cfg, "float32"))
        ref = GANSteps(mcfg, self.g0, self.d0, RefTemplate(**cfg["template"]),
                       self.device, tcfg.lr_g, tcfg.lr_d,
                       tcfg.mesh_regularization, tcfg.g_ema_alpha ** 100)
        order = gan_epoch_batches(len(self.data), self.batch_size, 0)
        ref_losses = []
        with Fp8Mode() if control else nullcontext():
            for it in range(FIRST_STEPS):
                b = self._ref_batch(0, order[it])
                z = gan_z(self.train_seed, it, self.batch_size,
                          mcfg.latent_dim).to(self.device)
                if it % (1 + tcfg.d_steps_per_g) == 0:
                    ref_losses.append(ref.g_step(b, z))
                    g_grad = first_moment(ref.opt_g, ref.G)
                else:
                    ref_losses.append(ref.d_step(b, z))
                    if it == 1:
                        d_grad = first_moment(ref.opt_d, ref.D)
        keep_g, keep_d = moving_leaves(g_grad), moving_leaves(d_grad)
        self.detail = dict(
            losses=[(got[k], want[k]) for got, want in
                    zip(self.losses, ref_losses) for k in want],
            g_grad=[], d_grad=[], change=[], ema=[],
            dropped=sorted(set(g_grad) - keep_g) + sorted(set(d_grad)
                                                          - keep_d))
        self.detail["loss_gap"] = max(rel_gap(g, w, 0.01)
                                      for g, w in self.detail["losses"])
        self.detail["g_grad_gap"] = worst_leaf_gap(
            self.g_grad, g_grad, keep_g, self.detail["g_grad"])[0]
        d_grad_gap = worst_leaf_gap(self.d_grad, d_grad, keep_d,
                                    self.detail["d_grad"])[0]
        dev = self.device

        def change(now: dict, start: dict) -> dict:
            return {k: now[k].float() - start[k].to(dev).float() for k in now}

        ema_now = {k: v for k, v in ref.ema.state_dict().items()
                   if v.is_floating_point()}
        keep_ema = {k for k in ema_now if k not in g_grad or k in keep_g}
        change_gap = max(
            worst_leaf_gap(change(self.after["g"], self.g0),
                           change(dict(ref.G.named_parameters()), self.g0),
                           keep_g, self.detail["change"])[0],
            worst_leaf_gap(change(self.after["d"], self.d0),
                           change(dict(ref.D.named_parameters()), self.d0),
                           keep_d, self.detail["change"])[0])
        ema_gap = worst_leaf_gap(change(self.after["ema"], self.g0),
                                 change(ema_now, self.g0), keep_ema,
                                 self.detail["ema"])[0]
        return dict(d_grad_gap=d_grad_gap, change_gap=change_gap,
                    ema_gap=ema_gap)
