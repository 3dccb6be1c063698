"""The mesh estimator's training loop as ``run_reconstruction`` runs it:
``ReconTrainer.train_step`` over ``data/cmr.batch_iterator`` (threads,
no processes, shuffled per epoch), the losses fetched every 10th step.

Set-up makes the photos and the weights from the seed, builds the
trainer, and drives its first three steps through the window's own call
and feed, keeping the network's output in the first step, each step's
recon loss, the first gradient of the network and of ``DatasetParams``
(Adam's first moment after one step over 1 − beta1) and the state after
three steps.  The check runs the plain
reference through the same three steps from the same weights and rows
(the shuffle worked out again), its render a few images at a time.
With ``fault`` (set only by the calibration script and the tests) the
state is left unchanged, half of each batch is cut off, or the loss is
taken over half of each batch's rows at the full shapes.
"""

from __future__ import annotations

from contextlib import nullcontext

import numpy as np
import torch

from portbench.entries.gan_train import mesh_gain
from portbench.lib.common import (
    first_moment,
    moving_leaves,
    rel_gap,
    rel_l2,
    seeded_state,
    subseed,
    worst_leaf_gap,
    worst_row_gap,
)
from portbench.lib.inputs import PhotoSet
from portbench.reference import nets
from portbench.reference.fp8 import Fp8Mode
from portbench.reference.render import MeshTemplate as RefTemplate
from portbench.reference.steps import ReconSteps

KIND = "train"
FIRST_STEPS = 3
BETA1 = 0.9
TRAIN_KEYS = ("image", "scale", "translation", "rotation", "idx")


def net_kwargs(config: dict) -> dict:
    m = config["model"]
    return dict(symmetric=m["symmetric"], texture_res=m["texture_resolution"],
                mesh_res=m["mesh_resolution"], image_res=m["image_resolution"])


def make_trainer(cell, config: dict, n: int):
    """The program's trainer with the seeded weights; keeps host copies of
    them on ``cell``."""
    from im23d_tpu_torch.geometry.mesh_template import MeshTemplate
    from im23d_tpu_torch.train.recon_trainer import ReconConfig, ReconTrainer

    m = config["model"]
    rcfg = ReconConfig(image_resolution=m["image_resolution"],
                       texture_resolution=m["texture_resolution"],
                       mesh_resolution=m["mesh_resolution"],
                       symmetric=m["symmetric"],
                       compute_dtype=m["compute_dtype"],
                       batch_size=cell.batch_size,
                       seed=subseed(cell.seed, 1) % 2**31, **config["train"])
    t = ReconTrainer(rcfg, n, MeshTemplate(**config["template"]),
                     device=cell.device)
    w = seeded_state(t.model, subseed(cell.seed, 2), cell.device,
                     mesh_gain(config))
    dp = seeded_state(t.dp_model, subseed(cell.seed, 3), cell.device)
    t.model.load_state_dict(w)
    t.dp_model.load_state_dict(dp)
    cell.w0 = {k: v.cpu() for k, v in w.items()}
    cell.dp0 = {k: v.cpu() for k, v in dp.items()}
    return t, rcfg


def ref_batch(data: PhotoSet, idx, device) -> dict:
    rows = data.rows(idx)
    return {k: torch.as_tensor(v).to(device) if k == "idx" else
            torch.as_tensor(v).to(device).float() for k, v in rows.items()}


def ref_steps(cell, rcfg, control_rows: int) -> ReconSteps:
    return ReconSteps(net_kwargs(cell.config), cell.w0, cell.dp0,
                      len(cell.data), RefTemplate(**cell.config["template"]),
                      cell.device, rcfg.lr, rcfg.lr_dataset,
                      rcfg.mesh_regularization,
                      cell.config["model"]["image_resolution"])


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 fault: str | None = None):
        self.config, self.traffic = config, traffic
        self.seed = int(seed)
        self.device = torch.device(device)
        self.fault = fault
        self.batch_size = traffic["batch_size"]
        self.samples_per_call = self.batch_size

    def setup(self, spans) -> None:
        tr = self.traffic
        self.data = PhotoSet(self.seed, self.config["dataset_size"],
                             self.config["model"]["image_resolution"],
                             self.device)
        self.trainer, self.rcfg = make_trainer(self, self.config,
                                               len(self.data))
        t = self.trainer
        if self.fault == "unchanged":
            t.opt.step = t.opt_dp.step = lambda *a, **k: None
        if self.fault == "half_loss":
            recon_loss = t._recon_loss

            def half_loss(x_fake, x_real, per_sample=False):
                per = recon_loss(x_fake, x_real, per_sample=True)
                return per if per_sample else per[: len(per) // 2].mean()

            t._recon_loss = half_loss
        self.batches = self._batches()
        self.losses = []
        hook = t.model.register_forward_hook(self._keep_output)
        for i in range(FIRST_STEPS):
            self.losses.append(self.step(spans, fetch_all=True))
            if i == 0:
                hook.remove()
                self.grad = {
                    **first_moment(t.opt, t.model, "net.", 1 - BETA1),
                    **first_moment(t.opt_dp, t.dp_model, "dp.", 1 - BETA1)}
        self.after = {f"{net}.{k}": p.detach().clone()
                      for net, mod in (("net", t.model), ("dp", t.dp_model))
                      for k, p in mod.named_parameters()}
        for _ in range(tr["warmup_steps"]):
            self.step(spans)
        self.sync()

    def _keep_output(self, module, inputs, output) -> None:
        """The network's (texture, mesh map) of the first step."""
        self.out0 = tuple(o.detach().clone() for o in output)

    def _batches(self):
        from im23d_tpu_torch.data.cmr import batch_iterator

        epoch = 0
        while True:
            self.trainer.epoch = epoch
            for it, batch in enumerate(batch_iterator(
                    self.data, self.batch_size, seed=epoch, keys=TRAIN_KEYS,
                    num_workers=self.traffic["feed_threads"])):
                yield it, batch
            epoch += 1

    def step(self, spans, fetch_all: bool = False):
        with spans("feed_wait"):
            it, batch = next(self.batches)
        batch = self._planted(batch)
        with spans("dispatch"):
            losses = self.trainer.train_step(batch)
        if fetch_all or it % self.traffic["fetch_every"] == 0:
            with spans("fetch"):
                return {k: float(v) for k, v in losses.items()}
        return None

    def _planted(self, batch: dict) -> dict:
        """Faults planted in the timed path (calibration only)."""
        if self.fault == "half_batch":
            return {k: v[: len(v) // 2] for k, v in batch.items()}
        if self.fault == "altered_row":
            batch = dict(batch)
            batch["image"] = batch["image"].copy()
            batch["image"][0, ..., :3] = -batch["image"][0, ..., :3]
            return batch
        return batch

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def release(self) -> None:
        self.batches.close()
        del self.trainer, self.batches
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def flops_per_call(self) -> float:
        """The network's conv and matmul FLOPs, forward and backward, of one
        step (the render is not counted), on the reference on meta."""
        from torch.utils.flop_counter import FlopCounterMode

        m = self.config["model"]
        with torch.device("meta"):
            net = nets.ReconstructionNetwork(**net_kwargs(self.config))
            x = torch.ones(self.batch_size, m["image_resolution"],
                           m["image_resolution"], 4)
        net.train()
        with FlopCounterMode(display=False) as fc:
            tex, mesh = net(x)
            (tex.sum() + mesh.sum()).backward()
        return fc.get_total_flops()

    def check(self, control: bool = False) -> dict:
        """Program against the reference (or the control: the reference in
        float8): the network's output in the first step (relative L2 of
        texture and mesh map), each parameter's change after three steps
        (worst leaf) and each ``DatasetParams`` row's change after them
        (worst row: a row is one photo's pose, moved only by the loss of
        the step that holds the photo, so a backward that leaves rows out
        reads 1 there).  The steps' recon losses and the first
        gradient go to ``detail`` only: the soft silhouette's edges
        (sigma 1e-4) turn rounding of the mesh into gaps that swing from
        seed to seed, alike in the program and the control (``PERF.md``)."""
        ref = ref_steps(self, self.rcfg, 0)
        rows = self.traffic["check_rows"]
        order = np.arange(len(self.data))
        np.random.RandomState(0).shuffle(order)
        ref_losses = []
        with Fp8Mode() if control else nullcontext():
            for it in range(FIRST_STEPS):
                idx = order[it * self.batch_size:(it + 1) * self.batch_size]
                ref_losses.append(ref.train_step(
                    ref_batch(self.data, idx, self.device), rows))
                if it == 0:
                    out0 = ref.last_out
                    grad = {
                        **first_moment(ref.opt, ref.net, "net.", 1 - BETA1),
                        **first_moment(ref.opt_dp, ref.dp, "dp.", 1 - BETA1)}
        keep = moving_leaves(grad)
        self.detail = dict(
            losses=[(g["recon_loss"], w["recon_loss"]) for g, w
                    in zip(self.losses, ref_losses)],
            grad=[], change=[], rows=[], dropped=sorted(set(grad) - keep))
        self.detail["loss_gap"] = max(rel_gap(g, w, 0.0)
                                      for g, w in self.detail["losses"])
        self.detail["grad_gap"] = worst_leaf_gap(self.grad, grad, keep,
                                                 self.detail["grad"])[0]
        now = {f"{net}.{k}": p.detach() for net, mod in (("net", ref.net),
                                                        ("dp", ref.dp))
               for k, p in mod.named_parameters()}
        start = {f"net.{k}": v for k, v in self.w0.items()}
        start.update({f"dp.{k}": v for k, v in self.dp0.items()})
        dev = self.device

        def change(state):
            return {k: state[k] - start[k].to(dev) for k in state}

        change_gap = worst_leaf_gap(change(self.after), change(now), keep,
                                    self.detail["change"])[0]
        rows_now = {k: v for k, v in change(now).items()
                    if k.startswith("dp.")}
        row_gap = worst_row_gap(change(self.after), rows_now,
                                self.detail["rows"])[0]
        out_gap = max(rel_l2(g, w) if g.shape == w.shape else float("inf")
                      for g, w in zip(self.out0, out0))
        return dict(out_gap=out_gap, change_gap=change_gap, row_gap=row_gap)
