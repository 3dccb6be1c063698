"""ShapeNet chairs training as ``training_test_shape_net`` runs it:
``ShapeNetLearner.train_step`` over ``DataBunch.train_iter()`` (one
producer thread, a pool of ``feed_threads``), each batch's copy
dispatched one step ahead by ``put_batch`` as ``fit`` does, the losses
and the argmin histogram fetched every ``fetch_every``-th step (the CLI's
``log_every``).

Set-up makes the renders and the weights from the seed, builds the
learner at the schedule's ``start_step``, and drives its first three steps
through the window's own call and feed, keeping what the check compares:
the first step's network outputs, its K-way sweep's silhouettes (K1) and
the gradient of its loss with respect to the cloud and the scale (only the
winners' projection, K2, reaches them), each step's host batch as the
feed drew it, its winners and losses, and the parameters and AdamW's
moments after each of the three steps.  The check runs the plain
reference ``reference/pointcloud.py`` on the same weights and batches.
With ``fault`` (set only by the calibration script and the tests) AdamW
does not step, half of each batch is cut off, the keep mask is ignored
(all points splatted), the winners' projection is detached, or the loss
takes the argmax over the candidates for the argmin.
"""

from __future__ import annotations

import math
import types
from contextlib import nullcontext
from functools import partial

import numpy as np
import torch

from portbench.lib.chairs_inputs import ChairRenders
from portbench.lib.common import (
    rel_gap,
    rel_l2,
    seeded_state,
    subseed,
    worst_leaf_gap,
)
from portbench.reference import pointcloud as ref_pc
from portbench.reference.fp8 import Fp8Mode

KIND = "train"
FIRST_STEPS = 3
LOSSES = ("projection_loss", "student_loss", "total_loss")


def learner_config(config: dict, traffic: dict, seed: int):
    """The program's ``ShapeNetConfig`` of the configuration."""
    from im23d_tpu_torch.train.shapenet_learner import ShapeNetConfig

    m, t = config["model"], config["train"]
    return ShapeNetConfig(
        image_size=m["image_size"], voxel_size=m["voxel_size"],
        num_points=m["num_points"], num_views=m["num_views"],
        num_candidates=m["num_candidates"],
        batch_size=traffic["batch_size"],
        learning_rate=t["learning_rate"], weight_decay=t["weight_decay"],
        total_steps=t["total_steps"], p_schedule=tuple(t["p_schedule"]),
        sigma_schedule=tuple(t["sigma_schedule"]),
        student_weight=t["student_weight"],
        log_every=traffic["fetch_every"], seed=seed,
        compute_dtype=m["compute_dtype"])


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 fault: str | None = None):
        self.config, self.traffic = config, traffic
        self.seed = int(seed)
        self.device = torch.device(device)
        self.fault = fault
        self.batch_size = traffic["batch_size"]
        self.samples_per_call = self.batch_size
        self.learner_seed = subseed(self.seed, 1) % 2**31
        self.data_seed = subseed(self.seed, 3) % 2**32
        self._unplant = None

    def setup(self, spans) -> None:
        from im23d_tpu_torch.data.shapenet import DataBunch
        from im23d_tpu_torch.train import shapenet_learner
        from im23d_tpu_torch.train.shapenet_learner import ShapeNetLearner

        m, tr = self.config["model"], self.traffic
        self.data = ChairRenders(self.seed, self.config["dataset_size"],
                                 m["image_size"], m["num_views"],
                                 self.device)
        L = self.learner = ShapeNetLearner(
            learner_config(self.config, tr, self.learner_seed),
            device=self.device)
        L.step = tr["start_step"]
        w = seeded_state(L.model, subseed(self.seed, 2), self.device)
        L.model.load_state_dict(w)
        self.w0 = {k: v.cpu() for k, v in w.items()}
        self._plant()
        self.bunch = DataBunch((self.data, self.data),
                               batch_size=self.batch_size,
                               use_camera=False, seed=self.data_seed,
                               num_workers=tr["feed_threads"])
        self.batches = self.bunch.train_iter()
        self.hosts = [next(self.batches)]
        self.pending = L.put_batch(self._planted(self.hosts[0]))
        self.losses, self.winners, self.states = [], [], []
        loss_fn = shapenet_learner.unsupervised_loss
        shapenet_learner.unsupervised_loss = partial(self._keep_first,
                                                     loss_fn)
        try:
            for _ in range(FIRST_STEPS):
                self.losses.append(self.step(spans, keep=True))
                self.winners.append(L._last_min_idx.clone())
                self.states.append(self._snapshot())
        finally:
            shapenet_learner.unsupervised_loss = loss_fn
        del self.hosts[FIRST_STEPS:]
        for _ in range(tr["warmup_steps"]):
            self.step(spans)
        self.sync()

    def _keep_first(self, loss_fn, outputs, *args, **kwargs):
        """The learner's loss; on the first step the network's outputs,
        the sweep's silhouettes and the cloud's and scale's gradients are
        kept."""
        if hasattr(self, "out0"):
            return loss_fn(outputs, *args, **kwargs)
        self.out0 = {k: v.detach().clone() for k, v in outputs.items()}
        self.grad0 = {}
        for k in ("point_cloud", "scale"):
            if outputs[k].requires_grad:
                outputs[k].register_hook(partial(self._keep_grad, k))
        losses, aux = loss_fn(outputs, *args, **kwargs)
        self.sweep0 = aux["projection"].detach().clone()
        return losses, aux

    def _snapshot(self) -> tuple:
        """The learner's parameters, AdamW's moments and its step count,
        copied to the host."""
        L = self.learner
        params, moments, n = {}, {}, 0
        for k, p in L.model.named_parameters():
            params[k] = p.detach().to("cpu", copy=True)
            st = L.opt.state.get(p)
            if st:
                moments[k] = tuple(st[m].to("cpu", copy=True)
                                   for m in ("exp_avg", "exp_avg_sq"))
                n = int(st["step"])
        return params, moments, n

    def _keep_grad(self, name: str, grad: torch.Tensor) -> None:
        self.grad0[name] = grad.detach().clone()

    def _plant(self) -> None:
        """Faults planted in the timed path (calibration only)."""
        L = self.learner
        if self.fault == "unchanged":
            L.opt.step = lambda *a, **k: None
        elif self.fault == "dense_keep":
            n = self.config["model"]["num_points"]
            L._keep_mask = lambda b, p, seed_offset=0: torch.ones(
                (b, n), device=self.device)
        elif self.fault == "no_winner_grad":
            from im23d_tpu_torch.losses import effective

            reuse = effective.projection_silhouette_reuse
            effective.projection_silhouette_reuse = \
                lambda points, size, sigma, scale, sil, **kw: sil.detach()
            self._unplant = partial(setattr, effective,
                                    "projection_silhouette_reuse", reuse)
        elif self.fault == "argmax":
            from im23d_tpu_torch.losses import effective

            flipped = types.SimpleNamespace(**vars(torch))
            flipped.argmin = torch.argmax
            effective.torch = flipped
            self._unplant = partial(setattr, effective, "torch", torch)

    def _planted(self, batch: dict) -> dict:
        if self.fault == "half_batch":
            return {k: v[: len(v) // 2] for k, v in batch.items()}
        return batch

    def step(self, spans, keep: bool = False):
        """One step; with ``keep`` (the first steps of the set-up) the host
        batch is kept for the check and the losses always fetched."""
        with spans("feed_wait"):
            host = next(self.batches)
        if keep:
            self.hosts.append(host)
        host = self._planted(host)
        L = self.learner
        with spans("dispatch"):
            batch, self.pending = self.pending, L.put_batch(host)
            losses = L.train_step(batch)
        if keep or L.step % self.traffic["fetch_every"] == 0:
            with spans("fetch"):
                out = {k: float(v) for k, v in losses.items()}
                out["predictors"] = np.bincount(
                    L._last_min_idx.cpu().numpy(),
                    minlength=self.config["model"]["num_candidates"]
                ).tolist()
                return out
        return None

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def release(self) -> None:
        self.batches.close()
        self.bunch._pool.shutdown(wait=False)
        if self._unplant is not None:
            self._unplant()
        del self.learner, self.batches, self.pending, self.bunch
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def flops_per_call(self) -> float:
        """The network's conv and matmul FLOPs, forward and backward, of one
        step (the projection is not counted), on the reference on meta."""
        from torch.utils.flop_counter import FlopCounterMode

        m = self.config["model"]
        B, H = self.batch_size, m["image_size"]
        with torch.device("meta"):
            net = ref_pc.UnsupervisedPart(H, m["num_points"],
                                          m["num_candidates"])
            img = torch.ones(B, H, H, 3)
            views = torch.ones(B * m["num_views"], H, H, 3)
        with FlopCounterMode(display=False) as fc:
            out = net(img, views)
            sum(v.sum() for v in out.values()).backward()
        return fc.get_total_flops()

    # -- the check ----------------------------------------------------------

    def check(self, control: bool = False) -> dict:
        """Program against the reference (or the control: the reference's
        network in float8), each a relative L2 in float64 unless said:

        * ``sil_gap``: the first step's sweep, (B·V, K, S, S) silhouettes,
          against the reference's projection of the program's own clouds,
          candidate poses and scales under the reference's keep mask and
          sigma: K1 alone;
        * ``grad_gap``: the gradient of the winners' projection loss with
          respect to the cloud and the scale (the worse of the two), from
          the same inputs and the program's winners: K2 and the chain back
          through the camera;
        * ``out_gap``: the network's first-step outputs (cloud, scale,
          ensemble and student quaternions; the worst) from the same
          weights and batch: the bfloat16 trunks;
        * ``change_gap``: every parameter's change in each of the first
          three AdamW steps, each step taken by the reference from the
          program's state before it (parameters and AdamW's moments), the
          worst step's worst leaf's gap of norms (``worst_leaf_gap``);
        * ``winner_excess``: the first step's winners, each row's squared
          error under the reference's sweep above that row's least, over
          the least; the worst row.  A winner the program picked at a near
          tie reads the tie's width, a wrong pick the gap between poses.

        The reference's steps take the program's winners and its state, as
        a language model's check feeds the sampled tokens: at a near tie
        the argmin flips on rounding, and a step of AdamW at lr 1e-3 moves
        each element of a layer by up to lr whatever the size of its
        gradient, so a free-running copy parts from the program on
        rounding alone (three free steps read 0.05–0.52 with the bfloat16
        trunks, 0.12–0.14 in float32; ``PERF.md``).  ``winner_excess``
        holds those winners to the reference's argmin.  The candidates'
        errors, the argmin's agreement and the steps' losses go to
        ``detail`` only.  A program whose shapes differ from the
        reference's reads inf."""
        m, t = self.config["model"], self.config["train"]
        V, S, B = m["num_views"], m["voxel_size"], self.batch_size
        start = self.traffic["start_step"]
        state = {k: v.to(self.device) for k, v in self.w0.items()}
        ref = ref_pc.ChairsSteps(m, t, state, self.learner_seed,
                                 self.device, start)
        batches = [{k: torch.as_tensor(v).to(self.device).float() / 255.0
                    for k, v in b.items()} for b in self.hosts]
        _, sigma = ref.schedules(start)
        keep = ref.keep(start, B)
        masks_s = ref_pc.resize_masks(batches[0]["masks"], S)
        out = self.out0
        full = len(out["point_cloud"]) == B
        self.detail = dict(losses=[], change=[])
        sil_gap = grad_gap = winner_excess = math.inf
        if full:
            with torch.no_grad():
                sweep = ref_pc.sweep(out["point_cloud"], out["ensemble_q"],
                                     out["scale"], keep, sigma, S)
            sil_gap = rel_l2(self.sweep0, sweep)
            grad_gap = self._grad_gap(keep, sigma, masks_s)
            winner_excess = self._winner_excess(sweep, masks_s)
        change_gap, prev = 0.0, (self.w0, {}, 0)
        with Fp8Mode() if control else nullcontext():
            for k, b in enumerate(batches):
                ref.load(*prev)
                start = {n: v.to(self.device) for n, v in prev[0].items()}
                won = self.winners[k] if full else None
                got, want = self.losses[k], ref.train_step(b, won)
                self.detail["losses"].append(
                    {n: (got[n], want[n]) for n in LOSSES})
                if k == 0:
                    out_ref = ref.last_out
                prev = self.states[k]
                mine = {n: v.to(self.device) - start[n]
                        for n, v in prev[0].items()}
                theirs = {n: p.detach() - start[n]
                          for n, p in ref.net.named_parameters()}
                rows = []
                change_gap = max(change_gap, worst_leaf_gap(
                    mine, theirs, None, rows)[0])
                self.detail["change"].append(rows)
        self.detail["loss_gap"] = max(
            rel_gap(g, w, 1e-6) for step in self.detail["losses"]
            for g, w in step.values())
        out_gap = max(rel_l2(out[k], v) if out[k].shape == v.shape
                      else math.inf for k, v in out_ref.items())
        return dict(sil_gap=sil_gap, grad_gap=grad_gap, out_gap=out_gap,
                    change_gap=change_gap, winner_excess=winner_excess)

    def _grad_gap(self, keep, sigma, masks_s) -> float:
        out = self.out0
        V = len(out["student_q"]) // len(out["point_cloud"])
        cloud = out["point_cloud"].clone().requires_grad_()
        scale = out["scale"].clone().requires_grad_()
        ens = out["ensemble_q"]
        best = ens[torch.arange(len(ens), device=ens.device), self.winners[0]]
        loss = ref_pc.winners_loss(cloud, best, scale, keep, sigma, masks_s,
                                   V)
        want = torch.autograd.grad(loss, (cloud, scale))
        names = ("point_cloud", "scale")
        gaps = {k: rel_l2(self.grad0.get(k, torch.zeros_like(w)), w)
                for k, w in zip(names, want)}
        self.detail["grad_gaps"] = gaps
        return max(gaps.values())

    def _winner_excess(self, sweep, masks_s) -> float:
        """The program's first-step winners' excess over the reference's
        least error (see ``check``); the candidates' errors from both
        sweeps and the share of rows whose argmin agrees go to ``detail``."""
        err = lambda s: ((s.double() - masks_s[:, None]) ** 2).sum((2, 3))  # noqa: E731
        got, want = err(self.sweep0), err(sweep)
        won = self.winners[0]
        rows = torch.arange(len(won), device=won.device)
        self.detail["candidate_gap"] = float(
            ((got - want).abs() / want.clamp(min=1e-12)).max())
        self.detail["argmin_agrees"] = float(
            (want.argmin(1) == won).double().mean())
        least = want.min(1).values
        return float(((want[rows, won] - least) / least.clamp(min=1e-12))
                     .max())
