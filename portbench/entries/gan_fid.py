"""The GAN's inference path as its FID evaluation runs it: one
closed-loop client calling ``FIDEvaluator.activations_for_batches`` with
one batch a call, batch after batch of the evaluation set and pass after
pass, each call's z drawn by ``truncation_sample`` from the batch's index
as the evaluator draws it.  A call generates with the EMA generator in
eval mode, poses and renders at the evaluation resolution and returns the
Inception features on the host.

The answers are each call's (B, D) features.  A sample of the set's
batches, drawn from the seed, is compared for every completed call: the
check runs the plain reference (generator, render, Inception) on them
from the same weights, poses, classes and z.  With ``fault`` (set only by
the calibration script) half of each batch is left out, or one sample's
features are altered where they are produced.
"""

from __future__ import annotations

from contextlib import nullcontext

import numpy as np
import torch

from portbench.entries.gan_train import mesh_gain, model_config
from portbench.lib.common import rel_l2, seeded_state, subseed
from portbench.lib.inputs import PoseSet
from portbench.reference import nets
from portbench.reference.fp8 import Fp8Mode
from portbench.reference.inception import InceptionV3Features
from portbench.reference.render import MeshTemplate as RefTemplate
from portbench.reference.steps import fid_activations, truncation_sample

KIND = "infer"
INCEPTION_GAIN = {"": 2.0}  # He scale: ReLU after every conv


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
        from im23d_tpu_torch.geometry.mesh_template import MeshTemplate
        from im23d_tpu_torch.metrics.inception import InceptionV3Features \
            as ProgInception
        from im23d_tpu_torch.models.gan import GANConfig
        from im23d_tpu_torch.train.gan_eval import FIDEvaluator
        from im23d_tpu_torch.train.gan_trainer import (
            GANTrainConfig,
            GANTrainer,
        )

        cfg, tr = self.config, self.traffic
        m = cfg["model"]
        self.poses = PoseSet(self.seed, tr["items"], m["n_classes"][0],
                             self.device)
        tcfg = GANTrainConfig(model=GANConfig(**model_config(cfg)),
                              batch_size=self.batch_size,
                              seed=subseed(self.seed, 1) % 2**31,
                              **cfg["train"])
        template = MeshTemplate(**cfg["template"])
        self.trainer = GANTrainer(tcfg, template, device=self.device)
        g = seeded_state(self.trainer.g_ema, subseed(self.seed, 4),
                         self.device, mesh_gain(cfg))
        self.trainer.g_ema.load_state_dict(g)
        self.g0 = {k: v.cpu() for k, v in g.items()}
        inception = ProgInception(cfg["inception"]["feature_layer"])
        w = seeded_state(inception, subseed(self.seed, 5), self.device,
                         INCEPTION_GAIN)
        inception.load_state_dict(w)
        self.i0 = {k: v.cpu() for k, v in w.items()}
        del g, w
        self.evaluator = FIDEvaluator(self.trainer, template,
                                      cfg["evaluation_res"],
                                      inception.to(self.device))
        self.n_batches = len(self.poses) // self.batch_size
        rng = np.random.default_rng(subseed(self.seed, 42))
        self.sampled = set(rng.choice(self.n_batches, tr["check_batches"],
                                      replace=False).tolist())
        self.call_no = 0
        self.answers = {}
        for _ in range(tr["warmup_calls"]):
            self.step(spans)
        self.answers = {}
        self.sync()

    def step(self, spans) -> None:
        from im23d_tpu_torch.train.gan_trainer import truncation_sample \
            as prog_truncation

        i = self.call_no % self.n_batches
        self.call_no += 1
        batch = self.poses.batch(i, self.batch_size)
        if self.fault == "half_batch":
            batch = {k: v[: len(v) // 2] for k, v in batch.items()}
        n = len(batch["c"])
        with spans("call"):
            z = prog_truncation(torch.Generator().manual_seed(i), n,
                                self.config["model"]["latent_dim"],
                                self.config["truncation_sigma"]).numpy()
            acts = self.evaluator.activations_for_batches(
                [batch], z_batches=[z])["combined"]
        if self.fault == "altered_row":
            acts = acts.copy()
            acts[0] = -acts[0]
        if i in self.sampled:
            self.answers.setdefault(i, []).append(acts)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def release(self) -> None:
        del self.trainer, self.evaluator
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def flops_per_call(self) -> float:
        """The generator's and the Inception's conv and matmul FLOPs of one
        call (the render is not counted), on the reference on meta."""
        from torch.utils.flop_counter import FlopCounterMode

        mcfg = nets.GANConfig(**model_config(self.config, "float32"))
        B, R = self.batch_size, self.config["evaluation_res"]
        with torch.device("meta"):
            G = nets.Generator(mcfg).eval()
            inc = InceptionV3Features(
                self.config["inception"]["feature_layer"])
            z = torch.randn(B, mcfg.latent_dim)
            c = torch.zeros(B, 1, dtype=torch.long)
            img = torch.ones(B, R, R, 3)
        with FlopCounterMode(display=False) as fc, torch.no_grad():
            G(z, c)
            inc(img)
        return fc.get_total_flops()

    def check(self, control: bool = False) -> dict:
        """The worst relative L2 of a sampled call's features against the
        reference's."""
        cfg, dev = self.config, self.device
        mcfg = nets.GANConfig(**model_config(cfg, "float32"))
        G = nets.Generator(mcfg).to(dev)
        G.load_state_dict(self.g0)
        inc = InceptionV3Features(cfg["inception"]["feature_layer"]).to(dev)
        inc.load_state_dict(self.i0)
        template = RefTemplate(**cfg["template"])
        if not self.answers:
            return dict(act_gap=float("inf"))
        gap = 0.0
        with Fp8Mode() if control else nullcontext():
            for i, seen in sorted(self.answers.items()):
                b = self.poses.batch(i, self.batch_size)
                z = truncation_sample(i, self.batch_size, mcfg.latent_dim,
                                      cfg["truncation_sigma"]).to(dev)

                def f32(a):
                    return torch.as_tensor(a, dtype=torch.float32, device=dev)

                want = fid_activations(
                    G, inc, template, cfg["evaluation_res"], z,
                    torch.as_tensor(b["c"], device=dev), f32(b["scale"]),
                    f32(b["translation"]), f32(b["rotation"]))
                for acts in seen:
                    got = torch.as_tensor(acts, device=dev)
                    gap = max(gap, rel_l2(got, want) if got.shape ==
                              want.shape else float("inf"))
        return dict(act_gap=gap)
