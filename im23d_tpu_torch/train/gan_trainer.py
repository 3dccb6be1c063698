"""UV-space mesh+texture GAN trainer on one device (counterpart of
``im23d_tpu/train/gan_trainer.py``).

* ``train_step``: a G step every (1 + ``d_steps_per_g``) iterations, else a
  D step; Adam(betas (0, 0.9), eps 1e-8) for each, the learning rate set
  per step to lr × the linear decay factor after ``lr_decay_after``
  epochs; hinge loss with the critics' alpha masks and, at 512² with two
  critics, critic weights [2, 1]; the fake texture is masked by the real
  alpha; flatness regularisation of the generated mesh.
* Both networks run in train mode in both steps, as in JAX: the G step
  moves the generator's batch-norm statistics and spectral-norm ``u`` and
  the critics' ``u``; the D step runs the generator without gradient (its
  statistics and ``u`` move) and the critics on one concatenated fake +
  real batch.
* The EMA generator follows the reference's epoch-dependent alpha
  (0.999^100 before epoch 10, 0.999^10 before 100) over every float
  parameter and buffer (batch-norm statistics, ``u``).
* ``z`` is standard normal from a ``torch.Generator`` seeded with (seed,
  iteration), drawn on the CPU, so a run is reproducible and a resumed run
  draws what the uninterrupted one drew; the steps take ``z`` as an
  argument too.  ``truncation_sample`` resamples components above sigma.
* ``conditional_text``: a frozen ``TextEncoder`` (vocabulary
  ``text_vocab_size``, width ``text_embedding_dim``, seeded at init or
  replaced by ``set_text_encoder``) turns a batch's ``caption`` tokens
  into word features and a padding mask for the generator and critics;
  the D step doubles them for its fake + real batch.
* Checkpoints ``checkpoint_<it>.pt`` (or the rolling ``latest``) under
  ``<workdir>/checkpoints`` hold both networks, the EMA generator, both
  optimizers, the text encoder, ``total_it`` and ``epoch``;
  ``curves_<step>.npz`` beside them the loss curves.
"""

from __future__ import annotations

import copy
import dataclasses
import math
import os

import numpy as np
import torch

from im23d_tpu_torch.core.checkpoint import (
    resolve_checkpoint,
    save_checkpoint,
)
from im23d_tpu_torch.core.convert import (
    discriminator_state_dict,
    generator_state_dict,
    text_encoder_state_dict,
)
from im23d_tpu_torch.geometry.mesh_template import MeshTemplate
from im23d_tpu_torch.losses.gan_losses import flatness_loss, gan_loss
from im23d_tpu_torch.models.gan import (
    GANConfig,
    Generator,
    MultiScaleDiscriminator,
    gan_init_,
)
from im23d_tpu_torch.models.text_encoder import (
    TextEncoder,
    caption_mask,
    text_encoder_init_,
)


@dataclasses.dataclass(frozen=True)
class GANTrainConfig:
    """The JAX ``GANTrainConfig``'s fields and defaults."""

    model: GANConfig = dataclasses.field(default_factory=GANConfig)
    lr_g: float = 1e-4
    lr_d: float = 4e-4
    d_steps_per_g: int = 2
    g_ema_alpha: float = 0.999
    mesh_regularization: float = 1e-4
    loss: str = "hinge"
    epochs: int = 600
    lr_decay_after: int = 1000
    batch_size: int = 32
    seed: int = 0
    text_vocab_size: int = 5450
    text_max_length: int = 18


def truncation_sample(gen: torch.Generator, n: int, dim: int,
                      sigma: float) -> torch.Tensor:
    """(n, dim) standard normal draws from ``gen`` (CPU), each component
    above ``sigma`` in magnitude redrawn, at most 100 rounds (the JAX
    version's bounded loop)."""
    z = torch.randn((n, dim), generator=gen)
    for _ in range(100):
        bad = z.abs() > sigma
        if not bool(bad.any()):
            break
        z = torch.where(bad, torch.randn((n, dim), generator=gen), z)
    return z


class GANTrainer:
    """Generator, critics, EMA generator and their optimizers on
    ``device``."""

    def __init__(self, config: GANTrainConfig,
                 template: MeshTemplate | None = None,
                 workdir: str | None = None,
                 device: str | torch.device = "cuda"):
        self.cfg = config
        self.mcfg = config.model
        self.workdir = workdir
        self.device = torch.device(device)
        self.use_mesh = not self.mcfg.texture_only
        self.template = template
        if self.use_mesh and template is None:
            self.template = MeshTemplate()
        gen = torch.Generator().manual_seed(config.seed)
        self.generator = Generator(self.mcfg, mesh_head=self.use_mesh)
        gan_init_(self.generator, gen)
        self.discriminator = MultiScaleDiscriminator(self.mcfg)
        gan_init_(self.discriminator, gen)
        self.generator.to(self.device).eval()
        self.discriminator.to(self.device).eval()
        self.g_ema = copy.deepcopy(self.generator).requires_grad_(False)
        self.text_encoder = None
        if self.mcfg.conditional_text:
            dim = self.mcfg.text_embedding_dim
            self.text_encoder = TextEncoder(config.text_vocab_size, dim,
                                            dim // 2)
            seed = np.random.SeedSequence([config.seed, 7]).generate_state(1)
            text_encoder_init_(self.text_encoder,
                               torch.Generator().manual_seed(int(seed[0])))
            self._freeze_text_encoder()
        self.opt_g = torch.optim.Adam(self.generator.parameters(),
                                      lr=config.lr_g, betas=(0.0, 0.9),
                                      eps=1e-8)
        self.opt_d = torch.optim.Adam(self.discriminator.parameters(),
                                      lr=config.lr_d, betas=(0.0, 0.9),
                                      eps=1e-8)
        self.total_it = 0
        self.epoch = 0
        self.curves: dict[str, list] = {"g_loss": [], "flat_loss": [],
                                        "d_fake": [], "d_real": []}

    # -- weights --------------------------------------------------------------

    def load_variables(self, g_vars: dict, d_vars: dict | None = None,
                       ema_vars: dict | None = None,
                       te_params: dict | None = None) -> None:
        """Load the JAX package's generator (and critics', EMA's) variables
        ``{params, batch_stats}`` and text encoder params as nested numpy
        dicts; the EMA generator takes ``ema_vars`` or a copy of the
        generator."""
        self.generator.load_state_dict(generator_state_dict(g_vars))
        if d_vars is not None:
            self.discriminator.load_state_dict(discriminator_state_dict(d_vars))
        self.g_ema.load_state_dict(generator_state_dict(ema_vars) if ema_vars
                                   else self.generator.state_dict())
        if te_params is not None:
            self.text_encoder.load_state_dict(
                text_encoder_state_dict(te_params))

    def _freeze_text_encoder(self) -> None:
        self.text_encoder.to(self.device).eval().requires_grad_(False)

    def set_text_encoder(self, state_dict: dict, vocab_size: int,
                         embedding_dim: int, hidden_dim: int) -> None:
        """Swap in pretrained text-encoder weights, an AttnGAN
        ``RNN_Encoder`` state dict (``encoder.*``, ``rnn.*``; other keys
        are ignored), frozen.  Raises ``ValueError`` unless the model is
        text-conditional and the encoder's word features (2·hidden_dim)
        are as wide as ``text_embedding_dim``."""
        if not self.mcfg.conditional_text:
            raise ValueError("the model is not text-conditional")
        if 2 * hidden_dim != self.mcfg.text_embedding_dim:
            raise ValueError(
                f"the pretrained encoder gives {2 * hidden_dim}-dim word "
                f"features but the GAN was built for "
                f"{self.mcfg.text_embedding_dim}")
        enc = TextEncoder(vocab_size, embedding_dim, hidden_dim)
        enc.load_state_dict({k: torch.as_tensor(v) for k, v in
                             state_dict.items()
                             if k.startswith(("encoder.", "rnn."))})
        self.text_encoder = enc
        self._freeze_text_encoder()

    # -- schedules --------------------------------------------------------------

    def _ema_alpha(self) -> float:
        a = self.cfg.g_ema_alpha
        if self.epoch < 10:
            return math.pow(a, 100)
        if self.epoch < 100:
            return math.pow(a, 10)
        return a

    def _lr_factor(self) -> float:
        cfg = self.cfg
        if self.epoch < cfg.lr_decay_after or cfg.epochs <= cfg.lr_decay_after:
            return 1.0
        return 1.0 - min(max((self.epoch - cfg.lr_decay_after)
                             / (cfg.epochs - cfg.lr_decay_after), 0.0), 1.0)

    def _d_weights(self):
        m = self.mcfg
        if m.num_discriminators == 2 and m.texture_resolution >= 512:
            return [2.0, 1.0]
        return None

    # -- steps ------------------------------------------------------------------

    def put_batch(self, batch: dict) -> dict:
        """Host NHWC arrays -> tensors on the device: texture, alpha and
        mesh in the compute dtype (the cache's float16 cast on the device),
        ``c`` int64."""
        out = {}
        for k, v in batch.items():
            t = v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))
            t = t.to(self.device, non_blocking=True)
            out[k] = (t.long() if k in ("c", "idx", "caption")
                      else t.to(self.mcfg.dtype))
        return out

    def encode_caption(self, tokens: torch.Tensor | None):
        """Caption tokens (B, L) -> (word features, padding mask) from the
        frozen encoder, or None without tokens or a text encoder."""
        if tokens is None or self.text_encoder is None:
            return None
        with torch.no_grad():
            words, _ = self.text_encoder(tokens)
        return words, caption_mask(tokens)

    def sample_z(self, n: int) -> torch.Tensor:
        """The iteration's latent draw, (n, latent_dim) on the device."""
        gen = torch.Generator().manual_seed((self.cfg.seed << 32)
                                            + self.total_it)
        return torch.randn((n, self.mcfg.latent_dim), generator=gen).to(
            self.device)

    def _fake(self, z, c, alpha, caption):
        tex, mesh = self.generator(z, c, caption)
        return torch.cat([tex * alpha, alpha], dim=-1), mesh

    def g_step(self, nb: dict, z: torch.Tensor, lr_factor: float = 1.0
               ) -> dict:
        cfg = self.cfg
        G, D = self.generator, self.discriminator
        G.train()
        D.train()
        D.requires_grad_(False)
        try:
            c, alpha = nb.get("c"), nb["alpha"]
            caption = self.encode_caption(nb.get("caption"))
            x_fake, mesh = self._fake(z, c, alpha, caption)
            preds, masks = D(x_fake, mesh, c, alpha=alpha, caption=caption)
            loss_gan = gan_loss(preds, True, False, masks, self._d_weights(),
                                cfg.loss)
            flat = torch.zeros((), device=self.device)
            if self.use_mesh:
                vtx = self.template.get_vertex_positions(mesh)
                flat = flatness_loss(self.template.compute_normals(vtx),
                                     self.template.tensor("ff", self.device))
            loss = loss_gan + cfg.mesh_regularization * flat
            for group in self.opt_g.param_groups:
                group["lr"] = cfg.lr_g * lr_factor
            self.opt_g.zero_grad(set_to_none=True)
            loss.backward()
            self.opt_g.step()
        finally:
            D.requires_grad_(True)
            G.eval()
            D.eval()
        self._update_ema(self._ema_alpha())
        return dict(g_loss=loss_gan.detach(), flat_loss=flat.detach())

    def d_step(self, nb: dict, z: torch.Tensor, lr_factor: float = 1.0
               ) -> dict:
        cfg = self.cfg
        G, D = self.generator, self.discriminator
        G.train()
        D.train()
        try:
            c, alpha = nb.get("c"), nb["alpha"]
            caption = self.encode_caption(nb.get("caption"))
            with torch.no_grad():
                x_fake, mesh = self._fake(z, c, alpha, caption)
            x_real = torch.cat([nb["texture"], alpha], dim=-1)
            x_comb = torch.cat([x_fake, x_real], dim=0)
            c_comb = None if c is None else torch.cat([c, c], dim=0)
            mesh_comb = (None if mesh is None else
                         torch.cat([mesh, nb["mesh"].float()], dim=0))
            caption_comb = (None if caption is None else
                            tuple(torch.cat([t, t], dim=0) for t in caption))
            preds, masks = D(x_comb, mesh_comb, c_comb,
                             alpha=torch.cat([alpha, alpha], dim=0),
                             caption=caption_comb)
            B = x_fake.shape[0]
            w = self._d_weights()
            loss_fake = gan_loss([p[:B] for p in preds], False, True,
                                 [None if m is None else m[:B] for m in masks],
                                 w, cfg.loss)
            loss_real = gan_loss([p[B:] for p in preds], True, True,
                                 [None if m is None else m[B:] for m in masks],
                                 w, cfg.loss)
            for group in self.opt_d.param_groups:
                group["lr"] = cfg.lr_d * lr_factor
            self.opt_d.zero_grad(set_to_none=True)
            (loss_fake + loss_real).backward()
            self.opt_d.step()
        finally:
            G.eval()
            D.eval()
        return dict(d_fake=loss_fake.detach(), d_real=loss_real.detach())

    @torch.no_grad()
    def _update_ema(self, alpha: float) -> None:
        live = self.generator.state_dict()
        for k, v in self.g_ema.state_dict().items():
            if v.is_floating_point():
                v.copy_(v * alpha + live[k] * (1.0 - alpha))

    def train_step(self, batch: dict, z: torch.Tensor | None = None) -> dict:
        """One iteration on a host or device batch (texture (B, H, W, 3),
        alpha (B, H, W, 1), mesh (B, m, m, 3), optional c (B, k)): a G step
        every (1 + d_steps_per_g) iterations, else a D step.  Returns the
        step's losses as device scalars."""
        nb = self.put_batch(batch)
        if z is None:
            z = self.sample_z(nb["alpha"].shape[0])
        if self.total_it % (1 + self.cfg.d_steps_per_g) == 0:
            losses = self.g_step(nb, z, self._lr_factor())
        else:
            losses = self.d_step(nb, z, self._lr_factor())
        self.total_it += 1
        return losses

    # -- inference ----------------------------------------------------------

    def _long(self, a) -> torch.Tensor:
        """A host array or a tensor on any device -> int64 on the device."""
        t = a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a))
        return t.to(self.device).long()

    @torch.no_grad()
    def generate(self, z: torch.Tensor, c=None, caption_tokens=None):
        """EMA generator in eval mode: (texture (B, T, T, 3), mesh map
        (B, m, m, 3) or None), float32; ``caption_tokens`` (B, L) go
        through the text encoder."""
        z = torch.as_tensor(z, dtype=torch.float32, device=self.device)
        if c is not None:
            c = self._long(c)
            if c.dim() == 1:
                c = c[:, None]
        caption = None
        if caption_tokens is not None:
            caption = self.encode_caption(self._long(caption_tokens))
        tex, mesh = self.g_ema(z, c, caption)
        return tex.float(), None if mesh is None else mesh.float()

    def truncation_sample(self, seed: int, n: int, sigma: float
                          ) -> torch.Tensor:
        """``truncation_sample`` from a generator seeded with ``seed``, on
        the device."""
        gen = torch.Generator().manual_seed(int(seed))
        return truncation_sample(gen, n, self.mcfg.latent_dim, sigma).to(
            self.device)

    # -- checkpoints ----------------------------------------------------------

    def record_curves(self, losses: dict) -> None:
        """Append host scalars to the persisted loss curves."""
        for k, v in losses.items():
            if k in self.curves:
                self.curves[k].append(float(v))

    def _ckpt_dir(self, workdir: str | None) -> str:
        return os.path.join(workdir or self.workdir, "checkpoints")

    def save(self, workdir: str | None = None, tag: str | None = None) -> str:
        """tag None writes the permanent checkpoint of ``total_it``, tag
        "latest" overwrites the rolling one; the curves go beside it."""
        step = self.total_it if tag is None else tag
        d = self._ckpt_dir(workdir)
        path = save_checkpoint(d, step, dict(
            g=self.generator.state_dict(), d=self.discriminator.state_dict(),
            g_ema=self.g_ema.state_dict(), opt_g=self.opt_g.state_dict(),
            opt_d=self.opt_d.state_dict(), total_it=self.total_it,
            epoch=self.epoch,
            te=(None if self.text_encoder is None
                else self.text_encoder.state_dict())))
        np.savez(os.path.join(d, f"curves_{step}.npz"),
                 **{k: np.asarray(v, np.float32)
                    for k, v in self.curves.items()})
        return path

    def restore(self, workdir: str | None = None, step=None) -> None:
        """Load the checkpoint of ``step`` (an int or "latest"; by default
        the newest) and its curves."""
        d = self._ckpt_dir(workdir)
        path = resolve_checkpoint(d, step)
        tree = torch.load(path, map_location=self.device, weights_only=True)
        self.generator.load_state_dict(tree["g"])
        self.discriminator.load_state_dict(tree["d"])
        self.g_ema.load_state_dict(tree["g_ema"])
        self.opt_g.load_state_dict(tree["opt_g"])
        self.opt_d.load_state_dict(tree["opt_d"])
        if self.text_encoder is not None and tree.get("te") is not None:
            self.text_encoder.load_state_dict(tree["te"])
        self.total_it = int(tree["total_it"])
        self.epoch = int(tree["epoch"])
        tag = os.path.basename(path)[len("checkpoint_"):-len(".pt")]
        cpath = os.path.join(d, f"curves_{tag}.npz")
        if os.path.exists(cpath):
            with np.load(cpath) as curves:
                self.curves = {k: [float(x) for x in curves[k]]
                               for k in curves.files}
