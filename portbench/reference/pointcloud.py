"""Frozen plain copy of Pipeline A, the ShapeNet chairs model: one image
to a point cloud, trained by the rendering-free projection loss, in plain
PyTorch and float32 (the caller turns TF32 off: ``steps.fp32_only``).

Written from the reference repository
(https://github.com/NikolaZubic/2dimageto3dmodel): ``code/models/
unsupervised_part.py`` (``UnsupervisedPart``: one encoder for the input
image and the pose views, the point decoder, the pose ensemble and its
student; ``UnsupervisedLoss``: the K-way min over pose candidates and the
student's quaternion-angle loss at weight 20), ``code/utils/
effective_loss_function.py`` (ray-termination probabilities with the
epsilon-filled leading plane, the depth sum and its vertical flip),
``trilinear_interpolation.py`` (strict border cull, 8-corner splat),
``smooth_voxels.py`` (the separable Gaussian blur, then ``* scale`` and the
clamp), ``code/camera/coordinate_system_transformation.py`` (field of
view 1.875, camera distance 2) and ``training_test_shape_net.py``
(AdamW, the linear p and sigma schedules).

Departures, each also the program's:

* the splat's low corner weighs ``1 - frac`` (the original computes
  ``1 - grid - floor(grid)``) at the configured grid size (it hard-codes
  64);
* the blur runs (the original hands it no kernels): 21 taps along z, y
  and x, zero padded, the order of a separable sum;
* dropout keeps exactly ceil(N p) points a cloud, drawn as the program
  draws them (uniforms from a generator seeded by seed · 2^32 + step, the
  smallest kept), and dropped points weigh 0 in a shape-static splat;
* ``UnsupervisedLoss``'s undefined ``num_candidates`` is K;
* the masks are resized to the silhouette's side bilinearly with aligned
  corners (the original's ``F.interpolate`` by 1/2).

Where this copy and the program differ by rounding alone: the program's
CUDA projection (K1, K2) adds the splat in 64-bit fixed point where this
adds float32 (``index_add``, in any order on a card), blurs by cluster
sums where this convolves, and runs the encoder and pose trunks in
bfloat16 where the configuration says so.  It imports nothing of the
program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

FIELD_OF_VIEW = 1.875
CAMERA_DISTANCE = 2.0
BORDER_EPS = 1e-6
TERMINATION_EPS = 1e-5
KERNEL_SIZE = 21


# --- networks ----------------------------------------------------------------

class Encoder(nn.Module):
    """Nine 16-channel convs (5 × 5, then 3 × 3; strides 2, 2, 1, 2, 1, 2,
    1, 2, 1; padding k // 2; ReLU), the NHWC flatten, 1024, ReLU, 1024."""

    STRIDES = (2, 2, 1, 2, 1, 2, 1, 2, 1)

    def __init__(self, image_size: int, features: int = 1024,
                 channels: int = 16):
        super().__init__()
        convs, cin, side = [], 3, image_size
        for i, stride in enumerate(self.STRIDES):
            k = 5 if i == 0 else 3
            convs.append(nn.Conv2d(cin, channels, k, stride, k // 2))
            cin = channels
            side = (side - 1) // stride + 1
        self.conv = nn.ModuleList(convs)
        self.dense = nn.ModuleList([nn.Linear(side * side * channels,
                                              features),
                                    nn.Linear(features, features)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        for conv in self.conv:
            x = F.relu(F.conv2d(x, conv.weight, conv.bias, conv.stride,
                                conv.padding))
        x = x.permute(0, 2, 3, 1).flatten(1)
        x = F.relu(F.linear(x, self.dense[0].weight, self.dense[0].bias))
        return F.linear(x, self.dense[1].weight, self.dense[1].bias)


class Decoder(nn.Module):
    """Latent to N points in [-0.5, 0.5]³ (tanh / 2; (z, y, x)) and the
    cloud's occupancy scale (sigmoid)."""

    def __init__(self, features: int, num_points: int):
        super().__init__()
        self.num_points = num_points
        self.points = nn.Linear(features, 3 * num_points)
        self.scale = nn.Linear(features, 1)

    def forward(self, z: torch.Tensor):
        pts = F.linear(z, self.points.weight, self.points.bias)
        cloud = torch.tanh(pts.view(len(z), self.num_points, 3)) / 2
        return cloud, torch.sigmoid(F.linear(z, self.scale.weight,
                                             self.scale.bias))


class PoseHead(nn.Module):
    """hidden → hidden → hidden → a quaternion, ReLU between."""

    def __init__(self, hidden: int):
        super().__init__()
        self.dense = nn.ModuleList([nn.Linear(hidden, hidden),
                                    nn.Linear(hidden, hidden),
                                    nn.Linear(hidden, 4)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.dense):
            x = F.linear(x, layer.weight, layer.bias)
            if i < 2:
                x = F.relu(x)
        return x


class PoseDecoder(nn.Module):
    """A student trunk and head, and K heads on one shared trunk."""

    def __init__(self, features: int, hidden: int, candidates: int):
        super().__init__()
        self.student_trunk = nn.Linear(features, hidden)
        self.student_head = PoseHead(hidden)
        self.ensemble_trunk = nn.Linear(features, hidden)
        self.heads = nn.ModuleList(PoseHead(hidden)
                                   for _ in range(candidates))

    def forward(self, z: torch.Tensor):
        st = F.relu(F.linear(z, self.student_trunk.weight,
                             self.student_trunk.bias))
        sh = F.relu(F.linear(z, self.ensemble_trunk.weight,
                             self.ensemble_trunk.bias))
        return (torch.stack([h(sh) for h in self.heads], dim=1),
                self.student_head(st))


class UnsupervisedPart(nn.Module):
    """(images (B, H, W, 3), pose views (B·V, H, W, 3)) → point_cloud (B,
    N, 3), scale (B, 1), ensemble_q (B·V, K, 4), student_q (B·V, 4).  The
    program's layer names: one state dict loads into both."""

    def __init__(self, image_size: int, num_points: int, num_candidates: int,
                 features: int = 1024, pose_hidden: int = 128):
        super().__init__()
        self.encoder = Encoder(image_size, features)
        self.decoder = Decoder(features, num_points)
        self.pose_decoder = PoseDecoder(features, pose_hidden,
                                        num_candidates)

    def forward(self, images: torch.Tensor, pose_images: torch.Tensor):
        cloud, scale = self.decoder(self.encoder(images))
        ens, stu = self.pose_decoder(self.encoder(pose_images))
        return dict(point_cloud=cloud, scale=scale, ensemble_q=ens,
                    student_q=stu)


# --- quaternions and the camera ----------------------------------------------

def unit(q: torch.Tensor) -> torch.Tensor:
    return q / q.norm(dim=-1, keepdim=True).clamp(min=1e-12)


def hamilton(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a · b of (w, x, y, z) quaternions."""
    aw, av = a[..., :1], a[..., 1:]
    bw, bv = b[..., :1], b[..., 1:]
    w = aw * bw - (av * bv).sum(-1, keepdim=True)
    v = aw * bv + bw * av + torch.linalg.cross(av, bv, dim=-1)
    return torch.cat([w, v], dim=-1)


def rotation_matrix(q: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation of the unit (w, x, y, z) quaternion ``q``, on
    vectors in the order (x, y, z) of its imaginary part."""
    w, x, y, z = q.unbind(-1)
    rows = [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]
    return torch.stack(rows, dim=-1).view(*q.shape[:-1], 3, 3)


def to_camera(cloud: torch.Tensor, q: torch.Tensor):
    """Camera-space (z, y, x) planes (C, N) of clouds (C, N, 3) under the
    (C, 4) poses: rotate by the normalised quaternion, divide the lateral
    components by depth + the camera distance, times the field of view."""
    p = cloud @ rotation_matrix(unit(q)).transpose(-1, -2)
    z = p[..., 0]
    f = FIELD_OF_VIEW / (z + CAMERA_DISTANCE)
    return z, p[..., 1] * f, p[..., 2] * f


def angle_loss(target: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """1 − w², w the real part of the normalised target · conj(q)."""
    conj = q * q.new_tensor([1.0, -1.0, -1.0, -1.0])
    return 1 - unit(hamilton(target, conj))[..., 0] ** 2


# --- the projection ----------------------------------------------------------

def gaussian_taps(sigma: torch.Tensor, size: int = KERNEL_SIZE):
    x = torch.arange(size, dtype=torch.float32, device=sigma.device) \
        - size // 2
    k = torch.exp(-x * x / (2 * sigma * sigma))
    return k / k.sum()


def splat(coords: torch.Tensor, weights: torch.Tensor, S: int):
    """(C, S, S, S) trilinear sums of (C, N, 3) grid coordinates (z, y, x)
    times ``weights`` (C, N); corners past the grid are clamped onto it
    (the points there weigh 0)."""
    C, N, _ = coords.shape
    lo = torch.floor(coords)
    frac = coords - lo
    lo = lo.long()
    idx, w = [], []
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                d = (dz, dy, dx)
                cw = weights
                for a in range(3):
                    cw = cw * (frac[..., a] if d[a] else 1 - frac[..., a])
                iz, iy, ix = ((lo[..., a] + d[a]).clamp(0, S - 1)
                              for a in range(3))
                idx.append((iz * S + iy) * S + ix)
                w.append(cw)
    idx = torch.stack(idx, -1) + (torch.arange(C, device=coords.device)
                                  * S ** 3).view(C, 1, 1)
    grid = coords.new_zeros(C * S ** 3)
    grid = grid.index_add(0, idx.flatten(), torch.stack(w, -1).flatten())
    return grid.view(C, S, S, S)


def blur(vox: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """'same' zero-padded convolution of (C, Z, Y, X) by ``taps`` along
    z, then y, then x."""
    K, h = taps.numel(), taps.numel() // 2
    x = vox[:, None]
    for shape, pad in (((K, 1, 1), (h, 0, 0)), ((1, K, 1), (0, h, 0)),
                       ((1, 1, K), (0, 0, h))):
        x = F.conv3d(x, taps.view(1, 1, *shape), padding=pad)
    return x[:, 0]


def silhouette(occ: torch.Tensor) -> torch.Tensor:
    """(C, S, S) silhouettes of (C, Z, Y, X) occupancies: Σ_z of the
    probability that the ray ends at z (occupied at z, empty before; the
    first plane's log transmittance is eps, not 0), flipped along y."""
    o = occ.clamp(TERMINATION_EPS, 1 - TERMINATION_EPS)
    log_t = torch.cumsum(torch.log1p(-o), dim=1)
    log_t = torch.cat([torch.full_like(o[:, :1], TERMINATION_EPS),
                       log_t[:, :-1]], dim=1)
    return torch.flip(torch.exp(log_t + torch.log(o)).sum(1), dims=(1,))


def project(cloud: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
            keep: torch.Tensor, sigma: torch.Tensor, S: int) -> torch.Tensor:
    """(C, S, S) silhouettes of clouds (C, N, 3) under poses (C, 4) with
    occupancy scales (C,) and keep weights (C, N): points on or past the
    border eps are culled; splat, clamp to 1, blur, × scale, clamp,
    termination, depth sum."""
    z, y, x = to_camera(cloud, q)
    lim = 0.5 - BORDER_EPS
    inside = ((z.abs() < lim) & (y.abs() < lim) & (x.abs() < lim)).float()
    g = (S - 1) * (torch.stack([z, y, x], -1) + 0.5)
    vox = splat(g, inside * keep, S).clamp(0, 1)
    occ = (blur(vox, gaussian_taps(sigma)) * scale.view(-1, 1, 1, 1)
           ).clamp(0, 1)
    return silhouette(occ)


def resize_masks(masks: torch.Tensor, S: int) -> torch.Tensor:
    if masks.shape[-1] == S:
        return masks
    return F.interpolate(masks[:, None], size=(S, S), mode="bilinear",
                         align_corners=True)[:, 0]


def sweep(cloud, ens_q, scale, keep, sigma, S: int, block: int = 60):
    """(B·V, K, S, S) silhouettes of every candidate: cloud b under pose
    (b·V + v, k), in blocks of ``block`` clouds."""
    B = cloud.shape[0]
    BV, K, _ = ens_q.shape
    per = BV // B * K
    q = ens_q.reshape(-1, 4)
    out = []
    for s in range(0, len(q), block):
        rows = torch.arange(s, min(len(q), s + block), device=q.device) // per
        out.append(project(cloud[rows], q[s:s + block], scale.view(-1)[rows],
                           keep[rows], sigma, S))
    return torch.cat(out).view(BV, K, S, S)


def winners_loss(cloud, best_q, scale, keep, sigma, masks_s, V: int):
    """Σ over the B·V winners of the squared silhouette error, over B·V."""
    S = masks_s.shape[-1]
    rep = lambda t: t.repeat_interleave(V, dim=0)  # noqa: E731
    sil = project(rep(cloud), best_q, rep(scale.view(-1)), rep(keep), sigma,
                  S)
    return ((sil - masks_s) ** 2).sum() / len(best_q)


# --- the training step -------------------------------------------------------

class ChairsSteps:
    """The network and AdamW from one state; each step takes the schedules
    and the keep mask at its pre-update step."""

    def __init__(self, model: dict, train: dict, state: dict, seed: int,
                 device, start_step: int = 0):
        self.dev = torch.device(device)
        self.net = UnsupervisedPart(model["image_size"], model["num_points"],
                                    model["num_candidates"]).to(self.dev)
        self.net.load_state_dict(state)
        self.opt = torch.optim.AdamW(self.net.parameters(),
                                     lr=train["learning_rate"],
                                     betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=train["weight_decay"])
        self.model, self.train = model, train
        self.seed = int(seed)
        self.step = int(start_step)

    def load(self, params: dict, moments: dict, adam_steps: int) -> None:
        """The parameters and AdamW's moments (name → (exp_avg,
        exp_avg_sq); a parameter without them has none yet) of a run
        after ``adam_steps`` steps."""
        with torch.no_grad():
            for k, p in self.net.named_parameters():
                p.copy_(params[k])
                if k in moments:
                    m, v = moments[k]
                    self.opt.state[p] = dict(
                        step=torch.tensor(float(adam_steps)),
                        exp_avg=m.to(self.dev, copy=True),
                        exp_avg_sq=v.to(self.dev, copy=True))
                else:
                    self.opt.state.pop(p, None)

    def schedules(self, step: int):
        """(p, sigma) float32 on the device, linear in step / total."""
        frac = torch.full((), step / float(self.train["total_steps"]),
                          device=self.dev).clamp(0, 1)
        (p0, p1), (s0, s1) = (self.train["p_schedule"],
                              self.train["sigma_schedule"])
        return p0 * (1 - frac) + p1 * frac, s0 * (1 - frac) + s1 * frac

    def keep(self, step: int, B: int) -> torch.Tensor:
        """(B, N): ones at the ceil(N p) smallest of B · N uniforms."""
        N = self.model["num_points"]
        p, _ = self.schedules(step)
        gen = torch.Generator(device=self.dev).manual_seed(
            self.seed * 2 ** 32 + step)
        u = torch.rand((B, N), generator=gen, device=self.dev)
        m = int(torch.ceil(N * p))
        out = torch.zeros_like(u)
        return out.scatter_(1, torch.argsort(u, dim=1)[:, :m], 1.0)

    def losses(self, out: dict, masks_s, sigma, keep, winners=None):
        """The step's losses and the winners: the given ones, else the
        argmin of the candidates' squared errors."""
        V = len(out["student_q"]) // len(out["point_cloud"])
        S = self.model["voxel_size"]
        ens = out["ensemble_q"]
        if winners is None:
            with torch.no_grad():
                sil = sweep(out["point_cloud"], ens, out["scale"], keep,
                            sigma, S)
                winners = ((sil - masks_s[:, None]) ** 2).sum((2, 3)).argmin(1)
        best = ens[torch.arange(len(ens), device=ens.device), winners]
        proj = winners_loss(out["point_cloud"], best, out["scale"], keep,
                            sigma, masks_s, V)
        student = angle_loss(best.detach(), out["student_q"]).sum() / len(ens)
        total = proj + self.train["student_weight"] * student
        return dict(projection_loss=proj, student_loss=student,
                    total_loss=total), winners

    def train_step(self, batch: dict, winners=None) -> dict:
        """One AdamW step on a batch (float images, pose views and masks on
        the device); ``winners`` (B·V,) fixes the argmin."""
        B = len(batch["images"])
        _, sigma = self.schedules(self.step)
        keep = self.keep(self.step, B)
        out = self.net(batch["images"], batch["pose_input"])
        self.last_out = {k: v.detach() for k, v in out.items()}
        masks_s = resize_masks(batch["masks"], self.model["voxel_size"])
        losses, self.last_winners = self.losses(out, masks_s, sigma, keep,
                                                winners)
        self.opt.zero_grad(set_to_none=True)
        losses["total_loss"].backward()
        self.opt.step()
        self.step += 1
        return {k: float(v.detach()) for k, v in losses.items()}
