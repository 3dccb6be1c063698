"""What every cell shares: the peaks of the card, seeded weights and input
fields made on the device, the statistics of a window, and the numbers
that decide ``correct``.

Nothing here imports the program.
"""

from __future__ import annotations

import math
import statistics

import numpy as np
import torch
import torch.nn.functional as F

# one NVIDIA H100 SXM (data sheet, dense): HBM bytes/s, bf16 and float32
# (CUDA cores) operations/s
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
PEAK_F32 = 67e12


def subseed(seed: int, *keys: int) -> int:
    """A 63-bit seed for one use of the run's ``--seed``."""
    return int(np.random.SeedSequence([int(seed) % 2**64, *keys])
               .generate_state(2, np.uint32).astype(np.uint64)
               @ np.array([1, 2**31], np.uint64))


def device_generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


# --- weights -----------------------------------------------------------------

def _leaf_rule(name: str, shape: tuple, gains: dict) -> tuple[float, float]:
    """(std, mean) of a leaf: conv and linear weights N(0, gain / fan_in),
    a norm's scale 1 + N(0, 0.1²), biases N(0, 0.02²), spectral-norm ``u``
    N(0, 1), running statistics 0 and 1, per-image pose deltas
    N(0, 0.01²).  ``gains`` scales the weights of leaves whose name holds
    a key (the mesh heads: a trained mesh moves by tenths, not by ones)."""
    last = name.rsplit(".", 1)[-1]
    if last == "running_mean":
        return 0.0, 0.0
    if last == "running_var":
        return 0.0, 1.0
    if last == "weight_u":
        return 1.0, 0.0
    if last.startswith("ds_"):
        return 0.01, 0.0
    if last == "bias":
        return 0.02, 0.0
    if len(shape) == 1:
        return 0.1, 1.0
    gain = next((g for k, g in gains.items() if k in name), 1.0)
    fan_in = math.prod(shape[1:])
    return math.sqrt(gain / fan_in), 0.0


def seeded_state(module: torch.nn.Module, seed: int, device,
                 gains: dict | None = None) -> dict[str, torch.Tensor]:
    """A state dict for ``module``'s float leaves, drawn on ``device`` from
    ``seed`` in one normal draw, scaled and shifted per leaf (see
    ``_leaf_rule``) in two more calls; integer buffers keep their values."""
    gains = gains or {}
    sd = module.state_dict()
    floats = [(k, v) for k, v in sd.items() if v.is_floating_point()]
    sizes = [v.numel() for _, v in floats]
    rules = [_leaf_rule(k, tuple(v.shape), gains) for k, v in floats]
    n = torch.tensor(sizes, device=device)
    std = torch.repeat_interleave(
        torch.tensor([r[0] for r in rules], device=device), n)
    mean = torch.repeat_interleave(
        torch.tensor([r[1] for r in rules], device=device), n)
    flat = torch.randn(sum(sizes), generator=device_generator(seed, device),
                       device=device) * std + mean
    out = dict(sd)
    for (k, v), part in zip(floats, torch.split(flat, sizes)):
        out[k] = part.view(v.shape).to(v.dtype)
    return {k: v.to(device) for k, v in out.items()}


# --- input fields ------------------------------------------------------------

def smooth_field(gen: torch.Generator, n: int, channels: int, res: int,
                 base: int, device, chunk: int = 64) -> torch.Tensor:
    """(n, res, res, channels) float32 fields of unit-scale variation: a
    base × base normal draw per map, bilinearly upsampled (in chunks of
    ``chunk`` maps)."""
    out = torch.empty((n, res, res, channels), device=device)
    for s in range(0, n, chunk):
        m = min(chunk, n - s)
        low = torch.randn((m, channels, base, base), generator=gen,
                          device=device)
        out[s:s + m] = F.interpolate(low, size=(res, res), mode="bilinear",
                                     align_corners=False).permute(0, 2, 3, 1)
    return out


def random_poses(gen: torch.Generator, n: int, device):
    """Camera poses of the CUB photos' kind: scale in [0.55, 0.8],
    translation (x, y) in [-0.1, 0.1] with z = 0, rotation a unit
    quaternion near a side view (a yaw and a tilt)."""
    u = torch.rand((n, 5), generator=gen, device=device)
    scale = 0.55 + 0.25 * u[:, 0]
    translation = torch.stack([0.2 * u[:, 1] - 0.1, 0.2 * u[:, 2] - 0.1,
                               torch.zeros_like(u[:, 0])], dim=1)
    yaw = (2 * u[:, 3] - 1) * math.pi
    tilt = (u[:, 4] - 0.5) * 0.6
    cy, sy, ct, st = (torch.cos(yaw / 2), torch.sin(yaw / 2),
                      torch.cos(tilt / 2), torch.sin(tilt / 2))
    rotation = torch.stack([cy * ct, cy * st, sy * ct, -sy * st], dim=1)
    return scale, translation, rotation


# --- window statistics -------------------------------------------------------

def p95(values) -> float:
    """Nearest-rank 95th percentile of all values."""
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


def union_seconds(intervals, lo: float, hi: float) -> float:
    """Length of the union of (start, end) intervals clipped to [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


# --- the numbers that decide ``correct`` -------------------------------------

def rel_gap(got: float, want: float, scale: float) -> float:
    """|got − want| over max(|want|, scale)."""
    return abs(got - want) / max(abs(want), scale)


def worst_leaf_gap(got: dict, want: dict, keep=None,
                   detail: list | None = None) -> tuple[float, str]:
    """The worst leaf's |‖got‖ − ‖want‖| over max(‖want‖, the median
    leaf's ‖want‖), over the leaves in ``keep`` (all by default); the
    value and the leaf's name.  ``detail`` gets the three worst leaves'
    (name, gap, ‖got‖, ‖want‖)."""
    names = [k for k in want if keep is None or k in keep]
    norms = {k: float(want[k].detach().double().norm()) for k in names}
    med = statistics.median(norms.values())
    rows = []
    for k in names:
        g = float(got[k].detach().double().norm()) if k in got else 0.0
        gap = abs(g - norms[k]) / max(norms[k], med)
        rows.append((gap if math.isfinite(gap) else math.inf, k, g, norms[k]))
    rows.sort(key=lambda r: -r[0])
    if detail is not None:
        detail.extend([k, gap, g, w] for gap, k, g, w in rows[:3])
    return rows[0][0], rows[0][1]


def worst_row_gap(got: dict, want: dict,
                  detail: list | None = None) -> tuple[float, str]:
    """For tables of per-item parameters (one row an item, as
    ``DatasetParams``): each row as a leaf of its own.  The worst row's
    |‖got row‖ − ‖want row‖| over max(‖want row‖, the median of the rows
    ``want`` moves), over the rows either side moves; the value and
    ``<leaf>[<row>]``.  ``detail`` gets the three worst rows' (name, gap,
    ‖got‖, ‖want‖)."""
    rows = []
    for k, w in want.items():
        w = w.detach().double().reshape(len(w), -1).norm(dim=1)
        g = got[k].detach().double().reshape(len(w), -1).norm(dim=1)
        moved = (w > 0) | (g > 0)
        if not bool(moved.any()):
            continue
        med = float(w[w > 0].median()) if bool((w > 0).any()) else 1.0
        gap = (g - w).abs() / w.clamp(min=med)
        for r in torch.nonzero(moved).flatten().tolist():
            rows.append((float(gap[r]), f"{k}[{r}]", float(g[r]),
                         float(w[r])))
    if not rows:
        return math.inf, ""
    rows.sort(key=lambda r: -r[0])
    if detail is not None:
        detail.extend([k, gap, g, w] for gap, k, g, w in rows[:3])
    return rows[0][0], rows[0][1]


def first_moment(opt, module, prefix: str = "",
                 scale: float = 1.0) -> dict:
    """Adam's first moment of each of ``module``'s parameters that has
    one, over ``scale`` (1 − beta1: the gradient after one step)."""
    return {prefix + k: opt.state[p]["exp_avg"].detach().clone() / scale
            for k, p in module.named_parameters() if p in opt.state}


def moving_leaves(grads: dict, share: float = 1e-3) -> set:
    """Leaves whose reference gradient norm is at least ``share`` of the
    median leaf's: the others move under Adam by round-off alone."""
    norms = {k: float(v.detach().double().norm()) for k, v in grads.items()}
    med = statistics.median(norms.values())
    return {k for k, n in norms.items() if n >= share * med}


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    """‖got − want‖ / ‖want‖ in float64."""
    g, w = got.detach().double(), want.detach().double()
    return float((g - w).norm() / w.norm().clamp(min=1e-30))


def judge(numbers: dict, limits: dict) -> tuple[bool, list]:
    """Every number against its limit: (all within, [[name, number,
    limit], ...]).  A number that is not finite fails."""
    rows = [[k, float(numbers[k]), float(limits[k])] for k in limits]
    ok = all(math.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
