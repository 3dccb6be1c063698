#!/usr/bin/env python3
"""Whether ``chip_smoke.py`` phase 37's limits catch the faults they are
for, on one GPU.

The GAN group and the recon step of phase 37 (``chip_smoke._mr_gan``,
``_mr_recon``) run on 2 gloo ranks sharing the card with a fault put into
the ranks in memory, and each is held against the one-process stage by
phase 37's own check (``_mr_check``):

  - local moments: ``parallel.mesh.batch_norm_group`` does nothing, so
    train-mode batch norm takes each rank's moments (16 or 25 rows, not
    the global 32 or 50), and the GAN's K9 fold gets a rank's affine;
  - unaveraged gradients: ``all_reduce_grads`` does nothing, so each rank
    steps on its own half batch's gradients.

Prints each reading (losses as max relative difference, gradients as
relative L2 per network, batch-norm running statistics as max |diff|)
beside phase 37's limit and whether the check fails, as it must; exits 1
if a fault passes.

    python3 tools/multi_rank_faults.py     (from the repository root)
"""

from __future__ import annotations

import contextlib
import os
import sys
from unittest import mock

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from im23d_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from im23d_tpu_torch.parallel.launch import launch  # noqa: E402

FAULTS = dict(
    local_moments=("batch_norm_group", lambda group: contextlib.nullcontext()),
    unaveraged_gradients=("all_reduce_grads", lambda params, group: None))
CASES = (("local_moments", "gan"), ("unaveraged_gradients", "gan"),
         ("local_moments", "recon"))


def _faulty_rank(rank: int, world: int, device, fault: str,
                 stage: str) -> dict:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = pmesh.make_2d_mesh(1)
    with mock.patch.object(pmesh, *FAULTS[fault]):
        return getattr(cs, f"_mr_{stage}")(mesh, device)


def main() -> int:
    if not torch.cuda.is_available():
        print("multi_rank_faults: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[gpu] {cs._gpu_line()}")
    cs.phase_build()
    refs, passed = {}, []
    for fault, stage in CASES:
        if stage not in refs:
            refs[stage] = getattr(cs, f"_mr_{stage}")(None, cs.DEVICE)
        ref, lim = refs[stage], cs.MR_LIMITS[stage]
        ranks = launch(_faulty_rank, cs.MR_WORLD, cs.DEVICE, fault, stage)
        got = ranks[0]
        loss = max(abs(g[k] - r[k]) / abs(r[k])
                   for g, r in zip(got["losses"], ref["losses"]) for k in r
                   if r[k])
        rl2 = {n: cs._net_rl2(got["grads"][n], g)
               for n, g in ref["grads"].items()}
        stats = max(float((got["stats"][k] - v).abs().max())
                    for k, v in ref["stats"].items())
        try:
            cs._mr_check(f"{stage} with {fault}", stage, ranks, ref)
            verdict = "PASSES phase 37's check: not caught"
            passed.append((fault, stage))
        except AssertionError as e:
            verdict = f"caught ({str(e)[:80]}...)"
        print(f"[fault] {fault} in the {stage} stage: losses {loss:.3e} "
              f"(limit {lim['loss_rtol']}), gradients "
              + ", ".join(f"{n} {v:.3e}" for n, v in rl2.items())
              + f" (limit {lim['grad_rl2']}), statistics {stats:.3e} (limit "
              f"{lim['stats_atol']}): {verdict}", flush=True)
    print(cs._gpu_line())
    return 1 if passed else 0


if __name__ == "__main__":
    sys.exit(main())
