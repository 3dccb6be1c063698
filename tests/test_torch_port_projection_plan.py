"""K1's and K2's host-side cluster plan (``ops/projection.py:projection_plan``)
on the CPU.

The projection kernels (``csrc/projection.cu``) hold each cloud's S³ grid
in the distributed shared memory of one thread-block cluster and take
their layout from this plan, refusing one they cannot run; so the plan's
choices and limits are held here, where there is no card: the main path
(S = 64, K = 21) takes a cluster of 8 CTAs of 8 planes each on the
specialised instance, its splat in 2 passes of 4 planes; every (S, K)
with 1 <= S, K <= 64 gets a plan that fits an H100's shared memory a
block and the portable cluster size, with no idle CTA; what the kernels
cannot take raises.  The plan reads its
limits from the kernel library (``projection_limits``); here they are an
H100 SXM's (232,448 bytes of shared memory a block) and the kernels'
constants, which ``test_projection_limits_are_the_plans``
in ``tests/test_torch_port_kernels.py`` holds against the library on a
card.
"""

import pytest

from im23d_tpu_torch.ops.projection import (
    ProjectionLimits,
    _scratch_offset,
    projection_plan,
)

H100 = ProjectionLimits(smem_optin=232448, max_cluster=8, max_s=64,
                        max_k=64, planes=8, extra=416, max_points=1 << 20)


def _layout_ok(S, P, Q) -> int:
    """Walk the splat's passes over a CTA's shared memory: the 64-bit
    scratch (Q planes of S² cells) must miss every float plane (S rows of
    an odd stride) that an earlier pass wrote, and float plane q0 + j,
    written once scratch plane j is read, must miss the scratch planes
    not read yet.  Returns the bytes of planes and scratch together."""
    fp, ip = S * (S | 1) * 4, S * S * 8
    off = _scratch_offset(S, P, Q)
    assert off % 8 == 0
    for q0 in range(0, P, Q):
        for p in range(q0):
            assert (p + 1) * fp <= off
        for j in range(min(Q, P - q0)):
            assert (q0 + j + 1) * fp <= off + (j + 1) * ip
    return max(-(-(P * fp) // 8) * 8, off + Q * ip)


def test_main_path_takes_the_eight_cta_cluster():
    """S = 64, K = 21: 8 CTAs of 8 z-planes (8 x 64 x 65 floats, 133,120
    bytes), the splat's 64-bit scratch for 4 planes (131,072 bytes: 2
    passes) from byte 66,560 on, over the float planes of the second pass,
    the backward's mask (a 64-bit word a column, 4 KiB) on top; the kernel
    library compiles this (S, K, planes) in.  One CTA a multiprocessor."""
    plan = projection_plan(64, 21, H100)
    assert (plan["cluster"], plan["planes"], plan["stride"]) == (8, 8, 65)
    assert plan["stage"] == 4
    assert _scratch_offset(64, 8, 4) == 4 * 64 * 65 * 4
    assert plan["smem_fwd"] == 66560 + 4 * 64 * 64 * 8 + H100.extra
    assert plan["smem_bwd"] == plan["smem_fwd"] + 8 * 64 * 8
    assert 2 * plan["smem_bwd"] > H100.smem_optin


@pytest.mark.parametrize("S,K,want", [
    (32, 21, (4, 8, 8)),   # the planes and cars configs: one splat pass
    (16, 9, (2, 8, 8)),
    (20, 7, (3, 7, 7)),    # 7 + 7 + 6 planes
    (20, 8, (3, 7, 7)),
    (9, 64, (2, 5, 5)),
    (8, 3, (1, 8, 8)),
    (1, 1, (1, 1, 1)),
    (60, 21, (8, 8, 5)),   # two splat passes
])
def test_other_shapes(S, K, want):
    plan = projection_plan(S, K, H100)
    assert (plan["cluster"], plan["planes"], plan["stage"]) == want


@pytest.mark.parametrize("S", range(1, 65))
def test_every_plan_keeps_within_the_kernel(S):
    """For every K: the cluster covers the S planes with no idle CTA, no
    CTA owns more than ``planes``, the rows are an odd stride, the splat's
    passes keep the scratch off every plane still in use, they are the
    fewest that fit, and both kernels' shared memory fits the card."""
    for K in range(1, 65):
        plan = projection_plan(S, K, H100)
        C, P, Q = plan["cluster"], plan["planes"], plan["stage"]
        assert 1 <= C <= H100.max_cluster and 1 <= P <= min(S, H100.planes)
        assert C * P >= S and (C - 1) * P < S
        assert 1 <= Q <= P
        assert plan["stride"] % 2 == 1 and S <= plan["stride"] <= S + 1
        assert plan["smem_fwd"] == _layout_ok(S, P, Q) + H100.extra
        assert plan["smem_bwd"] == plan["smem_fwd"] + P * S * 8
        assert plan["smem_bwd"] <= H100.smem_optin
        for more in range(Q + 1, P + 1):  # a larger stage does not fit
            assert (_layout_ok(S, P, more) + H100.extra + P * S * 8
                    > H100.smem_optin)


@pytest.mark.parametrize("S,K,lim", [
    (0, 21, H100), (65, 21, H100), (64, 0, H100), (64, 65, H100),
    # a card with less shared memory a block than the main plan's
    (64, 21, H100._replace(smem_optin=100_000)),
    # a library whose clusters hold fewer CTAs than S = 64 needs
    (64, 21, H100._replace(max_cluster=4)),
])
def test_plans_the_kernels_cannot_take_raise(S, K, lim):
    with pytest.raises(ValueError):
        projection_plan(S, K, lim)
