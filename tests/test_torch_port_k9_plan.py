"""K9's host-side tile plan (``ops/conv.py:fused_conv_plan``) on the CPU.

The persistent bf16 kernel (``csrc/fused_conv.cu``) takes its tiling from
this plan and refuses one it cannot run, so the plan's choices and limits
are held here, where there is no card: the main path's shapes (the 8
conv2s of the CLI's 512 generator at bs 32) take the TMA path with
512-pixel tiles, weights resident at 64 input channels and streamed at
128 and more; small layers get about one tile a multiprocessor; every plan
over a sweep of shapes keeps within the kernel's limits.  The plan reads
its limits from the kernel library (``k9_limits``); here they are an H100
SXM's (132 multiprocessors, 232,448 bytes of shared memory a block) and
the kernel's constants, which ``test_k9_limits_are_the_plans`` in
``tests/test_torch_port_kernels.py`` holds against the library on a card.
"""

import itertools

import pytest

from im23d_tpu_torch.ops.conv import K9Limits, fused_conv_plan

H100 = K9Limits(sms=132, smem_optin=232448, bm=512, bn=64, ck=32,
                max_tw=32, max_patch=640, wstage=9 * 64 * 64, tables=2048)
SMS, OPTIN = H100.sms, H100.smem_optin

# (Cin, H, W, Cout) of the generator's conv2s, blk1 ... blk6, blk3_mesh,
# and the plan each takes: (ti, th, tw, vec, resident)
MAIN_PATH = [
    ((512, 8, 4, 512), (2, 8, 4, False, False)),
    ((256, 16, 8, 256), (1, 16, 8, True, False)),
    ((256, 32, 16, 256), (1, 32, 16, True, False)),
    ((256, 64, 32, 256), (1, 16, 32, True, False)),
    ((128, 128, 64, 128), (1, 16, 32, True, False)),
    ((128, 256, 128, 128), (1, 16, 32, True, False)),
    ((64, 512, 256, 64), (1, 16, 32, True, True)),
    ((64, 32, 16, 64), (1, 8, 16, True, True)),
]


@pytest.mark.parametrize("shape,want", MAIN_PATH)
def test_main_path_plans(shape, want):
    cin, H, W, cout = shape
    plan = fused_conv_plan(32, cin, cout, H, W, True, H100)
    assert (plan["ti"], plan["th"], plan["tw"], plan["vec"],
            plan["resident"]) == want
    assert plan["smem"] <= OPTIN


def test_big_stages_take_the_compiled_tiling_and_odd_boxes():
    """blk3b ... blk6 run 16 x 32 tiles (the kernel instance with its
    geometry compiled in) from boxes of 19 rows x 56 columns: 133 16-byte
    units a channel, odd, so ldmatrix.trans reads no bank twice."""
    for cin, H, W, cout in (s for s, _ in MAIN_PATH[3:7]):
        plan = fused_conv_plan(32, cin, cout, H, W, True, H100)
        assert (plan["th"], plan["tw"], plan["bh"], plan["bw"]) == (16, 32,
                                                                      19, 56)
        assert (plan["bh"] * plan["bw"] * 2 // 16) % 2 == 1


def test_misaligned_x_loads_by_pixel():
    plan = fused_conv_plan(32, 64, 64, 512, 256, False, H100)
    assert not plan["vec"] and plan["smem"] <= OPTIN


@pytest.mark.parametrize("B,cin,cout", [(1, 16, 16), (32, 64, 64),
                                        (32, 256, 512), (600, 16, 32)])
@pytest.mark.parametrize("H,W", [(1, 1), (8, 4), (9, 70), (16, 24),
                                 (17, 33), (512, 256), (3, 1000)])
def test_every_plan_keeps_within_the_kernel(B, cin, cout, H, W):
    """The limits ``im23d_fused_conv_fwd`` checks, and the shared memory
    the plan says it takes."""
    plan = fused_conv_plan(B, cin, cout, H, W, True, H100)
    ti, th, tw = plan["ti"], plan["th"], plan["tw"]
    assert 1 <= ti <= B and 1 <= th <= H and 1 <= tw <= min(W, H100.max_tw)
    assert ti * th * tw <= H100.bm
    assert ti == 1 or (th == H and tw == W)
    assert plan["patch"] == ti * (th + 2) * (tw + 2) <= H100.max_patch
    if plan["vec"]:
        assert W % 8 == 0 and tw % 8 == 0 and ti == 1
        assert plan["bw"] >= tw + 16 and plan["bw"] % 8 == 0
        assert plan["bh"] >= th + 2 and max(plan["bw"], plan["bh"]) <= 256
    else:
        assert W % 8 or tw % 8 or ti > 1
    nks = -(-cin // H100.ck)
    weights = (nks if plan["resident"] else 2) * H100.wstage
    assert plan["smem"] <= OPTIN
    assert plan["smem"] >= weights + 2 * plan["patch"] * 64
    if not plan["resident"]:  # resident only where it does not fit
        assert plan["smem"] - 2 * H100.wstage + nks * H100.wstage > OPTIN
    tiles = -(-B // ti) * -(-H // th) * -(-W // tw) * -(-cout // 64)
    assert plan["tiles"] == tiles


@pytest.mark.parametrize("B,H,W", list(itertools.product(
    (1, 8, 32), (4, 16, 32), (4, 8, 16))))
def test_small_layers_spread_over_the_card(B, H, W):
    """A layer with fewer full tiles than multiprocessors takes shorter
    tiles (or, with whole images, packs them) so that the card gets about
    one tile a multiprocessor, never fewer than half as many as it could
    have."""
    plan = fused_conv_plan(B, 64, 64, H, W, True, H100)
    most = B * H * -(-W // plan["tw"])  # one-row tiles, one image each
    assert plan["tiles"] >= min(SMS // 2, most) or plan["th"] == 1


@pytest.mark.parametrize("W", [40, 48, 56, 1000])
def test_partial_column_tiles_take_the_box(W):
    """Widths past 32 that 32 does not divide keep the TMA box with a
    partial last column tile: the kernel writes the right W pad just past
    that tile's last column of x (``tests/test_torch_port_kernels.py``
    runs these widths on a card)."""
    plan = fused_conv_plan(2, 32, 48, 12, W, True, H100)
    assert plan["vec"] and plan["tw"] == 32 and W % plan["tw"]
    assert plan["tiles"] == 2 * -(-12 // plan["th"]) * -(-W // 32)
