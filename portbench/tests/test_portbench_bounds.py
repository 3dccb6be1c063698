"""Each kernel file's bound at the main path's shapes reproduces the
bound that the port's chip smoke counted by the same rule: K8 forward
0.168 ms and K9 at blk6's conv2 0.321 ms (both by bytes), K5 forward
0.0225 ms (bytes, every texel read).  K4's bound counts the pixel-face
pairs of its own scene, so it is checked on a scene counted by hand."""

from __future__ import annotations

import pytest
import torch

from portbench.lib.bounds import raster_pairs, seconds, texels_read
from portbench.lib.trace import kernel_spec


def _ms(spec, args, out):
    return 1e3 * seconds(*spec.bound(args, out))


def test_k8_head_bound():
    x = torch.empty(32, 64, 512, 256, dtype=torch.bfloat16, device="meta")
    w, b = torch.empty(3, 64, 5, 5), torch.empty(3)
    y = torch.empty(32, 3, 512, 256, dtype=torch.bfloat16, device="meta")
    assert _ms(kernel_spec("k8"), (x, w, b, "replicate"), y) == \
        pytest.approx(0.168, abs=5e-4)


def test_k9_blk6_bound():
    x = torch.empty(32, 64, 512, 256, dtype=torch.bfloat16, device="meta")
    a, b = torch.empty(32, 64), torch.empty(32, 64)
    w = torch.empty(64, 64, 3, 3)
    y = torch.empty(32, 64, 512, 256, dtype=torch.bfloat16, device="meta")
    assert _ms(kernel_spec("k9"), (x, a, b, w, "replicate"), y) == \
        pytest.approx(0.321, abs=5e-4)


def test_k5_forward_bound_reading_every_texel():
    img = torch.zeros(50, 128, 130, 3)
    t = torch.linspace(-1, 1, 256)
    gy, gx = torch.meshgrid(t, t, indexing="ij")
    grid = torch.stack([gx, gy], -1).expand(50, 256, 256, 2)
    assert int(texels_read(img, grid)) == 50 * 128 * 130
    out = torch.zeros(50, 256, 256, 3)
    assert _ms(kernel_spec("k5f"), (img, grid), out) == \
        pytest.approx(0.0225, abs=2e-4)


def test_k5_texels_read_counts_only_touched_corners():
    img = torch.zeros(1, 4, 4, 2)
    # every sample at texel (0, 0): its four in-range corners, whatever
    # their weights, are read once
    grid = torch.full((1, 3, 3, 2), -1.0)
    assert int(texels_read(img, grid)) == 4
    grid[0, 0, 0] = 1.0  # one sample at the far corner: one texel more
    assert int(texels_read(img, grid)) == 5
    live = torch.zeros(1, 3, 3, dtype=torch.bool)
    assert int(texels_read(img, grid, live)) == 0


def test_k4_pairs_of_one_triangle():
    # one front-facing triangle covering the pixel centres x, y in [-0.5,
    # 0.5] of a 4 x 4 raster, sigma so small that the margin adds nothing
    fv = torch.tensor([[[[-0.5, -0.5, 0.0], [0.5, -0.5, 0.0],
                         [-0.5, 0.5, 0.0]]]])
    assert int(raster_pairs(fv, 4, 4, 1e-12)) == 2 * 2
    back = fv[:, :, [0, 2, 1]]
    assert int(raster_pairs(back, 4, 4, 1e-12)) == 0
    assert int(raster_pairs(back, 4, 4, 1e-12, cull=False)) == 4
