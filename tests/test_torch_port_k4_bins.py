"""K4 forward's binning, held on the CPU: the plain twin of its rule.

The kernel (``csrc/rasterize.cu``) visits a pixel-face pair only where the
face is in the bin of the pixel's 16 x 16 tile and the face's box, widened
by ``soft_margin(sigma)``, holds the pixel centre.  ``bin_faces_torch`` is
the bins' rule in the kernel's float32 comparisons and
``rasterize_binned_torch`` the plain rasterizer restricted to those pairs.
Where the binning drops nothing that changes a value, the restricted
rasterizer equals ``rasterize_torch`` bit for bit: that is the claim these
tests hold, on scenes with faces across tile edges, boxes clipped by the
image, both windings with and without culling, face counts that are not a
multiple of 32, the sphere's depth ties, and sigma from 1e-4 to 1e-2.
"""

import numpy as np
import pytest
import torch

from im23d_tpu_torch.geometry.mesh_template import MeshTemplate
from im23d_tpu_torch.render.rasterizer import (
    BIN_TILE,
    _face_boxes,
    _front,
    _pixel_grid,
    bin_faces_torch,
    rasterize_binned_torch,
    rasterize_torch,
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The suite runs this file beside five other workers on a shared
    machine: with one intra-op thread, torch's many small chunk ops never
    wait on a descheduled thread (with the default eight the file took
    427 s there against 5 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(seed: int, B: int, F: int, spread: float, size: float):
    """B images of F independent triangles (3 vertices each) of about
    ``size`` NDC, centred anywhere in [-spread, spread]^2 (past the image
    where spread > 1), both windings, z in [-1, 1], 3 attributes."""
    rng = np.random.RandomState(seed)
    centre = rng.uniform(-spread, spread, (B, F, 1, 2))
    corner = centre + rng.uniform(-size, size, (B, F, 3, 2))
    z = rng.uniform(-1.0, 1.0, (B, F, 3, 1))
    verts = np.concatenate([corner, z], -1).reshape(B, 3 * F, 3)
    attrs = rng.randn(B, F, 3, 3)
    faces = np.arange(3 * F).reshape(F, 3)
    return (torch.from_numpy(verts.astype(np.float32)),
            torch.from_numpy(faces),
            torch.from_numpy(attrs.astype(np.float32)))


def _assert_same(verts, faces, attrs, h, w, sigma, cull):
    ref = rasterize_torch(verts, faces, attrs, h, w, sigma, cull)
    got = rasterize_binned_torch(verts, faces, attrs, h, w, sigma, cull)
    for name, g, r in zip(("feat", "soft"), got, ref):
        assert torch.equal(g, r), (name, float((g - r).abs().max()))
    return ref


@pytest.mark.parametrize("cull", [True, False])
@pytest.mark.parametrize("sigma", [1e-4, 1e-3, 1e-2])
@pytest.mark.parametrize("h,w,F", [(40, 36, 70), (17, 50, 32),
                                   (32, 32, 96)])
def test_binned_walk_equals_plain(h, w, F, sigma, cull):
    """Faces scattered past the image's edges (boxes clipped by it) and
    across its tiles, odd sizes that cut the last tiles."""
    verts, faces, attrs = _scene(F + h, 2, F, 1.2, 0.3)
    feat, soft = _assert_same(verts, faces, attrs, h, w, sigma, cull)
    assert float(soft.max()) > 0.5 and bool((feat != 0).any())


@pytest.mark.parametrize("cull", [True, False])
def test_binned_walk_equals_plain_sphere_ties(cull):
    """A closed sphere of 960 faces: depth ties on shared edges within and
    across chunks of 32, the case the chunk rule exists for."""
    tpl = MeshTemplate(segments=32, rings=16)
    v = tpl.tensor("vertices", "cpu")[None] * 0.7
    v = torch.cat([v, v * v.new_tensor([1.0, -1.0, -1.0])])
    faces = tpl.tensor("faces", "cpu")
    attrs = torch.rand((2, faces.shape[0], 3, 3),
                       generator=torch.Generator().manual_seed(0))
    _assert_same(v, faces, attrs, 48, 48, 1e-4, cull)


@pytest.mark.parametrize("sigma", [1e-4, 1e-2])
def test_bins_hold_every_pixel_box(sigma):
    """Every drawn face whose widened box holds a pixel centre is in the
    bin of that pixel's tile (the kernel's per-pixel test then finds it)."""
    h, w = 37, 45
    verts, faces, _ = _scene(5, 2, 50, 1.1, 0.25)
    fv = verts[:, faces]
    bins = bin_faces_torch(fv, h, w, sigma)
    tiles_x = -(-w // BIN_TILE)
    assert bins.shape == (2, -(-h // BIN_TILE) * tiles_x, 50)
    px, py = _pixel_grid(h, w, torch.float32, "cpu")
    minx, maxx, miny, maxy = (t[:, :, None, None]
                              for t in _face_boxes(fv, sigma))
    inbox = (minx <= px) & (px <= maxx) & (miny <= py) & (py <= maxy)
    inbox &= _front(fv, True)[:, :, None, None]
    rows = torch.arange(h) // BIN_TILE
    cols = torch.arange(w) // BIN_TILE
    tile = rows[:, None] * tiles_x + cols[None, :]
    in_bin = bins[:, tile].permute(0, 3, 1, 2)  # (B, F, H, W)
    assert bool(inbox.any())
    assert not bool((inbox & ~in_bin).any())
    # per tile: a bin holds every face whose box holds one of the tile's
    # pixels, and more only where a partial tile's span of pixel centres
    # runs past the image
    per_tile = torch.zeros_like(bins)
    for t in range(bins.shape[1]):
        sel = tile == t
        per_tile[:, t] = inbox[:, :, sel].any(-1)
    assert bool((bins >= per_tile).all())
    inner = [t for t in range(bins.shape[1])
             if (t % tiles_x + 1) * BIN_TILE <= w
             and (t // tiles_x + 1) * BIN_TILE <= h]
    assert torch.equal(bins[:, inner], per_tile[:, inner])


def test_bins_of_back_faces_and_empty_scenes():
    """Culled back faces are in no bin; with no faces the bins are empty
    and the binned rasterizer draws background."""
    verts, faces, attrs = _scene(9, 1, 40, 0.8, 0.3)
    fv = verts[:, faces]
    bins = bin_faces_torch(fv, 32, 32, 1e-4, cull_backfaces=True)
    back = ~_front(fv, True)
    assert bool(back.any()) and not bool(bins[:, :, back[0]].any())
    feat, soft = rasterize_binned_torch(verts, faces[:0], attrs[:, :0], 16,
                                        20)
    assert not feat.any() and not soft.any()
