"""K4 forward, the rasterizer, at the renderer's entry ``rasterize``:
reads the vertices, faces and face-corner attributes, writes the
interpolated attributes and the soft silhouette; 59 float32 operations
per pixel and nearby face (``bounds.raster_pairs``)."""

from portbench.lib.bounds import PEAK_F32, nbytes, raster_pairs

ENTRY = "im23d_tpu_torch.render.renderer:rasterize"
COUNTER = "im23d_tpu_torch.render.rasterizer:rasterize_kernel"
OPS_PER_PAIR = 59


def bound(args, out):
    verts, faces, attrs, height, width, sigma = args[:6]
    cull = args[6] if len(args) > 6 else True
    pairs = raster_pairs(verts[:, faces.long()], height, width, sigma, cull)
    return nbytes(verts, faces, attrs, *out), OPS_PER_PAIR * pairs, PEAK_F32
