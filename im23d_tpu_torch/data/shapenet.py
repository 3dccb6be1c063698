"""ShapeNet multi-view render dataset, host-side numpy (a copy of
``im23d_tpu/data/shapenet.py``).

Reads the reference's on-disk layout: a split file ``<synset>.{train,valid}``
listing model dirs, each holding ``render*.png`` (RGBA; alpha is the mask)
and ``camera*.mat`` (Blender camera position -> quaternion).  PIL and
``scipy.io`` are imported where an image or a camera file is read, never at
module import.  Batches are uint8 numpy dicts; the learner makes tensors of
them.  ``DataBunch`` also takes an in-memory ``(train, valid)`` pair of
datasets with ``ShapeNetRenders``' item contract in place of a root
(``data/fabricate.py:ShapeNetRenderSet``), through the same batching code.

Ground truth for Chamfer / 3D IoU comes from each model dir: a points file
or an OBJ mesh, surface-sampled on the host (``load_gt_points``);
``gt_cloud_pairs`` walks model dirs into (first render, GT cloud) pairs for
the eval CLI.
"""

from __future__ import annotations

import os
import queue as queue_mod
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterator, Sequence

import numpy as np

from im23d_tpu_torch.core.profiler import span
from im23d_tpu_torch.ops.quaternion import blender_camera_to_quaternion

SYNSET_IDS = {
    "chairs": "03001627",
    "planes": "02691156",
    "cars": "02958343",
}


def get_model_dirs(root: str, synset_id: str, split: str) -> list[Path]:
    """Model directories listed in ``<root>/<synset>.<split>``."""
    root = Path(root)
    if split not in ("train", "valid"):
        raise ValueError(f"split must be train or valid, not {split!r}")
    data = root / synset_id
    with open(root / f"{synset_id}.{split}") as fh:
        return [data / line.strip() for line in fh if line.strip()]


def _load_image_rgba(path: Path, image_size: int) -> np.ndarray:
    """(H, W, 4) uint8, bilinearly resized to ``image_size`` where it is
    not that size already; the learner divides by 255 on the device."""
    from PIL import Image

    img = Image.open(path)
    if img.size != (image_size, image_size):
        img = img.resize((image_size, image_size), Image.BILINEAR)
    return np.asarray(img, dtype=np.uint8)


class ShapeNetRenders:
    """Per-model multi-view sample: images (V, H, W, 3) uint8, poses, masks
    (V, H, W) uint8.  ``use_camera=False`` returns the view images as the
    pose input (the unsupervised pipeline predicts poses from views).

    Decoded models stay in a RAM cache (~325 KB a model at 128², uint8):
    a chairs run visits each model hundreds of times.  ``cache_in_ram=False``
    decodes every visit from disk."""

    def __init__(self, model_dirs: Sequence[Path], use_camera: bool = True,
                 image_size: int = 128, cache_in_ram: bool = True):
        self.model_dirs = list(model_dirs)
        self.use_camera = use_camera
        self.image_size = image_size
        self._cache: dict | None = {} if cache_in_ram else None

    def __len__(self) -> int:
        return len(self.model_dirs)

    def num_views(self, idx: int) -> int:
        """The model's render count, without decoding them."""
        hit = self._cache.get(idx) if self._cache is not None else None
        if hit is not None:
            return len(hit[0])
        return sum(name.startswith("render")
                   for name in os.listdir(self.model_dirs[idx]))

    def __getitem__(self, idx: int):
        if self._cache is not None:
            hit = self._cache.get(idx)
            if hit is not None:
                return hit
        model = self.model_dirs[idx]
        images, masks, cameras = [], [], []
        for name in sorted(os.listdir(model)):
            if name.startswith("render"):
                o = _load_image_rgba(model / name, self.image_size)
                images.append(o[..., :3])
                masks.append(o[..., 3])
            elif name.startswith("camera"):
                from scipy.io import loadmat

                cam = loadmat(model / name)
                cameras.append(blender_camera_to_quaternion(cam["pos"]))
        images = np.stack(images)
        masks = np.stack(masks)
        poses = np.stack(cameras) if self.use_camera else images
        out = (images, poses, masks)
        if self._cache is not None:
            self._cache[idx] = out  # one dict store: atomic under the GIL
        return out


def multi_view_collate(samples, rng: np.random.RandomState | None = None,
                       views=None) -> dict:
    """One random view image per model and all V poses / masks
    concatenated: images (B, H, W, 3), pose_input (B·V, ...), masks
    (B·V, H, W).  One ``rng.randint`` per model, in order, or the given
    ``views``."""
    images, pose_input, masks = [], [], []
    for i, (imgs, poses, msks) in enumerate(samples):
        v = rng.randint(imgs.shape[0]) if views is None else views[i]
        images.append(imgs[v])
        pose_input.append(poses)
        masks.append(msks)
    return dict(
        images=np.stack(images),
        pose_input=np.concatenate(pose_input, axis=0),
        masks=np.concatenate(masks, axis=0),
    )


# -- ground-truth point clouds (Chamfer / 3D IoU eval) -----------------------

GT_POINT_FILES = ("points.npy", "gt_points.npy", "pcl.npy", "points.npz")
GT_MESH_FILES = (
    "model.obj",
    "model_normalized.obj",
    os.path.join("models", "model_normalized.obj"),
)


def sample_mesh_points(vertices: np.ndarray, faces: np.ndarray, n_points: int,
                       rng: np.random.RandomState) -> np.ndarray:
    """Uniform surface sampling: triangles drawn by area, then uniform
    barycentric coordinates."""
    v0 = vertices[faces[:, 0]]
    v1 = vertices[faces[:, 1]]
    v2 = vertices[faces[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1)
    total = areas.sum()
    if not np.isfinite(total) or total <= 0:
        probs = np.full(len(areas), 1.0 / len(areas))
    else:
        probs = areas / total
    tri = rng.choice(len(faces), size=n_points, p=probs)
    r1 = np.sqrt(rng.rand(n_points, 1))
    r2 = rng.rand(n_points, 1)
    return ((1 - r1) * v0[tri] + r1 * (1 - r2) * v1[tri]
            + r1 * r2 * v2[tri]).astype(np.float32)


def normalize_cloud(points: np.ndarray) -> np.ndarray:
    """The eval frame: zero mean, max radius 0.5 (the decoder's tanh / 2
    range), so predicted and GT clouds compare directly."""
    points = np.asarray(points, np.float32)
    center = points.mean(axis=-2, keepdims=True)
    points = points - center
    radius = np.max(np.linalg.norm(points, axis=-1), axis=-1, keepdims=True)
    return points / np.maximum(radius[..., None], 1e-8) * 0.5


def resample_cloud(pts: np.ndarray, n_points: int,
                   rng: np.random.RandomState) -> np.ndarray:
    """Exactly ``n_points`` points (drawn with replacement only when there
    are fewer), normalized by :func:`normalize_cloud`."""
    if len(pts) != n_points:
        idx = rng.choice(len(pts), n_points, replace=len(pts) < n_points)
        pts = pts[idx]
    return normalize_cloud(pts)


def load_gt_points(model_dir, n_points: int = 2048,
                   rng: np.random.RandomState | None = None):
    """GT cloud (n_points, 3) for a model dir, or None when it has neither
    a points file nor a mesh."""
    from im23d_tpu_torch.geometry.objio import load_obj

    model_dir = Path(model_dir)
    rng = rng if rng is not None else np.random.RandomState(0)
    pts = None
    for name in GT_POINT_FILES:
        path = model_dir / name
        if path.exists():
            raw = np.load(path)
            if hasattr(raw, "files"):  # npz
                raw = raw[raw.files[0]]
            pts = np.asarray(raw, np.float32).reshape(-1, 3)
            break
    if pts is None:
        for name in GT_MESH_FILES:
            path = model_dir / name
            if path.exists():
                mesh = load_obj(str(path))
                pts = sample_mesh_points(
                    np.asarray(mesh.vertices, np.float32),
                    np.asarray(mesh.faces), n_points, rng,
                )
                break
    if pts is None:
        return None
    return resample_cloud(pts, n_points, rng)


def gt_cloud_pairs(model_dirs, n_points: int, image_size: int
                   ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """(first render (H, W, 3) uint8, GT cloud) for each model dir with
    both.  One ``RandomState(0)`` serves every dir in order, and a dir's GT
    is read before its renders are looked for, so a dir without renders
    still draws from it."""
    rng = np.random.RandomState(0)
    for model in model_dirs:
        gt = load_gt_points(model, n_points, rng)
        if gt is None:
            continue
        renders = sorted(name for name in os.listdir(model)
                         if name.startswith("render"))
        if not renders:
            continue
        img = _load_image_rgba(Path(model) / renders[0], image_size)
        yield img[..., :3], gt


class _PrefetchIterator:
    """Batches built on one background thread, ``num_prefetch`` ahead.  A
    failure on that thread is raised by the ``next`` that reaches it; the
    consumer's wait is the span ``im23d.feed.wait``."""

    def __init__(self, make_batch, num_prefetch: int = 4):
        self._queue: queue_mod.Queue = queue_mod.Queue(maxsize=num_prefetch)
        self._make_batch = make_batch
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while not self._stop.is_set():
            try:
                batch = self._make_batch()
            except Exception as exc:  # handed to the consumer
                self._queue.put(exc)
                return
            self._queue.put(batch)

    def __iter__(self):
        return self

    def __next__(self):
        with span("feed.wait"):
            batch = self._queue.get()
        if isinstance(batch, Exception):
            raise batch
        return batch

    def close(self):
        """Stop the producer (it ends after the batch it is building)."""
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue_mod.Empty:
            pass


class DataBunch:
    """Train / valid datasets, an infinite shuffled train iterator (drop
    last) and the valid split in order at twice the batch size.

    ``root`` is a ShapeNet tree, or a ``(train, valid)`` pair of datasets
    with ``ShapeNetRenders``' item contract (then ``category``,
    ``image_size``, ``use_camera`` and ``cache_in_ram`` are the datasets'
    own business).  The train generator ``RandomState(seed)`` is consumed
    on the one producer thread: ``choice`` of the batch's models, then one
    ``randint`` a model for its view.

    With ``world`` > 1 the batches are rank ``rank``'s rows of global
    batches of ``world`` times the size, drawn from the same generators
    (the view of every global row is drawn), and only its models are
    read."""

    def __init__(self, root, category: str = "chairs", batch_size: int = 10,
                 image_size: int = 128, use_camera: bool = True, seed: int = 0,
                 cache_in_ram: bool = True, num_workers: int = 8,
                 rank: int = 0, world: int = 1):
        self.batch_size = batch_size
        self.rank, self.world = rank, world
        if isinstance(root, (str, os.PathLike)):
            synset = SYNSET_IDS[category]
            self.train_ds, self.valid_ds = (
                ShapeNetRenders(get_model_dirs(root, synset, split),
                                use_camera, image_size,
                                cache_in_ram=cache_in_ram)
                for split in ("train", "valid"))
        else:
            self.train_ds, self.valid_ds = root
        self._rng = np.random.RandomState(seed)
        # PNG decode releases the GIL inside zlib: items are fetched on a
        # pool, so cold-cache batches stay off the learner's critical path
        self._pool = ThreadPoolExecutor(max_workers=num_workers)

    def _collate(self, ds, idx, rng: np.random.RandomState) -> dict:
        """This rank's rows of the global batch of models ``idx``."""
        views = [rng.randint(_num_views(ds, int(i))) for i in idx]
        n = len(idx) // self.world
        own = slice(self.rank * n, (self.rank + 1) * n)
        items = list(self._pool.map(ds.__getitem__, idx[own]))
        return multi_view_collate(items, views=views[own])

    def _train_batch(self) -> dict:
        idx = self._rng.choice(len(self.train_ds),
                               self.batch_size * self.world, replace=False)
        return self._collate(self.train_ds, idx, self._rng)

    def train_iter(self, num_prefetch: int = 4) -> _PrefetchIterator:
        return _PrefetchIterator(self._train_batch, num_prefetch)

    def valid_batches(self) -> Iterator[dict]:
        bs = self.batch_size * 2 * self.world
        rng = np.random.RandomState(0)
        for start in range(0, len(self.valid_ds) - bs + 1, bs):
            yield self._collate(self.valid_ds, np.arange(start, start + bs),
                                rng)


def _num_views(ds, idx: int) -> int:
    count = getattr(ds, "num_views", None)
    return count(idx) if count is not None else len(ds[idx][0])
