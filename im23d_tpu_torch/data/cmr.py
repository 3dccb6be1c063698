"""CMR-style CUB / Pascal3D+ raw data loaders, host-side numpy (a copy of
``im23d_tpu/data/cmr.py``): .mat annotations, bbox pad/jitter and square
crop, multi-resolution rescale, mirror augmentation with the sfm-pose
quaternion flip, giving the (image RGBA, scale, translation, rotation,
index) items the mesh-estimation trainer consumes.  PIL (photo decode and
resize) and scipy (.mat files) are imported when they are needed.

``batch_iterator`` assembles batches on threads and, with
``process_workers``, decodes items in worker processes.
"""

from __future__ import annotations

import os.path as osp
from typing import Iterator, Sequence

import numpy as np

from im23d_tpu_torch.data.image_utils import crop, peturb_bbox, resize_img, square_bbox
from im23d_tpu_torch.data.prefetch import prefetched_batches

CUB_KP_PERM = np.array([1, 2, 3, 4, 5, 6, 11, 12, 13, 10, 7, 8, 9, 14, 15]) - 1


def quaternion_from_matrix(m: np.ndarray) -> np.ndarray:
    """Rotation matrix (>=3x3) -> wxyz quaternion (precise branch)."""
    m = np.asarray(m, dtype=np.float64)[:3, :3]
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        w = (m[2, 1] - m[1, 2]) / s
        x = 0.25 * s
        y = (m[0, 1] + m[1, 0]) / s
        z = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        w = (m[0, 2] - m[2, 0]) / s
        x = (m[0, 1] + m[1, 0]) / s
        y = 0.25 * s
        z = (m[1, 2] + m[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        w = (m[1, 0] - m[0, 1]) / s
        x = (m[0, 2] + m[2, 0]) / s
        y = (m[1, 2] + m[2, 1]) / s
        z = 0.25 * s
    return np.array([w, x, y, z], dtype=np.float64)


def quaternion_matrix(q: np.ndarray) -> np.ndarray:
    """wxyz quaternion -> 4x4 homogeneous rotation matrix."""
    w, x, y, z = np.asarray(q, dtype=np.float64)
    n = w * w + x * x + y * y + z * z
    if n < 1e-12:
        return np.eye(4)
    s = 2.0 / n
    m = np.eye(4)
    m[:3, :3] = [
        [1 - s * (y * y + z * z), s * (x * y - w * z), s * (x * z + w * y)],
        [s * (x * y + w * z), 1 - s * (x * x + z * z), s * (y * z - w * x)],
        [s * (x * z - w * y), s * (y * z + w * x), 1 - s * (x * x + y * y)],
    ]
    return m


class CMRBaseDataset:
    """bbox crop / rescale / mirror pipeline (reference ``base.py:32-210``).

    Subclasses set: img_dir, anno, anno_sfm, kp_perm, num_imgs.
    """

    def __init__(self, is_train: bool, img_size, seed: int = 0):
        self.img_sizes = img_size if isinstance(img_size, list) else [img_size]
        self.jitter_frac = 0.0
        self.padding_frac = 0.05
        self.is_train = is_train
        # forward_img runs on prefetch threads, so augmentation draws are a
        # pure function of (seed, epoch, index): thread completion order
        # cannot perturb seeded reproducibility (set_epoch advances it)
        self._seed = seed
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Advance the per-item augmentation streams (one call per epoch).

        Iterators that prefetch across epoch boundaries should instead pass
        ``epoch`` to :meth:`item` — that form has no shared mutable state.
        """
        self._epoch = int(epoch)

    def _item_rng(self, index: int, epoch: int | None = None) -> np.random.Generator:
        e = self._epoch if epoch is None else int(epoch)
        return np.random.default_rng(
            np.random.SeedSequence([self._seed, e, int(index)])
        )

    def get_paths(self) -> list[str]:
        return [
            str(d.rel_path).replace("\\", "/") for d in self.anno
        ]

    def _read_image(self, path: str) -> np.ndarray:
        """Decode to uint8 (H, W, 3).  The [0,1] float conversion happens
        AFTER crop+resize (forward_img): normalizing the full-resolution
        image first costs a float64 multiply+alloc per item that the crop
        then throws away, and resize quantizes through uint8 anyway."""
        from PIL import Image

        img = np.asarray(Image.open(path))
        if img.ndim == 2:
            img = np.repeat(img[:, :, None], 3, axis=2)
        return img[..., :3]

    def forward_img(self, index: int, epoch: int | None = None):
        data = self.anno[index]
        data_sfm = self.anno_sfm[index]
        sfm_pose = [
            np.copy(data_sfm.scale), np.copy(data_sfm.trans),
            quaternion_from_matrix(np.asarray(data_sfm.rot)),
        ]
        img_path_rel = str(data.rel_path).replace("\\", "/")
        img = self._read_image(osp.join(self.img_dir, img_path_rel))
        mask = np.expand_dims(np.asarray(data.mask), 2)

        bbox = np.array(
            [data.bbox.x1, data.bbox.y1, data.bbox.x2, data.bbox.y2], float
        ) - 1
        rng = self._item_rng(index, epoch)
        bbox = peturb_bbox(
            bbox, pf=self.padding_frac,
            jf=self.jitter_frac if self.is_train else 0.0, rng=rng,
        )
        mirrored = self.is_train and rng.integers(2) == 1
        bbox = square_bbox(bbox)

        img = crop(img, bbox, bgval=255)  # uint8 white background
        mask = crop(mask, bbox, bgval=0)
        sfm_pose[1][0] -= bbox[0]
        sfm_pose[1][1] -= bbox[1]

        outputs = []
        for res in self.img_sizes:
            pose_c = [np.copy(sfm_pose[0]), np.copy(sfm_pose[1]),
                      np.copy(sfm_pose[2])]
            img_r, mask_r, pose_r = self._scale(img, mask, pose_c, res)
            if mirrored:
                img_r, mask_r, pose_r = self._mirror(img_r, mask_r, pose_r)
            # floats only at the final (small) resolution
            outputs.append((
                img_r.astype(np.float32) / 255.0, mask_r, pose_r
            ))

        img_ref, mask_ref, pose_ref = outputs[0]
        h, w = img_ref.shape[:2]
        # normalize pose to [-1, 1] (reference normalize_kp, :132-142)
        pose_ref[0] = pose_ref[0] * (1.0 / w + 1.0 / h)
        pose_ref[1][0] = 2.0 * (pose_ref[1][0] / w) - 1
        pose_ref[1][1] = 2.0 * (pose_ref[1][1] / h) - 1
        extra = {res: (o[0], o[1]) for res, o in zip(self.img_sizes[1:], outputs[1:])}
        return img_ref, mask_ref, pose_ref, mirrored, img_path_rel, extra

    def _scale(self, img, mask, sfm_pose, img_size):
        scale = img_size / float(max(img.shape[0], img.shape[1]))
        img, _ = resize_img(img, scale)
        mask, _ = resize_img(mask, scale)
        sfm_pose[0] *= scale
        sfm_pose[1] = sfm_pose[1] * scale
        return img, mask, sfm_pose

    def _mirror(self, img, mask, sfm_pose):
        img = img[:, ::-1].copy()
        mask = mask[:, ::-1].copy()
        R = quaternion_matrix(sfm_pose[2])
        flip_R = np.diag([-1, 1, 1, 1]).dot(R.dot(np.diag([-1, 1, 1, 1])))
        sfm_pose[2] = quaternion_from_matrix(flip_R)
        sfm_pose[1][0] = img.shape[1] - sfm_pose[1][0] - 1
        return img, mask, sfm_pose

    def __len__(self) -> int:
        return self.num_imgs

    def __getitem__(self, index: int) -> dict:
        return self.item(index, None)

    def item(self, index: int, epoch: int | None) -> dict:
        """Like ``__getitem__`` but with the augmentation epoch passed
        explicitly — a pure function of (seed, epoch, index), safe for
        concurrent iterators over the same dataset object."""
        img, mask, pose, mirrored, path, extra = self.forward_img(index, epoch)
        # masked RGBA in [-1, 1] like the recon ImageDataset wrapper
        # (run_reconstruction.py:104-122)
        rgb = (img.astype(np.float32) * 2 - 1) * mask.astype(np.float32)
        rgba = np.concatenate([rgb, mask.astype(np.float32)], axis=-1)
        idx = index + (self.num_imgs if mirrored else 0)
        item = dict(
            image=rgba,  # (H, W, 4) NHWC
            scale=np.float32(pose[0]),
            translation=np.asarray([pose[1][0], pose[1][1], 0.0], np.float32),
            rotation=np.asarray(pose[2], np.float32),
            idx=np.int32(idx),
            path=path,
        )
        for res, (img2, mask2) in extra.items():
            rgb2 = (img2.astype(np.float32) * 2 - 1) * mask2.astype(np.float32)
            item[f"image_{res}"] = rgb2  # (H, W, 3), reference keeps RGB only
        return item


class CUBDataset(CMRBaseDataset):
    """CUB-200-2011 with CMR annotations (reference ``cub.py:26-57``)."""

    def __init__(self, root: str, split: str, is_train: bool, img_size, seed: int = 0):
        super().__init__(is_train, img_size, seed)
        import scipy.io as sio

        cache = osp.join(root, "cub")
        self.img_dir = osp.join(cache, "CUB_200_2011", "images")
        anno_path = osp.join(cache, "data", f"{split}_cub_cleaned.mat")
        anno_sfm_path = osp.join(cache, "sfm", f"anno_{split}.mat")
        self.anno = sio.loadmat(anno_path, struct_as_record=False, squeeze_me=True)["images"]
        self.anno_sfm = sio.loadmat(anno_sfm_path, struct_as_record=False, squeeze_me=True)["sfm_anno"]
        self.kp_perm = CUB_KP_PERM
        self.num_imgs = len(self.anno)


class P3dDataset(CMRBaseDataset):
    """Pascal3D+ cars with CMR annotations (reference ``p3d.py:26-57``)."""

    def __init__(self, root: str, split: str, is_train: bool, img_size,
                 p3d_class: str = "car", seed: int = 0):
        super().__init__(is_train, img_size, seed)
        import scipy.io as sio

        cache = osp.join(root, "p3d")
        self.img_dir = osp.join(cache, "PASCAL3D+_release1.1", "Images")
        self.anno = sio.loadmat(
            osp.join(cache, "data", f"{p3d_class}_{split}.mat"),
            struct_as_record=False, squeeze_me=True,
        )["images"]
        self.anno_sfm = sio.loadmat(
            osp.join(cache, "sfm", f"{p3d_class}_{split}.mat"),
            struct_as_record=False, squeeze_me=True,
        )["sfm_anno"]
        self.kp_perm = sio.loadmat(
            osp.join(cache, "data", f"{p3d_class}_kps.mat"),
            struct_as_record=False, squeeze_me=True,
        )["kp_perm_inds"] - 1
        self.num_imgs = len(self.anno)


_WORKER_DS = None
_PROC_POOLS: dict = {}


def _worker_init(dataset) -> None:
    global _WORKER_DS
    _WORKER_DS = dataset


def _worker_item(args):
    idx, epoch = args
    item_at = getattr(_WORKER_DS, "item", None)
    return item_at(idx, epoch) if item_at is not None else _WORKER_DS[idx]


def _dataset_proc_pool(dataset, process_workers: int):
    """The dataset's persistent pool of decode processes (started once a
    run, not once an epoch).  Its workers are spawned, not forked: by the
    first batch the trainer has initialised CUDA and torch's threads, which
    a forked child would inherit half-held.  Each worker unpickles its own
    copy of the dataset; items are a pure function of (seed, epoch, index)
    and the epoch travels with each work unit, so the copies give the
    serial path's items."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    key = (id(dataset), process_workers)
    pool = _PROC_POOLS.get(key)
    if pool is None:
        pool = ProcessPoolExecutor(
            process_workers, mp_context=mp.get_context("spawn"),
            initializer=_worker_init, initargs=(dataset,),
        )
        _PROC_POOLS[key] = pool
    return pool


def close_process_pools(dataset) -> None:
    """End the decode processes of ``dataset`` (every worker count) and
    wait for them to exit.  The pool holds the dataset, so it lives until
    this call or the interpreter's exit."""
    for key in [k for k in _PROC_POOLS if k[0] == id(dataset)]:
        _PROC_POOLS.pop(key).shutdown(wait=True, cancel_futures=True)


def batch_iterator(dataset, batch_size: int, shuffle: bool = True,
                   seed: int = 0, drop_last: bool = True,
                   keys: Sequence[str] | None = None,
                   num_workers: int = 4,
                   process_workers: int = 0, rank: int = 0,
                   world: int = 1) -> Iterator[dict]:
    """One epoch of stacked-dict batches from an indexable dataset.

    With ``world`` > 1 it yields rank ``rank``'s rows of the epoch's global
    batches of ``world * batch_size`` (the same order on every rank) and
    reads only those items; a rank without rows in the tail batch skips
    it.

    ``num_workers`` threads assemble batches ahead of the consumer; with
    ``process_workers > 0`` the items are decoded in that many worker
    processes (``_dataset_proc_pool``: PIL's decode holds the GIL, so
    threads alone cannot scale it).  The workers run only the dataset's
    numpy / PIL code, never torch."""
    rng = np.random.RandomState(seed)
    epoch = seed  # captured locally: concurrent iterators cannot clobber it
    set_epoch = getattr(dataset, "set_epoch", None)
    if set_epoch is not None:
        set_epoch(epoch)  # keep direct dataset[i] consumers in sync
    item_at = getattr(dataset, "item", None)
    order = np.arange(len(dataset))
    if shuffle:
        rng.shuffle(order)
    step = batch_size * world
    end = len(order) - (len(order) % step if drop_last else 0)
    index_batches = [
        order[start : start + step][rank * batch_size:
                                    (rank + 1) * batch_size]
        for start in range(0, end, step)
    ]
    index_batches = [idx for idx in index_batches if len(idx) > 0]
    proc_pool = (_dataset_proc_pool(dataset, process_workers)
                 if process_workers > 0 else None)

    def build(idx):
        if proc_pool is not None:
            items = list(proc_pool.map(_worker_item,
                                       [(int(i), epoch) for i in idx]))
        else:
            items = [
                item_at(int(i), epoch) if item_at is not None
                else dataset[int(i)]
                for i in idx
            ]
        batch = {}
        for k in items[0]:
            if keys is not None and k not in keys:
                continue
            vals = [it[k] for it in items]
            if isinstance(vals[0], str):
                batch[k] = vals
            else:
                batch[k] = np.stack(vals)
        return batch

    yield from prefetched_batches(index_batches, build, num_workers)
