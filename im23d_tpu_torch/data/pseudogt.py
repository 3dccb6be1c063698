"""GAN-side datasets: pseudo-ground-truth cache readers (CUB / Pascal3D+),
a numpy copy of ``im23d_tpu/data/pseudogt.py``.

Read ``<cache>/poses_metadata.npz`` and the per-index
``pseudogt_<R>x<R>/<idx>.npz`` (NCHW float16), mirror in UV space as
augmentation, carry class labels and the per-dataset suggestions.  Items
and batches are NHWC numpy arrays; the GAN trainer makes tensors of them.
The per-item npz is decoded by the native pool of ``data/fastloader.py``
(C++ threads inflate outside the GIL, as in the JAX package's host feed),
bit-equal to ``np.load``.  With ``conditional_text`` the caption cache
``<cache>/captions_tokens.npz`` (``data/captions.py``) gives each item one
of its image's captions, ``caption`` (L,) int32, drawn after the mirror
from the same (seed, epoch, idx) stream.
"""

from __future__ import annotations

import glob
import os
import threading
from typing import Iterator

import numpy as np


def suggested_num_discriminators(dataset: str,
                                 texture_resolution: int) -> int:
    """The critics a dataset's GAN takes by default (the reference's
    per-dataset suggestion): 3 for CUB at 512² and above, else 2."""
    return 3 if dataset == "cub" and texture_resolution >= 512 else 2


def mirror_tex_nhwc(tr: np.ndarray) -> np.ndarray:
    """Mirror a texture or displacement map (H, W, C) in UV space: flip
    along u, then roll by half a period."""
    tr = tr[:, ::-1]
    tr = np.concatenate([tr, tr], axis=1)
    w = tr.shape[1]
    return tr[:, w // 4: -(w // 4)]


class PseudoGTDataset:
    """Abstract pseudo-ground-truth dataset (reference ``AbstractDataset``).

    Augmentation draws are a pure function of (seed, epoch, idx), so
    threads that build items in any order give the same batches."""

    def __init__(self, cache_dir: str, texture_resolution: int = 512,
                 augment: bool = True, evaluate: bool = False,
                 conditional_class: bool = False,
                 conditional_text: bool = False, seed: int = 0):
        self.cache_dir = cache_dir
        self.texture_resolution = texture_resolution
        self.augment = augment
        self.evaluate = evaluate
        self.conditional_class = conditional_class
        self.conditional_text = conditional_text
        self._seed = seed
        self._epoch = 0
        self._npz_pool = None
        self._npz_lock = threading.Lock()
        self.caption_tokens = None
        self.n_words = 0
        if conditional_text:
            # tokens (N, E, L) int32: E captions an image, 0-padded; the
            # index -> word table, when the cache has one, names the grid
            # samples' captions in the log
            with np.load(os.path.join(cache_dir, "captions_tokens.npz")) as cap:
                self.caption_tokens = cap["tokens"].astype(np.int32)
                self.n_words = int(cap["n_words"])
                self.caption_vocab = ([str(w) for w in cap["vocab"]]
                                      if "vocab" in cap else None)

        meta = np.load(os.path.join(cache_dir, "poses_metadata.npz"),
                       allow_pickle=True)
        self.data = meta["data"].item()
        n = len(self.data["path"])
        pg_files = glob.glob(os.path.join(
            cache_dir, f"pseudogt_{texture_resolution}x{texture_resolution}",
            "*.npz"))
        if len(pg_files) == 0:
            self.has_pseudo_ground_truth = False
        elif len(pg_files) == n:
            self.has_pseudo_ground_truth = True
        else:
            raise ValueError(
                "Found pseudo-ground-truth directory, but number of files does "
                f"not match! Expected {n}, got {len(pg_files)}.")
        if not self.has_pseudo_ground_truth and not evaluate:
            raise ValueError(
                "Training a model requires the pseudo-ground-truth to be set "
                "up beforehand.")

    def name(self) -> str:
        raise NotImplementedError

    def suggest_truncation_sigma(self) -> float:
        raise NotImplementedError

    def suggest_num_discriminators(self) -> int:
        raise NotImplementedError

    def suggest_mesh_template(self):
        """(segments, rings) of the procedural template for this dataset."""
        raise NotImplementedError

    def __len__(self) -> int:
        return len(self.data["path"])

    def _load_npz(self, path: str) -> dict:
        """One npz through the native decoder pool, started at first use."""
        with self._npz_lock:
            if self._npz_pool is None:
                from im23d_tpu_torch.data.fastloader import NpzPool

                self._npz_pool = NpzPool(n_threads=4)
        return self._npz_pool.load(path)

    def load_pseudo_ground_truth(self, idx: int,
                                 with_image: bool = True) -> dict:
        """texture (R, R, 3), texture_alpha (R, R, 1), mesh (m, m, 3) in the
        cache's float16 and, ``with_image``, the photo (299, 299, 3)
        float32 in [0, 1]."""
        res = self.texture_resolution
        path = os.path.join(self.cache_dir, f"pseudogt_{res}x{res}",
                            f"{idx}.npz")
        raw = self._load_npz(path)["data"].item()

        def to_nhwc(a):
            return np.ascontiguousarray(np.asarray(a).transpose(1, 2, 0))

        out = {"texture": to_nhwc(raw["texture"]),
               "texture_alpha": to_nhwc(raw["texture_alpha"]),
               "mesh": to_nhwc(raw["mesh"])}
        if with_image:
            out["image"] = (to_nhwc(raw["image"][:3]).astype(np.float32) / 2.0
                            + 0.5)
        return out

    def set_epoch(self, epoch: int) -> None:
        """Advance the per-item augmentation streams (one call per epoch)."""
        self._epoch = int(epoch)

    def _item_rng(self, idx: int, epoch: int | None = None):
        e = self._epoch if epoch is None else int(epoch)
        return np.random.default_rng(
            np.random.SeedSequence([self._seed, e, int(idx)]))

    def __getitem__(self, idx: int) -> dict:
        return self.item(idx, None)

    def item(self, idx: int, epoch: int | None) -> dict:
        """``__getitem__`` with the augmentation epoch given explicitly."""
        item = self.load_pseudo_ground_truth(idx, with_image=False)
        rng = self._item_rng(idx, epoch)
        # the mirror draw is skipped without augmentation, then the caption
        # draw: the JAX order, so items match for every flag
        mirror = self.augment and not self.evaluate and rng.integers(2) == 1
        e = (int(rng.integers(self.caption_tokens.shape[1]))
             if self.caption_tokens is not None else 0)
        if mirror:
            item = {k: mirror_tex_nhwc(v) for k, v in item.items()}
        if self.conditional_class:
            item["c"] = np.asarray(self.classes[idx], np.int32)
        if self.caption_tokens is not None:
            item["caption"] = self.caption_tokens[idx, e]
        item["idx"] = np.int32(idx)
        return item


class CubGANDataset(PseudoGTDataset):
    """CUB with 200-class labels (reference ``CubDataset``); the labels come
    from ``images.txt`` and ``image_class_labels.txt`` of ``cub_path``
    (default ``<cache>/../../datasets/cub/CUB_200_2011``)."""

    def __init__(self, cache_dir: str, cub_path: str | None = None, **kw):
        super().__init__(cache_dir, **kw)
        self.n_classes = (200,)
        if cub_path is None:
            cub_path = os.path.join(
                os.path.dirname(os.path.dirname(cache_dir)), "datasets", "cub",
                "CUB_200_2011")
        with open(os.path.join(cub_path, "images.txt")) as fh:
            ids = {k: v.strip() for k, v in (line.split(" ") for line in fh)}
        with open(os.path.join(cub_path, "image_class_labels.txt")) as fh:
            cls = {k: int(v.strip()) - 1
                   for k, v in (line.split(" ") for line in fh)}
        fname_to_class = {ids[k]: c for k, c in cls.items()}
        self.classes = [np.array([fname_to_class[str(p)]])
                        for p in self.data["path"]]

    def name(self):
        return "cub"

    def suggest_truncation_sigma(self):
        return 0.25 if self.conditional_class else 1.0

    def suggest_num_discriminators(self):
        return suggested_num_discriminators("cub", self.texture_resolution)

    def suggest_mesh_template(self):
        return (32, 16)  # uvsphere_16rings


class Pascal3DGANDataset(PseudoGTDataset):
    """Pascal3D+ cars, ImageNet subset, shape and colour labels (reference
    ``Pascal3DPlusDataset``)."""

    def __init__(self, cache_dir: str, labels_csv: str | None = None,
                 conditional_color: bool = False, **kw):
        super().__init__(cache_dir, **kw)
        self.conditional_color = conditional_color
        paths = [str(p) for p in self.data["path"]]
        self.imagenet_indices = [i for i, p in enumerate(paths)
                                 if p.startswith("car_imagenet")]
        self.data = dict(self.data)
        self.data["path"] = [paths[i] for i in self.imagenet_indices]
        for key in ("scale", "translation", "rotation"):
            self.data[key] = np.asarray(self.data[key])[self.imagenet_indices]
        if labels_csv is None:
            labels_csv = os.path.join(
                os.path.dirname(os.path.dirname(cache_dir)), "datasets", "p3d",
                "p3d_labels.csv")
        mapping, self.n_classes = self._load_labels(labels_csv)
        self.classes = [mapping[p.split("/")[-1]] for p in self.data["path"]]

    @staticmethod
    def _load_labels(path: str):
        with open(path) as fh:
            lines = fh.readlines()[1:]
        filenames, colors1, colors2, shapes = [], [], [], []
        for line in lines:
            filename, col1, col2, shape, _ = line.strip().split(",")
            filenames.append(filename)
            colors1.append(col1)
            colors2.append(col2)
            shapes.append(shape)
        c1 = {x: i for i, x in enumerate(sorted(set(colors1)))}
        c2 = {x: i for i, x in enumerate(sorted(set(colors2)))}
        sh = {x: i for i, x in enumerate(sorted(set(shapes)))}
        mapping = {f: np.array([sh[s], c1[a], c2[b]])
                   for f, s, a, b in zip(filenames, shapes, colors1, colors2)}
        return mapping, (len(sh), len(c1), len(c2))

    def load_pseudo_ground_truth(self, idx: int,
                                 with_image: bool = True) -> dict:
        return super().load_pseudo_ground_truth(self.imagenet_indices[idx],
                                                with_image)

    def name(self):
        return "p3d"

    def suggest_truncation_sigma(self):
        if self.conditional_class and self.conditional_color:
            return 0.5
        return 0.75 if self.conditional_class else 1.0

    def suggest_num_discriminators(self):
        return suggested_num_discriminators("p3d", self.texture_resolution)

    def suggest_mesh_template(self):
        return (32, 31)  # uvsphere_31rings


class EvalDataset:
    """Pose, class and pseudo-ground truth for FID evaluation (reference
    ``AbstractDatasetForEvaluation``)."""

    def __init__(self, dataset: PseudoGTDataset):
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx: int) -> dict:
        d = self.dataset.data
        item = dict(
            scale=np.asarray(d["scale"][idx], np.float32),
            translation=np.asarray(d["translation"][idx], np.float32),
            rotation=np.asarray(d["rotation"][idx], np.float32),
            idx=np.int32(idx))
        if self.dataset.conditional_class:
            item["c"] = np.asarray(self.dataset.classes[idx], np.int32)
        if self.dataset.has_pseudo_ground_truth:
            item.update(self.dataset.load_pseudo_ground_truth(idx))
        return item


def gan_batch_iterator(dataset: PseudoGTDataset, batch_size: int,
                       shuffle: bool = True, seed: int = 0,
                       num_workers: int = 4, rank: int = 0,
                       world: int = 1) -> Iterator[dict]:
    """Epoch iterator of GAN training batches, NHWC numpy: texture
    (B, H, W, 3), alpha (B, H, W, 1), mesh (B, h, w, 3), optional c and
    caption (B, L); the last partial batch dropped.  ``num_workers``
    threads build batches ahead (``data/prefetch.py``); ``seed`` is the
    epoch.  With ``world`` > 1, rank ``rank``'s rows of the global batches
    of ``world * batch_size``, reading only those items."""
    from im23d_tpu_torch.data.prefetch import prefetched_batches

    rng = np.random.RandomState(seed)
    epoch = seed
    set_epoch = getattr(dataset, "set_epoch", None)
    if set_epoch is not None:
        set_epoch(epoch)
    item_at = getattr(dataset, "item", None)
    order = np.arange(len(dataset))
    if shuffle:
        rng.shuffle(order)
    step = batch_size * world
    end = len(order) - (len(order) % step)
    index_batches = [order[start:start + step][rank * batch_size:
                                               (rank + 1) * batch_size]
                     for start in range(0, end, step)]

    def build(idx):
        items = [item_at(int(i), epoch) if item_at is not None
                 else dataset[int(i)] for i in idx]
        batch = dict(
            texture=np.stack([it["texture"] for it in items]),
            alpha=np.stack([it["texture_alpha"] for it in items]),
            mesh=np.stack([it["mesh"] for it in items]))
        for key in ("c", "caption"):
            if key in items[0]:
                batch[key] = np.stack([it[key] for it in items])
        return batch

    yield from prefetched_batches(index_batches, build, num_workers)
