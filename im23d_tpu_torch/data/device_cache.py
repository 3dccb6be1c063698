"""The pseudo-ground-truth cache staged in device memory, batches assembled
on the device (counterpart of ``im23d_tpu/data/device_cache.py``).

The host iterator (``data/pseudogt.py:gan_batch_iterator``) reads, mirrors
and copies every batch to the card each iteration: at 512², bs 32, float16,
~134 MB a batch.  ``DeviceGANCache`` copies the whole dataset once and
builds each batch there: an ``index_select`` over the staged maps, then
the UV mirror (flip u, roll by half a period: the pixels of
``mirror_tex_nhwc``) under a per-item mask.  The shuffle and the
per-(epoch, idx) mirror draws are ``gan_batch_iterator``'s, so the batches
are the same; only where the bytes move changes.

Memory: N · (texture + alpha + mesh map), each in the cache's own dtype
(``generate_pseudogt`` writes the texture and alpha in float16 and the
mesh map in float32): 100 items at 512² with 32² mesh maps take
210,944,000 bytes.  ``fits_in_hbm`` counts the dataset's own map sizes and
dtypes against a budget (``HBM_BUDGET_BYTES`` by default).

With ``world`` > 1 a rank stages only its rows: the maps stay in host
memory, and each epoch the rank copies the items of its slices of that
epoch's global batches (``world * batch_size``, the host iterator's order)
to the device at once, about 1 / ``world`` of the dataset; ``fits_in_hbm``
then counts a rank's share.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from im23d_tpu_torch.core.profiler import span, to_device

HBM_BUDGET_BYTES = 2 << 30  # the JAX package's default budget

_KEYS = (("texture", "texture"), ("alpha", "texture_alpha"), ("mesh", "mesh"))


def mirror_nhwc(x: torch.Tensor) -> torch.Tensor:
    """``mirror_tex_nhwc`` for (B, H, W, C): flip u (the width axis), then
    roll by -W/2 (flip, self-concatenation and centre crop are that
    roll)."""
    return torch.roll(torch.flip(x, dims=(2,)), -(x.shape[2] // 2), dims=2)


class DeviceGANCache:
    """Stage a ``PseudoGTDataset``'s texture, alpha and mesh maps on
    ``device`` once (NHWC, the cache's dtypes) and yield device batches."""

    def __init__(self, dataset, batch_size: int, device="cuda",
                 rank: int = 0, world: int = 1):
        if dataset.caption_tokens is not None:
            raise ValueError("the device cache does not hold captions "
                             "(--conditional_text)")
        self.ds = dataset
        self.batch_size = int(batch_size)
        self.device = torch.device(device)
        self.rank, self.world = rank, world
        items = [dataset.load_pseudo_ground_truth(i, with_image=False)
                 for i in range(len(dataset))]
        host = {key: np.stack([it[src] for it in items]) for key, src in _KEYS}
        if dataset.conditional_class:
            host["c"] = np.stack([np.asarray(dataset.classes[i], np.int32)
                                  for i in range(len(dataset))])
        self._host = host if world > 1 else None
        self._maps = (None if world > 1 else
                      {k: torch.as_tensor(v).to(self.device)
                       for k, v in host.items()})
        self._staged_epoch = None

    @staticmethod
    def fits_in_hbm(dataset, budget_bytes: int | None = None,
                    world: int = 1) -> bool:
        """Whether the staged maps fit ``budget_bytes``: the dataset's own
        texture, alpha and mesh map sizes (read from its first item) times
        its length, or a rank's share of it."""
        budget = HBM_BUDGET_BYTES if budget_bytes is None else budget_bytes
        first = dataset.load_pseudo_ground_truth(0, with_image=False)
        per_item = sum(first[src].nbytes for _, src in _KEYS)
        return -(-len(dataset) // world) * per_item <= budget

    def nbytes(self) -> int:
        maps = self._maps or {}
        return sum(t.numel() * t.element_size() for k, t in maps.items()
                   if k != "c")

    def _stage(self, idx: np.ndarray) -> None:
        """This rank's items of an epoch, in the order it reads them."""
        self._maps = {k: torch.as_tensor(v[idx]).to(self.device)
                      for k, v in self._host.items()}

    def epoch_batches(self, epoch: int) -> Iterator[dict]:
        """Device batches for one epoch: ``gan_batch_iterator(ds, bs,
        seed=epoch)``'s order, mirror draws and dropped tail; the dataset's
        epoch is set to ``epoch`` as that iterator sets it."""
        ds = self.ds
        ds.set_epoch(epoch)
        order = np.arange(len(ds))
        np.random.RandomState(epoch).shuffle(order)
        b, step = self.batch_size, self.batch_size * self.world
        end = len(order) - (len(order) % step)
        own = [order[start:start + step][self.rank * b:(self.rank + 1) * b]
               for start in range(0, end, step)]
        if self.world > 1 and own and self._staged_epoch != epoch:
            self._stage(np.concatenate(own))
            self._staged_epoch = epoch
        augment = ds.augment and not ds.evaluate
        for j, idx in enumerate(own):
            with span("feed.next", j):
                mirror = to_device(torch.from_numpy(np.array(
                    [augment and ds._item_rng(int(i), epoch).integers(2) == 1
                     for i in idx], bool)), self.device)
                sel = to_device(torch.as_tensor(
                    idx if self.world == 1 else np.arange(j * b, (j + 1) * b)),
                    self.device)
                batch = {}
                for key, arr in self._maps.items():
                    g = arr.index_select(0, sel)
                    batch[key] = (g if key == "c" else
                                  torch.where(mirror[:, None, None, None],
                                              mirror_nhwc(g), g))
            yield batch
