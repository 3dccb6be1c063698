"""Training observability: JSONL metrics, a plain-text log, PNG image grids
and an optional TensorBoard mirror.

A numpy-only copy of ``im23d_tpu/core/metrics_logger.py`` (the port cannot
import the JAX package).  PNGs are written by ``write_png`` below, with no
imaging library.  Scalars, histograms and images are mirrored to
TensorBoard when ``torch.utils.tensorboard`` imports; without it the JSONL
file and the PNGs are the whole record.
"""

from __future__ import annotations

import json
import os
import struct
import sys
import time
import zlib
from typing import Mapping

import numpy as np


def write_png(path: str, img: np.ndarray) -> None:
    """Write an (H, W) grayscale or (H, W, 3) RGB uint8 array as a PNG."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    color = 2 if img.ndim == 3 else 0
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n"
                 + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0,
                                              0, 0))
                 + chunk(b"IDAT", zlib.compress(raw))
                 + chunk(b"IEND", b""))


def tile_grid(images, ncol: int) -> np.ndarray:
    """Tile (N, H, W[, C]) floats in [0, 1] into one (H', W', C) grid; the
    remainder cells of a non-full last row stay black."""
    arr = np.clip(np.asarray(images, np.float32), 0.0, 1.0)
    if arr.ndim == 3:
        arr = arr[..., None]
    n, h, w, c = arr.shape
    nrows = -(-n // ncol)
    grid = np.zeros((nrows * h, ncol * w, c), np.float32)
    for i in range(n):
        r, col = divmod(i, ncol)
        grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = arr[i]
    return grid


class MetricsLogger:
    """``metrics_<name>.jsonl`` (one dict per event), ``log.txt`` (the
    command line of each run) and ``images/*.png`` under ``workdir``."""

    def __init__(self, workdir: str, name: str = "train",
                 tensorboard: bool = True):
        self.dir = os.path.abspath(workdir)
        os.makedirs(self.dir, exist_ok=True)
        self._fh = open(os.path.join(self.dir, f"metrics_{name}.jsonl"), "a",
                        buffering=1)
        self._txt = open(os.path.join(self.dir, "log.txt"), "a", buffering=1)
        print(" ".join(sys.argv), file=self._txt)
        self._tb = None
        if tensorboard:
            try:  # optional TensorBoard mirror
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(
                    log_dir=os.path.join(self.dir, "tb", name))
            except Exception:
                self._tb = None

    def log_text(self, text: str) -> None:
        """A line to log.txt and stdout."""
        print(text, file=self._txt)
        print(text)

    def log(self, step: int, scalars: Mapping[str, float]) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._fh.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), int(step))

    def log_histogram(self, step: int, name: str, values) -> None:
        """TensorBoard only; ``values`` is a host array."""
        if self._tb is not None:
            self._tb.add_histogram(name, np.asarray(values), int(step))

    def log_images(self, step: int, name: str, images, nrow: int = 4) -> None:
        """Image grid as a PNG file, and in TensorBoard when available.

        ``images``: (N, H, W[, C]) floats in [0, 1] (C = 1 or 3).
        """
        arr = np.asarray(images, np.float32)
        if arr.ndim == 3:
            arr = arr[..., None]
        if arr.shape[-1] == 1:
            arr = np.repeat(arr, 3, axis=-1)
        grid = tile_grid(arr, nrow)
        img_dir = os.path.join(self.dir, "images")
        os.makedirs(img_dir, exist_ok=True)
        write_png(
            os.path.join(img_dir,
                         f"{name.replace('/', '_')}_{int(step):08d}.png"),
            (grid * 255).astype(np.uint8),
        )
        if self._tb is not None:
            self._tb.add_image(name, grid.transpose(2, 0, 1), int(step))
