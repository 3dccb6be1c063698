"""The native npz decoder (``csrc/host/fastloader.cpp``) through ctypes:
a pool of C++ threads reads each archive and inflates its entries outside
the GIL, and ``NpzPool`` parses the returned ``.npy`` payloads, pickled
object arrays included.

The library is built at first use with ``g++ -O3 -shared -fPIC -std=c++17
... -lz -lpthread`` into ``build/fastloader/`` at the repository root,
named by a hash of the source and the flags; each build writes a
temporary file and renames it into place, so processes that build at once
all load a whole library.  A failed build raises ``RuntimeError``; an
archive or entry the decoder cannot parse raises ``ValueError`` naming the
file and the entry.  There is no numpy fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import io
import os
import pickle
import subprocess
import threading
from pathlib import Path
from typing import Sequence

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "host" / "fastloader.cpp"
BUILD_DIR = _PKG.parent / "build" / "fastloader"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-lz", "-lpthread")

_P, _L = ctypes.c_void_p, ctypes.c_longlong
_SIGNATURES = {  # name: (restype, argtypes)
    "fl_create_pool": (_P, [ctypes.c_int]),
    "fl_destroy_pool": (None, [_P]),
    "fl_submit": (_L, [_P, ctypes.c_char_p]),
    "fl_wait": (_P, [_P, _L]),
    "fl_result_error": (ctypes.c_char_p, [_P]),
    "fl_result_blob_size": (_L, [_P]),
    "fl_result_blob": (_P, [_P]),
    "fl_result_index": (ctypes.c_char_p, [_P]),
    "fl_free_result": (None, [_P]),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def library_path() -> Path:
    """The library's file name, from a hash of the flags and the source."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libim23d_fastloader_{h.hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp), *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"cannot build the npz decoder: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}) building "
                           f"{SOURCE}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)


def load_library() -> ctypes.CDLL:
    """The decoder library, built on first call in this process."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = lib
        return _lib


def _parse_npy(raw: bytes, path: str, name: str) -> np.ndarray:
    """One entry's ``.npy`` bytes -> its array, as ``np.load`` of the npz
    reads it (pickled object arrays allowed: the caches are this
    program's own files)."""
    if not (name.endswith(".npy") and raw.startswith(b"\x93NUMPY")):
        raise ValueError(f"{path}: entry {name!r} is not a .npy file")
    try:
        return np.load(io.BytesIO(raw), allow_pickle=True)
    except (ValueError, EOFError, OSError, pickle.UnpicklingError) as e:
        raise ValueError(f"{path}: entry {name!r}: {e}") from e


class NpzPool:
    """A pool of ``n_threads`` decoder threads: ``submit`` paths, ``get``
    each as {entry name without ``.npy``: array}; ``close`` joins the
    threads."""

    def __init__(self, n_threads: int = 4):
        self._lib = load_library()
        self._pool = self._lib.fl_create_pool(n_threads)

    def close(self) -> None:
        if getattr(self, "_pool", None):
            self._lib.fl_destroy_pool(self._pool)
            self._pool = None

    def __del__(self):
        self.close()

    def submit(self, path: str) -> int:
        if not self._pool:
            raise ValueError("the pool is closed")
        return int(self._lib.fl_submit(self._pool, os.fsencode(path)))

    def get(self, ticket: int, path: str) -> dict:
        """The decoded archive of a submitted ``ticket`` (``path`` names it
        in errors)."""
        if not self._pool:
            raise ValueError("the pool is closed")
        res = self._lib.fl_wait(self._pool, ticket)
        try:
            error = self._lib.fl_result_error(res).decode()
            if error:
                raise ValueError(f"{path}: {error}")
            blob = ctypes.string_at(self._lib.fl_result_blob(res),
                                    self._lib.fl_result_blob_size(res))
            index = self._lib.fl_result_index(res).decode()
        finally:
            self._lib.fl_free_result(res)
        out = {}
        for line in index.splitlines():
            name, off, size = line.split("\t")
            start = int(off)
            out[name[:-len(".npy")] if name.endswith(".npy") else name] = (
                _parse_npy(blob[start:start + int(size)], path, name))
        return out

    def load(self, path: str) -> dict:
        """Decode one archive."""
        return self.get(self.submit(path), path)

    def load_many(self, paths: Sequence[str]) -> list[dict]:
        """Decode a batch of archives concurrently."""
        tickets = [self.submit(p) for p in paths]
        return [self.get(t, p) for t, p in zip(tickets, paths)]
