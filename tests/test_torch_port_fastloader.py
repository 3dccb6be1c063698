"""The port's native npz decoder (``im23d_tpu_torch/data/fastloader.py``
over ``csrc/host/fastloader.cpp``, built with g++ at first use) on the CPU:
archives decoded bit-equal to ``np.load`` (a pseudo-ground-truth item as
``generate_pseudogt`` writes it, stored entries of several dtypes), the
refusals (``ValueError`` naming the file and the entry; a failed build
raises), two processes building the library at once, and the port's
pseudo-GT dataset, which decodes through the pool, against the JAX
package's.
"""

import os
import subprocess
import sys
import zipfile

import numpy as np
import pytest

from im23d_tpu.data.pseudogt import CubGANDataset as JCub
from im23d_tpu_torch.data import fastloader
from im23d_tpu_torch.data.fastloader import NpzPool
from im23d_tpu_torch.data.pseudogt import CubGANDataset
from test_cli_main import make_synthetic_cub_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def pool():
    p = NpzPool(3)
    yield p
    p.close()


def _pseudogt_item(path, seed):
    """An item of ``ReconTrainer.generate_pseudogt``'s cache: NCHW float16
    maps transposed from NHWC, a pickled ``data`` dict, compressed."""
    rng = np.random.default_rng(seed)

    def nchw(h, w, c):
        return rng.standard_normal((h, w, c)).astype(np.float16).transpose(
            2, 0, 1)

    data = dict(mesh=nchw(8, 8, 3), texture=nchw(32, 32, 3),
                texture_alpha=nchw(32, 32, 1), image=nchw(24, 24, 3))
    np.savez_compressed(path, data=data)
    return data


def _assert_same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.strides == b.strides and a.tobytes() == b.tobytes()


def test_pseudogt_items_match_np_load(tmp_path, pool):
    paths = [str(tmp_path / f"{i}.npz") for i in range(5)]
    for i, p in enumerate(paths):
        _pseudogt_item(p, i)
    for p, got in zip(paths, pool.load_many(paths)):
        with np.load(p, allow_pickle=True) as ref:
            assert set(got) == set(ref.files) == {"data"}
            want = ref["data"].item()
        have = got["data"].item()
        assert have.keys() == want.keys()
        for k in want:
            _assert_same(have[k], want[k])


def test_stored_entries_match_np_load(tmp_path, pool):
    rng = np.random.default_rng(1)
    arrays = dict(
        f32=rng.standard_normal((5, 7)).astype(np.float32),
        f64=rng.standard_normal(9),
        f16=rng.standard_normal((2, 3, 4)).astype(np.float16),
        i64=np.arange(-5, 5, dtype=np.int64),
        u8=rng.integers(0, 255, (4, 4), dtype=np.uint8),
        b=np.array([True, False, True]),
        be=rng.standard_normal(4).astype(">f4"),
        fortran=np.asfortranarray(rng.standard_normal((3, 4))),
        empty=np.zeros((0, 3), np.int32),
        scalar=np.float32(2.5))
    path = str(tmp_path / "stored.npz")
    np.savez(path, **arrays)
    for _ in range(2):  # the pool decodes again
        got = pool.load(path)
        with np.load(path) as ref:
            assert set(got) == set(ref.files) == set(arrays)
            for k in arrays:
                _assert_same(got[k], ref[k])


def _zip(path, name, payload, method=zipfile.ZIP_STORED):
    with zipfile.ZipFile(path, "w", method) as z:
        z.writestr(name, payload)


def _npy_bytes(tmp_path):
    np.save(tmp_path / "x.npy", np.arange(6.0))
    return (tmp_path / "x.npy").read_bytes()


@pytest.mark.parametrize("case", ["bzip2", "not_npy", "bad_npy_header",
                                  "not_a_zip", "truncated", "missing"])
def test_unsupported_entries_raise(tmp_path, pool, case):
    path = str(tmp_path / "bad.npz")
    npy = _npy_bytes(tmp_path)
    entry = "x.npy"
    if case == "bzip2":
        _zip(path, entry, npy, zipfile.ZIP_BZIP2)
    elif case == "not_npy":
        entry = "notes.txt"
        _zip(path, entry, b"not an array")
    elif case == "bad_npy_header":
        _zip(path, entry, npy[:8] + b"\xff" * 8 + npy[16:])
    elif case == "not_a_zip":
        entry = None
        (tmp_path / "bad.npz").write_bytes(b"\x00" * 64)
    elif case == "truncated":
        entry = None
        np.savez_compressed(path, x=np.arange(1000.0))
        data = (tmp_path / "bad.npz").read_bytes()
        (tmp_path / "bad.npz").write_bytes(data[:len(data) // 2])
    else:
        entry = None
        path = str(tmp_path / "absent.npz")
    with pytest.raises(ValueError) as err:
        pool.load(path)
    assert path in str(err.value)
    if entry is not None:
        assert entry in str(err.value)


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(fastloader, "SOURCE", bad)
    monkeypatch.setattr(fastloader, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(fastloader, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        fastloader.load_library()
    assert not list((tmp_path / "build").iterdir())


def test_two_processes_build_at_once(tmp_path):
    """Both build into an empty directory, rename into place, load the
    library and decode; one library is left and no temporary file."""
    item = str(tmp_path / "item.npz")
    want = _pseudogt_item(item, 7)
    build = tmp_path / "build"
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        "from im23d_tpu_torch.data import fastloader as fl\n"
        "fl.BUILD_DIR = Path(sys.argv[1])\n"
        "pool = fl.NpzPool(2)\n"
        "d = pool.load(sys.argv[2])['data'].item()\n"
        "print(float(d['texture'].astype('float64').sum()))\n"
        "pool.close()\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(build), item],
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert float(out) == float(want["texture"].astype(np.float64).sum())
    assert [f.name for f in build.iterdir()] == [
        fastloader.library_path().name]


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    """The same items written stored (``np.savez``) and compressed (as
    ``generate_pseudogt`` writes them)."""
    root = str(tmp_path_factory.mktemp("stored"))
    make_synthetic_cub_cache(root, n=6, res=32)
    stored = os.path.join(root, "cache", "cub")
    root = str(tmp_path_factory.mktemp("compressed"))
    make_synthetic_cub_cache(root, n=6, res=32)
    compressed = os.path.join(root, "cache", "cub")
    pg = os.path.join(compressed, "pseudogt_32x32")
    for name in os.listdir(pg):
        with np.load(os.path.join(pg, name), allow_pickle=True) as f:
            data = f["data"].item()
        np.savez_compressed(os.path.join(pg, name), data=data)
    return stored, compressed


@pytest.mark.parametrize("which", [0, 1])
def test_dataset_items_match_jax(caches, which):
    """``item`` of the port's dataset (its npz through the native pool)
    bit-equal to the JAX package's, with the mirror augmentation, over two
    epochs."""
    cache = caches[which]
    ds = CubGANDataset(cache, texture_resolution=32, conditional_class=True)
    jds = JCub(cache, texture_resolution=32, conditional_class=True)
    for epoch in (0, 1):
        for idx in range(len(ds)):
            got, want = ds.item(idx, epoch), jds.item(idx, epoch)
            assert got.keys() == want.keys()
            for k in want:
                np.testing.assert_array_equal(got[k], np.asarray(want[k]))
                assert got[k].dtype == np.asarray(want[k]).dtype
    full = ds.load_pseudo_ground_truth(0)
    jfull = jds.load_pseudo_ground_truth(0)
    assert full.keys() == jfull.keys()
    for k in jfull:
        _assert_same(full[k], np.asarray(jfull[k]))
