"""The PyTorch port's data feeds on the CPU: ``batch_iterator``'s decode
processes (``process_workers``, ``run_reconstruction --data_processes``)
and the GAN's device-resident cache (``DeviceGANCache``,
``cli/main.py --device_cache``).

Every comparison is bit-equal: the batches of 2 decode processes against
the serial path and JAX's ``batch_iterator`` (the pool starts after a torch
op has run in this process; every wait is bounded), the recon CLI's
checkpoint after one epoch with and without ``--data_processes 2``, the
cache's batches against the port's ``gan_batch_iterator`` and JAX's
``DeviceGANCache`` for epochs 0 and 1, and the GAN CLI's checkpoint after
2 epochs with and without ``--device_cache``.  ``fits_in_hbm`` counts a
16² and a 48² mesh map, and the CLI raises before staging a cache over its
budget.
"""

import os
import types
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from im23d_tpu.data import cmr as jcmr
from im23d_tpu.data.device_cache import DeviceGANCache as JCache
from im23d_tpu.data.pseudogt import CubGANDataset as JCub
from im23d_tpu.parallel.mesh import make_mesh
from im23d_tpu_torch.cli import main as gan_cli
from im23d_tpu_torch.cli import run_reconstruction as recon_cli
from im23d_tpu_torch.data import cmr
from im23d_tpu_torch.data import device_cache
from im23d_tpu_torch.data.device_cache import DeviceGANCache
from im23d_tpu_torch.data.pseudogt import (
    CubGANDataset,
    PseudoGTDataset,
    gan_batch_iterator,
)
from im23d_tpu_torch.geometry.objio import save_obj, uv_sphere
from im23d_tpu_torch.metrics import inception
from test_cli_main import make_synthetic_cub_cache

WAIT_S = 240  # bound on any wait for the decode processes


def _fake_cmr(root, dataset_cls, n=6):
    """A CMR dataset over ``n`` random photos (60 x 80) with box masks,
    bounding boxes and random sfm poses, items at 64² and 128², jittered
    and mirrored (the records pickle, so spawned workers can hold them)."""
    from PIL import Image

    rng = np.random.RandomState(0)
    anno, anno_sfm = [], []
    for i in range(n):
        rel = f"img_{i}.png"
        Image.fromarray((rng.rand(60, 80, 3) * 255).astype(np.uint8)).save(
            os.path.join(root, rel))
        mask = np.zeros((60, 80), np.uint8)
        mask[10:40, 20:60] = 1
        bbox = types.SimpleNamespace(x1=21, y1=11, x2=60, y2=40)
        anno.append(types.SimpleNamespace(rel_path=rel, mask=mask, bbox=bbox))
        q = rng.randn(4)
        q /= np.linalg.norm(q)
        anno_sfm.append(types.SimpleNamespace(
            scale=np.float64(1.5), trans=rng.rand(2) * 20,
            rot=cmr.quaternion_matrix(q)[:3, :3]))
    ds = dataset_cls(is_train=True, img_size=[64, 128])
    ds.img_dir, ds.anno, ds.anno_sfm = str(root), anno, anno_sfm
    ds.kp_perm, ds.num_imgs, ds.jitter_frac = np.arange(15), n, 0.05
    return ds


def _bounded(fn, *args, **kw):
    with ThreadPoolExecutor(1) as ex:
        return ex.submit(fn, *args, **kw).result(timeout=WAIT_S)


def _assert_batches_equal(got, want, keys=None):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        if keys is None:
            assert set(a) == set(b)
        for k in keys or a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=k)


def test_process_workers_match_serial_and_jax(tmp_path):
    torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()  # torch ran here
    ds = _fake_cmr(tmp_path, cmr.CMRBaseDataset)
    serial = list(cmr.batch_iterator(ds, 2, seed=3, num_workers=1))
    try:
        for workers in (1, 2):  # the threads hand items to the processes
            forked = _bounded(lambda: list(cmr.batch_iterator(
                ds, 2, seed=3, num_workers=workers, process_workers=2)))
            _assert_batches_equal(forked, serial)
        pool = cmr._dataset_proc_pool(ds, 2)
        procs = list(pool._processes.values())
        assert len(procs) == 2
    finally:
        _bounded(cmr.close_process_pools, ds)
    assert not any(p.is_alive() for p in procs)
    jds = _fake_cmr(tmp_path, jcmr.CMRBaseDataset)
    _assert_batches_equal(serial, list(jcmr.batch_iterator(jds, 2, seed=3,
                                                           num_workers=1)))


def test_recon_cli_data_processes_match_threads(tmp_path, monkeypatch):
    """One epoch (3 steps) with 2 decode processes and one without: the
    same checkpoint, bit for bit."""
    ds = _fake_cmr(tmp_path, cmr.CMRBaseDataset)
    sphere = uv_sphere(8, 4)
    save_obj(str(tmp_path / "sphere"), sphere, sphere.vertices)
    monkeypatch.chdir(tmp_path)
    flags = ["--dataset", "cub", "--batch_size", "2", "--image_resolution",
             "64", "--texture_resolution", "64", "--compute_dtype",
             "float32", "--num_workers", "1", "--device", "cpu",
             "--mesh_path", str(tmp_path / "sphere.obj"), "--epochs", "1"]
    for name, extra in (("procs", ["--data_processes", "2"]),
                        ("threads", [])):
        assert _bounded(recon_cli.main, ["--name", name, *flags, *extra],
                        datasets=(ds, ds)) == 0
    assert not cmr._PROC_POOLS
    a, b = (torch.load(tmp_path / "checkpoints_recon" / name /
                       "checkpoint_3.pt", weights_only=True)
            for name in ("procs", "threads"))
    assert a["total_it"] == b["total_it"] == 3
    for key in ("params", "batch_stats", "dp_params"):
        assert a[key].keys() == b[key].keys()
        for k in a[key]:
            assert torch.equal(a[key][k], b[key][k]), (key, k)


def _write_cache(root, n, res, mesh_res):
    """A pseudo-GT cache of ``n`` items at ``res``² with ``mesh_res``²
    mesh maps (no labels: no class conditioning)."""
    cache = os.path.join(root, "cache")
    pg = os.path.join(cache, f"pseudogt_{res}x{res}")
    os.makedirs(pg)
    np.savez(os.path.join(cache, "poses_metadata.npz"),
             data=dict(path=[f"img_{i}.jpg" for i in range(n)]))
    for i in range(n):
        np.savez(os.path.join(pg, f"{i}.npz"), data=dict(
            texture=np.zeros((3, res, res), np.float16),
            texture_alpha=np.zeros((1, res, res), np.float16),
            mesh=np.zeros((3, mesh_res, mesh_res), np.float16)))
    return cache


@pytest.mark.parametrize("mesh_res", [16, 48])
def test_fits_in_hbm_counts_the_mesh_maps(tmp_path, mesh_res):
    cache = _write_cache(str(tmp_path), 3, 32, mesh_res)
    ds = PseudoGTDataset(cache, texture_resolution=32)
    need = 3 * (32 * 32 * 4 + mesh_res * mesh_res * 3) * 2
    assert DeviceGANCache.fits_in_hbm(ds, need)
    assert not DeviceGANCache.fits_in_hbm(ds, need - 1)
    assert DeviceGANCache(ds, 2, "cpu").nbytes() == need


@pytest.fixture(scope="module")
def tiny_cache(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cache"))
    make_synthetic_cub_cache(root, n=9, res=32)
    return os.path.join(root, "cache", "cub")


def test_device_cache_matches_host_iterator_and_jax(tiny_cache):
    ds = CubGANDataset(tiny_cache, texture_resolution=32,
                       conditional_class=True)
    jds = JCub(tiny_cache, texture_resolution=32, conditional_class=True)
    dev = DeviceGANCache(ds, 4, "cpu")
    jdev = JCache(jds, 4, mesh=make_mesh(jax.devices()[:1]))
    assert dev.nbytes() == jdev.nbytes()
    mirrored = 0
    for epoch in (0, 1):
        got = list(dev.epoch_batches(epoch))
        assert ds._epoch == epoch
        host = list(gan_batch_iterator(ds, 4, seed=epoch, num_workers=1))
        assert len(got) == 2  # 9 items: the last one dropped
        for g in got:
            assert g["texture"].dtype == torch.float16
            assert g["c"].dtype == torch.int32 and g["c"].shape == (4, 1)
        _assert_batches_equal(got, host)
        _assert_batches_equal(got, list(jdev.epoch_batches(epoch)),
                              keys=("texture", "alpha", "mesh", "c"))
        mirrored += sum(ds._item_rng(int(i), epoch).integers(2)
                        for i in range(len(ds)))
    assert mirrored > 0


class _PoolFeatures(torch.nn.Module):
    """(B, R, R, 3) -> (B, 288): a 12 x 8 average pool per channel."""

    def forward(self, img):
        return F.adaptive_avg_pool2d(img.permute(0, 3, 1, 2),
                                     (12, 8)).flatten(1)


@pytest.fixture
def gan_root(tmp_path, monkeypatch):
    """The CLI's 128² CUB cache (4 items), one torch thread, a 288-d pool
    for Inception (FID never runs: --evaluate_freq 100)."""
    make_synthetic_cub_cache(str(tmp_path))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(inception, "init_inception",
                        lambda device: _PoolFeatures())
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield tmp_path
    torch.set_num_threads(n)


GAN_ARGS = ["--dataset", "cub", "--texture_resolution", "128",
            "--batch_size", "2", "--num_discriminators", "2", "--device",
            "cpu", "--num_workers", "1", "--evaluate_freq", "100",
            "--conditional_class"]


def test_gan_cli_device_cache_trains_as_the_host_feed(gan_root):
    for name, extra in (("cache", ["--device_cache"]), ("host", [])):
        assert gan_cli.main(["--name", name, "--epochs", "2", *GAN_ARGS,
                             *extra]) == 0
    a, b = (torch.load(os.path.join(gan_root, "gan_weights", name,
                                    "checkpoints", "checkpoint_4.pt"),
                       weights_only=True) for name in ("cache", "host"))
    assert a["total_it"] == b["total_it"] == 4
    for key in ("g", "d", "g_ema"):
        for k in a[key]:
            assert torch.equal(a[key][k], b[key][k]), (key, k)
    log = (gan_root / "gan_weights" / "cache" / "log.txt").read_text()
    assert "device_cache: staged 4 items" in log


def test_gan_cli_refuses_a_cache_over_budget(gan_root, monkeypatch):
    # 4 items of 128² maps and a 32² mesh map: 548,864 bytes
    monkeypatch.setattr(device_cache, "HBM_BUDGET_BYTES", 548_863)

    def staged(*a, **kw):
        raise AssertionError("staged a cache over the budget")

    monkeypatch.setattr(DeviceGANCache, "__init__", staged)
    with pytest.raises(ValueError, match="budget"):
        gan_cli.main(["--name", "x", "--epochs", "1", "--device_cache",
                      *GAN_ARGS])
