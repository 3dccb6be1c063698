"""Without a card the benchmark refuses to run, and a checkout without the
program cannot produce a result."""

from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

CHECKOUT = Path(__file__).resolve().parents[2]


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "cub_gan_512.fid",
         "--seed", "2147483749", "--seconds", "1", "--trace", "0"],
        cwd=CHECKOUT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA card" in proc.stderr
    assert proc.stdout.strip() == ""


def test_benchmark_alone_cannot_measure(tmp_path):
    """A directory with only ``BENCHMARK.json`` and ``portbench/``: the
    program is missing, so a run fails before any result."""
    shutil.copy(CHECKOUT / "BENCHMARK.json", tmp_path)
    shutil.copytree(CHECKOUT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, torch; sys.path.insert(0, '.');"
            "from portbench.run import measure;"
            "measure('cub_gan_512.fid', 1, 0.1, False, torch.device('cpu'))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "im23d_tpu_torch" in proc.stderr
    assert proc.stdout.strip() == ""
