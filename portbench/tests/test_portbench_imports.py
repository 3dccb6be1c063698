"""No module the benchmark loads has ``jax``, ``jaxlib``, ``flax`` or the
JAX package as its top-level name (whole names: ``im23d_tpu_torch`` is
the program), and the reference imports nothing of the program."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.lib.harness import forbidden_modules

ROOT = Path(__file__).resolve().parents[1]


def test_whole_names():
    assert forbidden_modules(["im23d_tpu_torch.ops.conv", "jaxtyping",
                              "flaxen", "numpy"]) == []
    assert forbidden_modules(["jax.numpy", "im23d_tpu.models",
                              "flax"]) == ["flax", "im23d_tpu.models",
                                           "jax.numpy"]


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted((ROOT / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not _imports(path) & {"im23d_tpu_torch", "im23d_tpu", "jax",
                                  "jaxlib", "flax"}


def test_a_run_loads_no_jax():
    """Every module of the benchmark, and a tiny run of each cell's entry on
    the CPU (which imports the program), in a fresh process."""
    code = """
import sys, torch, pathlib, importlib
sys.path.insert(0, '.')
torch.set_num_threads(2)
from portbench.run import measure
from portbench.tests.tiny import tiny_cell
from portbench.lib.harness import forbidden_modules, metric_reader
from portbench.lib.trace import kernel_spec
for p in pathlib.Path('portbench/metrics').glob('*.py'):
    metric_reader(p.stem)
for p in pathlib.Path('portbench/kernels').glob('*.py'):
    kernel_spec(p.stem)
measure('cub_gan_512.fid', 3, 0.1, False, torch.device('cpu'),
        files=tiny_cell('cub_gan_512.fid'))
found = forbidden_modules(sys.modules)
print('FOUND', found)
sys.exit(1 if found else 0)
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT.parent,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "FOUND []" in proc.stdout
