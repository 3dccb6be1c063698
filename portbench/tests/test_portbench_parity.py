"""The frozen reference against the port on the CPU at a tiny size: with
the configuration's compute type set to float32, the program's plain paths
and the reference compute the same function from the same seeded inputs,
so every number each cell compares reads (almost) nothing."""

from __future__ import annotations

import pytest
import torch

from portbench.run import measure
from portbench.tests.tiny import tiny_cell

CELLS = ["cub_gan_512.train", "cub_recon.train", "cub_gan_512.fid"]


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", CELLS)
def test_reference_is_the_program_in_float32(cell):
    traffic, config, entry = tiny_cell(cell)
    config["model"]["compute_dtype"] = "float32"
    result, rows, _, _ = measure(cell, 2147483905, 2.0, False,
                                 torch.device("cpu"),
                                 files=(traffic, config, entry))
    assert result["attempted"] >= 1
    for name, value, _ in rows:
        assert value <= 1e-4, (name, value)
