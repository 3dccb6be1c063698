"""A run with the timed path broken underneath comes out not correct:
every fault a cell can have, planted in the program at a tiny size on the
CPU (float32, where a sound run reads nothing), against the cell's own
limits.  The harness's look for a card is skipped; the rest of a run is
driven as on the card."""

from __future__ import annotations

import pytest
import torch

from portbench.run import measure
from portbench.tests.tiny import tiny_cell

FAULTS = {
    "cub_gan_512.train": ["unchanged", "half_batch"],
    "cub_recon.train": ["unchanged", "half_batch", "half_loss"],
    "cub_gan_512.fid": ["half_batch", "altered_row"],
}
CASES = [(c, f) for c, fs in FAULTS.items() for f in [None] + fs]


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell,fault", CASES,
                         ids=[f"{c}-{f or 'sound'}" for c, f in CASES])
def test_fault_is_caught(cell, fault):
    traffic, config, entry = tiny_cell(cell)
    config["model"]["compute_dtype"] = "float32"
    result, rows, _, _ = measure(cell, 2147483911, 2.0, False,
                                 torch.device("cpu"), fault=fault,
                                 files=(traffic, config, entry))
    assert result["correct"] is (fault is None), rows
