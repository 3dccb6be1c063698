"""On a card, each cell at its own size: a run of the program is correct,
and the control (the reference in float8 in the program's place) fails at
least one of the cell's limits.  Marked ``cuda``; it skips without a card:

    python -m pytest -p no:cacheprovider -m cuda \
        portbench/tests/test_portbench_control.py
"""

from __future__ import annotations

import pytest
import torch

from portbench.lib.common import judge
from portbench.lib.harness import load_cell
from portbench.run import measure

pytestmark = pytest.mark.cuda
CELLS = ["cub_gan_512.train", "cub_recon.train", "cub_gan_512.fid"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_refused(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    result, rows, control, _ = measure(cell, 2147483999, 4.0, False,
                                       torch.device("cuda", 0),
                                       controls=True)
    assert result["correct"], rows
    traffic, _, _ = load_cell(cell)
    numbers = {k: v for k, v in control.items() if k != "detail"}
    assert not judge(numbers, traffic["limits"])[0], numbers
