"""On the card, at each cell's own size: the program's readings within
their limits and the control's beyond them.  Marked `cuda`; skips
without a card.  Run there with

    python -m pytest benchmark/tests/test_benchmark_card.py -q
"""

import pytest
import torch

from bench_tiny import REPO
from benchmark.harness import readings, spec


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["hist.bulk", "hist.clips"])
def test_control_fails_at_the_cells_size(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run at their own size")
    cell = spec.resolve(REPO, workload)
    got = readings.readings(cell, 2 ** 31 + 77, 2.0, True,
                            torch.device("cuda"))
    limits = cell.reference.LIMITS
    assert got["failed"] == 0
    assert all(v <= limits[k] for k, v in got["program"].items()), got
    assert any(v > limits[k] for k, v in got["control"].items()), got
