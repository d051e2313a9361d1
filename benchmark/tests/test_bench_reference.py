"""The reference agrees with the port's CPU path (the kernels' plain
versions) on the checked steps of each training cell and on the checked
frames of the render cell, at the tiny size: the same arithmetic in the
same order, so the gaps read 0 to rounding."""
import pytest
import torch

from benchmark import harness
from conftest import tiny_cell

CELLS = ["sparf-dtu.fine", "sparf-llff.joint", "sparf-dtu.render"]


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_cpu_path(name):
    torch.set_num_threads(2)
    rec = harness.run_once(tiny_cell(name), 2**31 + 12345, 0.3, False, device="cpu")
    assert rec["attempted"] >= 1 and rec["failed"] == 0
    assert rec["correct"], rec["check"]
    for key, value in rec["numbers"].items():
        assert value <= 1e-6, (key, value)
