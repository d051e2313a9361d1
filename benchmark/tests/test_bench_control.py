"""The control: the port's own bfloat16 path, the precision below the
configurations' float32, put in the program's place. Its check has to come
out not correct with each cell's limits: at the tiny size on the CPU here,
and at the cell's own size on three seeds on the card (marked `cuda`)."""
import pytest
import torch

from benchmark import harness
from conftest import tiny_cell

CELLS = ["sparf-dtu.fine", "sparf-llff.joint", "sparf-dtu.render"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    torch.set_num_threads(2)
    rec = harness.run_once(tiny_cell(name), 4242, 0.3, False, device="cpu", dtype="bfloat16")
    assert not rec["correct"], rec["check"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_on_the_card(name, cuda_device):
    cell = harness.load_cell(name)
    for seed in (71, 72, 73):
        rec = harness.run_once(cell, seed, 4.0, False, device=cuda_device, dtype="bfloat16")
        assert not rec["correct"], (seed, rec["check"])
