"""Tiny cells for the benchmark's CPU tests, and the marker of tests that
need the card (`cuda`: they decide inside a fixture, never at import)."""
from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the 24x32 scene, a 4x64 MLP, 32 + 16 samples, 16 rays: every recipe's
# step and render at a size a test holds
TINY = {
    "synthetic.H": 24, "synthetic.W": 32,
    "arch.layers_feat": [None, 64, 64, 64, 64], "arch.layers_rgb": [None, 32, 3],
    "arch.skip": [2], "nerf.sample_intvs": 32, "nerf.sample_intvs_fine": 16,
    "nerf.rand_rays": 16, "depth_cons_nbr_rays": 16, "min_nbr_matches": 10,
}


def _set(tree, dotted, value):
    *head, last = dotted.split(".")
    for part in head:
        tree = tree.setdefault(part, {})
    tree[last] = value


def tiny_cell(name: str, **traffic):
    """The cell `name` of BENCHMARK.json with TINY's sizes in both its
    program overrides and its `run` section (and `traffic` replacing keys of
    its traffic file)."""
    from benchmark import harness

    cell = copy.deepcopy(harness.load_cell(name))
    for k, v in TINY.items():
        cell.config["run"][k] = v
        _set(cell.config["overrides"], k, v)
    cell.traffic.update(traffic)
    return cell


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device (runs on the card)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the card")
    return torch.device("cuda")
