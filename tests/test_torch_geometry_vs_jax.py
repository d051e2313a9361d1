"""The geometry stage from SPARF's noisy initial poses (~6 deg), the port's
against the JAX package's, on the DTU-like rig at 64x80, where the whole
stage runs at full resolution. The stage's RANSAC draws differ between the
packages (OpenCV's against the port's generators), so the port is held to
the JAX stage's accuracy, not to its bits: its internal poses (the mini-SfM
estimate, `geom_out["poses_w2c"]`) within 0.25 deg of the JAX stage's mean
relative rotation error, or below it, and its pools to the EPE contract of
tests/test_sparf_losses.py (> 45 confident px per pair, median per-pair EPE
< 1.5 px). The bootstrap branch is held to the same bar at 51x64 in
tests/test_torch_geometry_vs_jax_boot64.py; at 32x40 (_boot40.py) it is held
to the EPE contract and below 5 deg and the prior's error instead (its
docstring says why); the shared code is
tests/geometry_vs_jax_common.py.
"""
import pytest

import torch_parity  # noqa: F401  (thread cap)
from geometry_vs_jax_common import check_stage_from_the_prior


@pytest.mark.parametrize("bootstrap_max_dim", [None])
def test_stage_poses_from_the_prior_match_jax(monkeypatch, bootstrap_max_dim):
    check_stage_from_the_prior(monkeypatch, bootstrap_max_dim)
