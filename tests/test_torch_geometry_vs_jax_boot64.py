"""The geometry stage's bootstrap branch (stage 1 and the rounds at <=
_BOOTSTRAP_MAX_DIM px, then one full-resolution rematch at radius 3), the
port's against the JAX package's, on a 128x160 DTU-like rig with
_BOOTSTRAP_MAX_DIM monkeypatched to 64 in both packages, so that the rounds
run at 51x64. Held to the bar of tests/test_torch_geometry_vs_jax.py."""
import pytest

import torch_parity  # noqa: F401  (thread cap)
from geometry_vs_jax_common import check_stage_from_the_prior


@pytest.mark.parametrize("bootstrap_max_dim", [64])
def test_stage_poses_from_the_prior_match_jax(monkeypatch, bootstrap_max_dim):
    check_stage_from_the_prior(monkeypatch, bootstrap_max_dim)
