"""The geometry stage's bootstrap branch at 32x40 (_BOOTSTRAP_MAX_DIM = 40 on
the 64x80 DTU-like rig), the port's against the JAX stage without its
flat-window noise.

The JAX sweeps divide a flat window's rounding noise by a variance clamped at
1e-8 and score it up to ~500; the port scores it 0. At 32x40 that noise ranks
the JAX stage's rounds (its mean confident "ZNCC" is 1.9-3.8, above ZNCC's
bound of 1). With the two sweeps replaced by copies that score a flat window
0 under the port's rule (tests/geometry_vs_jax_common.py install_flat_zero,
nothing under sparf_tpu/ changed), the JAX stage lands round 1 at 2.546 deg
as the port's rule-free fallback does, then takes round 2 at 4.138 deg from
five of six priors (mean 3.8 over priors 0-5, against the clamped stage's
2.414 and the port's 3.823; PERF.md, PR 10). So the port is held to that
stage as at the other rigs: within 0.25 deg of its error or below it, from
the rig's prior (4.304 against 4.138 there), besides the EPE contract and
the bound of test_torch_geometry_vs_jax_boot40.py.
"""
import pytest

import torch_parity  # noqa: F401  (thread cap)
from geometry_vs_jax_common import check_stage_from_the_prior


@pytest.mark.parametrize("bootstrap_max_dim", [40])
def test_stage_poses_from_the_prior_match_flat_zero_jax(monkeypatch, bootstrap_max_dim):
    check_stage_from_the_prior(monkeypatch, bootstrap_max_dim, flat_zero=True)
