"""The geometry stage at full size, the port's against the JAX package's, on
the CPU: the correspondence precompute of chip_smoke.py's 300x400 synthetic
scene with the presets' default route (PDC-Net seeds, the stage's rounds at
150x200, one full-resolution rematch), from the joint trainer's noisy
initial poses drawn with cfg.seed 0-3 (tests/geometry_reference.py). Marked
slow: the eight precomputes take ~42 min on 8 CPU threads.

Each prior: the port's internal poses below 1/5 of the prior's rotation
error (chip_smoke.py's bar on the card), with all 6 pairs kept. Over the
four priors: the port's mean relative rotation error within 0.25 deg of the
JAX stage's mean, or below it. The bar is held on the mean because the stage
is chaotic from one prior to the next in both packages (a round is won by
score differences of ~1e-4); every prior's reading is printed."""
import numpy as np
import pytest

import geometry_reference

SEEDS = (0, 1, 2, 3)


@pytest.mark.slow
def test_full_size_stage_matches_jax_from_four_priors():
    rows = []
    for seed in SEEDS:
        port = geometry_reference.run("port", seed=seed)
        ref = geometry_reference.run("jax", seed=seed)
        rows.append((seed, port["prior_rot_err_deg"], port["internal_rot_err_deg"],
                     ref["internal_rot_err_deg"], port["n_pairs"]))
        print(f"prior {seed}: {rows[-1][1]:.3f} deg; internal poses port {rows[-1][2]:.3f}, "
              f"JAX {rows[-1][3]:.3f} deg; pairs kept {rows[-1][4]}", flush=True)
    prior, port, ref, pairs = (np.array([r[k] for r in rows]) for k in (1, 2, 3, 4))
    print(f"mean internal poses: port {port.mean():.3f}, JAX {ref.mean():.3f} deg")
    assert (pairs == 6).all() and (port < prior / 5).all()
    assert port.mean() <= ref.mean() + 0.25
