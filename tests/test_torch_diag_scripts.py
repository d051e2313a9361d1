"""The port's diagnostic scripts (sparf_tpu_torch/scripts/diag_*.py) at 32x40
on the CPU, against the JAX scripts where the two packages compute the same
thing.

- diag_matcher: stage 1 (hierarchical ZNCC + LK) against the JAX stage 1 run
  through the JAX script's epe_stats: the same confident pixels and EPE
  statistics within 1e-4 px (the stage-1 flows agree to float32 rounding,
  tests/test_torch_matchers.py); the oracle-pose rematch against the JAX
  script's oracle section (a copy of its loop): per pair the median EPE
  within 0.05 px and the confident count within 2% (the sweeps' flat windows
  score 0 in the port and rounding noise in the JAX package, which moves
  the confidence mask, tests/test_torch_geometry.py); the full pipeline from
  no prior held to the EPE contract of tests/test_torch_geometry_stage.py
  (the stage is chaotic and each package runs its own solvers); the
  --rounds report on the bootstrap rig of
  tests/test_torch_geometry_vs_jax_boot40.py.
- diag_sfm_oracle: the same GT-depth matches per pair as the JAX script and
  the prior-init SfM from the GT poses within 1e-3 deg and 1e-4 of the JAX
  script's (its run_mini_sfm uses OpenCV's RANSAC and the port its own
  solvers, so that stage is held to finite errors only).
- diag_sfm_init: with the matcher stage given (GT-depth matches and a
  perturbed GT hint, the same arrays in both packages) the matches per pair
  equal the JAX script's, the hint's error within 1e-5 deg and 1e-6 (the
  same pre-alignment on the same poses) and the outer prior-init SfM's within
  1e-3 deg and 1e-4, as diag_sfm_oracle's; the outer run_mini_sfm is held to
  finite errors (OpenCV's RANSAC against the port's solvers). The whole
  script, with the zncc matcher's internal rounds, runs with finite errors:
  those rounds race RANSAC bootstraps whose generators differ between the
  packages, so their poses, and the matches the rematch bakes from them,
  cannot be compared (tests/test_torch_geometry_stage.py holds the stage to
  its EPE contract instead).
"""
import contextlib
import importlib.util
import io
import os
import re
import sys

import jax.numpy as jnp
import numpy as np

import torch_parity  # noqa: F401  (thread cap)
from sparf_tpu_torch.scripts import diag_matcher, diag_sfm_init, diag_sfm_oracle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_stage1_and_oracle(H, W, span):
    """The JAX script's stage-1 and oracle sections (a copy of
    scripts/diag_matcher.py:101-109 and :132-147)."""
    import jax

    from sparf_tpu.datasets.synthetic import load_synthetic_scene
    from sparf_tpu.models import flow_net as F

    js = _jax_script("diag_matcher")
    sc = load_synthetic_scene(split="train", H=H, W=W, n_train=3, n_test=1, angular_span=span,
                              texture_octaves=1)
    imgs, intr = np.asarray(sc["image"]), np.asarray(sc["intr"])
    combi = F.get_combi_list(3, "all")
    gt_corres, gt_conf = F.compute_gt_flow_of_combi_list(sc, combi)
    poses44 = []
    for i in range(3):
        p = np.eye(4)
        p[:3] = sc["pose"][i]
        poses44.append(p)
    out = dict(stage1={}, oracle={})
    with jax.default_matmul_precision("float32"):
        jimgs = jnp.asarray(imgs, jnp.float32)
        c1, f1 = F.compute_zncc_flow_of_combi_list(imgs, combi, intr=None)
        for p, (t, s) in enumerate(combi.T):
            out["stage1"][f"{t}->{s}"] = js.epe_stats(np.asarray(c1[p]).transpose(1, 2, 0),
                                                      f1[p, 0], gt_corres[p], gt_conf[p: p + 1, 0])
        for p, (t, s) in enumerate(combi.T):
            t, s = int(t), int(s)
            R, tr = js.rel_pose(poses44, t, s)
            d = sc["depth_gt"][t][sc["valid_depth_gt"][t]]
            c, sc_, mg, _cv, _d = F._geom_rematch_pair(jimgs[t], jimgs[s], intr[t], intr[s], R,
                                                       tr, d)
            conf = (np.asarray(sc_) >= 0.5) & (np.asarray(mg) >= 0.02)
            out["oracle"][f"{t}->{s}"] = js.epe_stats(np.asarray(c), conf.astype(np.float32),
                                                      gt_corres[p], gt_conf[p: p + 1, 0],
                                                      min_conf=0.5)
    return out


def test_diag_matcher_against_the_jax_script():
    ours = diag_matcher.run(H=32, W=40, span=0.35, device="cpu")
    ref = _jax_stage1_and_oracle(32, 40, 0.35)
    for pair, st in ref["stage1"].items():
        got = ours["stage1"][pair]
        assert got["n"] == st["n"], pair
        for k in ("med", "mean", "pck1", "pck3"):
            assert abs(got[k] - st[k]) < 1e-4, (pair, k, got[k], st[k])
    for pair, st in ref["oracle"].items():
        got = ours["oracle"][pair]
        assert abs(got["n"] - st["n"]) <= 0.02 * st["n"], (pair, got["n"], st["n"])
        assert abs(got["med"] - st["med"]) < 0.05, (pair, got["med"], st["med"])
    (full,) = ours["full"]
    counts = [st["n"] for st in full["pairs"].values()]
    medians = [st["med"] for st in full["pairs"].values()]
    assert min(counts) > 20 and np.median(medians) < 1.5
    assert np.isfinite(full["sfm_rot_err_deg"])


def test_diag_matcher_rounds_report_on_the_bootstrap_rig(capsys):
    assert diag_matcher.main(["--H", "64", "--W", "80", "--span", "0.35", "--priors", "3",
                              "--bootstrap", "40", "--rounds", "--skip-stage1",
                              "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "prior seed 3" in text and text.count("  round {") == 3
    ours = diag_matcher.run(H=64, W=80, span=0.35, priors=[3], bootstrap=40, rounds=True,
                            skip_stage1=True, device="cpu")
    (entry,) = ours["full"]
    rounds = entry["rounds"]
    assert [r["round"] for r in rounds] == [0, 1, 2] and rounds[0]["keypoints"] == "grid"
    for r in rounds:
        scored = [c for c in r["candidates"] if c["rot_err_deg"] is not None]
        assert r["winner"] in [c["candidate"] for c in scored]
        assert r["score"] == max(c["score"] for c in scored)
        for c in scored:
            assert 0 < c["coverage"] <= 1 and -1 <= c["mean_zncc"] <= 1
    # the stage keeps the best-scoring round's poses
    best = max(rounds, key=lambda r: r["score"])
    winner = next(c for c in best["candidates"] if c["candidate"] == best["winner"])
    assert abs(entry["sfm_rot_err_deg"] - winner["rot_err_deg"]) < 1e-6


def test_diag_sfm_oracle_against_the_jax_script():
    ours = diag_sfm_oracle.run(H=32, W=40, device="cpu")
    js = _jax_script("diag_sfm_oracle")
    buf, argv = io.StringIO(), sys.argv
    sys.argv = ["diag_sfm_oracle.py", "--H", "32", "--W", "40"]
    try:
        with contextlib.redirect_stdout(buf):
            js.main()
    finally:
        sys.argv = argv
    text = buf.getvalue()
    counts = {f"{i}-{j}": int(n) for i, j, n in
              re.findall(r"pair \((\d+),(\d+)\): (\d+) matches", text)}
    assert counts == ours["matches"]
    rot, trans = (float(v) for v in
                  re.search(r"GT prior\): rot ([\d.]+) deg\s+trans ([\d.]+)", text).groups())
    assert abs(ours["prior_gt"][0] - rot) < 1e-3 and abs(ours["prior_gt"][1] - trans) < 1e-4
    assert np.isfinite(ours["mini"]).all()


def test_diag_sfm_init_runs_every_stage():
    out = diag_sfm_init.run(backend="zncc", H=32, W=40, device="cpu")
    assert out["internal"] and len(out["matches"]) == 6
    for key in ("hint", "outer_prior", "outer_mini"):
        assert np.isfinite(out[key]).all(), key


def test_diag_sfm_init_against_the_jax_script_from_a_given_matcher_stage(monkeypatch):
    from sparf_tpu.colmap_init import sfm as sfm_jax
    from sparf_tpu.configs.config import ConfigDict
    from sparf_tpu.datasets.synthetic import load_synthetic_scene
    from sparf_tpu_torch.colmap_init import sfm as sfm_torch

    scene = load_synthetic_scene(split="train", H=32, W=40, n_train=4, n_test=4,
                                 texture_octaves=3, angular_span=0.35)
    kps, pair_matches, _ = sfm_jax.matches_from_dense_flow(
        scene, ConfigDict(use_gt_correspondences=True, flow_backbone="zncc"))
    hint = diag_matcher.rig_prior(np.asarray(scene["pose"]), seed=1)
    given = lambda *a, **kw: (kps, pair_matches, hint)  # noqa: E731
    monkeypatch.setattr(sfm_jax, "matches_from_dense_flow", given)
    monkeypatch.setattr(sfm_torch, "matches_from_dense_flow", given)

    ours = diag_sfm_init.run(backend="zncc", H=32, W=40, device="cpu")
    js = _jax_script("diag_sfm_init")
    ref, jax_pose_err = [], js.pose_err   # the JAX script's errors at full precision
    monkeypatch.setattr(js, "pose_err", lambda p, g: ref.append(jax_pose_err(p, g)) or ref[-1])
    buf = io.StringIO()
    monkeypatch.setattr(sys, "argv", ["diag_sfm_init.py", "--backend", "zncc", "--H", "32",
                                      "--W", "40"])
    with contextlib.redirect_stdout(buf):
        js.main()
    counts = {f"{i}-{j}": int(n) for i, j, n in
              re.findall(r"pair \((\d+),(\d+)\): (\d+) confident", buf.getvalue())}
    assert counts == ours["matches"] and len(counts) == 6
    assert ours["internal"] == [] and len(ref) == 3   # hint, outer prior-init, outer mini
    hint_ref, prior_ref, _ = ref
    assert abs(ours["hint"][0] - hint_ref[0]) < 1e-5 and abs(ours["hint"][1] - hint_ref[1]) < 1e-6
    assert hint_ref[0] > 1.0   # the hint is a real perturbation the SfM has to undo
    assert abs(ours["outer_prior"][0] - prior_ref[0]) < 1e-3
    assert abs(ours["outer_prior"][1] - prior_ref[1]) < 1e-4
    assert np.isfinite(ours["outer_mini"]).all()
