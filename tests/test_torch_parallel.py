"""Ray-sharded training of sparf_tpu_torch over gloo CPU ranks
(sparf_tpu_torch.parallel), held to the port's one-process step: the
counterpart of tests/test_parallel.py.

Each case starts its ranks as spawned processes through
parallel/dryrun.step_on_ranks (a file rendezvous in a fresh temporary
directory, so xdist workers never share a port; one torch thread per rank)
at the tiny SPARF shape with GT-depth correspondences and 16 rays per rank,
and compares one step per stage with the unsharded step on the same draws:
the loss within 1e-6 relative; the updated NeRF and pose parameters within
2e-5 (tests/test_parallel.py's bound), except where the unsharded gradient
is below 1e-6 = 100 x Adam's eps (tests/traced_draws.py's
assert_one_step_matches: there the first Adam step turns the gradients'
float32 rounding into a step difference); every rank's parameters equal
bit for bit. The step's collectives carry at most 4 bytes per trainable
parameter plus 4 KB, and no ray-sized gather. With SfM initial poses and
the learned matcher's pools, rank 0 alone runs the host precompute and every
rank holds its result bit for bit."""
import dataclasses
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from torch_entry_common import REPO, TINY
from torch_parity import BLOCK, run_python

from sparf_tpu_torch.parallel import dryrun, mesh as mesh_mod
from sparf_tpu_torch.training import engine
from sparf_tpu_torch.training.define_trainer import define_trainer
from sparf_tpu_torch.utils.draws import Draws

ITERATIONS = (0, 350)   # the joint coarse stage and the frozen-pose fine stage


def _unsharded(n, cfg_over):
    cfg = dryrun.tiny_config(n, mesh=False, **cfg_over)
    trainer = define_trainer(cfg, workspace=tempfile.mkdtemp(prefix="sparf_ref_"), device="cpu")
    out = []
    for it in ITERATIONS:
        state = dataclasses.replace(trainer.state, iteration=it, iteration_nerf=it)
        new, stats = trainer.get_step(it)(state, Draws(it, "cpu"))
        out.append(dict(stats={k: float(v) for k, v in stats.items() if v.numel() == 1},
                        nerf=engine.tree_leaves(new.nerf_params),
                        pose=engine.tree_leaves(new.pose_params),
                        mu=engine.tree_leaves(new.opt_state_nerf.mu),
                        n_nerf=sum(t.numel() for t in engine.tree_leaves(state.nerf_params)),
                        n_pose=sum(t.numel() for t in engine.tree_leaves(state.pose_params))))
    return out


def _check(n, cfg_over):
    ranks = dryrun.step_on_ranks(n, cfg_over=cfg_over, iterations=ITERATIONS, threads=1)
    ref = _unsharded(n, cfg_over)
    assert [r["backend"] for r in ranks] == ["gloo"] * n
    for k, it in enumerate(ITERATIONS):
        want = ref[k]
        for r in ranks:
            got = r["results"][k]
            for key in ("all", "render", "corres", "depth_cons"):
                np.testing.assert_allclose(got["stats"][key], want["stats"][key], rtol=1e-6,
                                           err_msg=f"{key} rank {r['rank']} it {it}")
            for a, b in zip(got["nerf"] + got["pose"], ranks[0]["results"][k]["nerf"]
                            + ranks[0]["results"][k]["pose"]):
                assert torch.equal(a, b), f"rank {r['rank']} diverged from rank 0 at it {it}"
        got = ranks[0]["results"][k]
        for a, b, g in zip(got["nerf"], want["nerf"], want["mu"]):
            keep = (g / 0.1).abs() >= 1e-6
            np.testing.assert_allclose(a[keep].numpy(), b[keep].numpy(), atol=2e-5)
        for a, b in zip(got["pose"], want["pose"]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5)
        trainable = want["n_nerf"] + (want["n_pose"] if it < 350 else 0)
        sent = got["collective_bytes"]
        assert sent["gather"] == 0 and sent["broadcast"] == 0, sent
        assert 4 * trainable <= sent["all_reduce"] <= 4 * trainable + 4096, (sent, trainable)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_step_matches_unsharded(n):
    _check(n, dict(use_gt_correspondences=True))


def test_sharded_merged_step_matches_unsharded():
    _check(2, dict(use_gt_correspondences=True, tpu=dict(merged_render=True)))


def test_precompute_runs_on_rank0_and_reaches_every_rank():
    """SfM initial poses and the learned matcher's pools (PDC-Net with the
    geometry stage): rank 0 alone computes them (the other ranks' calls
    would raise) and writes the one SfM cache; every rank then holds rank
    0's initial poses, pose constants and pools bit for bit, and takes the
    same step."""
    with tempfile.TemporaryDirectory(prefix="sparf_sfm_") as cache:
        ranks = dryrun.step_on_ranks(2, cfg_over=dict(dryrun.SFM_MATCHER, sfm_cache_dir=cache),
                                     iterations=(0,), threads=1,
                                     rank_setup=dryrun.precompute_on_rank0_only)
        assert os.listdir(cache) == ["sfm_result.npz"]
    pre = ranks[0]["precompute"]
    init = pre["pose_constants"]["initial_poses_w2c"]
    assert init.shape == (3, 3, 4) and torch.isfinite(init).all()
    assert pre["pools"]["n_pairs"] > 0 and "pool_pix_self" in pre["pools"]
    assert dryrun.ranks_disagree(ranks) == []
    assert np.isfinite(ranks[1]["results"][0]["stats"]["all"])


def test_shard_rays_splits_as_tensor_split():
    """Contiguous per-rank slices in whole groups (patches), the sizes of
    torch.tensor_split; the identity without an active mesh."""
    x = torch.arange(3 * 44).reshape(3, 44)
    assert mesh_mod.shard_rays(x, axis=1) is x
    for world in (1, 2, 3, 4):
        for unit in (1, 4):
            parts = []
            for rank in range(world):
                with mesh_mod.active(mesh_mod.Mesh(world, rank, "gloo")):
                    parts.append(mesh_mod.shard_rays(x, axis=-1, unit=unit))
            want = x.reshape(3, 44 // unit, unit).tensor_split(world, dim=1)
            for p, w in zip(parts, want):
                assert torch.equal(p, w.reshape(3, -1))
    with mesh_mod.active(mesh_mod.Mesh(2, 0, "gloo")), pytest.raises(ValueError):
        mesh_mod.shard_rays(x, axis=1, unit=3)


def test_mesh_shape_needs_the_process_group():
    """mesh_shape [N] without a process group of N ranks raises; [1] runs
    unsharded, as does "auto" in one process."""
    from sparf_tpu_torch.training.trainer import mesh_from_config

    cfg = dryrun.tiny_config(2)
    with pytest.raises(RuntimeError, match="torch.distributed"):
        mesh_from_config(cfg)
    cfg.tpu.mesh_shape = [1]
    assert mesh_from_config(cfg) is None
    cfg.tpu.mesh_shape = "auto"
    assert mesh_from_config(cfg) is None


def test_dryrun_multichip_without_jax():
    """dryrun_multichip(2), the learned matcher's precompute included, in a
    fresh interpreter with JAX and the JAX package blocked."""
    code = BLOCK + ("from sparf_tpu_torch.parallel.dryrun import dryrun_multichip\n"
                    "dryrun_multichip(2, threads=1)\n")
    proc = run_python(code, REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "dryrun_multichip(2): ok, loss=" in proc.stdout


def test_cli_trains_sharded_under_torchrun(tmp_path):
    """run_trainval under torchrun with two gloo CPU ranks and
    --tpu.mesh_shape [2]: the 10 debug iterations with validation and
    snapshots; only rank 0 writes the log and the snapshots."""
    args = ["joint_pose_nerf_training/synthetic", "sparf", "--scene", "spheres", "--debug", "True",
            "--device", "cpu", "--workspace_dir", str(tmp_path),
            *[a for a in TINY if not a.startswith(("--nerf.rand_rays", "--depth_cons_nbr_rays"))],
            "--nerf.rand_rays=32", "--depth_cons_nbr_rays=32", "--tpu.mesh_shape=[2]"]
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "-m", "sparf_tpu_torch.run_trainval", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ws = tmp_path / "joint_pose_nerf_training" / "synthetic" / "sparf" / "spheres"
    log = (ws / "train.log").read_text()
    assert "ray sharding over 2 ranks (gloo)" in log and "iter 10/" in log
    assert (ws / "iter-10").is_dir() and (ws / "model_best").is_dir()
    assert not any("rank1" in p.name for p in ws.iterdir())
