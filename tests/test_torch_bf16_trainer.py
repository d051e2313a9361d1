"""cfg.tpu.compute_dtype = "bfloat16" through the port's joint trainer on the
CPU, against the JAX trainer with its MLP on the fused-VJP Pallas kernels
(impl "pallas_vjp", which the JAX trainer takes on a TPU) run in interpret
mode: the kernels' bf16 rounding, which the port copies
(tests/test_torch_bf16_kernels.py); the XLA path rounds the backward
elsewhere. The tiny sparf config of tests/test_torch_trajectory.py, the same
parameters, initial poses and numpy-made draws (tests/traced_draws.py).

  - one step in the joint (coarse) stage and one in the fine stage, held to
    tests/traced_draws.assert_one_step_matches's bounds, but for the updated
    parameters whose gradient is below 1e-5 (float32: 1e-6): a bf16 flip
    (tests/test_torch_bf16_kernels.py) moves a gradient by up to ~7e-4 of its
    tensor's scale (measured; the check on Adam's mu holds it to 1e-3), and
    Adam's first step lr g / (|g| + eps) turns that into up to 5.9e-4 on an
    element whose |g| is 1e-7 (measured, fine stage), 1.3e-6 at ~1e-6;
  - (the short trajectory across the stage switch is in
    tests/test_torch_bf16_trajectory.py;)
  - compute_dtype reaches the MLP's products and nothing else: with the MLP
    outputs fixed, a bf16 and a float32 step agree bit for bit (rays, poses,
    compositing, losses, Adam).
"""
import dataclasses

import numpy as np
import pytest
import torch

import __graft_entry__
from torch_parity import interpret_pallas, to_np
from traced_draws import assert_one_step_matches
from sparf_tpu.configs.config import ConfigDict, override_options
from sparf_tpu.training.joint_trainer import PoseAndNerfTrainerPerScene as JaxTrainer
from sparf_tpu_torch.convert import nerf_params_from_jax, pose_params_from_jax
from sparf_tpu_torch.models import nerf_mlp as tmlp
from sparf_tpu_torch.ops import fused_mlp as fm
from sparf_tpu_torch.training import engine as teng
from sparf_tpu_torch.training.joint_trainer import PoseAndNerfTrainerPerScene as TorchTrainer
from sparf_tpu_torch.utils.draws import Draws, ReplayDraws

MAX_ITER = 100  # the stage switch at 30, coarse-to-fine PE from 40


def _cfg(dtype="bfloat16", **over):
    return override_options(__graft_entry__._flagship_cfg(1), ConfigDict(dict(
        use_gt_correspondences=True, max_iter=MAX_ITER,
        tpu=ConfigDict(donate_state=False, compute_dtype=dtype),
        arch=dict(posenc=dict(L_3D=4, L_view=2)), **over)))


def trainers(tmp_path, monkeypatch):
    """(JAX trainer on the interpret-mode Pallas kernels, port trainer on the
    CPU) at bf16, from the same parameters and poses."""
    interpret_pallas(monkeypatch)
    jt = JaxTrainer(_cfg(), workspace=str(tmp_path / "jax"))
    jt.mlp_impl = "pallas_vjp"
    tt = TorchTrainer(_cfg(), workspace=str(tmp_path / "torch"), device="cpu",
                      initial_poses_w2c=np.asarray(jt.initial_poses_w2c))
    tt.state.nerf_params = nerf_params_from_jax(to_np(jt.state.nerf_params))
    tt.state.pose_params = pose_params_from_jax(to_np(jt.state.pose_params))
    assert tt.render_cfg.mlp.compute_dtype == torch.bfloat16
    return jt, tt


@pytest.mark.parametrize("iteration,stage", [(0, "joint"), (60, "fine")])
def test_bf16_step_matches_pallas_interpret(tmp_path, monkeypatch, iteration, stage):
    jt, tt = trainers(tmp_path, monkeypatch)
    assert (iteration < tt.iter_end_joint) == (stage == "joint")
    assert tt.fine_enabled_at(iteration) == (stage == "fine")
    assert_one_step_matches(jt, tt, iteration, monkeypatch, keep_grad=1e-5)


@pytest.mark.parametrize("iteration", [0, 60])
def test_compute_dtype_reaches_only_the_mlp_products(tmp_path, monkeypatch, iteration):
    """The MLP's outputs fixed to a float32 chain whatever the dtype: a bf16
    step and a float32 step from one state on one set of draws give the same
    bits (stats, parameters, poses, Adam's moments)."""
    calls = []

    def fp32_mlp(params, cfg, *a, **k):
        calls.append(cfg.compute_dtype)
        return tmlp.nerf_apply(params, dataclasses.replace(cfg, compute_dtype=torch.float32),
                               *a, **k)

    monkeypatch.setattr(fm, "nerf_apply_fused", fp32_mlp)
    out = []
    for dtype in ("float32", "bfloat16"):
        tt = TorchTrainer(_cfg(dtype), workspace=str(tmp_path / dtype), device="cpu")
        if out:  # the float32 trainer's state
            tt.state = out[0][0]
        state = dataclasses.replace(tt.state, iteration=iteration, iteration_nerf=iteration)
        rec = []
        new, stats = tt.get_step(iteration)(state, _Recorded(Draws(3, "cpu"), rec)
                                            if not out else ReplayDraws(list(out[0][3])))
        out.append((tt.state, new, stats, rec))
    assert {torch.float32, torch.bfloat16} == set(calls)
    (_, new_f, stats_f, _), (_, new_b, stats_b, _) = out
    assert sorted(stats_f) == sorted(stats_b)
    for k in stats_f:
        assert torch.equal(stats_f[k], stats_b[k]), k
    for a, b in zip(teng.tree_leaves(new_f.nerf_params) + list(new_f.pose_params.values())
                    + list(new_f.opt_state_nerf.mu),
                    teng.tree_leaves(new_b.nerf_params) + list(new_b.pose_params.values())
                    + list(new_b.opt_state_nerf.mu)):
        assert torch.equal(a, b)


class _Recorded:
    """Draws that keep (as numpy) every array they hand out, for a replay."""

    def __init__(self, draws, out):
        self.draws, self.out = draws, out

    def _keep(self, x):
        self.out.append(x.numpy().copy())
        return x

    def uniform(self, shape):
        return self._keep(self.draws.uniform(shape))

    def randint(self, shape, low, high):
        return self._keep(self.draws.randint(shape, low, high))

    def normal(self, shape):
        return self._keep(self.draws.normal(shape))
