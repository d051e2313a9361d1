"""Snapshots of sparf_tpu_torch (training/checkpointing.py and the trainer's
save/load): a save/load round trip gives the same bits, only the last two
iter-N snapshots stay beside model_best, 'latest' | 'best' | 'iter-N' select
the right one, and the weights-only warm start backfills iteration_nerf as
the JAX trainer does."""
import dataclasses
import os

import pytest
import torch

import torch_parity  # noqa: F401  (thread cap)

from sparf_tpu_torch.training import checkpointing, engine
from sparf_tpu_torch.training.define_trainer import build_config, define_trainer

TINY = dict(env={}, scene="spheres", max_iter=1000, use_gt_correspondences=True,
            min_nbr_matches=10, synthetic=dict(H=24, W=32, n_train=3, n_test=1),
            arch=dict(layers_feat=[None, 64, 64, 64, 64], layers_rgb=[None, 32, 3], skip=[2]),
            nerf=dict(sample_intvs=32, sample_intvs_fine=16, rand_rays=16),
            depth_cons_nbr_rays=16)


@pytest.fixture()
def trainer(tmp_path):
    cfg = build_config("joint_pose_nerf_training/synthetic", "sparf", TINY)
    tr = define_trainer(cfg, workspace=str(tmp_path / "ws"), device="cpu", save_option=False)
    tr.state, _ = tr.get_step(0)(tr.state, tr.draws)  # Adam moments and counts non-zero
    return tr


def _leaves(state: engine.TrainState):
    out = engine.tree_leaves(state.nerf_params) + engine.tree_leaves(state.pose_params)
    for s in (state.opt_state_nerf, state.opt_state_pose):
        out += [s.count, *s.mu, *s.nu]
    return out + [state.nan_count]


def _assert_same(a: engine.TrainState, b: engine.TrainState):
    assert (a.iteration, a.iteration_nerf) == (b.iteration, b.iteration_nerf)
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_round_trip_is_bit_exact(trainer):
    saved = trainer.state
    trainer.best_val, trainer.epoch_of_best_val = -12.5, 1
    trainer.save_snapshot()
    trainer.state, _ = trainer.get_step(1)(trainer.state, trainer.draws)
    trainer.best_val = 0.0
    assert trainer.load_snapshot("latest")
    _assert_same(trainer.state, saved)
    assert (trainer.best_val, trainer.epoch_of_best_val) == (-12.5, 1)
    assert trainer.state.iteration == 1 and trainer.state.opt_state_nerf.count.item() == 1


def test_keep_last_two_plus_best(trainer):
    ws = trainer.workspace
    states = {}
    for it in range(1, 6):
        st = dataclasses.replace(trainer.state, iteration=it, iteration_nerf=it)
        states[it] = st
        checkpointing.save_snapshot(ws, st, best_val=-float(it), epoch_of_best_val=it,
                                    is_best=(it == 2))
    assert [it for it, _ in checkpointing.list_snapshots(ws)] == [4, 5]
    assert {d for d in os.listdir(ws) if d.startswith(("iter-", "model_best"))} == \
        {"iter-4", "iter-5", "model_best"}
    best, meta = checkpointing.load_snapshot(ws, trainer.state, "best")
    assert best.iteration == 2 and meta["epoch_of_best_val"] == 2 and meta["best_val"] == -2.0
    latest, meta = checkpointing.load_snapshot(ws, trainer.state, "latest")
    assert latest.iteration == 5 and meta["iteration"] == 5
    _assert_same(checkpointing.load_snapshot(ws, trainer.state, "iter-4")[0], states[4])
    assert checkpointing.load_snapshot(ws, trainer.state, "iter-1") is None
    assert checkpointing.load_snapshot(str(ws) + "_empty", trainer.state, "latest") is None


def test_each_trainer_logs_to_its_own_workspace(trainer, tmp_path):
    """Two trainers in one process (training, then evaluation elsewhere)
    each write train.log into their own workspace."""
    cfg = build_config("joint_pose_nerf_training/synthetic", "sparf", TINY)
    other = define_trainer(cfg, workspace=str(tmp_path / "other"), device="cpu",
                           save_option=False)
    for tr in (trainer, other):
        tr.save_snapshot()
        with open(os.path.join(tr.workspace, "train.log")) as f:
            assert f"saved snapshot iter-{tr.iteration}" in f.read()


def test_layout_mismatch_raises(trainer):
    trainer.save_snapshot()
    like = dataclasses.replace(trainer.state, pose_params={
        k: torch.zeros(v.shape[0] + 1, *v.shape[1:]) for k, v in trainer.state.pose_params.items()})
    with pytest.raises(ValueError):
        checkpointing.load_snapshot(trainer.workspace, like, "latest")


@pytest.mark.parametrize("c2f", [True, False])
def test_load_weights_only_backfills_iteration_nerf(trainer, tmp_path, c2f):
    donor = dataclasses.replace(trainer.state, iteration=7, iteration_nerf=6)
    path = checkpointing.save_snapshot(str(tmp_path / "donor"), donor, 0.0, 0)
    fresh = trainer.state
    if not c2f:
        trainer.cfg.barf_c2f = None
    assert trainer.load_weights_only(path)
    st = trainer.state
    assert st.iteration == fresh.iteration
    assert st.iteration_nerf == (6 if c2f else trainer.cfg.max_iter)
    for a, b in zip(engine.tree_leaves(st.nerf_params), engine.tree_leaves(donor.nerf_params)):
        assert torch.equal(a, b)
    # the optimizers start fresh: they are the trainer's, not the donor's
    assert st.opt_state_nerf is fresh.opt_state_nerf
    assert not trainer.load_weights_only(str(tmp_path / "donor" / "iter-99"))
