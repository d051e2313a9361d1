"""Snapshot save/load with torch.save (torch port of
sparf_tpu/training/checkpointing.py).

A snapshot is a directory `iter-N/` holding `snapshot.pt`: the full
TrainState (NeRF and pose parameters, both Adam states, with gradient
accumulation also the running mean and the mini-step counter, iteration,
iteration_nerf, nan_count) and the meta (iteration, iteration_nerf,
best_val, epoch_of_best_val). The last 2 `iter-N/` are kept, plus
`model_best/` on a validation improvement. Only tensors, numbers, strings,
lists, tuples and dicts are written, so a snapshot loads with
`torch.load(weights_only=True)`, onto the device of the state it is loaded
into: a snapshot saved on the card loads on the CPU and the other way round.
Learning rates need no fast-forward on resume: the schedules are closed-form
in the step counter, and the optimizers' counts come back with the state.
"""
from __future__ import annotations

import os
import re
import shutil
from typing import Any, Dict, List, Optional, Tuple

import torch

from sparf_tpu_torch.training import engine

FILE_NAME = "snapshot.pt"


def _ckpt_dir(workspace: str, name: str) -> str:
    return os.path.join(os.path.abspath(workspace), name)


def _opt_to_dict(s) -> Optional[Dict[str, Any]]:
    if isinstance(s, engine.AccumState):
        return {"mini_step": s.mini_step, "acc": list(s.acc), "inner": _opt_to_dict(s.inner)}
    return None if s is None else {"count": s.count, "mu": list(s.mu), "nu": list(s.nu)}


def state_to_dict(state: engine.TrainState) -> Dict[str, Any]:
    return {"nerf_params": state.nerf_params, "pose_params": state.pose_params,
            "opt_state_nerf": _opt_to_dict(state.opt_state_nerf),
            "opt_state_pose": _opt_to_dict(state.opt_state_pose),
            "iteration": int(state.iteration), "iteration_nerf": int(state.iteration_nerf),
            "nan_count": state.nan_count}


def _check_like(what: str, loaded: List[torch.Tensor], like: List[torch.Tensor]):
    if len(loaded) != len(like) or any(a.shape != b.shape for a, b in zip(loaded, like)):
        raise ValueError(f"snapshot {what} does not match the trainer's layout: "
                         f"{[tuple(a.shape) for a in loaded]} vs {[tuple(b.shape) for b in like]}")


def _opt_from_dict(d, like, device):
    if d is None or like is None:
        return None
    if isinstance(like, engine.AccumState) != ("acc" in d):
        raise ValueError("snapshot optimizer state does not match the trainer's "
                         "grad_acc_steps (gradient accumulation on one side only)")
    if isinstance(like, engine.AccumState):
        acc = [t.to(device) for t in d["acc"]]
        _check_like("accumulated gradients", acc, like.acc)
        return engine.AccumState(d["mini_step"].to(device),
                                 _opt_from_dict(d["inner"], like.inner, device), acc)
    mu = [t.to(device) for t in d["mu"]]
    nu = [t.to(device) for t in d["nu"]]
    _check_like("optimizer state", mu, like.mu)
    _check_like("optimizer state", nu, like.nu)
    return engine.AdamState(d["count"].to(device), mu, nu)


def state_from_dict(d: Dict[str, Any], like: engine.TrainState) -> engine.TrainState:
    """A TrainState from `d`, with `like`'s tree layout, on `like`'s device."""
    device = like.nan_count.device
    nerf = [t.to(device) for t in engine.tree_leaves(d["nerf_params"])]
    _check_like("NeRF parameters", nerf, engine.tree_leaves(like.nerf_params))
    pose = [t.to(device) for t in engine.tree_leaves(d["pose_params"])]
    _check_like("pose parameters", pose, engine.tree_leaves(like.pose_params))
    return engine.TrainState(
        nerf_params=engine.tree_unflatten(like.nerf_params, nerf),
        pose_params=engine.tree_unflatten(like.pose_params, pose),
        opt_state_nerf=_opt_from_dict(d["opt_state_nerf"], like.opt_state_nerf, device),
        opt_state_pose=_opt_from_dict(d["opt_state_pose"], like.opt_state_pose, device),
        iteration=int(d["iteration"]), iteration_nerf=int(d["iteration_nerf"]),
        nan_count=d["nan_count"].to(device))


def _write(path: str, payload: Dict[str, Any]) -> None:
    if os.path.exists(path):
        shutil.rmtree(path)
    os.makedirs(path)
    torch.save(payload, os.path.join(path, FILE_NAME))


def save_snapshot(workspace: str, state: engine.TrainState, best_val: float,
                  epoch_of_best_val: int, keep_last: int = 2, is_best: bool = False) -> str:
    """Save the `iter-N` snapshot (+ `model_best` when is_best); GC old ones."""
    payload = {"state": state_to_dict(state),
               "meta": {"iteration": int(state.iteration),
                        "iteration_nerf": int(state.iteration_nerf),
                        "best_val": float(best_val),
                        "epoch_of_best_val": int(epoch_of_best_val)}}
    path = _ckpt_dir(workspace, f"iter-{int(state.iteration)}")
    _write(path, payload)
    if is_best:
        _write(_ckpt_dir(workspace, "model_best"), payload)
    delete_old_checkpoints(workspace, keep_last)
    return path


def delete_old_checkpoints(workspace: str, keep_last: int = 2) -> None:
    """Keep only the newest `keep_last` iter-N snapshots."""
    snaps = list_snapshots(workspace)
    for _, path in snaps[:-keep_last] if keep_last > 0 else snaps:
        shutil.rmtree(path, ignore_errors=True)


def list_snapshots(workspace: str) -> List[Tuple[int, str]]:
    """Sorted [(iteration, absolute path)] of the iter-N snapshot directories."""
    out = []
    if not os.path.isdir(workspace):
        return out
    for d in os.listdir(workspace):
        m = re.fullmatch(r"iter-(\d+)", d)
        if m:
            out.append((int(m.group(1)), _ckpt_dir(workspace, d)))
    return sorted(out)


def load_snapshot(workspace: str, like_state: engine.TrainState, which: str = "latest"
                  ) -> Optional[Tuple[engine.TrainState, Dict]]:
    """Load 'latest' | 'best' | 'iter-N' into like_state's layout and device.

    Returns (state, meta), or None when no such snapshot exists.
    """
    if which == "latest":
        snaps = list_snapshots(workspace)
        if not snaps:
            return None
        path = snaps[-1][1]
    else:
        path = _ckpt_dir(workspace, "model_best" if which == "best" else which)
    if not os.path.exists(os.path.join(path, FILE_NAME)):
        return None
    payload = torch.load(os.path.join(path, FILE_NAME), map_location="cpu", weights_only=True)
    return state_from_dict(payload["state"], like_state), payload["meta"]
