"""Ray-sharded training steps across processes: the port's counterpart of
__graft_entry__.dryrun_multichip, and the runner that holds a sharded step
to the one-process step (tests/test_torch_parallel.py, chip_smoke.py).

    python -m sparf_tpu_torch.parallel.dryrun 2      (two gloo ranks on the CPU)

Each rank is a spawned process that joins a process group through a file
rendezvous in a fresh temporary directory (no fixed port to collide with
another run), builds the trainer with cfg.tpu.mesh_shape = [n] and runs
steps. A spawned process imports the caller's main module first, so a
script that calls step_on_ranks does so under `if __name__ == "__main__"`.
"""
from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

# the tiny SPARF configuration of the JAX package's dry run
# (__graft_entry__._flagship_cfg): 24x32 scene, 4x64 MLP, 32+16 samples,
# 16 rays per rank
TINY = dict(scene="spheres", synthetic=dict(H=24, W=32, n_train=3, n_test=1), max_iter=1000,
            arch=dict(layers_feat=[None, 64, 64, 64, 64], layers_rgb=[None, 32, 3], skip=[2]),
            nerf=dict(sample_intvs=32, sample_intvs_fine=16), min_nbr_matches=10)
# its one-process step: 16 rays, GT-depth correspondences
TINY_GT = dict(TINY, use_gt_correspondences=True, nerf=dict(TINY["nerf"], rand_rays=16),
               depth_cons_nbr_rays=16)


# the bench.py full shape: 300x400, 1024 / 2x512 / 3x1024 rays, 128 + 128
# samples, the 8x256 MLP, GT-depth correspondences
FULL_SCENE = dict(scene="spheres", synthetic=dict(H=300, W=400, n_train=3, n_test=1))
FULL = dict(FULL_SCENE, max_iter=100000, use_gt_correspondences=True, min_nbr_matches=100)


def tiny_config(n_ranks: int, mesh: bool = True, **overrides):
    """The joint SPARF preset at the tiny shape with 16 rays per rank (the
    JAX dry run's), sharded over `n_ranks` when `mesh`; `overrides` replace
    top-level keys (e.g. use_gt_correspondences=True)."""
    from sparf_tpu_torch.training.define_trainer import build_config

    over = dict(TINY, nerf=dict(TINY["nerf"], rand_rays=16 * n_ranks),
                depth_cons_nbr_rays=16 * n_ranks,
                use_gt_correspondences=False, flow_backbone="PDCNet")
    over.update(overrides)
    cfg = build_config("joint_pose_nerf_training/synthetic", "sparf", over)
    cfg.tpu.mesh_shape = [n_ranks] if mesh else None
    return cfg


def full_config(n_ranks: int, mesh: bool = True, **overrides):
    """The joint SPARF preset at the bench.py full shape (the step's ray
    counts split over the ranks), sharded over `n_ranks` when `mesh`."""
    from sparf_tpu_torch.training.define_trainer import build_config

    cfg = build_config("joint_pose_nerf_training/synthetic", "sparf", dict(FULL, **overrides))
    cfg.tpu.mesh_shape = [n_ranks] if mesh else None
    return cfg


# SfM initial poses and the learned matcher's pools (PDC-Net with the geometry
# stage): the host precomputes that rank 0 alone runs
SFM_MATCHER = dict(use_gt_correspondences=False, camera=dict(initial_pose="sfm_pdcnet"))


def precompute_on_rank0_only(rank: int) -> None:
    """A rank_setup for step_on_ranks: on every rank but 0 the host
    precomputes (SfM, correspondence pools, triangulation) raise if called."""
    if rank == 0:
        return
    from sparf_tpu_torch.colmap_init import sfm, triangulation
    from sparf_tpu_torch.training.losses import corres

    def refuse(*args, **kwargs):
        raise AssertionError(f"rank {rank} ran a host precompute")

    sfm.compute_sfm_from_matches = refuse
    triangulation.compute_triangulation_from_matches = refuse
    corres.build_correspondence_pools = refuse


def precompute_of(trainer) -> Dict:
    """What a rank's trainer built before its first step, as CPU copies: the
    initial poses and the pose constants (SfM or a prior), and the
    correspondence pools' arrays."""
    import numpy as np

    pools = getattr(trainer, "corres_pools", None) or {}
    return dict(
        pose_constants={k: v.detach().cpu() for k, v in (trainer.pose_constants or {}).items()},
        pools={k: v for k, v in pools.items() if isinstance(v, (np.ndarray, int, np.integer))})


def _rank_main(rank: int, n: int, backend: str, device: str, rdzv: str, out_dir: str,
               cfg_over: Dict, iterations: Sequence[int], draws_seed: int,
               threads: Optional[int], full: bool, timed_steps: int,
               rank_setup: Optional[Callable[[int], None]]) -> None:
    if threads:
        torch.set_num_threads(threads)
    if rank_setup is not None:
        rank_setup(rank)
    import torch.distributed as dist

    from sparf_tpu_torch.ops import fused_mlp
    from sparf_tpu_torch.parallel import mesh as mesh_mod
    from sparf_tpu_torch.training import engine
    from sparf_tpu_torch.training.define_trainer import define_trainer
    from sparf_tpu_torch.utils.draws import Draws

    mesh_mod.init_process_group(backend, n, rank, init_method=f"file://{rdzv}")
    try:
        cfg = (full_config if full else tiny_config)(n, **cfg_over)
        trainer = define_trainer(cfg, workspace=os.path.join(out_dir, "ws"), device=device)
        results = []
        for it in iterations:
            state = dataclasses.replace(trainer.state, iteration=int(it), iteration_nerf=int(it))
            mesh_mod.reset_collective_bytes()
            fused_mlp.reset_launch_counts()
            draws = Draws(draws_seed + it, trainer.device)
            new, stats = trainer.get_step(it)(state, draws)
            its = None
            if timed_steps:
                step = trainer.get_step(it)
                sync = (torch.cuda.synchronize if trainer.device.type == "cuda"
                        else (lambda *a: None))
                sync(trainer.device)
                t0 = time.perf_counter()
                for _ in range(timed_steps):
                    new, stats = step(new, draws)
                sync(trainer.device)
                its = timed_steps / (time.perf_counter() - t0)
            results.append(dict(
                iteration=int(it),
                stats={k: float(v) for k, v in stats.items() if v.numel() == 1},
                nerf=[t.detach().cpu() for t in engine.tree_leaves(new.nerf_params)],
                pose=[t.detach().cpu() for t in engine.tree_leaves(new.pose_params)],
                mu=[t.detach().cpu() for t in engine.tree_leaves(
                    getattr(new.opt_state_nerf, "mu", []))],
                collective_bytes=mesh_mod.collective_bytes(),
                launches=fused_mlp.launch_counts(), it_per_sec=its))
        trainer.writer.close()
        torch.save(dict(rank=rank, world=n, backend=mesh_mod.make_mesh().backend,
                        device=str(trainer.device), precompute=precompute_of(trainer),
                        results=results),
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def step_on_ranks(n: int, backend: str = "gloo", device: str = "cpu",
                  cfg_over: Optional[Dict] = None, iterations: Sequence[int] = (0,),
                  draws_seed: int = 0, threads: Optional[int] = None, full: bool = False,
                  timed_steps: int = 0, timeout: float = 600.0,
                  rank_setup: Optional[Callable[[int], None]] = None) -> List[Dict]:
    """Start `n` ranks (spawned processes) on `device` with the process
    group's `backend`, that each build the trainer sharded over `n` (the
    tiny shape, or with `full` the bench.py shape) and run one step at each
    of `iterations` from its initial state with Draws(draws_seed +
    iteration), then `timed_steps` more steps of that stage timed on the
    host clock; returns each rank's precompute (`precompute_of`) and results
    (stats, updated parameters, Adam's first moment, the collective bytes
    and kernel launches of the first step, it/s). `rank_setup`, a picklable
    function, runs in each rank with its rank before the trainer is built.
    Raises if a rank fails or outlives `timeout`."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="sparf_ranks_") as tmp:
        args = (n, backend, device, os.path.join(tmp, "rdzv"), tmp, dict(cfg_over or {}),
                list(iterations), draws_seed, threads, full, timed_steps, rank_setup)
        procs = [ctx.Process(target=_rank_main, args=(r,) + args) for r in range(n)]
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(timeout)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        codes = [p.exitcode for p in procs]
        if any(c != 0 for c in codes):
            raise RuntimeError(f"ranks exited with {codes}")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(n)]


def ranks_disagree(ranks: List[Dict]) -> List[str]:
    """What differs between each rank's own copies and rank 0's, bit for
    bit: the precompute (initial poses, pose constants, pools) and the
    parameters after every step. The logged stats are all-reduced, so they
    cannot tell the ranks apart."""
    import numpy as np

    out = []
    ref = ranks[0]
    for r in ranks[1:]:
        a, b = r["precompute"], ref["precompute"]
        for k in sorted(set(a["pose_constants"]) | set(b["pose_constants"])):
            if k not in a["pose_constants"] or k not in b["pose_constants"] or not torch.equal(
                    a["pose_constants"][k], b["pose_constants"][k]):
                out.append(f"rank {r['rank']}: pose constant {k}")
        for k in sorted(set(a["pools"]) | set(b["pools"])):
            if k not in a["pools"] or k not in b["pools"] or not np.array_equal(
                    a["pools"][k], b["pools"][k]):
                out.append(f"rank {r['rank']}: pool {k}")
        for got, want in zip(r["results"], ref["results"]):
            for part in ("nerf", "pose"):
                if not all(torch.equal(x, y) for x, y in zip(got[part], want[part])):
                    out.append(f"rank {r['rank']}: {part} parameters after the step at "
                               f"iteration {got['iteration']}")
    return out


def dryrun_multichip(n_devices: int, threads: Optional[int] = None) -> float:
    """The full SPARF step on `n_devices` gloo CPU ranks at the tiny shape,
    the learned matcher's precompute included: one step of the joint stage
    and one of the frozen-pose fine stage. Every rank's precompute and
    updated parameters must equal rank 0's bit for bit and the losses be
    finite; prints and returns the first loss."""
    import math

    ranks = step_on_ranks(n_devices, iterations=(0, 999), threads=threads)
    losses = [res["stats"]["all"] for r in ranks for res in r["results"]]
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"non-finite loss: {losses}")
    differ = ranks_disagree(ranks)
    if differ:
        raise RuntimeError("the ranks hold different copies: " + "; ".join(differ))
    print(f"dryrun_multichip({n_devices}): ok, loss={losses[0]:.4f}, "
          f"{int(ranks[0]['precompute']['pools'].get('n_pairs', 0))} pairs kept, ranks equal")
    return losses[0]


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
