#!/usr/bin/env python
"""Profile the SPARF training step of the port: a torch.profiler trace of N
steps at one stage, device time by category, and the busy and idle share of
the traced window (the counterpart of scripts/profile_step.py).

    python -m sparf_tpu_torch.scripts.profile_step [--stage fine|coarse] [--steps 10]
        [--dtype float32|bfloat16] [--merged] [--tiny] [--device cuda|cpu]

The step is the bench.py full shape (300x400 synthetic scene, 1024
photometric, 2x512 correspondence and 3x1024 depth-consistency rays, 128 +
128 samples, the 8x256 MLP, GT-depth correspondences) unless --tiny. It
prints a table of the device kernels by time, then one JSON line: ms per
step by category (K1, K2's three parts, K3 and the weight layouts (k_pack,
and k_wg_layout of the bf16 K1 / K2) by kernel name, then
GEMM, elementwise, reduction, sort, memcpy, collective, other), the traced
window per step and the share of it in which the device ran a kernel.

On a CUDA device the categories sum device kernel events (DeviceType.CUDA);
the window is the host clock between the synchronisations before and after
the traced steps, so the idle share includes the host's gaps. On the CPU
(--device cpu, for the tests) there is no device trace: the categories sum
the self time of the CPU operators and the busy and idle shares are null.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Tuple

CATEGORIES = ("K1", "k2_backward", "k2_dw", "k2_reduce", "K3", "k_pack", "gemm", "elementwise",
              "reduction", "sort", "memcpy", "collective", "other")


def categorize(name: str) -> str:
    """The category of a kernel (or, on the CPU, operator) name."""
    n = name.lower()
    for key, cat in (("k1_forward", "K1"), ("k1_wg", "K1"), ("k2_backward", "k2_backward"),
                     ("k2_wg", "k2_backward"), ("k2_dw", "k2_dw"), ("k2_reduce", "k2_reduce"),
                     ("k3_forward", "K3"), ("k3_wg", "K3"), ("k_pack", "k_pack"),
                     ("k_wg_layout", "k_pack")):
        if key in n:
            return cat
    if any(k in n for k in ("nccl", "gloo", "all_reduce", "allreduce", "broadcast")):
        return "collective"
    if any(k in n for k in ("memcpy", "memset", "aten::copy_", "aten::to", "aten::clone")):
        return "memcpy"
    if any(k in n for k in ("gemm", "gemv", "cutlass", "xmma", "matmul", "aten::mm", "aten::bmm",
                            "aten::addmm", "aten::linear", "dot_kernel")):
        return "gemm"
    if "sort" in n:
        return "sort"
    if any(k in n for k in ("reduce", "aten::sum", "aten::mean", "aten::amax", "aten::amin",
                            "aten::max", "aten::min", "cumsum", "scan", "aten::norm",
                            "aten::linalg_vector_norm", "aten::all", "aten::any")):
        return "reduction"
    if any(k in n for k in ("elementwise", "vectorized", "unrolled", "aten::")):
        return "elementwise"
    return "other"


def build_trainer(tiny: bool, dtype: str, merged: bool, device: str):
    from sparf_tpu_torch.parallel.dryrun import FULL, TINY_GT
    from sparf_tpu_torch.training.define_trainer import build_config, define_trainer

    over = dict(TINY_GT if tiny else FULL)
    over["tpu"] = dict(compute_dtype=dtype, merged_render=merged)
    cfg = build_config("joint_pose_nerf_training/synthetic", "sparf", over)
    return define_trainer(cfg, workspace=tempfile.mkdtemp(prefix="sparf_profile_"),
                          device=device, save_option=False)


def stage_iteration(trainer, stage: str) -> int:
    ratio = float(trainer.cfg.get("ratio_end_joint_nerf_pose_refinement") or 0.3)
    return 0 if stage == "coarse" else int(trainer.cfg.max_iter * (ratio + 0.05))


def _busy_us(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy


def profile(trainer, stage: str, steps: int, warmup: int = 2) -> Dict:
    """Trace `steps` steps of the stage after `warmup`; returns the summary
    (the per-kernel table under "kernels")."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    cuda = trainer.device.type == "cuda"
    it = stage_iteration(trainer, stage)
    state = dataclasses.replace(trainer.state, iteration=it, iteration_nerf=it)
    step = trainer.get_step(it)

    def sync():
        if cuda:
            torch.cuda.synchronize(trainer.device)

    for _ in range(warmup):
        state, stats = step(state, trainer.draws)
    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with tprofile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, stats = step(state, trainer.draws)
        sync()
        window_us = (time.perf_counter() - t0) * 1e6
    by_cat: Dict[str, float] = dict.fromkeys(CATEGORIES, 0.0)
    by_name: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    intervals = []
    for e in prof.events():
        on_device = e.device_type == torch.autograd.DeviceType.CUDA
        if cuda != on_device:
            continue
        us = e.time_range.elapsed_us() if cuda else e.self_cpu_time_total
        if cuda:
            intervals.append((e.time_range.start, e.time_range.end))
        by_cat[categorize(e.name)] += us
        by_name[e.name][0] += us
        by_name[e.name][1] += 1
    busy = _busy_us(intervals) if cuda else None
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:30]
    return dict(
        device=torch.cuda.get_device_name(trainer.device) if cuda else "cpu",
        platform="cuda" if cuda else "cpu", stage=stage, iteration=it, steps=steps,
        dtype=str(trainer.cfg.tpu.get("compute_dtype", "float32")),
        merged_render=bool(trainer.cfg.tpu.get("merged_render")),
        loss=float(stats["all"]),
        ms_per_step={k: v / 1e3 / steps for k, v in by_cat.items()},
        window_ms_per_step=window_us / 1e3 / steps,
        busy_share=None if busy is None else busy / window_us,
        idle_share=None if busy is None else 1.0 - busy / window_us,
        kernels=[dict(name=n[:120], ms_per_step=v[0] / 1e3 / steps, calls=v[1]) for n, v in top])


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--stage", default="fine", choices=["fine", "coarse"])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--merged", action="store_true", help="cfg.tpu.merged_render = True")
    ap.add_argument("--tiny", action="store_true", help="the 24x32, 4x64-MLP step, 16 rays")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    trainer = build_trainer(args.tiny, args.dtype, args.merged, args.device)
    res = profile(trainer, args.stage, args.steps, args.warmup)
    for k in res["kernels"]:
        print(f"  {k['ms_per_step']:9.3f} ms/step  x{k['calls']:<5d} {k['name']}")
    print(json.dumps({k: v for k, v in res.items() if k != "kernels"}), flush=True)
    return res


if __name__ == "__main__":
    main()
