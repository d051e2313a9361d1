#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sparf_tpu_torch) on one NVIDIA GPU.

Usage (from the repository root, on a machine with a CUDA card and nvcc):

    python3 chip_smoke.py                 # all phases
    python3 chip_smoke.py --kernels-only  # build + kernel checks, no training

Phases, one line each; any failure raises and the process exits non-zero:
  1. device: name, power limit, TF32 off for matmuls and cuDNN;
  2. build: nvcc builds the kernels of sparf_tpu_torch/csrc for sm_90a in
     compiles run in parallel, fused_mlp.cu (K1, K2, K3 in 3xTF32 on
     mma.sync) and fused_mlp_wgmma.cu (K1, K2, K3 at bf16, and in 3xTF32 on
     the plan M chains); registers and spills per kernel;
  3. kernels: for each variant, 3xTF32 (compute_dtype float32) and bf16
     (compute_dtype bfloat16): the weight layouts bit for bit against their
     plain versions (k_pack's fragments and k_tf_layout at fp32; at bf16
     k_wg_layout; pack_weights' forward layout for K3); K1 (fused MLP
     forward), K2 (backward) and K3 (forward on packed weights) at the full
     8x256 width, ragged T, both view_dep settings and an active
     coarse-to-fine mask, against their plain torch versions (K3 also
     against K1's, and bit-identical to K1 where both run one body: bf16,
     and fp32 on wgmma; bf16 per point, see BF16_FLIPPED; fp32 also at T
     past the merged fine level's 786,432 points); the fp32 forward on
     wgmma also against fused_mlp.cu's k1_forward / k3_forward, and counted
     as launch.K1.tf32wg / launch.K3.tf32wg on every launch of the presets'
     chain, never on a chain outside plan M; K2 run twice must give the
     same bits; median times at T = 262,144 beside each kernel's bound (fp32
     cores, and the variant's tensor-core rate) and its plain cuBLAS chain
     (fp32 on wgmma: fused_mlp.cu's K1 / K3 beside it, "K1_mma_sync",
     "K3_mma_sync"); then the same checks (at T = 20,001) and times on
     the other chains of the kernels' domain (KERNEL_CHAINS: up to 512
     features per layer, pts_enc and view_enc up to 128 wide), each with
     its plan (128- or 64-point tiles) and K2's workspace bytes; routes: both
     C sizes entries take every chain of a grid inside the domain and
     refuse, with a width code, every chain just past it (route_chains),
     and the op's route (fused_mlp.route) picks K1/K3 and K2 as the Python
     mirror says and refuses the chains past the domain;
  4. slice-check: one step of the tiny sparf config on the card against the
     same step on the CPU (plain versions, same parameters and draws), in
     both stages; accum-check: grad_acc_steps = 2, six steps, one with a NaN
     draw, card against CPU after every step (counters, accumulator, Adam's
     mu, parameters); trajectory-check: the 200 steps of
     tests/test_torch_trajectory.py (across the stage switch at 120) on the
     card against the CPU in lockstep, the loss and the pose error held to
     that test's bounds, the largest gaps printed; bf16-check: the tiny step
     (only the bf16 variants launch) and the 200-step trajectory at
     compute_dtype bfloat16, card against CPU (TRAJ_TOL_BF16), then the
     training CLI and the eval entry point at bf16 on the card;
     wide-check: the tiny config with the presets' 8x256 MLP and
     posenc.L_3D=12 (pts_enc 75 wide: the kernels' wide plans), fp32 and
     bf16: the slice-check on it through the kernels (at fp32 its gradients
     within WIDE_KERNELS_GRAD_RTOL and its updated parameters where
     |gradient| >= WIDE_KEEP_GRAD, with a control that must miss: see
     WIDE_KERNELS_GRAD_RTOL), then
     with cfg.tpu.use_pallas=False (nerf_mlp.nerf_apply in torch ops, no
     kernel launch), under the same bounds but, at bf16, the gradients'
     (BF16_WIDE_GRAD_RTOL, see WIDE), and at bf16 a control that must miss
     them; at posenc.L_3D=21 (pts_enc 129 wide, past the domain) the step
     raises ValueError before any launch; use_pallas=False: the slice-check
     on the tiny config's own chain with use_pallas=False;
  5. matcher-check: with TF32 on for cuBLAS and cuDNN, the port's matchers
     on the card against the same calls on the CPU, on the 300x400 3-view
     synthetic scene: the PDC-Net forward with the bundled weights (max
     |delta mapping| in px at /2, max |delta p_r|) and its full-size flows,
     find_fundamental_ransac on that pair's confident matches with one
     generator seed (inlier agreement), SPSG (matched-pixel agreement) and
     ZNCC stage 1 (agreement on confident pixels and on the pool masks);
     then the geometry stage's pieces: _geom_rematch_pair 0 -> 1 at the GT
     pose (best-hypothesis agreement of both sweeps, coordinates where they
     agree) and the essential, pose-recovery, PnP and triangulation solvers
     (inlier agreement, one generator seed);
  6. matcher: build_correspondence_pools for the 6 ordered pairs of that
     scene with raw PDC-Net (bundled weights), SPSG, the presets' default
     route (PDC-Net seeds, then the geometry stage: mini-SfM and plane-sweep
     rematch) and zncc with the geometry stage, the last two from the
     trainer's noisy initial poses as prior: seconds by part, each round's
     winning route and score, the stage's internal poses against GT next to
     the prior's, pairs kept, pool sizes, flow quality against GT (EPE,
     PCK-1/3, all and in-confidence); it fails when the default route keeps
     no pair or its internal poses are not below 1/5 of the prior's error,
     or when zncc keeps no pair or ends more than ZNCC_MARGIN_DEG from the
     JAX package's reading; then the steps/s of a short
     self_supervised_adapt run;
  7. slice: the SPARF joint pose+NeRF trainer built through define_trainer
     on device "cuda" at the bench.py full shape, on the presets' default
     correspondence pools (PDC-Net + geometry stage, not GT depth), 3+ steps
     in the joint coarse stage and 3+ in the fine stage, with the kernels'
     launch counts of those steps (the depth-consistency visibility pass
     runs K3), and one timed refresh_correspondence_pools (the mid-training
     rematch, through the geometry stage again); its pools, built with TF32
     off, must equal the matcher phase's (TF32 on); bf16-slice: the same
     step shape at compute_dtype bfloat16 (GT-depth pools), 3+ steps per
     stage, its it/s beside the fp32 ones, the bf16 variants' launches;
     wide-slice: the joint step at the full shape with posenc.L_3D=12 (the
     kernels' wide plans) in both dtypes, its it/s beside the L_3D=10
     steps' and its launches;
  8. eval-check: with cuDNN TF32 at PyTorch's default (on), evaluate_full of
     the tiny config with test-time pose refinement on the card against the
     same call on the CPU (same state, replayed pixel draws); a snapshot
     saved on the card loads on the CPU with the same bits;
  9. eval: the port's eval.run_eval on the full-shape trainer after its
     fine-stage steps: one 300x400 test view, with and without 100 steps of
     test-time refinement; seconds per full-image render and per
     refinement, launch counts, metrics; video: generate_videos_synthesis on
     that trainer, 8 frames of 300x400 (rgb, depth; K3), seconds per frame,
     the animated PNGs decoded with the port's reader;
 10. fixed-pose: nerf_fixed_noisy_poses/synthetic/sparf at the full shape on
     GT-depth correspondences, steps in the coarse and the fine sampling
     stage with the poses bit-frozen, it/s, then one test view through
     evaluate_full with refinement composed onto its GT pose;
 11. dsnerf: nerf_gt_poses with SparseCOLMAPDepthLoss at the full shape, its
     depth triangulated from GT-depth matches at the GT poses and trained on
     (weight 10^0, a backward for every forward): the triangulation's
     seconds, perc_col_depth, it/s;
 12. accum: grad_acc_steps = 2 on the joint recipe at the full shape, it/s,
     the NeRF updated on every second step and the poses on every step;
 13. merged-check: the tiny step with tpu.merged_render on the card against
     the CPU in both stages, then against the card's per-bundle step on the
     same draws per bundle (utils/draws.KeyedDraws), fp32 kernel
     tolerances; per step one K1 and one K2 per hierarchy level and round
     of bundles, one K3 per level for the visibility group; merged-slice:
     the full shape in the joint and the fine stage with merged_render off
     and on, one step of each held to the other as in the merged-check (K1
     and K2 at the merged fine level's 786,432 points), then in turns (off,
     on, on, off), it/s and launches per step;
 14. multi-check: two gloo ranks on the one card (spawned processes, CUDA
     tensors through gloo) run the tiny step sharded over rays against the
     one-process card step (loss, updated parameters; every rank's
     parameters equal), then build it on SfM initial poses and the learned
     matcher's pools, which rank 0 alone computes and every rank must hold
     bit for bit; a one-rank NCCL group runs the tiny step too, then two
     ranks train the full shape in the joint stage (it/s per rank);
 15. profile: sparf_tpu_torch/scripts/profile_step.py, 10 fine-stage steps at
     fp32 at the full shape, the idle share and the top kernels by device
     time (K1 among them: k1_tf on the presets' chain, which the float32
     kernels on wgmma take, else k1_forward);
     fused-adam: the optimizer update's kernel pair (ops/fused_adam.py): the
     card tests of tests/test_torch_fused_adam.py (at the presets' leaves:
     the norms within 1e-6 relative of the plain update's, given the
     kernel's norms every output bit for bit the plain expressions', the
     same bits on two runs, the old state untouched, launch.adam once an
     update, the tiny step on the kernels and its MultiSteps twin on the
     plain update), then the full-shape step at both stages: launch.adam
     once a step, the kernels' update against the plain one on the step's
     own gradients, and torch.cuda.set_sync_debug_mode("error") silent over
     3 warmed-up steps of each stage.
 16. pdcnet-train: the PDC-Net trainer (scripts/train_pdcnet_synth.py) at
     300x400, batch 2, on 4 pairs generated through --data_cache: one step on
     the card against the CPU with TF32 on, both held to the float64
     gradient (PDC_TRAIN_TOL), then 30 steps
     through its entry point on the card (s/step, peak memory, loss trend),
     then --eval-only of the bundled weights, card against CPU;
 17. lpips-train: the LPIPS trainer (scripts/train_lpips_selfsup.py), 10 steps
     at batch 16 from seed 0 on the card and on the CPU through its entry
     point (s/step; the free-running drift beside the CPU's float32 against
     float64), then in lockstep, the card's step from the CPU's state, its
     gradient held to the float64 one along the same max-pool and ReLU routes
     (LPIPS_TRAIN_TOL), with a TF32-on control;
 18. diag: diag_matcher (the 32x40 bootstrap rig with --rounds),
     diag_sfm_init (32x40, zncc) and diag_sfm_oracle (150x200) on the card,
     exit 0.
Each path from 7 on counts its kernel launches from 0; the kernels line sums
them (the bf16 variants': the bf16-slice's and the wide-slice's; the two
full-shape ranks' counts come back from their processes). The geometry stage runs four
times in all (two matcher routes, the slice's trainer, its refresh); each
phase's seconds are printed. Then a JSON line with every kernel, and last
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
try:
    # the port's step shapes: the tiny one and the bench.py full shape
    from sparf_tpu_torch.parallel import dryrun as dryrun_configs
except ImportError:
    print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
    sys.exit(1)

# tolerances (fp32 everywhere; the kernels and the plain versions sum in other
# orders): forward outputs within 1e-4 of the largest output magnitude; every
# gradient (d_pts, d_view, each dW and db) within 1e-3 of its own largest
# magnitude (weight gradients sum over up to 262k points). A ReLU whose
# pre-activation lies within fp32 rounding of 0 can switch between two
# summation orders and change that point's gradients by O(|W| |g|), so the
# backward check gives zero output gradient to the points whose smallest
# |pre-activation| is below UNAMBIGUOUS_Z; their masks are then the same in
# the kernel and the reference and nothing is excused.
FWD_RTOL = 1e-4
BWD_RTOL = 1e-3
UNAMBIGUOUS_Z = 1e-4
# the bf16 variants against their bf16 plain versions (the same roundings,
# sums in another order): a point whose activation or g_z lands within that
# order's float32 difference of a bf16 tie rounds one bf16 step apart in the
# two (tests/test_torch_bf16_kernels.py). At the full width a point rounds
# ~2,300 values in the forward and as many g_z in the backward: 3.2% of the
# points flipped in the forward, worst 6.2e-3 of scale (PERF.md). A
# flip moves the next pre-activations by ~1e-3 (one bf16 step, 2^-8 of the
# value, times a weight), so it also switches ReLU masks that the fp32
# holdout (UNAMBIGUOUS_Z) keeps; a holdout at that size would hold out every
# point. Those points' gradients move by O(1) of their own: 0.9% of the
# points past BWD_RTOL in d_pts, worst 0.146 of scale, and the weight and
# bias gradients, sums over all points, by 0.6-2.0% of scale (PERF.md). So
# every point (row of the outputs, d_pts, d_view) is held to FWD_RTOL /
# BWD_RTOL, all but BF16_FLIPPED of them, and every point to BF16_LOOSE
# (forward, backward); each weight and bias gradient to BF16_WEIGHT_RTOL of
# its largest magnitude. A wrong layout index or rounding mode moves every
# point and every weight by O(1) of scale; the kernels' rounding is
# k_wg_layout's, bit for bit.
BF16_FLIPPED = 0.15
BF16_LOOSE = (5e-2, 0.3)
BF16_WEIGHT_RTOL = 5e-2
# Then K2 runs again with zero output gradient at the points past the tight
# bound in the forward outputs, d_pts or d_view: the weight and bias
# gradients of the other points are held to BF16_WEIGHT_RTOL_ISOLATED
# (measured on the H100: 3.5e-4 to 4.1e-4, PERF.md).
BF16_WEIGHT_RTOL_ISOLATED = 2e-3

# published peaks of one H100 SXM at 700 W (NVIDIA H100 datasheet)
PEAK_FP32 = 67e12      # FLOP/s, fp32 on the CUDA cores
PEAK_TF32 = 495e12     # FLOP/s, TF32 on the tensor cores, dense
PEAK_BF16 = 989e12     # FLOP/s, bf16 on the tensor cores, dense
PEAK_BYTES = 3.35e12   # bytes/s of HBM


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def rel_err(a, b) -> tuple:
    """(max abs error, max abs error / max abs reference)."""
    err = float((a - b).abs().max()) if a.numel() else 0.0
    scale = float(b.abs().max()) if b.numel() else 0.0
    return err, err / max(scale, 1e-6)


def row_errors(a, b):
    """Per row (point) of b, max |a - b| over b's largest magnitude."""
    if not b.numel():
        return a.new_zeros(b.shape[0])
    scale = max(float(b.abs().max()), 1e-6)
    return (a - b).abs().reshape(b.shape[0], -1).amax(dim=1) / scale


def points_err(a, b, rel: float) -> tuple:
    """(share of rows (points) whose error (row_errors) exceeds rel, the worst
    row's error)."""
    err = row_errors(a, b)
    return (float((err > rel).float().mean()), float(err.max())) if err.numel() else (0.0, 0.0)


def median_ms(fn, n: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def ptxas_summary(log: str, names=None) -> str:
    """Registers, stack and spills of each kernel (or of `names`: "tf32
    k1_forward", ...), from nvcc's -Xptxas -v output (ops/_build.py's log:
    each kind's compile after `== <source> <kind> ==`)."""
    kernels, name, kind = {}, None, ""
    for line in log.splitlines():
        h = re.match(r"== \S+ (\w+) ==", line)
        if h:
            kind = h.group(1) + " "
            continue
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = kind + _last_component(m.group(1))
            kernels[name] = []
        elif name and ("registers" in line or "spill" in line):
            kernels[name].append(line.split(" : ")[-1].strip())
    return "; ".join(f"{k}: {', '.join(v)}" for k, v in kernels.items()
                     if names is None or k in names)


def _last_component(mangled: str) -> str:
    """The function's own name in an Itanium-mangled (possibly nested) name."""
    rest = mangled[3:] if mangled.startswith("_ZN") else mangled[2:]
    last = mangled
    while rest[:1].isdigit():
        n = re.match(r"\d+", rest).group()
        last, rest = rest[len(n): len(n) + int(n)], rest[len(n) + int(n):]
    return last


# launches of K1, K2 and K3 per chain of KERNEL_CHAINS at T = 262,144 held
# bit-identical to the first (a fault in a ring's barrier schedule shows as
# a failed or a different launch now and then, not on every launch)
STRESS_LAUNCHES = 20
# MLP chains of the kernels phase beside the presets' 8x256 (MLPConfig
# widths; tests/test_torch_mlp_impl.py CHAINS): each kernel plan and layer
# shape in the kernels' domain (every layer up to 512 features, encodings up
# to 128 wide): pts_enc past 64 wide, features padded to 192, 75-wide and
# 39-wide pts_enc at 8x256, 384 and 32 features, and the domain's corner
# (8x512, pts_enc and view_enc 123 wide)
KERNEL_CHAINS = {
    "4x64-L3D12": dict(layers_feat=(64,) * 4, layers_rgb=(32, 3), skip=(2,), L_3D=12),
    "3x150": dict(layers_feat=(150,) * 3, layers_rgb=(32, 3), skip=()),
    "8x256-L3D12": dict(L_3D=12),
    "4x384-skip2": dict(layers_feat=(384,) * 4, skip=(2,)),
    "8x256-L3D6": dict(L_3D=6),
    "4x32": dict(layers_feat=(32,) * 4, layers_rgb=(32, 3), skip=(2,)),
    "8x512-L3D20-Lview20": dict(layers_feat=(512,) * 8, skip=(4,), L_3D=20, L_view=20),
}


def kernel_inputs(view_dep: bool, T: int, seed: int, bf16: bool = False, widths=None):
    """An MLP (the presets' 8x256, or `widths`: MLPConfig fields) as flat
    weights and as the parameter tree, encoded inputs of T random points,
    output gradients; `bf16`: compute_dtype bfloat16 (the bf16 variants)."""
    import torch

    from sparf_tpu_torch.models import nerf_mlp
    from sparf_tpu_torch.ops import fused_mlp as fm

    cfg = nerf_mlp.MLPConfig(view_dep=view_dep, barf_c2f=(0.4, 0.7),
                             compute_dtype=torch.bfloat16 if bf16 else torch.float32,
                             **(widths or {}))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = nerf_mlp.init_nerf_params(gen, cfg, device="cuda")
    weights = fm.flat_weights(params)
    for li in range(1, len(weights), 2):  # non-zero biases exercise the bias path
        weights[li].normal_(0.0, 0.1, generator=gen)
    progress = 0.55  # c2f mask active (frequencies partly on)
    pts = torch.randn((T, 3), generator=gen, device="cuda") * 1.5
    pts_enc = nerf_mlp.encode_points(cfg, pts, progress).contiguous()
    if view_dep:
        rays = nerf_mlp.unit_rays(torch.randn((T, 3), generator=gen, device="cuda"))
        view_enc = nerf_mlp.encode_views(cfg, rays, progress).contiguous()
    else:
        view_enc = torch.zeros((T, 0), device="cuda")
    g_density = torch.randn(T, generator=gen, device="cuda")
    g_rgb = torch.randn((T, 3), generator=gen, device="cuda")
    return fm.FusedMeta.from_cfg(cfg), pts_enc, view_enc, weights, g_density, g_rgb, params


def min_abs_preactivation(meta, pts_enc, view_enc, weights):
    """Per point, the smallest |pre-activation| over every ReLU of the chain."""
    import torch

    from sparf_tpu_torch.models import nerf_mlp
    from sparf_tpu_torch.ops import fused_mlp as fm

    _, _, xs = fm._forward_chain(meta, pts_enc, view_enc, weights)
    out = torch.full((pts_enc.shape[0],), float("inf"), device=pts_enc.device)
    for li, x in enumerate(xs[:-1]):
        z = nerf_mlp.linear(x, weights[2 * li], weights[2 * li + 1], meta.dtype)
        if li == meta.n_feat - 1:
            z = z[:, 1:]
        out = torch.minimum(out, z.abs().amin(dim=1))
    return out


def kernel_bounds(meta, weights, T: int) -> dict:
    """Per kernel, the least time the card could take for its work on these
    shapes: the larger of its bytes (inputs read once, outputs written once)
    over HBM's rate and its operations over the peak: fp32 FLOP on the CUDA
    cores, and the tensor cores' rate for what the variant runs: 3 TF32
    products per fp32 product (3xTF32), or 1 bf16 product (bf16 variants,
    meta.bf16). Returns ms and what bounds each."""
    macs = [int(weights[2 * li].numel()) for li in range(len(weights) // 2)]
    n_params = sum(int(w.numel()) for w in weights)
    d_io = meta.d_in + meta.d_view
    work = {  # (multiply-adds per point, bytes)
        "K1": (sum(macs), 4 * (T * (d_io + 4) + n_params)),
        "K2": (sum(macs[:-1]) + 2 * sum(macs), 4 * (T * (2 * d_io + 4) + 2 * n_params)),
    }
    work["K3"] = work["K1"]
    out = {}
    for k, (mac, nbytes) in work.items():
        flop = 2.0 * mac * T
        t_bytes, t_fp32 = nbytes / PEAK_BYTES, flop / PEAK_FP32
        t_3x = flop / PEAK_BF16 if meta.bf16 else 3 * flop / PEAK_TF32
        out[k] = {"bound_ms": 1e3 * max(t_bytes, t_3x),
                  "bound_by": "bytes" if t_bytes > t_3x else "operations",
                  "bound_fp32_ms": 1e3 * max(t_bytes, t_fp32), "flop": flop, "bytes": nbytes}
    return out


def check_packing(meta, weights, params) -> None:
    """The 3xTF32 weight layouts: k_pack's two fragment sets against
    pack_fragments_plain, and where the float32 kernels on wgmma take the
    chain, k_tf_layout against tf32wg_weights_plain, bit for bit (and the C
    sizes against its Python mirror, tf32wg_layout); pack_weights' layout
    for K3 against its plain version (the fragments, or the forward half)."""
    import torch

    from sparf_tpu_torch.ops import fused_mlp as fm

    dims = meta.dims(weights)
    frag = fm.pack_fragments_kernel(dims, weights)
    plain = [fm.pack_fragments_plain(dims, weights, transposed=t) for t in (False, True)]
    packed = fm.pack_weights(params, meta)
    torch.cuda.synchronize()
    lay = fm.tf32wg_layout(tuple(dims))
    route = meta.route(weights)
    if (lay is None) != (route.impl == "tf32"):
        raise AssertionError(f"the route's kernels {route.impl}, tf32wg_layout {lay is not None}")
    if isinstance(packed, fm.WgPackedWeights) != (lay is not None):
        raise AssertionError(f"pack_weights gave {type(packed).__name__}, tf32wg_layout "
                             f"{lay is not None}")
    for name, a, b in (("forward", frag[0], plain[0]), ("transposed", frag[1], plain[1]),
                       *((("pack_weights", packed.frag, plain[0]),) if lay is None else ())):
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            raise AssertionError(f"k_pack {name} fragments differ from the plain packing in "
                                 f"{int((a != b).sum())} of {a.numel()} floats")
    if lay is None:
        return
    want = [sum(int(w.numel()) for w in weights), 2 * lay.RF * lay.KF, 2 * lay.RT * lay.KT,
            lay.RF, lay.NX, lay.NG]
    if list(route.sizes[:6]) != want:
        raise AssertionError(f"sparf_fused_mlp_tf32wg_sizes {list(route.sizes[:6])} != "
                             f"tf32wg_layout's {want}")
    got = fm.tf32wg_weights_kernel(dims, weights)
    plain = fm.tf32wg_weights_plain(dims, weights)
    torch.cuda.synchronize()
    for name, a, b in zip(("forward", "transposed", "bias", "pack_weights forward",
                           "pack_weights bias"),
                          (*got, packed.wf, packed.bias_f), (*plain, plain[0], plain[2])):
        if not torch.equal(a.reshape(-1).view(torch.int32), b.reshape(-1).view(torch.int32)):
            raise AssertionError(f"k_tf_layout {name} differs from tf32wg_weights_plain in "
                                 f"{int((a != b).sum())} of {a.numel()} floats")


def check_wg_layout(meta, weights, params) -> None:
    """The bf16 kernels' weight layouts (k_wg_layout: K1 / K2's, and
    pack_weights' forward layout for K3) against wgmma_layout_plain, bit for
    bit, and the kernel's sizes against the Python mirror of its layout
    (wg_layout)."""
    import torch

    from sparf_tpu_torch.ops import fused_mlp as fm

    dims = meta.dims(weights)
    lay = fm.wg_layout(tuple(dims))
    sizes = list(meta.route(weights).sizes)
    want = [sum(int(w.numel()) for w in weights), lay.RF * lay.KF, lay.RT * lay.KT, lay.RF,
            lay.KX, lay.KG]
    if sizes[:6] != want:
        raise AssertionError(f"fused_mlp_wgmma.cu sizes {sizes[:6]} != wg_layout's {want}")
    got = fm.wg_layout_kernel(dims, weights)
    plain = fm.wgmma_layout_plain(dims, weights)
    packed = fm.pack_weights(params, meta)
    torch.cuda.synchronize()
    for name, a, b in zip(("forward", "transposed", "bias", "pack_weights forward",
                           "pack_weights bias"),
                          (*got, packed.wf, packed.bias_f), (*plain, plain[0], plain[2])):
        a, b = a.reshape(-1), b.reshape(-1)
        iv = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
        if a.shape != b.shape or not torch.equal(a.view(iv), b.view(iv)):
            raise AssertionError(f"k_wg_layout {name} differs from wgmma_layout_plain in "
                                 f"{int((a != b).sum()) if a.shape == b.shape else 'shape'}")


def _compare_forward(kname, ref_name, a, b, bf16, view_dep, T, worst, flipped, failed) -> None:
    """One forward output pair against its reference: fp32 within FWD_RTOL of
    scale; bf16 per point (module note). A miss is appended to `failed`."""
    for name, x, y in (("density", a[0][:, None], b[0][:, None]), ("rgb", a[1], b[1])):
        err, rel = rel_err(x, y)
        worst[kname] = max(worst[kname], err)
        if bf16:
            share, rel_max = points_err(x, y, FWD_RTOL)
            flipped[kname] = max(flipped[kname], share)
            ok = share <= BF16_FLIPPED and rel_max <= BF16_LOOSE[0]
        else:
            ok, share, rel_max = rel <= FWD_RTOL, 0.0, rel
        if not ok:
            failed.append(f"{kname} {name} vs {ref_name} view_dep={view_dep} T={T}: err "
                          f"{err:.3g} (rel {rel_max:.3g}, {share:.4f} of the points past "
                          f"{FWD_RTOL})")


def mma_sync_route(route):
    """The route of a chain the float32 kernels on wgmma take, with K1 / K3 and
    K2 on fused_mlp.cu's mma.sync kernels instead (the yardstick)."""
    from sparf_tpu_torch.ops import fused_mlp as fm

    return fm.Route(route.dims, False, "tf32", route.c_dims, route.tf32_sizes, route.tf32_sizes)


def check_kernels(bf16: bool = False, chain: str = None) -> dict:
    """K1, K2, K3 and their weight layouts of one variant (3xTF32 or bf16) on
    the presets' chain or a chain of KERNEL_CHAINS against their plain
    versions: the presets' at ragged T around a timed call's and, for fp32
    with view_dep, past the merged fine level's 786,432 points (K2's
    workspace then holds over 2^31 floats); another chain at one ragged T
    per view_dep setting; median times at T = 262,144. Every comparison
    runs and prints before a miss raises."""
    import torch

    from sparf_tpu_torch.ops import fused_mlp as fm
    from sparf_tpu_torch.utils import tracing

    tag = ("bf16" if bf16 else "fp32") + (f" {chain}" if chain else "")
    widths = KERNEL_CHAINS[chain] if chain else None
    worst = {"K1": 0.0, "K2": 0.0, "K3": 0.0}
    flipped = {"K1": 0.0, "K2": 0.0, "K3": 0.0}
    failed = []
    for view_dep in (True, False):
        if chain:
            Ts = (20001,)
        else:
            Ts = (131071, 262145) + ((786433,) if view_dep and not bf16 else ())
        for T in Ts:
            meta, pts_enc, view_enc, weights, g_d, g_rgb, params = kernel_inputs(
                view_dep, T, seed=T, bf16=bf16, widths=widths)
            if bf16:
                check_wg_layout(meta, weights, params)
            else:
                check_packing(meta, weights, params)
            fm.reset_launch_counts()
            packed, route = fm.pack_weights(params, meta), meta.route(weights)
            dens_k, rgb_k = fm.launch_k1(route, pts_enc, view_enc, weights)
            dens_3, rgb_3 = fm.launch_k3(route, pts_enc, view_enc, packed)
            dens_p, rgb_p = fm.fused_mlp_forward_plain(meta, pts_enc, view_enc, weights)
            dens_pp, rgb_pp = fm.fused_mlp_forward_packed_plain(meta, pts_enc, view_enc, packed)
            pairs = [("K1", "K1 plain", (dens_k, rgb_k), (dens_p, rgb_p)),
                     ("K3", "K3 plain", (dens_3, rgb_3), (dens_pp, rgb_pp)),
                     ("K3", "K1 plain", (dens_3, rgb_3), (dens_p, rgb_p))]
            counted = tracing.counts()
            fwd_wg = tuple(counted.get(k, 0) for k in (fm.K1_TF32WG, "launch.K1", fm.K3_TF32WG,
                                                       "launch.K3"))
            if route.impl == "tf32wg":
                # the forward on wgmma beside fused_mlp.cu's (both 3xTF32)
                dens_o, rgb_o = fm.launch_k1(mma_sync_route(route), pts_enc, view_enc, weights)
                pairs.append(("K1", "k1_forward", (dens_k, rgb_k), (dens_o, rgb_o)))
                if fwd_wg != (1, 1, 1, 1):
                    failed.append(f"{tag}: launch.K1.tf32wg / K1 / K3.tf32wg / K3 {fwd_wg}, not "
                                  f"one each (view_dep={view_dep}, T={T})")
            elif not bf16 and fwd_wg[0] + fwd_wg[2]:
                failed.append(f"{tag}: a chain outside plan M counted launch.K1.tf32wg / "
                              f"launch.K3.tf32wg {fwd_wg[0]} / {fwd_wg[2]}")
            torch.cuda.synchronize()
            for kname, ref_name, a, b in pairs:
                _compare_forward(kname, ref_name, a, b, bf16, view_dep, T, worst, flipped,
                                 failed)
            k3_same_bits = torch.equal(dens_3, dens_k) and torch.equal(rgb_3, rgb_k)
            if route.impl != "tf32" and not k3_same_bits:  # K1's body on one layout
                failed.append(f"K3 {tag} not bit-identical to K1 (view_dep={view_dep}, T={T})")
            fwd_past = ((row_errors(dens_k[:, None], dens_p[:, None]) > FWD_RTOL)
                        | (row_errors(rgb_k, rgb_p) > FWD_RTOL))

            keep = (min_abs_preactivation(meta, pts_enc, view_enc, weights)
                    >= UNAMBIGUOUS_Z).float()
            g_d, g_rgb = g_d * keep, g_rgb * keep[:, None]
            fm.reset_launch_counts()
            out_k = fm.launch_k2(route, pts_enc, view_enc, weights, g_d, g_rgb)
            out_k2 = fm.launch_k2(route, pts_enc, view_enc, weights, g_d, g_rgb)
            torch.cuda.synchronize()
            counted = tracing.counts()
            k2_wg = (counted.get(fm.K2_TF32WG, 0), counted.get("launch.K2", 0))
            if not bf16 and chain is None and k2_wg[0] != k2_wg[1]:
                failed.append(f"K2 {tag}: launch.K2.tf32wg {k2_wg[0]} != launch.K2 {k2_wg[1]} "
                              f"on the presets' chain")
            flat_k = [out_k[0], out_k[1], *out_k[2]]
            flat_k2 = [out_k2[0], out_k2[1], *out_k2[2]]
            k2_same_bits = all(torch.equal(a, b) for a, b in zip(flat_k, flat_k2))
            if not k2_same_bits:
                failed.append(f"K2 {tag} not deterministic (view_dep={view_dep}, T={T})")
            out_p = fm.fused_mlp_backward_plain(meta, pts_enc, view_enc, weights, g_d, g_rgb)
            refs = [("plain", [out_p[0], out_p[1], *out_p[2]])]
            if not bf16:
                # autograd through the plain chain (under bf16 autograd rounds the
                # gradients at the casts: another rounding than the kernels')
                leaves = [t.detach().requires_grad_(True) for t in (pts_enc, view_enc, *weights)]
                d, rgb = fm.fused_mlp_forward_plain(meta, leaves[0], leaves[1], leaves[2:])
                flat_a = torch.autograd.grad((d * g_d).sum() + (rgb * g_rgb).sum(), leaves,
                                             allow_unused=True)
                refs.append(("autograd", [torch.zeros_like(l) if g is None else g
                                          for g, l in zip(flat_a, leaves)]))
            names = ["d_pts", "d_view"] + [f"{'W' if i % 2 == 0 else 'b'}{i // 2}"
                                           for i in range(len(weights))]
            worst_rel, worst_weight = 0.0, 0.0
            for ref_name, flat_ref in refs:
                for i, (name, a, b) in enumerate(zip(names, flat_k, flat_ref)):
                    err, rel = rel_err(a, b)
                    worst["K2"] = max(worst["K2"], err)
                    share = 0.0
                    if bf16 and i < 2:  # per point
                        share, rel = points_err(a, b, BWD_RTOL)
                        flipped["K2"] = max(flipped["K2"], share)
                        ok = share <= BF16_FLIPPED and rel <= BF16_LOOSE[1]
                    else:
                        ok = rel <= (BF16_WEIGHT_RTOL if bf16 else BWD_RTOL)
                        worst_weight = max(worst_weight, rel)
                    worst_rel = max(worst_rel, rel)
                    if not ok:
                        failed.append(f"K2 {tag} {name} vs {ref_name} view_dep={view_dep} "
                                      f"T={T}: err {err:.3g} (rel {rel:.3g}, {share:.4f} of the "
                                      f"points past {BWD_RTOL})")
            isolated = 0.0
            if bf16:  # the weight gradients of the points that no flip reached
                past = (fwd_past | (row_errors(out_k[0], out_p[0]) > BWD_RTOL)
                        | (row_errors(out_k[1], out_p[1]) > BWD_RTOL))
                clean = (~past).float()
                out_k = fm.launch_k2(route, pts_enc, view_enc, weights, g_d * clean,
                                     g_rgb * clean[:, None])
                out_p = fm.fused_mlp_backward_plain(meta, pts_enc, view_enc, weights,
                                                    g_d * clean, g_rgb * clean[:, None])
                for name, a, b in zip(names[2:], out_k[2], out_p[2]):
                    rel = rel_err(a, b)[1]
                    isolated = max(isolated, rel)
                    if not rel <= BF16_WEIGHT_RTOL_ISOLATED:
                        failed.append(f"K2 {tag} {name} vs plain, {float(past.float().mean()):.4f} "
                                      f"of the points left out, view_dep={view_dep} T={T}: rel "
                                      f"{rel:.3g}")
            del out_k, out_k2, out_p, refs
            phase("kernels", f"{tag} view_dep={view_dep} T={T}: K1, K2 and K3 "
                             f"{'miss' if failed else 'agree with'} the plain versions (worst "
                             f"relative error K2 {worst_rel:.3g}, of a weight gradient "
                             f"{worst_weight:.3g}"
                             + (f"; points past the tight bound: K1 {flipped['K1']:.4f}, K3 "
                                f"{flipped['K3']:.4f}, K2 {flipped['K2']:.4f}; weight gradients "
                                f"without them {isolated:.3g}" if bf16 else "")
                             + f"), K2 {'' if k2_same_bits else 'not '}bit-identical on "
                             f"rerun, K3 "
                             f"{'' if k3_same_bits else 'not '}bit-identical to K1, "
                             + ("k_wg_layout" if bf16 else "k_pack")
                             + ("" if bf16 or fm.tf32wg_layout(tuple(meta.dims(weights))) is None
                                else " and k_tf_layout")
                             + f" bit-identical to its plain version; launch.K2.tf32wg / "
                             f"launch.K2 {k2_wg[0]} / {k2_wg[1]}, launch.K1.tf32wg / K1 / "
                             f"K3.tf32wg / K3 {fwd_wg}; "
                             f"{1 - float(keep.mean()):.4f} "
                             f"of the points held out of the backward check (|z| < "
                             f"{UNAMBIGUOUS_Z})")
            torch.cuda.empty_cache()

    meta, pts_enc, view_enc, weights, g_d, g_rgb, params = kernel_inputs(
        True, 262144, seed=1, bf16=bf16, widths=widths)
    packed, route = fm.pack_weights(params, meta), meta.route(weights)
    n = 5 if chain else 10
    times = {
        "K1": median_ms(lambda: fm.launch_k1(route, pts_enc, view_enc, weights), n),
        "K1_plain": median_ms(lambda: fm.fused_mlp_forward_plain(meta, pts_enc, view_enc,
                                                                  weights), n),
        "K3": median_ms(lambda: fm.launch_k3(route, pts_enc, view_enc, packed), n),
        "K3_plain": median_ms(lambda: fm.fused_mlp_forward_packed_plain(meta, pts_enc, view_enc,
                                                                         packed), n),
        "K2": median_ms(lambda: fm.launch_k2(route, pts_enc, view_enc, weights, g_d, g_rgb), n),
        "K2_plain": median_ms(lambda: fm.fused_mlp_backward_plain(meta, pts_enc, view_enc,
                                                                   weights, g_d, g_rgb), n),
    }
    if route.impl == "tf32wg":  # fused_mlp.cu's K1 / K3 on the same chain
        old = mma_sync_route(route)
        frags = fm.PackedWeights(route.dims, fm.pack_fragments_kernel(
            route.dims, weights, transposed=False)[0], weights[1::2])
        times["K1_mma_sync"] = median_ms(lambda: fm.launch_k1(old, pts_enc, view_enc, weights), n)
        times["K3_mma_sync"] = median_ms(lambda: fm.launch_k3(old, pts_enc, view_enc, frags), n)
    if chain:  # every launch at the timed T gives the first one's bits (K2 and K1, K3)
        first = fm.launch_k2(route, pts_enc, view_enc, weights, g_d, g_rgb)
        f1, f3 = (fm.launch_k1(route, pts_enc, view_enc, weights),
                  fm.launch_k3(route, pts_enc, view_enc, packed))
        same = True
        for _ in range(STRESS_LAUNCHES):
            again = fm.launch_k2(route, pts_enc, view_enc, weights, g_d, g_rgb)
            a1, a3 = (fm.launch_k1(route, pts_enc, view_enc, weights),
                      fm.launch_k3(route, pts_enc, view_enc, packed))
            torch.cuda.synchronize()
            same &= all(torch.equal(a, b) for a, b in zip([*again[:2], *again[2]],
                                                          [*first[:2], *first[2]]))
            same &= all(torch.equal(a, b) for a, b in zip([*a1, *a3], [*f1, *f3]))
        del first, again, f1, f3, a1, a3
        phase("kernels", f"{tag}: {STRESS_LAUNCHES} more launches of K2, K1 and K3 at T=262144, "
                         f"{'each' if same else 'not each'} bit-identical to the first")
        if not same:
            failed.append(f"{tag}: a launch at T=262144 gave other bits than the first")
    bounds = kernel_bounds(meta, weights, 262144)
    plan = kernel_plan(meta, weights)
    peak = "bf16" if bf16 else "3xTF32"
    phase("kernels", f"{tag} median ms at T=262144 ({chain or '8x256'}, view_dep; {plan['what']}, "
          f"K2 workspace {plan['workspace_bytes']} bytes): "
          + " ".join(f"{k}={v:.3f}" for k, v in times.items()))
    phase("kernels", f"{tag} registers and spills: {plan['kernels']}")
    phase("kernels", f"{tag} bounds at T=262144: " + "; ".join(
        f"{k} {peak} {b['bound_ms']:.3f} ms ({b['bound_by']}, share "
        f"{b['bound_ms'] / times[k]:.3f}),"
        f" fp32 cores {b['bound_fp32_ms']:.3f} ms (share {b['bound_fp32_ms'] / times[k]:.3f})"
        for k, b in bounds.items()))
    del pts_enc, view_enc, g_d, g_rgb, packed
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"{tag} kernels disagree with their plain versions:\n"
                             + "\n".join(failed))
    return {"max_abs_err": worst, "flipped": flipped, "ms": times, "bounds": bounds,
            "plan": plan}


def route_chains():
    """(inside, past): MLPConfig fields of chains inside the kernels' domain
    (every layer up to 512 features, pts_enc and view_enc up to 128 wide) and
    just past it. Inside: L_3D 0-20 and L_view 0-20 at 8x256; trunk widths
    1-512 at 8 layers (skip 4) and head widths 1-512, with and without the
    view head. Past: L_3D 21 (pts_enc 129 wide), L_view 21, a 513-wide trunk
    or head, a 640-wide trunk."""
    widths = (1, 2, 7, 8, 9, 16, 17, 31, 32, 33, 40, 63, 64, 65, 96, 100, 104, 127, 128, 129,
              150, 160, 192, 200, 224, 255, 256, 257, 288, 289, 300, 320, 321, 384, 448, 500,
              511, 512)
    inside = [dict(L_3D=L) for L in range(21)] + [dict(L_view=L) for L in range(21)]
    for view_dep in (True, False):
        inside += [dict(layers_feat=(w,) * 8, view_dep=view_dep) for w in widths]
        inside += [dict(layers_rgb=(w, 3), view_dep=view_dep) for w in widths]
    inside += [dict(layers_feat=(512,) * 8, L_3D=20, L_view=20),
               dict(layers_feat=(512,) * 14, layers_rgb=(512, 3), skip=(2, 4, 8, 12), L_3D=20,
                    L_view=20)]
    past = [dict(L_3D=21), dict(L_view=21), dict(layers_feat=(513,) * 8),
            dict(layers_rgb=(513, 3)), dict(layers_feat=(640,) * 8),
            dict(layers_feat=(512,) * 8, L_3D=21, L_view=20)]
    return inside, past


def check_routes() -> dict:
    """routes: both C sizes entries (sparf_fused_mlp_sizes_tf32 and
    sparf_fused_mlp_wg_sizes) return 0 for every chain of route_chains'
    inside and a width code (-2, -4 or -7, whose message names
    use_pallas=False) for every chain past it; the float32 kernels on wgmma
    (sparf_fused_mlp_tf32wg_sizes) take the chains their mirror
    (fused_mlp.tf32wg_layout) takes and answer -7 to the rest; the op's
    route (fused_mlp.route) runs K1/K3 and K2 on wgmma at float32 exactly
    where the mirror takes the chain, and on every chain past the domain raises
    ValueError naming use_pallas=False in both dtypes; the plans taken,
    counted."""
    from sparf_tpu_torch.models import nerf_mlp
    from sparf_tpu_torch.ops import _build
    from sparf_tpu_torch.ops import fused_mlp as fm

    lib = _build.load_library()
    inside, past = route_chains()
    counts, failed = {}, []
    for kind, chains, ok in (("inside", inside, lambda rc: rc == 0),
                             ("past", past, lambda rc: rc in (-2, -4, -7))):
        for over in chains:
            dims = fm.chain_dims(nerf_mlp.MLPConfig(**over))
            c_dims = (ctypes.c_int * len(dims))(*dims)
            for name, fn, n in (("fp32", _build.entry(lib, "sizes"), 7),
                                ("bf16", _build.wg_entry(lib, "sizes"), 9)):
                sizes = (ctypes.c_int * n)()
                rc = fn(c_dims, sizes)
                if not ok(rc):
                    failed.append(f"{name} {over}: rc {rc}")
                key = f"{kind} {name} " + (f"{sizes[n - 1]}-point tiles" if rc == 0 else f"rc {rc}")
                counts[key] = counts.get(key, 0) + 1
            # the float32 kernels on wgmma: their C descriptor and its mirror pick the same chains
            sizes = (ctypes.c_int * 9)()
            rc = _build.tf32wg_entry(lib, "sizes")(c_dims, sizes)
            if rc not in (0, -7) or (rc == 0) != (fm.tf32wg_layout(tuple(dims)) is not None):
                failed.append(f"fp32 kernels on wgmma {over}: rc {rc}, tf32wg_layout "
                              f"{fm.tf32wg_layout(tuple(dims)) is not None}")
            key = f"{kind} fp32 K1/K2/K3 " + ("on wgmma" if rc == 0 else "on mma.sync")
            counts[key] = counts.get(key, 0) + 1
            # the route the op launches on: the kernels of K1, K2 and K3, or the
            # refusal before any launch
            for bf16 in (False, True):
                try:
                    impl = fm.route(tuple(dims), bf16).impl
                except ValueError as err:
                    impl = "refused" if "use_pallas=False" in str(err) else f"raised {err}"
                want = ("refused" if kind == "past" else "wg" if bf16
                        else "tf32" if fm.tf32wg_layout(tuple(dims)) is None else "tf32wg")
                if impl != want:
                    failed.append(f"route {over} bf16={bf16}: {impl}, not {want}")
    phase("routes", f"{len(inside)} chains inside the domain, {len(past)} past it, each in both "
                    f"dtypes: {counts}")
    if failed:
        raise AssertionError("routes: " + "; ".join(failed))
    return counts


def kernel_plan(meta, weights, T: int = 262144) -> dict:
    """Which plan of its dtype's kernels a chain takes (the C sizes entries:
    points per block; at float32 whether K2 runs on wgmma) and the bytes of
    K2's workspace at T points: every layer's input and g_z, float32
    (3xTF32) or bf16; each kernel's registers and spills (ptxas)."""
    from sparf_tpu_torch.ops import _build

    route = meta.route(weights)
    x_rows = -(-T // 128) * 128
    sizes, tf32wg = route.sizes, route.impl == "tf32wg"
    if meta.bf16:
        per_point = 2 * (sizes[4] + sizes[5])
    elif tf32wg:  # X and G, point-contiguous
        per_point = 4 * (sizes[4] + sizes[5])
    else:
        per_point = 4 * (sizes[3] + sizes[4])
    tile = (sizes if meta.bf16 else route.tf32_sizes)[-1]
    what = (f"{tile}-point tiles" + (", the warpgroups split the outputs" if meta.bf16 and tile == 64
                                     else "") + (", K1/K2/K3 on wgmma" if tf32wg else ""))
    if meta.bf16:
        names = [f"wg {k}_wg{'_n' if tile == 64 else ''}" for k in ("k1", "k2", "k3")]
    elif tf32wg:
        names = ["wg k1_tf", "wg k2_tf", "wg k2_dw_tf", "wg k3_tf"]
    else:
        names = [f"tf32 {k}{'_w' if tile == 64 else ''}"
                 for k in ("k1_forward", "k2_backward", "k3_forward")]
    return {"tile": tile, "workspace_bytes": x_rows * per_point, "what": what,
            "kernels": ptxas_summary(_build.BuildInfo.log, names)}


TINY_SPARF = dict(dryrun_configs.TINY_GT, env={})


def _merged(base: dict, over: dict) -> dict:
    """base with over's keys, nested dicts merged."""
    out = dict(base)
    for k, v in over.items():
        out[k] = _merged(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


class RecordingDraws:
    """Draws that also keep every array they hand out, for a replay elsewhere."""

    def __init__(self, draws):
        self.draws, self.recorded = draws, []

    def _keep(self, x):
        self.recorded.append(x.cpu().numpy())
        return x

    def uniform(self, shape):
        return self._keep(self.draws.uniform(shape))

    def randint(self, shape, low, high):
        return self._keep(self.draws.randint(shape, low, high))

    def normal(self, shape):
        return self._keep(self.draws.normal(shape))


# bf16 steps (the bf16-check): updated parameters are held where the CPU's
# gradient is at least BF16_KEEP_GRAD; a bf16 flip moves a gradient by up to
# ~1e-3 of its tensor's scale, and Adam's first step lr g / (|g| + eps) turns
# that into more than 1e-5 on an element whose |g| is ~1e-6 or less
# (tests/test_torch_bf16_trainer.py); the gradients themselves stay held.
BF16_KEEP_GRAD = 1e-5
BF16 = dict(tpu=dict(compute_dtype="bfloat16"))
# the presets' 8x256 MLP (skip at 4, 128-wide view head) with 12 point PE
# frequencies: pts_enc 75 wide, past the kernels' first plans (128-point
# tiles), so both dtypes run it in their wide plans (64-point tiles). The
# wide-check runs its step through the kernels and, with use_pallas=False,
# through nerf_mlp.nerf_apply in torch ops, card against CPU. At bf16 the
# card's step is held to the CPU's with its gradients within
# BF16_WIDE_GRAD_RTOL of scale, not 1e-3: at 8x256 two correct sum orders of
# the same bf16 chain (cuBLAS on the card, the CPU's BLAS) round enough
# products to another bf16 value to move a gradient by 5.2e-3 and 7.7e-3 of
# its scale (iterations 0 and 350 on the H100; 5.1e-3 to 6.3e-3 between two
# CPU orders, tests/bf16_sum_orders.py), where the 4x64 chain of the
# bf16-check moves by 1.7e-5. The wide-check's control, the card's step
# without the bf16 rounding (compute_dtype float32) against the CPU's bf16
# step, moves them by 9.8e-2 (H100; 7.0e-2 to 9.8e-2 on the CPU) and must
# miss the bound, which lies between the two (PERF.md). Loss and updated
# parameters keep the slice-check's bounds. PAST (posenc.L_3D=21: pts_enc
# 129 wide) lies past the kernels' domain: they refuse it before any launch.
WIDE = dict(arch=dict(layers_feat=[None] + [256] * 8, layers_rgb=[None, 128, 3], skip=[4],
                      posenc=dict(L_3D=12)))
PRESETS_8X256 = dict(arch=dict(WIDE["arch"], posenc=dict(L_3D=10)))
PAST = dict(arch=dict(WIDE["arch"], posenc=dict(L_3D=21)))
# The wide chain's step through the kernels, against the CPU's plain
# versions, at 8x256: 3xTF32 sums land further from the CPU's than cuBLAS's
# full-fp32 ones (use_pallas=False: gradients within 7.7e-7 of scale), and
# at this width that moves (a) ReLU masks whose pre-activation lies within
# that difference of 0, so a gradient tensor by up to 2.55e-3 of its scale
# (L_3D=12, iteration 350; the presets' own 8x256 chain, PRESETS_8X256,
# through the unchanged 128-point kernels, 8.35e-4, where the tiny chain's
# slice-check reads 1.9e-6), and (b) through Adam's first step
# lr g / (|g| + eps), the update of an element whose gradient cancels to
# |g| < 1e-5 by up to 9.5e-4 (both chains; 1e-5 is the slice-check's
# bound). So its gradients are held to WIDE_KERNELS_GRAD_RTOL, 4x the
# largest of those readings, and its parameters where |gradient| >=
# WIDE_KEEP_GRAD (BF16_KEEP_GRAD's rule; there both chains stay within 3e-8);
# loss keeps the slice-check's bound. PRESETS_8X256 runs beside it under the
# same bounds, its readings printed. Its control, the card at compute_dtype
# bfloat16 against the CPU's float32 step, moves a gradient by 9.7e-2 of its
# scale and must miss (H100; PERF.md, PR 12). At bf16 the kernels' step
# keeps BF16_WIDE_GRAD_RTOL.
WIDE_KERNELS_GRAD_RTOL = 1e-2
WIDE_KEEP_GRAD = 1e-5
PLAIN_MLP = dict(tpu=dict(use_pallas=False))
BF16_WIDE_GRAD_RTOL = 2e-2


class StepMismatch(AssertionError):
    """check_step_cuda_vs_cpu's failure, with the readings of the step that
    missed (`readings`: the worst loss error over its bound, the worst
    gradient error of scale, the worst parameter difference)."""

    def __init__(self, msg: str, readings: dict):
        super().__init__(msg)
        self.readings = readings


def check_step_cuda_vs_cpu(over=None, what: str = "slice-check", grad_rtol: float = 1e-3,
                           card_over=None, keep_grad: float = None) -> dict:
    """One step of the tiny sparf config (with `over`) on the card (kernels)
    and on the CPU (plain versions) from the same parameters and draws, in
    both stages. Losses within rtol 1e-4, gradients (Adam's first moment /
    0.1) within grad_rtol of each tensor's largest magnitude, updated
    parameters within 1e-5 where |gradient| >= keep_grad (bf16:
    BF16_KEEP_GRAD; else every parameter unless keep_grad is given);
    StepMismatch otherwise. The card's step launches K1 and K2 of its dtype,
    and under use_pallas=False (nerf_mlp.nerf_apply on both devices) no
    kernel. `card_over`: options of the card's trainer alone (the
    wide-check's control). Returns the readings per iteration."""
    import dataclasses

    import torch

    from sparf_tpu_torch.ops import fused_mlp as fm
    from sparf_tpu_torch.training import engine
    from sparf_tpu_torch.training.define_trainer import build_config, define_trainer
    from sparf_tpu_torch.utils.draws import Draws, ReplayDraws

    def trainer_on(device, extra=None):
        cfg = build_config("joint_pose_nerf_training/synthetic", "sparf",
                           _merged(_merged(TINY_SPARF, over or {}), extra or {}))
        return define_trainer(cfg, workspace=tempfile.mkdtemp(prefix="sparf_torch_tiny_"),
                              device=device, save_option=False)

    cpu, gpu = trainer_on("cpu"), trainer_on("cuda", card_over)
    bf16 = cpu.render_cfg.mlp.compute_dtype == torch.bfloat16
    card_bf16 = gpu.render_cfg.mlp.compute_dtype == torch.bfloat16
    keep_grad = BF16_KEEP_GRAD if bf16 and keep_grad is None else keep_grad
    impl = gpu.render_cfg.mlp_impl
    if cpu.render_cfg.mlp_impl != impl:
        raise AssertionError(f"{what}: MLP {impl} on the card, {cpu.render_cfg.mlp_impl} on "
                             f"the CPU")
    readings = {}
    for it in (0, 350):
        st_c = dataclasses.replace(cpu.state, iteration=it, iteration_nerf=it)
        st_g = dataclasses.replace(
            gpu.state, iteration=it, iteration_nerf=it,
            nerf_params=engine.tree_unflatten(
                cpu.state.nerf_params,
                [x.cuda() for x in engine.tree_leaves(cpu.state.nerf_params)]),
            pose_params={k: v.cuda() for k, v in cpu.state.pose_params.items()})
        rec = RecordingDraws(Draws(it, "cpu"))
        new_c, stats_c = cpu.get_step(it)(st_c, rec)
        fm.reset_launch_counts()
        new_g, stats_g = gpu.get_step(it)(st_g, ReplayDraws(rec.recorded, "cuda"))
        launches = (fm.launch_counts(card_bf16), fm.launch_counts(not card_bf16))
        if impl == "plain":
            bad = any(launches[0].values())
        else:
            bad = 0 in (launches[0]["K1"], launches[0]["K2"])
        if bad or any(launches[1].values()):
            raise AssertionError(f"step at {it}: launches of the {'bf16' if card_bf16 else 'fp32'} "
                                 f"variants {launches[0]}, of the other {launches[1]}")
        failed, worst_l = [], 0.0
        for k, v in stats_c.items():
            a, b = float(stats_g[k]), float(v)
            worst_l = max(worst_l, abs(a - b) / (1e-6 + 1e-4 * abs(b)))
            if not abs(a - b) <= 1e-6 + 1e-4 * abs(b):
                failed.append(f"{k} cuda {a} vs cpu {b}")
        pairs = list(zip(new_g.opt_state_nerf.mu, new_c.opt_state_nerf.mu))
        if new_c.opt_state_pose is not None:
            pairs += list(zip(new_g.opt_state_pose.mu, new_c.opt_state_pose.mu))
        worst_g = max(rel_err(a.cpu(), b)[1] for a, b in pairs)
        if not worst_g <= grad_rtol:
            failed.append(f"a gradient off by {worst_g:.3g} of its scale (bound {grad_rtol})")
        grads = list(new_c.opt_state_nerf.mu) + (
            list(new_c.opt_state_pose.mu) if new_c.opt_state_pose is not None
            else [None] * len(new_c.pose_params))
        held, worst_p, worst_all = 1.0, 0.0, 0.0
        for a, b, g in zip(engine.tree_leaves(new_g.nerf_params) + list(new_g.pose_params.values()),
                           engine.tree_leaves(new_c.nerf_params) + list(new_c.pose_params.values()),
                           grads):
            keep = (g / 0.1).abs() >= keep_grad if keep_grad is not None and g is not None else None
            diff = (a.cpu() - b).abs()
            worst_all = max(worst_all, float(diff.max()) if diff.numel() else 0.0)
            if keep is not None:
                held = min(held, float(keep.float().mean()))
                diff = diff[keep]
            worst_p = max(worst_p, float(diff.max()) if diff.numel() else 0.0)
        if not worst_p <= 1e-5:
            failed.append(f"updated parameters differ by {worst_p:.3g}")
        readings[it] = dict(loss_over_bound=worst_l, grad=worst_g, params=worst_p,
                            params_all=worst_all)
        if failed:
            raise StepMismatch(f"{what}: step at {it}: " + "; ".join(failed), readings[it])
        phase(what, f"tiny sparf step at iteration {it}: cuda "
                    f"({'kernels' if impl == 'fused' else 'use_pallas=False, torch ops'}) "
                    f"matches cpu ({'plain versions' if impl == 'fused' else 'torch ops'}), "
                    f"loss all={float(stats_g['all']):.6g}, gradients within {worst_g:.3g} of "
                    f"scale, parameters within {worst_p:.3g}, launches "
                    f"{launches[0]}" + (f"; parameters held where |g| >= {keep_grad} "
                                        f"(at least {held:.3f} of each tensor; over all of "
                                        f"them {worst_all:.3g}), loss {worst_l:.3g} of its "
                                        f"bound" if keep_grad is not None else ""))
    return readings


def check_wide_refused(over=None) -> str:
    """A chain past the kernels' domain (PAST) with the kernels
    (use_pallas=True) on the card: its step raises ValueError naming the
    kernels' width limit and use_pallas=False, before any launch (the C
    sizes entries refuse it)."""
    import dataclasses

    from sparf_tpu_torch.ops import fused_mlp as fm
    from sparf_tpu_torch.training.define_trainer import build_config, define_trainer
    from sparf_tpu_torch.utils.draws import Draws

    cfg = build_config("joint_pose_nerf_training/synthetic", "sparf",
                       _merged(_merged(TINY_SPARF, PAST), over or {}))
    gpu = define_trainer(cfg, workspace=tempfile.mkdtemp(prefix="sparf_torch_tiny_"),
                         device="cuda", save_option=False)
    fm.reset_launch_counts()
    try:
        gpu.get_step(0)(dataclasses.replace(gpu.state, iteration=0, iteration_nerf=0),
                        Draws(0, "cuda"))
    except ValueError as err:
        counts = fm.launch_counts(), fm.launch_counts(True)
        if "use_pallas=False" not in str(err) or any(v for c in counts for v in c.values()):
            raise AssertionError(f"wide chain refused with {err!r}, launches {counts}") from err
        return str(err)
    raise AssertionError("the kernels ran a chain past their widths")


def _must_miss(tag: str, over, what: str, grad_rtol: float, card_over, **kw) -> dict:
    """A control step (check_step_cuda_vs_cpu with the card's own options)
    that must come out not correct on its gradients; its readings."""
    try:
        check_step_cuda_vs_cpu(over, what, grad_rtol=grad_rtol, card_over=card_over, **kw)
    except StepMismatch as err:
        if not err.readings["grad"] > grad_rtol:
            raise AssertionError(f"{what} missed, but its gradients are within {grad_rtol}: "
                                 f"{err}") from err
        phase(tag, f"{what} comes out not correct, as it must: {err}")
        return err.readings
    raise AssertionError(f"{what}: a step that must miss met the bounds")


def check_wide(bf16: bool) -> dict:
    """wide-check: the wide chain's step through the kernels (their wide
    plans; fp32 with its control, which must miss: see WIDE_KERNELS_GRAD_RTOL),
    then with use_pallas=False, card against CPU (at bf16 the gradients
    within BF16_WIDE_GRAD_RTOL, then the control, which must miss that
    bound); the kernels refuse a chain past their domain (PAST)."""
    dtype = BF16 if bf16 else {}
    tag = "wide-check" + (" bf16" if bf16 else "")
    refused = check_wide_refused(dtype)
    phase(tag, f"past the domain (posenc.L_3D=21, use_pallas=True): {refused}")
    rtol = BF16_WIDE_GRAD_RTOL if bf16 else 1e-3
    k_rtol = BF16_WIDE_GRAD_RTOL if bf16 else WIDE_KERNELS_GRAD_RTOL
    out = {"kernels": check_step_cuda_vs_cpu(_merged(WIDE, dtype), tag + " kernels",
                                             grad_rtol=k_rtol, keep_grad=WIDE_KEEP_GRAD)}
    if not bf16:
        # the same bounds on the presets' 8x256 chain (the unchanged 128-point kernels)
        out["presets_8x256"] = check_step_cuda_vs_cpu(
            PRESETS_8X256, tag + " kernels, the presets' 8x256 chain (L_3D=10)", grad_rtol=k_rtol,
            keep_grad=WIDE_KEEP_GRAD)
        out["kernels_control"] = _must_miss(tag, WIDE, tag + " kernels control (the card at bf16)",
                                            k_rtol, BF16, keep_grad=WIDE_KEEP_GRAD)
    out["readings"] = check_step_cuda_vs_cpu(_merged(_merged(WIDE, PLAIN_MLP), dtype), tag,
                                             grad_rtol=rtol)
    if bf16:
        out["control"] = _must_miss(tag, _merged(_merged(WIDE, PLAIN_MLP), BF16),
                                    tag + " control (the card without bf16 rounding)", rtol,
                                    dict(tpu=dict(compute_dtype="float32")))
    return out


# Tiny config of the eval-check: 4 point and 2 view PE frequencies instead of
# 10 and 4, because at 10 the pose-twist gradient of the refinement is
# ill-conditioned in float32 (a 1e-7 change of the pose moves it by ~5%;
# tests/test_torch_eval.py), so no two float32 implementations agree on it.
TINY_EVAL = dict(TINY_SPARF, optim=dict(test_photo=True, test_iter=5),
                 arch=dict(TINY_SPARF["arch"], posenc=dict(L_3D=4, L_view=2)))
# tolerances of the eval-check, absolute: PSNR in dB; the rotation that the
# refinement made, in degrees (an arccos of a trace near 3, where float32
# rounding of the rotation moves the angle by ~1e-3 deg); the other metrics;
# the refined twists
EVAL_TOL = {"psnr": 1e-3, "deg": 1e-2, "other": 1e-4, "twist": 1e-4}


def check_eval_cuda_vs_cpu() -> None:
    """evaluate_full (with test-time refinement) of the tiny config on the card
    against the CPU, from the same state and pixel draws, with cuDNN's TF32 at
    PyTorch's default: the metrics must switch it off themselves. Then a
    snapshot saved on the card must load on the CPU with the same bits."""
    import dataclasses

    import torch

    from sparf_tpu_torch.training import checkpointing, engine
    from sparf_tpu_torch.training.define_trainer import build_config, define_trainer
    from sparf_tpu_torch.utils.draws import ReplayDraws

    def trainer_on(device):
        cfg = build_config("joint_pose_nerf_training/synthetic", "sparf", TINY_EVAL)
        return define_trainer(cfg, workspace=tempfile.mkdtemp(prefix="sparf_torch_eval_"),
                              device=device, save_option=False)

    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default
    cpu, gpu = trainer_on("cpu"), trainer_on("cuda")
    it = 350  # fine sampling on
    cpu.state = dataclasses.replace(cpu.state, iteration=it, iteration_nerf=it)
    gpu.state = dataclasses.replace(
        cpu.state, nerf_params=engine.tree_unflatten(
            cpu.state.nerf_params, [x.cuda() for x in engine.tree_leaves(cpu.state.nerf_params)]),
        pose_params={k: v.cuda() for k, v in cpu.state.pose_params.items()},
        opt_state_nerf=gpu.state.opt_state_nerf, opt_state_pose=gpu.state.opt_state_pose,
        nan_count=gpu.state.nan_count)

    # the CPU run records its pixel draws, the card replays them
    recorded = {}
    make_draws = cpu.test_optim_draws

    def cpu_draws(idx):
        recorded[idx] = RecordingDraws(make_draws(idx))
        return recorded[idx]

    cpu.test_optim_draws = cpu_draws
    gpu.test_optim_draws = lambda idx: ReplayDraws(recorded[idx].recorded, "cuda")
    twists = {"cpu": [], "card": []}

    def keep_twists(tr, out):
        refine = tr.run_test_time_photometric_optim

        def call(*a):
            out.append(refine(*a))
            return out[-1]

        tr.run_test_time_photometric_optim = call

    keep_twists(cpu, twists["cpu"])
    keep_twists(gpu, twists["card"])
    res = {"cpu": cpu.evaluate_full(out_dir=cpu.workspace, with_test_optim=True),
           "card": gpu.evaluate_full(out_dir=gpu.workspace, with_test_optim=True)}
    worst = dict.fromkeys(EVAL_TOL, 0.0)
    for pc, pg in zip(res["cpu"]["per_image"], res["card"]["per_image"]):
        for k, v in pc.items():
            kind = ("psnr" if k.startswith("psnr") or k == "refine_psnr_delta"
                    else "deg" if k.endswith("_deg") else "other")
            worst[kind] = max(worst[kind], abs(pg[k] - v))
    for tc, tg in zip(twists["cpu"], twists["card"]):
        worst["twist"] = max(worst["twist"], float((tg.cpu() - tc).abs().max()))
    if not twists["cpu"] or any(not worst[k] <= EVAL_TOL[k] for k in worst):
        raise AssertionError(f"eval cuda vs cpu: worst differences {worst} > {EVAL_TOL}")

    gpu.save_snapshot()
    loaded, _ = checkpointing.load_snapshot(gpu.workspace, cpu.state, "latest")
    pairs = list(zip(engine.tree_leaves(loaded.nerf_params) + list(loaded.pose_params.values()),
                     engine.tree_leaves(gpu.state.nerf_params)
                     + list(gpu.state.pose_params.values())))
    if not all(a.device.type == "cpu" and torch.equal(a, b.cpu()) for a, b in pairs):
        raise AssertionError("a snapshot saved on the card did not load on the CPU bit for bit")
    m = res["card"]["per_image"][0]
    phase("eval-check", f"cuDNN TF32 on (PyTorch default): evaluate_full on cuda matches cpu "
                        f"with test-time refinement ({len(twists['card'])} view, "
                        f"{int(cpu.cfg.optim.test_iter)} steps), worst |diff| psnr "
                        f"{worst['psnr']:.3g} dB, refinement angle {worst['deg']:.3g} deg, "
                        f"other metrics {worst['other']:.3g}, twist {worst['twist']:.3g} "
                        f"(psnr={m['psnr']:.4f} ssim={m['ssim']:.4f} "
                        f"lpips={m['lpips']:.4f}); snapshot saved on cuda loads on cpu "
                        f"bit-identical ({len(pairs)} tensors)")


# the matchers' card and its CPU counterpart in the matcher-check
CARD = "cuda"
DEVICES = {"card": CARD, "cpu": "cpu"}
# tolerances of the matcher-check (card with TF32 on against the CPU; the
# matchers switch TF32 off themselves): PDC-Net's /2 mapping in px and its
# p_r, and the same after the full-size resize (correspondences in px, p_r)
# of compute_pdcnet_flow_of_combi_list; the share of RANSAC inliers and SPSG matched pixels on which the two
# devices agree; for ZNCC stage 1 the share of confident pixels (conf > 0.5
# on either device) matched within 1e-3 px on both, and the share of pixels
# on which the pool masks (conf >= 0.95) agree. ZNCC's argmax flips between
# near-equal scores under another summation order, and on this scene's
# texture-less regions a flip at a coarse level carries down the pyramid;
# those pixels score low and leave the pools, so the share of all pixels
# matched elsewhere is reported, not bounded (0.0426 on an H100 against this
# CPU code, where 0.0111 of the 1.4% confident pixels moved; the ZNCC bound
# below was set from that reading, the pool-mask bound before it).
MATCHER_TOL = {"mapping_px": 1e-2, "p_r": 1e-3, "corres_px": 2e-2, "p_r_full": 1e-3,
               "ransac_agreement": 0.99,
               "spsg_agreement": 0.99, "zncc_agreement": 0.98, "zncc_pool_agreement": 0.999}
FULL_SCENE = dict(dryrun_configs.FULL_SCENE, env={})
MATCHER_POOLS = dict(FULL_SCENE, use_gt_correspondences=False, min_nbr_matches=100)
# tolerances of the geometry check (card with TF32 on against the CPU): the
# share of pixels whose best hypothesis agrees in pass 1 of _geom_rematch_pair
# (over all pixels) and in pass 2 (over the pixels where pass 1 agrees, so
# that both start from the same depth), near-ties excused only within
# NEAR_TIE; where both agree, coordinates within 1e-3 px on at least 0.995 of
# the pixels and within 1e-2 px on all (a subpixel vertex on a flat peak
# moves with the scores' rounding); the solvers' inlier agreement (float64 on
# both devices, the same generator seed).
GEOM_TOL = {"pass1_agreement": 0.999, "pass2_agreement": 0.999, "corres_px": 1e-3,
            "corres_px_share": 0.995, "corres_px_all": 1e-2, "solver_agreement": 1.0}
NEAR_TIE = 2e-4
# zncc with the geometry stage, from the same prior (cfg.seed 0, 24.781 deg):
# the JAX package's internal poses end at 37.884 deg (tests/geometry_reference.py
# jax --backend zncc, on the CPU), worse than the prior in both packages: stage
# 1's ZNCC seeds are too few on the texture-less spheres. The port is held
# within ZNCC_MARGIN_DEG of that reading.
ZNCC_JAX_DEG = 37.884
ZNCC_MARGIN_DEG = 5.0


def full_scene():
    from sparf_tpu_torch.datasets import create_dataset
    from sparf_tpu_torch.training.define_trainer import build_config

    return create_dataset(build_config("joint_pose_nerf_training/synthetic", "sparf",
                                       FULL_SCENE), "train")


def check_matchers_cuda_vs_cpu(scene) -> dict:
    """The matchers on the card (TF32 on globally) against the CPU, on the
    300x400 scene."""
    import numpy as np
    import torch

    from sparf_tpu_torch.models import flow_net, pdcnet, sparse_matcher
    from sparf_tpu_torch.utils import imgproc

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    imgs = np.asarray(scene["image"])
    pair = np.array([[0], [1]], np.int32)
    out = {}

    gpu, cpu = (pdcnet.load_weights_npz(pdcnet.BUNDLED_WEIGHTS, d) for d in (CARD, "cpu"))
    t_img, s_img = torch.as_tensor(imgs[:1]), torch.as_tensor(imgs[1:2])
    with torch.no_grad():
        og, oc = gpu(t_img.to(CARD), s_img.to(CARD)), cpu(t_img, s_img)
        out["pdcnet_forward_ms"] = median_ms(lambda: gpu(t_img.to(CARD), s_img.to(CARD)))
    out["mapping_px"] = float((og["mapping"].cpu() - oc["mapping"]).abs().max())
    out["p_r"] = float((og["p_r"].cpu() - oc["p_r"]).abs().max())

    flows = {k: pdcnet.compute_pdcnet_flow_of_combi_list(imgs, pair, model=m, device=d)
             for (k, d), m in zip(DEVICES.items(), (gpu, cpu))}
    corres, conf = flows["card"]
    out["corres_px"] = float(np.abs(corres - flows["cpu"][0]).max())
    out["p_r_full"] = float(np.abs(conf - flows["cpu"][1]).max())
    mask = flow_net.get_mask_valid_from_conf_map(conf, corres, 0.95)[0, 0]
    ys, xs = np.where(mask)
    pts1 = np.stack([xs, ys], -1).astype(np.float64)
    pts2 = corres[0, :, ys, xs].astype(np.float64)
    masks, secs = {}, {}
    for key, dev in DEVICES.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, masks[key] = imgproc.find_fundamental_ransac(
            pts1, pts2, 1.0, 0.999, generator=torch.Generator().manual_seed(0), device=dev)
        secs[key] = time.perf_counter() - t0
    out["ransac_agreement"] = float((masks["card"] == masks["cpu"]).mean())
    out["ransac_points"], out["ransac_inliers"] = len(pts1), int(masks["card"].sum())
    out["ransac_s"] = secs["card"]

    combi = flow_net.get_combi_list(3, "all")[:, :2]
    sp = {k: sparse_matcher.compute_spsg_flow_of_combi_list(imgs, combi, device=d)
          for k, d in DEVICES.items()}
    m_g, m_c = sp["card"][1] > 0, sp["cpu"][1] > 0
    out["spsg_agreement"] = float((m_g & m_c).sum() / max(int((m_g | m_c).sum()), 1))
    out["spsg_matches"] = int(m_g.sum())
    both = np.broadcast_to(m_g & m_c, sp["cpu"][0].shape)
    out["spsg_corres_px"] = float(np.abs(sp["card"][0] - sp["cpu"][0])[both].max(initial=0.0))

    zn = {k: flow_net.compute_zncc_flow_of_combi_list(imgs, pair, device=d)
          for k, d in DEVICES.items()}
    moved = np.linalg.norm(zn["card"][0] - zn["cpu"][0], axis=1) > 1e-3
    confident = (zn["card"][1][:, 0] > 0.5) | (zn["cpu"][1][:, 0] > 0.5)
    out["zncc_moved_all"] = float(moved.mean())
    out["zncc_confident_share"] = float(confident.mean())
    out["zncc_agreement"] = 1.0 - float(moved[confident].mean())
    out["zncc_pool_agreement"] = float(((zn["card"][1] >= 0.95) == (zn["cpu"][1] >= 0.95)).mean())

    bad = [k for k in ("mapping_px", "p_r", "corres_px", "p_r_full")
           if not out[k] <= MATCHER_TOL[k]]
    bad += [k for k in ("ransac_agreement", "spsg_agreement", "zncc_agreement",
                        "zncc_pool_agreement") if not out[k] >= MATCHER_TOL[k]]
    phase("matcher-check", f"TF32 on: PDC-Net forward (bundled weights, pair 0-1 at 300x400) "
                           f"max |d mapping| {out['mapping_px']:.3g} px, max |d p_r| "
                           f"{out['p_r']:.3g}, {out['pdcnet_forward_ms']:.3f} ms on the card; "
                           f"full-size flows max |d corres| {out['corres_px']:.3g} px, max "
                           f"|d p_r| {out['p_r_full']:.3g}; "
                           f"RANSAC on {out['ransac_points']} confident matches: inlier "
                           f"agreement {out['ransac_agreement']:.5f} ({out['ransac_inliers']} "
                           f"inliers, {secs['card']:.3f} s card, {secs['cpu']:.3f} s cpu); SPSG "
                           f"matched-pixel agreement {out['spsg_agreement']:.4f} "
                           f"({out['spsg_matches']} matches in 2 pairs, corres "
                           f"{out['spsg_corres_px']:.3g} px); ZNCC stage 1 (pair 0-1 both ways): "
                           f"{out['zncc_moved_all']:.5f} of all pixels matched elsewhere, "
                           f"agreement {out['zncc_agreement']:.5f} on the "
                           f"{out['zncc_confident_share']:.4f} with conf > 0.5, pool masks "
                           f"(conf >= 0.95) agree on {out['zncc_pool_agreement']:.5f}")
    if bad:
        raise AssertionError(f"matcher-check: {bad} outside {MATCHER_TOL}: {out}")
    return out


def mean_rel_rot_deg(poses, gt) -> float:
    """Mean over view pairs of the angle between estimated and GT relative
    rotations (alignment-free)."""
    import numpy as np

    errs = []
    for a in range(len(gt)):
        for b in range(a + 1, len(gt)):
            Rg = gt[b][:3, :3] @ gt[a][:3, :3].T
            Re = poses[b][:3, :3] @ poses[a][:3, :3].T
            errs.append(np.degrees(np.arccos(np.clip((np.trace(Rg.T @ Re) - 1) / 2, -1, 1))))
    return float(np.mean(errs))


def check_geometry_cuda_vs_cpu(scene) -> dict:
    """The geometry stage's pieces on the card (TF32 on globally) against the
    CPU on the 300x400 scene: _geom_rematch_pair for pair 0 -> 1 at the GT
    relative pose and view 0's GT depths (7x7 windows, as the full-resolution
    rematch), with the score volumes of both passes captured from the call;
    then the two-view and PnP solvers on GT matches of that pair (0.5 px
    noise, 30% outliers) with one generator seed on both devices."""
    import numpy as np
    import torch

    from sparf_tpu_torch.models import flow_net as ft
    from sparf_tpu_torch.utils import geometry, imgproc

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    K = np.asarray(scene["intr"], np.float64)
    T01 = geometry.relative_transform_i_to_j(torch.as_tensor(scene["pose"][0]),
                                             torch.as_tensor(scene["pose"][1])).numpy()
    R, t = T01[:3, :3].astype(np.float64), T01[:3, 3].astype(np.float64)
    valid = np.asarray(scene["valid_depth_gt"][0]) > 0
    depths = np.asarray(scene["depth_gt"][0])[valid].astype(np.float64)
    volumes = {}
    plane, local = ft._plane_sweep_scores, ft._local_sweep_scores

    def keep(name, fn):
        def call(*a):
            out = fn(*a)
            volumes[name] = out
            return out
        return call

    res, secs = {}, {}
    for key, dev in DEVICES.items():
        imgs = torch.as_tensor(np.asarray(scene["image"][:2]), dtype=torch.float32, device=dev)
        ft._plane_sweep_scores, ft._local_sweep_scores = keep("pass1", plane), keep("pass2", local)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res[key] = [x.cpu() for x in ft._geom_rematch_pair(imgs[0], imgs[1], K[0], K[1], R, t,
                                                               depths, radius=3)]
            secs[key] = time.perf_counter() - t0
        finally:
            ft._plane_sweep_scores, ft._local_sweep_scores = plane, local
        volumes[key] = {k: volumes.pop(k).cpu() for k in ("pass1", "pass2")}
    out = {"rematch_s": secs["card"], "rematch_cpu_s": secs["cpu"],
           "hypotheses": [int(volumes["cpu"][k].shape[0]) for k in ("pass1", "pass2")]}
    agree = None
    for name in ("pass1", "pass2"):
        vg, vc = volumes["card"][name], volumes["cpu"][name]
        bg, bc = vg.argmax(0), vc.argmax(0)
        same = bg == bc
        gap = (vc.gather(0, bg[None])[0] - vc.gather(0, bc[None])[0]).abs()[~same]
        out[f"{name}_score_diff"] = float((vg - vc).abs().max())
        scope = same if agree is None else same[agree]
        out[f"{name}_agreement"] = float(scope.float().mean())
        out[f"{name}_largest_gap"] = float(gap.max()) if gap.numel() else 0.0
        out[f"{name}_far_flips"] = int((gap > NEAR_TIE).sum())
        agree = same if agree is None else agree & same
    d = (res["card"][0] - res["cpu"][0]).norm(dim=-1)[agree]
    out["corres_px_max"] = float(d.max())
    out["corres_px_share"] = float((d <= GEOM_TOL["corres_px"]).float().mean())
    out["score_diff"] = float((res["card"][1] - res["cpu"][1]).abs()[agree].max())

    # the solvers: GT matches of pair 0 -> 1, 0.5 px noise, 30% outliers
    rng = np.random.RandomState(0)
    gt, gt_valid = ft.gt_correspondences_for_pair(scene, 0, 1)
    ys, xs = np.where(gt_valid & valid)
    pick = rng.choice(len(ys), size=min(2000, len(ys)), replace=False)
    ys, xs = ys[pick], xs[pick]
    x1 = np.stack([xs, ys], -1).astype(np.float64) + rng.randn(len(ys), 2) * 0.5
    x2 = gt[:, ys, xs].T.astype(np.float64) + rng.randn(len(ys), 2) * 0.5
    bad = rng.rand(len(ys)) < 0.3
    x2[bad] = rng.uniform([0, 0], [scene["image"].shape[-1], scene["image"].shape[-2]],
                          (int(bad.sum()), 2))
    z = np.asarray(scene["depth_gt"][0])[ys, xs].astype(np.float64)
    X0 = np.c_[(np.stack([xs, ys], -1) - K[0][:2, 2]) / K[0][0, 0], np.ones(len(ys))] * z[:, None]
    def run_solvers(dev):
        """Each solver once on `dev`, with its seconds."""
        secs = {}

        def clocked(name, fn, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            secs[name] = time.perf_counter() - t0
            return out

        E, mask = clocked("essential", imgproc.find_essential_ransac, x1, x2, K[0], 1.5, 0.999,
                          generator=torch.Generator().manual_seed(0), device=dev)
        _, Re, _, front = clocked("recover_pose", imgproc.recover_pose, E, x1, x2, K[0], mask,
                                  device=dev)
        _, rvec, _, inl = clocked("pnp", imgproc.solve_pnp_ransac, X0, x2, K[1], reproj_err=4.0,
                                  iters=200, generator=torch.Generator().manual_seed(0),
                                  device=dev)
        Xh = clocked("triangulate", imgproc.triangulate_points, K[0] @ np.eye(3, 4),
                     K[1] @ np.c_[R, t], x1.T, x2.T, device=dev)
        pnp_mask = np.zeros(len(ys), bool)
        pnp_mask[inl[:, 0]] = True
        return dict(mask=mask, front=front, pnp=pnp_mask, Re=Re, rvec=rvec, X=Xh), secs

    # the card twice: its first call pays the solver libraries' set-up
    solved, ssecs = {}, {}
    _, ssecs["card_first"] = run_solvers(CARD)
    for key, dev in DEVICES.items():
        solved[key], ssecs[key] = run_solvers(dev)
    g, c = solved["card"], solved["cpu"]
    out["solver_agreement"] = min(float((g[k] == c[k]).mean()) for k in ("mask", "front", "pnp"))
    out["solver_points"], out["essential_inliers"] = len(ys), int(g["mask"].sum())
    out["pnp_inliers"] = int(g["pnp"].sum())
    out["essential_rot_err_deg"] = mean_rel_rot_deg([np.eye(4), np.c_[g["Re"], np.zeros(3)]],
                                                    [np.eye(4), np.c_[R, t]])
    out["solver_s"] = ssecs
    out["triangulation_rel"] = float(np.abs(g["X"][:3] / g["X"][3] - c["X"][:3] / c["X"][3]).max()
                                     / np.abs(c["X"][:3] / c["X"][3]).max())
    bad = [k for k in ("pass1_agreement", "pass2_agreement", "solver_agreement")
           if not out[k] >= GEOM_TOL[k]]
    bad += [k for k in ("pass1_far_flips", "pass2_far_flips") if out[k]]
    if not (out["corres_px_share"] >= GEOM_TOL["corres_px_share"]
            and out["corres_px_max"] <= GEOM_TOL["corres_px_all"]):
        bad.append("corres_px")
    phase("matcher-check", f"TF32 on: _geom_rematch_pair 0 -> 1 at the GT pose (radius 3, "
                           f"{out['hypotheses'][0]} + {out['hypotheses'][1]} hypotheses): "
                           f"best hypothesis agrees on {out['pass1_agreement']:.5f} (pass 1) "
                           f"and {out['pass2_agreement']:.5f} (pass 2) of the pixels, largest "
                           f"score gap of a flip {max(out['pass1_largest_gap'], out['pass2_largest_gap']):.3g}, "
                           f"score volumes within {max(out['pass1_score_diff'], out['pass2_score_diff']):.3g}; "
                           f"where both agree corres within {GEOM_TOL['corres_px']} px on "
                           f"{out['corres_px_share']:.5f} (largest {out['corres_px_max']:.3g} px), "
                           f"scores within {out['score_diff']:.3g}; {secs['card']:.3f} s card, "
                           f"{secs['cpu']:.3f} s cpu")
    phase("matcher-check", f"solvers on {out['solver_points']} GT matches of pair 0 -> 1 (0.5 px "
                           f"noise, 30% outliers), seed 0: essential RANSAC "
                           f"{out['essential_inliers']} inliers, {out['essential_rot_err_deg']:.4f} "
                           f"deg off GT; PnP {out['pnp_inliers']} inliers; inlier agreement card "
                           f"vs cpu {out['solver_agreement']:.5f}; triangulation within "
                           f"{out['triangulation_rel']:.3g} relative; seconds "
                           + "; ".join(f"{k}: " + ", ".join(f"{n} {v:.3f}" for n, v in d.items())
                                       for k, d in ssecs.items()))
    if bad:
        raise AssertionError(f"matcher-check (geometry): {bad} outside {GEOM_TOL}: {out}")
    return out


def geometry_prior(cfg, scene):
    """The joint trainer's initial poses (noisy_gt at cfg.camera.noise), which
    it hands the matcher as its prior."""
    import numpy as np

    from sparf_tpu_torch.training.joint_trainer import noisy_gt_poses

    return noisy_gt_poses(cfg, np.asarray(scene["pose"])).astype(np.float32)


def describe_geometry(pools, scene, prior) -> dict:
    """The geometry stage's report of a pool build, with the internal poses'
    mean relative rotation error against GT next to the prior's."""
    import numpy as np

    geom = pools.get("geom") or {}
    gt = np.asarray(scene["pose"], np.float64)
    out = {"route": geom.get("route"), "output": geom.get("output"),
           "bootstrap": geom.get("bootstrap"), "seconds": dict(geom.get("seconds", {})),
           "rounds": [dict(r) for r in geom.get("rounds", [])],
           "prior_rot_err_deg": mean_rel_rot_deg(np.asarray(prior, np.float64), gt)}
    if "poses_w2c" in geom:
        out["internal_rot_err_deg"] = mean_rel_rot_deg(np.asarray(geom["poses_w2c"]), gt)
    return out


def run_matcher_phase(scene, adapt_steps: int = 20) -> dict:
    """The full correspondence precompute on the card for raw PDC-Net and SPSG,
    then the rate of self_supervised_adapt."""
    import torch

    from sparf_tpu_torch.models import pdcnet
    from sparf_tpu_torch.training.define_trainer import build_config
    from sparf_tpu_torch.training.losses import corres
    from sparf_tpu_torch.utils.draws import Draws

    out = {}
    # raw PDC-Net, SPSG, then the geometry stage: the presets' default (PDC-Net
    # seeds) and zncc, both from the trainer's noisy initial poses as prior
    routes = (("PDCNet_raw", dict(flow_backbone="PDCNet", pdcnet_geometry_refine=False)),
              ("SPSG", dict(flow_backbone="SPSG")),
              ("PDCNet_geometry", dict(flow_backbone="PDCNet")),
              ("zncc_geometry", dict(flow_backbone="zncc")))
    for name, over in routes:
        cfg = build_config("joint_pose_nerf_training/synthetic", "sparf",
                           dict(MATCHER_POOLS, **over))
        prior = geometry_prior(cfg, scene) if name.endswith("_geometry") else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pools = corres.build_correspondence_pools(cfg, scene, init_poses_w2c=prior, device=CARD)
        total = time.perf_counter() - t0
        quality = corres.compute_flow_metrics(pools, scene)
        counts = [int(c) for c in pools.get("pool_count", [])]
        out[name] = {"seconds": dict(pools["seconds"], total=total),
                     "pairs_kept": int(pools["n_pairs"]), "pool_sizes": counts,
                     "flow_quality": quality}
        phase("matcher", f"{name} -> {pools['backend']}: {total:.3f} s for 6 ordered pairs ("
                         + ", ".join(f"{k} {v:.3f} s" for k, v in pools["seconds"].items())
                         + f"); {pools['n_pairs']} pairs kept (> {cfg.min_nbr_matches} px), pool "
                         f"sizes {counts}; vs GT: "
                         + " ".join(f"{k}={v:.4f}" for k, v in sorted(quality.items())))
        if prior is not None:
            g = out[name]["geometry"] = describe_geometry(pools, scene, prior)
            phase("matcher", f"{name} geometry stage: {g['route']}, bootstrap {g['bootstrap']}, "
                             f"output {g['output']}; rounds "
                             + "; ".join(f"{r['round']}: {r['winner']} score "
                                         f"{'-' if r['score'] is None else format(r['score'], '.4f')}"
                                         f" {r['views']} views {r['seconds']:.2f} s"
                                         for r in g["rounds"])
                             + "; seconds " + ", ".join(f"{k} {v:.3f}" for k, v in g["seconds"].items())
                             + f"; internal poses {g.get('internal_rot_err_deg', float('nan')):.4f} "
                             f"deg mean relative rotation error vs GT, prior "
                             f"{g['prior_rot_err_deg']:.4f} deg")
    if out["PDCNet_raw"]["pairs_kept"] == 0:
        raise AssertionError("matcher: raw PDC-Net kept no pair")
    g = out["PDCNet_geometry"]
    if g["pairs_kept"] == 0:
        raise AssertionError("matcher: the presets' default route (PDC-Net + geometry stage) "
                             "kept no pair")
    err = g["geometry"].get("internal_rot_err_deg", float("inf"))
    if not err < g["geometry"]["prior_rot_err_deg"] / 5:
        raise AssertionError(f"matcher: the geometry stage's internal poses ({err:.4f} deg) are "
                             f"not below 1/5 of the prior's "
                             f"({g['geometry']['prior_rot_err_deg']:.4f} deg)")
    z = out["zncc_geometry"]
    err = z["geometry"].get("internal_rot_err_deg", float("inf"))
    if z["pairs_kept"] == 0 or not abs(err - ZNCC_JAX_DEG) <= ZNCC_MARGIN_DEG:
        raise AssertionError(f"matcher: zncc with the geometry stage kept {z['pairs_kept']} pairs "
                             f"and its internal poses are at {err:.4f} deg, not within "
                             f"{ZNCC_MARGIN_DEG} deg of the JAX package's {ZNCC_JAX_DEG} deg")

    model = pdcnet.load_weights_npz(pdcnet.BUNDLED_WEIGHTS, CARD)
    draws = Draws(1, CARD)
    pdcnet.self_supervised_adapt(model, scene["image"], draws, n_steps=1)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pdcnet.self_supervised_adapt(model, scene["image"], draws, n_steps=adapt_steps)
    torch.cuda.synchronize()
    out["adapt_steps_per_s"] = adapt_steps / (time.perf_counter() - t0)
    phase("matcher", f"self_supervised_adapt at 300x400, batch 2: "
                     f"{out['adapt_steps_per_s']:.3f} steps/s over {adapt_steps} steps")
    return out


def run_slice(steps: int, matcher_pool_sizes=None) -> dict:
    import dataclasses

    import torch

    from sparf_tpu_torch.ops import fused_mlp as fm
    from sparf_tpu_torch.training.define_trainer import build_config, define_trainer

    cfg = build_config("joint_pose_nerf_training/synthetic", "sparf", dict(
        MATCHER_POOLS, max_iter=100000, flow_backbone="PDCNet"))  # the presets' default route
    workspace = tempfile.mkdtemp(prefix="sparf_torch_smoke_")
    t0 = time.perf_counter()
    trainer = define_trainer(cfg, workspace=workspace, device="cuda", save_option=False)
    pools = trainer.corres_pools
    if (pools.get("backend") != "pdcnet_jax" or pools["n_pairs"] == 0
            or not (pools.get("geom") or {}).get("rounds")):
        raise AssertionError(f"slice: no PDC-Net geometry-stage pools ({pools.get('backend')}, "
                             f"{pools['n_pairs']} pairs, geometry {pools.get('geom')})")
    sizes = [int(c) for c in pools["pool_count"]]
    if matcher_pool_sizes is not None and sizes != matcher_pool_sizes:
        # same scene, seed and card; the matcher phase ran with TF32 on, this
        # one with it off: the matchers must not depend on the global setting
        raise AssertionError(f"slice: pool sizes {sizes} differ from the matcher phase's "
                             f"{matcher_pool_sizes}")
    phase("slice", f"trainer built in {time.perf_counter() - t0:.1f} s "
                   f"({trainer.n_train_views} views {trainer.H}x{trainer.W}, "
                   f"{pools['n_pairs']} correspondence pairs from {pools['backend']} through the "
                   f"geometry stage ({pools['geom']['output']}), pool sizes {sizes}, equal to "
                   f"the matcher phase's under TF32 on)")
    ratio = float(cfg.ratio_end_joint_nerf_pose_refinement)
    stages = (("joint_coarse", 0), ("fine", int(cfg.max_iter * (ratio + 0.05))))
    result = {}
    # the main path's launches from here
    fm.reset_launch_counts()
    for name, it0 in stages:
        state = dataclasses.replace(trainer.state, iteration=it0, iteration_nerf=it0)
        step = trainer.get_step(it0)
        poses_before = trainer.current_poses_w2c(state).clone()
        before = fm.launch_counts()
        state, stats = step(state, trainer.draws)  # warm-up (allocator, first launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            state, stats = step(state, trainer.draws)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / steps
        launches = {k: v - before[k] for k, v in fm.launch_counts().items()}
        losses = {k: float(v) for k, v in stats.items() if v.numel() == 1}
        bad = [k for k, v in losses.items() if v != v or abs(v) == float("inf")]
        if bad:
            raise AssertionError(f"{name}: non-finite stats {bad}")
        if int(state.nan_count) != 0:
            raise AssertionError(f"{name}: {int(state.nan_count)} skipped non-finite updates")
        if 0 in launches.values():
            raise AssertionError(f"{name}: kernels not on the main path: {launches}")
        moved = float((trainer.current_poses_w2c(state) - poses_before).abs().max())
        if name == "joint_coarse" and not moved > 0:
            raise AssertionError("joint stage: pose parameters did not change")
        result[name] = 1.0 / dt
        phase("slice", f"{name} (iteration {it0}): {1.0 / dt:.3f} it/s over {steps} steps "
                       f"after 1 warm-up step, loss all={losses['all']:.5g} "
                       f"render={losses['render']:.5g} corres={losses['corres']:.5g} "
                       f"depth_cons={losses['depth_cons']:.5g}, pose change {moved:.3g}, "
                       f"launches {launches} (K3: the visibility pass, on weights packed by "
                       f"pack_weights)")
    result["launches"] = fm.launch_counts()
    trainer.state = state
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.refresh_correspondence_pools()
    torch.cuda.synchronize()
    result["refresh_s"] = time.perf_counter() - t0
    if trainer.corres_pools["n_pairs"] == 0:
        raise AssertionError("slice: the rematch kept no pair")
    refreshed = trainer.corres_pools
    result["refresh_geometry"] = describe_geometry(refreshed, trainer.train_scene_np,
                                                   trainer.matcher_prior_poses_w2c)
    rg = result["refresh_geometry"]
    phase("slice", f"refresh_correspondence_pools (rematch through the geometry stage with the "
                   f"current poses as prior): {result['refresh_s']:.3f} s, "
                   f"{refreshed['n_pairs']} pairs, pool sizes "
                   f"{[int(c) for c in refreshed['pool_count']]}; rounds "
                   f"{[(r['winner'], r['score']) for r in rg['rounds']]}; internal poses "
                   f"{rg.get('internal_rot_err_deg', float('nan')):.4f} deg vs the prior's "
                   f"{rg['prior_rot_err_deg']:.4f} deg")
    result["trainer"] = trainer
    return result


def run_eval_phase(trainer) -> dict:
    """The port's eval entry point (eval.run_eval) on the trainer's state: one
    full-size test view with and without test-time refinement."""
    import math

    import torch

    from sparf_tpu_torch import eval as teval
    from sparf_tpu_torch.ops import fused_mlp as fm

    renders, refines = [], []
    render, refine = trainer.render_full_image, trainer.run_test_time_photometric_optim

    def timed(fn, log):
        def call(*a, **kw):
            torch.cuda.synchronize()
            before, t0 = fm.launch_counts(), time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            after = fm.launch_counts()
            log.append((time.perf_counter() - t0, *(after[k] - before[k]
                                                    for k in ("K1", "K2", "K3"))))
            return out
        return call

    trainer.render_full_image = timed(render, renders)
    trainer.run_test_time_photometric_optim = timed(refine, refines)
    # the eval path's launches from here
    fm.reset_launch_counts()
    t0 = time.perf_counter()
    results = teval.run_eval(trainer, trainer.cfg, tempfile.mkdtemp(prefix="sparf_torch_eval_"),
                             "smoke_eval")
    total = time.perf_counter() - t0
    launches = fm.launch_counts()
    if 0 in launches.values():
        raise AssertionError(f"eval: kernels not on the eval path: {launches}")
    H, W = trainer.val_scene_np["image"].shape[-2:]
    for tag in ("w_test_optim", "without_test_optim"):
        bad = [k for k, v in results[tag].items()
               if isinstance(v, float) and not math.isfinite(v)]
        if bad:
            raise AssertionError(f"eval {tag}: non-finite metrics {bad}")
    phase("eval", f"{len(renders)} full-image renders of {H}x{W}: "
                  + ", ".join(f"{dt:.3f} s ({k3} K3)" for dt, _, _, k3 in renders)
                  + f"; test-time refinement ({int(trainer.cfg.optim.test_iter)} steps of "
                  f"{int(trainer.cfg.nerf.rand_rays)} rays): "
                  + ", ".join(f"{dt:.3f} s ({k1} K1, {k2} K2)" for dt, k1, k2, _ in refines)
                  + f"; run_eval {total:.3f} s, launches {launches}")
    for tag in ("w_test_optim", "without_test_optim"):
        phase("eval", f"{tag}: " + " ".join(f"{k}={v:.5g}" for k, v in results[tag].items()
                                             if isinstance(v, float)))
    return {"launches": launches, "render_s": [r[0] for r in renders],
            "refine_s": [r[0] for r in refines]}


# ---------------------------------------------------------------------------
# gradient accumulation, the N-step trajectory, the fixed-pose trainer,
# DS-NeRF's COLMAP depth loss
# ---------------------------------------------------------------------------

# the trajectory test's shape (tests/test_torch_trajectory.py): the tiny sparf
# config, 4 point / 2 view PE frequencies, max_iter 400 so that the 200 steps
# cross the stage switch at 120; and its bounds on the gap at step n
TINY_TRAJ = dict(TINY_SPARF, max_iter=400,
                 arch=dict(TINY_SPARF["arch"], posenc=dict(L_3D=4, L_view=2)))
TRAJ_STEPS = 200
TRAJ_TOL = {"loss_rel": (2e-4, 1e-5), "rot_deg": (1e-3, 5e-5), "trans": (5e-5, 5e-6)}
# the same steps at compute_dtype bfloat16 (bf16-check): the bounds of
# tests/test_torch_bf16_trajectory.py (port against JAX on the CPU)
TRAJ_TOL_BF16 = {"loss_rel": (5e-4, 5e-5), "rot_deg": (2e-3, 2e-4), "trans": (1e-4, 1e-5)}
# the accum-check, card against CPU: the accumulator and Adam's mu within 1e-3
# of each tensor's largest magnitude (tests/test_torch_accumulation.py's bound
# against JAX), the parameters within the slice-check's 1e-5
ACCUM_STEPS, ACCUM_NAN_STEP = 6, 3


class NanDraws:
    """Draws whose first 4-d uniform (a render's stratified offsets) gets a
    NaN, so that the step's gradients are not finite."""

    def __init__(self, draws):
        self.draws, self.done = draws, False

    def uniform(self, shape):
        u = self.draws.uniform(shape)
        if len(shape) == 4 and not self.done:
            u = u.clone()
            u.view(-1)[0] = float("nan")
            self.done = True
        return u

    def randint(self, shape, low, high):
        return self.draws.randint(shape, low, high)

    def normal(self, shape):
        return self.draws.normal(shape)


def _tiny_pair(over):
    """The joint trainer of the tiny config `over` on the CPU and on the card,
    the card's from the CPU's parameters."""
    from sparf_tpu_torch.training import engine
    from sparf_tpu_torch.training.define_trainer import build_config, define_trainer

    def trainer_on(device):
        cfg = build_config("joint_pose_nerf_training/synthetic", "sparf", over)
        return define_trainer(cfg, workspace=tempfile.mkdtemp(prefix="sparf_torch_tiny_"),
                              device=device, save_option=False)

    cpu, gpu = trainer_on("cpu"), trainer_on("cuda")
    gpu.state.nerf_params = engine.tree_unflatten(
        cpu.state.nerf_params, [x.cuda() for x in engine.tree_leaves(cpu.state.nerf_params)])
    gpu.state.pose_params = {k: v.cuda() for k, v in cpu.state.pose_params.items()}
    return cpu, gpu


def check_accum_cuda_vs_cpu() -> None:
    """grad_acc_steps = 2 on the tiny config: ACCUM_STEPS steps on the card
    against the CPU from the same parameters and draws, one of them with a
    NaN in a draw; after every step the mini-step counter, Adam's count, the
    accumulator, mu and the parameters agree, and the non-finite step leaves
    the whole state as it was."""
    import torch

    from sparf_tpu_torch.training import engine
    from sparf_tpu_torch.utils.draws import Draws, ReplayDraws

    cpu, gpu = _tiny_pair(dict(TINY_TRAJ, grad_acc_steps=2))
    st_c, st_g = cpu.state, gpu.state
    worst = {"acc": 0.0, "mu": 0.0, "param": 0.0}
    for it in range(ACCUM_STEPS):
        draws = Draws(100 + it, "cpu")
        rec = RecordingDraws(NanDraws(draws) if it == ACCUM_NAN_STEP else draws)
        prev_g = st_g
        st_c, _ = cpu.get_step(it)(st_c, rec)
        st_g, _ = gpu.get_step(it)(st_g, ReplayDraws(rec.recorded, "cuda"))
        a_c, a_g = st_c.opt_state_nerf, st_g.opt_state_nerf
        counts = [(int(a_g.mini_step), int(a_c.mini_step)), (int(a_g.inner.count),
                                                             int(a_c.inner.count)),
                  (int(st_g.nan_count), int(st_c.nan_count))]
        if any(g != c for g, c in counts):
            raise AssertionError(f"accum-check step {it}: counters card/cpu {counts}")
        if it == ACCUM_NAN_STEP:
            same = all(torch.equal(a, b) for a, b in zip(
                engine.tree_leaves(st_g.nerf_params) + a_g.acc,
                engine.tree_leaves(prev_g.nerf_params) + prev_g.opt_state_nerf.acc))
            if int(st_g.nan_count) != 1 or not same:
                raise AssertionError("accum-check: the non-finite step changed the state")
        for key, pairs in (("acc", zip(a_g.acc, a_c.acc)), ("mu", zip(a_g.inner.mu,
                                                                      a_c.inner.mu))):
            for a, b in pairs:
                err, rel = rel_err(a.cpu(), b)
                worst[key] = max(worst[key], rel)
                if not rel <= 1e-3:
                    raise AssertionError(f"accum-check step {it}: {key} off by {rel:.3g}")
        for a, b in zip(engine.tree_leaves(st_g.nerf_params) + list(st_g.pose_params.values()),
                        engine.tree_leaves(st_c.nerf_params) + list(st_c.pose_params.values())):
            err = float((a.cpu() - b).abs().max())
            worst["param"] = max(worst["param"], err)
            if not err <= 1e-5:
                raise AssertionError(f"accum-check step {it}: parameters off by {err:.3g}")
    phase("accum-check", f"grad_acc_steps=2, {ACCUM_STEPS} steps (step {ACCUM_NAN_STEP} "
                         f"non-finite, skipped on both): card matches cpu, "
                         f"{int(st_g.opt_state_nerf.inner.count)} applied updates; worst "
                         f"accumulator {worst['acc']:.3g} and mu {worst['mu']:.3g} of scale, "
                         f"parameters {worst['param']:.3g}")


def check_trajectory_cuda_vs_cpu(over=None, tol=None, what: str = "trajectory-check") -> dict:
    """The trajectory test's TRAJ_STEPS steps (with `over`) on the card
    against the CPU, in lockstep on the same draws: the loss and the pose
    error after alignment at every step, held to `tol` (the test's bounds,
    TRAJ_TOL)."""
    import numpy as np

    from sparf_tpu_torch.utils import alignment
    from sparf_tpu_torch.utils.draws import Draws, ReplayDraws

    tol = tol or TRAJ_TOL
    cpu, gpu = _tiny_pair(_merged(TINY_TRAJ, over or {}))
    gt = np.asarray(cpu.train_scene_np["pose"])
    draws = Draws(7, "cpu")
    st_c, st_g = cpu.state, gpu.state
    rows = []
    for it in range(TRAJ_STEPS):
        rec = RecordingDraws(draws)
        st_c, s_c = cpu.get_step(it)(st_c, rec)
        st_g, s_g = gpu.get_step(it)(st_g, ReplayDraws(rec.recorded, "cuda"))
        e_c = alignment.evaluate_any_poses(cpu.current_poses_w2c(st_c).detach().numpy(), gt)
        e_g = alignment.evaluate_any_poses(gpu.current_poses_w2c(st_g).detach().cpu().numpy(),
                                           gt)
        rows.append((float(s_c["all"]), float(s_g["all"]), e_c["error_R"], e_g["error_R"],
                     e_c["error_t"], e_g["error_t"]))
    r = np.asarray(rows)
    n = np.arange(TRAJ_STEPS)
    gaps = {"loss_rel": np.abs(r[:, 1] - r[:, 0]) / np.abs(r[:, 0]),
            "rot_deg": np.abs(r[:, 3] - r[:, 2]), "trans": np.abs(r[:, 5] - r[:, 4])}
    share = {k: float(np.max(g / (tol[k][0] + tol[k][1] * n))) for k, g in gaps.items()}
    switch = cpu.iter_end_joint
    phase(what, f"{TRAJ_STEPS} steps (poses frozen from {switch}), card vs cpu: "
          f"largest gaps loss {gaps['loss_rel'].max():.3g} (relative), rotation error "
          f"{gaps['rot_deg'].max():.3g} deg, translation error {gaps['trans'].max():.3g}; "
          f"largest share of the bound {max(share.values()):.3g}; pose error from "
          f"{r[0, 3]:.4f} to {r[-1, 3]:.4f} deg (cpu {r[-1, 2]:.4f})")
    if max(share.values()) > 1 or int(st_g.nan_count) or int(st_c.nan_count):
        raise AssertionError(f"{what}: gaps beyond the bounds {share}")
    return {k: float(g.max()) for k, g in gaps.items()}


def _full_trainer(module, name, over):
    from sparf_tpu_torch.training.define_trainer import build_config, define_trainer

    cfg = build_config(module, name, dict(FULL_SCENE, max_iter=100000, **over))
    return define_trainer(cfg, workspace=tempfile.mkdtemp(prefix="sparf_torch_smoke_"),
                          device="cuda", save_option=False)


def _timed_steps(trainer, it0: int, steps: int, what: str, bf16: bool = False):
    """1 warm-up step and `steps` timed steps from iteration it0, with the
    kernels' launches counted from 0 (returns state, it/s, the launches of
    the fp32 or, with `bf16`, the bf16 variants, stats); the other variants
    must not launch."""
    import dataclasses

    import torch

    from sparf_tpu_torch.ops import fused_mlp as fm

    state = dataclasses.replace(trainer.state, iteration=it0, iteration_nerf=it0)
    step = trainer.get_step(it0)
    fm.reset_launch_counts()
    state, stats = step(state, trainer.draws)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, stats = step(state, trainer.draws)
    torch.cuda.synchronize()
    its = steps / (time.perf_counter() - t0)
    launches, other = fm.launch_counts(bf16), fm.launch_counts(not bf16)
    losses = {k: float(v) for k, v in stats.items() if v.numel() == 1}
    bad = [k for k, v in losses.items() if v != v or abs(v) == float("inf")]
    if bad or int(state.nan_count):
        raise AssertionError(f"{what}: non-finite stats {bad}, nan_count {int(state.nan_count)}")
    if launches["K1"] == 0 or launches["K2"] == 0 or any(other.values()):
        raise AssertionError(f"{what}: K1/K2 not on the path: {launches} (the other variants "
                             f"{other})")
    return state, its, launches, losses


def check_bf16_cli() -> None:
    """--tpu.compute_dtype=bfloat16 through the training CLI on the card (the
    tiny config, 10 debug iterations with validation and snapshots) and the
    eval entry point on its snapshot: only the bf16 variants launch, and the
    metrics are finite."""
    import math

    from sparf_tpu_torch import eval as teval
    from sparf_tpu_torch import run_trainval
    from sparf_tpu_torch.ops import fused_mlp as fm

    ws = tempfile.mkdtemp(prefix="sparf_torch_cli_")
    tiny = ["--synthetic.H=24", "--synthetic.W=32", "--synthetic.n_train=3",
            "--synthetic.n_test=1", "--arch.layers_feat=[null,64,64,64,64]",
            "--arch.layers_rgb=[null,32,3]", "--arch.skip=[2]", "--nerf.sample_intvs=32",
            "--nerf.sample_intvs_fine=16", "--nerf.rand_rays=16", "--depth_cons_nbr_rays=16",
            "--min_nbr_matches=10", "--use_gt_correspondences=True", "--max_iter=1000",
            "--optim.test_iter=2", "--tpu.compute_dtype=bfloat16"]
    fm.reset_launch_counts()
    trainer = run_trainval.main(["joint_pose_nerf_training/synthetic", "sparf", "--scene",
                                 "spheres", "--debug", "True", "--device", "cuda",
                                 "--workspace_dir", ws, *tiny])
    res = teval.main(["--ckpt_dir", trainer.workspace, "--device", "cuda", "--out_dir",
                      os.path.join(ws, "ev"), "--expname", "bf16"])
    launches, other = fm.launch_counts(True), fm.launch_counts()
    w = res["latest"]["w_test_optim"]
    if (trainer.state.iteration != 10 or 0 in launches.values() or any(other.values())
            or not all(math.isfinite(w[k]) for k in ("psnr", "rot_error"))):
        raise AssertionError(f"bf16 CLI: iteration {trainer.state.iteration}, launches of the "
                             f"bf16 variants {launches}, of the fp32 ones {other}, metrics {w}")
    phase("bf16-check", f"the training CLI (10 debug iterations) and the eval entry point at "
                        f"compute_dtype bfloat16 on the card: launches of the bf16 variants "
                        f"{launches}, of the fp32 ones 0; psnr={w['psnr']:.4f} "
                        f"rot_error={w['rot_error']:.4f}")


def run_bf16_slice(steps: int, fp32_rates: dict) -> dict:
    """The joint recipe at the full shape with tpu.compute_dtype bfloat16:
    `steps` timed steps in the joint coarse and in the fine stage, on GT-depth
    correspondences (the step's shape does not depend on the matcher: the
    pools are padded); only the bf16 variants of K1/K2/K3 may launch."""
    trainer = _full_trainer("joint_pose_nerf_training/synthetic", "sparf", dict(
        use_gt_correspondences=True, min_nbr_matches=100, **BF16))
    ratio = float(trainer.cfg.ratio_end_joint_nerf_pose_refinement)
    out = {"launches": dict.fromkeys(("K1", "K2", "K3", "pack"), 0)}
    for name, it0 in (("joint_coarse", 0), ("fine", int(trainer.cfg.max_iter * (ratio + 0.05)))):
        state, its, launches, losses = _timed_steps(trainer, it0, steps, f"bf16 {name}",
                                                    bf16=True)
        if launches["K3"] == 0:
            raise AssertionError(f"bf16 {name}: no K3 (depth-consistency visibility)")
        trainer.state = state
        out[name] = its
        for k in out["launches"]:
            out["launches"][k] += launches[k]
        phase("bf16-slice", f"{name} (iteration {it0}): {its:.3f} it/s over {steps} steps after "
                            f"1 warm-up (fp32 in this call {fp32_rates[name]:.3f}), loss "
                            f"all={losses['all']:.5g}, launches of the bf16 variants {launches}, "
                            f"of the fp32 variants 0")
    return out


def run_wide_slice(steps: int, rates: dict) -> dict:
    """wide-slice: the joint recipe at the full shape with the presets' MLP
    at posenc.L_3D=12 (pts_enc 75 wide: the kernels' wide plans, 64-point
    tiles), in float32 and bfloat16, on GT-depth correspondences: `steps`
    timed steps of the joint coarse stage after one warm-up, their it/s
    beside the L_3D=10 steps' of this run (`rates`: dtype -> it/s), and the
    kernels' launches (only the dtype's own variants may launch)."""
    out = {"launches": {}}
    for tag, over in (("fp32", {}), ("bf16", BF16)):
        trainer = _full_trainer("joint_pose_nerf_training/synthetic", "sparf", dict(
            use_gt_correspondences=True, min_nbr_matches=100,
            arch=dict(posenc=dict(L_3D=12)), **over))
        if trainer.render_cfg.mlp.input_3d_dim != 75:
            raise AssertionError("wide-slice: pts_enc is not 75 wide")
        state, its, launches, losses = _timed_steps(trainer, 0, steps, f"wide-slice {tag}",
                                                    bf16=tag == "bf16")
        out[tag] = its
        out["launches"][tag] = launches
        phase("wide-slice", f"{tag} joint coarse (iteration 0), posenc.L_3D=12: {its:.3f} it/s "
                            f"over {steps} steps after 1 warm-up (L_3D=10 in this call "
                            f"{rates[tag]:.3f}), loss all={losses['all']:.5g}, launches of the "
                            f"{tag} variants {launches}, of the other 0")
        del trainer, state
    return out


def run_video_phase(trainer, n_frames: int = 8) -> dict:
    """generate_videos_synthesis on the full-shape trainer: n_frames of 300x400
    along the oscillation path, rgb and depth, through K3; each written file
    decoded with the port's reader, every frame finite and not constant."""
    import numpy as np
    import torch

    from sparf_tpu_torch.ops import fused_mlp as fm
    from sparf_tpu_torch.utils import imgproc
    from sparf_tpu_torch.utils.video import generate_videos_synthesis

    out_dir = tempfile.mkdtemp(prefix="sparf_torch_video_")
    fm.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    paths = generate_videos_synthesis(trainer, out_dir=out_dir, n_frames=n_frames)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = fm.launch_counts()
    frames = {os.path.basename(p): imgproc.read_apng(p) for p in paths}
    H, W = trainer.train_scene_np["image"].shape[-2:]
    for name, fr in frames.items():
        if len(fr) != n_frames or any(f.shape != (H, W, 3) or not np.isfinite(f).all()
                                      or np.ptp(f) == 0 for f in fr):
            raise AssertionError(f"video {name}: {len(fr)} frames, shapes "
                                 f"{[f.shape for f in fr]}, constant or not finite")
    if launches["K3"] == 0:
        raise AssertionError(f"video: no K3 launch ({launches})")
    out = {"s_per_frame": seconds / n_frames, "launches": launches,
           "bytes": {k: os.path.getsize(p) for k, p in zip(frames, paths)}}
    phase("video", f"generate_videos_synthesis, {n_frames} frames of {H}x{W} (rgb and depth): "
                   f"{out['s_per_frame']:.3f} s per frame, launches {launches} "
                   f"({launches['K3'] / n_frames:.0f} K3 per frame); files {out['bytes']} bytes, "
                   f"decoded with utils/imgproc.read_apng: every frame finite, none constant")
    return out


def run_fixed_pose_phase(steps: int) -> dict:
    """nerf_fixed_noisy_poses/synthetic/sparf at the full shape on GT-depth
    correspondences, fine sampling from 30% of max_iter (the preset renders
    fine from the start) so that both sampling stages run: `steps` timed
    steps in each, the poses bit-frozen, then one test view through
    evaluate_full with test-time refinement composed onto the GT pose."""
    import math

    import torch

    from sparf_tpu_torch.ops import fused_mlp as fm

    trainer = _full_trainer("nerf_fixed_noisy_poses/synthetic", "sparf", dict(
        use_gt_correspondences=True, min_nbr_matches=100,
        nerf=dict(ratio_start_fine_sampling_at_x=0.3)))
    if type(trainer).__name__ != "NerfTrainerPerSceneWColmapFixedPoses":
        raise AssertionError(f"fixed-pose: built {type(trainer).__name__}")
    poses = trainer.current_poses_w2c().detach().clone()
    out = {"launches": dict.fromkeys(("K1", "K2", "K3"), 0)}
    for stage, it0 in (("coarse", 0), ("fine", int(0.35 * trainer.cfg.max_iter))):
        state, its, launches, losses = _timed_steps(trainer, it0, steps, f"fixed-pose {stage}")
        if launches["K3"] == 0:
            raise AssertionError(f"fixed-pose {stage}: no K3 (depth-consistency visibility)")
        if not torch.equal(trainer.current_poses_w2c(state), poses):
            raise AssertionError(f"fixed-pose {stage}: the poses moved")
        trainer.state = state
        out[stage] = its
        for k in out["launches"]:
            out["launches"][k] += launches[k]
        phase("fixed-pose", f"{stage} (iteration {it0}, fine sampling "
                            f"{trainer.fine_enabled_at(it0)}): {its:.3f} it/s over {steps} "
                            f"steps after 1 warm-up, loss all={losses['all']:.5g} "
                            f"depth_cons={losses['depth_cons']:.5g}, poses bit-frozen, launches "
                            f"{launches}")
    fm.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = trainer.evaluate_full(out_dir=trainer.workspace, with_test_optim=True)
    torch.cuda.synchronize()
    launches = {k: v for k, v in fm.launch_counts().items() if k != "pack"}
    m = res["per_image"][0]
    if 0 in launches.values() or not all(math.isfinite(v) for v in m.values()
                                         if isinstance(v, float)):
        raise AssertionError(f"fixed-pose evaluate_full: launches {launches}, metrics {m}")
    for k in out["launches"]:
        out["launches"][k] += launches[k]
    out["eval_s"] = time.perf_counter() - t0
    phase("fixed-pose", f"evaluate_full, one test view at its GT pose with "
                        f"{int(trainer.cfg.optim.test_iter)} refinement steps: "
                        f"{out['eval_s']:.3f} s, launches {launches}, psnr={m['psnr']:.4f} "
                        f"(without refinement {m['psnr_no_refine']:.4f}), refinement moved the "
                        f"pose {m['refine_rot_deg']:.4f} deg")
    return out


def run_dsnerf_phase(steps: int) -> dict:
    """DS-NeRF: nerf_gt_poses with SparseCOLMAPDepthLoss at the full shape,
    its sparse depth triangulated from GT-depth matches at the GT poses (the
    trainer does it when it builds), trained on it at weight 10^0 (no preset
    weighs the loss, and a loss without a weight is only reported); the
    triangulation's seconds, perc_col_depth and the step rate. Every
    forward of the step has its backward: the photometric and the depth
    bundle, coarse and fine."""
    from sparf_tpu_torch.colmap_init import triangulation

    spent = []
    triangulate = triangulation.compute_triangulation_from_matches

    def timed(*a, **kw):
        t0 = time.perf_counter()
        out = triangulate(*a, **kw)
        spent.append(time.perf_counter() - t0)
        return out

    triangulation.compute_triangulation_from_matches = timed
    try:
        trainer = _full_trainer("nerf_training_w_gt_poses/synthetic", "nerf", dict(
            use_gt_correspondences=True, loss_type="photometric_and_SparseCOLMAPDepthLoss",
            loss_weight=dict(colmap_depth=0.0), nerf=dict(rand_rays=1024, sample_intvs=128, sample_intvs_fine=128,
                      fine_sampling=True)))
    finally:
        triangulation.compute_triangulation_from_matches = triangulate
    if len(spent) != 1:
        raise AssertionError("dsnerf: the trainer did not triangulate")
    depth = trainer.train_scene["colmap_depth"]
    state, its, launches, losses = _timed_steps(trainer, 0, steps, "dsnerf")
    if not losses["colmap_depth"] > 0 or "colmap_depth_after_w" not in losses:
        raise AssertionError(f"dsnerf: the depth loss is not trained on: {losses}")
    if launches["K2"] != launches["K1"]:
        raise AssertionError(f"dsnerf: a forward without its backward: {launches}")
    phase("dsnerf", f"triangulation of GT-depth matches at the GT poses: {spent[0]:.3f} s, "
                    f"{int((depth > 0).sum())} px with depth, perc_col_depth="
                    f"{losses['perc_col_depth']:.5g}; {its:.3f} it/s over {steps} steps, loss "
                    f"colmap_depth={losses['colmap_depth']:.5g} (weighted "
                    f"{losses['colmap_depth_after_w']:.5g}) render={losses['render']:.5g}, "
                    f"launches {launches}")
    return {"triangulation_s": spent[0], "it_per_sec": its,
            "perc_col_depth": losses["perc_col_depth"], "launches": launches}


def run_accum_phase(steps: int) -> dict:
    """grad_acc_steps = 2 on the joint recipe at the full shape (GT-depth
    correspondences): `steps` timed steps in the joint stage; the NeRF
    parameters change on every second step only, the poses on every step."""
    import dataclasses

    import torch

    from sparf_tpu_torch.ops import fused_mlp as fm
    from sparf_tpu_torch.training import engine

    trainer = _full_trainer("joint_pose_nerf_training/synthetic", "sparf", dict(
        use_gt_correspondences=True, min_nbr_matches=100, grad_acc_steps=2))
    state, its, launches, _ = _timed_steps(trainer, 0, steps, "accum")
    fm.reset_launch_counts()
    changed = []
    for _ in range(2):
        before = [t.clone() for t in engine.tree_leaves(state.nerf_params)]
        poses = trainer.current_poses_w2c(state).detach().clone()
        state, _ = trainer.get_step(0)(dataclasses.replace(state, iteration=0), trainer.draws)
        changed.append((int(state.opt_state_nerf.mini_step),
                        not all(torch.equal(a, b) for a, b in
                                zip(engine.tree_leaves(state.nerf_params), before)),
                        not torch.equal(trainer.current_poses_w2c(state), poses)))
    for k in launches:
        launches[k] += fm.launch_counts()[k]
    if sorted(c[1] for c in changed) != [False, True] or not all(c[2] for c in changed):
        raise AssertionError(f"accum: (mini_step, NeRF changed, poses changed) {changed}")
    phase("accum", f"grad_acc_steps=2, joint stage: {its:.3f} it/s over {steps} steps after 1 "
                   f"warm-up; (mini-step, NeRF updated, poses updated) over two more steps "
                   f"{changed}; launches {launches}")
    return {"it_per_sec": its, "launches": launches}


MERGED = dict(tpu=dict(merged_render=True))


def _levels(trainer, it: int) -> int:
    return 2 if trainer.fine_enabled_at(it) else 1


def merged_vs_per_bundle(trainers, it: int, what: str, keep_grad: float = 0.0) -> str:
    """One step at iteration `it` of trainers[True] (merged) and
    trainers[False] (per-bundle), both on the card, from the same state and
    the same draws per bundle (KeyedDraws): losses within rtol 1e-4,
    gradients (Adam's mu / 0.1) within BWD_RTOL of each tensor's largest
    magnitude, updated parameters within 1e-5 (NeRF parameters where the
    per-bundle gradient is at least `keep_grad`: Adam's first step moves an
    element by lr g / (|g| + eps), so a gradient within its rounding of 0
    can step either way); the merged step launches one K1 and one K2 per
    level for each of the two rounds of bundles and one K3 per level (the
    visibility group), the per-bundle step one K1/K2 pair per level for each
    of its five gradient bundles. Returns the phase's summary."""
    import dataclasses

    from sparf_tpu_torch.ops import fused_mlp as fm
    from sparf_tpu_torch.training import engine
    from sparf_tpu_torch.utils.draws import KeyedDraws

    res = {}
    for merged, tr in trainers.items():
        st = dataclasses.replace(tr.state, iteration=it, iteration_nerf=it)
        fm.reset_launch_counts()
        res[merged] = tr.get_step(it)(st, KeyedDraws(it, "cuda")) + (fm.launch_counts(),)
    (new_b, stats_b, l_b), (new_m, stats_m, l_m) = res[False], res[True]
    lv = _levels(trainers[True], it)
    want_m = {"K1": 2 * lv, "K2": 2 * lv, "K3": lv}
    want_b = {"K1": 5 * lv, "K2": 5 * lv, "K3": lv}
    if any(l_m[k] != v for k, v in want_m.items()) or any(l_b[k] != v
                                                          for k, v in want_b.items()):
        raise AssertionError(f"{what} at {it}: launches merged {l_m} (want {want_m}), "
                             f"per-bundle {l_b} (want {want_b})")
    for k, v in stats_b.items():
        a, b = float(stats_m[k]), float(v)
        if not abs(a - b) <= 1e-6 + 1e-4 * abs(b):
            raise AssertionError(f"{what} at {it}: {k} merged {a} vs per-bundle {b}")
    pairs = list(zip(new_m.opt_state_nerf.mu, new_b.opt_state_nerf.mu))
    if new_b.opt_state_pose is not None:
        pairs += list(zip(new_m.opt_state_pose.mu, new_b.opt_state_pose.mu))
    worst = 0.0
    for a, b in pairs:
        err, rel = rel_err(a, b)
        worst = max(worst, rel)
        if not rel <= BWD_RTOL:
            raise AssertionError(f"{what} at {it}: gradient off by {err:.3g} (rel {rel:.3g})")
    worst_param, held_out = 0.0, 0
    for a, b, g in zip(engine.tree_leaves(new_m.nerf_params),
                       engine.tree_leaves(new_b.nerf_params), new_b.opt_state_nerf.mu):
        keep = (g / 0.1).abs() >= keep_grad
        held_out += int((~keep).sum())
        worst_param = max(worst_param, float((a - b).abs()[keep].max()) if keep.any() else 0.0)
    for a, b in zip(new_m.pose_params.values(), new_b.pose_params.values()):
        worst_param = max(worst_param, float((a - b).abs().max()))
    if not worst_param <= 1e-5:
        raise AssertionError(f"{what} at {it}: updated parameters differ by {worst_param:.3g}")
    return (f"step at iteration {it}, card: merged = per-bundle (loss all "
            f"{float(stats_m['all']):.6g} vs {float(stats_b['all']):.6g}, worst gradient "
            f"{worst:.3g} of scale, parameters within {worst_param:.3g}"
            + (f", {held_out} NeRF values with |g| < {keep_grad:g} held out" if keep_grad else "")
            + f"); launches merged {l_m}, per-bundle {l_b}")


def check_merged_cuda_vs_per_bundle() -> None:
    """merged_vs_per_bundle for the tiny step in both stages."""
    from sparf_tpu_torch.training.define_trainer import build_config, define_trainer

    trainers = {}
    for merged in (False, True):
        cfg = build_config("joint_pose_nerf_training/synthetic", "sparf",
                           _merged(TINY_SPARF, dict(tpu=dict(merged_render=merged))))
        trainers[merged] = define_trainer(cfg, workspace=tempfile.mkdtemp(prefix="sparf_mg_"),
                                          device="cuda", save_option=False)
    for it in (0, 350):
        phase("merged-check", "tiny " + merged_vs_per_bundle(trainers, it, "merged-check"))


def run_merged_slice(steps: int) -> dict:
    """The full shape (GT-depth pools) with tpu.merged_render off and on: in
    each stage first one step of each held to the other
    (merged_vs_per_bundle: the merged K1/K2 launches at T = 3,072 rays x
    the level's samples, 786,432 points on the fine level), then the timed
    runs in turns off, on, on, off: it/s (the mean of each side's two runs)
    and launches per step."""
    trainers = {m: _full_trainer("joint_pose_nerf_training/synthetic", "sparf", dict(
        use_gt_correspondences=True, min_nbr_matches=100, tpu=dict(merged_render=m)))
        for m in (False, True)}
    ratio = float(trainers[True].cfg.ratio_end_joint_nerf_pose_refinement)
    out = {"launches": dict.fromkeys(("K1", "K2", "K3", "pack"), 0)}
    it_fine = int(trainers[True].cfg.max_iter * (ratio + 0.05))
    for name, it0 in (("joint_coarse", 0), ("fine", it_fine)):
        phase("merged-slice", f"{name}, full shape: " + merged_vs_per_bundle(
            trainers, it0, "merged-slice", keep_grad=1e-6))
        rates = {False: [], True: []}
        per_step = {}
        for merged in (False, True, True, False):
            tr = trainers[merged]
            state, its, launches, losses = _timed_steps(tr, it0, steps,
                                                        f"merged-slice {name} {merged}")
            rates[merged].append(its)
            per_step[merged] = {k: v / (steps + 1) for k, v in launches.items()}
            for k in out["launches"]:
                out["launches"][k] += launches[k]
        out[name] = {("merged" if m else "per_bundle"): sum(r) / len(r) for m, r in rates.items()}
        out[name]["runs"] = {("merged" if m else "per_bundle"): r for m, r in rates.items()}
        out[name]["launches_per_step"] = {("merged" if m else "per_bundle"): v
                                          for m, v in per_step.items()}
        phase("merged-slice", f"{name} (iteration {it0}), {steps} steps after 1 warm-up per run, "
                              f"off/on/on/off: per-bundle {rates[False][0]:.3f}, "
                              f"{rates[False][1]:.3f} it/s, merged {rates[True][0]:.3f}, "
                              f"{rates[True][1]:.3f} it/s; launches per step per-bundle "
                              f"{per_step[False]}, merged {per_step[True]}")
    return out


def check_multi() -> dict:
    """Ray sharding on the card: two gloo ranks (CUDA tensors through gloo,
    both on cuda:0) run the tiny step in both stages against the one-process
    card step from the same initial state and draws: every loss within rtol
    1e-5, the updated parameters within 1e-5 where the one-process gradient
    is at least 1e-6 (tests/traced_draws.py's holdout), every rank's
    parameters equal bit for bit; then the same two ranks build the tiny
    trainer on SfM initial poses and the learned matcher's pools (PDC-Net
    with the geometry stage on the card), which rank 0 alone computes (the
    other rank's calls would raise), and every rank must hold rank 0's
    initial poses and pools bit for bit; a one-rank NCCL group runs the
    tiny step; then two gloo ranks at the full shape, joint stage, it/s per
    rank."""
    import dataclasses

    import torch

    from sparf_tpu_torch.parallel import dryrun
    from sparf_tpu_torch.training import engine
    from sparf_tpu_torch.training.define_trainer import define_trainer
    from sparf_tpu_torch.utils.draws import Draws

    over = dict(use_gt_correspondences=True)

    def one_process(n, iterations):
        tr = define_trainer(dryrun.tiny_config(n, mesh=False, **over),
                            workspace=tempfile.mkdtemp(prefix="sparf_ref_"), device="cuda",
                            save_option=False)
        out = []
        for it in iterations:
            st = dataclasses.replace(tr.state, iteration=it, iteration_nerf=it)
            new, stats = tr.get_step(it)(st, Draws(it, "cuda"))
            out.append((new, {k: float(v) for k, v in stats.items() if v.numel() == 1}))
        return out

    def compare(ranks, ref, what):
        worst = 0.0
        for k, (new, stats) in enumerate(ref):
            for r in ranks:
                got = r["results"][k]
                for key in ("all", "render", "corres", "depth_cons"):
                    a, b = got["stats"][key], stats[key]
                    if not abs(a - b) <= 1e-5 * abs(b) + 1e-8:
                        raise AssertionError(f"{what}: {key} rank {r['rank']} {a} vs {b}")
                for a, b in zip(got["nerf"] + got["pose"], ranks[0]["results"][k]["nerf"]
                                + ranks[0]["results"][k]["pose"]):
                    if not torch.equal(a, b):
                        raise AssertionError(f"{what}: rank {r['rank']} diverged from rank 0")
            got = ranks[0]["results"][k]
            for a, b, g in zip(got["nerf"], engine.tree_leaves(new.nerf_params),
                               new.opt_state_nerf.mu):
                keep = (g.cpu() / 0.1).abs() >= 1e-6
                d = float((a - b.cpu()).abs()[keep].max()) if keep.any() else 0.0
                worst = max(worst, d)
                if not d <= 1e-5:
                    raise AssertionError(f"{what}: updated NeRF parameters off by {d:.3g}")
            for a, b in zip(got["pose"], engine.tree_leaves(new.pose_params)):
                d = float((a - b.cpu()).abs().max())
                worst = max(worst, d)
                if not d <= 1e-5:
                    raise AssertionError(f"{what}: updated poses off by {d:.3g}")
        return worst

    its = (0, 350)
    gloo = dryrun.step_on_ranks(2, backend="gloo", device="cuda:0", cfg_over=over,
                                iterations=its)
    worst = compare(gloo, one_process(2, its), "multi-check gloo x2")
    sent = gloo[0]["results"][0]["collective_bytes"]
    phase("multi-check", f"2 gloo ranks on {gloo[0]['device']} (CUDA tensors through gloo) = "
                         f"the one-process card step at iterations {its} (loss all "
                         f"{gloo[0]['results'][0]['stats']['all']:.6g}; parameters within "
                         f"{worst:.3g}; ranks equal bit for bit); collective bytes of the joint "
                         f"step per rank {sent}")
    with tempfile.TemporaryDirectory(prefix="sparf_sfm_") as cache:
        pre = dryrun.step_on_ranks(2, backend="gloo", device="cuda:0",
                                   cfg_over=dict(dryrun.SFM_MATCHER, sfm_cache_dir=cache),
                                   iterations=(0,), rank_setup=dryrun.precompute_on_rank0_only)
    differ = dryrun.ranks_disagree(pre)
    pools = pre[0]["precompute"]["pools"]
    if differ or not pools.get("n_pairs"):
        raise AssertionError(f"multi-check: the precompute differs across ranks {differ} or "
                             f"kept no pair ({pools.get('n_pairs')})")
    phase("multi-check", f"2 gloo ranks, SfM initial poses and PDC-Net + geometry-stage pools "
                         f"computed on rank 0 alone: {int(pools['n_pairs'])} pairs, every rank "
                         f"holds rank 0's poses and pools bit for bit")
    nccl = dryrun.step_on_ranks(1, backend="nccl", device="cuda:0", cfg_over=over,
                                iterations=its)
    worst = compare(nccl, one_process(1, its), "multi-check nccl x1")
    phase("multi-check", f"1 NCCL rank = the one-process card step (parameters within "
                         f"{worst:.3g}), backend {nccl[0]['backend']}")
    full = dryrun.step_on_ranks(2, backend="gloo", device="cuda:0", full=True, iterations=(0,),
                                timed_steps=5)
    rates = [r["results"][0]["it_per_sec"] for r in full]
    launches = {k: sum(r["results"][0]["launches"][k] for r in full)
                for k in ("K1", "K2", "K3", "pack")}
    phase("multi-check", f"2 gloo ranks on one card at the full shape, joint stage: "
                         f"{rates[0]:.3f} / {rates[1]:.3f} it/s per rank over 5 steps after 1, "
                         f"loss all {full[0]['results'][0]['stats']['all']:.6g}; launches "
                         f"(both ranks) {launches}")
    return {"it_per_sec_per_rank": rates, "launches": launches,
            "collective_bytes_tiny": sent}


def run_profile_phase() -> dict:
    """profile_step.py: 10 fine-stage steps at fp32 at the full shape."""
    from sparf_tpu_torch.models import nerf_mlp
    from sparf_tpu_torch.ops import fused_mlp as fm
    from sparf_tpu_torch.scripts import profile_step

    res = profile_step.main(["--stage", "fine", "--steps", "10"])
    # the K1 that the presets' chain takes: on wgmma where its route says so
    impl = fm.route(tuple(fm.chain_dims(nerf_mlp.MLPConfig())), False).impl
    k1 = "k1_tf" if impl == "tf32wg" else "k1_forward"
    k1_ms = sum(k["ms_per_step"] for k in res["kernels"] if k1 in k["name"])
    if res["platform"] != "cuda" or k1_ms <= 0:
        raise AssertionError(f"profile: no device time for K1 ({k1}): {res['kernels']}")
    phase("profile", f"fine stage, fp32, {res['window_ms_per_step']:.3f} ms per step, idle share "
                     f"{res['idle_share']:.3f}; top kernels, ms per step: "
                     + "; ".join(f"{k['name'][:60]} {k['ms_per_step']:.3f}"
                                 for k in res["kernels"][:10]))
    return {k: v for k, v in res.items() if k != "kernels"}


def run_fused_adam_phase() -> dict:
    """The optimizer update's kernel pair: its card tests, then the
    full-shape step at both stages (see the module's note)."""
    import torch

    from sparf_tpu_torch.ops import fused_adam
    from sparf_tpu_torch.scripts import profile_step
    from sparf_tpu_torch.training import engine
    from sparf_tpu_torch.utils import tracing

    proc = subprocess.run([sys.executable, "-m", "pytest", "-p", "no:cacheprovider",
                           "--noconftest", "-m", "card", "-q", "-rs",
                           "tests/test_torch_fused_adam.py"],
                          cwd=REPO, capture_output=True, text=True)
    tail = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
    if proc.returncode != 0 or "skipped" in tail or "passed" not in tail:
        raise AssertionError(f"fused-adam: card tests: {proc.stdout[-4000:]}{proc.stderr[-2000:]}")
    tr = profile_step.build_trainer(False, "float32", False, "cuda")
    out = {"card_tests": tail}
    for stage in ("coarse", "fine"):
        it = profile_step.stage_iteration(tr, stage)
        state = dataclasses.replace(tr.state, iteration=it, iteration_nerf=it)
        step = tr.get_step(it)
        for _ in range(2):
            state, _ = step(state, tr.draws)
        torch.cuda.synchronize()
        tracing.reset_counts("launch.")
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(3):
                state, stats = step(state, tr.draws)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        adam = tracing.counts().get("launch.adam", 0)
        if adam != 3:
            raise AssertionError(f"fused-adam: {stage}: launch.adam {adam} over 3 steps")
        # the kernels' update against the plain one on this state and random gradients
        # of the step's leaves, their norm under the clip: the same bits
        gen = torch.Generator(device="cuda").manual_seed(it)
        nerf = engine.tree_leaves(state.nerf_params)
        pose = engine.tree_leaves(state.pose_params)
        optimize = stage == "coarse"
        g_nerf = [torch.randn(t.shape, device="cuda", generator=gen) * 1e-5 for t in nerf]
        g_pose = [torch.randn(t.shape, device="cuda", generator=gen) * 1e-5 if optimize
                  else None for t in pose]
        args = (tr.tx_nerf, tr.tx_pose if optimize else None, nerf, g_nerf,
                state.opt_state_nerf, pose, g_pose, state.opt_state_pose, state.nan_count,
                tr.cfg.get("skip_large_gradients"))
        got = fused_adam.update(*args, pose_norm=optimize)
        ref = engine.update_plain(*args, pose_norm=optimize)
        norm_rel = abs(float(got.grad_norm_nerf) / float(ref.grad_norm_nerf) - 1)
        pairs = list(zip(got.nerf_params + got.pose_params + got.opt_nerf.mu + got.opt_nerf.nu,
                         ref.nerf_params + ref.pose_params + ref.opt_nerf.mu + ref.opt_nerf.nu))
        differ = sum(not torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in pairs)
        if norm_rel > 1e-6 or differ or float(ref.grad_norm_nerf) >= 0.1:
            raise AssertionError(f"fused-adam: {stage}: norm {norm_rel:.3g} relative to the "
                                 f"plain update's ({float(ref.grad_norm_nerf):.4g}), {differ} "
                                 f"of {len(pairs)} leaves not bit for bit")
        out[stage] = dict(iteration=it, leaves=len(nerf) + len(pose), loss=float(stats["all"]),
                          norm_rel=norm_rel, leaves_equal=len(pairs))
    phase("fused-adam", f"card tests: {tail}; full shape, launch.adam 1 a step, no sync under "
                        f"set_sync_debug_mode('error') over 3 steps of each stage; against the "
                        f"plain update: " + json.dumps({k: out[k] for k in ("coarse", "fine")}))
    return out


# the card's name and power limit (nvidia-smi), printed beside every time
# and memory figure of the phases that follow
CARD_TAG = ""

# the PDC-Net trainer, card against CPU (TF32 on globally; the step turns it
# off): the loss within 1e-5 relative. Its gradients at 300x400 are sums
# over ~60k pixels with cancellation: the CPU's float32 gradient lies up to
# 1.14e-4 of scale from the float64 one (ref4_dec1's bias, random init), so
# two float32 orders do not agree within 1e-4 of scale. Each parameter's
# gradient on the card is held to the float64 gradient of the same
# augmented batch (computed on the CPU) within twice the CPU's largest
# float32 error. The bundled weights' ladder eval: per-pair median EPE
# within 0.01 px
PDC_TRAIN_TOL = {"loss_rel": 1e-5, "grad_vs_cpu": 2.0, "epe_px": 1e-2}
# the LPIPS trainer, ten steps in lockstep (the card's step from the CPU's
# state each time): losses within 1e-5 relative; each gradient tensor,
# computed in float32 along the max-pool routes and ReLU masks of the card's
# float64 forward of the same batch, within 1e-4 of the largest magnitude of
# that float64 gradient. Left to choose its own routes, the float32 gradient
# is discontinuous: max-pool windows whose top activations lie within float32
# rounding of each other route their gradient elsewhere in float32 than in
# float64, on the CPU as on the card (up to 4.7e-2 of scale at batch 16 from
# seed 0, and 7.1e-6 once the routes are given; PERF.md), so those gaps are
# printed, not held
LPIPS_TRAIN_TOL = {"loss_rel": 1e-5, "grad_routed": 1e-4}


def _pdcnet_step_draws(rng, B: int, H: int, W: int, n_pairs: int) -> list:
    """One training step's draws in the order train_step takes them: pair
    indices, pair orders, zoom factors, then each view's photometric draws."""
    import numpy as np

    draws = [rng.randint(0, n_pairs, B), rng.randint(0, 2, B),
             rng.uniform(size=(B, 2)).astype(np.float32)]
    for _ in range(2):
        draws += [rng.uniform(size=(B, 3, 1, 1)).astype(np.float32),
                  rng.uniform(size=(B, 1, 1, 1)).astype(np.float32),
                  rng.standard_normal((B, 3, H, W)).astype(np.float32),
                  rng.uniform(size=(B, 1, 1, 1)).astype(np.float32)]
    return draws


def run_pdcnet_train_phase(steps: int = 30, H: int = 300, W: int = 400) -> dict:
    """The PDC-Net trainer at 300x400, batch 2: 4 pairs generated through
    --data_cache; one step on the card against the CPU with TF32 on; then
    `steps` steps through the script's entry point on the card (s/step, peak
    memory, loss trend) and --eval-only of the bundled weights, card against
    CPU."""
    import numpy as np
    import torch

    from sparf_tpu_torch.models import pdcnet as P
    from sparf_tpu_torch.scripts import train_pdcnet_synth as tr
    from sparf_tpu_torch.training.engine import Adam
    from sparf_tpu_torch.utils.draws import ReplayDraws

    B = 2
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        cache = os.path.join(tmp, "pairs.npz")
        t0 = time.perf_counter()
        tr.main(["--gen_only", "--pairs", "4", "--H", str(H), "--W", str(W), "--data_cache",
                 cache, "--out", os.path.join(tmp, "w.npz")])
        out["generate_s"] = time.perf_counter() - t0
        with np.load(cache) as d:
            imgs, corres, valid = d["imgs"], d["corres"], d["valid"]
        # one step, card against CPU, TF32 on for cuBLAS and cuDNN
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        draws = _pdcnet_step_draws(np.random.RandomState(5), B, H, W, imgs.shape[0])
        u8 = np.clip(imgs * 255.0 + 0.5, 0, 255).astype(np.uint8)
        res = {}
        for key, dev in (("cpu", "cpu"), ("card", CARD)):
            model = P.PDCNet(generator=torch.Generator().manual_seed(0), device=dev)
            tx = Adam(tr.cosine_lr(2e-4, 3000), clip_norm=1.0)
            pool = tuple(torch.as_tensor(a, device=dev) for a in (u8, corres, valid))
            loss, _, grads, _ = tr.train_step(model, tx, tx.init(list(model.parameters())), pool,
                                              ReplayDraws(draws, dev), B)
            res[key] = (float(loss), [g.detach().cpu().double() for g in grads])
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        # the float64 gradient of the same augmented batch (augmented in float32 on the CPU)
        d = ReplayDraws(draws, "cpu")
        pool = tuple(torch.as_tensor(a) for a in (u8, corres, valid))
        tgt, src, c, v = tr.zoom_aug(d, *tr.sample_batch(pool, d, B))
        tgt, src = tr.photometric_aug(d, tgt), tr.photometric_aug(d, src)
        model = P.PDCNet(generator=torch.Generator().manual_seed(0)).double()
        loss64, _ = tr.pdcnet_loss(model, tgt.double(), src.double(), c.double(), v.double())
        g64 = torch.autograd.grad(loss64, list(model.parameters()))
        names = [n for n, _ in model.named_parameters()]
        (l_cpu, g_cpu), (l_card, g_card) = res["cpu"], res["card"]
        loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
        worst = []
        for n, a, b, g in zip(names, g_card, g_cpu, g64):
            scale = float(g.abs().max().clamp(min=1e-30))
            worst.append((float((a - g).abs().max()) / scale, float((b - g).abs().max()) / scale,
                          float((a - b).abs().max()) / scale, n))
        bound = PDC_TRAIN_TOL["grad_vs_cpu"] * max(w[1] for w in worst)
        bad = [w for w in worst if w[0] > bound]
        if loss_rel > PDC_TRAIN_TOL["loss_rel"] or bad:
            raise AssertionError(f"pdcnet-train: card step differs from the CPU step: loss "
                                 f"{l_card} vs {l_cpu} (rel {loss_rel:.3g}); gradients (card vs "
                                 f"float64, cpu vs float64, card vs cpu; of scale) past {bound:.3g}:"
                                 f" {bad}")
        top = max(worst)
        phase("pdcnet-train", f"TF32 on: one step at {H}x{W}, batch {B}, card = CPU: loss "
                              f"{l_card:.6f} vs {l_cpu:.6f} (rel {loss_rel:.3g}; float64 "
                              f"{float(loss64):.6f}); gradients of {len(names)} parameters "
                              f"against float64: card within {top[0]:.3g} of scale ({top[3]}; "
                              f"the CPU's float32 {top[1]:.3g} there), card vs CPU within "
                              f"{max(w[2] for w in worst):.3g}")
        out.update(step_check={"loss_rel": loss_rel, "grad_card_vs_f64": top[0],
                               "grad_cpu_vs_f64": max(w[1] for w in worst),
                               "grad_card_vs_cpu": max(w[2] for w in worst), "worst": top[3]})
        # the entry point: `steps` steps on the card, then its ladder eval
        torch.cuda.reset_peak_memory_stats()
        run = tr.main(["--steps", str(steps), "--pairs", "4", "--H", str(H), "--W", str(W),
                       "--data_cache", cache, "--out", os.path.join(tmp, "w.npz")])
        tr_out = run["train"]
        steady = tr_out["step_seconds"][3:]
        losses = tr_out["losses"]
        out.update(s_per_step=float(np.median(steady)), s_per_step_min=float(np.min(steady)),
                   s_per_step_max=float(np.max(steady)),
                   peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                   loss_first5=float(np.mean(losses[:5])), loss_last5=float(np.mean(losses[-5:])))
        if not np.isfinite(losses).all():
            raise AssertionError(f"pdcnet-train: non-finite loss {losses}")
        with np.load(os.path.join(tmp, "w.npz")) as w:
            if "provenance" not in w.files:
                raise AssertionError("pdcnet-train: the written npz has no provenance")
    phase("pdcnet-train", f"{steps} steps at {H}x{W}, batch {B} ({CARD_TAG}): median "
                          f"{out['s_per_step']:.4f} s/step after 3 (min {out['s_per_step_min']:.4f},"
                          f" max {out['s_per_step_max']:.4f}), peak memory "
                          f"{out['peak_mem_gib']:.3f} GiB, loss {out['loss_first5']:.4f} (first 5)"
                          f" -> {out['loss_last5']:.4f} (last 5); pairs generated in "
                          f"{out['generate_s']:.1f} s (host)")
    # --eval-only on the bundled weights, card against CPU
    evals = {}
    for key, dev in (("cpu", "cpu"), ("card", CARD)):
        t0 = time.perf_counter()
        evals[key] = tr.main(["--eval-only", P.BUNDLED_WEIGHTS, "--H", str(H), "--W", str(W),
                              "--device", dev])["eval"]
        out[f"eval_{key}_s"] = time.perf_counter() - t0
    worst = 0.0
    for span, row in evals["cpu"].items():
        for a, b in zip(evals["card"][span]["median_epe"], row["median_epe"]):
            if np.isfinite(b) or np.isfinite(a):
                worst = max(worst, abs(a - b))
    if not worst <= PDC_TRAIN_TOL["epe_px"]:
        raise AssertionError(f"pdcnet-train: the card's ladder eval differs from the CPU's by "
                             f"{worst} px: {evals}")
    out.update(eval=evals["card"], eval_epe_gap_px=worst)
    phase("pdcnet-train", f"--eval-only bundled weights at {H}x{W}: card = CPU within {worst:.3g} "
                          f"px (median EPE per pair, span 0.35 "
                          f"{[round(v, 3) for v in evals['card']['0.35']['median_epe']]}, span 1.0 "
                          f"{[round(v, 3) for v in evals['card']['1.0']['median_epe']]}); "
                          f"{out['eval_card_s']:.2f} s on the card ({CARD_TAG}), "
                          f"{out['eval_cpu_s']:.2f} s on the CPU")
    return out


@contextlib.contextmanager
def _lpips_routes(record=None, replay=None):
    """Inside the block the max-pools and ReLUs of training/lpips.py's
    features record their routes (argmax indices, ReLU masks) into `record`,
    two lists, or follow those of `replay`."""
    import torch.nn.functional as F

    if record is None and replay is None:
        yield
        return
    pool0, relu0 = F.max_pool2d, F.relu
    pools, relus = (iter(replay[0]), iter(replay[1])) if replay is not None else (None, None)

    def pool(x, k, s):
        if pools is not None:
            idx = next(pools).to(x.device)
            return x.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)
        y, idx = pool0(x, k, s, return_indices=True)
        record[0].append(idx)
        return y

    def relu(x):
        if relus is not None:
            return x * next(relus).to(x.device, x.dtype)
        record[1].append(x > 0)
        return relu0(x)

    F.max_pool2d, F.relu = pool, relu
    try:
        yield
    finally:
        F.max_pool2d, F.relu = pool0, relu0


def _lpips_grads(tl, params, arrays, dtype, device, record=None, replay=None, tf32=False):
    """(loss, gradients in sorted-name order as float64 on the CPU) of the
    LPIPS trainer's loss at `params` on one batch, in `dtype` on `device`."""
    import torch

    from sparf_tpu_torch.utils.precision import ieee_fp32

    names = sorted(params)
    p = {k: v.detach().to(device, dtype).requires_grad_(True) for k, v in params.items()}
    batch = [torch.as_tensor(x, device=device, dtype=dtype) for x in arrays]
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    if tf32:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        with contextlib.nullcontext() if tf32 else ieee_fp32(), _lpips_routes(record, replay):
            loss, _ = tl.loss_fn(p, *batch)
            grads = torch.autograd.grad(loss, [p[k] for k in names])
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    return float(loss.detach()), [g.detach().cpu().double() for g in grads]


def _of_scale(got, ref) -> float:
    """The largest over tensors of max |got - ref| / max |ref|."""
    return max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
               for a, b in zip(got, ref))


def run_lpips_train_phase(steps: int = 10, batch: int = 16) -> dict:
    """The LPIPS trainer: `steps` steps through its entry point on the card and
    on the CPU from one seed (time per step, the free-running losses, beside
    the CPU's float32 run against a float64 run from the same seed); then the
    same steps in lockstep, the card's step from the CPU's state each time,
    each batch's gradient also in float64 on the card and on the CPU, in
    float32 along the card's float64 routes (held, LPIPS_TRAIN_TOL) and, as
    a control, the same with TF32 on (printed)."""
    import numpy as np
    import torch

    from sparf_tpu_torch.scripts import train_lpips_selfsup as tl
    from sparf_tpu_torch.training.engine import Adam, AdamState

    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for key, dev in (("cpu", "cpu"), ("card", CARD)):
            runs[key] = tl.main(["--steps", str(steps), "--batch", str(batch), "--device", dev,
                                 "--out", os.path.join(tmp, f"{key}.npz")])
    scene_imgs = tl.scene_images()

    def lr_fn(count):
        return torch.full((), 1e-4, device=count.device)

    # the CPU's run in float64 from the same seed: the CPU's own float32 drift
    rng = np.random.RandomState(0)
    p64 = {k: v.detach().double().requires_grad_(True)
           for k, v in tl.initial_params(0, "cpu").items()}
    tx = Adam(lr_fn)
    s64, losses64 = tx.init([p64[k] for k in sorted(p64)]), []
    for it in range(steps):
        arrays = tl.batch_triplets(scene_imgs, rng, batch) + tl.batch_cross(scene_imgs, rng, batch)
        loss, _, _, s64 = tl.train_step(p64, tx, s64, [torch.as_tensor(
            np.asarray(x, np.float32)).double() for x in arrays])
        losses64.append(float(loss))
    a, b, c = (np.array(runs["card"]["losses"]), np.array(runs["cpu"]["losses"]),
               np.array(losses64))
    free = dict(card_vs_cpu=float(np.max(np.abs(a - b) / np.abs(b))),
                cpu_vs_f64=float(np.max(np.abs(b - c) / np.abs(c))),
                card_vs_f64=float(np.max(np.abs(a - c) / np.abs(c))))

    rng = np.random.RandomState(0)
    params = tl.initial_params(0, "cpu")
    state = tx.init([params[k] for k in sorted(params)])
    rows = []
    for it in range(steps):
        arrays = [np.asarray(x, np.float32) for x in tl.batch_triplets(scene_imgs, rng, batch)
                  + tl.batch_cross(scene_imgs, rng, batch)]
        routes = ([], [])
        _, g64_card = _lpips_grads(tl, params, arrays, torch.float64, CARD, record=routes)
        _, g64_cpu = _lpips_grads(tl, params, arrays, torch.float64, "cpu")
        _, g_routed = _lpips_grads(tl, params, arrays, torch.float32, CARD, replay=routes)
        _, g_tf32 = _lpips_grads(tl, params, arrays, torch.float32, CARD, replay=routes,
                                 tf32=True)
        p_card = {k: v.detach().clone().to(CARD).requires_grad_(True) for k, v in params.items()}
        s_card = AdamState(state.count.to(CARD), [m.to(CARD) for m in state.mu],
                           [v.to(CARD) for v in state.nu])
        l_card, _, g_card, _ = tl.train_step(p_card, tx, s_card,
                                             [torch.as_tensor(x, device=CARD) for x in arrays])
        l_cpu, _, g_cpu, state = tl.train_step(params, tx, state,
                                               [torch.as_tensor(x) for x in arrays])
        g_card = [g.detach().cpu().double() for g in g_card]
        g_cpu = [g.detach().double() for g in g_cpu]
        rows.append(dict(loss_rel=abs(float(l_card) - float(l_cpu)) / abs(float(l_cpu)),
                         routed=_of_scale(g_routed, g64_card),
                         routed_tf32=_of_scale(g_tf32, g64_card),
                         card_vs_f64=_of_scale(g_card, g64_card),
                         cpu_vs_f64=_of_scale(g_cpu, g64_cpu),
                         f64_card_vs_cpu=_of_scale(g64_card, g64_cpu),
                         card_vs_cpu=_of_scale(g_card, g_cpu)))
    worst = {k: max(r[k] for r in rows) for k in rows[0]}
    if (worst["loss_rel"] > LPIPS_TRAIN_TOL["loss_rel"]
            or worst["routed"] > LPIPS_TRAIN_TOL["grad_routed"]):
        raise AssertionError(f"lpips-train: the card's step from the CPU's state differs: loss "
                             f"{worst['loss_rel']:.3g} relative, gradient along the float64 "
                             f"routes {worst['routed']:.3g} of scale; per step {rows}")
    steady = runs["card"]["step_seconds"][2:]
    out = dict(lockstep=rows, worst=worst, free_running=free,
               s_per_step=float(np.median(steady)),
               s_per_step_cpu=float(np.median(runs["cpu"]["step_seconds"][2:])),
               loop_s=runs["card"]["seconds"], rank_acc=runs["card"]["rank_acc"])
    per_step = ", ".join(f"{r['cpu_vs_f64']:.2g}/{r['card_vs_f64']:.2g}" for r in rows)
    phase("lpips-train", f"{steps} steps at batch {batch} from seed 0 in lockstep, card = CPU: "
                         f"losses within {worst['loss_rel']:.3g} relative; gradients along the "
                         f"card's float64 routes within {worst['routed']:.3g} of scale of "
                         f"float64 (TF32 on: {worst['routed_tf32']:.3g}); on their own routes, "
                         f"float32 against float64 per step (CPU/card, of scale): {per_step}; "
                         f"float64 card vs CPU {worst['f64_card_vs_cpu']:.3g}. Free-running "
                         f"from the same seed the losses part by up to "
                         f"{free['card_vs_cpu']:.3g} relative card vs CPU, "
                         f"{free['cpu_vs_f64']:.3g} CPU float32 vs float64 ({a[0]:.5f} -> "
                         f"{a[-1]:.5f}); median {out['s_per_step']:.4f} s/step after 2 on the "
                         f"card ({CARD_TAG}), {out['s_per_step_cpu']:.4f} on the CPU; the "
                         f"card's loop with host batch generation {out['loop_s']:.2f} s")
    return out


def run_diag_phase() -> dict:
    """The three diagnostic scripts at a small size on the card."""
    from sparf_tpu_torch.scripts import diag_matcher, diag_sfm_init, diag_sfm_oracle

    out = {}
    for name, fn, argv in (
            ("diag_matcher", diag_matcher.main,
             ["--H", "64", "--W", "80", "--span", "0.35", "--priors", "3", "--bootstrap", "40",
              "--rounds"]),
            ("diag_sfm_init", diag_sfm_init.main, ["--backend", "zncc", "--H", "32", "--W", "40"]),
            ("diag_sfm_oracle", diag_sfm_oracle.main, [])):
        t0 = time.perf_counter()
        if fn(argv) != 0:
            raise AssertionError(f"diag: {name} failed")
        out[name] = time.perf_counter() - t0
    phase("diag", "exit 0 on the card: " + ", ".join(f"{k} {v:.1f} s" for k, v in out.items())
          + f" ({CARD_TAG})")
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--kernels-only", action="store_true")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    # 1. device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    global CARD_TAG
    CARD_TAG = smi.stdout.strip().splitlines()[0]
    print(CARD_TAG, flush=True)
    phase("device", f"{kind}, {torch.cuda.device_count()} visible, torch {torch.__version__} "
                    f"cuda {torch.version.cuda}, TF32 off")

    # 2. build
    from sparf_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load_library()
    phase("build", f"{time.perf_counter() - t0:.1f} s, {_build.BuildInfo.path.name}; "
          + ptxas_summary(_build.BuildInfo.log))

    # 3. kernels, the 3xTF32 and the bf16 variants, on the presets' chain and
    # on the other chains of the domain; routes: the domain's edges
    checks = check_kernels()
    checks_bf16 = check_kernels(bf16=True)
    wide = {}
    for chain in KERNEL_CHAINS:
        for bf16 in (False, True):
            r = check_kernels(bf16, chain)
            wide[f"{'bf16' if bf16 else 'fp32'} {chain}"] = {
                "plan": r["plan"], "max_abs_err": r["max_abs_err"], "flipped": r["flipped"],
                "ms": r["ms"], "bound_ms": {k: b["bound_ms"] for k, b in r["bounds"].items()},
                "share": {k: b["bound_ms"] / r["ms"][k] for k, b in r["bounds"].items()}}
    routes = check_routes()
    if args.kernels_only:
        print(json.dumps({"fp32": checks, "bf16": checks_bf16, "wide_chains": wide,
                          "routes": routes}))
        return 0

    seconds = {}

    def timed(name, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        seconds[name] = time.perf_counter() - t0
        return out

    # 4. slice-check: the tiny step on the card against the CPU; then gradient
    # accumulation and the N-step trajectory, card against CPU
    timed("slice-check", check_step_cuda_vs_cpu)
    timed("accum-check", check_accum_cuda_vs_cpu)
    traj = timed("trajectory-check", check_trajectory_cuda_vs_cpu)
    # bf16-check: the tiny step and trajectory at compute_dtype bfloat16, card vs CPU
    timed("bf16-check", check_step_cuda_vs_cpu, BF16, "bf16-check")
    traj_bf16 = timed("bf16-trajectory-check", check_trajectory_cuda_vs_cpu, BF16, TRAJ_TOL_BF16,
                      "bf16-check")
    timed("bf16-cli", check_bf16_cli)
    # wide-check: the wide chain through the kernels and with use_pallas=False,
    # the kernels refuse a chain past their domain; use_pallas=False at the
    # tiny config's chain; card vs CPU
    timed("wide-check", check_wide, False)
    timed("wide-check-bf16", check_wide, True)
    timed("use_pallas=False", check_step_cuda_vs_cpu, PLAIN_MLP, "use_pallas=False")
    # 5.-6. matcher-check and matcher, TF32 on (the matchers switch it off)
    scene = full_scene()
    mc = timed("matcher-check", check_matchers_cuda_vs_cpu, scene)
    mc["geometry"] = timed("geometry-check", check_geometry_cuda_vs_cpu, scene)
    mp = timed("matcher", run_matcher_phase, scene)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    # 7. slice: the full shape on the presets' default pools (PDC-Net + geometry stage)
    sl = timed("slice", run_slice, steps=3,
               matcher_pool_sizes=mp["PDCNet_geometry"]["pool_sizes"])
    # bf16 slice: the same step shape at compute_dtype bfloat16
    sb = timed("bf16-slice", run_bf16_slice, 3, sl)
    # wide-slice: the full-shape joint step at posenc.L_3D=12 (the kernels' wide plans)
    ws = timed("wide-slice", run_wide_slice, 3, {"fp32": sl["joint_coarse"],
                                                 "bf16": sb["joint_coarse"]})
    # 8. eval-check: the tiny evaluation on the card against the CPU
    timed("eval-check", check_eval_cuda_vs_cpu)
    # 9. eval: the full-shape trainer's state through the eval entry point
    ev = timed("eval", run_eval_phase, sl["trainer"])
    # video: novel-view rgb and depth videos of the full-shape trainer (K3)
    vd = timed("video", run_video_phase, sl["trainer"])
    del sl["trainer"]
    # 10.-12. the fixed-pose trainer, DS-NeRF and gradient accumulation at the full shape
    fx = timed("fixed-pose", run_fixed_pose_phase, steps=3)
    ds = timed("dsnerf", run_dsnerf_phase, steps=3)
    ac = timed("accum", run_accum_phase, steps=4)
    # 13. merged rendering: the tiny step card vs CPU and vs the card's
    # per-bundle step, then the full-shape A/B
    timed("merged-check", check_step_cuda_vs_cpu, MERGED, "merged-check")
    timed("merged-check-card", check_merged_cuda_vs_per_bundle)
    ms = timed("merged-slice", run_merged_slice, steps=5)
    # 14. ray sharding over processes on the one card
    mu = timed("multi-check", check_multi)
    # 15. the step profile
    pr = timed("profile", run_profile_phase)
    fa = timed("fused-adam", run_fused_adam_phase)
    # 16.-18. the PDC-Net and LPIPS trainers and the diagnostic scripts
    pt = timed("pdcnet-train", run_pdcnet_train_phase)
    lt = timed("lpips-train", run_lpips_train_phase)
    dg = timed("diag", run_diag_phase)
    phase("phases", "seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))

    src = "sparf_tpu_torch/csrc/fused_mlp.cu"
    src_wg = "sparf_tpu_torch/csrc/fused_mlp_wgmma.cu"  # K1, K2 and K3 at bf16
    replaces = {"K1": "sparf_tpu/ops/fused_mlp_vjp.py:175", "K2": "sparf_tpu/ops/fused_mlp_vjp.py:86",
                "K3": "sparf_tpu/ops/fused_mlp.py:97"}
    names = {"K1": "K1_fused_mlp_forward", "K2": "K2_fused_mlp_backward",
             "K3": "K3_fused_mlp_forward_packed"}
    kernels = []
    ws_paths = {k: {"launches": v} for k, v in ws["launches"].items()}
    earlier = {k: sum(p["launches"][k] for p in (sl, ev, fx, ds, ac, vd, ms, mu))
               for k in ("K1", "K2", "K3")}
    phase("launches", f"fp32 K1/K2/K3 on the earlier paths {earlier}, on the wide-slice "
                      f"{ws['launches']['fp32']}; bf16 on the bf16-slice {sb['launches']}, on the "
                      f"wide-slice {ws['launches']['bf16']}")
    for dtype, chk, paths in (("float32", checks, (sl, ev, fx, ds, ac, vd, ms, mu,
                                                   ws_paths["fp32"])),
                              ("bfloat16", checks_bf16, (sb, ws_paths["bf16"]))):
        for k in ("K1", "K2", "K3"):
            b = chk["bounds"][k]
            kernels.append({
                "name": names[k] + ("_bf16" if dtype == "bfloat16" else ""), "route": "cuda",
                "source": src_wg if dtype == "bfloat16" else src,
                "replaces": replaces[k], "dtype": dtype,
                "launches": sum(p["launches"][k] for p in paths),
                "max_abs_err": chk["max_abs_err"][k], "ms": chk["ms"][k],
                "plain_ms": chk["ms"][f"{k}_plain"], "bound_ms": b["bound_ms"],
                "bound_by": b["bound_by"], "library_ms": None,
                "bound_share": b["bound_ms"] / chk["ms"][k], "bound_fp32_ms": b["bound_fp32_ms"]})
    print(json.dumps({"kernels": kernels,
                      "it_per_sec": {k: sl[k] for k in ("joint_coarse", "fine")},
                      "bf16_it_per_sec": {k: sb[k] for k in ("joint_coarse", "fine")},
                      "wide_slice": ws, "wide_chains": wide, "routes": routes,
                      "eval_s": {"render": ev["render_s"], "refine": ev["refine_s"]},
                      "video_s_per_frame": vd["s_per_frame"],
                      "trajectory_gaps": traj, "bf16_trajectory_gaps": traj_bf16,
                      "fixed_pose": {k: fx[k] for k in ("coarse", "fine", "eval_s")},
                      "dsnerf": {k: ds[k] for k in ("triangulation_s", "it_per_sec",
                                                    "perc_col_depth")},
                      "accum_it_per_sec": ac["it_per_sec"],
                      "merged_it_per_sec": {k: ms[k] for k in ("joint_coarse", "fine")},
                      "multi": mu, "profile_fine_fp32": pr, "fused_adam": fa,
                      "pdcnet_train": {k: v for k, v in pt.items() if k != "eval"},
                      "lpips_train": lt, "diag_s": dg,
                      "matcher": {"check": mc, "pools": mp, "refresh_s": sl["refresh_s"],
                                  "refresh_geometry": sl["refresh_geometry"]},
                      "phase_s": seconds}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
