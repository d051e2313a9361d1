#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sparf_tpu_torch) on one NVIDIA GPU.

Usage (from the repository root, on a machine with a CUDA card and nvcc):

    python3 chip_smoke.py                 # all phases
    python3 chip_smoke.py --kernels-only  # build + kernel checks, no training

Phases, one line each; any failure raises and the process exits non-zero:
  1. device: name, power limit, TF32 off for matmuls and cuDNN;
  2. build: nvcc builds the kernels of sparf_tpu_torch/csrc for sm_90a;
  3. kernels: the fragment packing (k_pack) bit for bit against its plain
     version; K1 (fused MLP forward), K2 (backward) and K3 (forward on
     packed weights), 3xTF32 on the tensor cores, at the full 8x256 width,
     ragged T, both view_dep settings and an active coarse-to-fine mask,
     against their plain torch versions (K3 also against K1's); K2 run twice
     must give the same bits; median times at T = 262,144 beside each
     kernel's bound (fp32 cores and 3xTF32 tensor cores) and its plain
     cuBLAS chain;
  4. slice-check: one step of the tiny sparf config on the card against the
     same step on the CPU (plain versions, same parameters and draws), in
     both stages;
  5. matcher-check: with TF32 on for cuBLAS and cuDNN, the port's matchers
     on the card against the same calls on the CPU, on the 300x400 3-view
     synthetic scene: the PDC-Net forward with the bundled weights (max
     |delta mapping| in px at /2, max |delta p_r|) and its full-size flows,
     find_fundamental_ransac on that pair's confident matches with one
     generator seed (inlier agreement), SPSG (matched-pixel agreement) and
     ZNCC stage 1 (agreement on confident pixels and on the pool masks);
  6. matcher: build_correspondence_pools for the 6 ordered pairs of that
     scene with raw PDC-Net (bundled weights) and with SPSG: seconds of
     matching, verification and pool building, pairs kept, pool sizes,
     flow quality against GT (EPE, PCK-1/3, all and in-confidence); then
     the steps/s of a short self_supervised_adapt run;
  7. slice: the SPARF joint pose+NeRF trainer built through define_trainer
     on device "cuda" at the bench.py full shape, on correspondence pools
     from raw PDC-Net (not GT depth), 3+ steps in the joint coarse stage and
     3+ in the fine stage, with the kernels' launch counts of those steps
     (the depth-consistency visibility pass runs K3), and one timed
     refresh_correspondence_pools (the mid-training rematch); its pools,
     built with TF32 off, must equal the matcher phase's (TF32 on);
  8. eval-check: with cuDNN TF32 at PyTorch's default (on), evaluate_full of
     the tiny config with test-time pose refinement on the card against the
     same call on the CPU (same state, replayed pixel draws); a snapshot
     saved on the card loads on the CPU with the same bits;
  9. eval: the port's eval.run_eval on the full-shape trainer after its
     fine-stage steps: one 300x400 test view, with and without 100 steps of
     test-time refinement; seconds per full-image render and per
     refinement, launch counts, metrics.
Then a JSON line with every kernel, and last {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

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

# published peaks of one H100 SXM at 700 W (NVIDIA H100 datasheet)
PEAK_FP32 = 67e12      # FLOP/s, fp32 on the CUDA cores
PEAK_TF32 = 495e12     # FLOP/s, TF32 on the tensor cores, dense
PEAK_BYTES = 3.35e12   # bytes/s of HBM


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def rel_err(a, b) -> tuple:
    """(max abs error, max abs error / max abs reference)."""
    err = float((a - b).abs().max()) if a.numel() else 0.0
    scale = float(b.abs().max()) if b.numel() else 0.0
    return err, err / max(scale, 1e-6)


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


def ptxas_summary(log: str) -> str:
    """Registers, stack and spills of each kernel, from nvcc's -Xptxas -v output."""
    kernels, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = _last_component(m.group(1))
            kernels[name] = []
        elif name and ("registers" in line or "spill" in line):
            kernels[name].append(line.split(" : ")[-1].strip())
    return "; ".join(f"{k}: {', '.join(v)}" for k, v in kernels.items())


def _last_component(mangled: str) -> str:
    """The function's own name in an Itanium-mangled (possibly nested) name."""
    rest = mangled[3:] if mangled.startswith("_ZN") else mangled[2:]
    last = mangled
    while rest[:1].isdigit():
        n = re.match(r"\d+", rest).group()
        last, rest = rest[len(n): len(n) + int(n)], rest[len(n) + int(n):]
    return last


def kernel_inputs(view_dep: bool, T: int, seed: int):
    """Full-width MLP (as flat weights and as the parameter tree), encoded
    inputs of T random points, output gradients."""
    import torch

    from sparf_tpu_torch.models import nerf_mlp
    from sparf_tpu_torch.ops import fused_mlp as fm

    cfg = nerf_mlp.MLPConfig(view_dep=view_dep, barf_c2f=(0.4, 0.7))
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

    from sparf_tpu_torch.ops import fused_mlp as fm

    _, _, xs = fm._forward_chain(meta, pts_enc, view_enc, weights)
    out = torch.full((pts_enc.shape[0],), float("inf"), device=pts_enc.device)
    for li, x in enumerate(xs[:-1]):
        z = torch.addmm(weights[2 * li + 1], x, weights[2 * li].t())
        if li == meta.n_feat - 1:
            z = z[:, 1:]
        out = torch.minimum(out, z.abs().amin(dim=1))
    return out


def kernel_bounds(meta, weights, T: int) -> dict:
    """Per kernel, the least time the card could take for its work on these
    shapes: the larger of its bytes (inputs read once, outputs written once)
    over HBM's rate and its operations over the peak: fp32 FLOP on the CUDA
    cores, and 3 TF32 products per fp32 product on the tensor cores (3xTF32,
    what the kernels run). Returns ms and what bounds each."""
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
        t_bytes, t_fp32, t_3x = nbytes / PEAK_BYTES, flop / PEAK_FP32, 3 * flop / PEAK_TF32
        out[k] = {"bound_ms": 1e3 * max(t_bytes, t_3x),
                  "bound_by": "bytes" if t_bytes > t_3x else "operations",
                  "bound_fp32_ms": 1e3 * max(t_bytes, t_fp32), "flop": flop, "bytes": nbytes}
    return out


def check_packing(meta, weights, params) -> None:
    """k_pack's two fragment sets against pack_fragments_plain, bit for bit."""
    import torch

    from sparf_tpu_torch.ops import _build
    from sparf_tpu_torch.ops import fused_mlp as fm

    lib = _build.load_library()
    dims = fm._dims(meta, weights)
    frag = torch.empty((2, fm._sizes(lib, dims, "pack")[1]), device="cuda")
    rc = lib.sparf_fused_mlp_pack(dims, fm._ptrs(weights), frag[0].data_ptr(),
                                  frag[1].data_ptr(), torch.cuda.current_stream().cuda_stream)
    fm._raise_rc(lib, rc, "k_pack")
    plain = [fm.pack_fragments_plain(meta.dims(weights), weights, transposed=t)
             for t in (False, True)]
    packed = fm.pack_weights(params, meta).frag
    torch.cuda.synchronize()
    for name, a, b in (("forward", frag[0], plain[0]), ("transposed", frag[1], plain[1]),
                       ("pack_weights", packed, plain[0])):
        if not torch.equal(a, b):
            raise AssertionError(f"k_pack {name} fragments differ from the plain packing in "
                                 f"{int((a != b).sum())} of {a.numel()} floats")


def check_kernels() -> dict:
    import torch

    from sparf_tpu_torch.ops import fused_mlp as fm

    worst = {"K1": 0.0, "K2": 0.0, "K3": 0.0}
    for view_dep in (True, False):
        for T in (131071, 262145):
            meta, pts_enc, view_enc, weights, g_d, g_rgb, params = kernel_inputs(view_dep, T,
                                                                                 seed=T)
            check_packing(meta, weights, params)
            packed = fm.pack_weights(params, meta)
            dens_k, rgb_k = fm._launch_k1(meta, pts_enc, view_enc, weights)
            dens_3, rgb_3 = fm._launch_k3(meta, pts_enc, view_enc, packed)
            dens_p, rgb_p = fm.fused_mlp_forward_plain(meta, pts_enc, view_enc, weights)
            dens_pp, rgb_pp = fm.fused_mlp_forward_packed_plain(meta, pts_enc, view_enc, packed)
            torch.cuda.synchronize()
            for kname, ref_name, (a_d, a_r), (b_d, b_r) in (
                    ("K1", "K1 plain", (dens_k, rgb_k), (dens_p, rgb_p)),
                    ("K3", "K3 plain", (dens_3, rgb_3), (dens_pp, rgb_pp)),
                    ("K3", "K1 plain", (dens_3, rgb_3), (dens_p, rgb_p))):
                for name, a, b in (("density", a_d, b_d), ("rgb", a_r, b_r)):
                    err, rel = rel_err(a, b)
                    worst[kname] = max(worst[kname], err)
                    if not rel <= FWD_RTOL:
                        raise AssertionError(f"{kname} {name} vs {ref_name} view_dep={view_dep} "
                                             f"T={T}: err {err:.3g} (rel {rel:.3g}) > {FWD_RTOL}")
            k3_same_bits = torch.equal(dens_3, dens_k) and torch.equal(rgb_3, rgb_k)

            keep = (min_abs_preactivation(meta, pts_enc, view_enc, weights)
                    >= UNAMBIGUOUS_Z).float()
            g_d, g_rgb = g_d * keep, g_rgb * keep[:, None]
            out_k = fm._launch_k2(meta, pts_enc, view_enc, weights, g_d, g_rgb)
            out_k2 = fm._launch_k2(meta, pts_enc, view_enc, weights, g_d, g_rgb)
            torch.cuda.synchronize()
            flat_k = [out_k[0], out_k[1], *out_k[2]]
            flat_k2 = [out_k2[0], out_k2[1], *out_k2[2]]
            if not all(torch.equal(a, b) for a, b in zip(flat_k, flat_k2)):
                raise AssertionError(f"K2 not deterministic (view_dep={view_dep}, T={T})")
            out_p = fm.fused_mlp_backward_plain(meta, pts_enc, view_enc, weights, g_d, g_rgb)
            flat_p = [out_p[0], out_p[1], *out_p[2]]
            # autograd through the plain chain
            leaves = [t.detach().requires_grad_(True) for t in (pts_enc, view_enc, *weights)]
            d, rgb = fm.fused_mlp_forward_plain(meta, leaves[0], leaves[1], leaves[2:])
            flat_a = torch.autograd.grad((d * g_d).sum() + (rgb * g_rgb).sum(), leaves,
                                         allow_unused=True)
            flat_a = [torch.zeros_like(l) if g is None else g for g, l in zip(flat_a, leaves)]
            names = ["d_pts", "d_view"] + [f"{'W' if i % 2 == 0 else 'b'}{i // 2}"
                                           for i in range(len(weights))]
            worst_rel = 0.0
            for ref_name, flat_ref in (("plain", flat_p), ("autograd", flat_a)):
                for name, a, b in zip(names, flat_k, flat_ref):
                    err, rel = rel_err(a, b)
                    worst["K2"] = max(worst["K2"], err)
                    worst_rel = max(worst_rel, rel)
                    if not rel <= BWD_RTOL:
                        raise AssertionError(
                            f"K2 {name} vs {ref_name} view_dep={view_dep} T={T}: "
                            f"err {err:.3g} (rel {rel:.3g}) > {BWD_RTOL}")
            del out_k, out_k2, out_p, flat_a, leaves
            phase("kernels", f"view_dep={view_dep} T={T}: K1, K2 and K3 agree with the plain "
                             f"versions (worst relative error K2 {worst_rel:.3g}), K2 "
                             f"bit-identical on rerun, K3 {'' if k3_same_bits else 'not '}"
                             f"bit-identical to K1, k_pack bit-identical to its plain "
                             f"version; {1 - float(keep.mean()):.4f} of the "
                             f"points held out of the backward check (|z| < {UNAMBIGUOUS_Z})")
            torch.cuda.empty_cache()

    meta, pts_enc, view_enc, weights, g_d, g_rgb, params = kernel_inputs(True, 262144, seed=1)
    packed = fm.pack_weights(params, meta)
    times = {
        "K1": median_ms(lambda: fm._launch_k1(meta, pts_enc, view_enc, weights)),
        "K1_plain": median_ms(lambda: fm.fused_mlp_forward_plain(meta, pts_enc, view_enc,
                                                                  weights)),
        "K3": median_ms(lambda: fm._launch_k3(meta, pts_enc, view_enc, packed)),
        "K3_plain": median_ms(lambda: fm.fused_mlp_forward_packed_plain(meta, pts_enc, view_enc,
                                                                         packed)),
        "K2": median_ms(lambda: fm._launch_k2(meta, pts_enc, view_enc, weights, g_d, g_rgb)),
        "K2_plain": median_ms(lambda: fm.fused_mlp_backward_plain(meta, pts_enc, view_enc,
                                                                   weights, g_d, g_rgb)),
    }
    bounds = kernel_bounds(meta, weights, 262144)
    phase("kernels", "median ms at T=262144 (8x256, view_dep): "
          + " ".join(f"{k}={v:.3f}" for k, v in times.items()))
    phase("kernels", "bounds at T=262144: " + "; ".join(
        f"{k} 3xTF32 {b['bound_ms']:.3f} ms ({b['bound_by']}, share {b['bound_ms'] / times[k]:.3f}),"
        f" fp32 cores {b['bound_fp32_ms']:.3f} ms (share {b['bound_fp32_ms'] / times[k]:.3f})"
        for k, b in bounds.items()))
    return {"max_abs_err": worst, "ms": times, "bounds": bounds}


TINY_SPARF = dict(
    env={}, scene="spheres", max_iter=1000, use_gt_correspondences=True, min_nbr_matches=10,
    synthetic=dict(H=24, W=32, n_train=3, n_test=1),
    arch=dict(layers_feat=[None, 64, 64, 64, 64], layers_rgb=[None, 32, 3], skip=[2]),
    nerf=dict(sample_intvs=32, sample_intvs_fine=16, rand_rays=16), depth_cons_nbr_rays=16)


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


def check_step_cuda_vs_cpu() -> None:
    """One step of the tiny sparf config on the card (kernels) and on the CPU
    (plain versions) from the same parameters and draws, in both stages.
    Losses within rtol 1e-4, gradients (Adam's first moment / 0.1) within
    1e-3 of each tensor's largest magnitude, updated parameters within 1e-5."""
    import dataclasses

    from sparf_tpu_torch.training import engine
    from sparf_tpu_torch.training.define_trainer import build_config, define_trainer
    from sparf_tpu_torch.utils.draws import Draws, ReplayDraws

    def trainer_on(device):
        cfg = build_config("joint_pose_nerf_training/synthetic", "sparf", TINY_SPARF)
        return define_trainer(cfg, workspace=tempfile.mkdtemp(prefix="sparf_torch_tiny_"),
                              device=device, save_option=False)

    cpu, gpu = trainer_on("cpu"), trainer_on("cuda")
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
        new_g, stats_g = gpu.get_step(it)(st_g, ReplayDraws(rec.recorded, "cuda"))
        for k, v in stats_c.items():
            a, b = float(stats_g[k]), float(v)
            if not abs(a - b) <= 1e-6 + 1e-4 * abs(b):
                raise AssertionError(f"step at {it}: {k} cuda {a} vs cpu {b}")
        pairs = list(zip(new_g.opt_state_nerf.mu, new_c.opt_state_nerf.mu))
        if new_c.opt_state_pose is not None:
            pairs += list(zip(new_g.opt_state_pose.mu, new_c.opt_state_pose.mu))
        for a, b in pairs:
            err, rel = rel_err(a.cpu(), b)
            if not rel <= 1e-3:
                raise AssertionError(f"step at {it}: gradient off by {err:.3g} (rel {rel:.3g})")
        for a, b in zip(engine.tree_leaves(new_g.nerf_params) + list(new_g.pose_params.values()),
                        engine.tree_leaves(new_c.nerf_params) + list(new_c.pose_params.values())):
            if not float((a.cpu() - b).abs().max()) <= 1e-5:
                raise AssertionError(f"step at {it}: updated parameters differ")
        phase("slice-check", f"tiny sparf step at iteration {it}: cuda (kernels) matches cpu "
                             f"(plain versions), loss all={float(stats_g['all']):.6g}")


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
FULL_SCENE = dict(env={}, scene="spheres", synthetic=dict(H=300, W=400, n_train=3, n_test=1))
MATCHER_POOLS = dict(FULL_SCENE, use_gt_correspondences=False, pdcnet_geometry_refine=False,
                     min_nbr_matches=100)


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


def run_matcher_phase(scene, adapt_steps: int = 20) -> dict:
    """The full correspondence precompute on the card for raw PDC-Net and SPSG,
    then the rate of self_supervised_adapt."""
    import torch

    from sparf_tpu_torch.models import pdcnet
    from sparf_tpu_torch.training.define_trainer import build_config
    from sparf_tpu_torch.training.losses import corres
    from sparf_tpu_torch.utils.draws import Draws

    out = {}
    for backend in ("PDCNet", "SPSG"):
        cfg = build_config("joint_pose_nerf_training/synthetic", "sparf",
                           dict(MATCHER_POOLS, flow_backbone=backend))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pools = corres.build_correspondence_pools(cfg, scene, device=CARD)
        total = time.perf_counter() - t0
        quality = corres.compute_flow_metrics(pools, scene)
        counts = [int(c) for c in pools.get("pool_count", [])]
        out[backend] = {"seconds": dict(pools["seconds"], total=total),
                        "pairs_kept": int(pools["n_pairs"]), "pool_sizes": counts,
                        "flow_quality": quality}
        phase("matcher", f"{backend} -> {pools['backend']}: {total:.3f} s for 6 ordered pairs ("
                         + ", ".join(f"{k} {v:.3f} s" for k, v in pools["seconds"].items())
                         + f"); {pools['n_pairs']} pairs kept (> {cfg.min_nbr_matches} px), pool "
                         f"sizes {counts}; vs GT: "
                         + " ".join(f"{k}={v:.4f}" for k, v in sorted(quality.items())))
    if out["PDCNet"]["pairs_kept"] == 0:
        raise AssertionError("matcher: raw PDC-Net kept no pair")

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
        MATCHER_POOLS, max_iter=100000, flow_backbone="PDCNet"))
    workspace = tempfile.mkdtemp(prefix="sparf_torch_smoke_")
    t0 = time.perf_counter()
    trainer = define_trainer(cfg, workspace=workspace, device="cuda", save_option=False)
    pools = trainer.corres_pools
    if pools.get("backend") != "pdcnet_jax" or pools["n_pairs"] == 0:
        raise AssertionError(f"slice: no PDC-Net pools ({pools.get('backend')}, "
                             f"{pools['n_pairs']} pairs)")
    sizes = [int(c) for c in pools["pool_count"]]
    if matcher_pool_sizes is not None and sizes != matcher_pool_sizes:
        # same scene, seed and card; the matcher phase ran with TF32 on, this
        # one with it off: the matchers must not depend on the global setting
        raise AssertionError(f"slice: pool sizes {sizes} differ from the matcher phase's "
                             f"{matcher_pool_sizes}")
    phase("slice", f"trainer built in {time.perf_counter() - t0:.1f} s "
                   f"({trainer.n_train_views} views {trainer.H}x{trainer.W}, "
                   f"{pools['n_pairs']} correspondence pairs from {pools['backend']}, "
                   f"pool sizes {sizes}, equal to the matcher phase's under TF32 on)")
    ratio = float(cfg.ratio_end_joint_nerf_pose_refinement)
    stages = (("joint_coarse", 0), ("fine", int(cfg.max_iter * (ratio + 0.05))))
    result = {}
    # the main path's launches from here
    fm.K1_LAUNCHES = fm.K2_LAUNCHES = fm.K3_LAUNCHES = fm.PACK_LAUNCHES = 0
    for name, it0 in stages:
        state = dataclasses.replace(trainer.state, iteration=it0, iteration_nerf=it0)
        step = trainer.get_step(it0)
        poses_before = trainer.current_poses_w2c(state).clone()
        before = (fm.K1_LAUNCHES, fm.K2_LAUNCHES, fm.K3_LAUNCHES, fm.PACK_LAUNCHES)
        state, stats = step(state, trainer.draws)  # warm-up (allocator, first launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            state, stats = step(state, trainer.draws)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / steps
        launches = {"K1": fm.K1_LAUNCHES - before[0], "K2": fm.K2_LAUNCHES - before[1],
                    "K3": fm.K3_LAUNCHES - before[2], "pack": fm.PACK_LAUNCHES - before[3]}
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
    result["launches"] = {"K1": fm.K1_LAUNCHES, "K2": fm.K2_LAUNCHES, "K3": fm.K3_LAUNCHES,
                          "pack": fm.PACK_LAUNCHES}
    trainer.state = state
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.refresh_correspondence_pools()
    torch.cuda.synchronize()
    result["refresh_s"] = time.perf_counter() - t0
    if trainer.corres_pools["n_pairs"] == 0:
        raise AssertionError("slice: the rematch kept no pair")
    phase("slice", f"refresh_correspondence_pools (rematch with the current poses as prior): "
                   f"{result['refresh_s']:.3f} s, {trainer.corres_pools['n_pairs']} pairs")
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
            before, t0 = (fm.K1_LAUNCHES, fm.K2_LAUNCHES, fm.K3_LAUNCHES), time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            log.append((time.perf_counter() - t0, fm.K1_LAUNCHES - before[0],
                        fm.K2_LAUNCHES - before[1], fm.K3_LAUNCHES - before[2]))
            return out
        return call

    trainer.render_full_image = timed(render, renders)
    trainer.run_test_time_photometric_optim = timed(refine, refines)
    # the eval path's launches from here
    fm.K1_LAUNCHES = fm.K2_LAUNCHES = fm.K3_LAUNCHES = fm.PACK_LAUNCHES = 0
    t0 = time.perf_counter()
    results = teval.run_eval(trainer, trainer.cfg, tempfile.mkdtemp(prefix="sparf_torch_eval_"),
                             "smoke_eval")
    total = time.perf_counter() - t0
    launches = {"K1": fm.K1_LAUNCHES, "K2": fm.K2_LAUNCHES, "K3": fm.K3_LAUNCHES,
                "pack": fm.PACK_LAUNCHES}
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--kernels-only", action="store_true")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "sparf_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)

    # 1. device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    phase("device", f"{kind}, {torch.cuda.device_count()} visible, torch {torch.__version__} "
                    f"cuda {torch.version.cuda}, TF32 off")

    # 2. build
    from sparf_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load_library()
    phase("build", f"{time.perf_counter() - t0:.1f} s, {_build.BuildInfo.path.name}; "
          + ptxas_summary(_build.BuildInfo.log))

    # 3. kernels
    checks = check_kernels()
    if args.kernels_only:
        print(json.dumps(checks))
        return 0

    # 4. slice-check: the tiny step on the card against the CPU
    check_step_cuda_vs_cpu()
    # 5.-6. matcher-check and matcher, TF32 on (the matchers switch it off)
    scene = full_scene()
    mc = check_matchers_cuda_vs_cpu(scene)
    mp = run_matcher_phase(scene)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    # 7. slice: the full shape on PDC-Net pools
    sl = run_slice(steps=3, matcher_pool_sizes=mp["PDCNet"]["pool_sizes"])
    # 8. eval-check: the tiny evaluation on the card against the CPU
    check_eval_cuda_vs_cpu()
    # 9. eval: the full-shape trainer's state through the eval entry point
    ev = run_eval_phase(sl["trainer"])

    src = "sparf_tpu_torch/csrc/fused_mlp.cu"
    replaces = {"K1": "sparf_tpu/ops/fused_mlp_vjp.py:175", "K2": "sparf_tpu/ops/fused_mlp_vjp.py:86",
                "K3": "sparf_tpu/ops/fused_mlp.py:97"}
    names = {"K1": "K1_fused_mlp_forward", "K2": "K2_fused_mlp_backward",
             "K3": "K3_fused_mlp_forward_packed"}
    kernels = []
    for k in ("K1", "K2", "K3"):
        b = checks["bounds"][k]
        kernels.append({
            "name": names[k], "route": "cuda", "source": src, "replaces": replaces[k],
            "launches": sl["launches"][k] + ev["launches"][k],
            "max_abs_err": checks["max_abs_err"][k], "ms": checks["ms"][k],
            "plain_ms": checks["ms"][f"{k}_plain"], "bound_ms": b["bound_ms"],
            "bound_by": b["bound_by"], "library_ms": None,
            "bound_share": b["bound_ms"] / checks["ms"][k], "bound_fp32_ms": b["bound_fp32_ms"]})
    print(json.dumps({"kernels": kernels,
                      "it_per_sec": {k: sl[k] for k in ("joint_coarse", "fine")},
                      "eval_s": {"render": ev["render_s"], "refine": ev["refine_s"]},
                      "matcher": {"check": mc, "pools": mp, "refresh_s": sl["refresh_s"]}}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
