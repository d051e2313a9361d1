#!/usr/bin/env python
"""Where K2's time goes: times K2 at T = 262,144 on the full 8x256 chain
beside timing-only builds that each drop one part of its work, and K1 and
K3 (on pack_weights' layout) beside them, for the 3xTF32 variants
(compute_dtype float32: K1 and K3 in csrc/fused_mlp.cu, K2 on wgmma in
csrc/fused_mlp_wgmma.cu, k2_tf and k2_dw_tf) and the bf16 ones
(csrc/fused_mlp_wgmma.cu: k1_wg, k3_wg, k2_wg). Needs one CUDA card and
nvcc.

Usage (from the repository root):
    python -m sparf_tpu_torch.kernel_split [--T 262144] [--reps 10]

Variants (macros of the csrc header notes; their outputs are wrong, only
their times are read): no_fwd drops the recompute's MMAs, no_dw the dW pass
(k2_dw_tf, k2_dw_wg; k2_dw where fused_mlp.cu's K2 runs), no_gx the g_x
MMAs. The builds run in parallel; the timings run in turns, full first and
last.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
from concurrent.futures import ThreadPoolExecutor

VARIANTS = {
    "full": (),
    "no_fwd": ("K2_TIME_NO_FWD",),
    "no_dw": ("K2_TIME_NO_DW",),
    "no_gx": ("K2_TIME_NO_GX",),
}


def _median_ms(fn, reps: int) -> float:
    import torch

    fn()
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--T", type=int, default=262144)
    parser.add_argument("--reps", type=int, default=10)
    args = parser.parse_args(argv)

    import torch

    from sparf_tpu_torch.models import nerf_mlp
    from sparf_tpu_torch.ops import _build
    from sparf_tpu_torch.ops import fused_mlp as fm

    if not torch.cuda.is_available():
        raise SystemExit("kernel_split: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        paths = dict(zip(VARIANTS, pool.map(_build.build, VARIANTS.values())))
    for line in paths["full"].with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("[ptxas]", line.strip())
    libs = {name: _build.load_library(defs) for name, defs in VARIANTS.items()}

    cfg = nerf_mlp.MLPConfig(view_dep=True, barf_c2f=(0.4, 0.7))
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = nerf_mlp.init_nerf_params(gen, cfg, device="cuda")
    weights = fm.flat_weights(params)
    metas = {"fp32": fm.FusedMeta.from_cfg(cfg),
             "bf16": fm.FusedMeta.from_cfg(dataclasses.replace(cfg, compute_dtype=torch.bfloat16))}
    T = args.T
    pts_enc = nerf_mlp.encode_points(cfg, torch.randn((T, 3), generator=gen, device="cuda"),
                                     0.55).contiguous()
    view_enc = nerf_mlp.encode_views(
        cfg, nerf_mlp.unit_rays(torch.randn((T, 3), generator=gen, device="cuda")),
        0.55).contiguous()
    g_d = torch.randn(T, generator=gen, device="cuda")
    g_rgb = torch.randn((T, 3), generator=gen, device="cuda")

    real_load = _build.load_library
    times = {}
    try:
        for dtype, meta in metas.items():
            for name in (*VARIANTS, "full"):
                _build.load_library = lambda defines=(), lib=libs[name]: lib
                k2 = _median_ms(lambda: fm._launch_k2(meta, pts_enc, view_enc, weights, g_d,
                                                      g_rgb), args.reps)
                times.setdefault(f"{dtype}_K2_{name}", []).append(k2)
                if name == "full":
                    k1 = _median_ms(lambda: fm._launch_k1(meta, pts_enc, view_enc, weights),
                                    args.reps)
                    times.setdefault(f"{dtype}_K1", []).append(k1)
                    packed = fm.pack_weights(params, meta)
                    k3 = _median_ms(lambda: fm._launch_k3(meta, pts_enc, view_enc, packed),
                                    args.reps)
                    times.setdefault(f"{dtype}_K3", []).append(k3)
    finally:
        _build.load_library = real_load
    result = {"card": smi, "T": T, "ms": times}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
