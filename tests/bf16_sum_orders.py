#!/usr/bin/env python
"""How far two correct summation orders of the same MLP chain put one
training step apart, on the CPU: chip_smoke.py's check_step_cuda_vs_cpu
(the tiny sparf step, both stages) with the card replaced by a second CPU
run whose MLP forward sums its products in another order. The difference
stands in for the card's cuBLAS against the CPU's BLAS, and says which of
the slice-check's bounds the wide-check's use_pallas=False step can meet.

Usage (from the repository root; no JAX, no card):
    python tests/bf16_sum_orders.py wide-bf16 [--order float64|halves|unrounded]

Chains: wide-fp32 / wide-bf16 (chip_smoke.WIDE: 8x256, L_3D=12, under
use_pallas=False: nerf_mlp.nerf_apply, the wide-check's), tiny-bf16 (the
bf16-check's 4x64, through the kernels' plain versions). Orders: float64 (each
product summed in float64, then rounded once) or halves (two float32 sums
over the halves of the inputs, added); unrounded is the control of the
wide-check, the chain without its bf16 operand rounding (what the card's
step at compute_dtype float32 computes). Prints, per iteration, the loss gap
as a share of its bound (1e-6 + 1e-4 |loss|), the worst gradient gap as a
share of its tensor's largest magnitude (bound 1e-3) and the worst
updated-parameter gap (bound 1e-5; at bf16 where |g| >= BF16_KEEP_GRAD).
"""
import argparse
import dataclasses
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from sparf_tpu_torch.models import nerf_mlp  # noqa: E402
from sparf_tpu_torch.training import engine  # noqa: E402
from sparf_tpu_torch.training.define_trainer import build_config, define_trainer  # noqa: E402
from sparf_tpu_torch.utils.draws import Draws, ReplayDraws  # noqa: E402

WIDE_PLAIN = cs._merged(cs.WIDE, cs.PLAIN_MLP)
CHAINS = {"wide-fp32": WIDE_PLAIN, "wide-bf16": cs._merged(WIDE_PLAIN, cs.BF16),
          "tiny-bf16": cs.BF16}


def other_order(order: str):
    """nerf_mlp.linear with the products summed in another order (or, for
    "unrounded", with the operands as they are)."""
    def linear(x, W, b, dtype):
        if order == "unrounded":
            return x @ W.t() + b
        x, W = nerf_mlp.round_to(x, dtype), nerf_mlp.round_to(W, dtype)
        if order == "halves":
            h = x.shape[1] // 2
            return x[:, :h] @ W[:, :h].t() + x[:, h:] @ W[:, h:].t() + b
        return (x.double() @ W.double().t() + b.double()).float()
    return linear


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("chain", choices=list(CHAINS))
    ap.add_argument("--order", choices=["float64", "halves", "unrounded"], default="halves")
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    bf16 = "bf16" in args.chain

    def trainer():
        cfg = build_config("joint_pose_nerf_training/synthetic", "sparf",
                           cs._merged(cs.TINY_SPARF, CHAINS[args.chain]))
        return define_trainer(cfg, workspace=tempfile.mkdtemp(prefix="sparf_orders_"),
                              device="cpu", save_option=False)

    a, b = trainer(), trainer()
    real = nerf_mlp.linear
    for it in (0, 350):
        st_a = dataclasses.replace(a.state, iteration=it, iteration_nerf=it)
        st_b = dataclasses.replace(b.state, iteration=it, iteration_nerf=it,
                                   nerf_params=a.state.nerf_params,
                                   pose_params=a.state.pose_params)
        rec = cs.RecordingDraws(Draws(it, "cpu"))
        new_a, stats_a = a.get_step(it)(st_a, rec)
        nerf_mlp.linear = other_order(args.order)
        try:
            new_b, stats_b = b.get_step(it)(st_b, ReplayDraws(rec.recorded, "cpu"))
        finally:
            nerf_mlp.linear = real
        loss = max(abs(float(stats_b[k]) - float(v)) / (1e-6 + 1e-4 * abs(float(v)))
                   for k, v in stats_a.items())
        pairs = list(zip(new_b.opt_state_nerf.mu, new_a.opt_state_nerf.mu))
        grads = list(new_a.opt_state_nerf.mu)
        if new_a.opt_state_pose is not None:
            pairs += list(zip(new_b.opt_state_pose.mu, new_a.opt_state_pose.mu))
            grads += list(new_a.opt_state_pose.mu)
        else:
            grads += [None] * len(new_a.pose_params)
        grad = max(cs.rel_err(x, y)[1] for x, y in pairs)
        param = 0.0
        for x, y, g in zip(engine.tree_leaves(new_b.nerf_params) + list(new_b.pose_params.values()),
                           engine.tree_leaves(new_a.nerf_params) + list(new_a.pose_params.values()),
                           grads):
            d = (x - y).abs()
            if bf16 and g is not None:
                d = d[(g / 0.1).abs() >= cs.BF16_KEEP_GRAD]
            param = max(param, float(d.max()) if d.numel() else 0.0)
        print(f"{args.chain} ({args.order}) iteration {it}: loss {loss:.3g} of its bound, "
              f"gradients within {grad:.3g} of scale (bound 1e-3), parameters within "
              f"{param:.3g} (bound 1e-5)", flush=True)


if __name__ == "__main__":
    main()
