"""The readings that a cell's correctness limits are set from: the numbers
its check compares, for the program as the configuration states it (the
lower reading: the largest over a dozen seeds or more) and for the control,
the port's own bfloat16 path (the upper reading: the smallest over three
seeds or more), on the card at the cell's own size.

    python3 -m benchmark.readings --workload <cell> --seeds 1001-1012 \
        --dtype float32 --dtype bfloat16 [--seconds 4] [--fault half]

One trainer per dtype serves every seed (each seed gets its own weights and
draws); a render cell renders for --seconds before its check, so that the
check finds the frames it compares. Prints a JSON line per run, then one per
dtype with each number's smallest and largest reading. `--fault half`
plants a fault in the program first, to read it at the cell's size: half of
the photometric batch left out, the mean taken over the rest. The
benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys


def seed_list(text: str):
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def plant_half_batch() -> None:
    """The photometric loss over the first half of its rays only."""
    from sparf_tpu_torch.training.losses import photometric

    loss = photometric.photometric_and_regu_loss

    def half(out, image_at_rays, **kwargs):
        n = image_at_rays.shape[1] // 2
        out = {k: v[:, :n] if k in ("rgb", "rgb_fine") else v for k, v in out.items()}
        return loss(out, image_at_rays[:, :n], **kwargs)

    photometric.photometric_and_regu_loss = half


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="e.g. 1001-1012 or 5,9,13")
    ap.add_argument("--dtype", action="append", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--fault", choices=("half",))
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("readings: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = harness.load_cell(args.workload)
    if args.fault == "half":
        plant_half_batch()
    for dtype in args.dtype:
        trainer, workspace = harness.build_trainer(cell.config, "cuda", dtype)
        readings = []
        for seed in seed_list(args.seeds):
            run = harness.new_run(cell, seed, "cuda", dtype)
            run.setup(trainer)
            run.window(args.seconds, False)
            numbers = run.numbers()
            run.release()
            readings.append(numbers)
            print(json.dumps(dict(workload=cell.name, dtype=dtype, fault=args.fault, seed=seed,
                                  **numbers)),
                  flush=True)
        summary = {k: dict(min=min(r[k] for r in readings), max=max(r[k] for r in readings))
                   for k in readings[0]}
        print(json.dumps(dict(workload=cell.name, dtype=dtype, fault=args.fault,
                              seeds=len(readings),
                              summary=summary)), flush=True)
        harness.close_trainer(trainer, workspace)
        del trainer
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
