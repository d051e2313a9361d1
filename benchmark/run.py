"""Run one cell of the benchmark of sparf_tpu_torch once, on the CUDA device.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the numbers the correctness check compared, each beside its limit,
as the last lines of standard error, and one JSON line as the last line of
standard output: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics with --trace 0, its per-layer metrics with --trace 1),
`device`, with --trace 1 `breakdown`, and last `check`. Exits non-zero, and
prints no result, without a CUDA device (there is no CPU fallback), or when
a module of JAX or of the JAX package was loaded by the time the window
closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def _metrics(entries, record):
    from benchmark.harness import read_metric

    out = {}
    for m in entries:
        value = read_metric(m["name"], record)
        if value is not None:
            out[m["name"]] = dict(value=value, unit=m["unit"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import guard, harness

    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: cell {cell.name} needs {cell.chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    rec = harness.run_once(cell, args.seed, args.seconds, bool(args.trace), device="cuda",
                           t_start=T_START)
    found = guard.loaded_forbidden()
    if found:
        print("benchmark: modules of JAX or of the JAX package are loaded: " + ", ".join(found),
              file=sys.stderr)
        return 3
    result = dict(
        correct=bool(rec["correct"]), attempted=int(rec["attempted"]), failed=int(rec["failed"]),
        metrics=_metrics(cell.per_layer if args.trace else cell.end_to_end, rec),
        device=dict(platform="gpu", kind=torch.cuda.get_device_name(0), count=cell.chips,
                    memory_peak_bytes=rec["memory_peak_bytes"],
                    power_limit=harness.power_limit()))
    if args.trace:
        tr = rec["trace"]
        result["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = tr["breakdown"]
    result["check"] = rec["check"]
    for name, c in rec["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
