"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>
    python3 -m portbench.run ...   (the same, from the repository root)

Finds the cell in ``BENCHMARK.json``, checks for the cards the cell asks
for (none: exit 2, no result), runs the mix's driver, refuses to print a
result if a module of JAX or of the JAX package was loaded (exit 3), and
prints the result line as the last line of standard output, then each
compared number beside its limit as the last lines of standard error.
With ``--trace 0`` the metrics are the cell's end-to-end ones, with
``--trace 1`` its per-layer ones.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # set-up runs from here to the first timed call

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __package__ in (None, ""):  # run as a script: the checkout's root first
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import harness  # noqa: E402


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    for k, v in harness.cache_dirs().items():
        os.environ[k] = v
    job = harness.load_job(args.workload, args.seed, args.seconds,
                           bool(args.trace), t0=T0)
    import torch

    chips = int(job.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"run: the cell needs {chips} CUDA device(s); found "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
                    " (no fallback to the CPU)")
        return 2
    out = harness.driver(job).run(job)
    found = harness.forbidden_modules()
    if found:
        harness.log(f"run: modules that a run may not load were loaded: "
                    f"{found}")
        return 3
    print(harness.result_line(out), flush=True)
    harness.print_checks(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
