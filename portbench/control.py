"""Readings that set a cell's correctness limits: the program's numbers
over many seeds and the control's, in one process.

    python3 -m portbench.control --workload <name> --seeds 1 2 3 ...
        [--control-seeds 3] [--seconds 3] [--out readings.jsonl]

For each seed, one short run of the cell's driver at the cell's own load
and sizes (a window of ``--seconds``), with its compared numbers; for the
first ``--control-seeds`` seeds also the control's reading: the reference
computed in fp8 (e4m3, one scale per tensor) put in the program's place,
judged against the fp32 reference as the program is. One JSON line per
seed goes to standard output and, with ``--out``, to that file. The
benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

from portbench import harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    for k, v in harness.cache_dirs().items():
        os.environ[k] = v
    import torch

    if not torch.cuda.is_available():
        harness.log("control: no CUDA device")
        return 2
    out = Path(args.out) if args.out else None
    if out is not None:
        out.parent.mkdir(parents=True, exist_ok=True)
    for i, seed in enumerate(args.seeds):
        job = harness.load_job(args.workload, seed, args.seconds, False)
        job.control = i < args.control_seeds
        t = time.perf_counter()
        res = harness.driver(job).run(job)
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "program": {k: v for k, (v, _) in
                                       res.checks.items()},
                           "control": res.control,
                           "counters": res.counters,
                           "seconds": time.perf_counter() - t})
        print(line, flush=True)
        if out is not None:
            with out.open("a") as f:
                f.write(line + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
