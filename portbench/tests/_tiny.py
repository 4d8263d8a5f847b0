"""A cell of the benchmark cut to a size the CPU runs in seconds: the n
scale's multiples at a 64 px canvas, batches of 2, for the tests only. The
program computes in fp32 there, so that only a planted fault, and not
bf16's rounding on maps a hundred times smaller than the cell's, moves
the compared numbers."""

from __future__ import annotations

from portbench import harness

SEED = 3_000_000_123  # above 32 signed bits, as the driver's seeds are


def tiny_job(name: str, trace: bool = False, seconds: float = 0.5,
             control: bool = False) -> harness.Job:
    job = harness.load_job(name, SEED, seconds, trace)
    job.device = "cpu"
    job.control = control
    job.cfg = dict(job.cfg, depth_multiple=0.33, width_multiple=0.25,
                   canvas=64, frame_hw=[48, 64], dtype="float32")
    small = {"batch": 2, "sample_calls": 2, "trace_calls": 2,
             "ref_block": 2, "trace_steps": 2, "sample_batches": 1,
             "trace_batches": 1,
             # the eval loader's rect canvas: the frame at twice its size
             "images": 8, "canvas_hw": [96, 128]}
    job.traffic = {**job.traffic,
                   **{k: v for k, v in small.items() if k in job.traffic}}
    return job


def run_tiny(name: str, **kw) -> harness.Outcome:
    job = tiny_job(name, **kw)
    return harness.driver(job).run(job)
