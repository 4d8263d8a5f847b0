"""Model summaries and microbenchmarks, the counterpart of
multispectral_object_detection_tpu/utils/profiling.py: parameter tables,
forward FLOPs from ``torch.utils.flop_counter.FlopCounterMode`` (the JAX
package reads XLA's cost analysis) and CUDA-event microbenchmarks.

The CUDA kernels of the CFT stack (K1) and of the C3 bottleneck (K2) are
ctypes calls that ``FlopCounterMode`` does not see, so ``estimate_flops``
runs the forward with their plain PyTorch twins swapped in: the count
includes every CFT layer (``cft_flops`` is K1's analytic share).
``FlopCounterMode`` counts matrix products and convolutions (2 per
multiply-add). XLA's count of the JAX package differs: on the mini
single-stream model the port's reads 14 % above it, and on a two-stream
model XLA counts the body of the CFT stack's 8-layer scan once
(tests/test_torch_profiling.py).
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Optional

import torch

logger = logging.getLogger(__name__)


def _n_params(module: torch.nn.Module) -> int:
    """Parameters, plus the stacked weights of a packed CFT stage (which
    replace its per-layer parameters)."""
    from ..models.fusion import _STACKED, CrossModalFusion

    n = sum(p.numel() for p in module.parameters())
    for m in module.modules():
        if isinstance(m, CrossModalFusion) and m.packed:
            n += sum(getattr(m, k).numel() for k in _STACKED)
    return n


def model_info(model, img_size: int = 640, verbose: bool = False) -> dict:
    """Graph nodes, parameters and forward FLOPs at ``img_size`` (batch 1):
    ``{"layers", "params", "flops"}``; logs a one-line summary (and a
    parameter table with ``verbose``)."""
    n_p = _n_params(model)
    if verbose:
        logger.info(f"{'name':<60} {'shape':>20} {'params':>12}")
        for name, p in model.named_parameters():
            logger.info(f"{name:<60} {str(tuple(p.shape)):>20} "
                        f"{p.numel():>12}")
    flops = estimate_flops(model, img_size)
    gf = f", {flops / 1e9:.1f} GFLOPs @ {img_size}px" if flops else ""
    n_layers = len(model.spec.nodes)
    logger.info(f"model: {n_layers} graph nodes, {n_p:,} parameters{gf}")
    return {"layers": n_layers, "params": n_p, "flops": flops}


def estimate_flops(model, img_size: int = 640) -> Optional[float]:
    """Forward FLOPs of one image (two for a two-stream model) at
    ``img_size`` on the model's device, with the kernels' plain twins
    (models/model.py ``plain_kernels``); None if the count fails."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..models.model import plain_kernels

    try:
        p = next(model.parameters())
        x = torch.zeros((1, 3, img_size, img_size), device=p.device)
        args = (x, x) if model.spec.two_stream else (x,)
        counter = FlopCounterMode(display=False)
        with torch.no_grad(), plain_kernels(model), counter:
            model(*args)
        return float(counter.get_total_flops())
    except Exception as e:  # the count is best-effort, as in JAX
        logger.debug(f"flop estimate failed: {e}")
        return None


def cft_flops(model, batch: int = 1) -> int:
    """Analytic FLOPs of the model's CFT stacks (K1) per forward of
    ``batch`` pairs: per layer of width C over M = batch * N tokens, the
    four GEMMs 24 M C^2 and the attention's two products 4 batch N^2 C
    (2 per multiply-add; LayerNorm, softmax and GELU not counted)."""
    from ..models.fusion import CrossModalFusion

    total = 0
    for m in model.modules():
        if isinstance(m, CrossModalFusion):
            n = 2 * m.grid[0] * m.grid[1]
            c = m.d_model
            layers = m.wqkv.shape[0] if m.packed else len(m.trans_blocks)
            total += layers * (24 * batch * n * c * c + 4 * batch * n * n * c)
    return total


def microbenchmark(fn: Callable, *args, n: int = 20, warmup: int = 5) -> dict:
    """ms per call of ``fn(*args)``: on CUDA by CUDA events over ``n``
    calls after ``warmup`` (the first call included in the warm-up), on
    the CPU by the host clock."""
    cuda = any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)
    fn(*args)
    for _ in range(warmup):
        fn(*args)
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn(*args)
        end.record()
        end.synchronize()
        return {"ms": start.elapsed_time(end) / n}
    t0 = time.perf_counter()
    for _ in range(n):
        fn(*args)
    return {"ms": (time.perf_counter() - t0) / n * 1000}


def per_layer_costs(model) -> list:
    """Per graph node: index, inputs, kind, parameters and output
    channels (static; the JAX package's table)."""
    rows = []
    for node, mod in zip(model.spec.nodes, model.model):
        rows.append({"i": node.index, "from": node.frm, "kind": node.kind,
                     "params": _n_params(mod), "c2": node.c2})
    return rows
