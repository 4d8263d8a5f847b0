"""The training step and its state.

Counterpart of multispectral_object_detection_tpu/train/trainer.py. A step
takes a uint8 batch on the device, divides it by 255, runs the model in
training mode (BatchNorm on batch statistics, CFT dropout keyed by the
step's seed), the loss in fp32 on the raw head outputs, the gradients,
one optimizer micro-batch and, on emitted steps, the EMA over parameters
and BatchNorm buffers.

Mixed precision follows the JAX package rather than ``torch.autocast``:
parameters stay fp32 and are cast to the compute dtype at use (the model's
``dtype``), BatchNorm and LayerNorm compute in fp32, the loss in fp32.
The step reads nothing back to the host: its metrics are device tensors.

``remat`` trades recompute for activation memory:

- ``none``: autograd keeps every activation;
- ``blocks``: each graph node under ``checkpoint_once`` (the model's
  ``remat_blocks``), keeping the nodes' outputs;
- ``full``: one checkpoint around the whole forward;
- ``dots``: one selective checkpoint around the forward that saves the
  outputs of convolutions and matmuls and recomputes the rest.

Under every mode BatchNorm's running statistics are updated once per step.
"""

from __future__ import annotations

import copy
import functools
from typing import Callable, Dict

import torch
import torch.nn as nn

from ..models.model import checkpoint_once
from . import eval_forward
from .optim import YoloOptimizer, ema_update

REMAT = ("none", "blocks", "full", "dots")


@functools.cache
def _saved_ops() -> frozenset:
    """The operators whose outputs ``dots`` keeps: convolutions and
    matmuls."""
    aten = torch.ops.aten
    return frozenset({aten.convolution.default, aten.mm.default,
                      aten.bmm.default, aten.addmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    return (CheckpointPolicy.MUST_SAVE if op in _saved_ops()
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    from torch.utils.checkpoint import create_selective_checkpoint_contexts

    return create_selective_checkpoint_contexts(_dots_policy)


class TrainState:
    """The model being trained, its EMA copy (eval mode, no gradients),
    the optimizer, and the counters ``step`` (micro-batches taken) and
    ``ema_updates`` (emitted steps)."""

    def __init__(self, model: nn.Module, opt: YoloOptimizer):
        self.model = model
        self.opt = opt
        self.ema_model = copy.deepcopy(model).eval().requires_grad_(False)
        self.step = 0
        self.ema_updates = 0

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(),
                "ema": self.ema_model.state_dict(),
                "opt": self.opt.state_dict(), "step": self.step,
                "ema_updates": self.ema_updates}

    def load_state_dict(self, sd: dict) -> None:
        self.model.load_state_dict(sd["model"])
        self.ema_model.load_state_dict(sd["ema"])
        self.opt.load_state_dict(sd["opt"])
        self.step, self.ema_updates = int(sd["step"]), int(sd["ema_updates"])


def make_train_step(state: TrainState, loss_fn,
                    remat: str = "none") -> Callable:
    """``step(rgb, ir, targets, tmask, seed) -> metrics``: rgb/ir uint8
    (B, S, S, 3) on the model's device (ir ignored for single-stream
    models),
    targets (T, 6), tmask (T,), seed an int keying the dropout masks.
    Metrics: box, obj, cls, total and grad_norm (of this micro-batch's
    gradients), 0-d device tensors."""
    if remat not in REMAT:
        raise ValueError(f"remat must be one of {REMAT}, got {remat!r}")
    model, opt = state.model, state.opt
    model.remat_blocks = remat == "blocks"
    context_fn = _dots_context if remat == "dots" else None

    def forward(*xs, seed: int):
        return model(*xs, dropout_seed=seed)

    def step(rgb, ir, targets, tmask, seed: int) -> Dict[str, torch.Tensor]:
        model.train()
        xs = eval_forward.model_inputs(model, rgb, ir)
        fwd = functools.partial(forward, seed=seed)
        if remat in ("full", "dots"):
            feats = checkpoint_once(fwd, *xs, context_fn=context_fn)
        else:
            feats = fwd(*xs)
        total, comps = loss_fn(feats, targets, tmask)
        grads = torch.autograd.grad(total, opt.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(opt.params, grads)]
        with torch.no_grad():
            gnorm = torch.linalg.vector_norm(torch.stack(
                torch._foreach_norm(grads)))
        if opt.update(grads):
            state.ema_updates += 1
            ema_update(state.ema_model, model, state.ema_updates)
        state.step += 1
        metrics = {k: v.detach() for k, v in comps.items()}
        metrics["grad_norm"] = gnorm
        return metrics

    return step


def make_eval_forward(state: TrainState) -> Callable:
    """The EMA model's eval-mode forward + decode (its CFT stages through
    ``fused_cft_stack``, the CUDA kernels on the card): (rgb, ir) uint8 ->
    (detections, raw head outputs)."""
    state.ema_model.eval()
    return eval_forward.make_eval_forward(state.ema_model)
