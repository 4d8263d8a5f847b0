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

On a parallel mesh (``TrainState(..., mesh)``, parallel/mesh.py) the step
sums the gradients over the data group in coalesced buckets (the loss is
already the rank's share of the global batch's), reports the global
losses and the norm of the reduced gradient, and keeps optimizer and EMA
replicated; under tensor parallelism ``state_dict`` gathers the CFT
shards into the full layout and ``load_state_dict`` cuts them again.
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

    def __init__(self, model: nn.Module, opt: YoloOptimizer, mesh=None):
        self.model = model
        self.opt = opt
        self.mesh = mesh
        self.ema_model = copy.deepcopy(model).eval().requires_grad_(False)
        self.step = 0
        self.ema_updates = 0

    def _tp(self):
        """(the split parameters' dims, the mesh) under tensor
        parallelism, else None."""
        if self.mesh is None or self.mesh.n_model == 1:
            return None
        from ..parallel.mesh import tp_dims

        return tp_dims(self.model), self.mesh

    def state_dict(self) -> dict:
        """The full layout (under tensor parallelism a collective over the
        model group: every rank of it calls)."""
        sd = {"model": self.model.state_dict(),
              "ema": self.ema_model.state_dict(),
              "opt": self.opt.state_dict(), "step": self.step,
              "ema_updates": self.ema_updates}
        tp = self._tp()
        if tp is not None:
            from ..parallel.mesh import gather_state

            dims, mesh = tp
            sd["model"] = gather_state(sd["model"], dims, mesh)
            sd["ema"] = gather_state(sd["ema"], dims, mesh)
            names = sd["opt"]["names"]
            for k, v in sd["opt"].items():
                if isinstance(v, list) and v and torch.is_tensor(v[0]):
                    sd["opt"][k] = list(gather_state(dict(zip(names, v)),
                                                     dims, mesh).values())
        return sd

    def load_state_dict(self, sd: dict) -> None:
        tp = self._tp()
        if tp is not None:
            from ..parallel.mesh import shard_state

            dims, mesh = tp
            sd = dict(sd, model=shard_state(sd["model"], dims, mesh),
                      ema=shard_state(sd["ema"], dims, mesh))
            names = sd["opt"]["names"]
            sd["opt"] = {k: list(shard_state(dict(zip(names, v)), dims,
                                             mesh).values())
                         if isinstance(v, list) and v and torch.is_tensor(v[0])
                         else v for k, v in sd["opt"].items()}
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
    model, opt, mesh = state.model, state.opt, state.mesh
    model.remat_blocks = remat == "blocks"
    if mesh is not None:
        from ..parallel.mesh import all_reduce_, reduce_gradients, tp_dims

        split = set(tp_dims(model)) if mesh.n_model > 1 else set()
        is_split = [n in split for n in opt.names]
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
        if mesh is not None:  # the global batch's gradient and losses
            reduce_gradients(grads, mesh.data_group)
            comps = dict(zip(comps, all_reduce_(
                torch.stack([v.detach() for v in comps.values()]),
                mesh.data_group)))
        with torch.no_grad():
            norms = torch.stack(torch._foreach_norm(grads))
            if mesh is not None and split:
                # the split tensors' squares summed over the model group
                sq = norms.square()
                part = sq[torch.tensor(is_split, device=sq.device)].sum()
                rest = sq[~torch.tensor(is_split, device=sq.device)].sum()
                gnorm = (rest + all_reduce_(part, mesh.model_group)).sqrt()
            else:
                gnorm = torch.linalg.vector_norm(norms)
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
