"""Optimizer, learning-rate schedule and EMA: the reference training recipe.

Counterpart of multispectral_object_detection_tpu/train/optim.py, with its
micro-batch control flow:

- one ``update`` = one micro-batch; gradients are SUMMED into an
  accumulator, and a real step is emitted when ``ni % k == 0``, ``ni`` the
  global micro-batch counter and ``k`` the accumulation of that batch, which
  ramps 1 -> 64/bs over the warmup;
- lr, bias lr and momentum are interpolated per micro-batch over
  ``nw = max(round(warmup_epochs * nb), 1000)`` batches, from (0,
  warmup_bias_lr, warmup_momentum); afterwards lr follows a per-epoch
  staircase ``lr0 * lf(epoch)`` (one-cycle cosine or linear);
- weight decay is scaled by bs * accumulate / 64 and applies to the
  ``kernel`` role only; SGD is torch-coupled Nesterov, Adam torch-coupled
  L2 with bias correction by the number of real steps;
- the EMA runs over parameters AND BatchNorm buffers with decay
  0.9999 * (1 - exp(-t / 2000)), on emitted steps only.

``ni`` lives on the host, so the emission test and the schedule are host
arithmetic and cost no device sync. The schedule is computed in float32 as
the JAX package computes it, so the accumulation ramp rounds alike.

Parameter roles on torch names: every ``.bias`` is ``bias`` (BatchNorm,
LayerNorm and the CFT linears included), a BatchNorm ``.weight`` is
``norm``, conv, linear and LayerNorm weights are ``kernel``, and
``pos_emb`` is ``frozen`` (never updated: the reference puts it in no
parameter group, so it stays at its zero init).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch
import torch.nn as nn

ROLES = ("kernel", "bias", "norm", "frozen")
_F32 = np.float32
ADAM_B2, ADAM_EPS = 0.999, 1e-8    # Adam's second moment and denominator
EMA_DECAY, EMA_TAU = 0.9999, 2000.0  # d(t) = EMA_DECAY * (1 - exp(-t/tau))


@dataclasses.dataclass(frozen=True)
class OptHyp:
    """The optimizer keys of hyp.scratch.yaml."""

    lr0: float = 0.01
    lrf: float = 0.2
    momentum: float = 0.937
    weight_decay: float = 5e-4
    warmup_epochs: float = 3.0
    warmup_momentum: float = 0.8
    warmup_bias_lr: float = 0.1
    adam: bool = False


def param_roles(model: nn.Module, freeze: Sequence[str] = ()) -> Dict[str, str]:
    """{parameter name: role}; names containing any ``freeze`` substring
    are ``frozen``."""
    roles = {}
    for mod_name, mod in model.named_modules():
        for pname, _ in mod.named_parameters(recurse=False):
            name = f"{mod_name}.{pname}" if mod_name else pname
            if pname == "pos_emb" or any(f in name for f in freeze):
                role = "frozen"
            elif pname == "bias":
                role = "bias"
            elif isinstance(mod, nn.modules.batchnorm._BatchNorm):
                role = "norm"
            else:
                role = "kernel"
            roles[name] = role
    return roles


def one_cycle_lf(epochs: int, lrf: float) -> Callable:
    """Cosine one-cycle factor of the epoch (float32)."""

    def lf(e):
        e = _F32(e)
        return ((_F32(1.0) + np.cos(e * _F32(math.pi) / _F32(epochs)))
                / _F32(2.0)) * _F32(1.0 - lrf) + _F32(lrf)

    return lf


def linear_lf(epochs: int, lrf: float) -> Callable:
    """Linear factor of the epoch, from 1 at epoch 0 to lrf at the last
    (float32); needs 2 epochs or more (the JAX package divides by zero)."""
    if epochs < 2:
        raise ValueError("a linear LR schedule needs at least 2 epochs")

    def lf(e):
        return (_F32(1.0) - _F32(e) / _F32(epochs - 1)) * _F32(1.0 - lrf) \
            + _F32(lrf)

    return lf


def warmup_schedules(hyp: OptHyp, steps_per_epoch: int, epochs: int,
                     total_batch_size: int, linear_lr: bool = False,
                     warmup_min_iters: int = 1000) -> Callable:
    """``sched(ni) -> (lr_main, lr_bias, momentum, k)``: float32 values and
    the int accumulation of micro-batch ``ni``."""
    nw = max(max(round(hyp.warmup_epochs * steps_per_epoch),
                  warmup_min_iters), 1)
    ratio = 64.0 / float(total_batch_size)
    lf = (linear_lf if linear_lr else one_cycle_lf)(epochs, hyp.lrf)

    def sched(ni: int):
        nif = _F32(ni)
        base = _F32(hyp.lr0) * lf(_F32(ni // steps_per_epoch))
        if nif <= _F32(nw):
            # as XLA compiles the JAX package's schedule: the division by
            # the constant nw as a product with its reciprocal, and
            # 1 + frac * (ratio - 1) as one fused multiply-add (exact in
            # float64, rounded once), so the accumulation rounds its .5
            # cases alike
            frac = min(max(nif * _F32(1.0 / nw), _F32(0.0)), _F32(1.0))
            lr_main = frac * base
            lr_bias = _F32(hyp.warmup_bias_lr) + frac * (
                base - _F32(hyp.warmup_bias_lr))
            mom = _F32(hyp.warmup_momentum) + frac * _F32(
                hyp.momentum - hyp.warmup_momentum)
            k = max(_F32(1.0), np.round(_F32(
                float(frac) * float(_F32(ratio - 1.0)) + 1.0)))
        else:
            lr_main = lr_bias = base
            mom = _F32(hyp.momentum)
            k = max(_F32(1.0), np.round(_F32(ratio)))
        return _F32(lr_main), _F32(lr_bias), _F32(mom), int(k)

    return sched


class YoloOptimizer:
    """The recipe's SGD (or Adam) over a model's parameters by role.

    ``update(grads)`` takes one micro-batch's gradients (a list in
    ``self.params`` order), adds them to the accumulator, and on an emitted
    step updates the parameters in place; it returns whether it emitted.
    """

    def __init__(self, model: nn.Module, hyp: OptHyp, steps_per_epoch: int,
                 epochs: int, accumulate: int = 1, total_batch_size: int = 64,
                 linear_lr: bool = False, warmup_min_iters: int = 1000,
                 freeze: Sequence[str] = ()):
        self.hyp = hyp
        self.roles = param_roles(model, freeze)
        named = dict(model.named_parameters())
        self.names: List[str] = list(self.roles)
        self.params: List[torch.Tensor] = [named[n] for n in self.names]
        # weight decay scaled to the nominal batch
        self.wd = hyp.weight_decay * total_batch_size * accumulate / 64.0
        self.sched = warmup_schedules(hyp, steps_per_epoch, epochs,
                                      total_batch_size, linear_lr,
                                      warmup_min_iters)
        self.ni = 0               # global micro-batch counter
        self.gradient_steps = 0   # real steps emitted
        self.emitted = False      # did the last update emit a step
        zeros = [torch.zeros_like(p, memory_format=torch.preserve_format)
                 for p in self.params]
        self.state: Dict[str, List[torch.Tensor]] = {
            "acc": zeros,
            "m": [torch.zeros_like(p) for p in self.params]}
        if hyp.adam:
            self.state["v"] = [torch.zeros_like(p) for p in self.params]
        self.groups = {r: [i for i, n in enumerate(self.names)
                           if self.roles[n] == r] for r in ROLES}

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor]) -> bool:
        lr_main, lr_bias, mom, k = self.sched(self.ni)
        emit = self.ni % k == 0
        acc = self.state["acc"]
        torch._foreach_add_(acc, list(grads))
        if emit:
            t = self.gradient_steps + 1
            for role, lr in (("kernel", lr_main), ("bias", lr_bias),
                             ("norm", lr_main)):
                idx = self.groups[role]
                if not idx:
                    continue
                p = [self.params[i] for i in idx]
                eff = [acc[i] for i in idx]
                if role == "kernel":
                    eff = torch._foreach_add(eff, p, alpha=self.wd)
                m = [self.state["m"][i] for i in idx]
                if self.hyp.adam:
                    self._adam(p, eff, m, [self.state["v"][i] for i in idx],
                               lr, t)
                else:
                    # torch-coupled Nesterov: buf = mom*buf + g;
                    # p -= lr * (g + mom*buf)
                    torch._foreach_mul_(m, float(mom))
                    torch._foreach_add_(m, eff)
                    d = torch._foreach_add(eff, m, alpha=float(mom))
                    torch._foreach_add_(p, d, alpha=-float(lr))
            torch._foreach_zero_(acc)
            self.gradient_steps += 1
        self.ni += 1
        self.emitted = emit
        return emit

    def _adam(self, p, g, mu, nu, lr, t: int) -> None:
        b1 = self.hyp.momentum
        bc1 = float(1.0 - _F32(b1) ** _F32(t))
        bc2 = float(1.0 - _F32(ADAM_B2) ** _F32(t))
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, g, alpha=1.0 - b1)
        torch._foreach_mul_(nu, ADAM_B2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - ADAM_B2)
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, ADAM_EPS)
        num = torch._foreach_div(mu, bc1)
        torch._foreach_div_(num, den)
        torch._foreach_add_(p, num, alpha=-float(lr))

    def state_dict(self) -> dict:
        return {"ni": self.ni, "gradient_steps": self.gradient_steps,
                "names": list(self.names),
                **{k: [t.detach().clone() for t in v]
                   for k, v in self.state.items()}}

    def load_state_dict(self, sd: dict) -> None:
        if list(sd["names"]) != self.names:
            raise ValueError("optimizer state of another model")
        self.ni, self.gradient_steps = int(sd["ni"]), int(sd["gradient_steps"])
        for k, v in self.state.items():
            if k not in sd:
                raise ValueError(f"optimizer state lacks {k!r} (SGD and "
                                 "Adam states differ)")
            for dst, src in zip(v, sd[k]):
                dst.copy_(src)


def build_optimizer(model: nn.Module, hyp: OptHyp, steps_per_epoch: int,
                    epochs: int, accumulate: int = 1,
                    total_batch_size: int = 64, linear_lr: bool = False,
                    warmup_min_iters: int = 1000,
                    freeze: Sequence[str] = ()) -> YoloOptimizer:
    """SGD, or Adam(lr0, betas=(momentum, 0.999)) when ``hyp.adam``.
    ``accumulate`` is the nominal max(round(64/bs), 1), used for the
    weight-decay scale; the live value ramps with the schedule."""
    return YoloOptimizer(model, hyp, steps_per_epoch, epochs, accumulate,
                         total_batch_size, linear_lr, warmup_min_iters,
                         freeze)


def opt_emitted(opt: YoloOptimizer) -> bool:
    """Did the last ``update`` emit a real step."""
    return opt.emitted


def ema_decay(updates: int) -> float:
    """d(t) = EMA_DECAY * (1 - exp(-t / EMA_TAU)), in float32."""
    return float(_F32(EMA_DECAY) * (_F32(1.0) - np.exp(-_F32(updates)
                                                      / _F32(EMA_TAU))))


def ema_tensors(model: nn.Module) -> List[torch.Tensor]:
    """The tensors the EMA averages: parameters, then floating buffers
    (BatchNorm running statistics), in state-dict order."""
    return [t for t in model.state_dict(keep_vars=True).values()
            if t.is_floating_point()]


@torch.no_grad()
def ema_update(ema_model: nn.Module, model: nn.Module,
               updates: int) -> None:
    """ema = ema * d + new * (1 - d) over parameters and float buffers,
    with d = ``ema_decay(updates)``."""
    d = ema_decay(updates)
    e = [t.data for t in ema_tensors(ema_model)]
    src = [t.detach() for t in ema_tensors(model)]
    torch._foreach_mul_(e, d)
    torch._foreach_add_(e, src, alpha=1.0 - d)
