"""Graph executor: ModelSpec -> nn.Module running the compiled layer list.

Counterpart of multispectral_object_detection_tpu/models/model.py. Layers
run in row order, outputs needed later are kept in a save dict, multi-input
rows gather from it, and rows whose ``from`` is -4 consume the second (IR)
input. The modules sit in ``self.model`` (an ``nn.ModuleList``), so state
dict keys read ``model.{i}.…`` as in the reference torch model.

``model.train()`` puts BatchNorm on batch statistics and the CFT stages on
their training stack with dropout (models/layers.py, models/fusion.py).
With ``remat_blocks`` each graph node runs under ``checkpoint_once`` in
training: the backward pass keeps the nodes' outputs and recomputes what
lies inside them, as the JAX package's ``nn.remat`` per block does.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..utils.tracing import span
from . import layers as L
from .deformable_detr import DeformableDETR
from .detect import Detect, anchor_arrays, decode_predictions
from .fusion import CrossModalFusion, mix_seed
from .parser import ModelSpec, Node, parse_model_config


def checkpoint_once(fn, *args, context_fn=None):
    """fn(*args) under ``torch.utils.checkpoint`` (non-reentrant). The
    backward pass recomputes fn with BatchNorm's running-statistics update
    off (``layers.frozen_batch_stats``), so a step updates them once.
    ``context_fn``: a selective-checkpoint policy context (see
    train/trainer.py)."""
    calls = [0]

    def run(*a):
        calls[0] += 1
        if calls[0] == 1:
            return fn(*a)
        with L.frozen_batch_stats():
            return fn(*a)

    kw = {} if context_fn is None else {"context_fn": context_fn}
    return checkpoint(run, *args, use_reentrant=False, **kw)


def _build_module(node: Node, use_c3_kernel: bool = False) -> nn.Module:
    """One graph row's module (a repeated row builds one per repeat)."""
    k, a = node.kind, node.args

    def arg(i, default):
        return a[i] if len(a) > i else default

    if k == "Conv":
        return L.ConvBnAct(a[0], a[1], k=arg(2, 1), s=arg(3, 1),
                           p=arg(4, None), g=arg(5, 1))
    if k == "DWConv":
        return L.dwconv(a[0], a[1], arg(2, 1), arg(3, 1))
    if k == "Focus":
        return L.Focus(a[0], a[1], k=arg(2, 1), s=arg(3, 1))
    if k == "Bottleneck":
        return L.Bottleneck(a[0], a[1], shortcut=arg(2, True))
    if k == "BottleneckCSP":
        return L.BottleneckCSP(a[0], a[1], n=a[2], shortcut=arg(3, True))
    if k == "C3":
        return L.C3(a[0], a[1], n=a[2], shortcut=arg(3, True),
                    use_c3_kernel=use_c3_kernel)
    if k == "C3TR":
        return L.C3TR(a[0], a[1], n=a[2], shortcut=arg(3, True))
    if k == "MixConv2d":
        return L.MixConv2d(a[0], a[1], k=tuple(arg(2, (1, 3))), s=arg(3, 1))
    if k == "Sum":
        return L.Sum(n=a[0], weight=arg(1, False))
    if k == "Classify":
        return L.Classify(a[0], a[1])
    if k == "TransformerBlock":
        return L.TransformerBlock2D(a[0], a[1], a[2], a[3])
    if k == "SPP":
        return L.SPP(a[0], a[1], k=tuple(arg(2, (5, 9, 13))))
    if k == "GhostConv":
        return L.GhostConv(a[0], a[1], k=arg(2, 1), s=arg(3, 1))
    if k == "GhostBottleneck":
        return L.GhostBottleneck(a[0], a[1], k=arg(2, 3), s=arg(3, 1))
    if k == "CrossConv":
        return L.CrossConv(a[0], a[1], k=arg(2, 3), s=arg(3, 1))
    if k == "Contract":
        return L.Contract(gain=arg(0, 2))
    if k == "Expand":
        return L.Expand(gain=arg(0, 2))
    if k == "Concat":
        return L.Concat()
    if k == "Add":
        return L.Add()
    if k == "Add2":
        return L.Add2(index=a[1])
    if k == "GPT":
        return CrossModalFusion(d_model=a[0])
    if k == "Upsample":
        # reference rows: [None, 2, 'nearest']
        return L.Upsample(scale=int(arg(1, 2)), mode=str(arg(2, "nearest")))
    if k == "MaxPool2d":
        # torch nn.MaxPool2d rows: [k, s, pad] (yolov3-tiny)
        return L.MaxPool2d(k=a[0], s=arg(1, a[0]), p=arg(2, 0))
    if k == "ZeroPad2d":
        return L.ZeroPad2d(padding=tuple(a[0]))
    raise ValueError(f"no module for kind {k!r}")


class DetectionModel(nn.Module):
    """Executable detection graph over NCHW inputs scaled to [0, 1].

    ``forward`` casts the inputs to ``dtype`` and returns the tuple of raw
    per-scale Detect outputs ``((B, ny, nx, na, 5+nc), ...)``; ``decode``
    gives flat detections. ``use_c3_kernel`` routes the C3 bottlenecks that
    fit it through the fused C3 kernel once the model is fused (the JAX
    package's ``use_pallas_c3``; off by default, as there).
    """

    def __init__(self, spec: ModelSpec, dtype: torch.dtype = torch.float32,
                 use_c3_kernel: bool = False):
        super().__init__()
        self.spec = spec
        self.dtype = dtype
        self.remat_blocks = False  # set by train.trainer.make_train_step
        mods = []
        for node in spec.nodes:
            if node.kind == "Detect":
                mods.append(Detect(node.args[0], spec.anchors, spec.strides,
                                   node.args[2]))
            elif node.repeats > 1:
                mods.append(nn.Sequential(*(_build_module(node, use_c3_kernel)
                                            for _ in range(node.repeats))))
            else:
                mods.append(_build_module(node, use_c3_kernel))
        self.model = nn.ModuleList(mods)

    def forward(self, x, x2=None, dropout_seed: Optional[int] = None):
        """``dropout_seed`` keys the CFT dropout masks in training mode
        (each stage mixes in its node index); None draws one from torch's
        global generator on the host. One ``model.forward`` span: the
        host's time to enqueue the graph."""
        if self.spec.two_stream and x2 is None:
            raise ValueError("two-stream model needs both RGB and IR inputs")
        with span("model.forward"):
            saved = {}
            cur = x.to(self.dtype)
            x2 = None if x2 is None else x2.to(self.dtype)
            remat = self.remat_blocks and self.training and \
                torch.is_grad_enabled()
            if self.training and dropout_seed is None:
                dropout_seed = int(torch.randint(2 ** 62, ()))
            for node, mod in zip(self.spec.nodes, self.model):
                if node.frm == (-4,) and not node.multi:
                    inp = x2
                elif node.frm == (-1,) and not node.multi:
                    inp = cur
                elif node.multi:
                    inp = [cur if j == -1 else saved[j] for j in node.frm]
                else:
                    inp = saved[node.frm[0]]
                fn = mod
                if isinstance(mod, CrossModalFusion) and self.training:
                    def fn(y, _m=mod, _s=mix_seed(dropout_seed, node.index)):
                        return _m(y, _s)
                cur = checkpoint_once(fn, inp) if remat else fn(inp)
                if node.index in self.spec.save:
                    saved[node.index] = cur
            return cur

    def decode(self, feats) -> torch.Tensor:
        with span("model.decode"):
            return decode_predictions(feats, anchor_arrays(self.spec.anchors),
                                      self.spec.strides)

    def fuse(self) -> "DetectionModel":
        """Inference form: fold every BatchNorm into its conv and pack the
        CFT layer weights and the fused C3 bottlenecks' weights into their
        kernels' layouts."""
        fuse_conv_bn(self)
        for m in self.modules():
            if isinstance(m, (CrossModalFusion, L.Bottleneck)):
                m.pack()
        return self


@contextlib.contextmanager
def plain_kernels(model: nn.Module, stack_fn=None):
    """Within: the model's CFT stages and fused C3 bottlenecks run their
    kernels' plain PyTorch twins (visible to FlopCounterMode and traceable
    by torch.export, which cannot see the ctypes-bound kernels), restored
    on exit. ``stack_fn`` replaces the CFT stack's twin (Grad-CAM passes
    the differentiable ``cft_stack_train``)."""
    from ..ops.c3_bottleneck import c3_bottleneck_plain
    from ..ops.cft_stack import fused_cft_stack_plain

    saved = []
    for m in model.modules():
        if isinstance(m, CrossModalFusion):
            saved.append((m, "stack_fn", m.stack_fn))
            m.stack_fn = stack_fn or fused_cft_stack_plain
        elif isinstance(m, L.Bottleneck):
            saved.append((m, "c3_fn", m.c3_fn))
            m.c3_fn = c3_bottleneck_plain
    try:
        yield model
    finally:
        for m, attr, fn in saved:
            setattr(m, attr, fn)


def build_model(cfg, ch_in: int = 3, nc: Optional[int] = None, anchors=None,
                dtype: torch.dtype = torch.float32, device=None,
                use_c3_kernel: bool = False) -> DetectionModel:
    """YAML path / dict / ModelSpec -> DetectionModel, in eval mode; a
    dict whose ``arch`` is "deformable_detr" -> DeformableDETR.
    ``device="meta"`` builds the structure without storage (parameter
    counts)."""
    if isinstance(cfg, dict) and cfg.get("arch") == "deformable_detr":
        with torch.device(device or "cpu"):
            return DeformableDETR(cfg, nc=nc, dtype=dtype).eval()
    spec = cfg if isinstance(cfg, ModelSpec) else parse_model_config(
        cfg, ch_in=ch_in, nc=nc, anchors=anchors)
    with torch.device(device or "cpu"):
        model = DetectionModel(spec, dtype=dtype, use_c3_kernel=use_c3_kernel)
    return model.eval()


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights from ``generator``, as the JAX package initialises:
    convs normal(0, 1/fan_in) (flax's default); the CFT stages' Linears
    normal(0, 0.02) with zero bias, their position embeddings zero; the
    zoo's Linears normal(0, 1/fan_in) with zero bias, the packed attention
    in-projection xavier-uniform with zero bias; ``Sum`` weights
    -(1..n-1)/2; norms at identity; the Detect prior bias. A
    DeformableDETR takes its own (``DeformableDETR.init_weights``)."""
    if isinstance(model, DeformableDETR):
        return model.init_weights(generator)
    cft = {id(m) for f in model.modules() if isinstance(f, CrossModalFusion)
           for m in f.modules()}
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.in_channels // m.groups * m.kernel_size[0] * m.kernel_size[1]
            m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Linear):
            std = 0.02 if id(m) in cft else 1.0 / math.sqrt(m.in_features)
            m.weight.normal_(0.0, std, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.MultiheadAttention):
            c3, c = m.in_proj_weight.shape  # (3c, c): fans c and 3c
            bound = math.sqrt(6.0 / (c + c3))
            m.in_proj_weight.uniform_(-bound, bound, generator=generator)
            m.in_proj_bias.zero_()
        elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
            m.reset_parameters()  # BatchNorm: running stats too
        elif isinstance(m, CrossModalFusion):
            m.pos_emb.zero_()
        elif isinstance(m, L.Sum) and m.weight:
            m.w.copy_(-torch.arange(1.0, m.n) / 2)
    for m in model.modules():
        if isinstance(m, Detect):
            m.init_prior_bias()
    return model


@torch.no_grad()
def fuse_conv_bn(model: nn.Module, eps: Optional[float] = None) -> nn.Module:
    """Fold each ConvBnAct's BatchNorm into its conv, in place:

        weight' = weight * gamma / sqrt(var + eps)   (per output channel)
        bias'   = beta - mean * gamma / sqrt(var + eps)

    computed in fp32 (eps defaults to the BatchNorm's own, 1e-3). A bare
    BatchNorm without a conv of its own (BottleneckCSP's, MixConv2d's)
    stays live, as in the JAX package's fold."""
    for m in model.modules():
        if isinstance(m, L.ConvBnAct) and m.bn is not None:
            bn, conv = m.bn, m.conv
            g = bn.weight.float() / torch.sqrt(
                bn.running_var.float() + (bn.eps if eps is None else eps))
            w = conv.weight.float() * g.view(-1, 1, 1, 1)
            b = bn.bias.float() - bn.running_mean.float() * g
            conv.weight = nn.Parameter(w, requires_grad=False)
            conv.bias = nn.Parameter(b, requires_grad=False)
            m.bn = None
    return model


def _is_norm(path: str) -> bool:
    return any(p.startswith(("bn", "ln")) or "norm" in p
               for p in path.split("."))


@torch.no_grad()
def cast_inference_params(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast stored float parameters and buffers to the compute dtype, in
    place, except those under a ``bn*``/``ln*``/``*norm*`` name: BatchNorm
    and LayerNorm compute in fp32 on purpose, so casting them would change
    the numbers."""
    if dtype == torch.float32:
        return model
    for mod_name, mod in model.named_modules():
        for store in (mod._parameters, mod._buffers):
            for name, t in store.items():
                path = f"{mod_name}.{name}" if mod_name else name
                if t is None or not t.is_floating_point() or _is_norm(path):
                    continue
                if isinstance(t, nn.Parameter):
                    store[name] = nn.Parameter(t.to(dtype),
                                               requires_grad=False)
                else:
                    store[name] = t.to(dtype)
    return model


# keys of reference state dicts that this model keeps elsewhere or not at all
_IGNORED_SUFFIXES = ("num_batches_tracked", "anchors", "anchor_grid")


def load_reference_state_dict(model: nn.Module, sd) -> None:
    """Load a reference-layout state dict (values: tensors or arrays).

    Detect's ``anchors``/``anchor_grid`` buffers are static in the spec and
    BatchNorm's ``num_batches_tracked`` is unused at inference, so those keys
    may be present or absent; every other key must match exactly."""
    sd = {k: v if isinstance(v, torch.Tensor) else torch.as_tensor(
        np.asarray(v)) for k, v in sd.items()
          if not k.endswith(_IGNORED_SUFFIXES)}
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.endswith(_IGNORED_SUFFIXES)]
    if missing or unexpected:
        raise KeyError(f"state dict mismatch: missing {missing[:8]}, "
                       f"unexpected {unexpected[:8]}")
