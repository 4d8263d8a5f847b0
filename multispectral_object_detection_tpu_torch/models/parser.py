"""YAML model-graph DSL -> static ModelSpec.

The port's own copy of multispectral_object_detection_tpu/models/parser.py
(framework-free there too, but the port imports nothing of the JAX
package). It accepts the reference schema
``{nc, depth_multiple, width_multiple, anchors, backbone, head}`` where each
row is ``[from, number, module, args]``:

- depth gain ``max(round(n * depth_multiple), 1)`` and width gain
  ``make_divisible(c_out * width_multiple, 8)``;
- channel bookkeeping per module kind (Concat sums, Add/Add2/GPT take the
  first input's channels, Detect collects input channel lists);
- the ``from: -4`` sentinel meaning "the second (IR) network input";
- a savelist of layer outputs consumed by later layers.

``yaml`` is imported only when ``cfg`` is a path.
"""

from __future__ import annotations

import ast
import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np

from .detect import check_anchor_order


def autopad(k, p=None):
    """'same'-style padding for odd kernels."""
    if p is None:
        p = k // 2 if isinstance(k, int) else [x // 2 for x in k]
    return p


def make_divisible(x: float, divisor: int = 8) -> int:
    """Round channel counts up to a multiple of `divisor`."""
    return int(math.ceil(x / divisor) * divisor)


# module-name aliases: reference YAMLs say e.g. `nn.Upsample`, `GPT`
_CANONICAL = {
    "Conv": "Conv",
    "DWConv": "DWConv",
    "Focus": "Focus",
    "Bottleneck": "Bottleneck",
    "BottleneckCSP": "BottleneckCSP",
    "C3": "C3",
    "C3TR": "C3TR",
    "SPP": "SPP",
    "GhostConv": "GhostConv",
    "GhostBottleneck": "GhostBottleneck",
    "CrossConv": "CrossConv",
    "MixConv2d": "MixConv2d",
    "Contract": "Contract",
    "Expand": "Expand",
    "Concat": "Concat",
    "Add": "Add",
    "Add2": "Add2",
    "GPT": "GPT",
    "Sum": "Sum",
    "Classify": "Classify",
    "TransformerBlock": "TransformerBlock",
    "nn.Upsample": "Upsample",
    "Upsample": "Upsample",
    "nn.BatchNorm2d": "BatchNorm2d",
    "nn.MaxPool2d": "MaxPool2d",
    "MaxPool2d": "MaxPool2d",
    "nn.ZeroPad2d": "ZeroPad2d",
    "ZeroPad2d": "ZeroPad2d",
    "Detect": "Detect",
}

# modules whose first arg is an output-channel count subject to width gain
_CONV_LIKE = {
    "Conv", "GhostConv", "Bottleneck", "GhostBottleneck", "SPP", "DWConv",
    "MixConv2d", "Focus", "CrossConv", "BottleneckCSP", "C3", "C3TR",
}
# CSP-style blocks receive the repeat count as an inner arg
_CSP_LIKE = {"BottleneckCSP", "C3", "C3TR"}


@dataclasses.dataclass(frozen=True)
class Node:
    """One compiled graph row."""

    index: int
    frm: Tuple[int, ...]  # input refs; -1 = previous, -4 = IR input, else absolute
    repeats: int          # sequential repeats of the module (after depth gain)
    kind: str             # canonical module name
    args: Tuple[Any, ...] # constructor args (channels already resolved/scaled)
    c1: int
    c2: int
    multi: bool = False   # YAML `from` was a list -> module receives a list


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    nc: int
    nodes: Tuple[Node, ...]
    save: Tuple[int, ...]            # indices whose outputs later layers consume
    anchors: Tuple[Tuple[float, ...], ...]  # per-scale flat pixel anchors
    strides: Tuple[int, ...]
    ch_in: int                       # channels per stream (3 for RGB / IR)
    two_stream: bool

    @property
    def na(self) -> int:
        return len(self.anchors[0]) // 2

    @property
    def nl(self) -> int:
        return len(self.anchors)


def _resolve_arg(a: Any, env: Dict[str, Any]) -> Any:
    """Resolve string args the reference would `eval` ('None', 'nc',
    'anchors'; 'nearest' stays a string)."""
    if not isinstance(a, str):
        return a
    if a in env:
        return env[a]
    if a == "None":
        return None
    try:
        return ast.literal_eval(a)
    except (ValueError, SyntaxError):
        return a


def _to_tuple(x):
    if isinstance(x, (list, tuple)):
        return tuple(_to_tuple(v) for v in x)
    return x


def parse_model_config(cfg, ch_in: int = 3, nc: Optional[int] = None,
                       anchors=None) -> ModelSpec:
    """Compile a model YAML (path or dict) into a ModelSpec."""
    if isinstance(cfg, str):
        import yaml

        with open(cfg) as f:
            cfg = yaml.safe_load(f)
    cfg = dict(cfg)
    if nc is not None:
        cfg["nc"] = nc
    if anchors is not None:
        cfg["anchors"] = anchors

    nc = int(cfg["nc"])
    gd = float(cfg.get("depth_multiple", 1.0))
    gw = float(cfg.get("width_multiple", 1.0))
    anchors = cfg["anchors"]
    rows = list(cfg["backbone"]) + list(cfg["head"])
    if not isinstance(anchors, list):
        # `anchors: N` = N autoanchor placeholders per scale
        na = int(anchors)
        nl_cfg = next(len(f) for f, _, m, _ in rows
                      if _CANONICAL.get(str(m)) == "Detect")
        anchors = [list(range(na * 2))] * nl_cfg
    na = len(anchors[0]) // 2
    no = na * (nc + 5)
    env = {"nc": nc, "anchors": anchors}

    ch = [ch_in]
    st = [1]   # cumulative stride per row, tracked statically
    nodes = []
    save: set[int] = set()
    detect_strides: Optional[Tuple[int, ...]] = None
    two_stream = False

    for i, (f, n, mname, args) in enumerate(rows):
        kind = _CANONICAL.get(str(mname))
        if kind is None:
            raise ValueError(f"unknown module {mname!r} in row {i}")
        args = [_resolve_arg(a, env) for a in list(args)]
        reps = max(round(n * gd), 1) if n > 1 else int(n)
        frm = tuple(f) if isinstance(f, (list, tuple)) else (f,)
        if -4 in frm:
            two_stream = True

        if kind in _CONV_LIKE:
            c1 = ch_in if frm[0] == -4 else ch[frm[0]]
            if kind == "Focus":
                c1 = ch_in  # per-stream input, as in the reference
            c2 = args[0]
            if c2 != no:
                c2 = make_divisible(c2 * gw, 8)
            args = [c1, c2, *args[1:]]
            if kind in _CSP_LIKE:
                args.insert(2, reps)  # repeat count moves inside the block
                reps = 1
        elif kind == "BatchNorm2d":
            c1 = c2 = ch[frm[0]]
            args = [c1]
        elif kind in ("MaxPool2d", "ZeroPad2d"):
            c1 = c2 = ch[frm[0]]
        elif kind == "Concat":
            c1 = c2 = sum(ch[x] for x in frm)
        elif kind == "Add":
            c1 = c2 = ch[frm[0]]
            args = [c2]
        elif kind == "Sum":
            c1 = c2 = ch[frm[0]]
            args = [len(frm)] + list(args)
        elif kind == "Classify":
            c1 = ch[frm[0]] if isinstance(frm[0], int) else sum(ch[x] for x in frm)
            c2 = args[0]
            args = [c1, c2]
        elif kind == "Add2":
            c1 = c2 = ch[frm[0]]
            args = [c2, args[1]]
        elif kind == "GPT":
            c1 = c2 = ch[frm[0]]
            args = [c2]
        elif kind == "TransformerBlock":
            c1 = ch[frm[0]]
            c2 = args[0]
            if c2 != no:
                c2 = make_divisible(c2 * gw, 8)
            args = [c1, c2, *args[1:]]
        elif kind == "Detect":
            c1 = c2 = 0
            chans = [ch[x] for x in frm]
            if isinstance(args[1], int):
                args[1] = [list(range(args[1] * 2))] * len(frm)
            args = [args[0], args[1], chans]
        elif kind == "Contract":
            c1 = ch[frm[0]]
            c2 = c1 * args[0] ** 2
        elif kind == "Expand":
            c1 = ch[frm[0]]
            c2 = c1 // args[0] ** 2
        else:  # Upsample and other pass-throughs
            c1 = c2 = ch[frm[0]]

        # cumulative-stride bookkeeping (static form of the reference's
        # dummy-forward stride discovery)
        in_st = 1 if frm[0] == -4 else st[frm[0]]
        sf = 1.0
        if kind == "Focus":
            sf = 2.0
        elif kind in ("Conv", "DWConv", "GhostConv", "GhostBottleneck",
                      "CrossConv", "MixConv2d"):
            sf = float(args[3]) if len(args) > 3 else 1.0
        elif kind == "MaxPool2d":
            sf = float(args[1]) if len(args) > 1 else float(args[0])
        elif kind == "Upsample":
            sf = 1.0 / float(args[1])
        elif kind == "Contract":
            sf = float(args[0])
        elif kind == "Expand":
            sf = 1.0 / float(args[0])
        row_st = in_st * sf
        if kind == "Detect":
            detect_strides = tuple(int(st[x]) for x in frm)

        # normalize negative refs (other than -1 prev / -4 IR input) to
        # absolute row indices
        frm = tuple(x if (x in (-1, -4) or x >= 0) else i + x for x in frm)
        nodes.append(Node(index=i, frm=frm, repeats=reps, kind=kind,
                          args=_to_tuple(args), c1=c1, c2=c2,
                          multi=isinstance(f, (list, tuple))))
        save.update(x for x in frm if x not in (-1, -4))
        if i == 0:
            ch = []
            st = []
        ch.append(c2)
        st.append(row_st)

    strides = tuple(cfg.get(
        "strides", detect_strides or tuple(8 * 2 ** i
                                           for i in range(len(anchors)))))

    # anchors: keep pixel units; order-check against strides
    anc = check_anchor_order(
        np.asarray(anchors, dtype="float32").reshape(len(anchors), -1, 2),
        strides)
    anchors_flat = tuple(tuple(float(v) for v in a.reshape(-1)) for a in anc)

    return ModelSpec(
        nc=nc,
        nodes=tuple(nodes),
        save=tuple(sorted(save)),
        anchors=anchors_flat,
        strides=strides,
        ch_in=ch_in,
        two_stream=two_stream,
    )
