"""Weight bridge: the JAX package's parameter trees -> a reference-layout
state dict for the port.

The inverse of multispectral_object_detection_tpu/utils/torch_import.py
``convert_state_dict``. It reads plain nested dicts of arrays (numpy, or
anything ``np.asarray`` takes), so it needs neither JAX nor flax:

- ``blocks_{i}/…`` -> ``model.{i}.…`` (a repeated row's ``blocks_{i}_{j}``
  -> ``model.{i}.{j}``), ``m{k}`` -> ``m.{k}``;
- conv kernels HWIO (kh, kw, I, O) -> OIHW (O, I, kh, kw); dense kernels
  (in, out) -> (out, in);
- BatchNorm ``scale``/``bias`` and batch stats ``mean``/``var`` ->
  ``weight``/``bias``/``running_mean``/``running_var``;
- the zoo: ``tr{k}`` -> ``tr.{k}``, a TransformerBlock's ``pos`` ->
  ``linear``, the packed attention's ``in_proj_w`` (c, 3c) ->
  ``ma.in_proj_weight`` (3c, c), ``in_proj_b`` and ``out`` ->
  ``ma.in_proj_bias`` and ``ma.out_proj``; BottleneckCSP's bare
  ``cv2``/``cv3`` kernels and ``bn``, MixConv2d's ``m{i}`` and Sum's ``w``
  keep their names; GhostBottleneck's ``g1``, ``ConvBnAct_0``, ``g2``,
  ``ConvBnAct_1``, ``sc`` -> ``conv.0``-``conv.2``, ``shortcut.0``,
  ``shortcut.1``; CrossConv's ``cv1_conv`` -> ``cv1.conv``;
- the stacked CFT parameters (``qkv_w`` (L, C, 3C) …) -> the reference GPT
  keys per layer: ``trans_blocks.{j}.sa.que_proj/key_proj/val_proj`` from
  the three (C, C) column blocks of ``qkv_w``, transposed.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np

_BLOCK = re.compile(r"^blocks_(\d+)(?:_(\d+))?$")
_INDEXED = re.compile(r"^m(\d+)$")
_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean",
         "var": "running_var"}


def _gpt(prefix: str, p: dict) -> Dict[str, np.ndarray]:
    out = {f"{prefix}.pos_emb": np.asarray(p["pos_emb"])}
    lnf = np.asarray(p["ln_f"])
    out[f"{prefix}.ln_f.weight"], out[f"{prefix}.ln_f.bias"] = lnf[0], lnf[1]
    qkv_w, qkv_b = np.asarray(p["qkv_w"]), np.asarray(p["qkv_b"])
    c = qkv_w.shape[1]
    for j in range(qkv_w.shape[0]):
        t = f"{prefix}.trans_blocks.{j}"
        for ln, name in (("ln1", "ln_input"), ("ln2", "ln_output")):
            v = np.asarray(p[ln])[j]
            out[f"{t}.{name}.weight"], out[f"{t}.{name}.bias"] = v[0], v[1]
        for s, proj in enumerate(("que_proj", "key_proj", "val_proj")):
            out[f"{t}.sa.{proj}.weight"] = np.ascontiguousarray(
                qkv_w[j][:, s * c:(s + 1) * c].T)
            out[f"{t}.sa.{proj}.bias"] = qkv_b[j][s * c:(s + 1) * c]
        for key, name in (("proj", "sa.out_proj"), ("fc1", "mlp.0"),
                          ("fc2", "mlp.2")):
            out[f"{t}.{name}.weight"] = np.ascontiguousarray(
                np.asarray(p[f"{key}_w"])[j].T)
            out[f"{t}.{name}.bias"] = np.asarray(p[f"{key}_b"])[j]
    return out


# the JAX package's GhostBottleneck names (flax numbers its unnamed
# dwconvs) -> the reference's Sequential positions
_GHOST = {"g1": "conv.0", "ConvBnAct_0": "conv.1", "g2": "conv.2",
          "ConvBnAct_1": "shortcut.0", "sc": "shortcut.1"}
_INDEXED_TR = re.compile(r"^tr(\d+)$")
_CROSS = re.compile(r"^(cv\d)_(conv|bn)$")


def _child_name(k: str, tree: dict) -> str:
    """A JAX submodule or leaf name -> the reference's, in its parent."""
    for pattern, base in ((_INDEXED, "m"), (_INDEXED_TR, "tr")):
        m = pattern.match(k)
        if m:
            return f"{base}.{m.group(1)}"
    if "g1" in tree and k in _GHOST:
        return _GHOST[k]
    m = _CROSS.match(k)
    if m:  # CrossConv: cv1_conv -> cv1.conv
        return f"{m.group(1)}.{m.group(2)}"
    if "in_proj_w" in tree and k == "out":  # nn.MultiheadAttention
        return "ma.out_proj"
    if k == "pos" and any(_INDEXED_TR.match(j) for j in tree):
        return "linear"  # TransformerBlock's position embedding
    return k


def _walk(prefix: str, tree: dict, out: Dict[str, np.ndarray]) -> None:
    for k, v in tree.items():
        name = f"{prefix}.{_child_name(k, tree)}"
        if isinstance(v, dict):
            _walk(name, v, out)
            continue
        v = np.asarray(v)
        if k == "kernel":
            base = name[: -len(".kernel")]
            out[f"{base}.weight"] = np.ascontiguousarray(
                v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.T)
        elif k in _LEAF:
            out[f"{prefix}.{_LEAF[k]}"] = v
        elif k == "in_proj_w":  # stored (c, 3c), torch's x @ W.T form
            out[f"{prefix}.ma.in_proj_weight"] = np.ascontiguousarray(v.T)
        elif k == "in_proj_b":
            out[f"{prefix}.ma.in_proj_bias"] = v
        elif k == "w":  # Sum's weights
            out[name] = v
        else:
            raise KeyError(f"no reference name for parameter {name!r}")


def state_dict_from_jax(params: dict, batch_stats: dict | None = None,
                        prefix: str = "model.") -> Dict[str, np.ndarray]:
    """(params, batch_stats) trees of the unfused JAX DetectionModel ->
    ``{reference key: ndarray}``."""
    out: Dict[str, np.ndarray] = {}
    for tree in (params, batch_stats or {}):
        for block, sub in tree.items():
            m = _BLOCK.match(block)
            if m is None:
                raise KeyError(f"not a graph block: {block!r}")
            # a repeated row's modules are blocks_{i}_{j} in the JAX model
            name = f"{prefix}{m.group(1)}" + (
                f".{m.group(2)}" if m.group(2) is not None else "")
            if "qkv_w" in sub:
                out.update(_gpt(name, sub))
            else:
                _walk(name, sub, out)
    return out
