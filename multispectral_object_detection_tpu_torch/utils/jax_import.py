"""Weight bridge: the JAX package's parameter trees -> a reference-layout
state dict for the port.

The inverse of multispectral_object_detection_tpu/utils/torch_import.py
``convert_state_dict``. It reads plain nested dicts of arrays (numpy, or
anything ``np.asarray`` takes), so it needs neither JAX nor flax:

- ``blocks_{i}/…`` -> ``model.{i}.…``, ``m{k}`` -> ``m.{k}``;
- conv kernels HWIO (kh, kw, I, O) -> OIHW (O, I, kh, kw); dense kernels
  (in, out) -> (out, in);
- BatchNorm ``scale``/``bias`` and batch stats ``mean``/``var`` ->
  ``weight``/``bias``/``running_mean``/``running_var``;
- the stacked CFT parameters (``qkv_w`` (L, C, 3C) …) -> the reference GPT
  keys per layer: ``trans_blocks.{j}.sa.que_proj/key_proj/val_proj`` from
  the three (C, C) column blocks of ``qkv_w``, transposed.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np

_BLOCK = re.compile(r"^blocks_(\d+)$")
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


def _walk(prefix: str, tree: dict, out: Dict[str, np.ndarray]) -> None:
    for k, v in tree.items():
        m = _INDEXED.match(k)
        name = f"{prefix}.m.{m.group(1)}" if m else f"{prefix}.{k}"
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
            name = f"{prefix}{m.group(1)}"
            if "qkv_w" in sub:
                out.update(_gpt(name, sub))
            else:
                _walk(name, sub, out)
    return out
