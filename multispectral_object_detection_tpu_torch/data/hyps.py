"""Hyperparameter presets: the reference hyp.scratch.yaml and hyp.finetune.yaml,
and the evolution bounds (key -> (mutation scale, lower, upper)).

The port's copy of multispectral_object_detection_tpu/data/hyps.py. PyYAML
is imported only to read a YAML path; ``dump_flat_yaml`` writes the flat
maps of a run directory (``hyp.yaml``, ``opt.yaml``) without it.
"""

from __future__ import annotations

import copy
import json
from typing import Dict

HYP_SCRATCH: Dict[str, float] = {
    "lr0": 0.01, "lrf": 0.2, "momentum": 0.937, "weight_decay": 0.0005,
    "warmup_epochs": 3.0, "warmup_momentum": 0.8, "warmup_bias_lr": 0.1,
    "box": 0.05, "cls": 0.5, "cls_pw": 1.0, "obj": 1.0, "obj_pw": 1.0,
    "iou_t": 0.20, "anchor_t": 4.0, "fl_gamma": 0.0,
    "hsv_h": 0.015, "hsv_s": 0.7, "hsv_v": 0.4,
    "degrees": 0.0, "translate": 0.1, "scale": 0.5, "shear": 0.0,
    "perspective": 0.0, "flipud": 0.0, "fliplr": 0.5,
    "mosaic": 1.0, "mixup": 0.0, "label_smoothing": 0.0,
}

HYP_FINETUNE: Dict[str, float] = {
    **HYP_SCRATCH,
    "lr0": 0.0032, "lrf": 0.12, "momentum": 0.843, "weight_decay": 0.00036,
    "warmup_epochs": 2.0, "warmup_momentum": 0.5, "warmup_bias_lr": 0.05,
    "box": 0.0296, "cls": 0.243, "cls_pw": 0.631, "obj": 0.301, "obj_pw": 0.911,
    "anchor_t": 2.91, "fl_gamma": 0.0,
    "hsv_h": 0.0138, "hsv_s": 0.664, "hsv_v": 0.464,
    "degrees": 0.373, "translate": 0.245, "scale": 0.898, "shear": 0.602,
    "perspective": 0.0, "flipud": 0.00856, "fliplr": 0.5,
    "mosaic": 1.0, "mixup": 0.243,
}

# (mutation scale, lower bound, upper bound) per evolvable key
EVOLVE_META = {
    "lr0": (1, 1e-5, 1e-1), "lrf": (1, 0.01, 1.0), "momentum": (0.3, 0.6, 0.98),
    "weight_decay": (1, 0.0, 0.001), "warmup_epochs": (1, 0.0, 5.0),
    "warmup_momentum": (1, 0.0, 0.95), "warmup_bias_lr": (1, 0.0, 0.2),
    "box": (1, 0.02, 0.2), "cls": (1, 0.2, 4.0), "cls_pw": (1, 0.5, 2.0),
    "obj": (1, 0.2, 4.0), "obj_pw": (1, 0.5, 2.0), "iou_t": (0, 0.1, 0.7),
    "anchor_t": (1, 2.0, 8.0), "fl_gamma": (0, 0.0, 2.0),
    "hsv_h": (1, 0.0, 0.1), "hsv_s": (1, 0.0, 0.9), "hsv_v": (1, 0.0, 0.9),
    "degrees": (1, 0.0, 45.0), "translate": (1, 0.0, 0.9),
    "scale": (1, 0.0, 0.9), "shear": (1, 0.0, 10.0),
    "perspective": (0, 0.0, 0.001), "flipud": (1, 0.0, 1.0),
    "fliplr": (0, 0.0, 1.0), "mosaic": (1, 0.0, 1.0), "mixup": (1, 0.0, 1.0),
}


def load_hyp(spec) -> Dict[str, float]:
    """'scratch' | 'finetune' | a YAML path | a dict -> hyp dict (keys the
    spec leaves out keep their scratch values)."""
    if spec is None or spec == "scratch":
        return copy.deepcopy(HYP_SCRATCH)
    if spec == "finetune":
        return copy.deepcopy(HYP_FINETUNE)
    out = copy.deepcopy(HYP_SCRATCH)
    if isinstance(spec, dict):
        out.update(spec)
        return out
    import yaml  # only for YAML paths

    with open(spec) as f:
        out.update(yaml.safe_load(f) or {})
    return out


def _scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return repr(v)
    if isinstance(v, float):
        r = repr(v)
        mant, _, exp = r.partition("e")
        # YAML 1.1 reads 1e-05 as a string: its floats need a dot
        return f"{mant}.0e{exp}" if exp and "." not in mant else r
    # a JSON string is a valid YAML double-quoted scalar
    return json.dumps(str(v))


def dump_flat_yaml(d: dict) -> str:
    """A map of scalars and lists of scalars as YAML (block style, keys
    sorted, as yaml.safe_dump writes them); PyYAML reads it back to the
    same values."""
    lines = []
    for k in sorted(d):
        v = d[k]
        if isinstance(v, (list, tuple)):
            lines.append(f"{k}:" if v else f"{k}: []")
            lines.extend(f"- {_scalar(x)}" for x in v)
        else:
            lines.append(f"{k}: {_scalar(v)}")
    return "\n".join(lines) + "\n"
