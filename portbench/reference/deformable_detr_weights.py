"""Seeded weights for Deformable DETR in the official layout, drawn on the
device.

Every floating tensor of the reference's state dict (``deformable_detr``:
the frozen BatchNorms with their statistics, the heads that the official
layout repeats per decoder layer drawn once and shared) comes from two
draws of one ``torch.Generator``: one ``randn`` and one ``rand`` over all
elements, cut and scaled per tensor by the configuration's ``init``. The
program and the reference both load this state dict.

The published initialisation zeroes ``sampling_offsets.weight`` and
``attention_weights``, so that every query of a level would sample the
same pattern with equal weights; the draw gives them standard deviations
instead (``init``), keeping the published grid as the offsets' bias, so
that each query samples its own points.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from ..seeds import derive
from .deformable_detr import DeformableDETR


def grid_bias(heads: int, levels: int, points: int) -> torch.Tensor:
    """The official ``sampling_offsets`` bias: head h looks along
    (cos, sin)(2 pi h / heads) scaled to the unit square, point p at p + 1
    pixels of its level; (heads * levels * points * 2,)."""
    theta = torch.arange(heads, dtype=torch.float32) * (2 * math.pi / heads)
    g = torch.stack([theta.cos(), theta.sin()], -1)
    g = (g / g.abs().max(-1, keepdim=True)[0]).view(heads, 1, 1, 2)
    g = g.repeat(1, levels, points, 1)
    return (g * torch.arange(1, points + 1).view(1, 1, points, 1)).flatten()


def _spec(cfg: dict):
    """[(keys, shape, draw)] of the reference's floating tensors, one entry
    per distinct tensor (``keys``: every name it has), where draw is
    ("normal", mean, std), ("uniform", low, high) or ("fixed", tensor,
    std): a fixed tensor plus normal noise."""
    init = cfg["init"]
    with torch.device("meta"):
        model = DeformableDETR(cfg)
    heads, levels = cfg["nheads"], cfg["num_feature_levels"]
    seen: Dict[int, list] = {}
    out = []
    for key, t in model.state_dict(keep_vars=True).items():
        if id(t) in seen:
            seen[id(t)].append(key)
            continue
        keys = seen[id(t)] = [key]
        shape = tuple(t.shape)
        leaf = key.rsplit(".", 1)[-1]
        fan_in = math.prod(shape[1:]) if len(shape) > 1 else 0
        if key.startswith("backbone.") and len(shape) == 1:  # frozen BN
            draw = {"weight": ("uniform", *init["bn_weight_uniform"]),
                    "bias": ("normal", 0.0, init["bn_bias_std"]),
                    "running_mean": ("normal", 0.0, init["bn_mean_std"]),
                    "running_var": ("uniform", *init["bn_var_uniform"])}[leaf]
        elif ".norm" in key or (key.startswith("input_proj.")
                                and key.split(".")[2] == "1"):
            draw = ("normal", 1.0, init["norm_weight_std"]) if \
                leaf == "weight" else ("normal", 0.0, init["norm_bias_std"])
        elif key == "transformer.level_embed":
            draw = ("normal", 0.0, init["level_embed_std"])
        elif key == "query_embed.weight":
            draw = ("normal", 0.0, init["query_embed_std"])
        elif "sampling_offsets" in key:
            draw = ("normal", 0.0, init["sampling_offsets_weight_std"]) if \
                leaf == "weight" else ("fixed", grid_bias(
                    heads, levels, cfg["enc_n_points"] if ".encoder." in key
                    else cfg["dec_n_points"]), init["bias_std"])
        elif key.startswith("class_embed.") and leaf == "bias":
            p = init["class_prior_prob"]
            draw = ("fixed", torch.full(shape, -math.log((1 - p) / p)),
                    init["bias_std"])
        elif key.startswith("bbox_embed.") and key.endswith(
                "layers.2.bias"):
            draw = ("fixed", torch.tensor(init["box_last_bias"]),
                    init["bias_std"])
        elif leaf in ("weight", "in_proj_weight") and fan_in:
            draw = ("normal", 0.0, 1.0 / math.sqrt(fan_in))
        elif leaf in ("bias", "in_proj_bias"):
            draw = ("normal", 0.0, init["bias_std"])
        else:
            raise ValueError(f"no draw for {key} {shape}")
        out.append((keys, shape, draw))
    return out


def draw_state_dict(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The configuration's fp32 weights for ``seed``, on ``device``, under
    every official name (a shared head's names hold one tensor)."""
    spec = _spec(cfg)
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, "weights"))
    sizes = [math.prod(s) for _, s, _ in spec]
    normal = torch.randn(sum(sizes), generator=g, device=device)
    uniform = torch.rand(sum(sizes), generator=g, device=device)
    sd, off = {}, 0
    for (keys, shape, (kind, a, b)), n in zip(spec, sizes):
        if kind == "uniform":
            t = uniform[off:off + n] * (b - a) + a
        elif kind == "fixed":
            t = normal[off:off + n] * b + a.to(device)
        else:
            t = normal[off:off + n] * b + a
        for k in keys:
            sd[k] = t.view(shape)
        off += n
    return sd
