"""Seeded weights in the reference layout, drawn on the device.

Every tensor of the reference's state dict (BatchNorm unfolded, with its
running statistics) comes from two draws of one ``torch.Generator`` on the
device: one ``randn`` and one ``rand`` over all elements, cut and scaled
per tensor by the configuration's ``init``. The program and the reference
both load this state dict; neither takes anything the other made.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from .reference.model import ReferenceModel
from .seeds import derive


def _spec(cfg: dict):
    """[(key, shape, draw)] of the reference's floating tensors, where
    draw is ("normal", mean, std) or ("uniform", low, high)."""
    init = cfg["init"]
    with torch.device("meta"):
        model = ReferenceModel(cfg)
    nc, na = model.nc, model.anchors.shape[1]
    out = []
    for key, t in model.state_dict().items():
        if not t.is_floating_point():
            continue
        shape = tuple(t.shape)
        leaf = key.rsplit(".", 1)[-1]
        if ".bn." in key:
            draw = {"weight": ("uniform", *init["bn_weight_uniform"]),
                    "bias": ("normal", 0.0, init["bn_bias_std"]),
                    "running_mean": ("normal", 0.0, init["bn_mean_std"]),
                    "running_var": ("uniform", *init["bn_var_uniform"])}[leaf]
        elif "ln_" in key:
            draw = ("normal", 1.0 if leaf == "weight" else 0.0,
                    init["ln_weight_std"] if leaf == "weight"
                    else init["ln_bias_std"])
        elif leaf == "pos_emb":
            draw = ("normal", 0.0, init["pos_emb_std"])
        elif "trans_blocks" in key:
            draw = ("normal", 0.0, init["cft_linear_std"] if leaf == "weight"
                    else init["cft_bias_std"])
        elif len(shape) == 4:  # convolutions and the Detect convs
            draw = ("normal", 0.0, 1.0 / math.sqrt(
                shape[1] * shape[2] * shape[3]))
        elif leaf == "bias":  # the Detect biases: the YOLOv5 prior
            draw = ("prior", None, init["detect_bias_std"])
        else:
            raise ValueError(f"no draw for {key} {shape}")
        out.append((key, shape, draw))
    return out, model.strides, nc, na


def detect_prior(nc: int, na: int, stride: int, canvas: int,
                 objects: float) -> torch.Tensor:
    """YOLOv5's Detect bias prior, (na * (5 + nc),): objectness for about
    ``objects`` objects per image, classes 0.6 / (nc - 0.99)."""
    b = torch.zeros(na, nc + 5)
    b[:, 4] = math.log(objects / (canvas / stride) ** 2)
    b[:, 5:] = math.log(0.6 / (nc - 0.99))
    return b.reshape(-1)


def draw_state_dict(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The configuration's fp32 weights for ``seed``, on ``device``."""
    spec, strides, nc, na = _spec(cfg)
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, "weights"))
    sizes = [math.prod(s) for _, s, _ in spec]
    normal = torch.randn(sum(sizes), generator=g, device=device)
    uniform = torch.rand(sum(sizes), generator=g, device=device)
    sd, off, det = {}, 0, 0
    for (key, shape, (kind, a, b)), n in zip(spec, sizes):
        if kind == "uniform":
            t = uniform[off:off + n] * (b - a) + a
        else:
            t = normal[off:off + n] * b
            if kind == "prior":
                t = t + detect_prior(nc, na, strides[det], cfg["canvas"],
                                     cfg["init"]["detect_prior_objects"]
                                     ).to(device)
                det += 1
            elif a:
                t = t + a
        sd[key] = t.view(shape)
        off += n
    return sd
