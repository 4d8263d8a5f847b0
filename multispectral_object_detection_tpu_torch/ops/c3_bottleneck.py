"""The fused C3 bottleneck: y = x + SiLU(conv3x3(SiLU(x . W1 + b1)) + b2).

Counterpart of multispectral_object_detection_tpu/ops/pallas_c3.py, the
BN-folded inference form of a C3 bottleneck with a shortcut and c1 == c2 ==
c_. Tensors keep that module's NHWC layout: x (B, H, W, C), w1 (C, C) as
(in, out), w2 (3, 3, C, C) HWIO or its (9, C, C) view, b1 and b2 (C,). The
port's NCHW channels_last maps are NHWC in memory, so ``x.permute(0, 2, 3,
1)`` of such a map is taken as it is.

``c3_bottleneck`` runs the CUDA kernel of kernels/csrc/c3_bottleneck.cu, two
launches (the 1x1, then the 3x3 with the residual), on CUDA tensors; on CPU
tensors it runs ``c3_bottleneck_plain``, the counterpart of
``bottleneck_ref`` with its rounding points: z = SiLU(x . W1 in fp32 + b1)
rounded to the dtype; y = conv3x3(z) in fp32 + b2; out = (x in fp32 +
SiLU(y)) rounded. ``LAUNCHES`` counts the kernel's launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import DTYPE_CODE, check_args, launch, on_cpu, ptr, require

LAUNCHES = {"c3_bottleneck": 0}


def reset_launches() -> None:
    LAUNCHES["c3_bottleneck"] = 0


def c3_bottleneck_plain(x, w1, b1, w2, b2):
    """Plain PyTorch version of the fused bottleneck on any device."""
    C = x.shape[-1]
    dt = x.dtype
    z = F.silu(torch.matmul(x.float(), w1.float()) + b1.float()).to(dt)
    w = w2.float().reshape(3, 3, C, C).permute(3, 2, 0, 1)  # HWIO -> OIHW
    y = F.conv2d(z.permute(0, 3, 1, 2).float(), w, padding=1)
    y = y.permute(0, 2, 3, 1) + b2.float()
    return (x.float() + F.silu(y)).to(dt)


def c3_bottleneck(x, w1, b1, w2, b2):
    """Kernel ``c3_conv`` (kernels/csrc/c3_bottleneck.cu), two launches."""
    if on_cpu(x, w1, b1, w2, b2):
        return c3_bottleneck_plain(x, w1, b1, w2, b2)
    require(x.dim() == 4, f"c3_bottleneck: x must be (B, H, W, C), got "
            f"{tuple(x.shape)}")
    B, H, W, C = x.shape
    require(x.dtype in DTYPE_CODE and w1.dtype == w2.dtype == x.dtype,
            "c3_bottleneck: x, w1 and w2 must share one dtype, float32 or "
            "bfloat16")
    require(b1.dtype in (torch.float32, x.dtype) and
            b2.dtype in (torch.float32, x.dtype),
            "c3_bottleneck: biases must be float32 or x's dtype")
    require(C % 64 == 0, f"c3_bottleneck: C={C} must be a multiple of 64")
    require(tuple(w1.shape) == (C, C) and w2.numel() == 9 * C * C and
            tuple(w2.shape[-2:]) == (C, C) and
            tuple(b1.shape) == tuple(b2.shape) == (C,),
            f"c3_bottleneck: weights w1 {tuple(w1.shape)}, w2 "
            f"{tuple(w2.shape)}, b1 {tuple(b1.shape)}, b2 {tuple(b2.shape)} "
            f"do not fit C={C}")
    x = x.contiguous()  # free for a permuted channels_last map
    z = torch.empty_like(x)
    out = torch.empty_like(x)
    check_args("c3_bottleneck", x=x, w1=w1, b1=b1, w2=w2, b2=b2, z=z,
               out=out)
    dt = DTYPE_CODE[x.dtype]
    for a, w, b, res, o, taps in ((x, w1, b1, None, z, 1),
                                  (z, w2, b2, x, out, 9)):
        launch("c3_bottleneck", "c3_conv", x.device, ptr(a), ptr(w), ptr(b),
               int(b.dtype == torch.bfloat16), ptr(res), ptr(o), B, H, W, C,
               C, taps, dt)
        LAUNCHES["c3_bottleneck"] += 1
    return out
