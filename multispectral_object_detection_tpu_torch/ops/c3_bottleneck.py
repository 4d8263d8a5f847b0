"""The fused C3 bottleneck: y = x + SiLU(conv3x3(SiLU(x . W1 + b1)) + b2).

Counterpart of multispectral_object_detection_tpu/ops/pallas_c3.py, the
BN-folded inference form of a C3 bottleneck with a shortcut and c1 == c2 ==
c_. Tensors keep that module's NHWC layout: x (B, H, W, C), w1 (C, C) as
(in, out), w2 (3, 3, C, C) HWIO or its (9, C, C) view, b1 and b2 (C,). The
port's NCHW channels_last maps are NHWC in memory, so ``x.permute(0, 2, 3,
1)`` of such a map is taken as it is.

``c3_bottleneck`` runs the CUDA kernel of kernels/csrc/c3_bottleneck.cu, two
launches of ``c3_conv`` (the 1x1, then the 3x3 with the residual), on CUDA
tensors, after ``check_c3`` has checked its arguments; on CPU
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


def check_c3(x, w1, b1, w2, b2) -> None:
    """Raise ValueError for arguments that ``c3_conv`` does not take.
    Reads shapes and dtypes only, so it runs on CPU or meta tensors; it runs
    before every launch, so it formats a message only on failure."""
    require(x.dim() == 4, "c3_bottleneck: x must be (B, H, W, C)")
    B, H, W, C = x.shape
    require(x.dtype in DTYPE_CODE and w1.dtype == w2.dtype == x.dtype,
            "c3_bottleneck: x, w1 and w2 must share one dtype, float32 or "
            "bfloat16")
    require(b1.dtype in (torch.float32, x.dtype) and
            b2.dtype in (torch.float32, x.dtype),
            "c3_bottleneck: biases must be float32 or x's dtype")
    if C % 64:
        raise ValueError(f"c3_bottleneck: C={C} must be a multiple of 64")
    if (w1.shape != (C, C) or w2.shape not in ((9, C, C), (3, 3, C, C))
            or b1.shape != (C,) or b2.shape != (C,)):
        raise ValueError(f"c3_bottleneck: weights w1 {tuple(w1.shape)}, w2 "
                         f"{tuple(w2.shape)}, b1 {tuple(b1.shape)}, b2 "
                         f"{tuple(b2.shape)} do not fit C={C}")
    if B * H * W > 2 ** 31 - 256:  # the kernel's pixel indices are ints
        raise ValueError(f"c3_bottleneck: {B * H * W} pixels, at most "
                         f"{2 ** 31 - 256}")


def c3_conv(a, w, b, res, out, taps: int) -> None:
    """One launch of kernel ``c3_conv``: out = SiLU(a . w + b), the 1x1
    (taps=1, res None), or out = res + SiLU(conv3x3(a, w) + b) (taps=9);
    a (B, H, W, C), w (taps, C, N) or (C, N), out (B, H, W, N). Arguments as
    ``c3_bottleneck`` checks them."""
    B, H, W, C = a.shape
    launch("c3_bottleneck", "c3_conv", a.device, ptr(a), ptr(w), ptr(b),
           int(b.dtype == torch.bfloat16), ptr(res), ptr(out), B, H, W, C,
           out.shape[-1], taps, DTYPE_CODE[a.dtype])
    LAUNCHES["c3_bottleneck"] += 1


def c3_bottleneck(x, w1, b1, w2, b2):
    """Kernel ``c3_conv`` (kernels/csrc/c3_bottleneck.cu), two launches."""
    if on_cpu(x, w1, b1, w2, b2):
        return c3_bottleneck_plain(x, w1, b1, w2, b2)
    check_c3(x, w1, b1, w2, b2)
    x = x.contiguous()  # free for a permuted channels_last map
    z = torch.empty_like(x)
    out = torch.empty_like(x)
    check_args("c3_bottleneck", x=x, w1=w1, b1=b1, w2=w2, b2=b2, z=z,
               out=out)
    c3_conv(x, w1, b1, None, z, 1)
    c3_conv(z, w2, b2, x, out, 9)
    return out
