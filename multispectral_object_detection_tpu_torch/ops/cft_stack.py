"""The CFT token transformer stack: L pre-LN layers over (B, N, C) tokens.

Counterpart of multispectral_object_detection_tpu/ops/pallas_fusion.py. The
TPU kernel runs all L layers in one call with the fp32 residual stream held
in VMEM. On the GPU the stream (B*N, C) fp32 stays in device memory and each
layer is seven launches of three hand-written CUDA kernels
(kernels/csrc/*.cu):

    layer_norm -> linear(bias) -> attention -> linear(residual)
    layer_norm -> linear(gelu) -> linear(residual)

Every kernel has a plain PyTorch twin beside it (``*_plain``) that repeats
its arithmetic and rounding points. A wrapper takes the twin only for
tensors on the CPU; for CUDA tensors it launches its kernel or raises.
Each launch adds one to the counter ``k1.<kernel>`` (``COUNTERS``,
utils/tracing), so a run can show that it went through the kernels.

Numerics follow ``_kernel`` of pallas_fusion.py: LayerNorm statistics in
fp32 (eps 1e-5), matmuls accumulated in fp32 with biases widened from the
compute dtype, fp32 logits and softmax, attention probabilities rounded to
the compute dtype, exact GELU, fp32 residual stream.

The kernels have no backward. Their wrappers refuse, on the card, inputs
that need a gradient while grad mode is on, instead of returning a result
cut from the autograd graph. Training runs ``cft_stack_train``: plain,
out-of-place PyTorch that computes what the JAX package trains through (the
``lax.scan`` of models/fusion.py ``_scan_stack``), with dropout, and a
residual stream in the compute dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels import DTYPE_CODE, check_args, launch, on_cpu, ptr, require
from ..utils.tracing import count

COUNTERS = ("k1.cft_layernorm", "k1.cft_gemm_bias", "k1.cft_gemm_gelu",
            "k1.cft_gemm_residual", "k1.cft_attention")
EPILOGUES = ("bias", "gelu", "residual")


def _refuse_grad(name: str, *tensors) -> None:
    """The kernels write their outputs through raw pointers: a result would
    carry no ``grad_fn``, and gradients would stop here without a word."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward; call it under "
            "torch.no_grad() or inference_mode, or train through "
            "cft_stack_train")


def _launch(lib_name: str, fn: str, counter: str, device, *args) -> None:
    launch(lib_name, fn, device, *args)
    count(counter)


# --------------------------------------------------------------- LayerNorm
def layer_norm_plain(x, scale, bias, dtype, eps: float = 1e-5):
    """x (M, C) fp32 -> LayerNorm(x) in ``dtype``; two-pass fp32 statistics."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + eps) * scale + bias).to(dtype)


def check_layer_norm(x, scale, bias, dtype) -> None:
    """Raise ValueError for arguments that ``cft_layernorm`` does not take.
    Reads shapes and dtypes only, so it runs on CPU or meta tensors. Like
    the other checks it runs before every launch, so it formats a message
    only on failure."""
    require(x.dim() == 2, "layer_norm: x must be (M, C)")
    C = x.shape[1]
    require(x.dtype == scale.dtype == bias.dtype == torch.float32,
            "layer_norm: x, scale and bias must be float32")
    if dtype not in DTYPE_CODE:
        raise ValueError(f"layer_norm: unsupported dtype {dtype}")
    if C % 4 or C > 2048:
        raise ValueError(f"layer_norm: C={C} must be a multiple of 4 and at "
                         "most 2048")
    require(scale.shape == bias.shape == (C,), "layer_norm: scale and bias "
            "must be (C,)")


def layer_norm(x, scale, bias, dtype, eps: float = 1e-5):
    """Kernel ``cft_layernorm`` (kernels/csrc/layernorm.cu)."""
    if on_cpu(x, scale, bias):
        return layer_norm_plain(x, scale, bias, dtype, eps)
    _refuse_grad("layer_norm", x, scale, bias)
    check_layer_norm(x, scale, bias, dtype)
    M, C = x.shape
    out = torch.empty((M, C), dtype=dtype, device=x.device)
    check_args("layer_norm", x=x, scale=scale, bias=bias, out=out)
    _launch("layernorm", "cft_layernorm", "k1.cft_layernorm", x.device,
            ptr(x), ptr(scale), ptr(bias), ptr(out), M, C, eps,
            DTYPE_CODE[dtype])
    return out


# ------------------------------------------------ GEMM with fused epilogue
def linear_plain(a, w, bias, epilogue: str, out=None):
    """epilogue(a (M, K) . w (K, N) + bias) with an fp32 accumulator.

    'bias' and 'gelu' return (M, N) in a's dtype; 'residual' adds into the
    fp32 stream ``out`` (M, N) in place and returns it."""
    acc = torch.matmul(a.float(), w.float())
    if epilogue == "residual":
        return out.add_(acc).add_(bias.float())
    t = acc + bias.float()
    if epilogue == "gelu":
        t = F.gelu(t)
    return t.to(a.dtype)


def _check_epilogue(epilogue: str, out) -> None:
    if epilogue not in EPILOGUES:
        raise ValueError(f"linear: unknown epilogue {epilogue!r}")
    require((out is not None) == (epilogue == "residual"),
            "linear: `out` is the residual stream, given only for the "
            "'residual' epilogue")


def check_linear(a, w, bias, epilogue: str, out=None) -> None:
    """Raise ValueError for arguments that ``cft_gemm`` does not take.
    Reads shapes and dtypes only, so it runs on CPU or meta tensors."""
    _check_epilogue(epilogue, out)
    require(a.dim() == 2 and w.dim() == 2, "linear: a and w must be 2-D")
    M, K = a.shape
    N = w.shape[1]
    require(a.dtype == w.dtype == bias.dtype and a.dtype in DTYPE_CODE,
            "linear: a, w and bias must share one dtype, float32 or bfloat16")
    if w.shape != (K, N) or bias.shape != (N,):
        raise ValueError(f"linear: w {tuple(w.shape)} / bias "
                         f"{tuple(bias.shape)} do not fit a {tuple(a.shape)}")
    if M % 64 or N % 64 or K % 32:
        raise ValueError(f"linear: needs M % 64 == N % 64 == K % 32 == 0, "
                         f"got M={M} N={N} K={K}")
    if out is not None:
        require(out.dtype == torch.float32 and out.shape == (M, N),
                "linear: the residual stream must be float32 (M, N)")


def linear(a, w, bias, epilogue: str, out=None):
    """Kernel ``cft_gemm`` (kernels/csrc/gemm.cu), one launch."""
    _check_epilogue(epilogue, out)
    tensors = (a, w, bias) + ((out,) if out is not None else ())
    if on_cpu(*tensors):
        return linear_plain(a, w, bias, epilogue, out)
    _refuse_grad("linear", *tensors)
    check_linear(a, w, bias, epilogue, out)
    M, K = a.shape
    N = w.shape[1]
    if out is None:
        out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    check_args("linear", a=a, w=w, bias=bias, out=out)
    _launch("gemm", "cft_gemm", f"k1.cft_gemm_{epilogue}", a.device,
            ptr(a), ptr(w), ptr(bias), ptr(out), M, N, K,
            EPILOGUES.index(epilogue), DTYPE_CODE[a.dtype])
    return out


# --------------------------------------------------------------- attention
def attention_plain(qkv, batch: int, num_heads: int):
    """qkv (B*N, 3C) with columns [q | k | v] -> per-(image, head)
    softmax(QK^T / sqrt(D)) V as (B*N, C) in qkv's dtype."""
    M, C3 = qkv.shape
    C = C3 // 3
    n, d = M // batch, C // num_heads
    q, k, v = qkv.view(batch, n, 3, num_heads, d).float().unbind(2)
    logits = torch.einsum("bnhd,bmhd->bhnm", q, k)
    att = torch.softmax(logits / math.sqrt(d), dim=-1).to(qkv.dtype)
    o = torch.einsum("bhnm,bmhd->bnhd", att.float(), v)
    return o.reshape(M, C).to(qkv.dtype)


def check_attention(qkv, batch: int, num_heads: int) -> None:
    """Raise ValueError for arguments that ``cft_attention`` does not take.
    Reads shapes and dtypes only, so it runs on CPU or meta tensors."""
    require(qkv.dim() == 2, "attention: qkv must be (B*N, 3C)")
    M, C3 = qkv.shape
    C = C3 // 3
    require(qkv.dtype in DTYPE_CODE,
            "attention: qkv must be float32 or bfloat16")
    if (batch <= 0 or num_heads <= 0 or C3 % 3 or M % batch
            or C % num_heads):
        raise ValueError(f"attention: qkv {tuple(qkv.shape)} does not split "
                         f"into {batch} images and {num_heads} heads")
    d = C // num_heads
    if d % 8 or not 0 < d <= 160:
        raise ValueError(f"attention: head width {d} must be a multiple of 8 "
                         "and at most 160")
    if not 0 < M // batch <= 128:
        raise ValueError(f"attention: {M // batch} tokens per image, at most "
                         "128")


def attention(qkv, batch: int, num_heads: int):
    """Kernel ``cft_attention`` (kernels/csrc/attention.cu)."""
    if on_cpu(qkv):
        return attention_plain(qkv, batch, num_heads)
    _refuse_grad("attention", qkv)
    check_attention(qkv, batch, num_heads)
    M, C3 = qkv.shape
    C = C3 // 3
    n = M // batch
    out = torch.empty((M, C), dtype=qkv.dtype, device=qkv.device)
    check_args("attention", qkv=qkv, out=out)
    _launch("attention", "cft_attention", "k1.cft_attention", qkv.device,
            ptr(qkv), ptr(out), batch, n, C, num_heads,
            DTYPE_CODE[qkv.dtype])
    return out


# ------------------------------------------------------------ whole stack
def _run_stack(ops, x, wqkv, bqkv, wp, bp, w1, b1, w2, b2, ln1, ln2,
               num_heads: int):
    layer_norm_fn, linear_fn, attention_fn = ops
    B, N, C = x.shape
    L = wqkv.shape[0]
    shapes = {"wqkv": (wqkv, (L, C, 3 * C)), "bqkv": (bqkv, (L, 3 * C)),
              "wp": (wp, (L, C, C)), "bp": (bp, (L, C)),
              "w1": (w1, (L, C, 4 * C)), "b1": (b1, (L, 4 * C)),
              "w2": (w2, (L, 4 * C, C)), "b2": (b2, (L, C)),
              "ln1": (ln1, (L, 2, C)), "ln2": (ln2, (L, 2, C))}
    for name, (t, want) in shapes.items():
        require(tuple(t.shape) == want, f"fused_cft_stack: {name} is "
                f"{tuple(t.shape)}, expected {want}")
    dt = x.dtype
    xs = torch.empty((B * N, C), dtype=torch.float32, device=x.device)
    xs.copy_(x.reshape(B * N, C))  # fp32 residual stream, updated in place
    for i in range(L):
        h = layer_norm_fn(xs, ln1[i, 0], ln1[i, 1], dt)
        qkv = linear_fn(h, wqkv[i], bqkv[i], "bias")
        o = attention_fn(qkv, B, num_heads)
        linear_fn(o, wp[i], bp[i], "residual", out=xs)
        h2 = layer_norm_fn(xs, ln2[i, 0], ln2[i, 1], dt)
        t = linear_fn(h2, w1[i], b1[i], "gelu")
        linear_fn(t, w2[i], b2[i], "residual", out=xs)
    return xs.to(dt).reshape(B, N, C)


def fused_cft_stack(x, wqkv, bqkv, wp, bp, w1, b1, w2, b2, ln1, ln2, *,
                    num_heads: int = 8):
    """x (B, N, C); stacked per-layer weights with a leading L axis, as in
    pallas_fusion.fused_cft_stack: wqkv (L, C, 3C), bqkv (L, 3C),
    wp (L, C, C), bp (L, C), w1 (L, C, 4C), b1 (L, 4C), w2 (L, 4C, C),
    b2 (L, C) in x's dtype; ln1/ln2 (L, 2, C) [scale, bias] float32.
    Returns (B, N, C) in x's dtype. 7 kernel launches per layer on CUDA."""
    return _run_stack((layer_norm, linear, attention), x, wqkv, bqkv, wp, bp,
                      w1, b1, w2, b2, ln1, ln2, num_heads)


def fused_cft_stack_plain(x, wqkv, bqkv, wp, bp, w1, b1, w2, b2, ln1, ln2, *,
                          num_heads: int = 8):
    """Plain PyTorch twin of ``fused_cft_stack`` on any device (the
    counterpart of pallas_fusion.fused_cft_stack_reference)."""
    return _run_stack((layer_norm_plain, linear_plain, attention_plain), x,
                      wqkv, bqkv, wp, bp, w1, b1, w2, b2, ln1, ln2, num_heads)


def cft_stack_train(x, wqkv, bqkv, wp, bp, w1, b1, w2, b2, ln1, ln2, *,
                    num_heads: int = 8, dropout=None, tp=None):
    """The stack for training: differentiable and out of place, step for
    step the JAX package's ``_scan_stack``. Arguments as ``fused_cft_stack``
    (weights in any float dtype, cast to x's at use). Per layer:

        h = LN1(x) (fp32 statistics, eps 1e-5) in x's dtype
        qkv = h @ wqkv + bqkv                  (x's dtype)
        a = drop(softmax(q k^T / sqrt(D)), 0)  (fp32, then x's dtype) @ v
        x = x + drop(a @ wp + bp, 1)           (x's dtype)
        x = x + drop(GELU(LN2(x) @ w1 + b1) @ w2 + b2, 2)

    so the residual stream stays in x's dtype (K1 keeps it in fp32).
    ``dropout(t, layer, slot)`` returns t with dropout applied; None for
    none. Tensor parallel: ``tp`` = (enter, reduce), the weights this
    rank's shards (wqkv (L, C, 3C/n) of whole heads, wp (L, C/n, C), w1
    (L, C, 4C/n), w2 (L, 4C/n, C)); ``enter`` wraps the LayerNorm outputs
    that feed the split products, ``reduce`` sums the row-split products
    before their biases."""
    B, N, C = x.shape
    dt = x.dtype
    d = C // num_heads
    heads = wqkv.shape[-1] // (3 * d)  # this rank's heads
    enter, reduce = tp if tp is not None else (None, None)
    for i in range(wqkv.shape[0]):
        h = layer_norm_plain(x.float(), ln1[i, 0], ln1[i, 1], dt)
        if enter is not None:
            h = enter(h)
        qkv = (h @ wqkv[i].to(dt) + bqkv[i].to(dt)).view(B, N, 3, heads, d)
        q, k, v = qkv.unbind(2)
        logits = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float())
        att = torch.softmax(logits / math.sqrt(d), dim=-1)
        if dropout is not None:
            att = dropout(att, i, 0)
        a = torch.einsum("bhnm,bmhd->bnhd", att.to(dt), v).reshape(
            B, N, heads * d)
        a = a @ wp[i].to(dt)
        if reduce is not None:
            a = reduce(a)
        a = a + bp[i].to(dt)
        if dropout is not None:
            a = dropout(a, i, 1)
        x = x + a
        h = layer_norm_plain(x.float(), ln2[i, 0], ln2[i, 1], dt)
        if enter is not None:
            h = enter(h)
        t = F.gelu(h @ w1[i].to(dt) + b1[i].to(dt))
        t = t @ w2[i].to(dt)
        if reduce is not None:
            t = reduce(t)
        t = t + b2[i].to(dt)
        if dropout is not None:
            t = dropout(t, i, 2)
        x = x + t
    return x
