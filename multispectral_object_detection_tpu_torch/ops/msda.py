"""Multi-scale deformable attention's sampling (Deformable DETR's MSDA core).

Each query of each head reads ``points`` positions in every level of a
multi-level value map, at its reference point plus offsets that its own
features chose, and sums the bilinear samples with softmax weights:

    loc = r + offset / (W_l, H_l)                     (fp32)
    a   = softmax over the (level, point) pairs of the logits   (fp32)
    out = sum_{l, p} a * bilinear(V_l, loc)           (fp32 accumulation)

``bilinear`` has ``grid_sample``'s semantics (align_corners False, zeros
outside). On CUDA tensors kernel K4 ``msda_sample`` (kernels/csrc/msda.cu)
computes it in one launch: the values read in their dtype where the caller
left them, softmax, locations and the sum over levels and points in
registers, the output stored once in the value's dtype; level shapes travel
as kernel arguments, so nothing is copied to the device or read back. On
CPU tensors its plain twin ``ms_deform_attn_plain`` runs: one
``grid_sample`` per level, on the level's value in fp32 laid out channels
last, then the weighting and the sum over the points. The projections
around it (value, offsets, weights, output) are the caller's.

One ``msda`` span per call (utils/tracing), and inside it one ``k4.msda``
span per K4 launch; counters ``msda.calls`` and ``msda.samples`` (queries x
heads x levels x points) on either path, ``k4.msda`` per K4 launch.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..kernels import DTYPE_CODE, check_args, launch, on_cpu, ptr, require
from ..utils.tracing import count, span

COUNTER = "k4.msda"
K4_HEAD_DIM = 32   # channels a head: a quad of lanes x 8 (csrc/msda.cu)
K4_MAX_LEVELS = 4  # one level a lane of the quad
K4_MAX_POINTS = 8
K4_MAX_PAIRS = 1 << 30  # images x queries x heads: an int in the kernel


def _launch_k4(value: torch.Tensor, offsets: torch.Tensor,
               logits: torch.Tensor, reference: torch.Tensor,
               out: torch.Tensor, levels: List[int], points: int) -> None:
    n, s, m, _ = value.shape
    launch("msda", "msda_sample", value.device, ptr(value), ptr(offsets),
           ptr(logits), ptr(reference), ptr(out), n, s, offsets.shape[1], m,
           len(levels) // 2, points, int(reference.shape[0] == n), *levels,
           *[0] * (2 * K4_MAX_LEVELS - len(levels)), DTYPE_CODE[value.dtype])


# K4's launch as the PyTorch operator ``cft::msda_sample`` (writes ``out``;
# CUDA only). A profiler links a kernel to the operator whose call launched
# it, as it links library kernels, and not to a bare ``record_function``
# range; inside an operator, K4's device time counts in the ``msda`` and
# ``k4.msda`` ranges around it. Registering builds nothing: the library is
# built at the first launch.
_LIB = torch.library.Library("cft", "FRAGMENT")
_LIB.define("msda_sample(Tensor value, Tensor offsets, Tensor logits, "
            "Tensor reference, Tensor(a!) out, int[] levels, int points) -> ()")
_LIB.impl("msda_sample", _launch_k4, "CUDA")


def ms_deform_attn(value: torch.Tensor, shapes: Sequence[Tuple[int, int]],
                   reference: torch.Tensor, offsets: torch.Tensor,
                   logits: torch.Tensor, points: int) -> torch.Tensor:
    """value (N, S, M, D) with S = sum of H_l * W_l, levels in order;
    reference (N or 1, Q, 2) as (x, y) in [0, 1], the same at every level;
    offsets (N, Q, M * L * P * 2) in pixels of each level, (x, y) last;
    logits (N, Q, M * L * P) -> (N, Q, M * D) in value's dtype. K4 on CUDA
    tensors (or ValueError for what it does not take), the plain twin on
    CPU tensors."""
    with span("msda"):
        n, q = offsets.shape[:2]
        m = value.shape[2]
        count("msda.calls")
        count("msda.samples", n * q * m * len(shapes) * points)
        if on_cpu(value, reference, offsets, logits):
            return ms_deform_attn_plain(value, shapes, reference, offsets,
                                        logits, points)
        return msda_sample(value, shapes, reference, offsets, logits, points)


def ms_deform_attn_plain(value: torch.Tensor,
                         shapes: Sequence[Tuple[int, int]],
                         reference: torch.Tensor, offsets: torch.Tensor,
                         logits: torch.Tensor, points: int) -> torch.Tensor:
    """K4's plain twin, with ``ms_deform_attn``'s arguments, on any device:
    a ``grid_sample`` per level in fp32, level shapes as Python ints."""
    n, q = offsets.shape[:2]
    m, d = value.shape[2:]
    nl = len(shapes)
    off = offsets.float().view(n, q, m, nl, points, 2)
    a = logits.float().view(n, q, m, nl * points).softmax(-1)
    a = a.view(n, q, m, nl, points)
    ref = reference.float()[:, :, None, None, :]
    out, start = None, 0
    for lid, (h, w) in enumerate(shapes):
        o = off[:, :, :, lid]
        loc = ref + torch.stack((o[..., 0] / w, o[..., 1] / h), -1)
        grid = (2 * loc - 1).transpose(1, 2).reshape(n * m, q, points, 2)
        v = value.new_empty((n, m, h * w, d), dtype=torch.float32)
        v.copy_(value[:, start:start + h * w].transpose(1, 2))
        v = v.view(n * m, h, w, d).permute(0, 3, 1, 2)
        s = F.grid_sample(v, grid, mode="bilinear", padding_mode="zeros",
                          align_corners=False)  # (N * M, D, Q, P)
        wl = a[:, :, :, lid].transpose(1, 2).reshape(n * m, 1, q, points)
        part = s.mul_(wl).sum(-1)  # (N * M, D, Q)
        out = part if out is None else out.add_(part)
        start += h * w
    return out.view(n, m * d, q).transpose(1, 2).to(value.dtype)


def check_msda(value: torch.Tensor, shapes: Sequence[Tuple[int, int]],
               reference: torch.Tensor, offsets: torch.Tensor,
               logits: torch.Tensor, points: int) -> None:
    """Raise ValueError for arguments that K4 does not take, and for inputs
    that ask for a gradient (K4 has no backward; the plain path has). The
    one place K4's arguments are checked, except for layout and device
    (``msda_sample``). Reads shapes and dtypes only, so it runs on CPU or
    meta tensors."""
    require(value.dim() == 4, f"msda_sample: value {tuple(value.shape)} must "
            "be (N, S, M, D)")
    n, s, m, d = value.shape
    nl = len(shapes)
    require(d == K4_HEAD_DIM,
            f"msda_sample: {d} channels a head, K4 takes {K4_HEAD_DIM}")
    require(1 <= nl <= K4_MAX_LEVELS,
            f"msda_sample: {nl} levels, K4 takes 1 to {K4_MAX_LEVELS}")
    require(1 <= points <= K4_MAX_POINTS,
            f"msda_sample: {points} points, K4 takes 1 to {K4_MAX_POINTS}")
    require(all(h > 0 and w > 0 for h, w in shapes)
            and sum(h * w for h, w in shapes) == s,
            f"msda_sample: level shapes {list(shapes)} do not tile {s} tokens")
    require(value.dtype in DTYPE_CODE,
            f"msda_sample: value is {value.dtype}, K4 takes bfloat16 or "
            "float32")
    require(offsets.dtype == logits.dtype == value.dtype,
            f"msda_sample: offsets {offsets.dtype} and logits {logits.dtype} "
            f"must be the value's {value.dtype}")
    require(reference.dtype == torch.float32,
            f"msda_sample: reference is {reference.dtype}, must be float32")
    require(offsets.dim() == 3 and offsets.shape[0] == n
            and offsets.shape[2] == m * nl * points * 2,
            f"msda_sample: offsets {tuple(offsets.shape)} must be "
            f"({n}, Q, {m * nl * points * 2})")
    q = offsets.shape[1]
    require(tuple(logits.shape) == (n, q, m * nl * points),
            f"msda_sample: logits {tuple(logits.shape)} must be "
            f"({n}, {q}, {m * nl * points})")
    require(reference.dim() == 3 and reference.shape[0] in (n, 1)
            and tuple(reference.shape[1:]) == (q, 2),
            f"msda_sample: reference {tuple(reference.shape)} must be "
            f"({n} or 1, {q}, 2)")
    require(n * q * m <= K4_MAX_PAIRS,
            f"msda_sample: {n * q * m} (image, query, head) triples, at most "
            f"{K4_MAX_PAIRS}")
    require(not (torch.is_grad_enabled() and any(
        t.requires_grad for t in (value, reference, offsets, logits))),
        "msda_sample: K4 has no backward; call it under torch.no_grad() or "
        "torch.inference_mode(), or on CPU tensors (the plain path)")


def msda_sample(value: torch.Tensor, shapes: Sequence[Tuple[int, int]],
                reference: torch.Tensor, offsets: torch.Tensor,
                logits: torch.Tensor, points: int) -> torch.Tensor:
    """Kernel ``msda_sample`` (kernels/csrc/msda.cu), one launch, on CUDA
    tensors with ``ms_deform_attn``'s arguments -> (N, Q, M * D) in the
    value's dtype. Nothing to sample (no image or no query): the empty
    output, no launch."""
    check_msda(value, shapes, reference, offsets, logits, points)
    check_args("msda_sample", value=value, reference=reference,
               offsets=offsets, logits=logits)
    require(not on_cpu(value, reference, offsets, logits),
            "msda_sample: K4 takes CUDA tensors; CPU tensors take "
            "ms_deform_attn_plain")
    n, s, m, d = value.shape
    q = offsets.shape[1]
    out = torch.empty((n, q, m * d), dtype=value.dtype, device=value.device)
    if out.numel() == 0:
        return out
    check_args("msda_sample", out=out)
    with span(COUNTER):
        torch.ops.cft.msda_sample.default(
            value, offsets, logits, reference, out,
            [x for h, w in shapes for x in (h, w)], points)
    count(COUNTER)
    return out
