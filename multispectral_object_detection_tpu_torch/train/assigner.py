"""Anchor-target assignment with fixed shapes.

Counterpart of multispectral_object_detection_tpu/train/assigner.py. The
reference ``build_targets`` filters candidates with boolean indexing, whose
shapes depend on the data; here every scale keeps ALL 5 x na x T candidates
(5 cell offsets, na anchors, T padded targets) with a validity mask:

- anchor match: max(wh / anchor, anchor / wh) < anchor_t;
- neighbour cells: the centre cell and up to 2 of its 4 neighbours whose
  fractional centre coordinate lies within g = 0.5 of that side;
- cells are clamped into the grid before the regression offset ``txy``.

No step reads a value back to the host or copies one to the device (the
caller passes the anchors and offsets as device tensors), so the loss
that consumes the candidates (one gather and one scatter-max per scale)
never waits on the device. Invalid candidates point at index 0 so gathers
stay in bounds.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

# centre, right, down, left, up (times g = 0.5)
OFFSETS = np.array([[0, 0], [1, 0], [0, 1], [-1, 0], [0, -1]],
                   dtype=np.float32) * 0.5


class ScaleAssignment(NamedTuple):
    """Flat candidate set of one scale; every tensor has K = 5*na*T rows."""

    b: torch.Tensor     # image index (int64)
    a: torch.Tensor     # anchor index
    gj: torch.Tensor    # grid row
    gi: torch.Tensor    # grid column
    txy: torch.Tensor   # (K, 2) target centre within its cell
    twh: torch.Tensor   # (K, 2) target size in grid units
    cls: torch.Tensor   # (K,) class id
    mask: torch.Tensor  # (K,) validity, float32 0/1


def assign_targets(targets: torch.Tensor, tmask: torch.Tensor,
                   feat_shapes: Sequence[Tuple[int, int]],
                   anchors_grid, anchor_t: float = 4.0,
                   offsets=OFFSETS) -> Tuple[ScaleAssignment, ...]:
    """targets (T, 6) [img, cls, x, y, w, h] normalised, tmask (T,);
    feat_shapes: (ny, nx) per scale; anchors_grid (nl, na, 2) in grid
    units and ``offsets`` (5, 2), arrays or (to copy nothing) float32
    tensors on the targets' device."""
    dev = targets.device
    t6 = targets.float()
    valid_t = tmask.float() > 0
    T = t6.shape[0]
    na = anchors_grid.shape[1]
    off = torch.as_tensor(offsets, device=dev)
    anchors = torch.as_tensor(anchors_grid, dtype=torch.float32, device=dev)
    g = 0.5
    out = []
    for si, (ny, nx) in enumerate(feat_shapes):
        t = torch.cat([t6[:, :2], t6[:, 2:3] * nx, t6[:, 3:4] * ny,
                       t6[:, 4:5] * nx, t6[:, 5:6] * ny], 1)  # grid units
        anc = anchors[si]                                        # (na, 2)
        r = t[None, :, 4:6] / anc[:, None, :]                    # (na, T, 2)
        ratio_ok = torch.maximum(r, 1.0 / r).amax(-1) < anchor_t  # (na, T)

        gxy = t[:, 2:4]
        gxi = torch.stack([nx - gxy[:, 0], ny - gxy[:, 1]], -1)
        jk = (torch.remainder(gxy, 1.0) < g) & (gxy > 1.0)       # right/down
        lm = (torch.remainder(gxi, 1.0) < g) & (gxi > 1.0)       # left/up
        offset_ok = torch.stack([torch.ones_like(jk[:, 0]), jk[:, 0],
                                 jk[:, 1], lm[:, 0], lm[:, 1]])  # (5, T)
        cand = (offset_ok[:, None, :] & ratio_ok[None]
                & valid_t[None, None, :])                        # (5, na, T)

        gij = torch.floor(gxy[None] - off[:, None, :])           # (5, T, 2)
        gi = gij[..., 0].clamp(0, nx - 1)
        gj = gij[..., 1].clamp(0, ny - 1)
        # the regression offset is taken from the clamped cell
        txy = gxy[None] - torch.stack([gi, gj], -1)              # (5, T, 2)
        twh = t[:, 4:6]
        K = 5 * na * T
        shape = (5, na, T)
        mc = cand.reshape(K).float()
        keep = mc > 0
        zero = torch.zeros((), dtype=torch.int64, device=dev)

        def flat(v):
            return torch.where(keep, v.expand(shape).reshape(K).long(), zero)

        out.append(ScaleAssignment(
            b=flat(t[:, 0][None, None]),
            a=flat(torch.arange(na, device=dev)[None, :, None]),
            gj=flat(gj[:, None, :]),
            gi=flat(gi[:, None, :]),
            txy=txy[:, None].expand(5, na, T, 2).reshape(K, 2),
            twh=twh[None, None].expand(5, na, T, 2).reshape(K, 2),
            cls=flat(t[:, 1][None, None]),
            mask=mc))
    return tuple(out)
