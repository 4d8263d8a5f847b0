"""Dempster-Shafer evidence fusion of ensemble detections, on device tensors.

Counterpart of multispectral_object_detection_tpu/ops/ds_fusion.py, with
the same closed form. For frames of K singletons plus the uncertain event
Θ, Dempster's rule is

    m(i) ∝ prod_e(m_e(i) + m_e(Θ)) − prod_e m_e(Θ)
    m(Θ) ∝ prod_e m_e(Θ)

which is O(E·K) and batches over any leading axes. ``fuse_detections``
treats each ensemble member's decoded (B, N, 5+nc) output as one evidence
per anchor: mass(class i) = objectness · P(class i), mass(Θ) = 1 −
objectness.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def dempster_combine(masses: torch.Tensor, return_conflict: bool = False):
    """Combine mass functions by Dempster's rule (closed form).

    masses: (E, ..., K+1), the last slot of the final axis m(Θ). Returns
    the normalised fused (..., K+1) mass (and the conflict mass in [0, 1]
    if ``return_conflict``)."""
    theta = masses[..., -1:]                                    # (E, ..., 1)
    th = torch.prod(theta, dim=0)                               # (..., 1)
    sing = torch.prod(masses[..., :-1] + theta, dim=0) - th
    unnorm = torch.cat([sing, th], dim=-1)
    total = unnorm.sum(dim=-1, keepdim=True)                    # 1 - conflict
    fused = unnorm / total.clamp(min=_EPS)
    if return_conflict:
        return fused, 1.0 - total[..., 0]
    return fused


def discount_li(masses: torch.Tensor) -> torch.Tensor:
    """Li's compatibility pre-weighting: singleton masses (E, ..., K) ->
    (E, ..., K+1) with the discounted mass moved into Θ.

    Per hypothesis, R_ij = 2·m_i·m_j / (m_i² + m_j²) (0 where both vanish);
    evidence e's weight is W_e = (Σ_j R_ej − 1) / (E − 1)."""
    e = masses.shape[0]
    prod = masses[:, None] * masses[None, :]                    # (E, E, ..., K)
    sq = masses.square()[:, None] + masses.square()[None, :]
    r = torch.where(sq > _EPS, 2.0 * prod / sq.clamp(min=_EPS), 0.0)
    w = (r.sum(dim=1) - 1.0) / max(e - 1, 1)                    # (E, ..., K)
    new = masses * w
    return torch.cat([new, 1.0 - new.sum(dim=-1, keepdim=True)], dim=-1)


def combine_sun(masses: torch.Tensor) -> torch.Tensor:
    """Sun's credibility-discounted combination of singleton masses
    (E, ..., K) -> fused (..., K+1).

    The mean pairwise conflict ε discounts Dempster's result back toward
    the evidence mean q: fused(i) = (1−k)·DS(i) + k·ε·q(i),
    fused(Θ) = k·(1−ε), k the conflict mass."""
    e = masses.shape[0]
    tot = masses.sum(dim=-1, keepdim=True)                      # (E, ..., 1)
    km = (masses[:, None] * (tot[None, :] - masses[None, :])).sum(dim=-1)
    iu = torch.triu(torch.ones((e, e), dtype=torch.bool,
                               device=masses.device), diagonal=1)
    iu = iu.reshape((e, e) + (1,) * (km.dim() - 2))
    eps = torch.where(iu, km, 0.0).sum(dim=(0, 1)) / max(e * (e - 1) // 2, 1)
    q = masses.mean(dim=0)                                      # (..., K)
    with_theta = torch.cat([masses, torch.zeros_like(masses[..., :1])], dim=-1)
    ds, conflict = dempster_combine(with_theta, return_conflict=True)
    k = conflict[..., None]
    fused = (1.0 - k) * ds[..., :-1] + k * eps[..., None] * q
    return torch.cat([fused, k * (1.0 - eps[..., None])], dim=-1)


def fuse_detections(dets: torch.Tensor, method: str = "plain") -> torch.Tensor:
    """Fuse aligned ensemble detections (E, B, N, 5+nc) -> (B, N, 5+nc).

    method: "plain" (Dempster), "li" (compatibility pre-weighting) or
    "sun" (conflict redistribution). Box = objectness-weighted member mean,
    objectness = 1 − fused m(Θ), class probabilities = the fused singleton
    masses over the non-Θ mass."""
    obj = dets[..., 4:5]                                        # (E, B, N, 1)
    cls = dets[..., 5:]
    cls = cls / cls.sum(dim=-1, keepdim=True).clamp(min=1.0)
    sing = obj * cls                                            # (E, B, N, nc)
    if method == "plain":
        fused = dempster_combine(torch.cat([sing, 1.0 - obj], dim=-1))
    elif method == "li":
        fused = dempster_combine(discount_li(sing))
    elif method == "sun":
        fused = combine_sun(sing)
    else:
        raise ValueError(f"method must be plain|li|sun, got {method!r}")
    new_obj = 1.0 - fused[..., -1:]
    new_cls = fused[..., :-1] / new_obj.clamp(min=_EPS)
    w = obj / obj.sum(dim=0, keepdim=True).clamp(min=_EPS)
    box = (w * dets[..., :4]).sum(dim=0)
    return torch.cat([box, new_obj, new_cls], dim=-1)
