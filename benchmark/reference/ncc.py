"""Normalized cross-correlation, global and over 13 x 13 patches, and their
weighted sum (upstream DiffDRR's multiscale NCC, ``[None, 13]``, ``[0.5, 0.5]``).

Patch means are average pools; a patch flat in both images (both variances
at most ``eps``) scores 0.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F


def ncc(x1: torch.Tensor, x2: torch.Tensor, patch: Optional[int] = None,
        eps: float = 1e-5) -> torch.Tensor:
    """NCC of ``(B, C, H, W)`` images, ``(B,)``."""
    if patch is None:
        def normal(x):
            mu = x.mean(dim=(-1, -2), keepdim=True)
            var = ((x - mu) ** 2).mean(dim=(-1, -2), keepdim=True)
            return (x - mu) / torch.sqrt(var + eps)
        return (normal(x1) * normal(x2)).flatten(1).mean(dim=1)
    m1, m2 = F.avg_pool2d(x1, patch, stride=1), F.avg_pool2d(x2, patch, stride=1)
    cov = F.avg_pool2d(x1 * x2, patch, stride=1) - m1 * m2
    var1 = (F.avg_pool2d(x1 * x1, patch, stride=1) - m1 * m1).clamp_min(0.0)
    var2 = (F.avg_pool2d(x2 * x2, patch, stride=1) - m2 * m2).clamp_min(0.0)
    valid = (var1 > eps) | (var2 > eps)
    score = torch.where(valid, cov, torch.zeros_like(cov)) / torch.sqrt((var1 + eps) * (var2 + eps))
    return score.flatten(1).mean(dim=1)


def multiscale_ncc(x1, x2, patches: Sequence[Optional[int]] = (None, 13),
                   weights: Sequence[float] = (0.5, 0.5)) -> torch.Tensor:
    return sum(w * ncc(x1, x2, p) for p, w in zip(patches, weights))
