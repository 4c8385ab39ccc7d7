"""Image similarity metrics and pose geodesics for 2D/3D registration.

Counterpart of ``diffdrr_tpu/metrics.py``: global and patchwise normalized
cross-correlation and its multiscale sum, the gradient NCC (NCC of
Gaussian-blurred Sobel maps), soft-histogram mutual information, and the
SE(3) geodesic distances that registration uses to judge convergence.

Patch statistics come from separable box sums over float32 cumulative sums,
not from a convolution: cuDNN runs float32 convolutions in TF32 unless told
not to, and the downstream ``E[x^2] - mu^2`` cancellation turns lost
mantissa bits into wrong variances (the JAX package met the same fault with
bf16 on the TPU). The blur and Sobel stencils, the histograms' joint product
and the geodesics' rotation products do use convolutions and matrix
products; each of them first turns TF32 off (``pin_f32``), so every metric
here runs in true float32 on every device.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ._device import pin_f32
from .pose import RigidTransform, so3_log_map

__all__ = [
    "NormalizedCrossCorrelation2d",
    "MultiscaleNormalizedCrossCorrelation2d",
    "GradientNormalizedCrossCorrelation2d",
    "MutualInformation",
    "LogGeodesicSE3",
    "DoubleGeodesicSE3",
    "ncc2d",
    "mutual_information",
    "sobel",
    "gaussian_blur",
    "to_patches",
]


def to_patches(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """Sliding patches as channels: (B, C, H, W) -> (B, C * nH * nW, p, p),
    stride 1, the patches of each channel in row-major order (the JAX
    package's layout). A gather (``F.unfold``), so every value is exact."""
    B, C, H, W = x.shape
    p = patch_size
    nH, nW = H - p + 1, W - p + 1
    patches = F.unfold(x, p).reshape(B, C, p, p, nH, nW)
    return patches.permute(0, 1, 4, 5, 2, 3).reshape(B, C * nH * nW, p, p)


def _normalize_local(x: torch.Tensor, eps: float) -> torch.Tensor:
    mu = torch.mean(x, dim=(-1, -2), keepdim=True)
    var = torch.var(x, dim=(-1, -2), keepdim=True, unbiased=False) + eps
    return (x - mu) / torch.sqrt(var)


def _box_sum(x: torch.Tensor, p: int) -> torch.Tensor:
    """Per-channel VALID p x p box sum of (B, C, H, W) via cumulative sums."""
    cs = torch.cumsum(x, dim=2)
    x = cs[:, :, p - 1:, :] - F.pad(cs, (0, 0, 1, 0))[:, :, :-p, :]
    cs = torch.cumsum(x, dim=3)
    return cs[:, :, :, p - 1:] - F.pad(cs, (1, 0))[:, :, :, :-p]


def ncc2d(x1: torch.Tensor, x2: torch.Tensor, patch_size: Optional[int] = None,
          eps: float = 1e-5, var_floor: float = 0.0) -> torch.Tensor:
    """Normalized cross-correlation of (B, C, H, W) images, optionally patchwise.

    Patchwise, the score is the mean over all stride-1 patch centres of
    ``(E[x1 x2] - mu1 mu2) / sqrt((var1 + eps)(var2 + eps))``. Patches flat
    in both images (both variances <= eps) contribute 0 to value and
    gradient: their covariance is rounding noise amplified by 1/eps.
    ``var_floor > 0`` floors each variance at that fraction of the pair's
    mean patch variance (no gradient through the floor).
    """
    if x1.shape != x2.shape:
        raise ValueError("Input images must be the same size")
    if patch_size is not None:
        p = patch_size
        n = float(p * p)
        s1 = _box_sum(x1, p) / n
        s2 = _box_sum(x2, p) / n
        s11 = _box_sum(x1 * x1, p) / n
        s22 = _box_sum(x2 * x2, p) / n
        s12 = _box_sum(x1 * x2, p) / n
        cov = s12 - s1 * s2
        var1 = torch.clamp(s11 - s1 * s1, min=0.0)
        var2 = torch.clamp(s22 - s2 * s2, min=0.0)
        valid = (var1 > eps) | (var2 > eps)
        floor = eps
        if var_floor > 0.0:
            scale = torch.mean(var1 + var2, dim=(1, 2, 3), keepdim=True).detach()
            floor = eps + var_floor * scale
        denom = torch.sqrt((var1 + floor) * (var2 + floor))
        ncc = torch.where(valid, cov, torch.zeros_like(cov)) / denom
        return torch.mean(ncc, dim=(1, 2, 3))
    _, c, h, w = x1.shape
    x1 = _normalize_local(x1, eps)
    x2 = _normalize_local(x2, eps)
    score = torch.einsum("b...,b...->b", x1, x2)
    return score / (c * h * w)


class NormalizedCrossCorrelation2d:
    """NCC between batches of images."""

    def __init__(self, patch_size: Optional[int] = None, eps: float = 1e-5,
                 var_floor: float = 0.0):
        self.patch_size = patch_size
        self.eps = eps
        self.var_floor = var_floor

    def __call__(self, x1, x2):
        return ncc2d(x1, x2, self.patch_size, self.eps, self.var_floor)

    forward = __call__


class MultiscaleNormalizedCrossCorrelation2d:
    """Weighted sum of NCC at several patch scales."""

    def __init__(self, patch_sizes: Sequence[Optional[int]] = (None,),
                 patch_weights: Sequence[float] = (1.0,), eps: float = 1e-5,
                 var_floor: float = 0.0):
        if len(patch_sizes) != len(patch_weights):
            raise ValueError("Each scale must have a weight")
        self.patch_sizes = list(patch_sizes)
        self.patch_weights = list(patch_weights)
        self.eps = eps
        self.var_floor = var_floor

    def __call__(self, x1, x2):
        scores = [w * ncc2d(x1, x2, p, self.eps, self.var_floor)
                  for w, p in zip(self.patch_weights, self.patch_sizes)]
        return torch.sum(torch.stack(scores, dim=0), dim=0)

    forward = __call__


# -----------------------------------------------------------------------------
# Sobel gradient NCC
# -----------------------------------------------------------------------------


def _gaussian_kernel1d(kernel_size: int, sigma: float, dtype=torch.float32,
                       device=None) -> torch.Tensor:
    """torchvision's construction: a normalized Gaussian over +-(k-1)/2."""
    x = torch.linspace(-(kernel_size - 1) * 0.5, (kernel_size - 1) * 0.5, kernel_size,
                       dtype=dtype, device=device)
    pdf = torch.exp(-0.5 * (x / sigma) ** 2)
    return pdf / pdf.sum()


def gaussian_blur(img: torch.Tensor, kernel_size: int, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of (B, C, H, W) with reflect padding
    (torchvision's semantics), each channel on its own."""
    pin_f32()
    B, C, H, W = img.shape
    k = _gaussian_kernel1d(kernel_size, sigma, img.dtype, img.device)
    pad = kernel_size // 2
    x = F.pad(img.reshape(B * C, 1, H, W), (pad, pad, pad, pad), mode="reflect")
    x = F.conv2d(x, k.reshape(1, 1, -1, 1))
    x = F.conv2d(x, k.reshape(1, 1, 1, -1))
    return x.reshape(B, C, H, W)


_SOBEL = ((1.0, 0.0, -1.0), (2.0, 0.0, -2.0), (1.0, 0.0, -1.0))


def sobel(img: torch.Tensor, sigma: float = 1.0) -> torch.Tensor:
    """Gaussian-blurred Sobel X/Y gradients, (B, 1, H, W) -> (B, 2, H, W).

    The blur's kernel size is ``int(6 sigma + 1) | 1`` (none at sigma 0);
    the 3x3 stencils are zero padded by 1, as ``Conv2d(padding=1)``.
    """
    x = img
    if sigma > 0:
        x = gaussian_blur(img, int(6 * sigma + 1) | 1, sigma)
    pin_f32()
    gx = torch.tensor(_SOBEL, dtype=x.dtype, device=x.device)
    kernel = torch.stack([gx, gx.T])[:, None]  # (2, 1, 3, 3): d/dx, d/dy
    return F.conv2d(x, kernel, padding=1)


class Sobel:
    def __init__(self, sigma: float):
        self.sigma = sigma

    def __call__(self, img):
        return sobel(img, self.sigma)

    forward = __call__


class GradientNormalizedCrossCorrelation2d(NormalizedCrossCorrelation2d):
    """NCC between the Sobel gradients of two image batches, with the patch
    NCC's flat-patch gating and ``var_floor``."""

    def __init__(self, patch_size: Optional[int] = None, sigma: float = 1.0, **kwargs):
        super().__init__(patch_size, **kwargs)
        self.sobel = Sobel(sigma)

    def __call__(self, x1, x2):
        return super().__call__(self.sobel(x1), self.sobel(x2))

    forward = __call__


# -----------------------------------------------------------------------------
# Mutual information (soft histograms)
# -----------------------------------------------------------------------------


def _chunk_sums(c1: torch.Tensor, c2: torch.Tensor, bins: torch.Tensor, sigma: float):
    """Parzen marginal sums (B, bins) and joint sum (B, bins, bins) of one
    block of pixels."""
    k1 = torch.exp(-0.5 * ((c1[..., None] - bins) / sigma) ** 2)
    k2 = torch.exp(-0.5 * ((c2[..., None] - bins) / sigma) ** 2)
    return k1.sum(dim=1), k2.sum(dim=1), torch.bmm(k1.transpose(1, 2), k2)


def _histogram_sums(v1: torch.Tensor, v2: torch.Tensor, bins: torch.Tensor, sigma: float,
                    chunk: int = 16384):
    """Unnormalized Parzen sums ``sum_n K(v1_n - b_i)``, ``sum_n K(v2_n - b_j)``
    and ``sum_n K(v1_n - b_i) K(v2_n - b_j)`` of (B, N) pixel values.

    Above ``chunk`` pixels they stream in blocks of ``chunk``, each under
    ``torch.utils.checkpoint``: the backward recomputes a block's kernel
    values instead of keeping them, so neither pass holds (B, N, bins).
    """
    pin_f32()
    N = v1.shape[1]
    if N <= chunk:
        return _chunk_sums(v1, v2, bins, sigma)
    s1 = s2 = j12 = 0.0
    for i in range(0, N, chunk):
        a, b, c = checkpoint(_chunk_sums, v1[:, i:i + chunk], v2[:, i:i + chunk], bins, sigma,
                             use_reentrant=False)
        s1, s2, j12 = s1 + a, s2 + b, j12 + c
    return s1, s2, j12


def mutual_information(x1: torch.Tensor, x2: torch.Tensor, sigma: float = 0.1,
                       num_bins: int = 256, epsilon: float = 1e-10,
                       normalize: bool = True) -> torch.Tensor:
    """(Normalized) mutual information of (B, C, H, W) images on [0, 1], per
    image: each channel is scored on its own (channels fold into the batch)
    and the channels' scores are averaged."""
    if x1.shape != x2.shape:
        raise ValueError("Input images must be the same size")
    B, C, H, W = x1.shape
    bins = torch.linspace(0.0, 1.0, num_bins, dtype=x1.dtype, device=x1.device)
    s1, s2, j12 = _histogram_sums(x1.reshape(B * C, H * W), x2.reshape(B * C, H * W), bins,
                                  sigma)
    N = H * W
    pdf1 = s1 / N
    pdf1 = pdf1 / (torch.sum(pdf1, dim=1, keepdim=True) + epsilon)
    pdf2 = s2 / N
    pdf2 = pdf2 / (torch.sum(pdf2, dim=1, keepdim=True) + epsilon)
    pdf12 = j12 / (torch.sum(j12, dim=(1, 2), keepdim=True) + epsilon)

    H1 = -torch.sum(pdf1 * torch.log2(pdf1 + epsilon), dim=1)
    H2 = -torch.sum(pdf2 * torch.log2(pdf2 + epsilon), dim=1)
    H12 = -torch.sum(pdf12 * torch.log2(pdf12 + epsilon), dim=(1, 2))

    mi = H1 + H2 - H12
    if normalize:
        mi = 2 * mi / (H1 + H2)
    return torch.mean(mi.reshape(B, C), dim=1)


class MutualInformation:
    """Mutual information of soft (Parzen) histograms."""

    def __init__(self, sigma=0.1, num_bins=256, epsilon=1e-10, normalize=True):
        self.sigma = sigma
        self.num_bins = num_bins
        self.epsilon = epsilon
        self.normalize = normalize

    def __call__(self, x1, x2):
        return mutual_information(x1, x2, self.sigma, self.num_bins, self.epsilon,
                                  self.normalize)

    forward = __call__


# -----------------------------------------------------------------------------
# SE(3) geodesics
# -----------------------------------------------------------------------------


class LogGeodesicSE3:
    """Distance in the log-space of SE(3): ``|log(pose_1^-1 pose_2)|``."""

    def __call__(self, pose_1: RigidTransform, pose_2: RigidTransform) -> torch.Tensor:
        pin_f32()
        rel = pose_2.compose(pose_1.inverse())
        return torch.linalg.vector_norm(rel.get_se3_log(), dim=1)

    forward = __call__


class DoubleGeodesicSE3:
    """Angular and translational geodesics, and their combination.

    Returns ``(rot, xyz, double)``: the rotation angle scaled by sdd / 2 (a
    length at the isocenter), the distance between the two camera centres,
    and ``sqrt(rot^2 + xyz^2 + eps)``, each (B,).
    """

    def __init__(self, sdd: float, eps: float = 1e-6):
        self.sdr = sdd / 2
        self.eps = eps

    def __call__(self, pose_1: RigidTransform, pose_2: RigidTransform):
        pin_f32()
        r1, t1 = pose_1.convert("matrix")
        r2, t2 = pose_2.convert("matrix")
        rot = self.sdr * torch.linalg.vector_norm(
            so3_log_map(torch.einsum("...ji,...jk->...ik", r1, r2)), dim=-1)
        xyz = torch.linalg.vector_norm(t1 - t2, dim=-1)
        dou = torch.sqrt(rot ** 2 + xyz ** 2 + self.eps)
        return rot, xyz, dou

    forward = __call__
