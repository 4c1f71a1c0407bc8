"""Wasserstein-2 uniformity metric family, ported from
:mod:`sparsify_clip_tpu.metrics.unif_w2` (reference uniformity.py:6-205;
the live eval path is the inline ``numpy_uniformity`` clone at
sparsify_clip.py:459-485).

Every variant is the closed-form W₂ between the embeddings' Gaussian
approximation N(μ, Σ) and the uniform-on-sphere surrogate N(0, I/√d):

    W₂² = ‖μ‖² + 1 + tr(Σ) − (2/√d)·tr(Σ^{1/2})

They differ in single vs concatenated modalities, the matrix square root
(SVD, or the eigenvalues of the symmetric Σ), where the epsilon goes and
the sign of the result.  Σ and its decompositions are fp32
(``torch.linalg.eigvalsh`` / ``svdvals``), with TF32 off
(:mod:`sparsify_clip_tpu_torch.utils.numerics`).
"""

from __future__ import annotations

import math

import torch

from sparsify_clip_tpu_torch.utils.numerics import fp32_matmul


def _mean_cov(x: torch.Tensor):
    x = x.float()
    mu = x.mean(0, keepdim=True)
    centered = x - mu
    return mu[0], fp32_matmul(centered.T, centered) / x.shape[0]


def _w2(mu: torch.Tensor, sigma: torch.Tensor, trace_sqrt: torch.Tensor) -> torch.Tensor:
    d = sigma.shape[0]
    return torch.sqrt(
        (mu * mu).sum() + 1.0 + sigma.diagonal().sum() - (2.0 / math.sqrt(d)) * trace_sqrt
    )


def unif_w2_single_svd(x: torch.Tensor) -> torch.Tensor:
    """Single modality, SVD square root, **+W₂** (uniformity.py:6-51)."""
    mu, sigma = _mean_cov(x)
    s = torch.linalg.svdvals(sigma)
    return _w2(mu, sigma, torch.sqrt(torch.clamp(s + 1e-8, min=0.0)).sum())


def unif_w2_joint(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Two modalities concatenated, +1e-6 on every entry of Σ, eigh
    square root, **−W₂** (uniformity.py:53-98)."""
    mu, sigma = _mean_cov(torch.cat([x, y], 0))
    sigma = sigma + 1e-6
    evals = torch.linalg.eigvalsh(sigma)
    return -_w2(mu, sigma, torch.sqrt(torch.clamp(evals + 1e-8, min=0.0)).sum())


def eval_uniformity(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The live eval metric: concatenated, eigenvalues ε-shifted and
    clipped at 0, **−W₂** (sparsify_clip.py:459-485)."""
    mu, sigma = _mean_cov(torch.cat([x, y], 0))
    evals = torch.linalg.eigvalsh(sigma)
    return -_w2(mu, sigma, torch.sqrt(torch.clamp(evals + 1e-8, min=0.0)).sum())


def unif_w2_eig_real(x: torch.Tensor) -> torch.Tensor:
    """Single modality, the real part of eig (eigh: Σ is symmetric),
    **+W₂** (uniformity.py:138-180)."""
    mu, sigma = _mean_cov(x)
    evals = torch.linalg.eigvalsh(sigma)
    return _w2(mu, sigma, torch.sqrt(torch.clamp(evals + 1e-8, min=0.0)).sum())


def unif_w2_abs_eig(x: torch.Tensor) -> torch.Tensor:
    """Single modality, |eigenvalue| square root, **+W₂**
    (uniformity.py:182-205; the reference's |Q| leaves the trace as it is)."""
    mu, sigma = _mean_cov(x)
    return _w2(mu, sigma, torch.sqrt(torch.linalg.eigvalsh(sigma).abs()).sum())
