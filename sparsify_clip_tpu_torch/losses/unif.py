"""Uniformity losses over pairwise distances, ported from
:mod:`sparsify_clip_tpu.losses.unif` (reference sparsify_clip.py:159-176).

``lunif_loss`` is the Wang–Isola uniformity potential
``log(mean(exp(-t * pdist(x)^2)))`` over the N(N−1)/2 unordered pairs,
self-pairs excluded.  It is computed from the Gram matrix,
d²(i,j) = ‖xᵢ‖² + ‖xⱼ‖² − 2·Gᵢⱼ clipped at 0, with the diagonal masked
**before** the sum (subtracting N afterwards would cancel
catastrophically when the off-diagonal terms are tiny); each unordered
pair appears twice, so the mean over N·(N−1) ordered pairs is the same.

These are the plain versions, differentiated by autograd: the numerics
golden of the fused kernels (:mod:`sparsify_clip_tpu_torch.ops.lunif`,
which the loss dispatch calls) and the loss of the plain comparison step
of ``chip_smoke.py``.
"""

from __future__ import annotations

import torch

from sparsify_clip_tpu_torch.utils.numerics import fp32_matmul


def pairwise_sq_dists(x: torch.Tensor) -> torch.Tensor:
    """Full (N, N) matrix of squared Euclidean distances, fp32."""
    x = x.float()
    sq_norms = (x * x).sum(1)
    d2 = sq_norms[:, None] + sq_norms[None, :] - 2.0 * fp32_matmul(x, x.T)
    return torch.clamp(d2, min=0.0)


def lunif_loss(x: torch.Tensor, t: float = 2.0) -> torch.Tensor:
    """log-mean-exp of −t·d² over the distinct pairs (sparsify_clip.py:159-164)."""
    n = x.shape[0]
    kernel = torch.exp(-t * pairwise_sq_dists(x))
    off_diag = kernel * (1.0 - torch.eye(n, dtype=kernel.dtype, device=kernel.device))
    return torch.log(off_diag.sum() / (n * (n - 1)))


def sparsify_loss(x: torch.Tensor) -> torch.Tensor:
    """MSE between the Gram matrix and a ±1 "eye" target
    (sparsify_clip.py:166-176; no live experiment calls it)."""
    cos_sim = fp32_matmul(x, x.T)
    n = cos_sim.shape[0]
    target = 2.0 * torch.eye(n, dtype=torch.float32, device=cos_sim.device) - 1.0
    return ((cos_sim - target) ** 2).mean()
