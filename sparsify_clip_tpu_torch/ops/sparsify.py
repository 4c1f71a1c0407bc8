"""Sparse embedding projections (top-k / L1 shrinkage), ported from
:mod:`sparsify_clip_tpu.ops.sparsify`.

The capability this system is named for: once ``epoch >=
sparse_after_epoch`` the train step projects both l2-normalised
embeddings inside the loss (``sparse_projection: topk | l1``).  Both
projections renormalise back onto the unit sphere, so every loss keeps
its unit-norm contract.  Evaluation sees the unprojected embeddings, as
on the JAX side.

Plain PyTorch: the JAX side is XLA (``lax.top_k`` and elementwise work),
no ``pallas_call``.  Arithmetic as there: fp32, the norm as
``sqrt(Σ x²)`` floored at 1e-12.  A row with nothing left (every
component of an ``l1`` row under λ) projects to zeros with a zero
gradient here; the JAX function's gradient there is NaN (``sqrt``'s
derivative at 0 times ``jnp.maximum``'s zero mask), which
``torch.clamp``'s masked backward does not produce.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def _renormalize(x: torch.Tensor) -> torch.Tensor:
    norm = torch.sqrt((x * x).sum(-1, keepdim=True))
    return x / torch.clamp(norm, min=1e-12)


def topk_project(x: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the components with ``|x| >=`` each row's k-th largest
    ``|x|``, renormalise.  Ties at the k-th value keep more than k
    components, as the JAX mask does (``absx >= kth``): the mask comes
    from ``torch.topk``'s k-th value, not from scattering its indices,
    which would keep exactly k.  The mask is a constant; the gradient
    flows through the kept components and the norm."""
    xf = x.float()
    absx = xf.abs()
    kth = torch.topk(absx, k, dim=-1).values[..., -1:]
    return _renormalize(xf * (absx >= kth).to(torch.float32))


def l1_shrink(x: torch.Tensor, lam: float) -> torch.Tensor:
    """Soft-thresholding (the proximal L1 step), then renormalise:
    ``sign(x)·max(|x| − λ, 0) / ‖·‖``."""
    xf = x.float()
    return _renormalize(torch.sign(xf) * torch.clamp(xf.abs() - lam, min=0.0))


def make_projection(kind: str, topk: int = 64,
                    l1: float = 0.01) -> Optional[Callable[[torch.Tensor], torch.Tensor]]:
    """kind ∈ {"none", "topk", "l1"} → fn(embeddings) or None."""
    if kind == "none":
        return None
    if kind == "topk":
        return lambda x: topk_project(x, topk)
    if kind == "l1":
        return lambda x: l1_shrink(x, l1)
    raise ValueError(f"unknown sparse projection {kind!r} (none|topk|l1)")
