"""Alignment losses (Wang–Isola style), ported from
:mod:`sparsify_clip_tpu.losses.align` (reference sparsify_clip.py:178-187
and :487-505).
"""

from __future__ import annotations

import torch


def lalign_loss(x: torch.Tensor, y: torch.Tensor, alpha: float = 2.0) -> torch.Tensor:
    """``mean(||x - y||_2 ** alpha)`` (sparsify_clip.py:186-187).

    At the default α = 2 this is the mean of summed squares: the same
    value as ``norm().pow(2)``, with a defined gradient at x == y, where
    the norm's is 0/0 (PARITY.md:189).
    """
    sq = ((x.float() - y.float()) ** 2).sum(1)
    if alpha == 2.0:
        return sq.mean()
    return torch.sqrt(sq + 1e-20).pow(alpha).mean()


def random_alignment_loss(x: torch.Tensor, y: torch.Tensor,
                          generator: torch.Generator) -> torch.Tensor:
    """Alignment against randomly shuffled pairs (sparsify_clip.py:178-184).
    The permutation is drawn from ``generator`` (the JAX side takes a PRNG
    key; the two give different permutations from one seed)."""
    perm = torch.randperm(y.shape[0], generator=generator, device=generator.device)
    return lalign_loss(x, y[perm.to(y.device)], alpha=2.0)


def centroid_alignment_loss(img_embeds: torch.Tensor, txt_embeds: torch.Tensor,
                            p: int = 2) -> torch.Tensor:
    """Distance between the two modality centroids (sparsify_clip.py:487-505)."""
    diff = img_embeds.float().mean(0) - txt_embeds.float().mean(0)
    if p == 2:
        return torch.sqrt((diff * diff).sum())
    return diff.abs().pow(p).sum().pow(1.0 / p)
