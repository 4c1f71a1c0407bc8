"""Centroid helpers of the centroid-uniformity experiments, ported from
:mod:`sparsify_clip_tpu.losses.centroids` (reference
sparsify_clip.py:308-355).  Live experiments use only the paired
midpoints; the all-pairs ``compute_centroids`` is kept for parity.
"""

from __future__ import annotations

from typing import Tuple

import torch


def compute_centroids(text_embeddings: torch.Tensor,
                      visual_embeddings: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-pairs midpoints → (norms (B1, B2), centroids (B1, B2, D))
    (sparsify_clip.py:308-332)."""
    centroids = (text_embeddings.float()[:, None, :] + visual_embeddings.float()[None, :, :]) / 2.0
    return torch.linalg.vector_norm(centroids, dim=-1), centroids


def compute_centroids_only(text_embeddings: torch.Tensor,
                           visual_embeddings: torch.Tensor) -> torch.Tensor:
    """Paired midpoints ``(text + visual) / 2``, (B, D)
    (sparsify_clip.py:334-355)."""
    return (text_embeddings.float() + visual_embeddings.float()) / 2.0


def normalized_centroids(image_embeds: torch.Tensor, text_embeds: torch.Tensor) -> torch.Tensor:
    """``F.normalize((img + txt) / 2)``, the pattern of every centroid
    experiment (sparsify_clip.py:803-804): the norm clamped at 1e-12."""
    c = compute_centroids_only(image_embeds, text_embeds)
    return c / torch.clamp(torch.linalg.vector_norm(c, dim=-1, keepdim=True), min=1e-12)
