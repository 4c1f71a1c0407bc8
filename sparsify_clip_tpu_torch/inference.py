"""Inference entry points, ported from :mod:`sparsify_clip_tpu.inference`:
a normalized-embedding encoder over a model and a retrieval index.

The raw-uint8 image path (``encode_images_u8``) waits for the port of
``ops/image.py``, and zero-shot classification for the rest of
inference (ROADMAP Queue 1, 'Rest of inference, serving and export').
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from sparsify_clip_tpu_torch.utils.numerics import fp32_matmul, l2_normalize


class CLIPEncoder:
    """Batch encoders returning (B, D) unit fp32 embeddings on the
    model's device.  Each call runs under ``torch.inference_mode()``.
    ``tokenizer`` (e.g. :func:`sparsify_clip_tpu_torch.text.get_tokenizer`'s)
    turns raw strings into token rows for :meth:`encode_texts`."""

    def __init__(self, model, tokenizer: Optional = None):
        self.model = model
        self.tokenizer = tokenizer
        self.device = model.device

    @torch.inference_mode()
    def encode_images(self, images) -> torch.Tensor:
        """(B, H, W, 3) float32 normalized pixels → (B, D) unit vectors."""
        x = torch.as_tensor(images, dtype=torch.float32).to(self.device)
        return l2_normalize(self.model.encode_image(x))

    @torch.inference_mode()
    def encode_tokens(self, tokens) -> torch.Tensor:
        """(B, context_length) int token rows → (B, D) unit vectors."""
        t = torch.as_tensor(tokens).to(self.device)
        return l2_normalize(self.model.encode_text(t))

    def encode_texts(self, texts: Sequence[str]) -> torch.Tensor:
        """Raw strings → (B, D) unit vectors, through the tokenizer."""
        if self.tokenizer is None:
            raise ValueError("pass a tokenizer to CLIPEncoder to encode raw strings")
        return self.encode_tokens(self.tokenizer(list(texts)))


class RetrievalIndex:
    """Exact dot-product retrieval over a bank of unit embeddings."""

    def __init__(self, embeddings):
        self.embeddings = torch.as_tensor(embeddings, dtype=torch.float32)

    def search(self, queries, k: int = 5) -> Tuple[np.ndarray, np.ndarray]:
        """→ (scores (Q, k), indices (Q, k)) by descending similarity."""
        q = torch.as_tensor(queries, dtype=torch.float32).to(self.embeddings.device)
        sims = fp32_matmul(q, self.embeddings.T)
        scores, idx = torch.topk(sims, min(k, self.embeddings.shape[0]), dim=-1)
        return scores.cpu().numpy(), idx.cpu().numpy()
