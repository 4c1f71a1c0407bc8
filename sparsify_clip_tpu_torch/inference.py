"""Inference entry points, ported from :mod:`sparsify_clip_tpu.inference`:
a normalized-embedding encoder over a model (normalized fp32 pixels, raw
uint8 pixels or token rows), a retrieval index, and prompt-ensemble
zero-shot classification.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from sparsify_clip_tpu_torch.ops.image import eval_resize_batch
from sparsify_clip_tpu_torch.utils.numerics import fp32_matmul, l2_normalize


class CLIPEncoder:
    """Batch encoders returning (B, D) unit fp32 embeddings on the
    model's device.  Each call runs under ``torch.inference_mode()``, in
    eval mode: a model in train mode is encoded through its eval twin
    (``with_dtype``, the same parameters and buffers), so a ResNet tower
    normalizes by its running statistics, as the JAX encoder's
    ``train=False``.  ``tokenizer`` (e.g.
    :func:`sparsify_clip_tpu_torch.text.get_tokenizer`'s) turns raw strings
    into token rows for :meth:`encode_texts`."""

    def __init__(self, model, tokenizer: Optional = None):
        self.model = model.with_dtype(model.dtype).eval() if model.training else model
        self.tokenizer = tokenizer
        self.device = model.device

    @torch.inference_mode()
    def encode_images(self, images) -> torch.Tensor:
        """(B, H, W, 3) float32 normalized pixels → (B, D) unit vectors."""
        x = torch.as_tensor(images, dtype=torch.float32).to(self.device)
        return l2_normalize(self.model.encode_image(x))

    @torch.inference_mode()
    def encode_images_u8(self, images_u8) -> torch.Tensor:
        """(B, H, W, 3) uint8 raw pixels → (B, D) unit vectors.  The cast,
        the squash-resize of an axis that differs from the tower's input
        size (:func:`~sparsify_clip_tpu_torch.ops.image.eval_resize_batch`,
        the eval path's Resize) and the CLIP normalization run on the
        model's device: a client ships a quarter of fp32's bytes."""
        x = torch.as_tensor(images_u8).to(self.device)
        return l2_normalize(self.model.encode_image(
            eval_resize_batch(x, self.model.cfg.image_size)))

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


# The 7-template subset commonly used for quick CLIP zero-shot evals (a
# copy of the JAX package's, inference.py:91-99).
DEFAULT_TEMPLATES = (
    "a photo of a {}.",
    "a bad photo of a {}.",
    "a photo of many {}.",
    "a photo of the large {}.",
    "a photo of the small {}.",
    "art of the {}.",
    "a photo of a {} in a video game.",
)


def build_zero_shot_classifier(encoder: CLIPEncoder, class_names: Sequence[str],
                               templates: Sequence[str] = DEFAULT_TEMPLATES) -> torch.Tensor:
    """(num_classes, D) fp32 classifier: per class, the renormalized mean of
    its prompt-ensemble text embeddings (the standard CLIP recipe).  Every
    prompt goes through one encode."""
    prompts = [t.format(name) for name in class_names for t in templates]
    emb = encoder.encode_texts(prompts).view(len(class_names), len(templates), -1)
    return l2_normalize(emb.mean(dim=1))


def zero_shot_classify(encoder: CLIPEncoder, images, classifier: torch.Tensor,
                       temperature: float = 0.01) -> Dict[str, np.ndarray]:
    """→ {"probs": (B, C), "predictions": (B,)} over the classifier, for
    (B, H, W, 3) float32 normalized pixels."""
    img = encoder.encode_images(images)
    logits = fp32_matmul(img, classifier.to(img.device).T) / temperature
    return {
        "probs": torch.softmax(logits, dim=-1).cpu().numpy(),
        "predictions": logits.argmax(dim=-1).cpu().numpy(),
    }
