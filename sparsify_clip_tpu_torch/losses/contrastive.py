"""Contrastive (InfoNCE / "anchor") losses, ported from
:mod:`sparsify_clip_tpu.losses.contrastive`.

Reference semantics: sparsify_clip.py:110-157.  ``temperature`` is the
raw divisor of the similarity matrix, not a logit scale, and when
learnable it is an unconstrained parameter initialised at 0.1.

This is the plain version, differentiated by autograd: the numerics
golden of the fused kernel (:mod:`sparsify_clip_tpu_torch.ops.infonce`)
and the loss of the plain comparison step of ``chip_smoke.py``.  The
soft-target variant (``contrastive_loss_roberta``, the ``anchor-roberta``
loss) is plain PyTorch on the card too, as the JAX side computes it with
XLA under every ``use_pallas``.
"""

from __future__ import annotations

import torch

from sparsify_clip_tpu_torch.utils.numerics import fp32_matmul


def contrastive_loss(
    image_embeds: torch.Tensor, text_embeds: torch.Tensor, temperature=0.07
) -> torch.Tensor:
    """Symmetric InfoNCE with diagonal targets: the mean of image→text and
    text→image cross-entropy over ``img·txtᵀ / temperature``."""
    logits = fp32_matmul(image_embeds, text_embeds.T) / temperature
    diag = logits.diagonal()
    loss_i2t = (torch.logsumexp(logits, dim=1) - diag).mean()
    loss_t2i = (torch.logsumexp(logits, dim=0) - diag).mean()
    return (loss_i2t + loss_t2i) / 2.0


def contrastive_loss_roberta(
    image_embeds: torch.Tensor, text_embeds: torch.Tensor, soft_targets: torch.Tensor,
    temperature=0.07,
) -> torch.Tensor:
    """Cross-entropy against a (B, B) row-stochastic soft-target matrix
    (sparsify_clip.py:135-157), symmetric: ``F.cross_entropy`` with
    probability targets, the mean over rows of ``-sum(target *
    log_softmax(logits))``, over ``logits`` and over ``logits.T`` against
    ``soft_targets.T``."""
    soft_targets = soft_targets.float()
    logits = fp32_matmul(image_embeds, text_embeds.T) / temperature

    def ce_soft(lg, tg):
        logp = lg - torch.logsumexp(lg, dim=1, keepdim=True)
        return -(tg * logp).sum(dim=1).mean()

    return (ce_soft(logits, soft_targets) + ce_soft(logits.T, soft_targets.T)) / 2.0
