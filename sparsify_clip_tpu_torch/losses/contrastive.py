"""Contrastive (InfoNCE / "anchor") loss, ported from
:mod:`sparsify_clip_tpu.losses.contrastive`.

Reference semantics: sparsify_clip.py:110-132.  ``temperature`` is the
raw divisor of the similarity matrix, not a logit scale, and when
learnable it is an unconstrained parameter initialised at 0.1.

This is the plain version, differentiated by autograd: the numerics
golden of the fused kernel (:mod:`sparsify_clip_tpu_torch.ops.infonce`)
and the loss of the plain comparison step of ``chip_smoke.py``.  The soft-target
variant (``contrastive_loss_roberta``) waits for ROADMAP Queue 1,
'Rest of the losses, and the step knobs'.
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
