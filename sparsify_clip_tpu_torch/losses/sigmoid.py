"""SigLIP pairwise sigmoid contrastive loss, ported from
:mod:`sparsify_clip_tpu.losses.sigmoid` (a framework extension: the
reference trains softmax InfoNCE only).

    L = -(1/B) * sum_ij log sigmoid( z_ij * (s * <x_i, y_j> + b) )

with ``z_ij = +1`` on the diagonal (true pairs) and ``-1`` elsewhere,
``s`` the positive scale (the train step passes ``exp`` of a learnable
log-scale) and ``b`` a learnable bias (paper inits: ``s = 10``,
``b = -10``).

The JAX package computes this with XLA and no Pallas kernel: every pair's
term is independent, so there is no row coupling for a kernel to fuse.
This is that plain version, a (B, D) × (D, B) fp32 product and
``F.logsigmoid``, differentiated by autograd, on the CPU and on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sparsify_clip_tpu_torch.utils.numerics import fp32_matmul


def siglip_loss(image_embeds: torch.Tensor, text_embeds: torch.Tensor,
                logit_scale, logit_bias) -> torch.Tensor:
    """Pairwise sigmoid loss over the full (B, B) block: the sum over
    pairs ``j`` and the mean over anchors ``i`` (the paper's eq. 1)."""
    b = image_embeds.shape[0]
    logits = fp32_matmul(image_embeds, text_embeds.T) * logit_scale + logit_bias
    # +1 on the true-pair diagonal, -1 elsewhere, by an index comparison
    idx = torch.arange(b, device=logits.device)
    z = torch.where(idx[:, None] == idx[None, :], 1.0, -1.0)
    return -F.logsigmoid(z * logits).sum() / b
