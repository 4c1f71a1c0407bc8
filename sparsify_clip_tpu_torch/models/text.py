"""CLIP text tower, ported from :mod:`sparsify_clip_tpu.models.text`:
gather embedding + causal transformer + ln_final + EOT pooling.

The one-hot embedding lookup (``onehot_embed``) is later work (ROADMAP).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from sparsify_clip_tpu_torch.models.layers import (
    Activation, LayerNorm, Transformer, _normal_, gelu_exact,
)


class TextTransformer(nn.Module):
    def __init__(self, vocab_size: int = 49408, context_length: int = 77,
                 width: int = 512, heads: int = 8, layers: int = 12,
                 mlp_hidden: Optional[int] = None, embed_dim: int = 512,
                 act: Activation = gelu_exact):
        super().__init__()
        self.width = width
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(torch.empty(context_length, width))
        self.transformer = Transformer(width, layers, heads, mlp_hidden, act, causal=True)
        self.ln_final = LayerNorm(width)
        self.text_projection = nn.Parameter(torch.empty(width, embed_dim))

    def reset_parameters(self, gen: torch.Generator) -> None:
        _normal_(self.token_embedding.weight, 0.02, gen)
        _normal_(self.positional_embedding, 0.01, gen)
        self.transformer.reset_parameters(gen)
        self.ln_final.reset_parameters()
        _normal_(self.text_projection, self.width ** -0.5, gen)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens: (B, T) int → (B, embed_dim) fp32, unnormalized."""
        b, l = tokens.shape
        dtype = self.text_projection.dtype
        x = self.token_embedding(tokens.long()).to(dtype)
        x = x + self.positional_embedding[:l].to(dtype)
        x = self.transformer(x)
        x = self.ln_final(x)
        # pool at the EOT token: the largest id the tokenizer emits (the
        # first one where ids tie, as jnp.argmax)
        pooled = x[torch.arange(b, device=x.device), tokens.argmax(dim=-1)]
        return (pooled @ self.text_projection.to(dtype)).float()
