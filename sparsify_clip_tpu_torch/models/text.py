"""CLIP text tower, ported from :mod:`sparsify_clip_tpu.models.text`:
token embedding + causal transformer + ln_final + EOT pooling.

The embedding is a gather, or with ``onehot_embed`` the JAX side's
one-hot product (text.py:66-73): the (B·L, V) one-hot rows in the
tower's type times the table cast to it.  A one-hot row picks the
table's rounded entry, so the forward equals the gather's; the fp32
table's gradient is the product's transpose in the tower's type, rounded
there before the cast back, as on the JAX side (the gather's
``index_add`` sums in fp32).  The product is cuBLAS's, as the JAX side's
is XLA's: no ``pallas_call``.
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
                 act: Activation = gelu_exact, dtype: torch.dtype = torch.float32,
                 fused_ln_qkv: bool = False, ln_fp32: bool = True, remat: bool = False,
                 remat_policy: Optional[str] = None, onehot_embed: bool = False,
                 **pipeline):
        super().__init__()
        self.dtype = dtype  # the compute type; weights are cast to it at use
        self.width = width
        self.onehot_embed = onehot_embed
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(torch.empty(context_length, width))
        # ``pipeline``: the trunk's scan_layers, pipeline_stages,
        # pipeline_microbatches and mesh (Transformer)
        self.transformer = Transformer(width, layers, heads, mlp_hidden, act, causal=True,
                                       fused_ln_qkv=fused_ln_qkv, ln_fp32=ln_fp32, remat=remat,
                                       remat_policy=remat_policy,
                                       **pipeline)
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
        dtype = self.dtype
        if self.onehot_embed:
            table = self.token_embedding.weight
            flat = tokens.reshape(-1, 1).long()
            # zeros + scatter, not F.one_hot: its int64 rows would be 4× the
            # operand (7.8 GB at B·L = 19712, V = 49408)
            onehot = torch.zeros(flat.shape[0], table.shape[0], dtype=dtype,
                                 device=tokens.device).scatter_(1, flat, 1.0)
            x = (onehot @ table.to(dtype)).view(b, l, self.width)
        else:
            x = self.token_embedding(tokens.long()).to(dtype)
        x = x + self.positional_embedding[:l].to(dtype)
        x = self.transformer(x)
        x = self.ln_final(x)
        # pool at the EOT token: the largest id the tokenizer emits (the
        # first one where ids tie, as jnp.argmax)
        pooled = x[torch.arange(b, device=x.device), tokens.argmax(dim=-1)]
        return (pooled @ self.text_projection.to(dtype)).float()
