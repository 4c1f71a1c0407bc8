"""Vision Transformer tower, ported from
:mod:`sparsify_clip_tpu.models.vit`.

The public input is NHWC, as on the JAX side.  The patchify is a
reshape into (B, patches, 3·P·P) rows followed by one product with the
conv weight, which is kept in open_clip's (width, 3, P, P) layout under
``conv1.weight``; no cuDNN convolution runs.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from sparsify_clip_tpu_torch.models.layers import (
    Activation, LayerNorm, Transformer, _lecun_normal_, _normal_, gelu_exact, linear,
)


class VisionTransformer(nn.Module):
    def __init__(self, image_size: int = 224, patch_size: int = 32,
                 width: int = 768, layers: int = 12, heads: int = 12,
                 mlp_hidden: Optional[int] = None, embed_dim: int = 512,
                 act: Activation = gelu_exact, dtype: torch.dtype = torch.float32,
                 fused_ln_qkv: bool = False, ln_fp32: bool = True, remat: bool = False,
                 remat_policy: Optional[str] = None,
                 **pipeline):
        super().__init__()
        self.dtype = dtype  # the compute type; weights are cast to it at use
        self.image_size = image_size
        self.patch_size = patch_size
        self.width = width
        grid = image_size // patch_size
        self.conv1 = nn.Conv2d(3, width, patch_size, stride=patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(width))
        self.positional_embedding = nn.Parameter(torch.empty(grid * grid + 1, width))
        self.ln_pre = LayerNorm(width)
        # ln_fp32 and remat reach the blocks alone, as on the JAX side
        # (ln_pre and ln_post stay fp32); ``pipeline`` is the trunk's
        # scan_layers, pipeline_stages, pipeline_microbatches and mesh
        self.transformer = Transformer(width, layers, heads, mlp_hidden, act,
                                       fused_ln_qkv=fused_ln_qkv, ln_fp32=ln_fp32, remat=remat,
                                       remat_policy=remat_policy,
                                       **pipeline)
        self.ln_post = LayerNorm(width)
        self.proj = nn.Parameter(torch.empty(width, embed_dim))

    def reset_parameters(self, gen: torch.Generator) -> None:
        _lecun_normal_(self.conv1.weight, 3 * self.patch_size ** 2, gen)  # flax nn.Conv's default
        scale = self.width ** -0.5
        for p in (self.class_embedding, self.positional_embedding, self.proj):
            _normal_(p, scale, gen)
        self.ln_pre.reset_parameters()
        self.transformer.reset_parameters(gen)
        self.ln_post.reset_parameters()

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images: (B, H, W, 3) float → (B, embed_dim) fp32, unnormalized."""
        b = images.shape[0]
        size, p = self.image_size, self.patch_size
        if tuple(images.shape[1:]) != (size, size, 3):
            raise ValueError(f"expected (B, {size}, {size}, 3) images, got {tuple(images.shape)}")
        dtype = self.dtype
        g = size // p
        x = images.to(dtype)  # cast before the patch product, as vit.py:59
        # (B, g, p, g, p, 3) → (B, g·g, 3·p·p) in the conv weight's (c, kh, kw) order
        x = x.reshape(b, g, p, g, p, 3).permute(0, 1, 3, 5, 2, 4).reshape(b, g * g, 3 * p * p)
        x = linear(x, self.conv1.weight.flatten(1))
        cls = self.class_embedding.to(dtype).expand(b, 1, self.width)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(dtype)
        x = self.ln_pre(x)
        x = self.transformer(x)
        x = self.ln_post(x[:, 0, :])
        return (x @ self.proj.to(dtype)).float()
