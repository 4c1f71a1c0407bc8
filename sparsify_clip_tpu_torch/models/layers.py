"""Transformer building blocks, ported from
:mod:`sparsify_clip_tpu.models.layers`.

Conventions carried over from the JAX towers:

* LayerNorm computes in fp32 whatever the activations' type, and its
  parameters stay fp32;
* every other weight is stored in the compute type (see
  :func:`sparsify_clip_tpu_torch.models.clip.create_model`), so each
  product runs in that type;
* the attention core is the fused kernel of
  :mod:`sparsify_clip_tpu_torch.ops.attention` on CUDA and its plain
  version on the CPU;
* module and parameter names follow open_clip's ``state_dict``
  (``resblocks.N.attn.in_proj_weight``, ``mlp.c_fc`` ...).

Only the unrolled layer stack is ported: ``scan_layers``, remat, the
pipeline and the fused LN+qkv kernel are later work (ROADMAP).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from sparsify_clip_tpu_torch.ops.attention import attention_core

Activation = Callable[[torch.Tensor], torch.Tensor]


class LayerNorm(nn.Module):
    """LayerNorm computed in fp32 whatever the input's type, cast back
    to it, as the JAX towers' ``LayerNorm`` (layers.py:65-82).

    flax takes the variance as E[x²] − E[x]² (``use_fast_variance``);
    ``F.layer_norm`` takes it without that cancellation.  The two agree
    to ~1e-6 on rows with zero mean and drift apart as |mean|/std grows
    (9e-6 at 3, 1.1e-3 at 30, on unit-variance 768-wide rows in fp32):
    that gap is flax's own rounding error, measured against float64 in
    tests/test_torch_port_models.py.
    """

    def __init__(self, width: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(width))
        self.bias = nn.Parameter(torch.zeros(width))

    def reset_parameters(self) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.weight.shape, self.weight, self.bias, self.eps)
        return y.to(x.dtype)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """x · sigmoid(1.702 x), OpenAI CLIP's activation (``-quickgelu``
    registry names)."""
    return x * torch.sigmoid(1.702 * x)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU in fp32, the tanh form in bf16, as the JAX
    towers choose (models/layers.py:108-110): in bf16 the two differ
    far below bf16's own rounding step."""
    if x.dtype == torch.bfloat16:
        return F.gelu(x, approximate="tanh")
    return F.gelu(x)


def _normal_(t: torch.Tensor, std: float, gen: torch.Generator) -> None:
    nn.init.normal_(t, 0.0, std, generator=gen)


class MultiHeadAttention(nn.Module):
    """Packed in_proj → attention core → out_proj."""

    def __init__(self, width: int, heads: int, causal: bool = False):
        super().__init__()
        self.heads = heads
        self.causal = causal
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        self.out_proj = nn.Linear(width, width)

    def reset_parameters(self, gen: torch.Generator) -> None:
        std = self.out_proj.in_features ** -0.5
        _normal_(self.in_proj_weight, std, gen)
        _normal_(self.out_proj.weight, std, gen)
        nn.init.zeros_(self.in_proj_bias)
        nn.init.zeros_(self.out_proj.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
        ctx = attention_core(qkv, self.heads, self.causal)
        return self.out_proj(ctx)


class MLP(nn.Module):
    def __init__(self, width: int, hidden: int, act: Activation):
        super().__init__()
        self.act = act
        self.c_fc = nn.Linear(width, hidden)
        self.c_proj = nn.Linear(hidden, width)

    def reset_parameters(self, gen: torch.Generator) -> None:
        width = self.c_fc.in_features
        _normal_(self.c_fc.weight, (2 * width) ** -0.5, gen)
        _normal_(self.c_proj.weight, width ** -0.5, gen)
        nn.init.zeros_(self.c_fc.bias)
        nn.init.zeros_(self.c_proj.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(self.act(self.c_fc(x)))


class ResidualAttentionBlock(nn.Module):
    """Pre-LN block: x += attn(ln_1(x)); x += mlp(ln_2(x))."""

    def __init__(self, width: int, heads: int, mlp_hidden: Optional[int],
                 act: Activation, causal: bool):
        super().__init__()
        self.ln_1 = LayerNorm(width)
        self.attn = MultiHeadAttention(width, heads, causal)
        self.ln_2 = LayerNorm(width)
        self.mlp = MLP(width, mlp_hidden or 4 * width, act)

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.ln_1.reset_parameters()
        self.attn.reset_parameters(gen)
        self.ln_2.reset_parameters()
        self.mlp.reset_parameters(gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int,
                 mlp_hidden: Optional[int] = None, act: Activation = gelu_exact,
                 causal: bool = False):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, mlp_hidden, act, causal)
            for _ in range(layers)
        )

    def reset_parameters(self, gen: torch.Generator) -> None:
        for block in self.resblocks:
            block.reset_parameters(gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.resblocks:
            x = block(x)
        return x
