"""Transformer building blocks, ported from
:mod:`sparsify_clip_tpu.models.layers`.

Conventions carried over from the JAX towers:

* LayerNorm computes in fp32 whatever the activations' type, and its
  parameters stay fp32;
* every other weight is cast to the activations' type where it is used
  (:func:`linear`), as flax casts its fp32 parameters at each use: a
  training model keeps fp32 parameters and computes in bf16, and a
  serving model stores its weights in the compute type once (see
  :func:`sparsify_clip_tpu_torch.models.clip.create_model`), where the
  cast is a no-op;
* the attention core is the fused kernel of
  :mod:`sparsify_clip_tpu_torch.ops.attention` on CUDA and its plain
  version on the CPU, with its own backward when a gradient is wanted;
* with ``fused_ln_qkv`` a block runs ``ln_1`` and the packed in_proj as
  one kernel (:func:`sparsify_clip_tpu_torch.ops.ln_qkv.ln_qkv_core`,
  the JAX block's ``ln_qkv_core`` route, layers.py:206-215) over the same
  parameters, so the ``state_dict`` is the unfused block's;
* ``remat`` runs each block under ``torch.utils.checkpoint``
  (non-reentrant) when a gradient is taken: the backward recomputes the
  block's forward, kernels included, from its saved input; a
  ``remat_policy`` keeps chosen intermediates (:func:`resolve_remat_policy`);
* under tensor parallelism (:mod:`sparsify_clip_tpu_torch.parallel.tensor`,
  a module's ``tp`` mesh) the attention keeps its model rank's heads and
  the MLP its block of hidden units; the split products take Megatron's
  f before and g after them, and the attention route is the one of the
  whole width;
* ``ln_fp32: false`` is flax's ``nn.LayerNorm(dtype=x.dtype)`` in the
  blocks (:class:`LayerNorm`), and such a block takes the unfused route
  even with ``fused_ln_qkv`` (the JAX condition ``fused_ln_qkv and
  ln_fp32``, layers.py:206);
* module and parameter names follow open_clip's ``state_dict``
  (``resblocks.N.attn.in_proj_weight``, ``mlp.c_fc`` ...).

The layer stack is the unrolled one.  ``scan_layers`` is a compile-time
lever of XLA (ROADMAP Queue 1, 'Do not port'): here it names the JAX
stacked layout that the weight files take
(:mod:`sparsify_clip_tpu_torch.checkpoints`), and a pipelined trunk
needs it, as on the JAX side.  With ``pipeline_stages`` S > 1 a trunk is
one stage of a GPipe pipeline over its mesh's model axis
(:mod:`sparsify_clip_tpu_torch.parallel.pipeline`): model rank ``s``
holds blocks ``[s·L/S, (s+1)·L/S)`` alone, under their global names
(``resblocks.{s·L/S}`` ...), and builds them without ``fused_ln_qkv``, as
the JAX stage body does (layers.py:354-358): a pipelined trunk takes the
unfused LN + qkv route whatever the knob.
"""

from __future__ import annotations

import functools
from typing import Callable, FrozenSet, Optional

import torch
import torch.nn.functional as F
from torch import nn

from sparsify_clip_tpu_torch.ops.attention import attention_core
from sparsify_clip_tpu_torch.ops.ln_qkv import ln_qkv_core
from sparsify_clip_tpu_torch.parallel.tensor import copy_to_model, reduce_from_model

Activation = Callable[[torch.Tensor], torch.Tensor]


# The block's attention output (after out_proj), tagged for the "attn_out"
# policy as the JAX block tags it with checkpoint_name (layers.py:218-220).
# A custom op may not return its input, so the tag is a copy, and the block
# calls it only under that policy.
@torch.library.custom_op("sparsify_clip::attn_out", mutates_args=(),
                         device_types=("cpu", "cuda"))
def attn_out(x: torch.Tensor) -> torch.Tensor:
    return x.clone()


@attn_out.register_fake
def _(x):
    return torch.empty_like(x)


attn_out.register_autograd(lambda ctx, grad: grad)

_aten = torch.ops.aten
# What each selective policy saves, as the aten ops whose outputs the
# checkpoint keeps; everything else is recomputed.  The hand-written
# kernels are no aten op, so every policy recomputes them (attention, the
# fused LN+qkv), as JAX's dots policies recompute a pallas_call, which is
# no dot_general.  "dots" keeps each block's four projections (in_proj,
# out_proj, c_fc, c_proj: 9 W a token) and any batched product (the plain
# attention's on the CPU, the folded convs' moments in a ResNet);
# "dots_no_batch" only the products without batch dims; "attn_out" the
# tagged attention output (W a token) beside the block's input.
_REMAT_POLICIES = {
    "dots": frozenset({_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
                       _aten.baddbmm.default}),
    "dots_no_batch": frozenset({_aten.mm.default, _aten.addmm.default}),
    "attn_out": frozenset({torch.ops.sparsify_clip.attn_out.default}),
}


def resolve_remat_policy(name: Optional[str]) -> Optional[FrozenSet]:
    """A config string → the ops a checkpointed block keeps (the JAX
    ``resolve_remat_policy``, layers.py:34-61): ``None`` for
    ``"nothing"``/``"full"``/None (save the block's input alone, recompute
    the whole block); ``"dots"``, ``"dots_no_batch"`` and ``"attn_out"`` as
    above.  Policies change what the backward recomputes, never the math."""
    if name in (None, "nothing", "full"):
        return None
    if name not in _REMAT_POLICIES:
        raise ValueError(
            f"Unknown remat_policy {name!r}; choose from "
            f"{['nothing', *_REMAT_POLICIES]}"
        )
    return _REMAT_POLICIES[name]


def remat(fn: Callable, policy: Optional[FrozenSet], *args):
    """``fn(*args)`` under a non-reentrant ``torch.utils.checkpoint``
    (``jax.checkpoint``): the forward keeps ``args`` and, under a
    selective ``policy``, the outputs of its ops; the backward recomputes
    the rest.  The blocks draw no random numbers, so no RNG state is kept."""
    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

    context_fn = {} if policy is None else {"context_fn": functools.partial(
        create_selective_checkpoint_contexts, sorted(policy, key=str))}
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False, **context_fn)


class LayerNorm(nn.Module):
    """LayerNorm computed in fp32 whatever the input's type, cast back
    to it, as the JAX towers' ``LayerNorm`` (layers.py:65-82).

    flax takes the variance as E[x²] − E[x]² (``use_fast_variance``);
    ``F.layer_norm`` takes it without that cancellation.  The two agree
    to ~1e-6 on rows with zero mean and drift apart as |mean|/std grows
    (9e-6 at 3, 1.1e-3 at 30, on unit-variance 768-wide rows in fp32):
    that gap is flax's own rounding error, measured against float64 in
    tests/test_torch_port_models.py.

    ``fp32=False`` is the JAX ``LayerNorm(fp32=False)``, flax 0.12.3's
    ``nn.LayerNorm(dtype=x.dtype)``: ``_compute_stats`` promotes x to fp32
    for the mean and the fast variance (clipped at 0), and ``_normalize``
    takes ``x − mean`` in fp32 (bf16 minus fp32 promotes), multiplies by
    ``rsqrt(var + eps)·scale`` and adds the bias in fp32, then rounds once
    to x's type.  So it is this module's fp32 function with flax's
    variance, as plain elementwise work.
    """

    def __init__(self, width: int, eps: float = 1e-5, fp32: bool = True):
        super().__init__()
        self.eps = eps
        self.fp32 = fp32
        self.weight = nn.Parameter(torch.ones(width))
        self.bias = nn.Parameter(torch.zeros(width))

    def reset_parameters(self) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.fp32:
            x32 = x.float()
            mean = x32.mean(-1, keepdim=True)
            var = torch.clamp((x32 * x32).mean(-1, keepdim=True) - mean * mean, min=0.0)
            y = (x32 - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
            return y.to(x.dtype)
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


def _lecun_normal_(t: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """flax's ``lecun_normal`` (the default of ``nn.Conv`` and ``nn.Dense``):
    a normal truncated at ±2σ whose variance is 1/fan_in, σ rescaled by the
    truncation's standard deviation, 0.87962566103423978."""
    std = fan_in ** -0.5 / 0.87962566103423978
    nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=gen)


def linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``F.linear`` with the weight (and bias) cast to the activations'
    type at use; the cast's backward hands fp32 parameters an fp32
    gradient."""
    return F.linear(x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype))


def row_linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
               tp) -> torch.Tensor:
    """:func:`linear` of a row-parallel weight over the ``tp`` mesh's model
    axis: the partial products summed over the model group, then the
    (replicated) bias once.  Without a split, :func:`linear` itself."""
    if tp is None or tp.model == 1:
        return linear(x, weight, bias)
    y = reduce_from_model(linear(x, weight), tp)
    return y if bias is None else y + bias.to(y.dtype)


class MultiHeadAttention(nn.Module):
    """Packed in_proj → attention core → out_proj.  Under tensor
    parallelism (``tp``, set by ``apply_tensor_parallel``) ``heads`` is
    the model rank's share of them."""

    tp = None  # the mesh whose model axis splits the heads

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
        x = copy_to_model(x, self.tp)
        return self.attend(linear(x, self.in_proj_weight, self.in_proj_bias))

    def attend(self, qkv: torch.Tensor) -> torch.Tensor:
        """Attention core and out_proj over a packed (B, L, 3W) qkv, for a
        block whose fused LN+qkv kernel already produced it."""
        if self.tp is None or self.tp.model == 1:
            ctx = attention_core(qkv, self.heads, self.causal)
        else:  # the route of the whole width, as the JAX kernel sees it
            ctx = attention_core(qkv, self.heads, self.causal, tp=self.tp.model)
        return row_linear(ctx, self.out_proj.weight, self.out_proj.bias, self.tp)


class MLP(nn.Module):
    tp = None  # the mesh whose model axis splits the hidden units

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
        h = self.act(linear(copy_to_model(x, self.tp), self.c_fc.weight, self.c_fc.bias))
        return row_linear(h, self.c_proj.weight, self.c_proj.bias, self.tp)


class ResidualAttentionBlock(nn.Module):
    """Pre-LN block: x += attn(ln_1(x)); x += mlp(ln_2(x)).

    With ``fused_ln_qkv`` and ``ln_fp32``, ``ln_1`` and the in_proj run as
    one fused LN+qkv (fast-variance LayerNorm, the JAX kernel's
    arithmetic) in x's type, over ``ln_1``'s and ``attn``'s own
    parameters.  ``tag_attn_out`` tags the attention output for the
    ``attn_out`` remat policy."""

    def __init__(self, width: int, heads: int, mlp_hidden: Optional[int],
                 act: Activation, causal: bool, fused_ln_qkv: bool = False,
                 ln_fp32: bool = True, tag_attn_out: bool = False):
        super().__init__()
        self.fused_ln_qkv = fused_ln_qkv
        self.tag_attn_out = tag_attn_out
        self.ln_1 = LayerNorm(width, fp32=ln_fp32)
        self.attn = MultiHeadAttention(width, heads, causal)
        self.ln_2 = LayerNorm(width, fp32=ln_fp32)
        self.mlp = MLP(width, mlp_hidden or 4 * width, act)

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.ln_1.reset_parameters()
        self.attn.reset_parameters(gen)
        self.ln_2.reset_parameters()
        self.mlp.reset_parameters(gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused_ln_qkv and self.ln_1.fp32:
            # under tensor parallelism the kernel's LayerNorm gradients are
            # partial sums over the local columns: f sums them, as x's
            tp = self.attn.tp
            qkv = ln_qkv_core(copy_to_model(x, tp), copy_to_model(self.ln_1.weight, tp),
                              copy_to_model(self.ln_1.bias, tp), self.attn.in_proj_weight,
                              self.attn.in_proj_bias, self.ln_1.eps)
            attn = self.attn.attend(qkv)
        else:
            attn = self.attn(self.ln_1(x))
        x = x + (attn_out(attn) if self.tag_attn_out else attn)
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    """The block stack.  With ``remat`` each block runs under
    :func:`remat` with its ``remat_policy`` whenever a gradient is taken
    (the JAX ``nn.remat(ResidualAttentionBlock)``, layers.py:322-336);
    without a gradient (eval, GradCache's first pass) the blocks run
    plainly.

    ``pipeline_stages`` S > 1 (with ``scan_layers`` and a ``mesh`` of S
    model ranks) makes the stack this model rank's stage of a GPipe
    pipeline of ``pipeline_microbatches`` microbatches (default S): the
    stage's blocks in a ``ModuleDict`` under their global indices, the
    forward :func:`~sparsify_clip_tpu_torch.parallel.pipeline.gpipe_apply`
    behind Megatron's f.  :meth:`reset_parameters` still draws every
    block, so a seed gives the same weights on every layout."""

    def __init__(self, width: int, layers: int, heads: int,
                 mlp_hidden: Optional[int] = None, act: Activation = gelu_exact,
                 causal: bool = False, fused_ln_qkv: bool = False, ln_fp32: bool = True,
                 remat: bool = False, remat_policy: Optional[str] = None,
                 scan_layers: bool = False, pipeline_stages: int = 1,
                 pipeline_microbatches: Optional[int] = None, mesh=None):
        super().__init__()
        self.layers = layers
        self.remat = remat
        self.policy = resolve_remat_policy(remat_policy) if remat else None
        tag = remat and remat_policy == "attn_out"

        def block(fused: bool) -> ResidualAttentionBlock:
            return ResidualAttentionBlock(width, heads, mlp_hidden, act, causal, fused,
                                          ln_fp32, tag)

        self.pipeline = None  # (mesh, microbatches) of a pipelined stack
        if pipeline_stages <= 1:
            self.resblocks = nn.ModuleList(block(fused_ln_qkv) for _ in range(layers))
            return
        from sparsify_clip_tpu_torch.parallel.pipeline import validate_pipeline

        if not scan_layers:
            raise ValueError(
                "pipeline_stages > 1 requires scan_layers=True (the "
                "stacked (layers, ...) param layout is the stage split)"
            )
        if mesh is None:
            raise ValueError("pipeline_stages > 1 requires pipeline_mesh")
        if mesh.model != pipeline_stages:
            raise ValueError(f"pipeline_stages={pipeline_stages} needs a mesh of as many "
                             f"model ranks, got {mesh.model}")
        n_micro = pipeline_microbatches or pipeline_stages
        validate_pipeline(layers, pipeline_stages, 0, n_micro)  # the batch at each call
        self.pipeline = (mesh, n_micro)
        per = layers // pipeline_stages
        first = mesh.model_rank * per
        self.resblocks = nn.ModuleDict({str(i): block(False) for i in range(first, first + per)})
        # what reset_parameters draws for another stage's block
        self._draw = functools.partial(block, False)

    def reset_parameters(self, gen: torch.Generator) -> None:
        if self.pipeline is None:
            for block in self.resblocks:
                block.reset_parameters(gen)
            return
        for i in range(self.layers):
            if str(i) in self.resblocks:
                self.resblocks[str(i)].reset_parameters(gen)
            else:  # another stage's block: the same draws, kept nowhere
                with torch.device(gen.device):
                    self._draw().reset_parameters(gen)

    def stage(self, x: torch.Tensor) -> torch.Tensor:
        """A pipelined stack's blocks, in order: this rank's stage."""
        for block in self.resblocks.values():
            x = block(x)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pipeline is not None:
            from sparsify_clip_tpu_torch.parallel.pipeline import gpipe_apply

            mesh, n_micro = self.pipeline
            return gpipe_apply(self.stage, list(self.parameters()), copy_to_model(x, mesh),
                               mesh, n_micro, self.layers)
        recompute = self.remat and torch.is_grad_enabled()
        for block in self.resblocks:
            x = remat(block, self.policy, x) if recompute else block(x)
        return x
