"""Tensor parallelism over the mesh's model axis, ported from the JAX
``_TP_RULES`` (sparsify_clip_tpu/parallel/mesh.py:67-90).

The JAX package annotates the weights and lets XLA insert the
collectives.  The port splits the same weights Megatron's way, by hand,
over the mesh's model group:

* **column-parallel**: the attention's packed ``in_proj`` and the MLP's
  ``c_fc``; model rank ``m`` keeps its block of output features (and of
  the bias);
* **row-parallel**: the attention's ``out_proj``, the MLP's ``c_proj``
  and a ResNet attention pool's ``c_proj``; rank ``m`` keeps its block of
  input features, and the bias is added once, after the sum.

``in_proj`` splits by head: its rows are [q | k | v], and rank ``m`` keeps
the q, k and v rows of heads ``[m·H/tp, (m+1)·H/tp)``, so its local qkv
is again [q | k | v], over H/tp heads (a contiguous split of the 3W rows
would hand rank 0 all of q and part of k).

Two conjugate operations carry the activations (Megatron's f and g):
:func:`copy_to_model` (identity forward, the backward sums the model
ranks' gradients) before a column-parallel product, and
:func:`reduce_from_model` (the forward sums the partial products,
identity backward) after a row-parallel one.  Both sum in fp32 whatever
the activations' type, one design on every backend.

Every rank builds the full model from the seed and keeps its slices
(:func:`apply_tensor_parallel`), so the mesh does not change the initial
values; :func:`split` and :func:`join` map a full tensor to a rank's
slice and the slices back, bit for bit.
"""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

import torch
from torch import nn

from sparsify_clip_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh, all_reduce_

# parameter name → (kind, dim in the torch layout): the JAX rules'
# targets, kernels and (here) the column-parallel biases
_RULES: List[Tuple[re.Pattern, Tuple[str, int]]] = [
    (re.compile(r"(^|\.)attn\.in_proj_(weight|bias)$"), ("heads", 0)),
    (re.compile(r"(^|\.)c_fc\.(weight|bias)$"), ("cols", 0)),
    (re.compile(r"(^|\.)(out_proj|c_proj)\.weight$"), ("rows", 1)),
]


def tp_rule(name: str) -> Optional[Tuple[str, int]]:
    """How the model axis splits the parameter ``name``: ``(kind, dim)``,
    or None for a replicated one."""
    for pattern, rule in _RULES:
        if pattern.search(name):
            return rule
    return None


def split(kind: str, dim: int, full: torch.Tensor, tp: int, m: int) -> torch.Tensor:
    """Model rank ``m``'s slice of ``full`` (a view where one exists)."""
    if kind == "heads":  # [q | k | v]: the same block of heads from each
        return full.reshape(3, tp, full.shape[0] // (3 * tp), *full.shape[1:])[:, m].reshape(
            -1, *full.shape[1:])
    return full.chunk(tp, dim)[m]


def join(kind: str, dim: int, parts: List[torch.Tensor]) -> torch.Tensor:
    """The full tensor from every model rank's slice, in rank order."""
    if kind == "heads":
        rest = parts[0].shape[1:]
        return torch.stack([p.reshape(3, -1, *rest) for p in parts], 1).reshape(-1, *rest)
    return torch.cat(parts, dim)


def sum_fp32(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of every model rank's ``x``, taken in fp32 and returned in
    x's type (no autograd)."""
    y = x.float().contiguous()  # a fresh buffer when x is not fp32
    if y is x:
        y = y.clone()
    return all_reduce_(y, mesh, axis=MODEL_AXIS).to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return sum_fp32(g, ctx.mesh), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return sum_fp32(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Megatron's f: ``x`` replicated over the model group enters a split
    computation; its gradient is the sum of the model ranks'."""
    if mesh is None or mesh.model == 1:
        return x
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Megatron's g: the sum over the model group of each rank's partial
    ``x``, replicated; the gradient passes to each part unchanged."""
    if mesh is None or mesh.model == 1:
        return x
    return _ReduceFromModel.apply(x, mesh)


def check_divisible(model: nn.Module, tp: int) -> None:
    """Refuse, by module, a head count or a split width that ``tp`` does
    not divide (the head-aligned split needs whole heads a rank)."""
    from sparsify_clip_tpu_torch.models.layers import MLP, MultiHeadAttention
    from sparsify_clip_tpu_torch.models.resnet import AttentionPool2d

    for name, module in model.named_modules():
        if isinstance(module, MultiHeadAttention):
            counts = {"heads": module.heads}
        elif isinstance(module, MLP):
            counts = {"MLP hidden width": module.c_fc.out_features}
        elif isinstance(module, AttentionPool2d):
            counts = {"attention pool width": module.c_proj.in_features}
        else:
            continue
        for what, n in counts.items():
            if n % tp:
                raise ValueError(f"mesh_model={tp} does not divide {name}'s {n} {what}: "
                                 "tensor parallelism splits them evenly over the model axis")


def apply_tensor_parallel(model: nn.Module, mesh: Mesh) -> None:
    """Keep this model rank's slice of every split weight of ``model`` (a
    full model built from the seed) and switch its attention, MLP and
    attention-pool modules to the split forward."""
    from sparsify_clip_tpu_torch.models.layers import MLP, MultiHeadAttention
    from sparsify_clip_tpu_torch.models.resnet import AttentionPool2d

    tp, m = mesh.model, mesh.model_rank
    if tp == 1:
        return
    check_divisible(model, tp)
    for mod_name, module in model.named_modules():
        for p_name, p in list(module.named_parameters(recurse=False)):
            rule = tp_rule(f"{mod_name}.{p_name}")
            if rule is not None:
                local = split(*rule, p.detach(), tp, m).clone()
                module._parameters[p_name] = nn.Parameter(local, requires_grad=p.requires_grad)
        if isinstance(module, MultiHeadAttention):
            module.heads //= tp
        if isinstance(module, (MultiHeadAttention, MLP, AttentionPool2d)):
            module.tp = mesh
