"""GPipe pipeline parallelism over the mesh's model axis, ported from
:mod:`sparsify_clip_tpu.parallel.pipeline`.

The JAX package keeps each transformer trunk's blocks stacked on a
leading layer axis (``scan_layers``), shards that axis over 'model', and
runs the trunk as an S-stage GPipe schedule under ``shard_map``: a
statically unrolled loop of ``n_micro + S − 1`` ticks, at each of which
every stage applies its ``L/S`` blocks under ``jax.checkpoint`` and hands
its activation to the next stage with a non-cyclic ``ppermute``; the
microbatch that leaves the last stage is masked to it and ``psum``-ed
over 'model', so the head and the loss run replicated over the stages.
JAX differentiates that loop.

The port runs one process per GPU.  Model rank ``s`` of a (data, model)
mesh is stage ``s``: it holds blocks ``[s·L/S, (s+1)·L/S)`` of each trunk
(:class:`~sparsify_clip_tpu_torch.models.layers.Transformer` with
``pipeline_stages``) and everything else replicated.  One autograd
function (:class:`_GPipe`) is the whole trunk call, with a schedule of
its own in both directions:

* **forward**, without autograd: tick ``t`` hands each stage's last
  output to the next stage (:func:`~sparsify_clip_tpu_torch.parallel.mesh.hop`
  over the model group, one ``all_to_all_single`` with one nonzero split:
  the hop is cyclic, and stage 0 discards what the last stage sends it,
  which gives the JAX values); stage 0 takes microbatch ``t``; a stage
  whose tick carries a microbatch applies its blocks and keeps that input
  (the JAX checkpoint's memory profile: one microbatch's activation a
  tick).  The last stage's outputs, zeros elsewhere, are summed over the
  model group in fp32 (Megatron's g: every stage then holds the trunk's
  output; one nonzero term, so the sum is exact);
* **backward**: the ticks in reverse.  The cotangent of the output is
  replicated and enters the last stage alone (g's backward is the
  identity: summing it again would count the replicated loss S times);
  each tick hops the stages' input cotangents back one stage, and a stage
  whose tick carried a microbatch recomputes its blocks from the kept
  input with autograd on and takes the gradients of that input and of
  its parameters, summed over the microbatches.

Every rank issues the same collectives in the same order in both
directions, for both trunks: under plain autograd stage 0 would never
run the backward of a hop it discarded, and the other ranks' backward
collectives would wait for it.  Bubble ticks (a stage with no microbatch)
skip their compute, whose outputs never reach the loss; the hops stay in
lockstep (``n_micro + S − 2`` a call each way: the first forward tick and
the last backward tick carry nothing).  So each stage runs its blocks
``n_micro`` times forward and ``n_micro`` times again in the backward:
its attention forward launches ``2·n_micro·L/S`` times a step and its
backward ``n_micro·L/S`` times, a trunk.  Without a gradient (eval) the
forward alone runs and keeps nothing.

The trunk's input enters through Megatron's f
(:func:`~sparsify_clip_tpu_torch.parallel.tensor.copy_to_model`): only
stage 0's input cotangent is nonzero, and f's backward sums it over the
model group, so every stage's embedding gradients are complete.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from sparsify_clip_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh, hop
from sparsify_clip_tpu_torch.parallel.tensor import sum_fp32

StageFn = Callable[[torch.Tensor], torch.Tensor]


def stacked_layers(transformer) -> int:
    """The block count of a transformer trunk: the leading (layer) axis of
    its JAX scan-layout stack, all stages' blocks together."""
    return transformer.layers


def validate_pipeline(n_layers: int, stages: int, local_batch: int, n_micro: int) -> None:
    if n_micro < 1:
        raise ValueError(
            f"pipeline: pipeline_microbatches must be >= 1, got {n_micro}"
        )
    if n_layers % stages:
        raise ValueError(
            f"pipeline: {n_layers} layers not divisible by {stages} stages"
        )
    if local_batch % n_micro:
        raise ValueError(
            f"pipeline: per-data-shard batch {local_batch} not divisible "
            f"by {n_micro} microbatches"
        )


def bubble_share(stages: int, n_micro: int) -> float:
    """The share of a stage's ticks that carry no microbatch: (S−1)/(M+S−1)."""
    return (stages - 1) / (n_micro + stages - 1)


def _active(stage: int, t: int, n_micro: int) -> bool:
    """Whether stage ``stage``'s tick ``t`` carries a microbatch (``t − stage``)."""
    return 0 <= t - stage < n_micro


def _forward(stage_fn: StageFn, x: torch.Tensor, mesh: Mesh, n_micro: int,
             keep: Optional[List[torch.Tensor]]) -> torch.Tensor:
    """The forward schedule on this rank's ``x``; with ``keep``, the stage's
    input of each microbatch is appended to it, in microbatch order."""
    stages, s = mesh.model, mesh.model_rank
    micro = x.reshape(n_micro, x.shape[0] // n_micro, *x.shape[1:])
    zeros = x.new_zeros(micro.shape[1:])
    out = x.new_zeros(micro.shape)
    prev = zeros
    for t in range(n_micro + stages - 1):
        incoming = hop(prev, mesh, 1, MODEL_AXIS) if t > 0 else zeros
        if not _active(s, t, n_micro):
            prev = zeros
            continue
        x_in = micro[t] if s == 0 else incoming
        if keep is not None:
            keep.append(x_in)
        prev = stage_fn(x_in)
        if s == stages - 1:
            out[t - s] = prev
    return sum_fp32(out.view_as(x), mesh)


class _GPipe(torch.autograd.Function):
    """The pipelined trunk: ``x`` (this rank's rows) → the trunk's output,
    replicated over the model group; the gradients of ``x`` (nonzero on
    stage 0) and of the stage's ``params``."""

    @staticmethod
    def forward(ctx, x, stage_fn, mesh, n_micro, *params):
        ctx.stage_fn, ctx.mesh, ctx.n_micro, ctx.params = stage_fn, mesh, n_micro, params
        ctx.inputs = []
        return _forward(stage_fn, x, mesh, n_micro, ctx.inputs)

    @staticmethod
    def backward(ctx, dy):
        mesh, n_micro, params = ctx.mesh, ctx.n_micro, ctx.params
        stages, s = mesh.model, mesh.model_rank
        ticks = n_micro + stages - 1
        dy = dy.reshape(n_micro, dy.shape[0] // n_micro, *dy.shape[1:])
        zeros = dy.new_zeros(dy.shape[1:])
        dx = torch.zeros_like(dy) if s == 0 else None
        grads: List[Optional[torch.Tensor]] = [None] * len(params)
        g_in = zeros  # the cotangent of this stage's input at tick t + 1
        for t in reversed(range(ticks)):
            # stage s + 1's input cotangent of tick t + 1 is that of stage
            # s's output at tick t; the last stage discards stage 0's
            received = hop(g_in, mesh, -1, MODEL_AXIS) if t < ticks - 1 else zeros
            if not _active(s, t, n_micro):
                g_in = zeros
                continue
            k = t - s
            g_out = dy[k] if s == stages - 1 else received
            x_in = ctx.inputs[k].detach().requires_grad_(True)
            with torch.enable_grad():
                y = ctx.stage_fn(x_in)
            got = torch.autograd.grad(y, (x_in, *params), g_out, allow_unused=True)
            ctx.inputs[k] = None  # the microbatch's input is no longer needed
            g_in = got[0]
            for i, g in enumerate(got[1:]):
                if g is not None:
                    grads[i] = g if grads[i] is None else grads[i] + g
            if s == 0:
                dx[k] = g_in
        if dx is None:
            dx = torch.zeros_like(dy)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        return (dx.view(-1, *dx.shape[2:]), None, None, None, *grads)


def gpipe_apply(stage_fn: StageFn, params: Sequence[torch.Tensor], x: torch.Tensor,
                mesh: Mesh, n_micro: Optional[int] = None, n_layers: Optional[int] = None
                ) -> torch.Tensor:
    """Apply a trunk of ``n_layers`` blocks as an S-stage GPipe pipeline
    over ``mesh``'s model axis (S = ``mesh.model``): ``stage_fn(x)``
    applies this rank's stage, whose parameters are ``params``; ``x`` is
    this rank's rows, the same on every model rank.  The output equals
    applying all the blocks in order, on every model rank.  ``n_micro``
    defaults to the stage count."""
    stages = mesh.model
    if n_micro is None:
        n_micro = max(stages, 1)
    validate_pipeline(stages if n_layers is None else n_layers, stages, x.shape[0], n_micro)
    params = [p for p in params if p.requires_grad]
    if not torch.is_grad_enabled() or not (x.requires_grad or params):
        with torch.no_grad():
            return _forward(stage_fn, x, mesh, n_micro, None)
    return _GPipe.apply(x, stage_fn, mesh, n_micro, *params)
