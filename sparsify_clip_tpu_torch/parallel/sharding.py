"""The train state's layout over the (data, model) mesh: ZeRO-1 and FSDP
on the data axis, on top of tensor parallelism's slices or the GPipe
stages on the model axis (:mod:`sparsify_clip_tpu_torch.parallel.tensor`,
:mod:`sparsify_clip_tpu_torch.parallel.pipeline`), ported from the JAX
``shard_over_data``, ``zero1_opt_shardings``, the stage rule of
``param_shardings(pipeline=True)`` (parallel/mesh.py:91-180) and
``state_shardings_for`` (train.py:413-445).

**The rule** (:func:`data_dim`, the JAX ``shard_over_data``): a tensor
shards over the data axis along its largest dimension that the model
axis leaves whole and the data-axis size divides; a scalar, or a tensor
no dimension of which divides, stays replicated.  Data rank ``r`` keeps
block ``r`` of that dimension.

* **ZeRO-1** (``shard_opt_state``; :class:`Zero1Optimizer`): the AdamW
  moments shard by the rule; parameters and gradients stay replicated.
  Each rank steps AdamW on its blocks of the parameters, then one
  ``all_gather_into_tensor`` puts the updated blocks together on every
  rank.  AdamW is elementwise, so the trajectory is the replicated
  step's, bit for bit.  The loss scalars (temperature, SigLIP's scale and
  bias) keep replicated moments, as the JAX rule leaves scalars alone.
* **FSDP** (``fsdp``; :class:`Layout` with ``fsdp``): parameters and
  moments shard by the rule; the optimizer steps the shards.  Each
  residual block (``ResidualAttentionBlock``, ``Bottleneck``) and each
  tower's remaining weights are one unit: a forward pre-hook gathers the
  unit's shards (one ``all_gather_into_tensor``) into full tensors that
  the unit's modules read for that call, and a forward hook drops them.
  The gather is an autograd function whose backward sums the full
  gradients over the data group and keeps this rank's block (one
  ``reduce_scatter_tensor``): the per-layer exchange XLA inserts.  The
  backward reads what its forward saved (the compute-type casts of the
  weights); under ``remat`` the recompute calls the unit again and so
  gathers again.  A replicated tensor keeps its gradient all-reduce.
* **The stage rule** (``pipeline``; :class:`Layout` with ``pipeline``):
  model rank ``s`` holds stage ``s``'s blocks of each transformer trunk
  (``resblocks.N`` with ``N // (L/S) == s``, the JAX ``layers_scan``
  stacks sharded on their layer axis) and every other parameter whole.
  Each parameter's gradient reduces over the data group alone, as
  without the pipeline: a block's is its stage's, and a replicated one's
  is already whole over the model group (Megatron's f before each trunk).
  ZeRO-1 then splits the moments of the rank's own parameters.

The full view (:meth:`Layout.full`, :meth:`Layout.full_named`,
:meth:`Layout.full_state_dict`, :func:`full_optimizer_state`) puts every
tensor back together, the data blocks first and then the model slices
(or the other stages' blocks, one ``all_gather_into_tensor`` over the
model group), so checkpoints, the JAX weight files and the eval twin see
the model of one process under its names and its optimizer indices;
:meth:`Layout.local`, :meth:`Layout.load_state_dict` and
:func:`load_optimizer_state` cut a full tensor or state down to this
rank's piece.  Every one of them is a collective: each rank calls it.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from sparsify_clip_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, Mesh, all_gather_rows, reduce_scatter_rows,
)
from sparsify_clip_tpu_torch.parallel.tensor import join, split, tp_rule


def data_dim(shape: Sequence[int], dp: int, exclude: Optional[int] = None) -> Optional[int]:
    """The dimension the data axis splits (the JAX ``shard_over_data``):
    the largest one, first on ties, that is not ``exclude`` (the model
    axis's) and that ``dp`` divides; None to stay replicated."""
    if dp == 1:
        return None
    dims = [i for i in range(len(shape)) if i != exclude and shape[i] % dp == 0]
    return max(dims, key=lambda i: shape[i]) if dims else None


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where one parameter's pieces live: ``tp`` is the model axis's
    ``(kind, dim)`` (None: replicated over it), ``data_dim`` the dimension
    the data axis splits (None: replicated), ``sharded`` whether the
    parameter itself is split there (FSDP) or only its moments (ZeRO-1)."""

    full_shape: Tuple[int, ...]
    tp: Optional[Tuple[str, int]]
    data_dim: Optional[int]
    sharded: bool


def _exact(t: torch.Tensor) -> torch.Tensor:
    """Half types travel as fp32, which holds them exactly."""
    return t.float() if t.dtype in (torch.bfloat16, torch.float16) else t


def _gather_dim(t: torch.Tensor, dim: int, mesh: Mesh, axis: str) -> torch.Tensor:
    x = _exact(t).movedim(dim, 0).contiguous()
    return all_gather_rows(x, mesh, axis).movedim(0, dim).to(t.dtype)


def _block(t: torch.Tensor, dim: Optional[int], mesh: Mesh) -> torch.Tensor:
    return t if dim is None else t.chunk(mesh.data, dim)[mesh.data_rank]


# ------------------------------------------------------------------ FSDP


@dataclasses.dataclass
class _Entry:
    module: nn.Module
    attr: str
    shard: nn.Parameter
    dim: int


class _Unit:
    """One FSDP unit: the sharded parameters that one module's forward reads."""

    def __init__(self, layout: "Layout", entries: List[_Entry]):
        self.layout = layout
        self.entries = entries

    def gather(self, module, args):
        fulls = _GatherUnit.apply(self, *[e.shard for e in self.entries])
        for e, full in zip(self.entries, fulls):
            e.module.__dict__[e.attr] = full  # found before the module's _parameters

    def drop(self, module, args, out):
        for e in self.entries:
            e.module.__dict__.pop(e.attr, None)


class _GatherUnit(torch.autograd.Function):
    """Shards → full tensors (one all-gather of the packed shards); the
    backward reduce-scatters the full gradients back onto the shards."""

    @staticmethod
    def forward(ctx, unit: _Unit, *shards):
        ctx.unit = unit
        mesh = unit.layout.mesh
        flat = torch.cat([s.detach().reshape(-1) for s in shards])
        parts = all_gather_rows(flat, mesh).view(mesh.data, -1)
        fulls, at = [], 0
        for e, s in zip(unit.entries, shards):
            n = s.numel()
            fulls.append(torch.cat([parts[r, at:at + n].view(s.shape)
                                    for r in range(mesh.data)], e.dim))
            at += n
        return tuple(fulls)

    @staticmethod
    def backward(ctx, *grads):
        unit = ctx.unit
        layout = unit.layout
        mesh = layout.mesh
        grads = [torch.zeros(e.shard.shape[:e.dim] + (e.shard.shape[e.dim] * mesh.data,)
                             + e.shard.shape[e.dim + 1:], dtype=e.shard.dtype,
                             device=e.shard.device) if g is None else g
                 for e, g in zip(unit.entries, grads)]
        if layout.reduce_grads:
            # rank-major: block r of every gradient, packed, for rank r
            packed = torch.cat([g.chunk(mesh.data, e.dim)[r].reshape(-1)
                                for r in range(mesh.data)
                                for e, g in zip(unit.entries, grads)])
            own = reduce_scatter_rows(packed, mesh)
        else:  # every data rank already holds the whole gradient
            own = torch.cat([g.chunk(mesh.data, e.dim)[mesh.data_rank].reshape(-1)
                             for e, g in zip(unit.entries, grads)])
        out, at = [], 0
        for e in unit.entries:
            n = e.shard.numel()
            out.append(own[at:at + n].view(e.shard.shape))
            at += n
        return (None, *out)


def _unit_modules(model: nn.Module) -> List[nn.Module]:
    """The FSDP units, innermost first: every residual block, then each tower."""
    from sparsify_clip_tpu_torch.models.layers import ResidualAttentionBlock
    from sparsify_clip_tpu_torch.models.resnet import Bottleneck

    blocks = [m for m in model.modules() if isinstance(m, (ResidualAttentionBlock, Bottleneck))]
    towers = [m for m in (getattr(model, "visual", None), getattr(model, "text", None))
              if m is not None]
    return blocks + towers + [model]


# ---------------------------------------------------------------- layout


_BLOCK = re.compile(r"^(.*)\.resblocks\.(\d+)\.(.*)$")


class Layout:
    """Every parameter's :class:`Placement` on ``mesh`` for a model whose
    split weights ``apply_tensor_parallel`` already cut; ``fsdp`` shards
    the parameters by the rule and installs the units' hooks.  With
    ``pipeline`` the model holds its model rank's stage of each pipelined
    trunk: the placements then name every parameter of the model of one
    process (:attr:`one_process`, on the meta device), in its order
    (:attr:`full_names`)."""

    def __init__(self, model: nn.Module, mesh: Mesh, fsdp: bool = False, zero1: bool = False,
                 pipeline: bool = False):
        self.mesh = mesh
        self.fsdp = fsdp and mesh.data > 1
        self.zero1 = zero1 and mesh.data > 1 and not self.fsdp
        self.pipeline = pipeline and mesh.model > 1
        # False while every data rank holds the whole batch (the gathered
        # GradCache layout): FSDP's backward then keeps its block unsummed
        self.reduce_grads = True
        self.placements: Dict[str, Placement] = {}
        self.one_process: Optional[nn.Module] = None
        # pipeline: (stage, slot) of each block parameter, and the inverse;
        # a slot (trunk, index within the stage, name within the block)
        # holds the same tensor shape on every stage
        self.stages: Dict[str, Tuple[int, tuple]] = {}
        self.slot_names: Dict[Tuple[int, tuple], str] = {}
        named = model.named_parameters()
        if self.pipeline:
            from sparsify_clip_tpu_torch.models.clip import CLIP

            with torch.device("meta"):
                self.one_process = CLIP(model.cfg, dtype=model.dtype, **model.one_process_knobs)
            named = self.one_process.named_parameters()
            from sparsify_clip_tpu_torch.parallel.pipeline import stacked_layers

            per = {prefix: stacked_layers(t) // mesh.model for prefix, t in model.named_modules()
                   if getattr(t, "pipeline", None) is not None}
        split_data = self.fsdp or self.zero1
        for name, p in named:
            tp = tp_rule(name) if mesh.model > 1 and not self.pipeline else None
            full = list(p.shape)
            if tp is not None:
                full[tp[1]] *= mesh.model
            dim = data_dim(p.shape, mesh.data, tp and tp[1]) if split_data else None
            block = _BLOCK.match(name) if self.pipeline else None
            if block is not None and block.group(1) in per:
                i, n = int(block.group(2)), per[block.group(1)]
                slot = (block.group(1), i % n, block.group(3))
                self.stages[name] = (i // n, slot)
                self.slot_names[(i // n, slot)] = name
            self.placements[name] = Placement(tuple(full), tp, dim, self.fsdp and dim is not None)
        self.full_names = list(self.placements)
        # this rank's block slots, in one order on every stage
        self.slots = sorted(slot for stage, slot in self.stages.values()
                            if stage == mesh.model_rank)
        if self.fsdp:
            self._shard(model)

    def _shard(self, model: nn.Module) -> None:
        owned = set()
        names = {id(p): n for n, p in model.named_parameters()}
        for unit_module in _unit_modules(model):
            entries = []
            for module in unit_module.modules():
                for attr, p in list(module._parameters.items()):
                    if p is None or id(p) in owned:
                        continue
                    owned.add(id(p))
                    place = self.placements[names[id(p)]]
                    if not place.sharded:
                        continue
                    shard = nn.Parameter(_block(p.detach(), place.data_dim, self.mesh).clone(),
                                         requires_grad=p.requires_grad)
                    module._parameters[attr] = shard
                    owned.add(id(shard))
                    entries.append(_Entry(module, attr, shard, place.data_dim))
            if entries:  # the hooks hold the unit
                unit = _Unit(self, entries)
                unit_module.register_forward_pre_hook(unit.gather)
                unit_module.register_forward_hook(unit.drop)

    # -------------------------------------------------- what the step reads

    def reduced_params(self, model: nn.Module) -> List[nn.Parameter]:
        """The parameters whose gradients the step all-reduces over the
        data axis: all but FSDP's shards, which the units reduce-scatter."""
        return [p for n, p in model.named_parameters() if not self.placements[n].sharded]

    def moment_dims(self, model: nn.Module) -> List[Optional[int]]:
        """ZeRO-1: the data dimension of each parameter's moments, in
        ``model.parameters()`` order."""
        return [self.placements[n].data_dim for n, _ in model.named_parameters()]

    # ------------------------------------------------------- the full view

    def full(self, name: str, local: torch.Tensor, moment: bool = False) -> torch.Tensor:
        """Parameter ``name``'s full tensor (or that of a moment of it) from
        this rank's piece: the data blocks, then the model slices."""
        place = self.placements[name]
        t = local
        if place.data_dim is not None and (place.sharded or moment):
            t = _gather_dim(t, place.data_dim, self.mesh, DATA_AXIS)
        if place.tp is not None:
            kind, dim = place.tp
            parts = all_gather_rows(_exact(t).reshape(1, -1), self.mesh, MODEL_AXIS)
            t = join(kind, dim, [row.view(t.shape) for row in parts]).to(t.dtype)
        return t

    def local(self, name: str, full: torch.Tensor, moment: bool = False) -> torch.Tensor:
        """This rank's piece of parameter ``name``'s full tensor (or of a
        moment of it): the inverse of :meth:`full`."""
        place = self.placements[name]
        t = full
        if place.tp is not None:
            t = split(*place.tp, t, self.mesh.model, self.mesh.model_rank)
        if place.data_dim is not None and (place.sharded or moment):
            t = _block(t, place.data_dim, self.mesh)
        return t.contiguous()

    def stage_gather(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Pipeline: every stage's block tensors by name, from this rank's
        (``tensors``: its stage's, by name, among others): one
        ``all_gather_into_tensor`` over the model group, in fp32 (half types
        travel exactly).  Without the pipeline, nothing."""
        if not self.pipeline:
            return {}
        mine = [tensors[self.slot_names[(self.mesh.model_rank, slot)]] for slot in self.slots]
        flat = torch.cat([_exact(t).reshape(-1) for t in mine])
        parts = all_gather_rows(flat, self.mesh, MODEL_AXIS).view(self.mesh.model, -1)
        out = {}
        for stage in range(self.mesh.model):
            at = 0
            for slot, t in zip(self.slots, mine):
                out[self.slot_names[(stage, slot)]] = parts[stage, at:at + t.numel()].view(
                    t.shape).to(t.dtype)
                at += t.numel()
        return out

    def full_named(self, tensors: Dict[str, torch.Tensor],
                   moment: bool = False) -> Dict[str, torch.Tensor]:
        """:meth:`full` of each of this rank's ``tensors`` (parameter name →
        the rank's piece of it, or of a moment of it), and under the
        pipeline the other stages' blocks too: the full view by name."""
        out = {n: self.full(n, t, moment) for n, t in tensors.items()}
        out.update(self.stage_gather(out))
        return out

    def full_params(self, model: nn.Module) -> Dict[str, torch.Tensor]:
        return self.full_named({n: p.detach() for n, p in model.named_parameters()})

    def full_state_dict(self, model: nn.Module) -> Dict[str, torch.Tensor]:
        """The model's ``state_dict`` as one process holds it: full
        parameters and the (replicated) buffers."""
        full = self.full_params(model)
        return {**{k: full.get(k, v) for k, v in model.state_dict().items()}, **full}

    def load_state_dict(self, model: nn.Module, state: Dict[str, torch.Tensor]) -> None:
        """Fill this rank's pieces from a full ``state_dict`` (strict: the
        keys of the model of one process)."""
        own = model.state_dict(keep_vars=True)
        expected = set(own) | set(self.placements)
        missing, extra = sorted(expected - set(state)), sorted(set(state) - expected)
        if missing or extra:
            raise KeyError(f"state_dict keys: missing {missing}, unexpected {extra}")
        with torch.no_grad():
            for k, target in own.items():
                value = state[k]
                if k in self.placements:
                    if tuple(value.shape) != self.placements[k].full_shape:
                        raise ValueError(f"shape mismatch for {k}: {tuple(value.shape)} vs "
                                         f"{self.placements[k].full_shape}")
                    value = self.local(k, value.to(target.device))
                target.copy_(value)

    def full_model(self, model: nn.Module, dtype: torch.dtype) -> nn.Module:
        """A CLIP of one process, computing in ``dtype``, over fresh copies
        of the full parameters and buffers (the eval twin of a sharded
        model)."""
        from sparsify_clip_tpu_torch.models.clip import CLIP

        with torch.device("meta"):
            twin = CLIP(model.cfg, dtype=dtype, **model.one_process_knobs)
        twin.load_state_dict(self.full_state_dict(model), strict=True, assign=True)
        return twin.train(model.training)


def shard_model(model: nn.Module, mesh: Mesh, fsdp: bool = False,
                zero1: bool = False, pipeline: bool = False) -> Optional[Layout]:
    """Lay ``model`` (full, from the seed) out over ``mesh``: tensor
    parallelism's slices, then FSDP's shards; or, with ``pipeline``, for a
    model that already holds its stage of each trunk (``create_model``'s
    ``pipeline_stages``), the stage rule and ZeRO-1's moments.  The
    :class:`Layout`, also set as ``model.layout``, or None when nothing is
    split."""
    from sparsify_clip_tpu_torch.parallel.tensor import apply_tensor_parallel

    if mesh.model == 1 and not (mesh.data > 1 and (fsdp or zero1)):
        return None
    if not pipeline:
        apply_tensor_parallel(model, mesh)
    layout = Layout(model, mesh, fsdp=fsdp, zero1=zero1, pipeline=pipeline)
    model.layout = layout
    return layout


def layout_of(model: nn.Module) -> Optional[Layout]:
    return getattr(model, "layout", None)


# ------------------------------------------------------------- optimizer


class Zero1Optimizer:
    """ZeRO-1 over the data axis: an inner AdamW (``make(params)``) over
    this rank's blocks of ``params`` (a parameter whose ``dims`` entry is
    None is its own block, replicated); :meth:`step` copies the parameters'
    and the gradients' blocks in, steps, and all-gathers the updated blocks
    into ``params``.
    The learning rate is written on :attr:`param_groups`, the inner
    optimizer's; the state dict is the inner one's (this rank's blocks)."""

    def __init__(self, params: Sequence[nn.Parameter], dims: Sequence[Optional[int]],
                 mesh: Mesh, make: Callable[[List[nn.Parameter]], torch.optim.Optimizer]):
        self.params, self.dims, self.mesh = list(params), list(dims), mesh
        self.blocks = [p if d is None else nn.Parameter(_block(p.detach(), d, mesh).clone())
                       for p, d in zip(self.params, self.dims)]
        self.inner = make(self.blocks)

    @property
    def param_groups(self):
        return self.inner.param_groups

    @property
    def state(self):
        return self.inner.state

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.params:
            p.grad = None
        self.inner.zero_grad(set_to_none=set_to_none)

    def state_dict(self) -> Dict[str, Any]:
        return self.inner.state_dict()

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.inner.load_state_dict(state)

    @torch.no_grad()
    def step(self) -> None:
        split_ = [(p, b, d) for p, b, d in zip(self.params, self.blocks, self.dims)
                  if d is not None]
        for p, b, d in split_:
            # the parameters are the truth (a load or a restore writes them)
            b.copy_(_block(p, d, self.mesh))
            b.grad = _block(p.grad, d, self.mesh).contiguous()
        self.inner.step()
        if not split_:
            return
        flat = torch.cat([b.reshape(-1) for _, b, _ in split_])
        parts = all_gather_rows(flat, self.mesh).view(self.mesh.data, -1)
        at = 0
        for p, b, d in split_:
            n = b.numel()
            p.copy_(torch.cat([parts[r, at:at + n].view(b.shape)
                               for r in range(self.mesh.data)], d))
            at += n


_MOMENTS = ("exp_avg", "exp_avg_sq")


def _moment_names(state) -> List[Optional[str]]:
    """The parameter name of each optimizer index (None past the model's:
    the temperature and the loss scalars, replicated everywhere)."""
    names: List[Optional[str]] = [n for n, _ in state.model.named_parameters()]
    n_opt = sum(len(g["params"]) for g in state.optimizer.param_groups)
    return names + [None] * (n_opt - len(names))


def _full_index(layout: Layout, names: List[Optional[str]]) -> Callable[[int], int]:
    """This rank's optimizer index → the one process's: the same but under
    the pipeline, where the one process holds every stage's blocks (in
    :attr:`Layout.full_names` order) and the loss scalars come after them."""
    if not layout.pipeline:
        return lambda i: i
    index = {n: j for j, n in enumerate(layout.full_names)}
    n_local = sum(n is not None for n in names)
    return lambda i: (index[names[i]] if names[i] is not None
                      else len(layout.full_names) + i - n_local)


def full_optimizer_state(state, layout: Layout) -> Dict[str, Any]:
    """The optimizer's state dict as one process's AdamW holds it: every
    moment full, every parameter's (a collective)."""
    sd = state.optimizer.state_dict()
    names = _moment_names(state)
    sharded_moments = layout.fsdp or layout.zero1
    entries = {}
    for i in sorted(sd["state"]):
        entry = dict(sd["state"][i])
        name = names[i]
        if name is not None:
            for k in _MOMENTS:
                if k in entry:
                    entry[k] = layout.full(name, entry[k], moment=sharded_moments)
        entries[i] = entry
    to_full = _full_index(layout, names)
    groups = sd["param_groups"]
    out = {"param_groups": groups, "state": {to_full(i): e for i, e in entries.items()}}
    if not layout.pipeline:
        return out
    # the other stages' entries: their moments gathered, the rest (the step
    # count) that of this rank's block of the same slot
    if len(groups) != 1:
        raise NotImplementedError("a pipelined optimizer has one parameter group")
    n_opt = len(layout.full_names) + len(names) - sum(n is not None for n in names)
    out["param_groups"] = [dict(groups[0], params=list(range(n_opt)))]
    by_name = {names[i]: e for i, e in entries.items() if names[i] is not None}
    if by_name:  # every rank has stepped as often: all gather, or none
        gathered = {k: layout.stage_gather({n: e[k] for n, e in by_name.items()})
                    for k in _MOMENTS if k in next(iter(by_name.values()))}
        index = {n: j for j, n in enumerate(layout.full_names)}
        for name, (stage, slot) in layout.stages.items():
            if stage != layout.mesh.model_rank:
                entry = dict(by_name[layout.slot_names[(layout.mesh.model_rank, slot)]])
                entry.update({k: moments[name] for k, moments in gathered.items()})
                out["state"][index[name]] = entry
    out["state"] = dict(sorted(out["state"].items()))
    return out


def load_optimizer_state(state, layout: Layout, full: Dict[str, Any]) -> None:
    """Load a full optimizer state dict (:func:`full_optimizer_state`'s, or
    one process's) into this rank's sharded optimizer."""
    names = _moment_names(state)
    sharded_moments = layout.fsdp or layout.zero1
    to_full = _full_index(layout, names)
    saved = {int(i): entry for i, entry in full["state"].items()}
    own_groups = state.optimizer.state_dict()["param_groups"]
    local = {"param_groups": [dict(g, params=own["params"])
                              for g, own in zip(full["param_groups"], own_groups)],
             "state": {}}
    for i, name in enumerate(names):
        if to_full(i) not in saved:
            continue
        entry = dict(saved[to_full(i)])
        if name is not None:
            for k in _MOMENTS:
                if k in entry:
                    entry[k] = layout.local(name, entry[k], moment=sharded_moments)
        local["state"][i] = entry
    state.optimizer.load_state_dict(local)
