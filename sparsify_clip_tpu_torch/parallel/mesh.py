"""The (data, model) process mesh and its collectives, ported from
:mod:`sparsify_clip_tpu.parallel.mesh` (mesh.py:36-65, 183-186).

The JAX package runs one global-view program over a ('data', 'model')
device mesh and lets XLA insert the collectives.  The port runs one
process per GPU (``torchrun``); :class:`Mesh` describes that process
group as the same grid, ``devices.reshape(data, model)``: world rank
``data_rank · model + model_rank``.  Each axis has its process group: the
data group holds the ranks that share this ``model_rank`` (they split the
batch: data rank ``r`` holds rows ``[r·b, (r+1)·b)`` of every global
batch of ``data·b`` rows), the model group the ranks that share this
``data_rank`` (they hold the same rows and split the tensor-parallel
weights, :mod:`sparsify_clip_tpu_torch.parallel.tensor`, or the GPipe
stages, :mod:`sparsify_clip_tpu_torch.parallel.pipeline`).  A group that
spans the whole world is the default group.

Every rank computes the same global loss.  The collectives below run
over the data group (``axis="model"`` where a function takes it) and
follow the JAX transposition rules of a ``shard_map`` with ``check_vma``
on, so that autograd on each rank leaves the gradient of that one loss
with respect to the rank's own inputs:

* :func:`all_gather` (``jax.lax.all_gather``, tiled): the output is the
  same on every rank, and so is its gradient; the backward keeps the
  rank's own rows of it.  A reduce-scatter would count the loss W times
  (the trap ``ops/fused.py:153-158`` names on the JAX side).
* :func:`psum` (``jax.lax.psum``): a replicated sum of per-rank parts;
  the backward hands each part the replicated gradient unchanged.
* :func:`pvary` (the implicit ``pvary`` of a replicated value used in a
  per-rank computation): identity forward, a summing all-reduce backward,
  so the value's gradient is complete on every rank.
* :func:`ring_hop` (``jax.lax.ppermute`` to ``rank + 1``): one
  ``all_to_all_single`` with one nonzero split, the form NCCL, gloo on
  the CPU and gloo on CUDA tensors all take (torch 2.11's gloo fails
  ``batch_isend_irecv`` of CUDA tensors); its backward hops back.
  :func:`hop` is the same step without autograd, over either axis (the
  pipeline's stage-to-stage hand-off runs it over the model group).

Replicated parameters see only the rank's rows in the encoders, so each
data rank's parameter gradients are its share of the total:
:func:`all_reduce_gradients` sums them once a step (one flat bucket).
Replicated scalars that only the loss reads (the temperature, SigLIP's
scale and bias) already hold their complete gradient on every rank and
are left out of it.  Sharded state (ZeRO-1, FSDP) is
:mod:`sparsify_clip_tpu_torch.parallel.sharding`'s.

A backend that refuses a collective raises :class:`RuntimeError` naming
the backend and the collective; nothing falls back.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The (data, model) grid over the process group: ``data`` × ``model``
    ranks, this process at ``data_rank`` and ``model_rank`` (world rank
    ``rank``); ``backend`` is the group's (None without a process group).
    ``data_group`` and ``model_group`` are the axes' process groups (None:
    the default group, or an axis of one rank)."""

    data: int = 1
    rank: int = 0
    backend: Optional[str] = None
    model: int = 1
    data_rank: int = 0
    model_rank: int = 0
    data_group: Any = dataclasses.field(default=None, compare=False, repr=False)
    model_group: Any = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def world(self) -> int:
        return self.data * self.model

    def size(self, axis: str) -> int:
        return self.data if axis == DATA_AXIS else self.model

    def group(self, axis: str) -> Any:
        return self.data_group if axis == DATA_AXIS else self.model_group

    def index(self, axis: str) -> int:
        """This rank's place on ``axis``."""
        return self.data_rank if axis == DATA_AXIS else self.model_rank

    def local_batch(self, global_batch: int) -> int:
        """The rows of a global batch that this rank holds."""
        if global_batch % self.data:
            raise ValueError(f"global batch {global_batch} not divisible by "
                             f"{self.data} processes")
        return global_batch // self.data

    def batch_slice(self, global_batch: int) -> slice:
        """This rank's rows of a global batch (the JAX ``P('data')``)."""
        b = self.local_batch(global_batch)
        return slice(self.data_rank * b, (self.data_rank + 1) * b)

    def without_data(self) -> "Mesh":
        """This rank's model group alone, as a mesh of one data rank: the
        view of a step whose data ranks all hold the same rows."""
        return dataclasses.replace(self, data=1, data_rank=0, data_group=None)


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


# every rank must create the same groups in the same order, once a mesh
_MESHES: Dict[Tuple[Any, int, int], Mesh] = {}


def create_mesh(data: int = -1, model: int = 1) -> Mesh:
    """The (data, model) mesh over the default process group (world 1
    without one), as JAX's ``devices.reshape(data, model)``.  ``data`` −1
    takes world // model; ``data · model`` must equal the world size.
    A collective on first use of a shape: every rank calls it alike."""
    dist = _dist()
    world = dist.get_world_size() if dist is not None else 1
    rank = dist.get_rank() if dist is not None else 0
    if model < 1:
        raise ValueError(f"model axis must be >= 1, got {model}")
    if data == -1:
        if world % model:
            raise ValueError(f"mesh_model={model} does not divide the world size {world}")
        data = world // model
    if data * model != world:
        raise ValueError(f"mesh data={data} × model={model} does not match the process "
                         f"group's world size {world}: each rank is one place on the grid")
    if dist is None:
        return Mesh(data=data, model=model)
    key = (dist.distributed_c10d._get_default_group(), data, model)
    if key not in _MESHES:
        data_rank, model_rank = divmod(rank, model)
        groups = {}
        # one group a column (data) and a row (model) of the grid; an axis
        # that spans the world runs on the default group
        if 1 < data < world:
            for m in range(model):
                g = dist.new_group([d * model + m for d in range(data)])
                groups[("data", m)] = g
        if 1 < model < world:
            for d in range(data):
                g = dist.new_group([d * model + m for m in range(model)])
                groups[("model", d)] = g
        _MESHES[key] = Mesh(data=data, rank=rank, backend=dist.get_backend(), model=model,
                            data_rank=data_rank, model_rank=model_rank,
                            data_group=groups.get(("data", model_rank)),
                            model_group=groups.get(("model", data_rank)))
    return _MESHES[key]


def _run(mesh: Mesh, what: str, fn: Callable[[], Any]) -> Any:
    """Run one collective; a backend that refuses it raises by name."""
    try:
        return fn()
    except (RuntimeError, ValueError, NotImplementedError) as exc:
        raise RuntimeError(f"the {mesh.backend} backend refused {what}: {exc}") from exc


_OPS = {"sum": "SUM", "max": "MAX"}


def all_reduce_(x: torch.Tensor, mesh: Mesh, op: str = "sum",
                axis: str = DATA_AXIS) -> torch.Tensor:
    """In-place all-reduce (``sum`` or ``max``) of ``x`` over ``axis``."""
    if mesh.size(axis) == 1:
        return x
    dist = _dist()
    red = getattr(dist.ReduceOp, _OPS[op])
    _run(mesh, f"all_reduce({op}) of a {x.device.type} tensor",
         lambda: dist.all_reduce(x, op=red, group=mesh.group(axis)))
    return x


def all_gather_rows(x: torch.Tensor, mesh: Mesh, axis: str = DATA_AXIS) -> torch.Tensor:
    """Every rank's ``x`` on ``axis`` stacked along the rows, in axis
    order (no autograd)."""
    n = mesh.size(axis)
    if n == 1:
        return x
    dist = _dist()
    x = x.contiguous()
    out = x.new_empty((n * x.shape[0], *x.shape[1:]))
    _run(mesh, f"all_gather_into_tensor of a {x.device.type} tensor",
         lambda: dist.all_gather_into_tensor(out, x, group=mesh.group(axis)))
    return out


def reduce_scatter_rows(x: torch.Tensor, mesh: Mesh, axis: str = DATA_AXIS) -> torch.Tensor:
    """The sum over ``axis`` of every rank's ``x``, of which this rank keeps
    its block of rows (its place on the axis, of ``size(axis)`` equal
    blocks): one ``reduce_scatter_tensor`` (no autograd)."""
    n = mesh.size(axis)
    if n == 1:
        return x
    dist = _dist()
    x = x.contiguous()
    out = x.new_empty((x.shape[0] // n, *x.shape[1:]))
    _run(mesh, f"reduce_scatter_tensor of a {x.device.type} tensor",
         lambda: dist.reduce_scatter_tensor(out, x, group=mesh.group(axis)))
    return out


def _hop(x: torch.Tensor, mesh: Mesh, step: int, axis: str = DATA_AXIS) -> torch.Tensor:
    """Send ``x`` to rank + step on ``axis``, receive the same shape from
    rank − step."""
    dist = _dist()
    x = x.contiguous()
    rows = x.shape[0]
    n, r = mesh.size(axis), mesh.index(axis)
    send = [0] * n
    recv = [0] * n
    send[(r + step) % n] = rows
    recv[(r - step) % n] = rows
    out = torch.empty_like(x)
    _run(mesh, f"all_to_all_single (one ring hop) of a {x.device.type} tensor",
         lambda: dist.all_to_all_single(out, x, recv, send, group=mesh.group(axis)))
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.rows = mesh, x.shape[0]
        return all_gather_rows(x, mesh)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.mesh.data_rank * ctx.rows
        return g[lo:lo + ctx.rows], None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce_(x.clone(), mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Pvary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.mesh), None


class _RingHop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _hop(x, mesh, 1)

    @staticmethod
    def backward(ctx, g):
        return _hop(g, ctx.mesh, -1), None


def all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Differentiable tiled all-gather whose output is replicated: the
    backward returns the rank's own rows of the (replicated) gradient."""
    return x if mesh.data == 1 else _AllGather.apply(x, mesh)


def psum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Differentiable sum of every rank's ``x``, replicated; the backward
    passes the replicated gradient to each rank's part."""
    return x if mesh.data == 1 else _Psum.apply(x, mesh)


def pvary(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Mark a replicated ``x`` as read by per-rank computations: identity
    forward, and the backward sums the ranks' gradients."""
    if mesh.data == 1 or not isinstance(x, torch.Tensor):
        return x
    return _Pvary.apply(x, mesh)


def ring_hop(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Differentiable ring step: ``x`` goes to rank + 1, rank − 1's comes
    in (the JAX ``ppermute`` with ``perm = [(i, i + 1)]``)."""
    return x if mesh.data == 1 else _RingHop.apply(x, mesh)


def hop(x: torch.Tensor, mesh: Mesh, step: int = 1, axis: str = DATA_AXIS) -> torch.Tensor:
    """One ring step of ``step`` ranks on ``axis`` without autograd (the
    ring losses' own passes, the pipeline's hand-offs)."""
    return x if mesh.size(axis) == 1 else _hop(x, mesh, step, axis)


def all_reduce_gradients(params: Iterable[torch.Tensor], mesh: Mesh,
                         axis: str = DATA_AXIS) -> None:
    """Sum every rank's gradients of ``params`` over ``axis`` in one flat
    bucket, in place: each rank then holds the gradient of the global
    loss.  The gradients must all exist (the step fills missing ones with
    zeros)."""
    grads: List[torch.Tensor] = [p.grad for p in params]
    if mesh.size(axis) == 1 or not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    all_reduce_(flat, mesh, axis=axis)
    offset = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[offset:offset + n].view_as(g))
        offset += n


def digest(tensors: Sequence[torch.Tensor]) -> str:
    """A sha256 of the tensors' bytes, in order: equal on two ranks only if
    every tensor is bit-identical."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().reshape(-1).cpu().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()
