"""The data-parallel mesh and its collectives, ported from the ``data``
axis of :mod:`sparsify_clip_tpu.parallel.mesh` (mesh.py:36-65, 183-186).

The JAX package runs one global-view program over a ('data', 'model')
device mesh and lets XLA insert the collectives.  The port runs one
process per GPU (``torchrun``); :class:`Mesh` describes that process
group: ``data`` is the world size, ``rank`` the process's place on the
data axis, and rank ``r`` holds rows ``[r·b, (r+1)·b)`` of every global
batch of ``W·b`` rows.  The ``model`` axis (tensor parallelism, GPipe
stages, FSDP and ZeRO-1) waits for ROADMAP Queue 1, 'Multi-GPU'.

Every rank computes the same global loss.  The collectives below follow
the JAX transposition rules of a ``shard_map`` with ``check_vma`` on, so
that autograd on each rank leaves the gradient of that one loss with
respect to the rank's own inputs:

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

The model's parameters are replicated and each rank's encoders see only
its rows, so each rank's parameter gradients are its share of the total:
:func:`all_reduce_gradients` sums them once a step (one flat bucket).
Replicated scalars that only the loss reads (the temperature, SigLIP's
scale and bias) already hold their complete gradient on every rank and
are left out of it.

A backend that refuses a collective raises :class:`RuntimeError` naming
the backend and the collective; nothing falls back.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable, List, Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The data axis over the default process group: ``data`` ranks, this
    process at ``rank``; ``backend`` is the group's (None without a
    process group).  The 'model' axis is 1."""

    data: int = 1
    rank: int = 0
    backend: Optional[str] = None

    def local_batch(self, global_batch: int) -> int:
        """The rows of a global batch that this rank holds."""
        if global_batch % self.data:
            raise ValueError(f"global batch {global_batch} not divisible by "
                             f"{self.data} processes")
        return global_batch // self.data

    def batch_slice(self, global_batch: int) -> slice:
        """This rank's rows of a global batch (the JAX ``P('data')``)."""
        b = self.local_batch(global_batch)
        return slice(self.rank * b, (self.rank + 1) * b)


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def create_mesh(data: int = -1, model: int = 1) -> Mesh:
    """The mesh over the default process group (world 1 without one).
    ``data`` −1 is the world size; any other value must equal it.
    ``model`` > 1 is not ported."""
    dist = _dist()
    world = dist.get_world_size() if dist is not None else 1
    rank = dist.get_rank() if dist is not None else 0
    if model < 1:
        raise ValueError(f"model axis must be >= 1, got {model}")
    if model > 1:
        raise NotImplementedError(
            f"mesh_model={model} (the mesh's 'model' axis: tensor parallelism and GPipe "
            "stages) is not ported to sparsify_clip_tpu_torch yet (ROADMAP Queue 1, "
            "'Multi-GPU')")
    if data == -1:
        data = world
    if data != world:
        raise ValueError(f"mesh data={data} does not match the process group's world size "
                         f"{world}: each rank is one place on the data axis")
    backend = dist.get_backend() if dist is not None else None
    return Mesh(data=data, rank=rank, backend=backend)


def _run(mesh: Mesh, what: str, fn: Callable[[], Any]) -> Any:
    """Run one collective; a backend that refuses it raises by name."""
    try:
        return fn()
    except (RuntimeError, ValueError, NotImplementedError) as exc:
        raise RuntimeError(f"the {mesh.backend} backend refused {what}: {exc}") from exc


def all_reduce_(x: torch.Tensor, mesh: Mesh, op: str = "sum") -> torch.Tensor:
    """In-place all-reduce (``sum`` or ``max``) of ``x`` over the data axis."""
    if mesh.data == 1:
        return x
    dist = _dist()
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    _run(mesh, f"all_reduce({op}) of a {x.device.type} tensor",
         lambda: dist.all_reduce(x, op=red))
    return x


def all_gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``x`` stacked along the rows, rank order (no autograd)."""
    if mesh.data == 1:
        return x
    dist = _dist()
    x = x.contiguous()
    out = x.new_empty((mesh.data * x.shape[0], *x.shape[1:]))
    _run(mesh, f"all_gather_into_tensor of a {x.device.type} tensor",
         lambda: dist.all_gather_into_tensor(out, x))
    return out


def _hop(x: torch.Tensor, mesh: Mesh, step: int) -> torch.Tensor:
    """Send ``x`` to rank + step, receive the same shape from rank − step."""
    dist = _dist()
    x = x.contiguous()
    rows = x.shape[0]
    send = [0] * mesh.data
    recv = [0] * mesh.data
    send[(mesh.rank + step) % mesh.data] = rows
    recv[(mesh.rank - step) % mesh.data] = rows
    out = torch.empty_like(x)
    _run(mesh, f"all_to_all_single (one ring hop) of a {x.device.type} tensor",
         lambda: dist.all_to_all_single(out, x, recv, send))
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.rows = mesh, x.shape[0]
        return all_gather_rows(x, mesh)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.mesh.rank * ctx.rows
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


def hop(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """One ring step without autograd (the ring losses' own passes)."""
    return x if mesh.data == 1 else _hop(x, mesh, 1)


def all_reduce_gradients(params: Iterable[torch.Tensor], mesh: Mesh) -> None:
    """Sum every rank's gradients of ``params`` in one flat bucket, in
    place: each rank then holds the gradient of the global loss.  The
    gradients must all exist (the step fills missing ones with zeros)."""
    if mesh.data == 1:
        return
    grads: List[torch.Tensor] = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    all_reduce_(flat, mesh)
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
