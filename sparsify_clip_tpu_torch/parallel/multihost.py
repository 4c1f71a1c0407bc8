"""Multi-process data parallelism on the host side, ported from
:mod:`sparsify_clip_tpu.parallel.multihost`.

The port runs one process per GPU, the torch way:

    torchrun --standalone --nproc_per_node=N -m sparsify_clip_tpu_torch.cli --config ...

* :func:`initialize_distributed` joins the process group, from the
  launcher's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``MASTER_ADDR``/``MASTER_PORT``) or from ``config.multihost`` with its
  rendezvous keys (``coordinator_address``, ``num_processes``,
  ``process_id``); with neither it is a no-op at world 1, as the JAX
  function is.  Each rank takes ``cuda:LOCAL_RANK % device_count``.
* **deterministic partition of the global batch**: every process seeds
  the same global order (:func:`epoch_order`) and takes a disjoint
  contiguous slice of each global batch (:func:`local_batch_indices`);
  the union of the slices is exactly the global batch.
* The JAX ``make_global_batch`` has no counterpart here: the loader
  already hands each rank its slice, which ``train.batch_to_device``
  moves to the rank's device, and the train step sees its rows of the
  global batch (:mod:`sparsify_clip_tpu_torch.parallel.mesh`).

The backend is NCCL on the card and gloo on the CPU; gloo over CUDA
tensors is taken only when the caller passes ``backend="gloo"``.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch

from sparsify_clip_tpu_torch.parallel.mesh import Mesh, all_gather_rows, all_reduce_, create_mesh

_LAUNCHER_KEYS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
BACKENDS = ("nccl", "gloo")


def _dist():
    import torch.distributed as dist

    return dist


def world_size() -> int:
    """The process group's size (1 without one)."""
    dist = _dist()
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank (0 without a process group)."""
    dist = _dist()
    return dist.get_rank() if dist.is_initialized() else 0


def _rank_device(backend: str, local_rank: int) -> torch.device:
    if backend == "nccl" or torch.cuda.is_available():
        if not torch.cuda.is_available():
            raise RuntimeError("the nccl backend needs a CUDA device and none is available")
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
        return device
    return torch.device("cpu")


def initialize_distributed(config=None, backend: Optional[str] = None,
                           timeout_s: float = 600.0) -> Optional[torch.device]:
    """Join the process group; return the rank's device, or None when
    there is nothing to join (world 1, no launcher and no
    ``config.multihost``).  Already joined: the rank's device.

    ``backend`` None takes NCCL where CUDA is available, else gloo;
    ``"gloo"`` on the card moves CUDA tensors through the host (one card
    can hold several ranks that way, NCCL refuses that).  A rank runs on
    ``cuda:LOCAL_RANK % device_count`` when a card is present."""
    dist = _dist()
    if backend is not None and backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if dist.is_initialized():
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        return _rank_device(dist.get_backend(), local)
    env = os.environ
    timeout = datetime.timedelta(seconds=timeout_s)
    if all(k in env for k in _LAUNCHER_KEYS):
        me, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        device = _rank_device(backend, int(env.get("LOCAL_RANK", me)))
        dist.init_process_group(backend, init_method="env://", rank=me, world_size=world,
                                timeout=timeout)
        return device
    if config is None or not getattr(config, "multihost", False):
        return None
    missing = [k for k, unset in (("coordinator_address", not config.coordinator_address),
                                  ("num_processes", config.num_processes <= 0),
                                  ("process_id", config.process_id < 0)) if unset]
    if missing:
        # jax.distributed detects TPU pods, GKE and Slurm; here the launcher does
        raise ValueError(
            f"multihost: true without the launcher's environment needs {', '.join(missing)} "
            "(or start the run under torchrun, which sets RANK, WORLD_SIZE, LOCAL_RANK, "
            "MASTER_ADDR and MASTER_PORT)")
    me = config.process_id
    device = _rank_device(backend, int(env.get("LOCAL_RANK", me)))
    dist.init_process_group(backend, init_method=f"tcp://{config.coordinator_address}",
                            rank=me, world_size=config.num_processes, timeout=timeout)
    return device


def shutdown_distributed() -> None:
    """Leave the process group, if one was joined."""
    dist = _dist()
    if dist.is_initialized():
        dist.destroy_process_group()


def is_primary() -> bool:
    """True on the process that owns host-side side effects (logging,
    plots, weights-npz writes).  Always true single-process."""
    return rank() == 0


def barrier() -> None:
    """Wait for every rank (nothing at world 1)."""
    dist = _dist()
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def _flag_device() -> torch.device:
    dist = _dist()
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def allgather_to_host(x: torch.Tensor, mesh: Optional[Mesh] = None) -> np.ndarray:
    """Every rank's ``x`` stacked along the rows in rank order, as host
    numpy, identical on every rank (a collective: every rank calls it).
    World 1: ``x`` itself."""
    mesh = mesh if mesh is not None else create_mesh()
    if mesh.data == 1:
        return x.detach().cpu().numpy()
    return all_gather_rows(x.detach(), mesh).cpu().numpy()


def any_process_flag(flag: bool) -> bool:
    """Collective OR of a per-process host flag, an all-reduce MAX of an
    int (preemption: one rank's SIGTERM stops every rank at the same step,
    or the others would wait in the next step's collectives).  World 1:
    the flag itself."""
    if world_size() == 1:
        return bool(flag)
    mesh = create_mesh()
    value = torch.tensor([int(bool(flag))], dtype=torch.int32, device=_flag_device())
    return bool(all_reduce_(value, mesh, op="max").item())


def local_batch_indices(
    global_order: np.ndarray,
    batch_index: int,
    global_batch: int,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
) -> np.ndarray:
    """This process's slice of global batch ``batch_index``.

    ``global_order`` is the epoch's (identically-seeded) global
    permutation.  The global batch is split into ``process_count``
    contiguous equal slices; process ``p`` loads the ``p``-th.  Raises
    if the global batch does not divide evenly (ragged per-host batches
    would deadlock collectives).
    """
    process_index = rank() if process_index is None else process_index
    process_count = world_size() if process_count is None else process_count
    if global_batch % process_count:
        raise ValueError(
            f"global batch {global_batch} not divisible by "
            f"{process_count} processes"
        )
    local = global_batch // process_count
    start = batch_index * global_batch + process_index * local
    return np.asarray(global_order[start : start + local])


def epoch_order(
    dataset_len: int, seed: int, epoch: int, shuffle: bool
) -> np.ndarray:
    """The global example order every process derives identically
    (mirrors DataLoader.epoch's seeding)."""
    order = np.arange(dataset_len)
    if shuffle:
        order = np.random.default_rng(
            np.random.SeedSequence([seed, epoch])
        ).permutation(dataset_len)
    return order
