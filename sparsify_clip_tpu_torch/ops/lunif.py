"""Fused uniformity potential with its own backward.

Port of :mod:`sparsify_clip_tpu.ops.pallas_lunif` (``lunif_loss_pallas``
and its custom VJP) and of the single-device route of
:func:`sparsify_clip_tpu.ops.fused.fused_lunif_loss`:

    loss = log( Σ_{i≠j} exp(−t·‖xᵢ − xⱼ‖²) / (N·(N−1)) )

with d² = ‖xᵢ‖² + ‖xⱼ‖² − 2·xᵢ·xⱼ clipped at 0 and the diagonal masked by
index before the sum.

* :func:`lunif_fwd_reference` and :func:`lunif_bwd_reference` are the
  plain PyTorch versions, in fp32, of what the two TPU kernels compute:
  S = Σ_{i≠j} W_ij and the loss (``_fwd_kernel``, pallas_lunif.py:41-65),
  and dx = g·(−4t/S)·(r∘x − Wx) from r = W·1 and Wx (``_bwd_kernel``,
  pallas_lunif.py:91-125, finished as ``_bwd`` :167-171 finishes it).
* :func:`lunif_fwd` and :func:`lunif_bwd` wrap the CUDA kernels of
  ``csrc/lunif.cu``.  A CPU tensor goes to the plain version; a CUDA
  tensor launches the kernel or raises.  Each counts its launches in
  ``.launches``.
* :class:`LunifFunction` gives the loss and the gradient of x (t is a
  constant, as ``nondiff_argnums=(1,)``); :func:`lunif_loss` is what the
  loss dispatch calls.

What bounds the kernels, and what their design does about it, is in the
source's head note: at the train step's (256, 512) both are far below
the card's arithmetic and memory limits.  Both spread tiles of the pair
block over the card (``csrc/pair_tiles.cuh``) and add the tiles' partial
sums in a fixed order in a second launch: the forward takes 16 × 16
tiles of W, with the norms folded into its first pass; the backward
takes 32 × 32 tiles, is bound by shared memory's bandwidth inside each
block and by its two launches.  S
and the incoming gradient stay on the device, so a step never waits on
a host read.  Over several ranks the loss dispatch takes the ring of
``fused.py`` instead (:func:`sparsify_clip_tpu_torch.parallel.dist_losses.ring_lunif_loss`).
"""

from __future__ import annotations

import threading
from typing import Tuple

import torch

from sparsify_clip_tpu_torch.ops import _build
from sparsify_clip_tpu_torch.utils.numerics import fp32_matmul

MAX_DIM = 2048  # the kernels refuse wider rows; the JAX package's callers stay below
_count_lock = threading.Lock()


def _weights(x: torch.Tensor, t: float) -> torch.Tensor:
    """W_ij = exp(−t·d²_ij), 0 on the diagonal, in fp32."""
    # imported here: the losses package imports this module
    from sparsify_clip_tpu_torch.losses.unif import pairwise_sq_dists

    return torch.exp(-t * pairwise_sq_dists(x)).fill_diagonal_(0.0)


def lunif_fwd_reference(x: torch.Tensor, t: float = 2.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain forward → (S, loss), fp32 scalars."""
    n = x.shape[0]
    s = _weights(x, t).sum()
    return s, torch.log(s / (n * (n - 1)))


def lunif_bwd_reference(
    x: torch.Tensor, s: torch.Tensor, g: torch.Tensor, t: float = 2.0
) -> torch.Tensor:
    """Plain backward → dx = g·(−4t/S)·(r∘x − Wx), fp32."""
    w = _weights(x, t)
    x = x.float()
    r = w.sum(1, keepdim=True)
    return g * ((-4.0 * t / s) * (x * r - fp32_matmul(w, x)))


def _check(x: torch.Tensor, *scalars: torch.Tensor) -> Tuple[int, int]:
    """Shape, type and device checks shared by the wrappers → (N, D)."""
    if x.ndim != 2:
        raise ValueError(f"lunif takes x of shape (N, D), got {tuple(x.shape)}")
    n, d = x.shape
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lunif runs on cpu or cuda tensors, got {x.device}")
    if any(s.device != x.device for s in scalars):
        raise ValueError("lunif needs its tensors on one device")
    if x.device.type == "cuda":
        if any(v.dtype != torch.float32 for v in (x, *scalars)):
            raise TypeError("lunif kernels take fp32 tensors")
        if not x.is_contiguous():
            raise ValueError("lunif kernels need a contiguous x")
        if any(s.numel() != 1 for s in scalars):
            raise ValueError("lunif kernels take S and g as one-element tensors")
        if n < 2 or not 0 < d <= MAX_DIM:
            raise ValueError(f"lunif kernels take N >= 2 and 1 <= D <= {MAX_DIM}, got {n}, {d}")
    return n, d


def _count(fn) -> None:
    with _count_lock:
        fn.launches += 1


def lunif_fwd(x: torch.Tensor, t: float = 2.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward: the CUDA kernel for a CUDA tensor, the plain version for a
    CPU tensor → (S, loss).

    On the card S and the loss are views into the call's one buffer, which
    also holds the kernel's scratch (a float a 16 × 16 tile): a saved S
    keeps that buffer alive, and the loss that :class:`LunifFunction`
    returns is a view made inside a custom Function, so an in-place op on
    it raises."""
    n, d = _check(x)
    if x.device.type == "cpu":
        return lunif_fwd_reference(x, t)
    lib = _build.library()
    # one allocation: S, the loss, then the kernel's scratch (its blocks' partial sums)
    buf = torch.empty(2 + lib.sparsify_lunif_fwd_scratch(n, d), dtype=torch.float32,
                      device=x.device)
    base = buf.data_ptr()
    err = _build.launch(
        lib.sparsify_lunif_fwd, x.device, x.data_ptr(), n, d, float(t), base + 8, base, base + 4,
    )
    if err:
        raise RuntimeError(f"lunif_fwd kernel launch failed with CUDA error {err}")
    _count(lunif_fwd)
    return buf[0], buf[1]


def lunif_bwd(x: torch.Tensor, s: torch.Tensor, g: torch.Tensor, t: float = 2.0) -> torch.Tensor:
    """dx: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    n, d = _check(x, s, g)
    if x.device.type == "cpu":
        return lunif_bwd_reference(x, s, g, t)
    s, g = s.contiguous(), g.contiguous()
    lib = _build.library()
    scratch = torch.empty(lib.sparsify_lunif_bwd_scratch(n, d), dtype=torch.float32,
                          device=x.device)
    dx = torch.empty_like(x)
    err = _build.launch(
        lib.sparsify_lunif_bwd, x.device, x.data_ptr(), s.data_ptr(), g.data_ptr(), n, d,
        float(t), scratch.data_ptr(), dx.data_ptr(),
    )
    if err:
        raise RuntimeError(f"lunif_bwd kernel launch failed with CUDA error {err}")
    _count(lunif_bwd)
    return dx


lunif_fwd.launches = 0
lunif_bwd.launches = 0


class LunifFunction(torch.autograd.Function):
    """The fused loss with its own backward, as ``lunif_loss_pallas``'s
    custom VJP (pallas_lunif.py:152-174): the forward saves x and S, the
    backward recomputes W from x."""

    @staticmethod
    def forward(ctx, x, t):
        s, loss = lunif_fwd(x, t)
        ctx.save_for_backward(x, s)
        ctx.t = t
        return loss

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        return lunif_bwd(x, s, g, ctx.t), None


def lunif_loss(x: torch.Tensor, t: float = 2.0) -> torch.Tensor:
    """Uniformity potential of the (N, D) rows of x; numerics-matched to
    :func:`sparsify_clip_tpu_torch.losses.unif.lunif_loss`."""
    return LunifFunction.apply(x.float().contiguous(), float(t))
