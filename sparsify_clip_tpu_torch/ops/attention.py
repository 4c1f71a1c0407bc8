"""Fused multi-head self-attention for the CLIP towers, forward and
backward.

Port of :mod:`sparsify_clip_tpu.ops.pallas_attention` (``mha_pallas``
and its custom VJP).  The input is the packed in_proj output (B, L, 3W);
the result is the (B, L, W) context.

* :func:`mha_fwd_reference` is the plain PyTorch forward: what the TPU
  kernel ``_fwd_kernel`` computes (pallas_attention.py:67-92), with q, k
  and v in fp32, scores scaled by ``head_dim**-0.5``, the causal mask
  ``col > row``, softmax and P·V in fp32, and the context cast back to
  the input type.  It also gives the per-head row LSE, (B, L, H) fp32.
  The JAX einsum path casts P to the compute type before P·V
  (pallas_attention.py:478), so in bf16 the two differ by that rounding.
* :func:`mha_bwd_reference` is the plain PyTorch backward: what
  ``_bwd_kernel`` computes (pallas_attention.py:95-148), P rebuilt from
  the saved LSE and the softmax backward's row term taken as
  rowsum(dP∘P), all in fp32, dqkv in qkv's type.
* :func:`mha_fwd` and :func:`mha_bwd` wrap the CUDA kernels
  ``csrc/mha_fwd.cu`` and ``csrc/mha_bwd.cu``.  A CPU tensor goes to the
  plain version; a CUDA tensor launches the kernel or raises.  There is
  no fallback from one to the other.  ``mha_fwd.launches`` and
  ``mha_bwd.launches`` count kernel launches.
* The head-group route (:func:`use_head_group`, the JAX package's
  ``_use_per_head``) takes the long sequences: the 577-token
  ViT-L-14-336 vision tower in bf16 and fp32, ViT-L-14's in fp32.  There
  the forward writes no LSE and the backward recomputes the softmax from
  q and k.  :func:`mha_fwd_head_group_reference` and
  :func:`mha_bwd_head_group_reference` are the plain versions of
  ``_fwd_kernel_head_group`` and ``_bwd_kernel_head_group``
  (pallas_attention.py:204-274); :func:`mha_fwd_head_group` and
  :func:`mha_bwd_head_group` wrap ``csrc/mha_head_group.cu`` and count
  their launches the same way.
* :func:`attention_core` is what the towers call, on both devices.  When
  a gradient is wanted it goes through :class:`MhaFunction`, whose
  forward is :func:`mha_fwd` with the LSE and saves qkv and the LSE, and
  whose backward is :func:`mha_bwd`, or, on the head-group route, through
  :class:`MhaHeadGroupFunction`, which saves qkv alone; otherwise
  (serving, eval) it calls the route's forward without the LSE.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import torch

from sparsify_clip_tpu_torch.ops import _build

MAX_HEAD_DIM = 128
_count_lock = threading.Lock()


def _split(qkv: torch.Tensor, heads: int) -> Tuple[int, int, int, int]:
    if qkv.ndim != 3 or qkv.shape[-1] % (3 * heads):
        raise ValueError(
            f"expected packed qkv (B, L, 3*W) with W divisible by heads={heads}, "
            f"got {tuple(qkv.shape)}"
        )
    b, l, w3 = qkv.shape
    return b, l, w3 // 3, w3 // (3 * heads)


def _check_kernel_qkv(name: str, qkv: torch.Tensor, head_dim: int) -> None:
    """What every attention kernel takes: a CUDA tensor, bf16 or fp32,
    contiguous, 1 <= B <= 65535 and L >= 1, head_dim <= 128 in multiples
    of 8.  (A CPU tensor takes the plain version before this check.)"""
    b, l = qkv.shape[:2]
    if qkv.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda tensors, got {qkv.device}")
    if qkv.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name} kernel takes bf16 or fp32, got {qkv.dtype}")
    if head_dim % 8 or head_dim > MAX_HEAD_DIM:
        raise ValueError(
            f"{name} kernel takes head_dim <= {MAX_HEAD_DIM} in multiples of 8, got {head_dim}"
        )
    if not qkv.is_contiguous():
        raise ValueError(f"{name} kernel needs a contiguous qkv")
    if not 0 < b <= 65535 or l == 0:
        raise ValueError(f"{name} kernel takes 1 <= B <= 65535 and L >= 1, got {b}, {l}")


def _check_kernel_dout(name: str, qkv: torch.Tensor, dout: torch.Tensor) -> None:
    """The backward kernels take dout (B, L, W), contiguous, in qkv's type
    and on qkv's device."""
    b, l, w3 = qkv.shape
    if dout.dtype != qkv.dtype:
        raise TypeError(
            f"{name} kernel takes dout in qkv's type, got {dout.dtype} for {qkv.dtype} qkv")
    if tuple(dout.shape) != (b, l, w3 // 3):
        raise ValueError(
            f"{name} kernel takes dout (B, L, W), got {tuple(dout.shape)} "
            f"for qkv {tuple(qkv.shape)}"
        )
    if dout.device != qkv.device:
        raise ValueError(f"{name} kernel needs qkv and dout on one device")
    if not dout.is_contiguous():
        raise ValueError(f"{name} kernel needs a contiguous dout")


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x``, or a copy of it when its data does not start on a 16-byte
    boundary: the bf16 backward kernels stage 16-byte vectors with
    cp.async, and a contiguous view may start mid-vector."""
    return x.clone() if x.data_ptr() % 16 else x


def _count(fn) -> None:
    with _count_lock:
        fn.launches += 1


def _scores(qkv: torch.Tensor, heads: int, causal: bool):
    """q, k, v (B, H, L, D) fp32, the scaled and masked scores S (B, H, L,
    L) fp32, and the scale."""
    b, l, _, head_dim = _split(qkv, heads)
    scale = head_dim ** -0.5
    q, k, v = qkv.float().view(b, l, 3, heads, head_dim).permute(2, 0, 3, 1, 4)
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if causal:
        col_gt_row = torch.ones(l, l, dtype=torch.bool, device=qkv.device).triu(1)
        s = s.masked_fill(col_gt_row, float("-inf"))
    return q, k, v, s, scale


def mha_fwd_reference(
    qkv: torch.Tensor, heads: int, causal: bool = False, with_lse: bool = False
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch attention forward → (context (B, L, W) in qkv's
    type, LSE (B, L, H) fp32 or None)."""
    b, l, width, _ = _split(qkv, heads)
    _, _, v, s, _ = _scores(qkv, heads, causal)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    denom = e.sum(dim=-1, keepdim=True)
    ctx = torch.matmul(e / denom, v)  # (B, H, L, D) fp32
    out = ctx.transpose(1, 2).reshape(b, l, width).to(qkv.dtype)
    lse = None
    if with_lse:
        lse = (m + torch.log(denom))[..., 0].transpose(1, 2).contiguous()
    return out, lse


def mha_fwd(
    qkv: torch.Tensor, heads: int, causal: bool = False, with_lse: bool = False
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Attention forward: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor.  Same results as :func:`mha_fwd_reference`.

    The kernel takes bf16 or fp32, a contiguous (B, L, 3W) qkv and a
    head_dim that is a multiple of 8 and at most 128."""
    b, l, width, head_dim = _split(qkv, heads)
    if qkv.device.type == "cpu":
        return mha_fwd_reference(qkv, heads, causal, with_lse)
    _check_kernel_qkv("mha_fwd", qkv, head_dim)
    if qkv.data_ptr() % 16:
        # the kernel loads 16-byte vectors; a misaligned load faults and
        # poisons the CUDA context, so refuse it here
        raise ValueError("mha_fwd kernel needs a qkv whose data starts on a 16-byte boundary")
    out = torch.empty((b, l, width), dtype=qkv.dtype, device=qkv.device)
    lse = (
        torch.empty((b, l, heads), dtype=torch.float32, device=qkv.device)
        if with_lse else None
    )
    lib = _build.library()
    # the launch goes to the current device's context: make it qkv's
    with torch.cuda.device(qkv.device):
        err = lib.sparsify_mha_fwd(
            qkv.data_ptr(), out.data_ptr(), None if lse is None else lse.data_ptr(),
            b, l, heads, head_dim, int(causal), int(qkv.dtype == torch.bfloat16),
            head_dim ** -0.5, torch.cuda.current_stream(qkv.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"mha_fwd kernel launch failed with CUDA error {err}")
    _count(mha_fwd)
    return out, lse


mha_fwd.launches = 0


def mha_bwd_reference(
    qkv: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, heads: int, causal: bool = False
) -> torch.Tensor:
    """Plain PyTorch attention backward → dqkv (B, L, 3W) in qkv's type,
    from qkv, the forward's LSE (B, L, H) and dout (B, L, W)."""
    q, k, v, s, scale = _scores(qkv, heads, causal)
    p = torch.exp(s - lse.float().transpose(1, 2).unsqueeze(-1))
    return _softmax_bwd(qkv, dout, q, k, v, p, scale)


def _softmax_bwd(qkv, dout, q, k, v, p, scale) -> torch.Tensor:
    """Packed dqkv in qkv's type from P (B, H, L, L) fp32: dV = P^T.dO,
    dS = P∘(dP − rowsum(dP∘P)), dQ = dS.K·s, dK = dS^T.Q·s."""
    b, heads, l, head_dim = q.shape
    width = heads * head_dim
    do = dout.float().reshape(b, l, heads, head_dim).transpose(1, 2)  # (B, H, L, D)
    dv = torch.matmul(p.transpose(-1, -2), do)
    dp = torch.matmul(do, v.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = torch.matmul(ds, k) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q) * scale
    dqkv = torch.stack([dq, dk, dv])  # (3, B, H, L, D)
    return dqkv.permute(1, 3, 0, 2, 4).reshape(b, l, 3 * width).to(qkv.dtype)


def mha_bwd(
    qkv: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, heads: int, causal: bool = False
) -> torch.Tensor:
    """Attention backward: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  Same result as :func:`mha_bwd_reference`.

    The kernel takes bf16 or fp32 (dout in qkv's type), contiguous
    tensors, a head_dim that is a multiple of 8 and at most 128, and any
    L: it walks queries and keys in tiles (64 and 32 rows in bf16, on the
    tensor cores; 32 in fp32) and masks the ragged last one.  A view that
    starts off a 16-byte boundary is copied first."""
    b, l, width, head_dim = _split(qkv, heads)
    if qkv.device.type == "cpu":
        return mha_bwd_reference(qkv, lse, dout, heads, causal)
    _check_kernel_qkv("mha_bwd", qkv, head_dim)
    _check_kernel_dout("mha_bwd", qkv, dout)
    if lse.dtype != torch.float32 or tuple(lse.shape) != (b, l, heads):
        raise TypeError(f"mha_bwd kernel takes an fp32 lse (B, L, H), got {lse.dtype} "
                        f"{tuple(lse.shape)} for qkv {tuple(qkv.shape)}")
    if lse.device != qkv.device or not lse.is_contiguous():
        raise ValueError("mha_bwd kernel needs a contiguous lse on qkv's device")
    qkv, dout = _aligned(qkv), _aligned(dout)
    dqkv = torch.empty_like(qkv)
    drow = torch.empty((b, heads, l), dtype=torch.float32, device=qkv.device)
    lib = _build.library()
    with torch.cuda.device(qkv.device):
        err = lib.sparsify_mha_bwd(
            qkv.data_ptr(), lse.data_ptr(), dout.data_ptr(), dqkv.data_ptr(), drow.data_ptr(),
            b, l, heads, head_dim, int(causal), int(qkv.dtype == torch.bfloat16),
            head_dim ** -0.5, torch.cuda.current_stream(qkv.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"mha_bwd kernel launch failed with CUDA error {err}")
    _count(mha_bwd)
    return dqkv


mha_bwd.launches = 0


class MhaFunction(torch.autograd.Function):
    """Attention with its own backward, as ``mha_pallas``'s custom VJP:
    the forward saves qkv and the row LSE, the backward rebuilds P from
    them (pallas_attention.py:343-386)."""

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, heads: int, causal: bool) -> torch.Tensor:
        out, lse = mha_fwd(qkv, heads, causal, with_lse=True)
        ctx.save_for_backward(qkv, lse)
        ctx.heads, ctx.causal = heads, causal
        return out

    @staticmethod
    def backward(ctx, dout: torch.Tensor):
        qkv, lse = ctx.saved_tensors
        # autograd may hand over a strided view; the kernel wants rows
        dout = dout.to(qkv.dtype).contiguous()
        return mha_bwd(qkv, lse, dout, ctx.heads, ctx.causal), None, None


# The JAX package's budget for one sample's packed qkv block on its
# whole-width route (pallas_attention.py:151)
_QKV_BUDGET = 3 * 1024 * 1024


def use_head_group(l: int, w3: int, itemsize: int, heads: int) -> bool:
    """Whether attention over a packed (·, l, w3) qkv of ``itemsize``-byte
    elements takes the head-group route: the JAX package's
    ``_use_per_head`` (pallas_attention.py:172-190), term for term.

    Over the 3 MB budget (strictly) and with a head_dim that packs into
    128 lanes (a multiple of 128, or a divisor of 128 with the width a
    multiple of 128); an over-budget tower whose head_dim does not pack
    (88) stays on the whole-width route.  On the TPU this is a memory
    limit of the kernel stack.  On the GPU it is a routing decision that
    the port mirrors so that each shape has the JAX side's route, saved
    residuals (no LSE here) and softmax arithmetic (P = e / sum(e))."""
    width = w3 // 3
    head_dim = width // heads
    if l * w3 * itemsize <= _QKV_BUDGET:
        return False
    if head_dim % 128 == 0:
        return True
    return 128 % head_dim == 0 and width % 128 == 0


def mha_fwd_head_group_reference(
    qkv: torch.Tensor, heads: int, causal: bool = False
) -> torch.Tensor:
    """Plain PyTorch forward of the head-group route → context (B, L, W)
    in qkv's type, no LSE: what ``_fwd_kernel_head_group`` computes
    (pallas_attention.py:204-225), m = max(s), e = exp(s − m), P = e /
    sum(e) and P·V in fp32, the same arithmetic as the whole-width
    forward's context."""
    return mha_fwd_reference(qkv, heads, causal)[0]


def mha_fwd_head_group(qkv: torch.Tensor, heads: int, causal: bool = False) -> torch.Tensor:
    """Head-group attention forward: the CUDA kernel
    (``csrc/mha_head_group.cu``) for a CUDA tensor, the plain version for
    a CPU tensor.  Takes what :func:`mha_fwd` takes; writes no LSE."""
    b, l, width, head_dim = _split(qkv, heads)
    if qkv.device.type == "cpu":
        return mha_fwd_head_group_reference(qkv, heads, causal)
    _check_kernel_qkv("mha_fwd_head_group", qkv, head_dim)
    if qkv.data_ptr() % 16:
        # cp.async copies 16-byte vectors
        raise ValueError(
            "mha_fwd_head_group kernel needs a qkv whose data starts on a 16-byte boundary")
    out = torch.empty((b, l, width), dtype=qkv.dtype, device=qkv.device)
    lib = _build.library()
    with torch.cuda.device(qkv.device):
        err = lib.sparsify_mha_fwd_head_group(
            qkv.data_ptr(), out.data_ptr(), b, l, heads, head_dim, int(causal),
            int(qkv.dtype == torch.bfloat16), head_dim ** -0.5,
            torch.cuda.current_stream(qkv.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"mha_fwd_head_group kernel launch failed with CUDA error {err}")
    _count(mha_fwd_head_group)
    return out


mha_fwd_head_group.launches = 0


def mha_bwd_head_group_reference(
    qkv: torch.Tensor, dout: torch.Tensor, heads: int, causal: bool = False
) -> torch.Tensor:
    """Plain PyTorch backward of the head-group route → dqkv (B, L, 3W) in
    qkv's type, from qkv and dout alone: what ``_bwd_kernel_head_group``
    computes (pallas_attention.py:228-274).  The softmax is rebuilt from
    q·k as m = max(s), e = exp(s − m), P = e / sum(e) (no saved LSE, no
    exp(s − lse)); then dS = P∘(dP − rowsum(dP∘P)), dQ and dK scaled by
    head_dim**-0.5, and dV, all in fp32."""
    q, k, v, s, scale = _scores(qkv, heads, causal)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return _softmax_bwd(qkv, dout, q, k, v, e / e.sum(dim=-1, keepdim=True), scale)


def mha_bwd_head_group(
    qkv: torch.Tensor, dout: torch.Tensor, heads: int, causal: bool = False
) -> torch.Tensor:
    """Head-group attention backward: the CUDA kernels for CUDA tensors
    (dQ, whose first sweep recomputes each row's max, sum and
    rowsum(dP∘P), then dK/dV; one launch of the entry point, counted
    once), the plain version for CPU tensors.  Takes what :func:`mha_bwd`
    takes, without an LSE."""
    b, l, width, head_dim = _split(qkv, heads)
    if qkv.device.type == "cpu":
        return mha_bwd_head_group_reference(qkv, dout, heads, causal)
    _check_kernel_qkv("mha_bwd_head_group", qkv, head_dim)
    _check_kernel_dout("mha_bwd_head_group", qkv, dout)
    qkv, dout = _aligned(qkv), _aligned(dout)
    dqkv = torch.empty_like(qkv)
    row_max = torch.empty((b, l, heads), dtype=torch.float32, device=qkv.device)
    row_sum = torch.empty_like(row_max)
    drow = torch.empty((b, heads, l), dtype=torch.float32, device=qkv.device)
    lib = _build.library()
    with torch.cuda.device(qkv.device):
        err = lib.sparsify_mha_bwd_head_group(
            qkv.data_ptr(), dout.data_ptr(), dqkv.data_ptr(), row_max.data_ptr(),
            row_sum.data_ptr(), drow.data_ptr(), b, l, heads, head_dim, int(causal),
            int(qkv.dtype == torch.bfloat16), head_dim ** -0.5,
            torch.cuda.current_stream(qkv.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"mha_bwd_head_group kernel launch failed with CUDA error {err}")
    _count(mha_bwd_head_group)
    return dqkv


mha_bwd_head_group.launches = 0


class MhaHeadGroupFunction(torch.autograd.Function):
    """Attention on the head-group route with its own backward, as
    ``mha_pallas``'s custom VJP takes it there: the forward saves qkv
    alone (no LSE residual), the backward recomputes the softmax
    (pallas_attention.py:343-369)."""

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, heads: int, causal: bool) -> torch.Tensor:
        out = mha_fwd_head_group(qkv, heads, causal)
        ctx.save_for_backward(qkv)
        ctx.heads, ctx.causal = heads, causal
        return out

    @staticmethod
    def backward(ctx, dout: torch.Tensor):
        (qkv,) = ctx.saved_tensors
        dout = dout.to(qkv.dtype).contiguous()
        return mha_bwd_head_group(qkv, dout, ctx.heads, ctx.causal), None, None


def attention_core(qkv: torch.Tensor, heads: int, causal: bool = False) -> torch.Tensor:
    """The towers' attention core: packed (B, L, 3W) qkv → (B, L, W)
    context.  Long sequences (:func:`use_head_group`) take the head-group
    pair through :class:`MhaHeadGroupFunction`, the rest the whole-width
    pair through :class:`MhaFunction`.  Without a gradient to take, the
    route's forward runs alone and no LSE is written."""
    grad = torch.is_grad_enabled() and qkv.requires_grad
    if use_head_group(qkv.shape[1], qkv.shape[2], qkv.element_size(), heads):
        if grad:
            return MhaHeadGroupFunction.apply(qkv, heads, causal)
        return mha_fwd_head_group(qkv, heads, causal)
    if grad:
        return MhaFunction.apply(qkv, heads, causal)
    return mha_fwd(qkv, heads, causal)[0]
