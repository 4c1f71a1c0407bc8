"""Fused multi-head self-attention forward for the CLIP towers.

Port of :mod:`sparsify_clip_tpu.ops.pallas_attention` (``mha_pallas``,
forward only).  The input is the packed in_proj output (B, L, 3W); the
result is the (B, L, W) context.

* :func:`mha_fwd_reference` is the plain PyTorch version: what the TPU
  kernel ``_fwd_kernel`` computes (pallas_attention.py:67-92), with q, k
  and v in fp32, scores scaled by ``head_dim**-0.5``, the causal mask
  ``col > row``, softmax and P·V in fp32, and the context cast back to
  the input type.  It also gives the per-head row LSE, (B, L, H) fp32.
  The JAX einsum path casts P to the compute type before P·V
  (pallas_attention.py:478), so in bf16 the two differ by that rounding.
* :func:`mha_fwd` is the wrapper of the CUDA kernel ``csrc/mha_fwd.cu``.
  A CPU tensor goes to the plain version; a CUDA tensor launches the
  kernel or raises.  There is no fallback from one to the other.
  ``mha_fwd.launches`` counts kernel launches.
* :func:`attention_core` is what the towers call.
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


def mha_fwd_reference(
    qkv: torch.Tensor, heads: int, causal: bool = False, with_lse: bool = False
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch attention forward → (context (B, L, W) in qkv's
    type, LSE (B, L, H) fp32 or None)."""
    b, l, width, head_dim = _split(qkv, heads)
    q, k, v = qkv.float().view(b, l, 3, heads, head_dim).permute(2, 0, 3, 1, 4)
    s = torch.matmul(q, k.transpose(-1, -2)) * (head_dim ** -0.5)  # (B, H, L, L)
    if causal:
        col_gt_row = torch.ones(l, l, dtype=torch.bool, device=qkv.device).triu(1)
        s = s.masked_fill(col_gt_row, float("-inf"))
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
    if qkv.device.type != "cuda":
        raise ValueError(f"mha_fwd runs on cpu or cuda tensors, got {qkv.device}")
    if qkv.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"mha_fwd kernel takes bf16 or fp32, got {qkv.dtype}")
    if head_dim % 8 or head_dim > MAX_HEAD_DIM:
        raise ValueError(
            f"mha_fwd kernel takes head_dim <= {MAX_HEAD_DIM} in multiples of 8, "
            f"got {head_dim}"
        )
    if not qkv.is_contiguous():
        raise ValueError("mha_fwd kernel needs a contiguous qkv")
    if qkv.data_ptr() % 16:
        # the kernel loads 16-byte vectors; a misaligned load faults and
        # poisons the CUDA context, so refuse it here
        raise ValueError("mha_fwd kernel needs a qkv whose data starts on a 16-byte boundary")
    if not 0 < b <= 65535 or l == 0:
        raise ValueError(f"mha_fwd kernel takes 1 <= B <= 65535 and L >= 1, got {b}, {l}")
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
    with _count_lock:
        mha_fwd.launches += 1
    return out, lse


mha_fwd.launches = 0


def attention_core(qkv: torch.Tensor, heads: int, causal: bool = False) -> torch.Tensor:
    """The towers' attention core: packed (B, L, 3W) qkv → (B, L, W)
    context."""
    return mha_fwd(qkv, heads, causal)[0]
