"""LayerNorm fused into the qkv projection, with the unfused path's
backward.

Port of :mod:`sparsify_clip_tpu.ops.pallas_ln_qkv` (``ln_qkv_pallas``
and its custom VJP).  In the pre-LN block the only consumer of ``ln_1``
is the packed in_proj, so the forward computes

    qkv = LN_fp32(x) · Wᵀ + b

in one kernel, with the normalized rows kept on chip.

* :func:`ln_qkv_reference` is the plain PyTorch version, term for term
  the JAX twin ``ln_qkv_reference`` (pallas_ln_qkv.py:109-118): the fp32
  mean and the **fast variance** E[x²] − E[x]², not clipped at 0 (the
  TPU kernel's; flax's ``LayerNorm`` takes it too, clipped; the port's
  unfused :class:`~sparsify_clip_tpu_torch.models.layers.LayerNorm`
  calls ``F.layer_norm``, whose variance has no such cancellation, so
  the two drift apart on rows with a large |mean|/std), ``rsqrt(var + eps)``,
  the LayerNorm scale and bias in fp32, the rows cast to x's type and
  then to ``dtype``, one product in ``dtype`` with the weight cast to
  it, rounded, and the bias added in ``dtype``: two roundings, as the
  TPU kernel's ``dot(...).astype(dtype) + kb``.  The weight is open_clip's
  ``in_proj_weight``, (3W, W); the JAX kernel's is its transpose.
* :func:`ln_qkv_fwd` wraps the CUDA kernel ``csrc/ln_qkv.cu``.  A CPU
  tensor goes to the plain version; a CUDA tensor launches the kernel or
  raises.  ``ln_qkv_fwd.launches`` counts launches.
* :func:`row_stats_reference` is the plain version of the kernels'
  row-statistics pass: each row's fp32 mean and rstd = rsqrt(E[x²] −
  E[x]² + eps), the twin's (pallas_ln_qkv.py:111-113).
* :func:`ln_fast_bwd` wraps the backward's LayerNorm kernel (same
  source): from x and dy = dL/dy it gives the normalized rows y again
  (for dW), dx, dscale and dbias in one pass a row.  Its plain version
  :func:`ln_fast_bwd_reference` is autograd through the fast-variance
  LayerNorm.  ``ln_fast_bwd.launches`` counts launches.
* :class:`LnQkvFunction` is the forward kernel with the JAX twin's
  gradient (pallas_ln_qkv.py:126-140): it saves x, the LayerNorm scale
  and bias, the weight and the bias, and its backward recomputes only the
  normalized rows.  XLA drops the twin's forward product inside
  ``jax.vjp``; eager PyTorch would not, so the backward is written out:
  dy = g·W in ``dtype``, then :func:`ln_fast_bwd` (y, dx, dscale and
  dbias), then dW = gᵀ·y and db = Σ g in ``dtype``.
* :func:`ln_qkv_core` is what the blocks call: through
  :class:`LnQkvFunction` when a gradient is wanted, else (serving, eval,
  export) the forward alone as the custom op :func:`ln_qkv_fwd_op`
  (``sparsify_clip::ln_qkv_fwd``; the plain version on the CPU, the
  kernel on CUDA).
"""

from __future__ import annotations

import threading
from typing import Optional

import torch

from sparsify_clip_tpu_torch.ops import _build

MAX_WIDTH = 1664  # ViT-bigG's; the bf16 kernel keeps the LayerNorm's scale and bias in shared memory
_count_lock = threading.Lock()


def _mean_and_fast_var(x32: torch.Tensor):
    """Each row's mean and E[x²] − E[x]² (not clipped at 0), fp32."""
    mean = x32.mean(-1, keepdim=True)
    return mean, (x32 * x32).mean(-1, keepdim=True) - mean * mean


def row_stats_reference(x2d: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Plain version of the kernels' row-statistics pass: (N, 2) fp32,
    each row's mean and rsqrt(E[x²] − E[x]² + eps)."""
    mean, var = _mean_and_fast_var(x2d.float())
    return torch.cat([mean, torch.rsqrt(var + eps)], dim=-1)


def _layer_norm_fast(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     eps: float) -> torch.Tensor:
    """fp32 LayerNorm over the last axis with the variance E[x²] − E[x]²."""
    x32 = x.float()
    mean, var = _mean_and_fast_var(x32)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return y * scale.float() + bias.float()


def _normalized_rows(x2d, scale, bias, eps, dtype) -> torch.Tensor:
    """The product's left operand: fp32 LayerNorm, cast to x's type, then
    to ``dtype``."""
    return _layer_norm_fast(x2d, scale, bias, eps).to(x2d.dtype).to(dtype)


def ln_qkv_reference(x2d: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     weight: torch.Tensor, kbias: torch.Tensor, eps: float = 1e-5,
                     dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain PyTorch fused LN+qkv → (N, C) in ``dtype`` (x's type by
    default), from x (N, W), the LayerNorm's scale and bias (W,), the
    in_proj weight (C, W) and bias (C,): C = 3W, or under tensor
    parallelism a rank's 3W / tp."""
    dtype = dtype or x2d.dtype
    y = _normalized_rows(x2d, scale, bias, eps, dtype)
    return torch.matmul(y, weight.to(dtype).t()) + kbias.to(dtype)


def _count(fn) -> None:
    with _count_lock:
        fn.launches += 1


def _check_aligned(what: str, *tensors) -> None:
    if any(t.data_ptr() % 16 for t in tensors):
        # 16-byte vector loads and TMA; a misaligned one faults
        raise ValueError(f"{what} kernel needs tensors whose data starts on a 16-byte boundary")


def _check_kernel(x2d, scale, bias, weight, kbias, dtype) -> None:
    """What the kernel takes (a CPU tensor takes the plain version before
    this check): CUDA tensors on one device, x (N, W) contiguous in
    ``dtype``, bf16 or fp32, N >= 1, W a multiple of 8 up to
    :data:`MAX_WIDTH`, the weight (C, W) with C a multiple of 8 (3W, or a
    tensor-parallel rank's 3W / tp) and the biases to match."""
    if x2d.device.type != "cuda":
        raise ValueError(f"ln_qkv_fwd runs on cpu or cuda tensors, got {x2d.device}")
    if any(t.device != x2d.device for t in (scale, bias, weight, kbias)):
        raise ValueError("ln_qkv_fwd kernel needs its tensors on one device")
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"ln_qkv_fwd kernel takes bf16 or fp32, got {dtype}")
    if x2d.dtype != dtype:
        raise TypeError(f"ln_qkv_fwd kernel takes x in the output's type, got {x2d.dtype} "
                        f"for {dtype}")
    if x2d.ndim != 2:
        raise ValueError(f"ln_qkv_fwd takes x of shape (N, W), got {tuple(x2d.shape)}")
    n, w = x2d.shape
    if n == 0 or w % 8 or not 0 < w <= MAX_WIDTH:
        raise ValueError(f"ln_qkv_fwd kernel takes N >= 1 and W a multiple of 8 up to "
                         f"{MAX_WIDTH}, got {tuple(x2d.shape)}")
    cols = weight.shape[0] if weight.ndim == 2 else 0
    if tuple(weight.shape) != (cols, w) or cols == 0 or cols % 8 or \
            tuple(kbias.shape) != (cols,) or tuple(scale.shape) != (w,) or \
            tuple(bias.shape) != (w,):
        raise ValueError(
            f"ln_qkv_fwd takes scale and bias ({w},), weight (C, {w}) and kbias (C,) with C "
            f"a multiple of 8, got {tuple(scale.shape)}, {tuple(bias.shape)}, "
            f"{tuple(weight.shape)}, {tuple(kbias.shape)}")
    if not x2d.is_contiguous():
        raise ValueError("ln_qkv_fwd kernel needs a contiguous x")
    _check_aligned("ln_qkv_fwd", x2d)


def ln_qkv_fwd(x2d: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               weight: torch.Tensor, kbias: torch.Tensor, eps: float = 1e-5,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Fused LN+qkv forward: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor.  Same result as :func:`ln_qkv_reference`.

    The weight and bias are cast to ``dtype`` here, before the launch (the
    JAX side casts them in XLA too, pallas_ln_qkv.py:103-104); the
    LayerNorm's scale and bias are read in fp32."""
    dtype = dtype or x2d.dtype
    if x2d.device.type == "cpu":
        return ln_qkv_reference(x2d, scale, bias, weight, kbias, eps, dtype)
    _check_kernel(x2d, scale, bias, weight, kbias, dtype)
    n, w = x2d.shape
    w_c = weight.to(dtype).contiguous()
    kb = kbias.to(dtype).contiguous()
    sc, bi = scale.float().contiguous(), bias.float().contiguous()
    _check_aligned("ln_qkv_fwd", w_c, kb, sc, bi)
    cols = w_c.shape[0]
    out = torch.empty((n, cols), dtype=dtype, device=x2d.device)
    stats = torch.empty((n, 2), dtype=torch.float32, device=x2d.device)
    lib = _build.library()
    with torch.cuda.device(x2d.device):
        err = lib.sparsify_ln_qkv_fwd(
            x2d.data_ptr(), sc.data_ptr(), bi.data_ptr(), w_c.data_ptr(), kb.data_ptr(),
            out.data_ptr(), stats.data_ptr(), n, w, cols, float(eps),
            int(dtype == torch.bfloat16),
            torch.cuda.current_stream(x2d.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"ln_qkv_fwd kernel launch failed with CUDA error {err}")
    _count(ln_qkv_fwd)
    return out


ln_qkv_fwd.launches = 0


def ln_fast_bwd_reference(x2d: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor,
                          bias: torch.Tensor, eps: float = 1e-5,
                          dtype: Optional[torch.dtype] = None):
    """Plain version of the backward's LayerNorm: the normalized rows y =
    :func:`_normalized_rows` in ``dtype`` and, by autograd through them
    against dy (N, W) in ``dtype``, dx (x's type), dscale and dbias
    (their parameters' types) → (y, dx, dscale, dbias)."""
    dtype = dtype or x2d.dtype
    leaves = [t.detach().requires_grad_(True) for t in (x2d, scale, bias)]
    with torch.enable_grad():
        y = _normalized_rows(*leaves, eps, dtype)
    dx, dscale, dbias = torch.autograd.grad(y, leaves, dy)
    return y.detach(), dx, dscale, dbias


def _check_bwd_kernel(x2d, dy, scale, bias, dtype) -> None:
    """What the backward kernel takes: the forward kernel's x, scale and
    bias, and dy (N, W) contiguous in ``dtype``, all on 16-byte
    boundaries."""
    if x2d.device.type != "cuda":
        raise ValueError(f"ln_fast_bwd runs on cpu or cuda tensors, got {x2d.device}")
    if any(t.device != x2d.device for t in (dy, scale, bias)):
        raise ValueError("ln_fast_bwd kernel needs its tensors on one device")
    if dtype not in (torch.bfloat16, torch.float32) or x2d.dtype != dtype or dy.dtype != dtype:
        raise TypeError(f"ln_fast_bwd kernel takes x and dy in one type, bf16 or fp32, got "
                        f"{x2d.dtype} and {dy.dtype} for {dtype}")
    if x2d.ndim != 2 or dy.shape != x2d.shape:
        raise ValueError(f"ln_fast_bwd takes x and dy of one shape (N, W), got "
                         f"{tuple(x2d.shape)} and {tuple(dy.shape)}")
    n, w = x2d.shape
    if n == 0 or w % 8 or not 0 < w <= MAX_WIDTH:
        raise ValueError(f"ln_fast_bwd kernel takes N >= 1 and W a multiple of 8 up to "
                         f"{MAX_WIDTH}, got {tuple(x2d.shape)}")
    if tuple(scale.shape) != (w,) or tuple(bias.shape) != (w,):
        raise ValueError(f"ln_fast_bwd takes scale and bias ({w},), got "
                         f"{tuple(scale.shape)}, {tuple(bias.shape)}")
    if not (x2d.is_contiguous() and dy.is_contiguous()):
        raise ValueError("ln_fast_bwd kernel needs a contiguous x and dy")
    _check_aligned("ln_fast_bwd", x2d, dy)


def ln_fast_bwd(x2d: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float = 1e-5, dtype: Optional[torch.dtype] = None):
    """The backward's LayerNorm: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor.  Same result as
    :func:`ln_fast_bwd_reference`: (y, dx, dscale, dbias).

    The kernel reduces its fp32 dscale and dbias over the rows in a fixed
    order (no atomics), so two runs agree bit for bit."""
    dtype = dtype or x2d.dtype
    if x2d.device.type == "cpu":
        return ln_fast_bwd_reference(x2d, dy, scale, bias, eps, dtype)
    _check_bwd_kernel(x2d, dy, scale, bias, dtype)
    n, w = x2d.shape
    sc, bi = scale.float().contiguous(), bias.float().contiguous()
    _check_aligned("ln_fast_bwd", sc, bi)
    y, dx = torch.empty_like(x2d), torch.empty_like(x2d)
    lib = _build.library()
    partial = torch.empty(lib.sparsify_ln_fast_bwd_scratch(n, w), dtype=torch.float32,
                          device=x2d.device)
    dscale_dbias = torch.empty(2 * w, dtype=torch.float32, device=x2d.device)
    with torch.cuda.device(x2d.device):
        err = lib.sparsify_ln_fast_bwd(
            x2d.data_ptr(), dy.data_ptr(), sc.data_ptr(), bi.data_ptr(), y.data_ptr(),
            dx.data_ptr(), partial.data_ptr(), dscale_dbias.data_ptr(), n, w, float(eps),
            int(dtype == torch.bfloat16), torch.cuda.current_stream(x2d.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"ln_fast_bwd kernel launch failed with CUDA error {err}")
    _count(ln_fast_bwd)
    return y, dx, dscale_dbias[:w].to(scale.dtype), dscale_dbias[w:].to(bias.dtype)


ln_fast_bwd.launches = 0


class LnQkvFunction(torch.autograd.Function):
    """The fused forward with the JAX twin's gradient, as
    ``ln_qkv_pallas``'s custom VJP: the forward saves its five inputs,
    the backward takes dy = g·W in ``dtype``, then the normalized rows y
    again with dx, dscale and dbias through the fast-variance LayerNorm
    (:func:`ln_fast_bwd`, one kernel on the card), and dW = gᵀ·y and
    db = Σ g in ``dtype`` (the types the unfused ``linear`` gives; the
    casts' backward hands fp32 parameters fp32 gradients)."""

    @staticmethod
    def forward(ctx, x2d, scale, bias, weight, kbias, eps: float, dtype: torch.dtype):
        out = ln_qkv_fwd(x2d, scale, bias, weight, kbias, eps, dtype)
        ctx.save_for_backward(x2d, scale, bias, weight, kbias)
        ctx.eps, ctx.dtype = eps, dtype
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x2d, scale, bias, weight, kbias = ctx.saved_tensors
        dtype = ctx.dtype
        g = g.to(dtype)
        y, dx, dscale, dbias = ln_fast_bwd(x2d, torch.matmul(g, weight.to(dtype)), scale, bias,
                                           ctx.eps, dtype)
        dweight = torch.matmul(g.t(), y).to(weight.dtype) if ctx.needs_input_grad[3] else None
        dkbias = g.sum(0).to(kbias.dtype) if ctx.needs_input_grad[4] else None
        dx, dscale, dbias = (t if need else None
                             for t, need in zip((dx, dscale, dbias), ctx.needs_input_grad[:3]))
        return dx, dscale, dbias, dweight, dkbias, None, None


def ln_qkv_core(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                weight: torch.Tensor, kbias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """The blocks' fused LN+qkv: x (..., W) → qkv (..., 3W) in x's type,
    the tower's compute type (the JAX block passes its ``dtype``, which x
    is in).  With a gradient to take it goes through
    :class:`LnQkvFunction`; without one the forward runs alone."""
    x2d = x.reshape(-1, x.shape[-1])
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, scale, bias, weight, kbias)):
        out = LnQkvFunction.apply(x2d, scale, bias, weight, kbias, eps, x.dtype)
    else:
        out = ln_qkv_fwd_op(x2d, scale, bias, weight, kbias, eps)
    return out.reshape(*x.shape[:-1], out.shape[-1])


# The forward without a gradient as a custom op, for ``torch.export`` (see
# ops/attention.py's ``mha_fwd_op``): the wrapper, so the plain version on
# a CPU tensor and the kernel on a CUDA one, in x's type.
@torch.library.custom_op("sparsify_clip::ln_qkv_fwd", mutates_args=(),
                         device_types=("cpu", "cuda"))
def ln_qkv_fwd_op(x2d: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  weight: torch.Tensor, kbias: torch.Tensor, eps: float) -> torch.Tensor:
    """:func:`ln_qkv_fwd` in x's type."""
    return ln_qkv_fwd(x2d, scale, bias, weight, kbias, eps)


@ln_qkv_fwd_op.register_fake
def _(x2d, scale, bias, weight, kbias, eps):
    return x2d.new_empty((x2d.shape[0], weight.shape[0]))
