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
* :class:`LnQkvFunction` is the forward kernel with the JAX twin's
  gradient (pallas_ln_qkv.py:126-140): it saves x, the LayerNorm scale
  and bias, the weight and the bias, and its backward recomputes only the
  normalized rows.  XLA drops the twin's forward product inside
  ``jax.vjp``; eager PyTorch would not, so the backward is written out:
  dW = gᵀ·y and db = Σ g in ``dtype``, dy = g·W, and dx, dscale and dbias
  by autograd through the fast-variance LayerNorm.
* :func:`ln_qkv_core` is what the blocks call: through
  :class:`LnQkvFunction` when a gradient is wanted, else (serving, eval)
  the forward alone.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch

from sparsify_clip_tpu_torch.ops import _build

MAX_WIDTH = 1664  # ViT-bigG's; the bf16 kernel keeps 32-64 normalized rows in shared memory
_count_lock = threading.Lock()


def _layer_norm_fast(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     eps: float) -> torch.Tensor:
    """fp32 LayerNorm over the last axis with the variance E[x²] − E[x]²."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 * x32).mean(-1, keepdim=True) - mean * mean
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return y * scale.float() + bias.float()


def _normalized_rows(x2d, scale, bias, eps, dtype) -> torch.Tensor:
    """The product's left operand: fp32 LayerNorm, cast to x's type, then
    to ``dtype``."""
    return _layer_norm_fast(x2d, scale, bias, eps).to(x2d.dtype).to(dtype)


def ln_qkv_reference(x2d: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     weight: torch.Tensor, kbias: torch.Tensor, eps: float = 1e-5,
                     dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain PyTorch fused LN+qkv → (N, 3W) in ``dtype`` (x's type by
    default), from x (N, W), the LayerNorm's scale and bias (W,), the
    in_proj weight (3W, W) and bias (3W,)."""
    dtype = dtype or x2d.dtype
    y = _normalized_rows(x2d, scale, bias, eps, dtype)
    return torch.matmul(y, weight.to(dtype).t()) + kbias.to(dtype)


def _count(fn) -> None:
    with _count_lock:
        fn.launches += 1


def _check_kernel(x2d, scale, bias, weight, kbias, dtype) -> None:
    """What the kernel takes (a CPU tensor takes the plain version before
    this check): CUDA tensors on one device, x (N, W) contiguous in
    ``dtype``, bf16 or fp32, N >= 1, W a multiple of 8 up to
    :data:`MAX_WIDTH`, the weight (3W, W) and the biases to match."""
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
    if tuple(weight.shape) != (3 * w, w) or tuple(kbias.shape) != (3 * w,) or \
            tuple(scale.shape) != (w,) or tuple(bias.shape) != (w,):
        raise ValueError(
            f"ln_qkv_fwd takes scale and bias ({w},), weight ({3 * w}, {w}) and kbias "
            f"({3 * w},), got {tuple(scale.shape)}, {tuple(bias.shape)}, "
            f"{tuple(weight.shape)}, {tuple(kbias.shape)}")
    if not x2d.is_contiguous():
        raise ValueError("ln_qkv_fwd kernel needs a contiguous x")
    if x2d.data_ptr() % 16:
        # 16-byte vector loads and cp.async; a misaligned one faults
        raise ValueError("ln_qkv_fwd kernel needs an x whose data starts on a 16-byte boundary")


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
    if w_c.data_ptr() % 16:
        raise ValueError("ln_qkv_fwd kernel needs a weight whose data starts on a 16-byte boundary")
    out = torch.empty((n, 3 * w), dtype=dtype, device=x2d.device)
    lib = _build.library()
    with torch.cuda.device(x2d.device):
        err = lib.sparsify_ln_qkv_fwd(
            x2d.data_ptr(), sc.data_ptr(), bi.data_ptr(), w_c.data_ptr(), kb.data_ptr(),
            out.data_ptr(), n, w, float(eps), int(dtype == torch.bfloat16),
            torch.cuda.current_stream(x2d.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"ln_qkv_fwd kernel launch failed with CUDA error {err}")
    _count(ln_qkv_fwd)
    return out


ln_qkv_fwd.launches = 0


class LnQkvFunction(torch.autograd.Function):
    """The fused forward with the JAX twin's gradient, as
    ``ln_qkv_pallas``'s custom VJP: the forward saves its five inputs,
    the backward recomputes the normalized rows y (not the product) and
    takes dW = gᵀ·y, db = Σ g and dy = g·W in ``dtype`` (the types the
    unfused ``linear`` gives; the casts' backward hands fp32 parameters
    fp32 gradients), then dx, dscale and dbias through the fast-variance
    LayerNorm."""

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
        leaves = [t.detach().requires_grad_(need)
                  for t, need in zip((x2d, scale, bias), ctx.needs_input_grad[:3])]
        with torch.enable_grad():
            y = _normalized_rows(*leaves, ctx.eps, dtype)
        dweight = torch.matmul(g.t(), y.detach()).to(weight.dtype) \
            if ctx.needs_input_grad[3] else None
        dkbias = g.sum(0).to(kbias.dtype) if ctx.needs_input_grad[4] else None
        wanted = [t for t in leaves if t.requires_grad]
        grads = iter(torch.autograd.grad(y, wanted, torch.matmul(g, weight.to(dtype)))
                     if wanted else ())
        dx, dscale, dbias = (next(grads) if t.requires_grad else None for t in leaves)
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
        out = ln_qkv_fwd(x2d, scale, bias, weight, kbias, eps, x.dtype)
    return out.reshape(*x.shape[:-1], out.shape[-1])
