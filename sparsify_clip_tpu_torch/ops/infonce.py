"""Fused symmetric InfoNCE ("anchor" loss) with its own backward.

Port of :mod:`sparsify_clip_tpu.ops.pallas_infonce` (``infonce_loss_pallas``
and its custom VJP) and of the single-device route of
:func:`sparsify_clip_tpu.ops.fused.fused_infonce_loss`.  The logits are
Z = img·txtᵀ / T with the raw temperature T as the divisor.

* :func:`infonce_fwd_reference`, :func:`infonce_bwd_dimg_reference` and
  :func:`infonce_bwd_dtxt_reference` are the plain PyTorch versions of
  what the three TPU kernels compute (pallas_infonce.py:64-134, :185-219,
  :222-248), in fp32; :func:`infonce_bwd_reference` gives all three
  gradients.
* :func:`infonce_fwd`, :func:`infonce_bwd_dimg` and
  :func:`infonce_bwd_dtxt` wrap the CUDA kernels of ``csrc/infonce.cu``.
  A CPU tensor goes to the plain version; a CUDA tensor launches the
  kernel or raises.  Each counts its launches in ``.launches``.
* :class:`InfoNCEFunction` gives the loss and the gradients of img, txt
  and T; :func:`infonce_loss` is what the loss dispatch calls.

The temperature and the incoming gradient stay on the device: the
kernels read them through pointers, so a step never waits on a host read.
The multi-device ``ring`` and ``replicate`` routes of ``fused.py`` wait
for the multi-GPU work (ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

import threading
from typing import Tuple, Union

import torch

from sparsify_clip_tpu_torch.ops import _build

MAX_DIM = 2048  # the kernels refuse wider rows; the JAX package's callers stay below
_count_lock = threading.Lock()


def _logits(img: torch.Tensor, txt: torch.Tensor, temperature: torch.Tensor) -> torch.Tensor:
    return torch.matmul(img.float(), txt.float().T) / temperature


def infonce_fwd_reference(
    img: torch.Tensor, txt: torch.Tensor, temperature: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain forward → (loss, row LSE (N,), column LSE (N,)), fp32."""
    z = _logits(img, txt, temperature)
    n = z.shape[0]
    row_lse, col_lse = torch.logsumexp(z, 1), torch.logsumexp(z, 0)
    diag = z.diagonal().sum()
    loss = ((row_lse.sum() - diag) / n + (col_lse.sum() - diag) / n) / 2
    return loss, row_lse, col_lse


def _dz(img, txt, temperature, row_lse, col_lse, g) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Z, dZ) with dZ = g / (2N) (exp(Z − row LSE) + exp(Z − col LSE) − 2I)."""
    z = _logits(img, txt, temperature)
    n = z.shape[0]
    eye = torch.eye(n, dtype=z.dtype, device=z.device)
    dz = g / (2 * n) * (torch.exp(z - row_lse[:, None]) + torch.exp(z - col_lse[None, :]) - 2 * eye)
    return z, dz


def infonce_bwd_dimg_reference(
    img: torch.Tensor, txt: torch.Tensor, temperature: torch.Tensor,
    row_lse: torch.Tensor, col_lse: torch.Tensor, g: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain ``_bwd_dimg_kernel``: (d_img = dZ·txt / T, dT = −Σ dZ∘Z / T)."""
    z, dz = _dz(img, txt, temperature, row_lse, col_lse, g)
    return torch.matmul(dz, txt.float()) / temperature, -(dz * z).sum() / temperature


def infonce_bwd_dtxt_reference(
    img: torch.Tensor, txt: torch.Tensor, temperature: torch.Tensor,
    row_lse: torch.Tensor, col_lse: torch.Tensor, g: torch.Tensor,
) -> torch.Tensor:
    """Plain ``_bwd_dtxt_kernel``: d_txt = dZᵀ·img / T."""
    _, dz = _dz(img, txt, temperature, row_lse, col_lse, g)
    return torch.matmul(dz.T, img.float()) / temperature


def infonce_bwd_reference(
    img: torch.Tensor, txt: torch.Tensor, temperature: torch.Tensor,
    row_lse: torch.Tensor, col_lse: torch.Tensor, g: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain backward → (d_img, d_txt, dT) from the saved LSE vectors and
    the loss's incoming gradient ``g``."""
    args = (img, txt, temperature, row_lse, col_lse, g)
    d_img, d_temp = infonce_bwd_dimg_reference(*args)
    return d_img, infonce_bwd_dtxt_reference(*args), d_temp


def _check(img: torch.Tensor, txt: torch.Tensor, *scalars: torch.Tensor,
           lse: Tuple[torch.Tensor, ...] = ()) -> Tuple[int, int]:
    """Shape, type and device checks shared by the wrappers → (N, D)."""
    if img.ndim != 2 or img.shape != txt.shape:
        raise ValueError(
            f"InfoNCE takes img and txt of one (N, D) shape, got {tuple(img.shape)} "
            f"and {tuple(txt.shape)}"
        )
    n, d = img.shape
    if img.device.type not in ("cpu", "cuda"):
        raise ValueError(f"InfoNCE runs on cpu or cuda tensors, got {img.device}")
    if any(t.device != img.device for t in (txt, *scalars, *lse)):
        raise ValueError("InfoNCE needs its tensors on one device")
    if any(tuple(t.shape) != (n,) for t in lse):
        raise ValueError(f"InfoNCE takes (N,) = ({n},) row and column LSE vectors")
    if img.device.type == "cuda":
        if any(t.dtype != torch.float32 for t in (img, txt, *scalars, *lse)):
            raise TypeError("InfoNCE kernels take fp32 tensors")
        if not (img.is_contiguous() and txt.is_contiguous()):
            raise ValueError("InfoNCE kernels need contiguous img and txt")
        if any(t.numel() != 1 for t in scalars):
            raise ValueError("InfoNCE kernels take the temperature and g as one-element tensors")
        if n == 0 or not 0 < d <= MAX_DIM:
            raise ValueError(f"InfoNCE kernels take N >= 1 and 1 <= D <= {MAX_DIM}, got {n}, {d}")
    return n, d


def _count(fn) -> None:
    with _count_lock:
        fn.launches += 1


def _bwd_scratch(lib, n: int, d: int, device: torch.device) -> torch.Tensor:
    """The backward's scratch: its tiles' shares of the gradient rows (and
    of dT), which the kernel's second pass adds in a fixed order."""
    return torch.empty(lib.sparsify_infonce_bwd_scratch(n, d), dtype=torch.float32,
                       device=device)


def infonce_fwd(
    img: torch.Tensor, txt: torch.Tensor, temperature: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Forward: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors → (loss, row LSE, column LSE)."""
    n, d = _check(img, txt, temperature)
    if img.device.type == "cpu":
        return infonce_fwd_reference(img, txt, temperature)
    temperature = temperature.contiguous()
    loss = torch.empty((), dtype=torch.float32, device=img.device)
    row_lse, col_lse, diag = torch.empty((3, n), dtype=torch.float32, device=img.device)
    err = _build.launch(
        _build.library().sparsify_infonce_fwd, img.device, img.data_ptr(), txt.data_ptr(),
        temperature.data_ptr(), n, d, loss.data_ptr(), row_lse.data_ptr(), col_lse.data_ptr(),
        diag.data_ptr(),
    )
    if err:
        raise RuntimeError(f"infonce_fwd kernel launch failed with CUDA error {err}")
    _count(infonce_fwd)
    return loss, row_lse, col_lse


def infonce_bwd_dimg(
    img: torch.Tensor, txt: torch.Tensor, temperature: torch.Tensor,
    row_lse: torch.Tensor, col_lse: torch.Tensor, g: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """d_img and dT: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors."""
    n, d = _check(img, txt, temperature, g, lse=(row_lse, col_lse))
    if img.device.type == "cpu":
        return infonce_bwd_dimg_reference(img, txt, temperature, row_lse, col_lse, g)
    temperature, g, row_lse, col_lse = (t.contiguous() for t in (temperature, g, row_lse, col_lse))
    lib = _build.library()
    d_img = torch.empty_like(img)
    d_temp = torch.empty((), dtype=torch.float32, device=img.device)
    scratch = _bwd_scratch(lib, n, d, img.device)
    err = _build.launch(
        lib.sparsify_infonce_bwd_dimg, img.device, img.data_ptr(), txt.data_ptr(),
        temperature.data_ptr(), g.data_ptr(), row_lse.data_ptr(), col_lse.data_ptr(), n, d,
        d_img.data_ptr(), scratch.data_ptr(), d_temp.data_ptr(),
    )
    if err:
        raise RuntimeError(f"infonce_bwd_dimg kernel launch failed with CUDA error {err}")
    _count(infonce_bwd_dimg)
    return d_img, d_temp


def infonce_bwd_dtxt(
    img: torch.Tensor, txt: torch.Tensor, temperature: torch.Tensor,
    row_lse: torch.Tensor, col_lse: torch.Tensor, g: torch.Tensor,
) -> torch.Tensor:
    """d_txt: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    n, d = _check(img, txt, temperature, g, lse=(row_lse, col_lse))
    if img.device.type == "cpu":
        return infonce_bwd_dtxt_reference(img, txt, temperature, row_lse, col_lse, g)
    temperature, g, row_lse, col_lse = (t.contiguous() for t in (temperature, g, row_lse, col_lse))
    lib = _build.library()
    d_txt = torch.empty_like(txt)
    scratch = _bwd_scratch(lib, n, d, img.device)
    err = _build.launch(
        lib.sparsify_infonce_bwd_dtxt, img.device, img.data_ptr(), txt.data_ptr(),
        temperature.data_ptr(), g.data_ptr(), row_lse.data_ptr(), col_lse.data_ptr(), n, d,
        d_txt.data_ptr(), scratch.data_ptr(),
    )
    if err:
        raise RuntimeError(f"infonce_bwd_dtxt kernel launch failed with CUDA error {err}")
    _count(infonce_bwd_dtxt)
    return d_txt


infonce_fwd.launches = 0
infonce_bwd_dimg.launches = 0
infonce_bwd_dtxt.launches = 0


class InfoNCEFunction(torch.autograd.Function):
    """The fused loss with its own backward, as ``infonce_loss_pallas``'s
    custom VJP (pallas_infonce.py:305-327): the forward saves the row and
    column LSE, the backward rebuilds both softmaxes from them."""

    @staticmethod
    def forward(ctx, img, txt, temperature):
        loss, row_lse, col_lse = infonce_fwd(img, txt, temperature)
        ctx.save_for_backward(img, txt, temperature, row_lse, col_lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        img, txt, temperature, row_lse, col_lse = ctx.saved_tensors
        d_img, d_temp = infonce_bwd_dimg(img, txt, temperature, row_lse, col_lse, g)
        d_txt = infonce_bwd_dtxt(img, txt, temperature, row_lse, col_lse, g)
        return d_img, d_txt, d_temp.reshape(temperature.shape)


def infonce_loss(
    img: torch.Tensor, txt: torch.Tensor, temperature: Union[torch.Tensor, float]
) -> torch.Tensor:
    """Symmetric InfoNCE over (N, D) embeddings; numerics-matched to
    :func:`sparsify_clip_tpu_torch.losses.contrastive.contrastive_loss`."""
    if not isinstance(temperature, torch.Tensor):
        temperature = torch.tensor(float(temperature), dtype=torch.float32, device=img.device)
    return InfoNCEFunction.apply(img, txt, temperature)
