"""Numerics helpers shared by inference and (later) the losses.

Port of :mod:`sparsify_clip_tpu.utils.numerics`.  The JAX side asks for
``Precision.HIGHEST`` on every loss-path matmul; here fp32 must mean
fp32 as well, so importing this module turns TF32 off for both cuBLAS
matmuls and cuDNN convolutions (cuDNN's default is TF32, which keeps
about three decimal digits).  bf16 encoder matmuls are not affected.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def fp32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full-precision fp32 matmul (TF32 is off, see the module doc)."""
    return torch.matmul(a.float(), b.float())


def l2_normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """x / ||x||₂ along ``dim`` in fp32, with no epsilon, as the
    reference's plain divide (sparsify_clip.py:772-773)."""
    x = x.float()
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True)
