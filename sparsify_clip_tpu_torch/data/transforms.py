"""Host-side image transforms, ported from
:mod:`sparsify_clip_tpu.data.transforms` without PIL.

Reference pipeline (sparsify_clip.py:1003-1018):
* train: RandomResizedCrop((224,224)) → RandomHorizontalFlip →
  ToTensor → Normalize(CLIP mean/std)
* test: Resize((224,224)) (aspect-squashing, NOT center-crop) →
  ToTensor → Normalize

Images are (H, W, 3) uint8 arrays.  PIL's ``Image.resize(size,
BILINEAR)`` becomes :func:`resize_bilinear`, which follows Pillow's
``libImaging/Resample.c`` for 8-bit images: the triangle filter's support
scaled by max(scale, 1), each output's coefficients normalised to sum 1
and rounded to 22-bit fixed point, the horizontal pass first, the
intermediate clipped to uint8, then the vertical pass.  The fixed-point
sums are taken as float64 matrix products, exact for integers below
2^53, so the result is Pillow's to the bit
(``tests/test_torch_port_data.py``).

Crop and flip draws follow torchvision's RandomResizedCrop with an
explicit numpy Generator, in the JAX transform's order.  Output is NHWC
fp32.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np

# CLIP pixel statistics (sparsify_clip.py:1003-1004).
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)

_PRECISION_BITS = 32 - 8 - 2  # Resample.c, 8 bits a channel


@functools.lru_cache(maxsize=256)
def _coefficients(in_size: int, out_size: int) -> Optional[np.ndarray]:
    """(out_size, in_size) float64 matrix of Pillow's fixed-point bilinear
    coefficients (``precompute_coeffs`` + ``normalize_coeffs_8bpc``), or
    None where Pillow skips the pass (same size)."""
    if in_size == out_size:
        return None
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale  # the bilinear filter's support is 1
    ss = 1.0 / filterscale
    matrix = np.zeros((out_size, in_size), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        weights = []
        for x in range(xmax):
            t = abs((x + xmin - center + 0.5) * ss)
            weights.append(1.0 - t if t < 1.0 else 0.0)
        total = 0.0
        for w in weights:
            total += w
        for x, w in enumerate(weights):
            if total != 0.0:
                w /= total
            fixed = w * (1 << _PRECISION_BITS)
            matrix[xx, xmin + x] = int(fixed - 0.5) if fixed < 0 else int(fixed + 0.5)
    return matrix


def _pass(matrix: np.ndarray, x: np.ndarray) -> np.ndarray:
    """One separable pass over axis 0 of ``x`` (float64 integers):
    Pillow's rounding offset, the 22-bit shift and the uint8 clip."""
    flat = x.reshape(x.shape[0], -1)
    acc = matrix @ flat + float(1 << (_PRECISION_BITS - 1))
    out = np.clip(np.floor(acc / (1 << _PRECISION_BITS)), 0, 255)
    return out.reshape(matrix.shape[0], *x.shape[1:])


def resize_bilinear(image: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """(H, W, C) uint8 → (size[1], size[0], C) uint8, equal to PIL's
    ``Image.fromarray(image).resize(size, Image.BILINEAR)``; ``size`` is
    (width, height) as in PIL."""
    width, height = size
    h_coef = _coefficients(image.shape[1], width)
    v_coef = _coefficients(image.shape[0], height)
    x = image.astype(np.float64)
    if h_coef is not None:
        x = _pass(h_coef, x.transpose(1, 0, 2)).transpose(1, 0, 2)
    if v_coef is not None:
        x = _pass(v_coef, x)
    return x.astype(np.uint8)


def to_float(image: np.ndarray) -> np.ndarray:
    """uint8 (H, W, 3) → float32 in [0, 1]."""
    return np.asarray(image, dtype=np.float32) / 255.0


def normalize(arr: np.ndarray) -> np.ndarray:
    return (arr - CLIP_MEAN) / CLIP_STD


def sample_resized_crop_params(
    height: int,
    width: int,
    rng: np.random.Generator,
    scale: Tuple[float, float] = (0.08, 1.0),
    ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
) -> Tuple[int, int, int, int]:
    """(top, left, h, w) with torchvision RandomResizedCrop semantics."""
    area = height * width
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect = math.exp(rng.uniform(log_ratio[0], log_ratio[1]))
        w = int(round(math.sqrt(target_area * aspect)))
        h = int(round(math.sqrt(target_area / aspect)))
        if 0 < w <= width and 0 < h <= height:
            top = int(rng.integers(0, height - h + 1))
            left = int(rng.integers(0, width - w + 1))
            return top, left, h, w
    # fallback: center crop at the closest valid aspect
    in_ratio = width / height
    if in_ratio < ratio[0]:
        w = width
        h = int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        h = height
        w = int(round(h * ratio[1]))
    else:
        w, h = width, height
    top = (height - h) // 2
    left = (width - w) // 2
    return top, left, h, w


def train_transform(image: np.ndarray, rng: np.random.Generator, size: int = 224) -> np.ndarray:
    """RandomResizedCrop + RandomHorizontalFlip + normalize → (S, S, 3)."""
    top, left, h, w = sample_resized_crop_params(image.shape[0], image.shape[1], rng)
    crop = image[top:top + h, left:left + w]
    arr = to_float(resize_bilinear(crop, (size, size)))
    if rng.random() < 0.5:
        arr = arr[:, ::-1, :]
    return normalize(arr)


def test_transform(image: np.ndarray, size: int = 224) -> np.ndarray:
    """Aspect-squashing resize + normalize (the reference's eval path
    uses plain Resize((224,224)), sparsify_clip.py:1014-1018)."""
    return normalize(to_float(resize_bilinear(image, (size, size))))
