"""Device-side image pipeline: random-resized crop, flip and CLIP
normalization of uint8 batches, and the eval path's squash-resize.

Port of :mod:`sparsify_clip_tpu.ops.image`.  The loader ships fixed-size
uint8 staging images (a quarter of fp32's host→device bytes) and the
train step crops, resizes, flips and normalizes them on the card; the
serving path's raw-uint8 requests are squash-resized and normalized the
same way.  The JAX side is XLA here, not Pallas, so this module is plain
PyTorch on whatever device the tensors are on.

* **The sampling is split from the transform.**
  :func:`crop_boxes_from_uniforms` is the JAX ``sample_crop_box`` logic
  (torchvision RandomResizedCrop: area scale U(0.08, 1), log-uniform
  aspect 3/4..4/3, 10 vectorized attempts, the first valid one, else a
  centre crop at the clamped aspect) applied to its four (N_ATTEMPTS,)
  unit uniforms; :func:`augment_uniforms` draws those and the flips'
  from an explicit ``torch.Generator``; :func:`crop_resize` is the
  deterministic transform.  JAX draws with threefry and the port with the
  generator, so the same seed gives other crops: the tests hold the box
  logic against JAX on JAX's own uniforms and the transform on the same
  boxes and flips.
* **The resize** builds the separable weight matrices exactly as
  ``jax.image``'s ``compute_weight_mat`` does (the triangle kernel scaled
  by max(1/scale, 1) when antialiased, the sample grid
  (i + 0.5)/scale − t/scale − 0.5, each output column normalized by its
  sum above 1000·eps, zero outside [−0.5, in − 0.5]) and applies them
  with two batched products, per sample for the crop boxes.
  ``F.interpolate`` and ``F.grid_sample`` handle edges and antialiasing
  otherwise.  The crop's resize is not antialiased (PIL's BILINEAR
  upsampling convention, as the JAX crop); :func:`eval_resize_batch` is,
  as ``jax.image.resize``'s default, and resizes only the axes whose size
  differs.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from sparsify_clip_tpu_torch.data.transforms import CLIP_MEAN, CLIP_STD

SCALE_RANGE = (0.08, 1.0)
LOG_RATIO_RANGE = (math.log(3.0 / 4.0), math.log(4.0 / 3.0))
N_ATTEMPTS = 10
_EPS32 = float(torch.finfo(torch.float32).eps)

Boxes = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _scaled(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """Unit uniforms onto [lo, hi) in float32, as ``jax.random.uniform``
    maps its [0, 1) floats: max(lo, u·(hi − lo) + lo)."""
    lo32 = torch.tensor(lo, dtype=torch.float32, device=u.device)
    hi32 = torch.tensor(hi, dtype=torch.float32, device=u.device)
    return torch.maximum(lo32, u * (hi32 - lo32) + lo32)


def _round32(x: float) -> float:
    """``jnp.round`` of a Python float: to float32, then half to even."""
    return float(torch.round(torch.tensor(x, dtype=torch.float32)))


def crop_boxes_from_uniforms(u_area: torch.Tensor, u_ratio: torch.Tensor,
                             u_top: torch.Tensor, u_left: torch.Tensor,
                             height: int, width: int) -> Boxes:
    """(top, left, h, w) float32 crop boxes with torchvision
    RandomResizedCrop semantics from four (..., N_ATTEMPTS) unit uniforms
    in [0, 1): the JAX ``sample_crop_box`` (ops/image.py:42-87) after its
    draws, over any leading batch shape."""
    u_area, u_ratio, u_top, u_left = (u.float() for u in (u_area, u_ratio, u_top, u_left))
    target_area = (height * width) * _scaled(u_area, *SCALE_RANGE)
    aspect = torch.exp(_scaled(u_ratio, *LOG_RATIO_RANGE))
    w = torch.round(torch.sqrt(target_area * aspect))
    h = torch.round(torch.sqrt(target_area / aspect))
    valid = (w > 0) & (w <= width) & (h > 0) & (h <= height)
    top = torch.floor(u_top * (height - h + 1))
    left = torch.floor(u_left * (width - w + 1))

    # the first valid attempt, else the centre crop at the clamped aspect
    any_valid = valid.any(dim=-1)
    first = valid.int().argmax(dim=-1, keepdim=True)  # first True (0 if none)
    in_ratio = width / height
    if in_ratio < 3.0 / 4.0:
        fb_w, fb_h = float(width), _round32(width / (3.0 / 4.0))
    elif in_ratio > 4.0 / 3.0:
        fb_w, fb_h = _round32(height * 4.0 / 3.0), float(height)
    else:
        fb_w, fb_h = float(width), float(height)
    fallback = (_round32((height - fb_h) / 2.0), _round32((width - fb_w) / 2.0), fb_h, fb_w)
    return tuple(
        torch.where(any_valid, t.gather(-1, first).squeeze(-1),
                    torch.tensor(fb, dtype=torch.float32, device=t.device))
        for t, fb in zip((top, left, h, w), fallback)
    )


def augment_uniforms(generator: torch.Generator, batch: int,
                     device: Optional[torch.device] = None):
    """The draws of one augmented batch from ``generator`` (on its
    device): (B, 4, N_ATTEMPTS) unit uniforms for the crop boxes (area,
    ratio, top, left) and (B,) for the flips."""
    device = generator.device if device is None else device
    boxes = torch.rand((batch, 4, N_ATTEMPTS), generator=generator, device=device)
    flips = torch.rand((batch,), generator=generator, device=device)
    return boxes, flips


def weight_matrix(in_size: int, out_size: int, inv_scale, translation, antialias: bool,
                  device: Optional[torch.device] = None) -> torch.Tensor:
    """``jax.image``'s ``compute_weight_mat`` for the triangle kernel:
    (..., in_size, out_size) float32 weights.  ``inv_scale`` (1/scale) and
    ``translation`` are float32 tensors of one leading shape, one matrix
    each, or Python floats, rounded to float32 as JAX's weak types are."""
    inv_scale = torch.as_tensor(inv_scale, dtype=torch.float32, device=device)[..., None]
    translation = torch.as_tensor(translation, dtype=torch.float32,
                                  device=inv_scale.device)[..., None]
    out_pos = torch.arange(out_size, dtype=torch.float32, device=inv_scale.device)
    sample_f = (out_pos + 0.5) * inv_scale - translation * inv_scale - 0.5  # (..., out)
    in_pos = torch.arange(in_size, dtype=torch.float32, device=inv_scale.device)[:, None]
    x = (sample_f[..., None, :] - in_pos).abs()
    if antialias:  # downsampling widens the kernel; upsampling only interpolates
        x = x / torch.clamp(inv_scale, min=1.0)[..., None]
    weights = torch.clamp(1.0 - x, min=0.0)
    total = weights.sum(dim=-2, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * _EPS32,
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[..., None, :], weights, torch.zeros_like(weights))


def _resample(images: torch.Tensor, rows: Optional[torch.Tensor],
              cols: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, H, W, C) float32 through the row weights (H, S) or (B, H, S)
    and the column weights (W, T) or (B, W, T) → (B, S, T, C) contiguous;
    an axis whose matrix is None is left as it is.  Two batched products
    whose operands are the images' own layout or a transposed view of it
    (cuBLAS reads those in place), then one copy back to NHWC."""
    b, h, w, c = images.shape
    if rows is None:
        rows = torch.eye(h, dtype=images.dtype, device=images.device)
    if cols is None:
        cols = torch.eye(w, dtype=images.dtype, device=images.device)
    s, t = rows.shape[-1], cols.shape[-1]
    # (B, W·C, H) view @ (B, H, S) → (B, W·C, S): the rows' pass, laid out (B, W, C, S)
    x = torch.bmm(images.reshape(b, h, w * c).transpose(1, 2), rows.expand(b, h, s))
    # (B, T, W) @ (B, W, C·S) → (B, T, C·S): the columns' pass, laid out (B, T, C, S)
    x = torch.bmm(cols.expand(b, w, t).transpose(1, 2), x.view(b, w, c * s))
    return x.view(b, t, c, s).permute(0, 3, 1, 2).contiguous()


def crop_resize(images_u8: torch.Tensor, boxes: Boxes, flips: torch.Tensor,
                size: int) -> torch.Tensor:
    """uint8 (B, H, W, 3) → (B, size, size, 3) float32 pixels in [0, 1]:
    each sample's (top, left, h, w) box bilinearly resized to ``size`` ×
    ``size`` without antialiasing, then flipped left-right where ``flips``
    (B,) is true.  The JAX ``_crop_resize_one`` (ops/image.py:90-110),
    ``jax.image.scale_and_translate`` with scale size/h and translation
    −top·scale on each axis; the flip reverses the column weights'
    outputs, the same products in the mirrored order.  float32 images are
    divided by 255 as the uint8 ones (see :func:`augment_batch`)."""
    _check_images(images_u8, float32_too=True)
    top, left, h, w = (t.float() for t in boxes)
    _, height, width, _ = images_u8.shape
    scale_y, scale_x = size / h, size / w
    rows = weight_matrix(height, size, 1.0 / scale_y, -top * scale_y, antialias=False)
    cols = weight_matrix(width, size, 1.0 / scale_x, -left * scale_x, antialias=False)
    cols = torch.where(flips.to(torch.bool)[:, None, None], cols.flip(-1), cols)
    return _resample(images_u8.float() / 255.0, rows, cols)


def normalize_batch(images: torch.Tensor) -> torch.Tensor:
    """CLIP mean/std normalization of [0, 1] pixels, float32."""
    mean = torch.as_tensor(CLIP_MEAN, device=images.device)
    std = torch.as_tensor(CLIP_STD, device=images.device)
    return (images.float() - mean) / std


def augment_batch(images_u8: torch.Tensor, generator: torch.Generator,
                  size: int = 224, shard: Tuple[int, int] = (0, 1)) -> torch.Tensor:
    """uint8 (B, H, W, 3) → augmented, normalized float32 (B, size, size,
    3): a random-resized crop, a random flip and CLIP normalization, with
    every draw from ``generator`` (on the images' device).  The device
    twin of :func:`sparsify_clip_tpu_torch.data.transforms.train_transform`
    (the JAX ``augment_batch``).

    float32 images are taken as the JAX function takes them, divided by
    255 like pixels: the grain route ships normalized float32 images under
    ``device_augment``, and the JAX step augments them so
    (:mod:`sparsify_clip_tpu_torch.data.grain_loader`).

    ``shard=(rank, world)``: the images are rank's rows of a global batch
    of ``world`` such slices; the generator draws the whole global batch's
    uniforms and the rank keeps its rows, so W ranks augment as one does."""
    _check_images(images_u8, float32_too=True)
    b, height, width, _ = images_u8.shape
    rank, world = shard
    u, u_flip = augment_uniforms(generator, b * world, images_u8.device)
    if world > 1:
        u, u_flip = u[rank * b:(rank + 1) * b], u_flip[rank * b:(rank + 1) * b]
    boxes = crop_boxes_from_uniforms(u[:, 0], u[:, 1], u[:, 2], u[:, 3], height, width)
    return normalize_batch(crop_resize(images_u8, boxes, u_flip < 0.5, size))


def eval_resize_batch(images_u8: torch.Tensor, size: int = 224) -> torch.Tensor:
    """uint8 (B, H, W, 3) → squash-resized, normalized float32 (B, size,
    size, 3): the eval path's aspect-squashing Resize, as
    ``jax.image.resize(..., "linear")`` (antialiased when it downsamples;
    an axis already at ``size`` is left as it is)."""
    _check_images(images_u8)
    _, height, width, _ = images_u8.shape
    images = images_u8.float() / 255.0
    axes = [None if n == size else
            weight_matrix(n, size, 1.0 / (size / n), 0.0, antialias=True, device=images.device)
            for n in (height, width)]
    if any(m is not None for m in axes):
        images = _resample(images, *axes)
    return normalize_batch(images)


def _check_images(images: torch.Tensor, float32_too: bool = False) -> None:
    dtypes = (torch.uint8, torch.float32) if float32_too else (torch.uint8,)
    if images.ndim != 4 or images.shape[-1] != 3 or images.dtype not in dtypes:
        raise ValueError(f"expected uint8 images (B, H, W, 3), got {images.dtype} "
                         f"{tuple(images.shape)}")
