"""The port's device image pipeline (``ops/image.py``) against the JAX
package's on the CPU.

The two frameworks draw from other generators, so the test holds the
split parts apart:
* the box logic on JAX's own uniforms, read from ``jax.random`` on the
  very key splits ``sample_crop_box`` takes: equal, bit for bit, including
  the centre fallback at aspect ratios of 1:5 and 5:1;
* the crop-resize on the same boxes and flips against
  ``jax.image.scale_and_translate`` (atol 1e-5 on [0, 1] pixels);
* ``eval_resize_batch`` against the JAX one (``jax.image.resize``,
  antialiased) when it up- and downsamples.  JAX's jitted resize sits up
  to 1.4e-5 from the exact product of its own weights at 224 × 300 → 224
  (the port 7e-8), so the port is held to atol 1e-5 against that float64
  product and to 1e-5 plus JAX's own distance from it against JAX.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax._src.image import scale as jax_scale

from sparsify_clip_tpu.ops import image as jax_image
from sparsify_clip_tpu_torch.data.transforms import CLIP_MEAN, CLIP_STD
from sparsify_clip_tpu_torch.ops import image

PIXEL_ATOL = 1e-5


def _jax_uniforms(key):
    """The four (N_ATTEMPTS,) unit uniforms ``sample_crop_box(key, ...)``
    draws: one split of the key each, uniform on [0, 1)."""
    return [np.array(jax.random.uniform(k, (image.N_ATTEMPTS,)))
            for k in jax.random.split(key, 4)]


def _port_box(key, height, width):
    u = [torch.from_numpy(a) for a in _jax_uniforms(key)]
    return [float(t) for t in image.crop_boxes_from_uniforms(*u, height, width)]


def _valid_attempts(key, height, width):
    """How many of the 10 attempts fit the image, from JAX's draws (numpy)."""
    u_area, u_ratio, _, _ = _jax_uniforms(key)
    area = height * width * (u_area * (1 - 0.08) + 0.08)
    aspect = np.exp(u_ratio * (image.LOG_RATIO_RANGE[1] - image.LOG_RATIO_RANGE[0])
                    + image.LOG_RATIO_RANGE[0])
    w, h = np.round(np.sqrt(area * aspect)), np.round(np.sqrt(area / aspect))
    return int(((w > 0) & (w <= width) & (h > 0) & (h <= height)).sum())


@pytest.mark.parametrize("height,width", [(64, 64), (48, 40), (256, 256), (480, 640)])
def test_crop_boxes_equal_jax_on_its_own_uniforms(height, width):
    for seed in range(60):
        key = jax.random.PRNGKey(seed)
        want = [float(t) for t in jax_image.sample_crop_box(key, height, width)]
        assert _port_box(key, height, width) == want, seed


@pytest.mark.parametrize("height,width,centre", [
    (20, 100, [0.0, 36.0, 20.0, 27.0]),  # h 20, w round(20·4/3), left round(73/2) half to even
    (100, 20, [36.0, 0.0, 27.0, 20.0]),
])
def test_centre_fallback_equals_jax_at_1_to_5(height, width, centre):
    """At 1:5 and 5:1 about one key in ten draws no attempt that fits: the
    box is then the centre crop at the clamped aspect."""
    fallbacks = 0
    for seed in range(80):
        key = jax.random.PRNGKey(seed)
        want = [float(t) for t in jax_image.sample_crop_box(key, height, width)]
        assert _port_box(key, height, width) == want, seed
        if _valid_attempts(key, height, width) == 0:
            fallbacks += 1
            assert want == centre, seed
    assert fallbacks >= 3


def test_batched_boxes_equal_the_per_sample_boxes():
    keys = [jax.random.PRNGKey(s) for s in range(16)]
    u = torch.from_numpy(np.stack([np.stack(_jax_uniforms(k)) for k in keys]))
    boxes = image.crop_boxes_from_uniforms(u[:, 0], u[:, 1], u[:, 2], u[:, 3], 48, 40)
    got = torch.stack(boxes, dim=1).tolist()
    assert got == [_port_box(k, 48, 40) for k in keys]


def _jax_crop_resize(img_u8, box, flip, size):
    """``_crop_resize_one``'s transform on a given box and flip."""
    top, left, h, w = (jnp.float32(v) for v in box)
    sy, sx = size / h, size / w
    out = jax.image.scale_and_translate(
        jnp.asarray(img_u8, jnp.float32) / 255.0, (size, size, 3), (0, 1),
        jnp.stack([sy, sx]), jnp.stack([-top * sy, -left * sx]), method="linear",
        antialias=False)
    out = np.asarray(out)
    return out[:, ::-1] if flip else out


@pytest.mark.parametrize("size", [16, 64])  # down- and upsampling a 48 × 40 staging image
def test_crop_resize_equals_scale_and_translate(size):
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (6, 48, 40, 3), dtype=np.uint8)
    boxes = [[float(t) for t in jax_image.sample_crop_box(jax.random.PRNGKey(s), 48, 40)]
             for s in range(6)]
    boxes[0] = [0.0, 0.0, 48.0, 40.0]  # the whole image
    boxes[1] = [47.0, 39.0, 1.0, 1.0]  # one corner pixel
    flips = np.array([True, False, True, False, False, True])
    got = image.crop_resize(torch.from_numpy(images),
                            [torch.tensor(col, dtype=torch.float32) for col in zip(*boxes)],
                            torch.from_numpy(flips), size).numpy()
    assert got.shape == (6, size, size, 3) and got.dtype == np.float32
    for i in range(6):
        want = _jax_crop_resize(images[i], boxes[i], flips[i], size)
        np.testing.assert_allclose(got[i], want, rtol=0, atol=PIXEL_ATOL, err_msg=str(i))


def _pixels(normalized):
    return np.asarray(normalized, np.float64) * CLIP_STD + CLIP_MEAN


def _exact_resize(images_u8, size):
    """The float64 product of JAX's own (eager) weight matrices."""
    x = images_u8.astype(np.float64) / 255.0
    for axis in (1, 2):
        n = x.shape[axis]
        if n == size:
            continue
        w = np.asarray(jax_scale.compute_weight_mat(
            n, size, size / n, 0.0, jax_scale._fill_triangle_kernel, True), np.float64)
        x = np.moveaxis(np.tensordot(x, w, axes=([axis], [0])), -1, axis)
    return x


@pytest.mark.parametrize("height,width,size", [
    (48, 40, 16),    # down on both axes
    (16, 24, 32),    # up on both axes
    (224, 300, 224),  # one axis alone, down
    (480, 640, 224),  # a camera frame to ViT-B-32's input
    (32, 32, 32),    # no resize
])
def test_eval_resize_equals_jax_resize(height, width, size):
    rng = np.random.default_rng(1)
    images = rng.integers(0, 256, (2, height, width, 3), dtype=np.uint8)
    got = _pixels(image.eval_resize_batch(torch.from_numpy(images), size).numpy())
    want = _pixels(jax_image.eval_resize_batch(jnp.asarray(images), size))
    exact = _exact_resize(images, size)
    assert got.shape == want.shape == (2, size, size, 3)
    np.testing.assert_allclose(got, exact, rtol=0, atol=PIXEL_ATOL)
    assert np.all(np.abs(got - want) <= PIXEL_ATOL + np.abs(want - exact) + 1e-7)


def test_normalize_batch_equals_jax():
    x = np.random.default_rng(2).random((2, 5, 5, 3), dtype=np.float32)
    np.testing.assert_allclose(image.normalize_batch(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_image.normalize_batch(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


def test_augment_batch_is_its_parts_and_follows_the_generator():
    images = torch.from_numpy(
        np.random.default_rng(3).integers(0, 256, (4, 48, 40, 3), dtype=np.uint8))
    out = image.augment_batch(images, torch.Generator().manual_seed(5), 32)
    assert out.shape == (4, 32, 32, 3) and out.dtype == torch.float32
    u, u_flip = image.augment_uniforms(torch.Generator().manual_seed(5), 4)
    boxes = image.crop_boxes_from_uniforms(u[:, 0], u[:, 1], u[:, 2], u[:, 3], 48, 40)
    want = image.normalize_batch(image.crop_resize(images, boxes, u_flip < 0.5, 32))
    assert torch.equal(out, want)
    again = image.augment_batch(images, torch.Generator().manual_seed(5), 32)
    other = image.augment_batch(images, torch.Generator().manual_seed(6), 32)
    assert torch.equal(out, again) and not torch.equal(out, other)
    top, left, h, w = boxes
    assert ((0 <= top) & (top + h <= 48) & (0 <= left) & (left + w <= 40)).all()


def test_non_uint8_images_are_refused():
    with pytest.raises(ValueError, match="uint8"):
        image.eval_resize_batch(torch.zeros(1, 8, 8, 3), 4)
    with pytest.raises(ValueError, match="uint8"):
        image.augment_batch(torch.zeros(1, 8, 8, 3, dtype=torch.uint8)[..., :2],
                            torch.Generator(), 4)
