"""The port's raw-uint8 request path and zero-shot classification on the
CPU, against the JAX package's: ``CLIPEncoder.encode_images_u8`` (cast,
squash-resize where H or W differs, normalize, encode),
``build_zero_shot_classifier`` / ``zero_shot_classify``, and the server's
``submit_image_u8`` with its per-(H, W) queues and its rejections
(tests/test_serving.py:203-230's checks).  fp32 towers on the same numpy
weights agree to rtol 2e-4 / atol 2e-5 (tests/test_torch_port_serving.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparsify_clip_tpu import inference as jax_inference
from sparsify_clip_tpu.checkpoints import collect_host_arrays, fill_from_flat
from sparsify_clip_tpu.models import clip as jax_clip
from sparsify_clip_tpu.text import get_tokenizer as jax_get_tokenizer
from sparsify_clip_tpu_torch import inference
from sparsify_clip_tpu_torch.checkpoints import load_jax_params
from sparsify_clip_tpu_torch.data.transforms import CLIP_MEAN, CLIP_STD
from sparsify_clip_tpu_torch.models import clip as port_clip
from sparsify_clip_tpu_torch.serving import BatchingEncoderServer
from sparsify_clip_tpu_torch.text import get_tokenizer

FP32 = dict(rtol=2e-4, atol=2e-5)
MODEL = "tiny-test"  # both registries: 32² images, the full vocabulary and context
RNG = np.random.default_rng(11)


@pytest.fixture(scope="module")
def encoders():
    """(JAX CLIPEncoder, port CLIPEncoder) over the same numpy weights."""
    model = jax_clip.CLIP(cfg=jax_clip.MODEL_REGISTRY[MODEL])
    variables = jax.jit(model.init, static_argnames="train")(
        jax.random.PRNGKey(0), jnp.zeros((2, 32, 32, 3)), jnp.zeros((2, 77), jnp.int32),
        train=False)
    rng = np.random.default_rng(3)
    flat = {k: (1 + 0.1 * rng.standard_normal(v.shape) if k.endswith("ln/scale")
                else 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in collect_host_arrays(variables["params"]).items()}
    jax_enc = jax_inference.CLIPEncoder(
        model, {"params": fill_from_flat(variables["params"], flat)}, jax_get_tokenizer(MODEL))
    port = load_jax_params(port_clip.create_model(MODEL, device="cpu"), flat)
    return jax_enc, inference.CLIPEncoder(port, get_tokenizer(MODEL))


@pytest.mark.parametrize("height,width", [(32, 32), (48, 64), (16, 24), (32, 40)])
def test_encode_images_u8_matches_jax(encoders, height, width):
    jax_enc, enc = encoders
    raw = RNG.integers(0, 256, (3, height, width, 3), dtype=np.uint8)
    got = enc.encode_images_u8(raw)
    assert got.dtype == torch.float32 and got.shape == (3, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_enc.encode_images_u8(raw)), **FP32)


def test_u8_at_the_towers_size_is_the_normalized_fp32_encode(encoders):
    _, enc = encoders
    raw = RNG.integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
    host = (raw.astype(np.float32) / 255.0 - CLIP_MEAN) / CLIP_STD
    torch.testing.assert_close(enc.encode_images_u8(raw), enc.encode_images(host),
                               rtol=1e-6, atol=1e-6)


def test_zero_shot_matches_jax(encoders):
    jax_enc, enc = encoders
    names = ["dog", "cat", "red bus", "kitchen"]
    want_cls = np.asarray(jax_inference.build_zero_shot_classifier(jax_enc, names))
    got_cls = inference.build_zero_shot_classifier(enc, names)
    assert got_cls.shape == (4, 16)
    np.testing.assert_allclose(got_cls.numpy(), want_cls, **FP32)
    images = RNG.standard_normal((5, 32, 32, 3)).astype(np.float32)
    want = jax_inference.zero_shot_classify(jax_enc, images, jnp.asarray(want_cls),
                                            temperature=0.1)
    got = inference.zero_shot_classify(enc, images, got_cls, temperature=0.1)
    np.testing.assert_allclose(got["probs"], want["probs"], **FP32)
    np.testing.assert_allclose(got["probs"].sum(-1), 1.0, rtol=1e-6)
    np.testing.assert_array_equal(got["predictions"], want["predictions"])
    assert inference.DEFAULT_TEMPLATES == jax_inference.DEFAULT_TEMPLATES


class _Recording:
    """The encoder, recording each uint8 batch's shape."""

    def __init__(self, encoder):
        self.encoder, self.model, self.device = encoder, encoder.model, encoder.device
        self.u8_shapes = []

    def encode_images(self, x):
        return self.encoder.encode_images(x)

    def encode_tokens(self, x):
        return self.encoder.encode_tokens(x)

    def encode_images_u8(self, x):
        self.u8_shapes.append(x.shape)
        return self.encoder.encode_images_u8(x)


def test_u8_path_matches_host_normalized_fp32(encoders):
    _, enc = encoders
    raw = RNG.integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
    host = (raw.astype(np.float32) / 255.0 - CLIP_MEAN) / CLIP_STD
    with BatchingEncoderServer(enc, max_batch=4, max_wait_ms=5.0) as server:
        got_u8 = np.stack([server.submit_image_u8(r).result(30) for r in raw])
        got_f32 = np.stack([server.submit_image(h).result(30) for h in host])
    np.testing.assert_allclose(got_u8, got_f32, **FP32)


def test_u8_queues_per_shape_and_drops_drained_queues(encoders):
    _, enc = encoders
    recording = _Recording(enc)
    shapes = [(32, 32), (48, 64), (16, 24)]
    raws = [RNG.integers(0, 256, (*shapes[i % 3], 3), dtype=np.uint8) for i in range(12)]
    with BatchingEncoderServer(recording, max_batch=8, max_wait_ms=50.0) as server:
        futures = [server.submit_image_u8(r) for r in raws]
        rows = [f.result(30) for f in futures]
        assert set(server._queues) == {"image", "tokens"}  # the u8 queues drained and went
        assert server.stats().requests == 12 and server.stats().errors == 0
    # every batch held one shape, every shape was served, padded to a bucket
    assert {s[1:3] for s in recording.u8_shapes} == set(shapes)
    assert sum(1 for s in recording.u8_shapes) >= 3
    for raw, row in zip(raws, rows):
        np.testing.assert_allclose(row, enc.encode_images_u8(raw[None])[0].numpy(), **FP32)
        assert row.shape == (16,) and np.isclose(np.linalg.norm(row), 1.0, rtol=1e-5)


def test_u8_rejections(encoders):
    _, enc = encoders
    with BatchingEncoderServer(enc, max_batch=2) as server:
        with pytest.raises(ValueError, match="uint8"):
            server.submit_image_u8(np.zeros((32, 32, 3), np.float32))
        with pytest.raises(ValueError, match="uint8"):
            server.submit_image_u8(np.zeros((2, 32, 32, 3), np.uint8))

    class NoU8:
        device = enc.device
        encode_images, encode_tokens = enc.encode_images, enc.encode_tokens

    with BatchingEncoderServer(NoU8(), max_batch=2) as server:
        with pytest.raises(ValueError, match="no uint8 path"):
            server.submit_image_u8(np.zeros((32, 32, 3), np.uint8))


def test_warmup_runs_the_u8_path_when_asked(encoders):
    _, enc = encoders
    recording = _Recording(enc)
    server = BatchingEncoderServer(recording, max_batch=4)
    try:
        server.warmup((32, 32, 3), 77)
        assert recording.u8_shapes == []
        server.warmup((32, 32, 3), 77, include_u8=True)
        assert recording.u8_shapes == [(b, 32, 32, 3) for b in server.buckets]
    finally:
        server.close()
