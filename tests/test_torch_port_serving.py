"""The port's serving slice on the CPU: ``BatchingEncoderServer`` over
``CLIPEncoder`` against the JAX package's pair, plus the server's own
behaviour (bucket padding, concurrency, errors, thread state) and the
package's independence from JAX.
"""

import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparsify_clip_tpu import inference as jax_inference
from sparsify_clip_tpu import serving as jax_serving
from sparsify_clip_tpu.checkpoints import collect_host_arrays, fill_from_flat
from sparsify_clip_tpu.models import clip as jax_clip
from sparsify_clip_tpu_torch.checkpoints import load_jax_params
from sparsify_clip_tpu_torch.inference import CLIPEncoder, RetrievalIndex
from sparsify_clip_tpu_torch.models import clip as port_clip
from sparsify_clip_tpu_torch.serving import (
    BatchingEncoderServer, bucket_ladder, replicate_clip_encoder,
)

REPO = Path(__file__).resolve().parent.parent
# same-weight fp32 towers agree to rtol 2e-4 / atol 2e-5 on raw embeddings
# (tests/test_torch_port_models.py); on unit vectors the same bounds hold
FP32 = dict(rtol=2e-4, atol=2e-5)

SERVE_TEST = dict(
    name="port-serve-test", embed_dim=16, vision_kind="vit", image_size=32,
    vision_width=32, vision_layers=(2,), vision_heads=2, patch_size=16,
    vocab_size=256, context_length=12, text_width=16, text_heads=2, text_layers=2,
)
jax_clip.MODEL_REGISTRY.setdefault(SERVE_TEST["name"], jax_clip.CLIPConfig(**SERVE_TEST))
port_clip.MODEL_REGISTRY.setdefault(SERVE_TEST["name"], port_clip.CLIPConfig(**SERVE_TEST))
RNG = np.random.default_rng(7)


def _images(n):
    return RNG.standard_normal((n, 32, 32, 3)).astype(np.float32)


def _token_rows(n):
    rows = RNG.integers(1, 250, size=(n, 12)).astype(np.int32)
    rows[:, 0] = 254
    rows[np.arange(n), RNG.integers(1, 12, size=n)] = 255
    return rows


@pytest.fixture(scope="module")
def weights():
    """(flax model, flax params, flat dict) with numpy-drawn weights."""
    model = jax_clip.CLIP(cfg=jax_clip.MODEL_REGISTRY[SERVE_TEST["name"]])
    variables = jax.jit(model.init, static_argnames="train")(
        jax.random.PRNGKey(0), jnp.zeros((2, 32, 32, 3)), jnp.zeros((2, 12), jnp.int32),
        train=False,
    )
    rng = np.random.default_rng(3)
    flat = {
        k: (1 + 0.1 * rng.standard_normal(v.shape) if k.endswith("ln/scale")
            else 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        for k, v in collect_host_arrays(variables["params"]).items()
    }
    return model, fill_from_flat(variables["params"], flat), flat


@pytest.fixture(scope="module")
def encoder(weights):
    model = port_clip.create_model(SERVE_TEST["name"])
    return CLIPEncoder(load_jax_params(model, weights[2]))


class _Recording:
    """Wraps an encoder, recording each batch shape and the runner
    thread's grad mode, inference mode and thread name."""

    def __init__(self, enc):
        self._enc = enc
        self.model = enc.model
        self.device = enc.device
        self.shapes = []
        self.modes = []

    def _record(self, kind, x):
        self.shapes.append((kind, tuple(x.shape)))
        self.modes.append((torch.is_grad_enabled(), torch.is_inference_mode_enabled(),
                           threading.current_thread().name))

    def encode_images(self, images):
        self._record("image", images)
        return self._enc.encode_images(images)

    def encode_tokens(self, tokens):
        self._record("tokens", tokens)
        return self._enc.encode_tokens(tokens)


# ------------------------------------------------------- the slice vs JAX


def test_served_embeddings_match_the_jax_server(weights, encoder):
    """Same weights, same requests, submitted concurrently to both
    servers; padded to a 4-bucket (partial batches carry zero rows)."""
    jmodel, params, _ = weights
    jenc = jax_inference.CLIPEncoder(jmodel, {"params": params}, tokenizer=None)
    images, tokens = _images(7), _token_rows(5)

    def serve(server):
        futs = {}

        def submit(worker):
            for i in range(worker, 7, 3):
                futs[("img", i)] = server.submit_image(images[i])
            for i in range(worker, 5, 3):
                futs[("txt", i)] = server.submit_tokens(tokens[i])

        threads = [threading.Thread(target=submit, args=(w,)) for w in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        img = np.stack([np.asarray(futs[("img", i)].result(60)) for i in range(7)])
        txt = np.stack([np.asarray(futs[("txt", i)].result(60)) for i in range(5)])
        return img, txt

    with jax_serving.BatchingEncoderServer(jenc, max_batch=4, buckets=[4]) as server:
        want_img, want_txt = serve(server)
    with BatchingEncoderServer(encoder, max_batch=4, buckets=[4]) as server:
        got_img, got_txt = serve(server)
        stats = server.stats()
    assert got_img.dtype == np.float32 and got_img.shape == (7, 16)
    np.testing.assert_allclose(got_img, want_img, **FP32)
    np.testing.assert_allclose(got_txt, want_txt, **FP32)
    np.testing.assert_allclose(np.linalg.norm(got_img, axis=-1), 1, rtol=1e-5)
    assert stats.requests == 12 and stats.errors == 0
    assert set(stats.batch_histogram) == {4}


def test_retrieval_index_matches_jax(encoder):
    bank = encoder.encode_images(_images(9)).numpy()
    queries = encoder.encode_images(_images(3)).numpy()
    want = jax_inference.RetrievalIndex(bank).search(queries, k=4)
    got = RetrievalIndex(bank).search(queries, k=4)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-6)
    assert RetrievalIndex(bank).search(queries, k=50)[1].shape == (3, 9)


# ------------------------------------------------------- the server itself


def test_bucket_ladder():
    assert bucket_ladder(256) == [1, 2, 4, 8, 16, 32, 64, 128, 256]
    assert bucket_ladder(48) == [1, 2, 4, 8, 16, 32, 48]
    assert bucket_ladder(1) == [1]


def test_batches_are_padded_to_buckets_and_rows_are_unchanged(encoder):
    images, tokens = _images(5), _token_rows(3)
    want_img = encoder.encode_images(images).numpy()
    want_txt = encoder.encode_tokens(tokens).numpy()
    rec = _Recording(encoder)
    with BatchingEncoderServer(rec, max_batch=8, max_wait_ms=40.0) as server:
        img = [server.submit_image(x) for x in images]
        got_img = np.stack([f.result(30) for f in img])
        txt = [server.submit_tokens(t) for t in tokens]
        got_txt = np.stack([f.result(30) for f in txt])
    allowed = set(bucket_ladder(8))
    assert {k for k, _ in rec.shapes} == {"image", "tokens"}
    for kind, shape in rec.shapes:
        assert shape[0] in allowed
        assert shape[1:] == ((32, 32, 3) if kind == "image" else (12,))
    assert sum(k == "image" for k, _ in rec.shapes) < 5  # coalesced, not bs1 calls
    # zero rows padded into the batch do not change the real rows
    np.testing.assert_allclose(got_img, want_img, rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(got_txt, want_txt, rtol=2e-5, atol=2e-6)


def test_runner_threads_encode_in_inference_mode(encoder):
    rec = _Recording(encoder)
    with BatchingEncoderServer(rec, max_batch=4, max_wait_ms=1.0) as server:
        out = server.submit_image(_images(1)[0]).result(30)
        server.submit_tokens(_token_rows(1)[0]).result(30)
    assert isinstance(out, np.ndarray) and out.dtype == np.float32
    assert rec.modes and all(
        (grad, inf, name) == (False, True, "encoder-replica-0") for grad, inf, name in rec.modes
    )


def test_concurrent_submitters_get_their_own_results(encoder):
    images = _images(32)
    want = encoder.encode_images(images).numpy()
    results, errors = {}, []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # more thread switches inside the server's critical sections
    try:
        with BatchingEncoderServer(encoder, max_batch=8, max_wait_ms=2.0) as server:
            def worker(i):
                try:
                    results[i] = server.submit_image(images[i]).result(60)
                except Exception as exc:  # pragma: no cover - reported below
                    errors.append(exc)

            threads = [threading.Thread(target=worker, args=(i,)) for i in range(32)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
            assert not any(t.is_alive() for t in threads)
            stats = server.stats()
    finally:
        sys.setswitchinterval(interval)
    assert not errors
    for i in range(32):
        np.testing.assert_allclose(results[i], want[i], rtol=2e-5, atol=2e-6)
    assert stats.requests == 32 and stats.errors == 0
    assert sum(stats.batch_histogram.values()) == stats.batches
    assert stats.mean_batch * stats.batches == 32
    assert stats.latency_p99_ms >= stats.latency_p50_ms >= 0.0


def test_full_batch_dispatches_before_deadline(encoder):
    rec = _Recording(encoder)
    with BatchingEncoderServer(rec, max_batch=4, max_wait_ms=5000.0) as server:
        futs = [server.submit_image(x) for x in _images(4)]
        assert len([f.result(30) for f in futs]) == 4
    assert rec.shapes[0] == ("image", (4, 32, 32, 3))


def test_error_propagates_to_every_waiter(encoder):
    class Broken(_Recording):
        def encode_images(self, images):
            raise RuntimeError("device lost")

    with BatchingEncoderServer(Broken(encoder), max_batch=4, max_wait_ms=20.0) as server:
        futs = [server.submit_image(x) for x in _images(3)]
        for f in futs:
            with pytest.raises(RuntimeError, match="device lost"):
                f.result(30)
        ok = server.submit_tokens(_token_rows(1)[0]).result(30)  # runner survived
        stats = server.stats()
    assert ok.shape == (16,) and stats.errors == 3


def test_close_rejects_new_work_and_flushes(encoder):
    server = BatchingEncoderServer(encoder, max_batch=64, max_wait_ms=10_000.0)
    futs = [server.submit_image(x) for x in _images(3)]
    server.close()
    assert all(f.result(1).shape == (16,) for f in futs)
    with pytest.raises(RuntimeError, match="closed"):
        server.submit_image(_images(1)[0])


def test_cancelled_future_is_skipped_not_fatal(encoder):
    with BatchingEncoderServer(encoder, max_batch=8, max_wait_ms=200.0) as server:
        futs = [server.submit_image(x) for x in _images(3)]
        assert futs[1].cancel()
        assert futs[0].result(30).shape == (16,) and futs[2].result(30).shape == (16,)
        assert server.submit_image(_images(1)[0]).result(30).shape == (16,)


@pytest.mark.parametrize(
    "kind,shape,match",
    [
        ("image", (16, 16, 3), "resize"),       # wrong size
        ("image", (32, 32), "one"),             # not (H, W, 3)
        ("tokens", (13,), "context length"),    # wrong length
        ("tokens", (1, 12), "one"),             # a batch, not one row
    ],
)
def test_wrong_shapes_are_rejected_at_submit(encoder, kind, shape, match):
    """One malformed request fails at submit, not inside a batch it shares."""
    submit_ok = {"image": lambda s: s.submit_image(_images(1)[0]),
                 "tokens": lambda s: s.submit_tokens(_token_rows(1)[0])}[kind]
    with BatchingEncoderServer(encoder, max_batch=4) as server:
        assert (server.image_size, server.context_length) == (32, 12)
        bad = np.zeros(shape, np.float32 if kind == "image" else np.int32)
        submit = server.submit_image if kind == "image" else server.submit_tokens
        with pytest.raises(ValueError, match=match):
            submit(bad)
        assert submit_ok(server).result(30).shape == (16,)
        assert server.stats().requests == 1


def test_replicas_share_the_load(encoder):
    replicas = replicate_clip_encoder(encoder.model, devices=["cpu", "cpu"])
    assert replicas[0].model is not replicas[1].model
    images = _images(16)
    want = encoder.encode_images(images).numpy()
    with BatchingEncoderServer(replicas, max_batch=2, max_wait_ms=0.5) as server:
        futs = [server.submit_image(x) for x in images]
        got = np.stack([f.result(60) for f in futs])
        stats = server.stats()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)
    assert len(stats.replica_batches) == 2 and sum(stats.replica_batches) == stats.batches


def test_warmup_runs_every_bucket(encoder):
    rec = _Recording(encoder)
    with BatchingEncoderServer(rec, max_batch=4) as server:
        server.warmup((32, 32, 3), 12)
    assert sorted(s[0] for k, s in rec.shapes if k == "image") == [1, 2, 4]
    assert sorted(s[0] for k, s in rec.shapes if k == "tokens") == [1, 2, 4]


# ------------------------------------------------------- no JAX in the port


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import sparsify_clip_tpu_torch, sparsify_clip_tpu_torch.serving\n"
        "import sparsify_clip_tpu_torch.checkpoints, sparsify_clip_tpu_torch.ops._build\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', "
        "'sparsify_clip_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
