"""The port's ``encode`` CLI (sparsify_clip_tpu_torch/encode.py) on the
CPU against the JAX CLI (sparsify_clip_tpu/encode.py), both reading one
``save_weights`` file and the same PNG files and captions: the same npz
keys, files and texts, and embeddings equal at the bf16 towers'
tolerance (``bf16_rows_close`` of tests/test_torch_port_bf16.py over
256 images and 256 captions: the port's error against the JAX fp32
encode as noisy as the JAX bf16 encode's own, and no more biased).
"""

import os

import numpy as np
import pytest

import jax.numpy as jnp

from sparsify_clip_tpu import encode as jax_encode
from sparsify_clip_tpu.checkpoints import save_weights
from sparsify_clip_tpu.inference import CLIPEncoder as JaxEncoder
from sparsify_clip_tpu.models import create_model as jax_create_model
from sparsify_clip_tpu.text import get_tokenizer as jax_get_tokenizer
from sparsify_clip_tpu_torch import encode

from test_torch_port_bf16 import bf16_rows_close

MODEL = "tiny-test"  # both registries: 32² images, the full vocabulary and context
N_ROWS = 256


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("encode")
    images = root / "images"
    images.mkdir()
    rng = np.random.default_rng(5)
    # five sizes, then 32² images: 256 rows for the bf16 statistic
    sizes = [(32, 32), (40, 56), (64, 48), (20, 30), (33, 33)] + [(32, 32)] * (N_ROWS - 5)
    for i, (h, w) in enumerate(sizes):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            images / f"img_{i:03d}.png")
    (images / "notes.txt").write_text("not an image")
    texts = root / "texts.txt"
    words = ["a", "red", "bus", "dog", "on", "grass", "an", "empty", "kitchen", "two", "cats"]
    captions = [" ".join(rng.choice(words, size=rng.integers(2, 9))) for _ in range(N_ROWS - 3)]
    texts.write_text("a red bus\na dog on grass\n\nan empty kitchen\n" + "\n".join(captions) + "\n")
    _, variables = jax_create_model(MODEL, dtype=jnp.float32)
    weights = save_weights(variables["params"], str(root / "w.npz"))
    return root, str(images), str(texts), weights, variables


def test_encode_cli_equals_the_jax_cli(inputs, capsys):
    root, images, texts, weights, variables = inputs
    args = ["--model", MODEL, "--weights", weights, "--images", images, "--texts", texts,
            "--batch-size", "48"]
    want_path = jax_encode.main(args + ["--out", str(root / "jax.npz")])
    got_path = encode.main(args + ["--out", str(root / "port.npz"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("->") >= 2 + 3  # the encode lines and a retrieval line an image
    with np.load(want_path) as want, np.load(got_path) as got:
        assert sorted(got.files) == sorted(want.files) == [
            "image_embeddings", "image_files", "text_embeddings", "texts"]
        np.testing.assert_array_equal(got["image_files"], want["image_files"])
        np.testing.assert_array_equal(got["texts"], want["texts"])
        assert got["image_embeddings"].shape == (N_ROWS, 16) and got["texts"].shape == (N_ROWS,)
        for key in ("image_embeddings", "text_embeddings"):
            assert got[key].dtype == np.float32
            np.testing.assert_allclose(np.linalg.norm(got[key], axis=1), 1.0, atol=1e-5)
        # the JAX fp32 encode of the same pixels and captions
        fp32 = JaxEncoder(jax_create_model(MODEL, dtype=jnp.float32)[0], variables,
                          jax_get_tokenizer(MODEL))
        pixels = encode._load_image_batch(list(got["image_files"]), 32)
        bf16_rows_close(got["image_embeddings"], want["image_embeddings"],
                        np.asarray(fp32.encode_images(pixels)), "images")
        bf16_rows_close(got["text_embeddings"], want["text_embeddings"],
                        np.asarray(fp32.encode_texts(list(got["texts"]))), "texts")


def test_encode_cli_needs_an_input(inputs):
    _, _, _, weights, _ = inputs
    with pytest.raises(SystemExit):
        encode.main(["--model", MODEL, "--weights", weights, "--out", "x.npz",
                     "--device", "cpu"])
    assert not os.path.exists("x.npz")
