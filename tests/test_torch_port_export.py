"""``torch.export`` artifacts (sparsify_clip_tpu_torch/export.py) on the
CPU: round trips against the live encoder at the JAX
tests/test_export.py tolerances (symbolic batch, concrete batch,
unbaked weights, ``uint8_input``, a small ResNet tower, the fused
LN+qkv), the kernels' custom ops inside the graphs, a load in a process
that imports only torch and the port's op module, the weights file read
by each package's loader, the platform refusals and the CLI.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparsify_clip_tpu import checkpoints as jax_checkpoints
from sparsify_clip_tpu import export as jax_export
from sparsify_clip_tpu import inference as jax_inference
from sparsify_clip_tpu.models import clip as jax_clip
from sparsify_clip_tpu_torch.data.transforms import CLIP_MEAN, CLIP_STD
from sparsify_clip_tpu_torch.export import (
    ExportedEncoder, export_encoders, main as export_main, save_exported,
)
from sparsify_clip_tpu_torch.inference import CLIPEncoder
from sparsify_clip_tpu_torch.models import clip as port_clip
from sparsify_clip_tpu_torch.serving import BatchingEncoderServer

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
TIGHT = dict(rtol=2e-5, atol=2e-6)  # tests/test_export.py: an artifact against its live encoder
FP32 = dict(rtol=2e-4, atol=2e-5)   # the port against the JAX package, fp32 towers
TINY = dict(name="port-export-tiny", embed_dim=16, vision_kind="vit", image_size=32,
            vision_width=32, vision_layers=(2,), vision_heads=2, patch_size=16,
            vocab_size=256, context_length=12, text_width=16, text_heads=2, text_layers=2)
RN = dict(TINY, name="port-export-rn", vision_kind="resnet", vision_width=8,
          vision_layers=(1, 1, 1, 1), vision_heads=4)
RNG = np.random.default_rng(3)


@pytest.fixture(scope="module", autouse=True)
def _registered():
    """TINY and RN in both registries while this module runs, and out of
    them after: a registry entry left behind would join the test files
    that enumerate the registered models."""
    added = []
    for registry, make in ((jax_clip.MODEL_REGISTRY, jax_clip.CLIPConfig),
                           (port_clip.MODEL_REGISTRY, port_clip.CLIPConfig)):
        for cfg in (TINY, RN):
            if cfg["name"] not in registry:
                registry[cfg["name"]] = make(**cfg)
                added.append((registry, cfg["name"]))
    yield
    for registry, name in added:
        del registry[name]


def _inputs(b):
    tokens = RNG.integers(1, 250, size=(b, 12)).astype(np.int32)
    tokens[:, 0], tokens[:, -1] = 254, 255
    return RNG.standard_normal((b, 32, 32, 3)).astype(np.float32), tokens


def _model(name=TINY["name"], **kwargs):
    return port_clip.create_model(name, device="cpu", seed=1, **kwargs)


@pytest.fixture(scope="module")
def symbolic(_registered, tmp_path_factory):
    model = _model()
    out = str(tmp_path_factory.mktemp("export") / "tiny")
    save_exported(model, out)
    return out, model


def test_artifact_files_and_meta(symbolic):
    out, _ = symbolic
    assert sorted(os.listdir(out)) == ["export_meta.json", "image_encoder.pt2",
                                       "text_encoder.pt2"]
    with open(os.path.join(out, "export_meta.json")) as fh:
        meta = json.load(fh)
    assert meta["model"] == TINY["name"] and meta["image_size"] == 32
    assert meta["embed_dim"] == 16 and meta["context_length"] == 12
    assert meta["batch"] is None and meta["baked_params"] is True
    assert meta["platforms"] == ["cpu"] and meta["device"] == "cpu"


def test_graphs_hold_the_attention_op(symbolic):
    out, _ = symbolic
    for name in ("image_encoder.pt2", "text_encoder.pt2"):
        graph = str(torch.export.load(os.path.join(out, name)).graph)
        assert graph.count("sparsify_clip.mha_fwd.default") == 2, name  # one a block


@pytest.mark.parametrize("b", [1, 3, 7])
def test_roundtrip_matches_live_encoder_at_any_batch(symbolic, b):
    out, model = symbolic
    served, live = ExportedEncoder(out), CLIPEncoder(model)
    images, tokens = _inputs(b)
    got = served.encode_images(images)
    assert got.dtype == torch.float32 and got.shape == (b, 16)
    torch.testing.assert_close(got, live.encode_images(images), **TIGHT)
    torch.testing.assert_close(served.encode_tokens(tokens), live.encode_tokens(tokens),
                               **TIGHT)
    np.testing.assert_allclose(torch.linalg.vector_norm(got, dim=1).numpy(), 1.0, rtol=1e-5)


def test_concrete_batch_export(tmp_path):
    model = _model()
    save_exported(model, str(tmp_path), batch=4)
    served = ExportedEncoder(str(tmp_path))
    images, tokens = _inputs(4)
    torch.testing.assert_close(served.encode_images(images),
                               CLIPEncoder(model).encode_images(images), **TIGHT)
    assert served.meta["batch"] == 4
    with pytest.raises(Exception):
        served.encode_tokens(tokens[:3])  # the batch is pinned


def test_uint8_input_export(tmp_path):
    model = _model()
    save_exported(model, str(tmp_path), uint8_input=True)
    served = ExportedEncoder(str(tmp_path))
    assert served.meta["uint8_input"] is True
    raw = RNG.integers(0, 256, size=(3, 32, 32, 3)).astype(np.uint8)
    host = (raw.astype(np.float32) / 255.0 - CLIP_MEAN) / CLIP_STD
    live = CLIPEncoder(model)
    torch.testing.assert_close(served.encode_images(raw), live.encode_images_u8(raw), **TIGHT)
    torch.testing.assert_close(served.encode_images(raw), live.encode_images(host), **FP32)
    with BatchingEncoderServer(served, max_batch=2) as server:
        with pytest.raises(ValueError, match="no uint8 path"):
            server.submit_image_u8(raw[0])


def test_resnet_tower_exports_with_symbolic_batch(tmp_path):
    model = _model(RN["name"])
    with torch.no_grad():  # running statistics away from their init
        for name, buf in model.named_buffers():
            buf.copy_(torch.rand_like(buf) + (0.5 if name.endswith("var") else -0.5))
    save_exported(model, str(tmp_path))
    served, live = ExportedEncoder(str(tmp_path)), CLIPEncoder(model)
    for b in (2, 5):
        images, _ = _inputs(b)
        torch.testing.assert_close(served.encode_images(images), live.encode_images(images),
                                   **TIGHT)


def test_fused_ln_qkv_exports_its_op(tmp_path):
    model = _model(fused_ln_qkv=True)
    save_exported(model, str(tmp_path))
    graph = str(torch.export.load(str(tmp_path / "image_encoder.pt2")).graph)
    assert graph.count("sparsify_clip.ln_qkv_fwd.default") == 2
    images, _ = _inputs(3)
    torch.testing.assert_close(ExportedEncoder(str(tmp_path)).encode_images(images),
                               CLIPEncoder(model).encode_images(images), **TIGHT)


def _jax_model(name):
    """The JAX model of ``name`` and random variables of its tree: shapes
    from a trace of its init (no compile), values drawn here, the running
    variances positive."""
    model = jax_clip.CLIP(cfg=jax_clip.MODEL_REGISTRY[name])
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 32, 32, 3)), jnp.zeros((2, 12), jnp.int32),
        train=False))
    rng = np.random.default_rng(11)

    def draw(path, leaf):
        value = 0.1 * rng.standard_normal(leaf.shape)
        if getattr(path[-1], "key", None) == "var":
            value = np.abs(value) + 0.5
        return jnp.asarray(value, leaf.dtype)

    return model, dict(jax.tree_util.tree_map_with_path(draw, dict(shapes)))


@pytest.mark.parametrize("name", [TINY["name"], RN["name"]])
def test_unbaked_weights_are_the_jax_variables(tmp_path, name):
    """bake_params=False: the programs take the variables, weights.npz holds
    them in the JAX layout.  The JAX ``_unflatten_variables`` (the JAX
    ``ExportedEncoder``'s loader) reads the file into its model's tree (the
    ResNet's ``batch_stats`` too), whose encode equals the port's; and, for
    the ViT, the port's artifact serves a file written by the JAX
    ``save_weights(variables, ...)`` (the JAX ``save_exported``'s writer,
    export.py:186) as the JAX model encodes."""
    model = _model(name)
    if RN["name"] == name:
        with torch.no_grad():  # running statistics away from their init
            for buf_name, buf in model.named_buffers():
                buf.copy_(torch.rand_like(buf) + (0.5 if buf_name.endswith("var") else -0.5))
    port_dir = str(tmp_path / "port")
    save_exported(model, port_dir, bake_params=False)
    with open(os.path.join(port_dir, "export_meta.json")) as fh:
        assert json.load(fh)["baked_params"] is False
    live, served = CLIPEncoder(model), ExportedEncoder(port_dir)
    for b in (2, 5):  # the symbolic batch holds for unbaked programs too
        x, t = _inputs(b)
        torch.testing.assert_close(served.encode_images(x), live.encode_images(x), **TIGHT)
        torch.testing.assert_close(served.encode_tokens(t), live.encode_tokens(t), **TIGHT)

    images, tokens = _inputs(3)
    port_file, jax_file = os.path.join(port_dir, "weights.npz"), str(tmp_path / "jax.npz")
    with np.load(port_file) as data:
        tree = jax_export._unflatten_variables(data)
    jax_model, init = _jax_model(name)
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(init)
    for got, want in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(init)):
        assert got.shape == want.shape and got.dtype == jnp.float32
    want_img = live.encode_images(images).numpy()
    np.testing.assert_allclose(
        np.asarray(jax_inference.CLIPEncoder(jax_model, tree, None).encode_images(images)),
        want_img, **FP32)

    if name == RN["name"]:
        return  # the ViT case reads a JAX-written file; the layout is the same
    # the port's artifact serves the JAX file
    jax_checkpoints.save_weights(init, jax_file)
    shutil.copy(jax_file, port_file)
    jax_live, from_jax = jax_inference.CLIPEncoder(jax_model, init, None), ExportedEncoder(port_dir)
    np.testing.assert_allclose(from_jax.encode_images(images).numpy(),
                               np.asarray(jax_live.encode_images(images)), **FP32)
    np.testing.assert_allclose(from_jax.encode_tokens(tokens).numpy(),
                               np.asarray(jax_live._encode_tokens(init, jnp.asarray(tokens))),
                               **FP32)


def test_load_in_a_process_with_no_model(symbolic):
    """The artifact needs torch and the port's op module alone."""
    out, model = symbolic
    images, _ = _inputs(3)
    path = os.path.join(out, "probe.npy")
    np.save(path, images)
    code = (
        "import sys, numpy as np, torch\n"
        "import sparsify_clip_tpu_torch.ops\n"
        f"program = torch.export.load({os.path.join(out, 'image_encoder.pt2')!r}).module()\n"
        f"x = torch.from_numpy(np.load({path!r}))\n"
        "with torch.inference_mode():\n"
        "    y = program(x)\n"
        f"np.save({path!r}, y.numpy())\n"
        "loaded = sorted(m for m in sys.modules if m.startswith('sparsify_clip_tpu'))\n"
        "print(' '.join(loaded))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    loaded = proc.stdout.split()
    assert "sparsify_clip_tpu_torch.ops.attention" in loaded
    assert not [m for m in loaded if m.startswith(("sparsify_clip_tpu_torch.models",
                                                   "sparsify_clip_tpu_torch.export",
                                                   "sparsify_clip_tpu."))], loaded
    np.testing.assert_allclose(np.load(path), CLIPEncoder(model).encode_images(images).numpy(),
                               **TIGHT)


def test_exported_encoder_behind_the_server(symbolic):
    out, model = symbolic
    images, tokens = _inputs(3)
    with BatchingEncoderServer(ExportedEncoder(out), max_batch=4) as server:
        assert server.image_size == 32 and server.context_length == 12
        got = np.stack([server.submit_image(im).result(30) for im in images])
        rows = np.stack([server.submit_tokens(t).result(30) for t in tokens])
    live = CLIPEncoder(model)
    np.testing.assert_allclose(got, live.encode_images(images).numpy(), **TIGHT)
    np.testing.assert_allclose(rows, live.encode_tokens(tokens).numpy(), **TIGHT)


def test_platforms_other_than_the_models_device_are_refused():
    model = _model()
    with pytest.raises(ValueError, match="jax.export"):
        export_encoders(model, batch=2, platforms=["tpu"])
    with pytest.raises(ValueError, match="traced on"):
        export_encoders(model, batch=2, platforms=["cuda"])
    with pytest.raises(ValueError, match="traced on"):
        export_encoders(model, batch=2, platforms=["cuda", "cpu"])
    assert set(export_encoders(model, batch=2, platforms=["cpu"])) == {"image", "text"}


def test_cli_export(tmp_path):
    out = str(tmp_path / "cli")
    export_main(["--model", TINY["name"], "--out", out, "--device", "cpu", "--batch", "2"])
    images, _ = _inputs(2)
    assert ExportedEncoder(out).encode_images(images).shape == (2, 16)
    with pytest.raises(SystemExit):
        export_main(["--model", TINY["name"], "--out", out, "--device", "tpu"])
