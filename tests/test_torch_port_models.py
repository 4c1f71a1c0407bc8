"""The port's towers and weight bridge against the JAX package, on the CPU.

One set of weights, drawn with numpy, goes to both frameworks: to flax
through ``fill_from_flat``, to the port through ``load_jax_params``.
The same numpy inputs then go through both, and the embeddings must
agree: in fp32 to rtol 2e-4 / atol 2e-5 (as tests/test_torch_vit_interop.py
holds flax against torch), in bf16 to the looser tolerance stated at
``BF16_ATOL``.
"""

import dataclasses
import importlib.util

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from sparsify_clip_tpu.checkpoints import collect_host_arrays, fill_from_flat
from sparsify_clip_tpu.models import clip as jax_clip
from sparsify_clip_tpu.models import layers as jax_layers
from sparsify_clip_tpu.models.text import TextTransformer as JaxText
from sparsify_clip_tpu.models.vit import VisionTransformer as JaxViT
from sparsify_clip_tpu_torch.checkpoints import load_jax_params, torch_name
from sparsify_clip_tpu_torch.models import clip as port_clip
from sparsify_clip_tpu_torch.models import layers as port_layers
from sparsify_clip_tpu_torch.models.text import TextTransformer
from sparsify_clip_tpu_torch.models.vit import VisionTransformer

FP32 = dict(rtol=2e-4, atol=2e-5)
# bf16: both sides round to bf16 after every product, but at different
# places (flax rounds the dense product, then adds the bias in bf16;
# cuBLAS/ATen add the bias before rounding; the JAX einsum attention
# rounds P to bf16 before P·V where the port keeps it fp32; GELU's tanh
# form is evaluated in bf16 ops by XLA and in fp32 by ATen).  Each is a
# relative step of 2^-8.  Measured on these shapes over weight seeds
# 7-9, max |port − JAX| / max |JAX| in bf16: 0.004-0.008 for both towers,
# the same size as JAX bf16 against JAX fp32 (0.004-0.008).  The bound
# below is about 4x the largest.
BF16_ATOL = 3e-2

# vision: 112 / 16 = 7x7 patches + class token = 50 tokens; text: 77 tokens
PORT_TEST = dict(
    name="port-test", embed_dim=32, vision_kind="vit", image_size=112,
    vision_width=64, vision_layers=(2,), vision_heads=4, patch_size=16,
    vocab_size=512, context_length=77, text_width=32, text_heads=4, text_layers=2,
)
jax_clip.MODEL_REGISTRY.setdefault("port-test", jax_clip.CLIPConfig(**PORT_TEST))
port_clip.MODEL_REGISTRY.setdefault("port-test", port_clip.CLIPConfig(**PORT_TEST))


def jax_model(name, dtype=jnp.float32):
    """What ``sparsify_clip_tpu.models.create_model(name, dtype)`` returns,
    with the init jitted (one compile instead of hundreds of eager ones)."""
    model = jax_clip.CLIP(cfg=jax_clip.MODEL_REGISTRY[name], dtype=dtype)
    cfg = model.cfg
    init = jax.jit(model.init, static_argnames="train")
    variables = init(
        jax.random.PRNGKey(0),
        jnp.zeros((2, cfg.image_size, cfg.image_size, 3), jnp.float32),
        jnp.zeros((2, cfg.context_length), jnp.int32),
        train=False,
    )
    return model, variables


def jit_apply(model, params, x, method=None):
    fn = jax.jit(lambda p, x: model.apply({"params": p}, x, method=method))
    return np.asarray(fn(params, jnp.asarray(x)))


def random_flat(params, seed):
    """The flat JAX weight dict with every array redrawn from numpy:
    LayerNorm scales near 1, everything else N(0, 0.05²)."""
    rng = np.random.default_rng(seed)
    flat = collect_host_arrays(params)
    out = {}
    for key, arr in flat.items():
        noise = rng.standard_normal(arr.shape).astype(np.float32)
        out[key] = 1 + 0.1 * noise if key.endswith("ln/scale") else 0.05 * noise
    return out


def images(n, size, seed=2):
    return np.random.default_rng(seed).standard_normal((n, size, size, 3)).astype(np.float32)


def token_rows(n, context, vocab, seed=3):
    """SOT first; EOT mid-sequence, followed by zero padding in even rows
    and by random ids in odd rows (argmax pooling must still find it)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(1, vocab - 2, size=(n, context)).astype(np.int32)
    rows[:, 0] = vocab - 2
    for i in range(n):
        eot = 5 + 7 * i
        rows[i, eot] = vocab - 1
        if i % 2 == 0:
            rows[i, eot + 1:] = 0
    return rows


@pytest.fixture(scope="module")
def clip_pair():
    """(flax model, fp32 params, flat weights) for the port-test config."""
    model, variables = jax_model("port-test")
    flat = random_flat(variables["params"], seed=7)
    return model, fill_from_flat(variables["params"], flat), flat


def _fresh_registry(module_name):
    """The registry as the module defines it: test files add their own
    tiny configs to the imported registries."""
    spec = importlib.util.find_spec(module_name)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.MODEL_REGISTRY


def test_registry_is_a_copy_of_the_jax_registry():
    jax_registry = _fresh_registry("sparsify_clip_tpu.models.clip")
    port_registry = _fresh_registry("sparsify_clip_tpu_torch.models.clip")
    assert set(port_registry) == set(jax_registry)
    for name, cfg in jax_registry.items():
        assert dataclasses.asdict(port_registry[name]) == dataclasses.asdict(cfg), name


@pytest.mark.parametrize("name", ["RN50", "RN50x4", "RN101-quickgelu"])
def test_resnet_entries_raise_not_implemented(name):
    with pytest.raises(NotImplementedError, match="ResNet family"):
        port_clip.create_model(name)


def test_unknown_name_raises():
    with pytest.raises(ValueError, match="Unknown model"):
        port_clip.create_model("ViT-Z-99")


def test_create_model_is_seeded_and_stores_weights_in_the_compute_type():
    a = port_clip.create_model("tiny-test", dtype=torch.bfloat16, seed=3)
    b = port_clip.create_model("tiny-test", dtype=torch.bfloat16, seed=3)
    c = port_clip.create_model("tiny-test", dtype=torch.bfloat16, seed=4)
    assert not a.training and a.dtype == torch.bfloat16
    for (name, p), q, r in zip(a.named_parameters(), b.parameters(), c.parameters()):
        assert torch.equal(p, q), name
        is_ln = ".ln_" in name or name.startswith(("visual.ln", "text.ln"))
        assert p.dtype == (torch.float32 if is_ln else torch.bfloat16), name
        if not is_ln and "bias" not in name:
            assert not torch.equal(p, r), name


def test_init_scales_follow_the_flax_initializers():
    # ViT-B-32's widths at one layer a tower: the scales depend on widths only
    name = "port-init-test"
    port_clip.MODEL_REGISTRY.setdefault(name, dataclasses.replace(
        port_clip.MODEL_REGISTRY["ViT-B-32"], name=name, vision_layers=(1,), text_layers=1))
    m = port_clip.create_model(name, seed=0)
    w = 768
    block = m.visual.transformer.resblocks[0]
    stds = {
        "in_proj": (block.attn.in_proj_weight, w ** -0.5),
        "out_proj": (block.attn.out_proj.weight, w ** -0.5),
        "c_fc": (block.mlp.c_fc.weight, (2 * w) ** -0.5),
        "c_proj": (block.mlp.c_proj.weight, w ** -0.5),
        "conv1": (m.visual.conv1.weight, (3 * 32 * 32) ** -0.5),
        "positional": (m.visual.positional_embedding, w ** -0.5),
        "token_embedding": (m.text.token_embedding.weight, 0.02),
        "text_positional": (m.text.positional_embedding, 0.01),
        "text_projection": (m.text.text_projection, 512 ** -0.5),
    }
    for name, (p, std) in stds.items():
        assert abs(p.std().item() / std - 1) < 0.03, name
    assert torch.equal(block.attn.in_proj_bias, torch.zeros_like(block.attn.in_proj_bias))
    assert torch.equal(block.ln_1.weight, torch.ones_like(block.ln_1.weight))
    lim = 2 * (3 * 32 * 32) ** -0.5 / 0.87962566103423978
    assert m.visual.conv1.weight.abs().max().item() <= lim + 1e-6


# ---------------------------------------------------------------- bridge


@pytest.fixture(scope="module")
def tiny_flat():
    _, variables = jax_model("tiny-test")
    return collect_host_arrays(variables["params"])


def test_bridge_fills_every_parameter_from_a_jax_model(tiny_flat):
    model = port_clip.create_model("tiny-test", seed=1)
    load_jax_params(model, tiny_flat)
    params = dict(model.named_parameters())
    assert len(params) == len(tiny_flat)
    for path, arr in tiny_flat.items():
        name, fn = torch_name(path)
        np.testing.assert_array_equal(params[name].detach().numpy(), fn(arr), err_msg=path)
    # the two layout changes, spelled out
    conv = tiny_flat["visual/conv1/kernel"]  # HWIO
    np.testing.assert_array_equal(model.visual.conv1.weight[5, 2, 3, 7].item(), conv[3, 7, 2, 5])
    dense = tiny_flat["text/transformer/resblock_1/mlp/c_fc/kernel"]  # (in, out)
    assert model.text.transformer.resblocks[1].mlp.c_fc.weight.shape == dense.T.shape


def test_bridge_raises_on_missing_key(tiny_flat):
    flat = dict(tiny_flat)
    del flat["visual/transformer/resblock_1/attn/in_proj/bias"]
    with pytest.raises(KeyError, match="missing"):
        load_jax_params(port_clip.create_model("tiny-test"), flat)


def test_bridge_raises_on_extra_key(tiny_flat):
    flat = dict(tiny_flat, **{"visual/extra/kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError, match="unexpected"):
        load_jax_params(port_clip.create_model("tiny-test"), flat)


def test_bridge_raises_on_wrong_shape_and_writes_nothing(tiny_flat):
    flat = dict(tiny_flat)
    flat["text/text_projection"] = np.zeros((16, 15), np.float32)
    model = port_clip.create_model("tiny-test", seed=1)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(ValueError, match="shape mismatch"):
        load_jax_params(model, flat)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_load_weights_reads_a_save_weights_npz(tiny_flat, tmp_path):
    from sparsify_clip_tpu_torch.checkpoints import load_weights

    np.savez(tmp_path / "w.npz", **tiny_flat)
    model = load_weights(port_clip.create_model("tiny-test", seed=1), str(tmp_path / "w"))
    np.testing.assert_array_equal(
        model.text.text_projection.detach().numpy(), tiny_flat["text/text_projection"]
    )


# ---------------------------------------------------------------- layers


@pytest.mark.parametrize("offset,tol", [(0.0, 2e-6), (3.0, 2e-5)])
def test_layernorm_matches_flax(offset, tol):
    """fp32 statistics; flax's E[x²]−E[x]² variance costs it ~1e-6 at
    zero mean and ~9e-6 at a mean of 3 std (layers.LayerNorm doc)."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((64, 768)) + offset).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(768)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(768)).astype(np.float32)
    want = jax_layers.LayerNorm().apply(
        {"params": {"ln": {"scale": scale, "bias": bias}}}, jnp.asarray(x)
    )
    ln = port_layers.LayerNorm(768)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(scale))
        ln.bias.copy_(torch.from_numpy(bias))
        got = ln(torch.from_numpy(x))
        x_bf16 = torch.from_numpy(x).bfloat16()
        got_bf16 = ln(x_bf16)
        want_bf16 = ln(x_bf16.float()).bfloat16()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=tol)
    # bf16 in: fp32 statistics, one rounding back to bf16
    assert got_bf16.dtype == torch.bfloat16 and torch.equal(got_bf16, want_bf16)


def test_layernorm_is_accurate_where_the_fast_variance_is_not():
    """At a mean of 30 std, flax's E[x²]−E[x]² loses ~1e-3; the port
    stays within 1e-5 of a float64 LayerNorm."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((64, 768)) + 30).astype(np.float32)
    x64 = x.astype(np.float64)
    want = (x64 - x64.mean(-1, keepdims=True)) / np.sqrt(x64.var(-1, keepdims=True) + 1e-5)
    with torch.no_grad():
        got = port_layers.LayerNorm(768)(torch.from_numpy(x)).numpy()
    flax = jax_layers.LayerNorm().apply(
        {"params": {"ln": {"scale": np.ones(768, np.float32), "bias": np.zeros(768, np.float32)}}},
        jnp.asarray(x),
    )
    assert np.abs(got - want).max() < 1e-5
    assert np.abs(np.asarray(flax) - want).max() > 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_activations_match_jax(dtype):
    x = np.linspace(-5, 5, 201, dtype=np.float32)
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    # bf16: XLA evaluates in bf16 ops, ATen in fp32 then rounds once
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    for jf, tf in [(jax_layers.gelu_exact, port_layers.gelu_exact),
                   (jax_layers.quick_gelu, port_layers.quick_gelu)]:
        np.testing.assert_allclose(
            tf(tx).float().numpy(), np.asarray(jf(jx), np.float32), **tol
        )
    if dtype == "float32":  # erf form, not tanh
        np.testing.assert_allclose(port_layers.gelu_exact(tx).numpy(), F.gelu(tx).numpy())


# ---------------------------------------------------------------- towers


def test_vit_tower_matches_jax():
    kw = dict(image_size=112, patch_size=16, width=64, layers=2, heads=4, embed_dim=32)
    jmodel = JaxViT(**kw)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 112, 112, 3)))
    flat = random_flat(variables["params"], seed=11)
    port = load_jax_params(VisionTransformer(**kw), flat)
    x = images(4, 112)
    want = jit_apply(jmodel, fill_from_flat(variables["params"], flat), x)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)


def test_text_tower_matches_jax_with_eot_mid_sequence():
    kw = dict(vocab_size=512, context_length=77, width=32, heads=4, layers=2, embed_dim=32)
    jmodel = JaxText(**kw)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 77), jnp.int32))
    flat = random_flat(variables["params"], seed=13)
    port = load_jax_params(TextTransformer(**kw), flat)
    tokens = token_rows(6, 77, 512)
    want = jit_apply(jmodel, fill_from_flat(variables["params"], flat), tokens)
    with torch.no_grad():
        got = port(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tower", ["image", "text"])
def test_clip_encode_matches_jax(clip_pair, dtype, tower):
    jmodel, params, flat = clip_pair
    cfg = jmodel.cfg
    jmodel = jmodel.clone(dtype=getattr(jnp, dtype))
    port = load_jax_params(port_clip.create_model("port-test", dtype=getattr(torch, dtype)), flat)
    if tower == "image":
        x = images(4, cfg.image_size, seed=17)
        want = jit_apply(jmodel, params, x, jax_clip.CLIP.encode_image)
        with torch.no_grad():
            got = port.encode_image(torch.from_numpy(x))
    else:
        x = token_rows(4, cfg.context_length, cfg.vocab_size, seed=19)
        want = jit_apply(jmodel, params, x, jax_clip.CLIP.encode_text)
        with torch.no_grad():
            got = port.encode_text(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, **FP32)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=BF16_ATOL * np.abs(want).max())


def test_quickgelu_entry_uses_quick_gelu():
    m = port_clip.create_model("tiny-test")
    q = port_clip.CLIP(dataclasses.replace(m.cfg, quick_gelu=True))
    assert m.visual.transformer.resblocks[0].mlp.act is port_layers.gelu_exact
    assert q.visual.transformer.resblocks[0].mlp.act is port_layers.quick_gelu
