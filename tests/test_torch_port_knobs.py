"""``ln_fp32: false`` and ``onehot_embed`` in the port against the JAX
package, on the CPU.

* ``LayerNorm(fp32=False)`` against the JAX ``LayerNorm(fp32=False)``
  (flax's ``nn.LayerNorm(dtype=x.dtype)``) in bf16 on rows whose mean is
  3 standard deviations off zero: flax keeps the statistics and the
  normalization in fp32 and rounds once, so the outputs agree to one bf16
  step (2^-7 relative at the bottom of a binade), 99 % to the bit; in fp32
  to 1e-5, the fast variance's own rounding on such rows.
* A block with ``fused_ln_qkv: true, ln_fp32: false`` against the JAX
  block, which takes the unfused route (layers.py:206); the port's block
  calls no fused LN+qkv.  bf16 at tests/test_torch_port_ln_qkv.py's block
  tolerance (2e-2 of the largest output).
* ``onehot_embed``: a text tower of ``port-test``'s widths
  (tests/test_torch_port_models.py; vocab 512, so the one-hot rows stay
  small) against JAX's with the flag on.  fp32: the output and the token
  table's gradient to rtol 2e-4 / atol 2e-5 (relative to the gradient's
  largest entry).  bf16: the output equals the gather's to the bit, and
  over 256 rows sits from the JAX fp32 encode as the JAX bf16 encode does
  (``bf16_rows_close``); the table's gradient is the one-hot product's
  transpose rounded to bf16 (each entry a bf16 value, where the gather's
  fp32 ``index_add`` is not), within 2 bf16 steps of the largest entry of
  JAX's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparsify_clip_tpu.checkpoints import collect_host_arrays, fill_from_flat
from sparsify_clip_tpu.models.layers import LayerNorm as JaxLayerNorm
from sparsify_clip_tpu.models.layers import ResidualAttentionBlock as JaxBlock
from sparsify_clip_tpu.models.text import TextTransformer as JaxText
from sparsify_clip_tpu_torch.checkpoints import load_jax_params
from sparsify_clip_tpu_torch.models import layers
from sparsify_clip_tpu_torch.models.layers import LayerNorm, ResidualAttentionBlock, gelu_exact
from sparsify_clip_tpu_torch.models.text import TextTransformer

from test_torch_port_bf16 import MIN_ROWS, bf16_rows_close, caption_rows
from test_torch_port_models import FP32, random_flat

BF16_STEP = 2.0 ** -8
BLOCK_TOL = 2e-2


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_layernorm_not_fp32_matches_flax(dtype):
    rng = np.random.default_rng(0)
    x = (3 + rng.standard_normal((64, 96))).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(96)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(96)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax.jit(JaxLayerNorm(fp32=False).apply)(
        {"params": {"ln": {"scale": scale, "bias": bias}}}, jnp.asarray(x, jdt))
    assert want.dtype == jdt
    ln = LayerNorm(96, fp32=False)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(scale))
        ln.bias.copy_(torch.from_numpy(bias))
        got = ln(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=2 * BF16_STEP, atol=0)
        assert (got == want).mean() >= 0.99


def test_block_with_fused_ln_qkv_and_bf16_layernorm_takes_the_unfused_route(monkeypatch):
    width, heads = 64, 2
    x = np.random.default_rng(7).standard_normal((2, 10, width)).astype(np.float32) + 1.5
    kw = dict(width=width, heads=heads, dtype=jnp.bfloat16, ln_fp32=False)
    params = jax.jit(JaxBlock(**kw).init)(jax.random.PRNGKey(0), jnp.asarray(x, jnp.bfloat16))
    flat = {k: (1 + 0.1 * np.random.default_rng(1).standard_normal(v.shape)
                if k.endswith("scale") else 0.3 * v + 0.05).astype(np.float32)
            for k, v in collect_host_arrays(params["params"]).items()}
    params = {"params": jax.tree_util.tree_map(jnp.asarray, _unflatten(flat))}
    want = np.asarray(jax.jit(JaxBlock(fused_ln_qkv=True, **kw).apply)(
        params, jnp.asarray(x, jnp.bfloat16)), np.float32)
    block = ResidualAttentionBlock(width, heads, None, gelu_exact, False, fused_ln_qkv=True,
                                   ln_fp32=False)
    load_jax_params(block, flat)
    fused_calls = []
    monkeypatch.setattr(layers, "ln_qkv_core", lambda *a: fused_calls.append(a))
    with torch.no_grad():
        got = block(torch.from_numpy(x).to(torch.bfloat16)).float().numpy()
    assert fused_calls == [] and not block.ln_1.fp32 and not block.ln_2.fp32
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=BLOCK_TOL, atol=BLOCK_TOL * scale)


def _unflatten(flat):
    tree = {}
    for path, arr in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return tree


TEXT = dict(vocab_size=512, context_length=77, width=32, heads=4, layers=2, embed_dim=32)


@pytest.fixture(scope="module")
def onehot_pair():
    variables = jax.jit(JaxText(**TEXT).init)(jax.random.PRNGKey(0), jnp.zeros((1, 77), jnp.int32))
    flat = random_flat(variables["params"], seed=5)
    tokens = caption_rows(MIN_ROWS, 77, TEXT["vocab_size"], seed=6)
    params = fill_from_flat(variables["params"], flat)
    return params, flat, tokens, _jax_text(params, tokens, jnp.float32)


def _jax_text(params, tokens, dtype):
    """The JAX text tower's output with ``onehot_embed`` and the token
    table's gradient of Σ out·w (w fixed)."""
    model = JaxText(**TEXT, dtype=dtype, onehot_embed=True)
    w = np.random.default_rng(3).standard_normal((tokens.shape[0], TEXT["embed_dim"]))

    def f(p):
        out = model.apply({"params": p}, jnp.asarray(tokens))
        return jnp.sum(out * w), out

    (_, out), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(params)
    return np.asarray(out), np.asarray(grads["token_embedding"]), w


def _port_text(flat, tokens, dtype, onehot, w):
    tower = load_jax_params(TextTransformer(**TEXT, dtype=dtype, onehot_embed=onehot), flat)
    out = tower(torch.from_numpy(tokens))
    (out * torch.from_numpy(w).float()).sum().backward()
    return out.detach().numpy(), tower.token_embedding.weight.grad.numpy()


def test_onehot_text_tower_matches_jax_in_fp32(onehot_pair):
    params, flat, tokens, (want, want_grad, w) = onehot_pair
    got, grad = _port_text(flat, tokens, torch.float32, True, w)
    np.testing.assert_allclose(got, want, **FP32)
    np.testing.assert_allclose(grad, want_grad, rtol=FP32["rtol"],
                               atol=FP32["atol"] * np.abs(want_grad).max())


def test_onehot_text_tower_matches_jax_in_bf16(onehot_pair):
    params, flat, tokens, (want32, _, _) = onehot_pair
    want16, want_grad, w = _jax_text(params, tokens, jnp.bfloat16)
    got, grad = _port_text(flat, tokens, torch.bfloat16, True, w)
    gathered, gather_grad = _port_text(flat, tokens, torch.bfloat16, False, w)
    # a one-hot row picks the table's bf16-rounded entry: the gather's value
    np.testing.assert_array_equal(got, gathered)
    bf16_rows_close(got, want16, want32, "onehot text tower")
    # the table's gradient: the product's transpose in bf16, cast to fp32
    assert np.array_equal(grad, torch.from_numpy(grad).bfloat16().float().numpy())
    assert np.array_equal(want_grad, np.asarray(jnp.asarray(want_grad).astype(jnp.bfloat16)
                                                 .astype(jnp.float32)))
    assert not np.array_equal(gather_grad, torch.from_numpy(gather_grad).bfloat16().float().numpy())
    np.testing.assert_allclose(grad, want_grad, rtol=0,
                               atol=2 * BF16_STEP * np.abs(want_grad).max())
    used = np.unique(tokens)
    assert np.abs(grad[used]).max() > 0 and not np.abs(np.delete(grad, used, axis=0)).any()
