"""The port's attention (sparsify_clip_tpu_torch.ops.attention) against
the JAX package's, on the CPU.

The plain PyTorch version is held against the Pallas kernel run in
interpret mode (as tests/test_pallas_attention.py runs it) and against
``attention_core``'s einsum path, on the same numpy inputs, in fp32.
The CUDA kernel itself is held against the plain version on the card
(tests/test_torch_port_cuda.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from sparsify_clip_tpu.ops.pallas_attention import attention_core as jax_attention_core
from sparsify_clip_tpu.ops.pallas_attention import mha_pallas
from sparsify_clip_tpu_torch.ops import _build
from sparsify_clip_tpu_torch.ops.attention import attention_core, mha_fwd, mha_fwd_reference

SHAPES = [
    (4, 50, 96, 12, False),   # ViT-like: 50 tokens
    (4, 77, 64, 8, True),     # text-like: 77 tokens, causal
    (2, 16, 32, 2, False),
]
FP32 = dict(rtol=2e-5, atol=2e-6)


def _qkv(b, l, w, seed=13):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, l, 3 * w)) * 0.3).astype(np.float32)


@pytest.mark.parametrize("b,l,w,heads,causal", SHAPES)
def test_reference_matches_pallas_kernel(b, l, w, heads, causal):
    x = _qkv(b, l, w)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(mha_pallas(jnp.asarray(x), heads, causal))
    got, _ = mha_fwd_reference(torch.from_numpy(x), heads, causal)
    np.testing.assert_allclose(got.numpy(), want, **FP32)


@pytest.mark.parametrize("b,l,w,heads,causal", SHAPES)
def test_reference_matches_einsum_path(b, l, w, heads, causal):
    x = _qkv(b, l, w, seed=5)
    want = np.asarray(jax_attention_core(jnp.asarray(x), heads, causal=causal))
    got = attention_core(torch.from_numpy(x), heads, causal)
    np.testing.assert_allclose(got.numpy(), want, **FP32)


def test_lse_is_the_row_logsumexp_of_the_scaled_scores():
    b, l, w, heads = 2, 16, 32, 2
    x = _qkv(b, l, w)
    _, lse = mha_fwd_reference(torch.from_numpy(x), heads, causal=True, with_lse=True)
    d = w // heads
    q = x[..., :w].reshape(b, l, heads, d)
    k = x[..., w:2 * w].reshape(b, l, heads, d)
    s = np.einsum("bqhd,bkhd->bhqk", q, k).astype(np.float64) * d ** -0.5
    s = np.where(np.triu(np.ones((l, l), bool), 1), -np.inf, s)
    want = np.log(np.exp(s).sum(-1)).transpose(0, 2, 1)  # (B, L, H)
    assert lse.shape == (b, l, heads) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-5, atol=1e-5)


def test_bf16_output_is_the_fp32_context_rounded_once():
    x = torch.from_numpy(_qkv(2, 50, 64)).bfloat16()
    got, _ = mha_fwd_reference(x, 4)
    want, _ = mha_fwd_reference(x.float(), 4)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.bfloat16())


def test_cpu_tensor_takes_the_plain_version_uncounted():
    x = torch.from_numpy(_qkv(2, 16, 32))
    before = mha_fwd.launches
    got, lse = mha_fwd(x, 2, True, with_lse=True)
    want, want_lse = mha_fwd_reference(x, 2, True, with_lse=True)
    assert torch.equal(got, want) and torch.equal(lse, want_lse)
    assert mha_fwd(x, 2)[1] is None
    assert mha_fwd.launches == before


def test_other_devices_and_bad_shapes_raise():
    with pytest.raises(ValueError, match="cpu or cuda"):
        mha_fwd(torch.empty(2, 4, 96, device="meta"), 2)
    with pytest.raises(ValueError, match="packed qkv"):
        mha_fwd(torch.zeros(2, 4, 100), 2)


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.setattr(_build.os, "access", lambda *a: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


def test_library_name_tracks_the_sources():
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libsparsify_kernels_") and path.suffix == ".so"
    assert path == _build.library_path()
    assert {p.name for p in _build._sources()} >= {"mha_fwd.cu"}
