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
from sparsify_clip_tpu.ops.pallas_attention import _run_fwd, mha_pallas
from sparsify_clip_tpu_torch.ops import _build
from sparsify_clip_tpu_torch.ops.attention import (
    attention_core, mha_bwd_reference, mha_fwd, mha_fwd_reference,
)

SHAPES = [
    (4, 50, 96, 12, False),   # ViT-like: 50 tokens
    (4, 77, 64, 8, True),     # text-like: 77 tokens, causal
    (2, 16, 32, 2, False),
]
FP32 = dict(rtol=2e-5, atol=2e-6)
# the CUDA forward's tile edges (query tiles of up to 128 rows, 64-key
# stages): one short of an edge, on it and one over, ViT-L-14's length
# (257 = 4 × 64 + 1: a one-key last stage) and ViT-L-14-336's; head_dim 8
# and 88 (zero-filled to 16), 64 and the widest, 128
EDGE_SHAPES = [
    (l, head_dim, causal)
    for l in (63, 64, 65, 127, 128, 129, 257, 577)
    for head_dim in (8, 64, 88, 128)
    for causal in (False, True)
]


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


@pytest.mark.parametrize("l,head_dim,causal", EDGE_SHAPES)
def test_reference_and_lse_match_pallas_kernel_at_tile_edges(l, head_dim, causal):
    heads = 2
    x = _qkv(1, l, heads * head_dim, seed=l + head_dim)
    with pltpu.force_tpu_interpret_mode():
        want, want_lse = (np.asarray(a) for a in _run_fwd(jnp.asarray(x), heads, causal))
    got, lse = mha_fwd_reference(torch.from_numpy(x), heads, causal, with_lse=True)
    np.testing.assert_allclose(got.numpy(), want, **FP32)
    np.testing.assert_allclose(lse.numpy(), want_lse, **FP32)


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


def test_ptxas_usage_names_each_kernel(monkeypatch):
    symbols = [
        "_ZN43_GLOBAL__N__a5e578d3_10_mha_fwd_cu_fc8036118attn_fwd20mha_fwd_wgmma_kernelILb0EEE"
        "vPK13__nv_bfloat16PS2_Pfiiif",
        "_ZN12_GLOBAL__N_122mha_bwd_dq_bf16_kernelILi64ENS_13HeadGroupRowsEEEvPK13__nv_bfloat16"
        "PfS5_S4_PS2_S5_iiiif",
    ]
    names = {symbols[0]: "attn_fwd::mha_fwd_wgmma_kernel<false>",
             symbols[1]: "mha_bwd_dq_bf16_kernel<64, HeadGroupRows>"}
    monkeypatch.setattr(_build, "demangle", lambda got: [names[s] for s in got])
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{symbols[0]}' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 112 registers, used 1 barriers, 400 bytes cmem[0]",
        f"ptxas info    : Compiling entry function '{symbols[1]}' for 'sm_90a'",
        "    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads",
        "ptxas info    : Used 96 registers, used 1 barriers, 1024 bytes smem, 400 bytes cmem[0]",
    ])
    assert _build.ptxas_usage(log) == [
        {"source": "mha_fwd.cu", "kernel": "attn_fwd::mha_fwd_wgmma_kernel<false>",
         "spill_stores": 0, "spill_loads": 0, "registers": 112, "static_smem": 0},
        {"source": "", "kernel": "mha_bwd_dq_bf16_kernel<64, HeadGroupRows>",
         "spill_stores": 4, "spill_loads": 12, "registers": 96, "static_smem": 1024},
    ]
    assert _build.ptxas_usage("no entry functions") == []


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_reference_matches_the_pallas_vjp_at_vit_l14_length(dtype):
    """Row 3 at ViT-L-14's vision length, L = 257, head_dim 64 (the CUDA
    backward's 32-row tiles end on a one-row tile), as
    tests/test_torch_port_train_ops.py holds it at L 5 and 17."""
    from test_torch_port_train_ops import BF16, FP32 as FP32_GRAD, _attention_inputs, _jax_vjp

    heads = 2
    qkv, dout = _attention_inputs(257, dtype, b=1, w=heads * 64, seed=257)
    want = _jax_vjp(qkv, dout, heads, False, dtype)
    x = torch.from_numpy(qkv).to(getattr(torch, dtype))
    _, lse = mha_fwd_reference(x, heads, False, with_lse=True)
    got = mha_bwd_reference(x, lse, torch.from_numpy(dout).to(x.dtype), heads, False)
    np.testing.assert_allclose(got.float().numpy(), want,
                               **(FP32_GRAD if dtype == "float32" else BF16))
