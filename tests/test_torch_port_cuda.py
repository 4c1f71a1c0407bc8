"""The port's CUDA attention kernel against its plain PyTorch version, on
the card.

Every test here needs a CUDA device and skips without one.  This file
imports no JAX, so it also runs on a machine that has only PyTorch::

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q

(``--noconftest``: the suite's conftest imports JAX.)
"""

import numpy as np
import pytest
import torch

from sparsify_clip_tpu_torch.ops.attention import (
    mha_bwd, mha_bwd_reference, mha_fwd, mha_fwd_head_group, mha_fwd_reference,
)

pytestmark = pytest.mark.cuda

# bf16: the kernel and the plain version round the same fp32 context once,
# but their fp32 sums run in different orders, so a value near a rounding
# boundary may land one bf16 step apart (2^-8 relative).  fp32: order only.
TOL = {torch.bfloat16: dict(rtol=1e-2, atol=1e-2), torch.float32: dict(rtol=1e-5, atol=1e-5)}


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _qkv(b, l, heads, head_dim, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, 3 * heads * head_dim)).astype(np.float32)
    return torch.from_numpy(x).to(device=device, dtype=dtype)


@pytest.mark.parametrize(
    "b,l,heads,head_dim,causal,dtype",
    [
        (256, 50, 12, 64, False, torch.bfloat16),   # ViT-B-32 vision tower
        (256, 77, 8, 64, True, torch.bfloat16),     # text tower
        (64, 50, 12, 64, False, torch.float32),
        (8, 577, 16, 64, False, torch.bfloat16),    # ViT-L-14-336 vision tower
        (2, 577, 16, 64, True, torch.bfloat16),
        (16, 257, 16, 64, False, torch.bfloat16),   # ViT-L-14 vision tower (a one-key last stage)
        (4, 130, 3, 64, True, torch.bfloat16),      # ragged last query and key tiles
        (4, 77, 8, 64, True, torch.float32),
        (3, 33, 2, 128, True, torch.float32),       # largest head_dim
        (3, 33, 2, 128, True, torch.bfloat16),
        (2, 257, 4, 88, False, torch.float32),      # ViT-g-14's head_dim (not a multiple of 16)
        (2, 257, 4, 88, False, torch.bfloat16),
        (2, 50, 2, 104, True, torch.bfloat16),      # ViT-bigG-14's head_dim
        (5, 16, 12, 8, False, torch.float32),       # smallest head_dim
        (5, 16, 12, 8, False, torch.bfloat16),
        (1, 1, 1, 8, True, torch.float32),
        (1, 1, 1, 8, True, torch.bfloat16),
    ],
)
def test_kernel_matches_plain_version(device, b, l, heads, head_dim, causal, dtype):
    qkv = _qkv(b, l, heads, head_dim, dtype, device)
    got, got_lse = mha_fwd(qkv, heads, causal, with_lse=True)
    want, want_lse = mha_fwd_reference(qkv, heads, causal, with_lse=True)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (b, l, heads * head_dim)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    torch.testing.assert_close(got_lse, want_lse, rtol=1e-5, atol=1e-5)


# the forward's tile edges (query tiles of up to 128 rows, 64-key stages):
# one short of an edge, on it and one over, ViT-L-14's and ViT-L-14-336's
# lengths;
# a last stage of 16 and of 17 keys past 128 rows (the wgmma kernel's
# 16-key tail and the full stage after it); head_dim 8 and 88 (zero-filled
# to 16), 64 (the main path's) and 128
EDGE_CASES = [
    (l, head_dim, causal, dtype)
    for l in (63, 64, 65, 127, 128, 129, 144, 145, 257, 577)
    for head_dim in (8, 64, 88, 128)
    for causal in (False, True)
    for dtype in (torch.bfloat16, torch.float32)
]


@pytest.mark.parametrize("l,head_dim,causal,dtype", EDGE_CASES)
def test_kernel_matches_plain_version_at_tile_edges(device, l, head_dim, causal, dtype):
    qkv = _qkv(2, l, 2, head_dim, dtype, device, seed=l + head_dim)
    got, got_lse = mha_fwd(qkv, 2, causal, with_lse=True)
    want, want_lse = mha_fwd_reference(qkv, 2, causal, with_lse=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    torch.testing.assert_close(got_lse, want_lse, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("l,heads,causal", [(50, 12, False), (77, 8, True), (577, 16, False)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_two_runs_are_bit_identical(device, l, heads, causal, dtype):
    qkv = _qkv(8, l, heads, 64, dtype, device, seed=8)
    runs = [mha_fwd(qkv, heads, causal, with_lse=True) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])


def _context_p_hi_only(qkv, heads, causal):
    """A control: the plain fp32 forward with the softmax numerator rounded
    to bf16 before P.V, which is what the bf16 kernel would compute if it
    dropped P's lo half."""
    b, l, w3 = qkv.shape
    d = w3 // (3 * heads)
    q, k, v = qkv.float().view(b, l, 3, heads, d).permute(2, 0, 3, 1, 4)
    s = (q @ k.transpose(-1, -2)) * d ** -0.5
    if causal:
        above = torch.ones(l, l, dtype=torch.bool, device=s.device).triu(1)
        s = s.masked_fill(above, float("-inf"))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    ctx = (e.bfloat16().float() @ v) / e.sum(dim=-1, keepdim=True)
    return ctx.transpose(1, 2).reshape(b, l, w3 // 3)


# The bf16 context's mean error against the unrounded fp32 plain context,
# over the mean magnitude.  Rounding the context to bf16 alone costs about
# 0.0014; a P.V with P as bf16 hi alone adds its own rounding on top (the
# control, about 0.0020); so does a dropped key.  The bound lies between the
# kernel's readings and the control's (PERF.md, "P.V precision").
P_LO_BOUND = 0.0016


@pytest.mark.parametrize(
    "forward,b,l,heads,causal",
    [
        (mha_fwd, 256, 50, 12, False),              # ViT-B-32 vision tower
        (mha_fwd, 256, 77, 8, True),                # text tower
        (mha_fwd_head_group, 64, 577, 16, False),   # ViT-L-14-336 vision tower (wgmma)
        (mha_fwd_head_group, 64, 577, 16, True),
    ],
    ids=["vision-50", "text-77-causal", "vision-577", "vision-577-causal"],
)
def test_bf16_context_keeps_the_fp32_grade_of_p(device, record_property, forward, b, l, heads,
                                                causal):
    qkv = _qkv(b, l, heads, 64, torch.bfloat16, device, seed=l)
    got = forward(qkv, heads, causal)
    got = (got[0] if isinstance(got, tuple) else got).float()
    want = mha_fwd_reference(qkv.float(), heads, causal)[0]
    control = _context_p_hi_only(qkv, heads, causal).bfloat16().float()
    scale = want.abs().mean()
    kernel_err = ((got - want).abs().mean() / scale).item()
    control_err = ((control - want).abs().mean() / scale).item()
    record_property("kernel_rel_err", kernel_err)
    record_property("p_hi_only_rel_err", control_err)
    assert kernel_err < P_LO_BOUND < control_err, (kernel_err, control_err)


def test_kernel_without_lse_gives_the_same_context(device):
    qkv = _qkv(4, 77, 8, 64, torch.bfloat16, device)
    with_lse, _ = mha_fwd(qkv, 8, True, with_lse=True)
    without, lse = mha_fwd(qkv, 8, True)
    assert lse is None
    assert torch.equal(with_lse, without)


def test_each_launch_is_counted(device):
    qkv = _qkv(2, 50, 12, 64, torch.bfloat16, device)
    before = mha_fwd.launches
    mha_fwd(qkv, 12)
    mha_fwd_reference(qkv, 12)
    assert mha_fwd.launches == before + 1


@pytest.mark.parametrize("head_dim", [12, 136])
def test_kernel_rejects_unsupported_head_dim(device, head_dim):
    qkv = _qkv(1, 8, 2, head_dim, torch.float32, device)
    with pytest.raises(ValueError, match="head_dim"):
        mha_fwd(qkv, 2)


def test_kernel_rejects_non_contiguous_and_other_types(device):
    qkv = _qkv(2, 8, 2, 64, torch.float32, device)
    with pytest.raises(ValueError, match="contiguous"):
        mha_fwd(qkv.transpose(0, 1), 2)
    with pytest.raises(TypeError):
        mha_fwd(qkv.half(), 2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_rejects_a_misaligned_view(device, dtype):
    """A contiguous view that starts one element into its storage would
    fault on the kernel's 16-byte loads; the wrapper raises instead, and
    the context stays usable."""
    b, l, heads, head_dim = 2, 8, 2, 64
    n = b * l * 3 * heads * head_dim
    flat = torch.zeros(n + 1, dtype=dtype, device=device)
    qkv = flat[1:].view(b, l, 3 * heads * head_dim)
    assert qkv.is_contiguous() and qkv.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        mha_fwd(qkv, heads)
    aligned = _qkv(b, l, heads, head_dim, dtype, device)
    torch.testing.assert_close(mha_fwd(aligned, heads)[0].float(),
                               mha_fwd_reference(aligned, heads)[0].float(), **TOL[dtype])


@pytest.mark.parametrize("causal", [False, True])
def test_backward_matches_plain_version_at_vit_l14_length(device, causal):
    """Row 3 at ViT-L-14's vision shape, L = 257 with 16 heads of 64 in
    bf16 (the backward's 32-row tiles end on a one-row tile), under the
    backward's bf16 tolerance (tests/test_torch_port_cuda_train.py)."""
    qkv = _qkv(16, 257, 16, 64, torch.bfloat16, device, seed=257)
    dout = _qkv(16, 257, 16, 64, torch.bfloat16, device, seed=258)[..., :16 * 64].contiguous()
    _, lse = mha_fwd(qkv, 16, causal, with_lse=True)
    got = mha_bwd(qkv, lse, dout, 16, causal)
    want = mha_bwd_reference(qkv, lse, dout, 16, causal)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == qkv.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=1e-2)
