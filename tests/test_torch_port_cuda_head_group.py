"""The head-group attention kernels (the forward of ``ops/csrc/mha_fwd.cu``
and the backward of ``ops/csrc/mha_head_group.cu``) against their plain
PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one.  This file
imports no JAX, so it also runs on a machine that has only PyTorch::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda*.py -q

(``--noconftest``: the suite's conftest imports JAX.)
"""

import numpy as np
import pytest
import torch

from sparsify_clip_tpu_torch.ops.attention import (
    MhaHeadGroupFunction, attention_core, mha_bwd_head_group, mha_bwd_head_group_reference,
    mha_fwd, mha_fwd_head_group, mha_fwd_head_group_reference,
)

pytestmark = pytest.mark.cuda

# bf16: kernel and plain version round the same fp32 result once, their
# fp32 sums run in other orders, so a value near a rounding boundary may
# land one bf16 step (2^-8 relative) apart.  fp32 forward: the order of
# the sums only.  fp32 backward: against the largest entry, since dS =
# P∘(dP − Dr) cancels and the small entries carry the terms' rounding
# over up to 577 keys.
FWD_TOL = {torch.bfloat16: dict(rtol=1e-2, atol=1e-2), torch.float32: dict(rtol=1e-5, atol=1e-5)}
BF16_BWD_TOL = dict(rtol=1e-2, atol=1e-2)
FP32_BWD_TOL = (1e-4, 1e-5)  # rtol, atol relative to the largest entry


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _normal(shape, dtype, device, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(device=device, dtype=dtype)


def _inputs(b, l, heads, head_dim, dtype, device, seed=0):
    width = heads * head_dim
    return (_normal((b, l, 3 * width), dtype, device, seed),
            _normal((b, l, width), dtype, device, seed + 1))


def _assert_bwd_close(got, want, dtype):
    if dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), want.float(), **BF16_BWD_TOL)
    else:
        rtol, atol = FP32_BWD_TOL
        torch.testing.assert_close(got, want, rtol=rtol, atol=atol * want.abs().max().item())


CASES = [
    (b, l, heads, head_dim, causal, dtype)
    for l in (33, 257, 577)
    for heads, head_dim in ((4, 64), (2, 128))
    for causal in (False, True)
    for dtype in (torch.bfloat16, torch.float32)
    for b in (2,)
] + [
    (8, 577, 16, 64, False, torch.bfloat16),   # the ViT-L-14-336 vision tower
    (2, 577, 16, 64, False, torch.float32),
    (16, 257, 16, 64, False, torch.float32),   # the ViT-L-14 eval twin's vision tower
    (3, 65, 6, 8, True, torch.bfloat16),       # smallest head_dim
    (3, 65, 6, 8, False, torch.float32),
    (2, 100, 4, 88, False, torch.bfloat16),    # a head_dim that is no multiple of 16
    (2, 100, 4, 88, True, torch.float32),
    (1, 1, 1, 64, True, torch.bfloat16),
    (1, 1, 1, 64, False, torch.float32),
    (8, 577, 16, 64, True, torch.bfloat16),    # the vision shape, causal
] + [
    # the bf16 tiles' edges: 64-row blocks and 32-row stages, one row short,
    # full and one over; head_dim zero-filled to 16 (8, 88) and the widest
    (1, l, 2, head_dim, causal, torch.bfloat16)
    for l in (63, 64, 65, 129)
    for head_dim in (8, 88, 128)
    for causal in (False, True)
]


@pytest.mark.parametrize("b,l,heads,head_dim,causal,dtype", CASES)
def test_forward_matches_plain_version(device, b, l, heads, head_dim, causal, dtype):
    qkv, _ = _inputs(b, l, heads, head_dim, dtype, device)
    got = mha_fwd_head_group(qkv, heads, causal)
    want = mha_fwd_head_group_reference(qkv, heads, causal)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (b, l, heads * head_dim)
    torch.testing.assert_close(got.float(), want.float(), **FWD_TOL[dtype])


# the forward's tile edges (query tiles of up to 128 rows, 64-key stages):
# one short of an edge, on it and one over, ViT-L-14's and ViT-L-14-336's
# lengths;
# a last stage of 16 and of 17 keys past 128 rows (the wgmma kernel's
# 16-key tail and the full stage after it); head_dim 8 and 88 (zero-filled
# to 16), 64 (the main path's) and 128
FWD_EDGE_CASES = [
    (l, head_dim, causal, dtype)
    for l in (63, 64, 65, 127, 128, 129, 144, 145, 257, 577)
    for head_dim in (8, 64, 88, 128)
    for causal in (False, True)
    for dtype in (torch.bfloat16, torch.float32)
]


@pytest.mark.parametrize("l,head_dim,causal,dtype", FWD_EDGE_CASES)
def test_forward_matches_plain_version_at_tile_edges(device, l, head_dim, causal, dtype):
    qkv, _ = _inputs(2, l, 2, head_dim, dtype, device, seed=l + head_dim)
    got = mha_fwd_head_group(qkv, 2, causal)
    want = mha_fwd_head_group_reference(qkv, 2, causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **FWD_TOL[dtype])


@pytest.mark.parametrize("b,l,heads,head_dim,causal,dtype", CASES)
def test_backward_matches_plain_version(device, b, l, heads, head_dim, causal, dtype):
    qkv, dout = _inputs(b, l, heads, head_dim, dtype, device)
    got = mha_bwd_head_group(qkv, dout, heads, causal)
    want = mha_bwd_head_group_reference(qkv, dout, heads, causal)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == qkv.shape
    _assert_bwd_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_function_gradient_matches_autograd_of_the_plain_forward(device, dtype):
    b, l, heads, head_dim = 2, 577, 16, 64
    qkv, _ = _inputs(b, l, heads, head_dim, dtype, device, seed=4)
    g = _normal((b, l, heads * head_dim), dtype, device, 6)
    x1 = qkv.clone().requires_grad_(True)
    x2 = qkv.clone().requires_grad_(True)
    out1 = MhaHeadGroupFunction.apply(x1, heads, False)
    out2 = mha_fwd_head_group_reference(x2, heads, False)
    out1.backward(g)
    out2.backward(g)
    torch.cuda.synchronize()
    torch.testing.assert_close(out1.float(), out2.float(), **FWD_TOL[dtype])
    _assert_bwd_close(x1.grad, x2.grad, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_two_runs_are_bit_identical(device, dtype):
    qkv, dout = _inputs(4, 577, 16, 64, dtype, device, seed=8)
    outs = [(mha_fwd_head_group(qkv, 16), mha_bwd_head_group(qkv, dout, 16)) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


def test_each_entry_point_call_counts_one_launch(device):
    qkv, dout = _inputs(2, 577, 16, 64, torch.bfloat16, device)
    fwd, bwd = mha_fwd_head_group.launches, mha_bwd_head_group.launches
    mha_fwd_head_group(qkv, 16)
    mha_bwd_head_group(qkv, dout, 16)
    mha_fwd_head_group_reference(qkv, 16)
    mha_bwd_head_group_reference(qkv, dout, 16)
    assert (mha_fwd_head_group.launches, mha_bwd_head_group.launches) == (fwd + 1, bwd + 1)


def test_attention_core_takes_the_head_group_pair_on_the_l336_vision_shape(device):
    qkv, _ = _inputs(2, 577, 16, 64, torch.bfloat16, device)
    counts = lambda: (mha_fwd.launches, mha_fwd_head_group.launches, mha_bwd_head_group.launches)
    before = counts()
    with torch.no_grad():
        attention_core(qkv, 16)
    assert counts() == (before[0], before[1] + 1, before[2])
    x = qkv.clone().requires_grad_(True)
    attention_core(x, 16).float().sum().backward()
    assert counts() == (before[0], before[1] + 2, before[2] + 1)
    assert x.grad is not None and torch.isfinite(x.grad.float()).all()


def test_kernels_refuse_what_they_do_not_take(device):
    qkv, dout = _inputs(2, 40, 2, 64, torch.float32, device)
    flat = torch.zeros(qkv.numel() + 1, device=device)
    view = flat[1:].view(qkv.shape)
    assert view.is_contiguous() and view.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        mha_fwd_head_group(view, 2)
    with pytest.raises(ValueError, match="contiguous"):
        mha_fwd_head_group(qkv.transpose(0, 1), 2)
    with pytest.raises(TypeError, match="dout in qkv's type"):
        mha_bwd_head_group(qkv, dout.bfloat16(), 2)
    with pytest.raises(ValueError, match="contiguous"):
        mha_bwd_head_group(qkv, dout.transpose(0, 1).contiguous().transpose(0, 1), 2)
    with pytest.raises(ValueError, match="head_dim"):
        mha_fwd_head_group(_normal((1, 8, 3 * 2 * 12), torch.float32, device, 0), 2)
    with pytest.raises(TypeError, match="bf16 or fp32"):
        mha_fwd_head_group(qkv.half(), 2)
