"""The fused LayerNorm + qkv kernel and the backward's LayerNorm kernel
(``ops/csrc/ln_qkv.cu``) against their plain PyTorch versions, on the
card.

Every test here needs a CUDA device and skips without one.  This file
imports no JAX, so it also runs on a machine that has only PyTorch::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda*.py -q

(``--noconftest``: the suite's conftest imports JAX.)

Tolerances: bf16, kernel and plain version round the same fp32 sums
twice (the product, then the bias added), summed in other orders, so an
output near a rounding boundary may land one bf16 step (2^-8 relative)
apart; fp32, the order of the sums only (W terms of O(1)).  Over the
tile-edge cases' 10^7-10^8 outputs the two roundings meet: the row
statistics, summed in another order, may round one normalized element
the other way, the product then rounds a step apart, and where the bias
sum falls on a tie the second rounding carries that to two steps (for
example, products rounded to -2.21875 and -2.203125, a step apart, plus
the bias 0.1328125 are the ties -2.0859375 and -2.0703125, which round
to even, -2.09375 and -2.0625), so those cases hold bf16 to two steps
(2^-6 relative; the JAX package's own tests of this kernel take 2e-2).
On rows
shifted by s standard deviations the fast variance cancels, and the
sums' order-dependent rounding reaches it multiplied by 1 + s², so the
fp32 tolerances grow by that factor.

The backward's LayerNorm (y, dx, dscale, dbias) against autograd of the
plain version: y and dx are fp32 values rounded once to their type, from
row statistics summed in other orders, so they may land one step of
their type apart (2^-7 relative in bf16), plus 1e-5·(1 + s²) of the
largest entry where the fp32 terms cancel (y = x̂·scale + bias near 0,
dx = rstd·(dŷ − mean(dŷ) − x̂·mean(dŷ·x̂)) near 0); dscale and dbias sum N
fp32 products in another order: rtol 1e-4, atol 1e-5 of the largest
entry (as the other backward kernels' fp32 gradients).
"""

import numpy as np
import pytest
import torch

from sparsify_clip_tpu_torch.models.layers import ResidualAttentionBlock, gelu_exact
from sparsify_clip_tpu_torch.ops.ln_qkv import (
    LnQkvFunction, ln_fast_bwd, ln_fast_bwd_reference, ln_qkv_core, ln_qkv_fwd,
    ln_qkv_reference,
)

pytestmark = pytest.mark.cuda

TOL = {torch.bfloat16: dict(rtol=1e-2, atol=1e-2), torch.float32: dict(rtol=1e-5, atol=1e-5)}
STEP = {torch.bfloat16: 2.0 ** -7, torch.float32: 2.0 ** -23}  # one step of the type, relative
GRAD = (1e-4, 1e-5)  # dscale, dbias: rtol, atol relative to the largest entry
EPS = 1e-5


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(n, w, dtype, device, seed=0, shift=0.0):
    """x (N, W) in ``dtype``; LayerNorm scale and bias, the in_proj weight
    (3W, W) and bias fp32, as a training model holds them."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(device)

    x = t(rng.standard_normal((n, w)) + shift).to(dtype)
    return (x, t(1 + 0.1 * rng.standard_normal(w)), t(0.1 * rng.standard_normal(w)),
            t(rng.standard_normal((3 * w, w)) * w ** -0.5), t(0.1 * rng.standard_normal(3 * w)))


def _dy(n, w, dtype, device, seed):
    """A gradient of the normalized rows, (N, W) in ``dtype``."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((n, w)).astype(np.float32)).to(device, dtype)


def _check_bwd(got, want, dtype, shift=0.0):
    """(y, dx, dscale, dbias) of the kernel against the plain version."""
    cancel = 1e-5 * (1 + shift ** 2)
    for name, a, b in zip(("y", "dx", "dscale", "dbias"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        big = b.float().abs().max().item()
        if name in ("y", "dx"):
            tol = dict(rtol=STEP[dtype], atol=cancel * big)
        else:
            tol = dict(rtol=GRAD[0], atol=GRAD[1] * big)
        torch.testing.assert_close(a.float(), b.float(), msg=name, **tol)


CASES = [
    (36928, 1024, torch.bfloat16),   # ViT-L-14-336 vision at batch 64
    (4928, 768, torch.bfloat16),     # its text tower
    (9232, 1024, torch.float32),     # the fp32 eval twin (batch 16)
    (1000, 1664, torch.bfloat16),    # the widest tower, 32-row tiles, ragged
    (1000, 1664, torch.float32),
] + [
    (n, w, dtype)
    for n, w in ((1, 8), (33, 72), (300, 64), (129, 520), (77, 1280), (65, 1408))
    for dtype in (torch.bfloat16, torch.float32)
]


@pytest.mark.parametrize("n,w,dtype", CASES)
def test_kernel_matches_plain_version(device, n, w, dtype):
    args = _inputs(n, w, dtype, device)
    got = ln_qkv_fwd(*args, EPS)
    want = ln_qkv_reference(*args, EPS)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (n, 3 * w)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,w,cols", [(12800, 768, 1152), (19712, 512, 768), (300, 768, 576),
                                      (129, 520, 8), (77, 1024, 1544)])
def test_kernel_takes_a_tensor_parallel_ranks_columns(device, n, w, cols, dtype):
    """Under tensor parallelism a block's in_proj keeps a rank's 3W/tp rows
    (ViT-B-32 at tp 2: vision 1152, text 768; tp 4: 576): the kernel takes
    any output width that 8 divides, a ragged last column tile included."""
    x, scale, bias, weight, kbias = _inputs(n, w, dtype, device, seed=n + cols)
    args = (x, scale, bias, weight[:cols].contiguous(), kbias[:cols].contiguous())
    got, want = ln_qkv_fwd(*args, EPS), ln_qkv_reference(*args, EPS)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (n, cols)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shift", [0.0, 3.0])
@pytest.mark.parametrize("w", [8, 72, 520, 768, 1024, 1408, 1664])
@pytest.mark.parametrize("n", [1, 63, 64, 127, 129, 36928])
def test_both_kernels_at_the_tile_edges(device, n, w, shift, dtype):
    """Row counts around the 128-row tile and 64-row backward block (36928
    = 288 * 128 + 64: a half-full last tile), widths with a k tail (8, 72,
    520, 1408), a ragged last column tile (W 8, 72, 520: 3W is no multiple
    of 192) and the towers' widths, rows with |mean|/std 0 and 3."""
    seed = 7 * n + w
    args = _inputs(n, w, dtype, device, seed=seed, shift=shift)
    got, want = ln_qkv_fwd(*args, EPS), ln_qkv_reference(*args, EPS)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (n, 3 * w)
    if dtype == torch.float32:
        tol = {k: v * (1 + shift ** 2) for k, v in TOL[dtype].items()}
    else:
        # over 10^7-10^8 outputs the two roundings meet: where one y
        # element rounds the other way, the product may round a step apart,
        # and a tie in the bias sum's rounding carries that to two steps
        tol = dict(rtol=2 * STEP[dtype], atol=TOL[dtype]["atol"])
    torch.testing.assert_close(got.float(), want.float(), **tol)
    del got, want
    x, scale, bias = args[:3]
    dy = _dy(n, w, dtype, device, seed + 1)
    before = ln_fast_bwd.launches
    got = ln_fast_bwd(x, dy, scale, bias, EPS)
    assert ln_fast_bwd.launches == before + 1
    want = ln_fast_bwd_reference(x, dy, scale, bias, EPS)
    torch.cuda.synchronize()
    _check_bwd(got, want, dtype, shift)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_shifted_rows(device, dtype):
    # |mean|/std = 3: the fast variance's cancellation stays under the
    # tolerance (1e-5 * (1 + 3^2) in fp32)
    args = _inputs(500, 1024, dtype, device, seed=3, shift=3.0)
    got, want = ln_qkv_fwd(*args, EPS), ln_qkv_reference(*args, EPS)
    torch.cuda.synchronize()
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 else TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_two_runs_are_bit_identical(device, dtype):
    args = _inputs(4928, 768, dtype, device, seed=8)
    assert torch.equal(ln_qkv_fwd(*args, EPS), ln_qkv_fwd(*args, EPS))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_two_runs_are_bit_identical(device, dtype):
    # dscale and dbias are reduced over 577 blocks in a fixed order
    x, scale, bias = _inputs(36928, 1024, dtype, device, seed=9)[:3]
    dy = _dy(36928, 1024, dtype, device, 10)
    first, second = ln_fast_bwd(x, dy, scale, bias, EPS), ln_fast_bwd(x, dy, scale, bias, EPS)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_function_gradient_is_autograd_of_the_plain_version(device, dtype):
    x, *rest = _inputs(1154, 1024, dtype, device, seed=4)
    g = torch.randn(1154, 3072, device=device, generator=torch.Generator(device).manual_seed(5))
    grads = []
    for fn in (lambda *a: LnQkvFunction.apply(*a, EPS, dtype),
               lambda *a: ln_qkv_reference(*a, EPS, dtype)):
        leaves = [t.detach().clone().requires_grad_(True) for t in (x, *rest)]
        fn(*leaves).backward(g.to(dtype))
        grads.append([t.grad for t in leaves])
    torch.cuda.synchronize()
    # dx, dscale and dbias come from the backward's LayerNorm kernel (the
    # module docstring's tolerances; dx one step of x's type); dW = gᵀ·y
    # from the kernel's y, which may sit one step of the type from the
    # plain y: the forward's bf16 tolerance against the largest entry;
    # db = Σ g is the same torch arithmetic on both sides
    names = ("dx", "dscale", "dbias", "dweight", "dkbias")
    for name, got, want in zip(names, *grads):
        assert got.dtype == want.dtype, name
        big = want.float().abs().max().item()
        if name == "dx":
            tol = dict(rtol=STEP[dtype], atol=1e-5 * big)
        elif name in ("dscale", "dbias"):
            tol = dict(rtol=GRAD[0], atol=GRAD[1] * big)
        elif name == "dweight":
            tol = dict(rtol=TOL[dtype]["rtol"], atol=TOL[dtype]["atol"] * big)
        else:
            tol = dict(rtol=0, atol=0)
        torch.testing.assert_close(got.float(), want.float(), msg=name, **tol)


def test_launches_count_once_a_call_and_the_backward_launches_the_layernorm_kernel_once(device):
    x, *rest = _inputs(2 * 577, 1024, torch.bfloat16, device)
    before, before_bwd = ln_qkv_fwd.launches, ln_fast_bwd.launches
    ln_qkv_fwd(x, *rest, EPS)
    ln_qkv_reference(x, *rest, EPS)
    assert ln_qkv_fwd.launches == before + 1
    leaves = [t.detach().clone().requires_grad_(True) for t in (x, *rest)]
    out = ln_qkv_core(leaves[0].view(2, 577, 1024), *leaves[1:], EPS)
    assert ln_qkv_fwd.launches == before + 2
    out.float().sum().backward()
    torch.cuda.synchronize()
    assert ln_qkv_fwd.launches == before + 2
    assert ln_fast_bwd.launches == before_bwd + 1
    assert all(t.grad is not None and torch.isfinite(t.grad.float()).all() for t in leaves)


def test_fused_block_launches_the_kernel_and_matches_the_unfused_block(device):
    torch.manual_seed(0)
    unfused = ResidualAttentionBlock(1024, 16, None, gelu_exact, False).to(device)
    for p in unfused.parameters():
        torch.nn.init.normal_(p, 0.0, 0.03) if p.ndim > 1 else torch.nn.init.normal_(p, 0.0, 0.1)
    fused = ResidualAttentionBlock(1024, 16, None, gelu_exact, False, fused_ln_qkv=True).to(device)
    fused.load_state_dict(unfused.state_dict())
    x = torch.randn(2, 577, 1024, device=device)
    before = ln_qkv_fwd.launches
    with torch.no_grad():
        got, want = fused(x), unfused(x)
    torch.cuda.synchronize()
    assert ln_qkv_fwd.launches == before + 1
    # fast and exact LayerNorm variance, fp32 sums in other orders
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_kernel_refuses_what_it_does_not_take(device):
    x, scale, bias, weight, kbias = _inputs(16, 64, torch.float32, device)
    with pytest.raises(TypeError, match="output's type"):
        ln_qkv_fwd(x, scale, bias, weight, kbias, EPS, torch.bfloat16)
    with pytest.raises(TypeError, match="bf16 or fp32"):
        ln_qkv_fwd(x.half(), scale, bias, weight, kbias, EPS)
    with pytest.raises(ValueError, match="multiple of 8"):
        ln_qkv_fwd(*_inputs(4, 60, torch.float32, device), EPS)
    with pytest.raises(ValueError, match="multiple of 8"):
        ln_qkv_fwd(*_inputs(4, 1672, torch.float32, device), EPS)
    with pytest.raises(ValueError, match="contiguous"):
        ln_qkv_fwd(torch.zeros(64, 16, device=device).t(), scale, bias, weight, kbias, EPS)
    with pytest.raises(ValueError, match="weight"):
        ln_qkv_fwd(x, scale, bias, weight[:96], kbias, EPS)
    flat = torch.zeros(x.numel() + 1, device=device)
    view = flat[1:].view(x.shape)
    assert view.is_contiguous() and view.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        ln_qkv_fwd(view, scale, bias, weight, kbias, EPS)


def test_backward_kernel_refuses_what_it_does_not_take(device):
    x, scale, bias = _inputs(16, 64, torch.float32, device)[:3]
    dy = _dy(16, 64, torch.float32, device, 0)
    with pytest.raises(TypeError, match="one type"):
        ln_fast_bwd(x, dy.bfloat16(), scale, bias, EPS)
    with pytest.raises(ValueError, match="one shape"):
        ln_fast_bwd(x, dy[:8], scale, bias, EPS)
    with pytest.raises(ValueError, match="multiple of 8"):
        ln_fast_bwd(x[:, :60].contiguous(), dy[:, :60].contiguous(), scale[:60], bias[:60], EPS)
    with pytest.raises(ValueError, match="contiguous"):
        ln_fast_bwd(x, torch.zeros(64, 16, device=device).t(), scale, bias, EPS)
    with pytest.raises(ValueError, match="scale and bias"):
        ln_fast_bwd(x, dy, scale[:32], bias, EPS)
    flat = torch.zeros(dy.numel() + 1, device=device)
    view = flat[1:].view(dy.shape)
    assert view.is_contiguous() and view.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        ln_fast_bwd(x, view, scale, bias, EPS)
