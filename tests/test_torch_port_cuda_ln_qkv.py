"""The fused LayerNorm + qkv kernel (``ops/csrc/ln_qkv.cu``) against its
plain PyTorch version, on the card.

Every test here needs a CUDA device and skips without one.  This file
imports no JAX, so it also runs on a machine that has only PyTorch::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda*.py -q

(``--noconftest``: the suite's conftest imports JAX.)

Tolerances: bf16, kernel and plain version round the same fp32 sums
twice (the product, then the bias added), summed in other orders, so an
output near a rounding boundary may land one bf16 step (2^-8 relative)
apart; fp32, the order of the sums only (W terms of O(1)).
"""

import numpy as np
import pytest
import torch

from sparsify_clip_tpu_torch.models.layers import ResidualAttentionBlock, gelu_exact
from sparsify_clip_tpu_torch.ops.ln_qkv import (
    LnQkvFunction, ln_qkv_core, ln_qkv_fwd, ln_qkv_reference,
)

pytestmark = pytest.mark.cuda

TOL = {torch.bfloat16: dict(rtol=1e-2, atol=1e-2), torch.float32: dict(rtol=1e-5, atol=1e-5)}
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
    for got, want in zip(*grads):
        # the backward is the same torch arithmetic on both sides; only
        # the forward's output (unused by it) came from the kernel
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_launches_count_once_a_call_and_the_backward_launches_none(device):
    x, *rest = _inputs(2 * 577, 1024, torch.bfloat16, device)
    before = ln_qkv_fwd.launches
    ln_qkv_fwd(x, *rest, EPS)
    ln_qkv_reference(x, *rest, EPS)
    assert ln_qkv_fwd.launches == before + 1
    leaves = [t.detach().clone().requires_grad_(True) for t in (x, *rest)]
    out = ln_qkv_core(leaves[0].view(2, 577, 1024), *leaves[1:], EPS)
    assert ln_qkv_fwd.launches == before + 2
    out.float().sum().backward()
    torch.cuda.synchronize()
    assert ln_qkv_fwd.launches == before + 2
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
