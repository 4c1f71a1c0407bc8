"""The port's fused uniformity kernels (``ops/csrc/lunif.cu``) against
their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one.  This file
imports no JAX, so it also runs on a machine that has only PyTorch::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda*.py -q

(``--noconftest``: the suite's conftest imports JAX.)
"""

import numpy as np
import pytest
import torch

from sparsify_clip_tpu_torch.losses.unif import lunif_loss as plain_lunif_loss
from sparsify_clip_tpu_torch.ops.lunif import (
    MAX_DIM, lunif_bwd, lunif_bwd_reference, lunif_fwd, lunif_fwd_reference, lunif_loss,
)

pytestmark = pytest.mark.cuda

# All fp32.  S sums N(N-1) weights in another order than torch's sum, and
# each weight's Gram entry is an FMA chain where cuBLAS takes another
# order; the loss is the log of S.  dx is checked against its largest
# entry: r∘x − Wx cancels, so small entries carry the terms' rounding.
S_RTOL = 1e-5
LOSS_ATOL = 1e-5
DX_TOL = (1e-4, 1e-5)  # rtol, atol relative to the largest entry


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _rows(n, d, device, seed, scale=None):
    """Unit rows, or normal rows times ``scale`` (off the sphere)."""
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32))
    x = x / x.norm(dim=-1, keepdim=True) if scale is None else x * scale
    return x.to(device)


def _check_dx(got, want):
    scale = want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=DX_TOL[0], atol=DX_TOL[1] * scale)


# N: the forward's 16-row tiles' edges (15, 17), the backward's 32-row
# tiles' edges (31, 33), ViT-L-14-336's batch (64) and the ragged or large
# ones (1000: 63 x 63 forward tiles); D: ViT-B-32's 512,
# ViT-L-14-336's 768, RN50's 1024 and ViT-bigG-14's 1280 embeddings
@pytest.mark.parametrize("n", [2, 15, 16, 17, 31, 33, 64, 200, 256, 1000])
@pytest.mark.parametrize("d,scale", [(16, None), (512, None), (512, 0.05), (768, None),
                                     (1024, None), (1280, None)])
def test_lunif_kernels_match_plain_versions(device, n, d, scale):
    x = _rows(n, d, device, n + d, scale)
    s, loss = lunif_fwd(x)
    want_s, want_loss = lunif_fwd_reference(x)
    torch.testing.assert_close(s, want_s, rtol=S_RTOL, atol=0)
    torch.testing.assert_close(loss, want_loss, rtol=0, atol=LOSS_ATOL)
    g = torch.tensor(1.7, device=device)
    dx = lunif_bwd(x, want_s, g)
    torch.cuda.synchronize()
    assert dx.shape == x.shape and dx.dtype == torch.float32
    _check_dx(dx, lunif_bwd_reference(x, want_s, g))


@pytest.mark.parametrize("layout", ["odd_width", "misaligned"])
def test_lunif_bwd_takes_rows_the_16_byte_path_cannot(device, layout):
    """D = 37 (no 16-byte quads) and rows starting one float into their
    storage take the kernel's 4-byte copies and scalar stores."""
    n, d = 70, 37 if layout == "odd_width" else 64
    x = _rows(n, d, device, 5)
    if layout == "misaligned":
        flat = torch.zeros(n * d + 1, device=device)
        x = flat[1:].view(n, d).copy_(x)
        assert x.is_contiguous() and x.data_ptr() % 16
    s, _ = lunif_fwd_reference(x)
    g = torch.tensor(0.9, device=device)
    dx = lunif_bwd(x, s, g)
    torch.cuda.synchronize()
    _check_dx(dx, lunif_bwd_reference(x, s, g))


@pytest.mark.parametrize("n", [15, 17, 70])
@pytest.mark.parametrize("layout", ["odd_width", "misaligned"])
def test_lunif_fwd_takes_rows_the_16_byte_path_cannot(device, layout, n):
    """D = 37 and rows starting one float into their storage take the
    forward's 4-byte copies, at and past the edges of its 16-row tiles."""
    d = 37 if layout == "odd_width" else 64
    x = _rows(n, d, device, 6)
    if layout == "misaligned":
        flat = torch.zeros(n * d + 1, device=device)
        x = flat[1:].view(n, d).copy_(x)
        assert x.is_contiguous() and x.data_ptr() % 16
    s, loss = lunif_fwd(x)
    want_s, want_loss = lunif_fwd_reference(x)
    torch.cuda.synchronize()
    torch.testing.assert_close(s, want_s, rtol=S_RTOL, atol=0)
    torch.testing.assert_close(loss, want_loss, rtol=0, atol=LOSS_ATOL)


def test_lunif_kernels_are_deterministic(device):
    x = _rows(300, 512, device, 0)
    s1, loss1 = lunif_fwd(x)
    s2, loss2 = lunif_fwd(x)
    g = torch.tensor(1.0, device=device)
    assert torch.equal(s1, s2) and torch.equal(loss1, loss2)
    assert torch.equal(lunif_bwd(x, s1, g), lunif_bwd(x, s1, g))


@pytest.mark.parametrize("n", [200, 256])
def test_lunif_function_gradient_matches_autograd_of_the_plain_loss(device, n):
    x = _rows(n, 512, device, 7)
    results = []
    for fn in (lunif_loss, plain_lunif_loss):
        leaf = x.clone().requires_grad_(True)
        loss = fn(leaf)
        (2.5 * loss).backward()  # an incoming gradient other than 1
        results.append((loss.detach(), leaf.grad))
    torch.cuda.synchronize()
    (loss_k, dx_k), (loss_p, dx_p) = results
    torch.testing.assert_close(loss_k, loss_p, rtol=0, atol=LOSS_ATOL)
    _check_dx(dx_k, dx_p)


def test_lunif_counts_launches_and_refuses_what_it_does_not_take(device):
    x = _rows(8, 16, device, 0)
    before = (lunif_fwd.launches, lunif_bwd.launches)
    lunif_loss(x.clone().requires_grad_(True)).backward()
    lunif_fwd_reference(x)
    assert (lunif_fwd.launches, lunif_bwd.launches) == (before[0] + 1, before[1] + 1)
    with pytest.raises(TypeError, match="fp32"):
        lunif_fwd(x.double())
    with pytest.raises(ValueError, match="contiguous"):
        lunif_fwd(_rows(16, 8, device, 1).T)
    with pytest.raises(ValueError, match=f"D <= {MAX_DIM}"):
        lunif_fwd(_rows(4, MAX_DIM + 1, device, 2))
    with pytest.raises(ValueError, match="N >= 2"):
        lunif_fwd(x[:1])
    with pytest.raises(ValueError, match="one-element"):
        lunif_bwd(x, torch.ones(2, device=device), torch.ones((), device=device))
