"""The port's training kernels against their plain PyTorch versions, on
the card: the attention backward (``ops/csrc/mha_bwd.cu``) and the
fused InfoNCE forward and backward (``ops/csrc/infonce.cu``).

Every test here needs a CUDA device and skips without one.  This file
imports no JAX, so it also runs on a machine that has only PyTorch::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda*.py -q

(``--noconftest``: the suite's conftest imports JAX.)
"""

import numpy as np
import pytest
import torch

from sparsify_clip_tpu_torch.ops import infonce
from sparsify_clip_tpu_torch.ops.attention import (
    MhaFunction, attention_core, mha_bwd, mha_bwd_reference, mha_fwd, mha_fwd_reference,
)
from sparsify_clip_tpu_torch.ops.infonce import (
    infonce_bwd_dimg, infonce_bwd_dtxt, infonce_bwd_reference, infonce_fwd,
    infonce_fwd_reference, infonce_loss,
)

pytestmark = pytest.mark.cuda

# bf16: kernel and plain version round the same fp32 gradient once, but
# their fp32 sums run in different orders, so a value near a rounding
# boundary may land one bf16 step (2^-8 relative) apart.  fp32: the order
# of the sums only; the larger atol covers L = 257 sums of O(1) terms.
BWD_TOL = {torch.bfloat16: dict(rtol=1e-2, atol=1e-2), torch.float32: dict(rtol=1e-4, atol=2e-5)}
# InfoNCE, all fp32: the kernels sum the D-long dot products and the
# N-long softmax sums in other orders than cuBLAS and logsumexp.
NCE_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _normal(shape, dtype, device, seed, scale=1.0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale
    return torch.from_numpy(x).to(device=device, dtype=dtype)


def _attention_inputs(b, l, heads, head_dim, causal, dtype, device, seed=0):
    width = heads * head_dim
    qkv = _normal((b, l, 3 * width), dtype, device, seed)
    _, lse = mha_fwd_reference(qkv, heads, causal, with_lse=True)
    dout = _normal((b, l, width), dtype, device, seed + 1)
    return qkv, lse, dout


@pytest.mark.parametrize(
    "b,l,heads,head_dim,causal,dtype",
    [
        (256, 50, 12, 64, False, torch.bfloat16),   # ViT-B-32 vision tower
        (256, 77, 8, 64, True, torch.bfloat16),     # text tower
        (16, 50, 12, 64, False, torch.float32),
        (8, 77, 8, 64, True, torch.float32),
        (4, 197, 12, 64, False, torch.bfloat16),    # ViT-B-16 vision tower
        (2, 257, 16, 64, False, torch.float32),     # ViT-L-14 vision tower
        (2, 257, 16, 64, True, torch.bfloat16),
        (2, 257, 4, 88, False, torch.float32),      # ViT-g-14's head_dim
        (2, 257, 4, 88, False, torch.bfloat16),
        (2, 257, 4, 104, False, torch.bfloat16),    # ViT-bigG-14's head_dim
        (2, 257, 4, 104, False, torch.float32),
        (4, 77, 20, 64, True, torch.bfloat16),      # ViT-bigG-14's 20-head text tower
        (3, 257, 2, 128, True, torch.float32),      # largest head_dim
        (3, 257, 2, 128, False, torch.bfloat16),
        (2, 577, 4, 64, True, torch.bfloat16),      # ViT-L-14-336 length
        (5, 33, 6, 8, True, torch.float32),         # smallest head_dim
        (5, 33, 6, 8, False, torch.bfloat16),
        (1, 1, 1, 8, True, torch.float32),
        (1, 1, 1, 64, False, torch.bfloat16),
    ] + [
        # the bf16 tiles' edges: 64-row blocks and 32-row stages, one row
        # short, full and one over; head_dim zero-filled to 16 (8, 88) and
        # the widest
        (1, l, 2, head_dim, causal, torch.bfloat16)
        for l in (63, 64, 65, 129)
        for head_dim in (8, 88, 128)
        for causal in (False, True)
    ],
)
def test_mha_bwd_matches_plain_version(device, b, l, heads, head_dim, causal, dtype):
    qkv, lse, dout = _attention_inputs(b, l, heads, head_dim, causal, dtype, device)
    got = mha_bwd(qkv, lse, dout, heads, causal)
    want = mha_bwd_reference(qkv, lse, dout, heads, causal)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == qkv.shape
    torch.testing.assert_close(got.float(), want.float(), **BWD_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [False, True])
def test_mha_bwd_two_runs_are_bit_identical(device, dtype, causal):
    """No atomics: every gradient entry is summed by one thread in a fixed
    order, so a rerun gives the same bits."""
    qkv, lse, dout = _attention_inputs(64, 77, 8, 64, causal, dtype, device, seed=8)
    runs = [mha_bwd(qkv, lse, dout, 8, causal) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])


def test_mha_bwd_counts_each_launch(device):
    qkv, lse, dout = _attention_inputs(2, 50, 12, 64, False, torch.bfloat16, device)
    before = mha_bwd.launches
    mha_bwd(qkv, lse, dout, 12)
    mha_bwd_reference(qkv, lse, dout, 12)
    assert mha_bwd.launches == before + 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_mha_bwd_takes_a_misaligned_dout(device, dtype):
    """A contiguous view that starts one element into its storage is read
    right: the fp32 kernels read elements, and the wrapper hands the bf16
    kernels (16-byte cp.async vectors) an aligned copy."""
    b, l, heads, head_dim = 2, 50, 4, 64
    qkv, lse, dout = _attention_inputs(b, l, heads, head_dim, False, dtype, device)
    flat = torch.zeros(dout.numel() + 1, dtype=dtype, device=device)
    view = flat[1:].view(dout.shape)
    view.copy_(dout)
    assert view.is_contiguous() and view.data_ptr() % 16
    torch.testing.assert_close(mha_bwd(qkv, lse, view, heads).float(),
                               mha_bwd_reference(qkv, lse, dout, heads).float(), **BWD_TOL[dtype])


def test_mha_bwd_refuses_what_it_does_not_take(device):
    qkv, lse, dout = _attention_inputs(2, 8, 2, 64, False, torch.float32, device)
    with pytest.raises(ValueError, match="contiguous"):
        mha_bwd(qkv, lse, dout.transpose(0, 1).contiguous().transpose(0, 1), 2)
    with pytest.raises(TypeError, match="dout in qkv's type"):
        mha_bwd(qkv, lse, dout.bfloat16(), 2)
    with pytest.raises(ValueError, match="head_dim"):
        bad = _normal((1, 8, 3 * 2 * 12), torch.float32, device, 0)
        mha_bwd(bad, torch.zeros(1, 8, 2, device=device), torch.zeros(1, 8, 24, device=device), 2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("strided", [False, True])
def test_function_gradient_matches_autograd_of_the_plain_forward(device, dtype, strided):
    """MhaFunction (mha_fwd + mha_bwd kernels) against autograd through
    the plain forward, with the gradient arriving as a strided view when
    ``strided``."""
    b, l, heads, head_dim = 4, 77, 8, 64
    qkv, _, _ = _attention_inputs(b, l, heads, head_dim, True, dtype, device)
    g = _normal((l, b, heads * head_dim), dtype, device, 3)
    x1 = qkv.clone().requires_grad_(True)
    x2 = qkv.clone().requires_grad_(True)
    out1 = MhaFunction.apply(x1, heads, True)
    out2 = mha_fwd_reference(x2, heads, True)[0]
    if strided:  # the transpose's backward hands the Function a strided dout
        (out1.transpose(0, 1) * g).sum().backward()
        (out2.transpose(0, 1) * g).sum().backward()
    else:
        out1.backward(g.transpose(0, 1).contiguous())
        out2.backward(g.transpose(0, 1).contiguous())
    torch.cuda.synchronize()
    torch.testing.assert_close(x1.grad.float(), x2.grad.float(), **BWD_TOL[dtype])


def test_attention_core_launches_both_kernels_only_when_a_gradient_is_wanted(device):
    qkv = _normal((2, 50, 3 * 4 * 64), torch.bfloat16, device, 0)
    fwd, bwd = mha_fwd.launches, mha_bwd.launches
    with torch.no_grad():
        attention_core(qkv.requires_grad_(True), 4)
    assert (mha_fwd.launches, mha_bwd.launches) == (fwd + 1, bwd)
    attention_core(qkv, 4).float().sum().backward()
    assert (mha_fwd.launches, mha_bwd.launches) == (fwd + 2, bwd + 1)
    assert qkv.grad is not None and qkv.grad.abs().sum() > 0


# ------------------------------------------------------------------ InfoNCE


def _embeddings(n, d, device, seed):
    x = _normal((n, d), torch.float32, device, seed)
    return x / x.norm(dim=-1, keepdim=True)


# N: the forward's 16-row tiles' edges (15, 17), the backward's 32-row
# tiles' edges (31, 33), ViT-L-14-336's batch (64) and the ragged or large
# ones (1000: 63 x 63 forward tiles); D: ViT-B-32's 512,
# ViT-L-14-336's 768, RN50's 1024, ViT-bigG-14's 1280
@pytest.mark.parametrize("n", [1, 2, 15, 16, 17, 31, 33, 64, 256, 1000])
@pytest.mark.parametrize("d", [16, 512, 768, 1024, 1280])
def test_infonce_kernels_match_plain_versions(device, n, d):
    img, txt = _embeddings(n, d, device, 0), _embeddings(n, d, device, 1)
    temp = torch.tensor(0.07, device=device)
    g = torch.tensor(1.3, device=device)
    got = infonce_fwd(img, txt, temp)
    want = infonce_fwd_reference(img, txt, temp)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, **NCE_TOL)
    _, row_lse, col_lse = want
    d_img, d_temp = infonce_bwd_dimg(img, txt, temp, row_lse, col_lse, g)
    d_txt = infonce_bwd_dtxt(img, txt, temp, row_lse, col_lse, g)
    want_img, want_txt, want_temp = infonce_bwd_reference(img, txt, temp, row_lse, col_lse, g)
    torch.cuda.synchronize()
    # the size of dZ.txt / T's terms before they cancel: g / (N T); at N = 1
    # the exact gradient is 0 and only the rounding of the terms is left
    scale = max(want_img.abs().max().item(), want_txt.abs().max().item(), 1.3 / (n * 0.07))
    torch.testing.assert_close(d_img, want_img, rtol=1e-4, atol=1e-5 * scale)
    torch.testing.assert_close(d_txt, want_txt, rtol=1e-4, atol=1e-5 * scale)
    torch.testing.assert_close(d_temp, want_temp, rtol=1e-4, atol=1e-5 * max(abs(want_temp.item()), 1.0))


@pytest.mark.parametrize("d", [16, 37, 512, 768, 1024])
def test_infonce_forward_and_backward_see_the_same_logits(device, d):
    """At N = 1 both LSEs are Z_11 and the loss is 0; the gradients are then
    exactly 0, which holds only if the backward's Z_11 equals the forward's
    bit for bit (one fmaf chain over d ascending, then / T, in both)."""
    img, txt = _embeddings(1, d, device, 10), _embeddings(1, d, device, 11)
    temp, g = torch.tensor(0.07, device=device), torch.tensor(1.3, device=device)
    loss, row_lse, col_lse = infonce_fwd(img, txt, temp)
    d_img, d_temp = infonce_bwd_dimg(img, txt, temp, row_lse, col_lse, g)
    d_txt = infonce_bwd_dtxt(img, txt, temp, row_lse, col_lse, g)
    torch.cuda.synchronize()
    torch.testing.assert_close(row_lse, (img * txt).sum(-1) / temp, **NCE_TOL)
    assert torch.equal(row_lse, col_lse) and loss.item() == 0.0
    assert not d_img.any() and not d_txt.any() and d_temp.item() == 0.0


def test_infonce_forward_two_runs_are_bit_identical(device):
    """No atomics: the tiles' partials are merged in a fixed order."""
    img, txt = _embeddings(300, 512, device, 12), _embeddings(300, 512, device, 13)
    temp = torch.tensor(0.07, device=device)
    runs = [infonce_fwd(img, txt, temp) for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_infonce_backward_two_runs_are_bit_identical(device):
    """No atomics: the tiles' shares of each gradient row and of dT are
    added in a fixed order, so a rerun gives the same bits."""
    img, txt = _embeddings(300, 512, device, 6), _embeddings(300, 512, device, 7)
    temp, g = torch.tensor(0.07, device=device), torch.tensor(1.0, device=device)
    _, row_lse, col_lse = infonce_fwd(img, txt, temp)
    args = (img, txt, temp, row_lse, col_lse, g)
    runs = [(*infonce_bwd_dimg(*args), infonce_bwd_dtxt(*args)) for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.parametrize("layout", ["odd_width", "misaligned"])
def test_infonce_backward_takes_rows_the_16_byte_path_cannot(device, layout):
    """D = 37 (no 16-byte quads) and rows starting one float into their
    storage take the kernel's 4-byte copies and scalar stores."""
    n, d = 70, 37 if layout == "odd_width" else 64
    img, txt = _embeddings(n, d, device, 8), _embeddings(n, d, device, 9)
    if layout == "misaligned":
        flat = torch.zeros(n * d + 1, device=device)
        img = flat[1:].view(n, d).copy_(img)
        assert img.is_contiguous() and img.data_ptr() % 16
    temp, g = torch.tensor(0.07, device=device), torch.tensor(1.3, device=device)
    _, row_lse, col_lse = infonce_fwd_reference(img, txt, temp)
    args = (img, txt, temp, row_lse, col_lse, g)
    d_img, d_temp = infonce_bwd_dimg(*args)
    d_txt = infonce_bwd_dtxt(*args)
    want_img, want_txt, want_temp = infonce_bwd_reference(*args)
    torch.cuda.synchronize()
    scale = max(want_img.abs().max().item(), want_txt.abs().max().item())
    torch.testing.assert_close(d_img, want_img, rtol=1e-4, atol=1e-5 * scale)
    torch.testing.assert_close(d_txt, want_txt, rtol=1e-4, atol=1e-5 * scale)
    torch.testing.assert_close(d_temp, want_temp, rtol=1e-4, atol=1e-5 * max(abs(want_temp.item()), 1.0))


@pytest.mark.parametrize("n", [15, 17, 70])
@pytest.mark.parametrize("layout", ["odd_width", "misaligned"])
def test_infonce_forward_takes_rows_the_16_byte_path_cannot(device, layout, n):
    """D = 37 and rows starting one float into their storage take the
    forward's 4-byte copies, at and past the edges of its 16-row tiles."""
    d = 37 if layout == "odd_width" else 64
    img, txt = _embeddings(n, d, device, 14), _embeddings(n, d, device, 15)
    if layout == "misaligned":
        flat = torch.zeros(n * d + 1, device=device)
        txt = flat[1:].view(n, d).copy_(txt)
        assert txt.is_contiguous() and txt.data_ptr() % 16
    temp = torch.tensor(0.07, device=device)
    got = infonce_fwd(img, txt, temp)
    want = infonce_fwd_reference(img, txt, temp)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, **NCE_TOL)


def test_infonce_loss_gradients_match_autograd_of_the_plain_loss(device):
    from sparsify_clip_tpu_torch.losses.contrastive import contrastive_loss

    img, txt = _embeddings(256, 512, device, 4), _embeddings(256, 512, device, 5)
    leaves = []
    for fn in (infonce_loss, contrastive_loss):
        i, t = img.clone().requires_grad_(True), txt.clone().requires_grad_(True)
        temp = torch.tensor(0.1, device=device, requires_grad=True)
        loss = fn(i, t, temp)
        loss.backward()
        leaves.append((loss.detach(), i.grad, t.grad, temp.grad))
    for a, w in zip(*leaves):
        torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-6)


def test_infonce_counts_launches_and_refuses_what_it_does_not_take(device):
    img, txt = _embeddings(8, 16, device, 0), _embeddings(8, 16, device, 1)
    temp = torch.tensor(0.1, device=device)
    before = (infonce.infonce_fwd.launches, infonce.infonce_bwd_dimg.launches,
              infonce.infonce_bwd_dtxt.launches)
    infonce_loss(img.requires_grad_(True), txt, temp).backward()
    infonce_fwd_reference(img, txt, temp)
    assert (infonce.infonce_fwd.launches, infonce.infonce_bwd_dimg.launches,
            infonce.infonce_bwd_dtxt.launches) == tuple(c + 1 for c in before)
    with pytest.raises(TypeError, match="fp32"):
        infonce_fwd(img.double(), txt.double(), temp.double())
    with pytest.raises(ValueError, match="contiguous"):
        wide = _embeddings(16, 8, device, 2).T
        infonce_fwd(wide, wide, temp)
    with pytest.raises(ValueError, match="D <= 2048"):
        big = _embeddings(4, 4096, device, 3)
        infonce_fwd(big, big, temp)
