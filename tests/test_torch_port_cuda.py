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

from sparsify_clip_tpu_torch.ops.attention import mha_fwd, mha_fwd_reference

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
