"""The port's head-group attention route against the JAX package's, on
the CPU.

* :func:`use_head_group` is ``_use_per_head`` term for term, on every ViT
  tower of the registry in bf16 and fp32, on the JAX test's cases, and at
  the 3 MB boundary (ViT-L-14's fp32 vision tower is over it by 0.4 %);
* the plain versions and :class:`MhaHeadGroupFunction` against
  ``mha_pallas`` with ``_use_per_head`` forced on, in interpret mode, as
  tests/test_pallas_attention.py:91-120 runs it (fp32, with its
  tolerances);
* on that route ``attention_core`` saves qkv alone, no LSE.

The CUDA kernels are held against the plain versions on the card
(tests/test_torch_port_cuda_head_group.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from sparsify_clip_tpu.models.clip import MODEL_REGISTRY as JAX_REGISTRY
from sparsify_clip_tpu.ops import pallas_attention as pa
from sparsify_clip_tpu_torch.ops import attention
from sparsify_clip_tpu_torch.ops.attention import (
    MhaFunction, MhaHeadGroupFunction, attention_core, mha_bwd_head_group,
    mha_bwd_head_group_reference, mha_fwd_head_group, mha_fwd_head_group_reference,
    use_head_group,
)

from test_torch_port_models import _fresh_registry

FWD = dict(rtol=2e-5, atol=2e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)
# the ViT entries of the registry as the JAX package defines it
VIT_NAMES = ("ViT-B-32", "ViT-B-16", "ViT-L-14", "ViT-L-14-336", "ViT-H-14", "ViT-g-14",
             "ViT-bigG-14", "tiny-test", "ViT-B-32-quickgelu", "ViT-B-16-quickgelu",
             "ViT-L-14-quickgelu", "ViT-L-14-336-quickgelu")
# (b, l, w, heads, causal): the JAX per-head tests' shape, a ragged L with
# head_dim 16, and a width of two 128-lane head groups
SHAPES = [
    (2, 20, 32, 4, False),
    (2, 20, 32, 4, True),
    (2, 33, 64, 4, False),
    (2, 33, 64, 4, True),
    (1, 33, 256, 4, True),
]
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


def _towers(name):
    cfg = JAX_REGISTRY[name]
    grid = cfg.image_size // cfg.patch_size
    return {"vision": (grid * grid + 1, 3 * cfg.vision_width, cfg.vision_heads),
            "text": (cfg.context_length, 3 * cfg.text_width, cfg.text_heads)}


def test_vit_names_cover_the_registry():
    # the registry as the module defines it: test files add their own entries
    fresh = _fresh_registry("sparsify_clip_tpu.models.clip")
    assert set(VIT_NAMES) == {n for n, c in fresh.items() if c.vision_kind == "vit"}


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("name", VIT_NAMES)
def test_route_is_the_jax_route_on_every_vit_tower(name, itemsize):
    for tower, (l, w3, heads) in _towers(name).items():
        want = pa._use_per_head(l, w3, itemsize, heads)
        assert use_head_group(l, w3, itemsize, heads) == want, tower


def test_route_takes_the_l336_vision_tower_and_l14_in_fp32():
    l336, l14 = _towers("ViT-L-14-336"), _towers("ViT-L-14")
    assert l336 == {"vision": (577, 3072, 16), "text": (77, 2304, 12)}
    assert use_head_group(*l336["vision"][:2], 2, l336["vision"][2])      # 3.54 MB bf16
    assert use_head_group(*l336["vision"][:2], 4, l336["vision"][2])      # 7.09 MB fp32
    assert not use_head_group(*l14["vision"][:2], 2, l14["vision"][2])    # 1.58 MB bf16
    assert not use_head_group(*l336["text"][:2], 2, l336["text"][2])      # text: rows 1 and 3
    assert not use_head_group(*l336["text"][:2], 4, l336["text"][2])


@pytest.mark.parametrize(
    "l,w3,itemsize,heads,want",
    [
        (577, 3 * 1024, 2, 16, True),     # the cases of tests/test_pallas_attention.py:76-83
        (257, 3 * 1024, 2, 16, False),
        (257, 3 * 1280, 2, 16, False),
        (257, 3 * 1408, 2, 16, False),    # head_dim 88
        (77, 3 * 768, 2, 12, False),
        (577, 3 * 1408, 2, 16, False),    # over budget, head_dim 88 does not pack
        (257, 3 * 1024, 4, 16, True),     # 3,158,016 B: 0.4 % over the budget
        (256, 3 * 1024, 4, 16, False),    # 3,145,728 B: at the budget, not over
        (1024, 3 * 384, 4, 3, True),      # head_dim 128
        (1024, 3 * 96, 4, 3, False),      # head_dim 32 but width 96: no 128-lane packing
    ],
)
def test_route_matches_the_jax_predicate(l, w3, itemsize, heads, want):
    assert pa._use_per_head(l, w3, itemsize, heads) == want
    assert use_head_group(l, w3, itemsize, heads) == want


def _qkv(b, l, w, seed=13):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, l, 3 * w)) * 0.3).astype(np.float32)


@pytest.fixture
def per_head(monkeypatch):
    monkeypatch.setattr(pa, "_use_per_head", lambda *a: True)


@pytest.mark.parametrize("b,l,w,heads,causal", SHAPES)
def test_forward_reference_matches_the_head_group_kernel(per_head, b, l, w, heads, causal):
    x = _qkv(b, l, w)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pa.mha_pallas(jnp.asarray(x), heads, causal))
    got = mha_fwd_head_group_reference(torch.from_numpy(x), heads, causal)
    assert got.dtype == torch.float32 and got.shape == (b, l, w)
    np.testing.assert_allclose(got.numpy(), want, **FWD)
    # the CPU wrapper is the plain version
    assert torch.equal(mha_fwd_head_group(torch.from_numpy(x), heads, causal), got)


@pytest.mark.parametrize("l,head_dim,causal", EDGE_SHAPES)
def test_forward_reference_matches_the_head_group_kernel_at_tile_edges(
        per_head, l, head_dim, causal):
    heads = 2
    x = _qkv(1, l, heads * head_dim, seed=l + head_dim)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pa.mha_pallas(jnp.asarray(x), heads, causal))
    got = mha_fwd_head_group_reference(torch.from_numpy(x), heads, causal)
    np.testing.assert_allclose(got.numpy(), want, **FWD)


@pytest.mark.parametrize("b,l,w,heads,causal", SHAPES)
def test_backward_reference_and_function_match_jax_grad(per_head, b, l, w, heads, causal):
    x = _qkv(b, l, w, seed=5)

    def loss(q):
        return jnp.sum(jnp.square(pa.mha_pallas(q, heads, causal)))

    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax.grad(loss)(jnp.asarray(x)))
    t = torch.from_numpy(x).requires_grad_(True)
    out = MhaHeadGroupFunction.apply(t, heads, causal)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), want, **GRAD)
    # the plain backward on the same dout
    dqkv = mha_bwd_head_group_reference(t.detach(), 2 * out.detach(), heads, causal)
    np.testing.assert_allclose(dqkv.numpy(), want, **GRAD)


def test_backward_reference_normalises_by_division():
    """The softmax is rebuilt as e / sum(e) from q.k, the TPU head-group
    kernel's form, and agrees with the LSE-based backward to fp32
    rounding."""
    x = torch.from_numpy(_qkv(2, 33, 64, seed=3))
    g = torch.from_numpy(_qkv(2, 33, 64, seed=4)[..., :64])
    _, lse = attention.mha_fwd_reference(x, 4, True, with_lse=True)
    via_lse = attention.mha_bwd_reference(x, lse, g, 4, True)
    got = mha_bwd_head_group_reference(x, g, 4, True)
    torch.testing.assert_close(got, via_lse, rtol=1e-5, atol=1e-6)


def test_head_group_route_saves_no_lse(monkeypatch):
    """ViT-L-14-336's vision shape in fp32 (7.09 MB a sample): qkv is the
    only residual, and the whole-width forward never runs."""
    def refuse(*a, **k):
        raise AssertionError("the whole-width forward ran on the head-group route")

    monkeypatch.setattr(attention, "mha_fwd", refuse)
    x = torch.from_numpy(_qkv(1, 577, 1024, seed=7)).requires_grad_(True)
    out = attention_core(x, 16)
    assert type(out.grad_fn).__name__ == "MhaHeadGroupFunctionBackward"
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 1 and saved[0] is x
    with torch.no_grad():
        assert torch.equal(attention_core(x, 16), out)
    out.float().pow(2).sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()


def test_whole_width_route_keeps_its_lse():
    x = torch.from_numpy(_qkv(2, 77, 256, seed=8)).requires_grad_(True)
    out = attention_core(x, 4, causal=True)
    assert type(out.grad_fn).__name__ == "MhaFunctionBackward"
    qkv, lse = out.grad_fn.saved_tensors
    assert qkv is x and lse.shape == (2, 77, 4)


def test_bf16_route_follows_the_element_size(monkeypatch):
    """ViT-L-14's vision shape: fp32 (3.16 MB) takes the head-group pair,
    bf16 (1.58 MB) the whole-width pair."""
    taken = []
    monkeypatch.setattr(MhaHeadGroupFunction, "apply", lambda *a: taken.append("head_group"))
    monkeypatch.setattr(MhaFunction, "apply", lambda *a: taken.append("whole_width"))
    x = torch.zeros(1, 257, 3072)
    attention_core(x.requires_grad_(True), 16)
    attention_core(x.detach().bfloat16().requires_grad_(True), 16)
    assert taken == ["head_group", "whole_width"]


def test_cpu_tensors_take_the_plain_versions_uncounted():
    x = torch.from_numpy(_qkv(2, 16, 32))
    g = torch.from_numpy(_qkv(2, 16, 32, seed=2)[..., :32])
    before = (mha_fwd_head_group.launches, mha_bwd_head_group.launches)
    assert torch.equal(mha_fwd_head_group(x, 2, True), mha_fwd_head_group_reference(x, 2, True))
    assert torch.equal(mha_bwd_head_group(x, g, 2, True),
                       mha_bwd_head_group_reference(x, g, 2, True))
    assert (mha_fwd_head_group.launches, mha_bwd_head_group.launches) == before


def test_other_devices_and_bad_shapes_raise():
    meta = torch.empty(2, 4, 96, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        mha_fwd_head_group(meta, 2)
    with pytest.raises(ValueError, match="cpu or cuda"):
        mha_bwd_head_group(meta, torch.empty(2, 4, 32, device="meta"), 2)
    with pytest.raises(ValueError, match="packed qkv"):
        mha_fwd_head_group(torch.zeros(2, 4, 100), 2)
