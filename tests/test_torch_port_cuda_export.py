"""The kernels' custom ops, the device image ops and an exported tower on
the card.

Every test here needs a CUDA device and skips without one.  This file
imports no JAX, so it also runs on a machine that has only PyTorch::

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda_export.py -q
"""

import numpy as np
import pytest
import torch

from sparsify_clip_tpu_torch.ops import attention, image, ln_qkv

pytestmark = pytest.mark.cuda

BF16 = dict(rtol=1e-2, atol=1e-2)  # tests/test_torch_port_cuda.py's kernel tolerance


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _randn(*shape, dtype=torch.bfloat16, device="cuda", seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device, dtype)


def test_custom_ops_launch_the_kernels(device):
    qkv = _randn(4, 77, 3 * 512, device=device)
    before = attention.mha_fwd.launches
    got = attention.mha_fwd_op(qkv, 8, True)
    assert attention.mha_fwd.launches == before + 1
    torch.testing.assert_close(got.float(), attention.mha_fwd_reference(qkv, 8, True)[0].float(),
                               **BF16)
    qkv = _randn(2, 577, 3 * 1024, device=device)
    before = attention.mha_fwd_head_group.launches
    attention.mha_fwd_head_group_op(qkv, 16, False)
    assert attention.mha_fwd_head_group.launches == before + 1
    x = _randn(64, 256, device=device)
    args = [_randn(256, dtype=torch.float32, device=device, seed=1) + 1,
            _randn(256, dtype=torch.float32, device=device, seed=2),
            _randn(768, 256, dtype=torch.float32, device=device, seed=3) * 0.05,
            _randn(768, dtype=torch.float32, device=device, seed=4)]
    before = ln_qkv.ln_qkv_fwd.launches
    got = ln_qkv.ln_qkv_fwd_op(x, *args, 1e-5)
    assert ln_qkv.ln_qkv_fwd.launches == before + 1 and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), ln_qkv.ln_qkv_reference(x, *args).float(),
                               rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("height,width,size", [(256, 256, 224), (480, 640, 224), (48, 40, 64)])
def test_image_ops_on_the_card_equal_the_cpu(device, height, width, size):
    rng = np.random.default_rng(5)
    images = torch.from_numpy(rng.integers(0, 256, (8, height, width, 3), dtype=np.uint8))
    want = image.eval_resize_batch(images, size)
    torch.testing.assert_close(image.eval_resize_batch(images.to(device), size).cpu(), want,
                               rtol=0, atol=5e-5)
    u, u_flip = image.augment_uniforms(torch.Generator().manual_seed(0), 8)
    boxes = image.crop_boxes_from_uniforms(u[:, 0], u[:, 1], u[:, 2], u[:, 3], height, width)
    want = image.crop_resize(images, boxes, u_flip < 0.5, size)
    got = image.crop_resize(images.to(device), [b.to(device) for b in boxes],
                            (u_flip < 0.5).to(device), size)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5)
    gen = torch.Generator(device=device).manual_seed(3)
    out = image.augment_batch(images.to(device), gen, size)
    assert out.shape == (8, size, size, 3) and torch.isfinite(out).all()


def test_exported_tower_runs_the_kernel(device, tmp_path):
    from sparsify_clip_tpu_torch.export import ExportedEncoder, save_exported
    from sparsify_clip_tpu_torch.inference import CLIPEncoder
    from sparsify_clip_tpu_torch.models.clip import create_model

    model = create_model("tiny-test", dtype=torch.bfloat16, device=device)
    save_exported(model, str(tmp_path))
    served, live = ExportedEncoder(str(tmp_path)), CLIPEncoder(model)
    for b in (1, 5):
        x = np.random.default_rng(b).standard_normal((b, 32, 32, 3)).astype(np.float32)
        before = attention.mha_fwd.launches
        got = served.encode_images(x)
        assert attention.mha_fwd.launches == before + model.cfg.vision_layers[0]
        torch.testing.assert_close(got, live.encode_images(x), rtol=0, atol=1e-6)
