"""The port's data path (``sparsify_clip_tpu_torch.data``, no PIL in the
transforms) against the JAX package's, on the CPU: the numpy bilinear
resize against Pillow, the train and test transforms, the synthetic set,
the loader over two epochs of ``dataset: synthetic`` and of a COCO
fixture written by the JAX ``write_coco_fixture``, and each data route
(native and ``auto`` tokenizer and image backend, grain) against the JAX
pipeline's.

Tolerances: the resize follows Pillow's fixed-point arithmetic, so
pixels are compared exactly (tolerance 0), and so are order, tokens and
captions.
"""

import dataclasses

import numpy as np
import pytest
from PIL import Image

from sparsify_clip_tpu.config import ExperimentConfig as JaxConfig
from sparsify_clip_tpu.data import pipeline as jax_pipeline
from sparsify_clip_tpu.data import synthetic as jax_synthetic
from sparsify_clip_tpu.data import transforms as jax_transforms
from sparsify_clip_tpu_torch.config import ExperimentConfig
from sparsify_clip_tpu_torch.data import pipeline, synthetic, transforms


def _random_image(rng, h, w):
    if rng.random() < 0.5:
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    # smooth content: the filter's taps, not noise, decide the result
    y, x = np.mgrid[0:h, 0:w]
    return np.stack([(x * 255 // max(w - 1, 1)), (y * 255 // max(h - 1, 1)),
                     (x + y) * 7 % 256], -1).astype(np.uint8)


def test_resize_equals_pillow_up_and_down_with_crop_boxes():
    rng = np.random.default_rng(0)
    for _ in range(200):
        h, w = (int(v) for v in rng.integers(1, 160, 2))
        out_w, out_h = (int(v) for v in rng.integers(1, 260, 2))
        img = _random_image(rng, h, w)
        top, left = int(rng.integers(0, h)), int(rng.integers(0, w))
        ch, cw = int(rng.integers(1, h - top + 1)), int(rng.integers(1, w - left + 1))
        want = np.asarray(Image.fromarray(img).crop((left, top, left + cw, top + ch))
                          .resize((out_w, out_h), Image.BILINEAR))
        got = transforms.resize_bilinear(img[top:top + ch, left:left + cw], (out_w, out_h))
        np.testing.assert_array_equal(got, want, err_msg=f"{(h, w)} box {(top, left, ch, cw)} "
                                                         f"-> {(out_h, out_w)}")


@pytest.mark.parametrize("size", [224, 32, 57])
def test_transforms_equal_the_jax_transforms(size):
    for seed in range(12):
        img = jax_synthetic.make_image(np.random.default_rng(seed), 64 + 9 * seed % 40)
        arr = np.asarray(img)
        jax_rng, rng = np.random.default_rng(100 + seed), np.random.default_rng(100 + seed)
        want = jax_transforms.train_transform(img, jax_rng, size)
        got = transforms.train_transform(arr, rng, size)
        np.testing.assert_array_equal(got, want)
        assert rng.random() == jax_rng.random()  # both took the same draws
        np.testing.assert_array_equal(transforms.test_transform(arr, size),
                                      jax_transforms.test_transform(img, size))
    h, w = 20, 300  # the crop sampler's centre-crop fallback
    for seed in range(5):
        assert (transforms.sample_resized_crop_params(h, w, np.random.default_rng(seed))
                == jax_transforms.sample_resized_crop_params(h, w, np.random.default_rng(seed)))


def test_synthetic_items_equal_the_jax_set():
    jax_ds, port_ds = jax_synthetic.SyntheticCaptions(6, seed=3), synthetic.SyntheticCaptions(6, seed=3)
    assert len(port_ds) == len(jax_ds)
    for i in range(len(jax_ds)):
        (jimg, jcaps), (pimg, pcaps) = jax_ds[i], port_ds[i]
        assert pimg.dtype == np.uint8 and pimg.shape == (64, 64, 3)
        np.testing.assert_array_equal(pimg, np.asarray(jimg))
        assert pcaps == jcaps


def _configs(**fields):
    base = dict(dict(dataset="synthetic", batch_size=8, num_train_samples=24,
                     num_test_samples=16, seed=5, model="tiny-test"), **fields)
    return JaxConfig.from_dict(dict(base)), ExperimentConfig.from_dict(dict(base))


def _assert_same_epochs(jax_loader, port_loader, epochs=(0, 1)):
    assert len(port_loader) == len(jax_loader)
    for epoch in epochs:
        jb, pb = list(jax_loader.epoch(epoch)), list(port_loader.epoch(epoch))
        assert len(pb) == len(jb) == len(jax_loader)
        for want, got in zip(jb, pb):
            assert got["captions"] == want["captions"]
            np.testing.assert_array_equal(got["tokens"], want["tokens"])
            assert got["images"].dtype == want["images"].dtype == np.float32
            np.testing.assert_array_equal(got["images"], want["images"])


def test_loader_equals_the_jax_loader_on_synthetic_data():
    jcfg, pcfg = _configs()
    jtrain, jtest = jax_pipeline.dataset_loader(jcfg, image_size=40)
    ptrain, ptest = pipeline.dataset_loader(pcfg, image_size=40)
    _assert_same_epochs(jtrain, ptrain)
    _assert_same_epochs(jtest, ptest)
    # shuffled per epoch, ordered for eval
    assert next(ptrain.epoch(0))["captions"] != next(ptrain.epoch(1))["captions"]
    assert next(ptest.epoch(0))["captions"] == next(jtest.epoch(0))["captions"]


def test_loader_equals_the_jax_loader_on_a_coco_fixture(tmp_path):
    jax_synthetic.write_coco_fixture(str(tmp_path), num_train=12, num_val=8, image_size=48)
    jcfg, pcfg = _configs(dataset="coco", data_root=str(tmp_path), num_train_samples=10,
                          num_test_samples=-1, batch_size=4)
    jtrain, jtest = jax_pipeline.dataset_loader(jcfg, image_size=32)
    ptrain, ptest = pipeline.dataset_loader(pcfg, image_size=32)
    assert len(ptrain.dataset) == 10 and len(ptest.dataset) == 8
    _assert_same_epochs(jtrain, ptrain)
    _assert_same_epochs(jtest, ptest)


def test_loader_reraises_a_producer_error():
    class Broken(synthetic.SyntheticCaptions):
        def __getitem__(self, i):
            if i == 5:
                raise ValueError("bad item")
            return super().__getitem__(i)

    from sparsify_clip_tpu_torch.data.loader import DataLoader
    from sparsify_clip_tpu_torch.text import get_tokenizer

    loader = DataLoader(Broken(8), 4, get_tokenizer(), train=False, image_size=16)
    with pytest.raises(RuntimeError, match="worker failed") as info:
        list(loader.epoch(0))
    assert isinstance(info.value.__cause__, ValueError)


@pytest.mark.parametrize("field,value", [
    ("tokenizer", "native"),
    ("tokenizer", "auto"),
    ("loader_backend", "grain"),
    ("image_backend", "native"),
    ("image_backend", "auto"),
])
def test_the_jax_routes_run_and_name_the_route_taken(tmp_path, field, value):
    """Each data route the port once refused now runs as the JAX
    pipeline's does: the tokenizer routes on the synthetic set, the
    image routes on a COCO fixture (the synthetic set hands out no JPEG
    bytes), grain on the synthetic set (its order is grain's own, so the
    rows of an epoch are compared as a multiset)."""
    fields = {field: value}
    if field == "image_backend":
        jax_synthetic.write_coco_fixture(str(tmp_path), num_train=10, num_val=8, image_size=40)
        fields.update(dataset="coco", data_root=str(tmp_path), num_train_samples=-1,
                      num_test_samples=-1, batch_size=4)
    jcfg, pcfg = _configs(**fields)
    jtrain, jtest = jax_pipeline.dataset_loader(jcfg, image_size=24)
    ptrain, ptest = pipeline.dataset_loader(pcfg, image_size=24)
    want = {"loader": "threads", "tokenizer": "python", "image": "pil"}
    want.update({"tokenizer": {"tokenizer": "native"}, "loader_backend": {"loader": "grain"},
                 "image_backend": {"image": "native"}}[field])
    assert pipeline.routes(ptrain) == pipeline.routes(ptest) == want
    if field == "loader_backend":
        for jl, pl in ((jtrain, ptrain), (jtest, ptest)):
            rows = [sorted(b["images"][i].tobytes() + b["tokens"][i].tobytes()
                           for b in loader.epoch(1) for i in range(len(b["images"])))
                    for loader in (jl, pl)]
            assert rows[0] == rows[1]
        return
    _assert_same_epochs(jtrain, ptrain)
    _assert_same_epochs(jtest, ptest)


@pytest.mark.parametrize("field", ["tokenizer", "image_backend"])
def test_a_native_route_refuses_by_name_when_its_build_fails(tmp_path, monkeypatch, field):
    from sparsify_clip_tpu_torch.data import native_imaging
    from sparsify_clip_tpu_torch.utils import native_build

    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native_imaging, "_pipeline", None)
    monkeypatch.setattr(native_imaging, "_error", None)
    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CXX", raising=False)
    config = dataclasses.replace(_configs()[1], **{field: "native"})
    match = "native tokenizer library" if field == "tokenizer" else "image_backend='native'"
    with pytest.raises(RuntimeError, match=match):
        pipeline.dataset_loader(config)


def test_coco_without_pil_names_the_native_decoder(tmp_path, monkeypatch):
    import sys

    jax_synthetic.write_coco_fixture(str(tmp_path), num_train=2, num_val=2)
    monkeypatch.setitem(sys.modules, "PIL", None)
    config = _configs(dataset="coco", data_root=str(tmp_path))[1]
    with pytest.raises(RuntimeError, match="'Data without PIL'"):
        pipeline.dataset_loader(config)
