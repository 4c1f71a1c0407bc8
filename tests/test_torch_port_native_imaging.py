"""The port's native image pipeline
(``sparsify_clip_tpu_torch.data.native_imaging``) against the JAX
package's, on the CPU.

The C++ source is a byte-for-byte copy of the JAX package's, built into
the port's ``_build/``.  Both decode the same JPEG bytes with the same
libjpeg and the same arithmetic, so pixels, crops, flips, tokens and
captions are compared exactly (tolerance 0): ``dims`` and ``transform``,
the thread loader with ``image_backend`` ``native`` and ``auto`` over a
COCO tree written by the JAX ``write_coco_fixture`` (train and eval,
float and uint8 staging), and the encode CLI's image batch.
"""

import dataclasses
import os

import numpy as np
import pytest
from PIL import Image

from sparsify_clip_tpu import encode as jax_encode
from sparsify_clip_tpu.config import ExperimentConfig as JaxConfig
from sparsify_clip_tpu.data import native_imaging as jax_imaging
from sparsify_clip_tpu.data import pipeline as jax_pipeline
from sparsify_clip_tpu.data.synthetic import write_coco_fixture
from sparsify_clip_tpu_torch import encode
from sparsify_clip_tpu_torch.config import ExperimentConfig
from sparsify_clip_tpu_torch.data import native_imaging, pipeline
from sparsify_clip_tpu_torch.utils import native_build

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("coco"))
    return write_coco_fixture(root, num_train=12, num_val=8, image_size=48)


@pytest.fixture(scope="module")
def jpegs(coco):
    folder = os.path.join(coco, "images", "train2017")
    out = []
    for name in sorted(os.listdir(folder))[:4]:
        with open(os.path.join(folder, name), "rb") as fh:
            out.append(fh.read())
    return out


@pytest.fixture(scope="module")
def pipelines():
    return native_imaging.NativeImagePipeline(), jax_imaging.NativeImagePipeline()


def test_the_source_is_the_jax_packages_byte_for_byte():
    with open(os.path.join(REPO, "native", "imaging", "clip_image.cpp"), "rb") as fh:
        assert native_imaging.SOURCE.read_bytes() == fh.read()


def test_the_build_lands_in_the_ports_build_dir():
    path = native_imaging.build_library()
    assert path.parent == native_build.BUILD_DIR and path.name.startswith("libclip_image_")
    assert native_imaging.get_pipeline() is not None


@pytest.mark.parametrize("case", ["squash", "crop_flip", "crop", "upsample", "uint8",
                                  "uint8_crop_flip"])
def test_transform_equals_the_jax_pipelines(pipelines, jpegs, case):
    port, jax_pipe = pipelines
    for jpeg in jpegs:
        assert port.dims(jpeg) == jax_pipe.dims(jpeg) == (48, 48)
        args = {"squash": (32, None, False, False), "crop_flip": (24, (5, 7, 30, 21), True, False),
                "crop": (40, (0, 3, 45, 40), False, False), "upsample": (96, None, False, False),
                "uint8": (64, None, False, True),
                "uint8_crop_flip": (20, (11, 2, 17, 33), True, True)}[case]
        size, crop, flip, uint8 = args
        got = port.transform(jpeg, size, crop=crop, flip=flip, uint8=uint8)
        want = jax_pipe.transform(jpeg, size, crop=crop, flip=flip, uint8=uint8)
        assert got.dtype == want.dtype == (np.uint8 if uint8 else np.float32)
        assert got.shape == (size, size, 3)
        np.testing.assert_array_equal(got, want)


def test_bad_input_raises_as_the_jax_pipeline(pipelines, jpegs):
    for pipe in pipelines:
        with pytest.raises(ValueError, match="not a decodable JPEG"):
            pipe.dims(b"not a jpeg")
        with pytest.raises(ValueError, match="JPEG decode failed"):
            pipe.transform(b"not a jpeg", 32)
        with pytest.raises(ValueError, match="outside image"):
            pipe.transform(jpegs[0], 32, crop=(0, 0, 64, 64))


def _configs(root, **fields):
    base = dict(dict(dataset="coco", data_root=root, batch_size=4, num_train_samples=10,
                     num_test_samples=-1, seed=5, model="tiny-test"), **fields)
    return JaxConfig.from_dict(dict(base)), ExperimentConfig.from_dict(dict(base))


@pytest.mark.parametrize("backend", ["native", "auto"])
@pytest.mark.parametrize("staging", [False, True], ids=["float", "uint8"])
def test_loaders_equal_the_jax_loaders(coco, backend, staging):
    jcfg, pcfg = _configs(coco, image_backend=backend, device_augment=staging,
                          device_augment_staging=40)
    jtrain, jtest = jax_pipeline.dataset_loader(jcfg, image_size=32)
    ptrain, ptest = pipeline.dataset_loader(pcfg, image_size=32)
    assert pipeline.routes(ptrain)["image"] == pipeline.routes(ptest)["image"] == "native"
    for jl, pl in ((jtrain, ptrain), (jtest, ptest)):
        for epoch in (0, 1):
            jb, pb = list(jl.epoch(epoch)), list(pl.epoch(epoch))
            assert len(pb) == len(jb) == len(jl) > 0
            for want, got in zip(jb, pb):
                assert got["captions"] == want["captions"]
                np.testing.assert_array_equal(got["tokens"], want["tokens"])
                assert got["images"].dtype == want["images"].dtype
                np.testing.assert_array_equal(got["images"], want["images"])
    assert next(ptrain.epoch(0))["images"].dtype == (np.uint8 if staging else np.float32)


def test_a_non_jpeg_item_takes_the_pil_route(coco, tmp_path):
    """A PNG in the tree: both loaders decode it through PIL, the rest
    natively, and draw the same crops and captions."""
    import shutil

    root = str(tmp_path / "mixed")
    shutil.copytree(coco, root)
    folder = os.path.join(root, "images", "train2017")
    name = sorted(os.listdir(folder))[2]
    Image.open(os.path.join(folder, name)).save(os.path.join(folder, name[:-4] + ".png"))
    ann = os.path.join(root, "annotations", "captions_train2017.json")
    with open(ann) as fh:
        text = fh.read()
    with open(ann, "w") as fh:
        fh.write(text.replace(name, name[:-4] + ".png"))
    jcfg, pcfg = _configs(root, image_backend="native")
    jtrain, _ = jax_pipeline.dataset_loader(jcfg, image_size=32)
    ptrain, _ = pipeline.dataset_loader(pcfg, image_size=32)
    for want, got in zip(jtrain.epoch(0), ptrain.epoch(0)):
        assert got["captions"] == want["captions"]
        np.testing.assert_array_equal(got["images"], want["images"])


def test_native_raises_and_auto_falls_back_when_the_build_fails(coco, tmp_path, monkeypatch):
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native_imaging, "_pipeline", None)
    monkeypatch.setattr(native_imaging, "_error", None)
    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CXX", raising=False)
    _, pcfg = _configs(coco, image_backend="native")
    with pytest.raises(RuntimeError, match="image_backend='native'") as info:
        pipeline.dataset_loader(pcfg, image_size=32)
    assert "C++ compiler" in str(info.value.__cause__)
    assert native_imaging.get_pipeline() is None
    train, test = pipeline.dataset_loader(dataclasses.replace(pcfg, image_backend="auto"),
                                          image_size=32)
    assert pipeline.routes(train)["image"] == pipeline.routes(test)["image"] == "pil"
    jtrain, _ = jax_pipeline.dataset_loader(_configs(coco, image_backend="pil")[0], image_size=32)
    want, got = next(jtrain.epoch(0)), next(train.epoch(0))
    np.testing.assert_array_equal(got["images"], want["images"])


def test_encode_image_batch_equals_the_jax_clis(coco, tmp_path):
    folder = os.path.join(coco, "images", "val2017")
    files = [os.path.join(folder, f) for f in sorted(os.listdir(folder))[:3]]
    png = str(tmp_path / "a.png")
    Image.open(files[0]).resize((37, 29)).save(png)
    paths = files + [png]
    got = encode._load_image_batch(paths, 32)
    want = jax_encode._load_image_batch(paths, 32)
    assert got.dtype == np.float32 and got.shape == (4, 32, 32, 3)
    np.testing.assert_array_equal(got, want)
