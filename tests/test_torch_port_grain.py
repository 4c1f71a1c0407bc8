"""The port's grain route (``sparsify_clip_tpu_torch.data.grain_loader``,
on torch's DataLoader) against the JAX package's (on grain), on the CPU.

Items are compared to the bit (tolerance 0) for several (index, seed +
epoch, train); a whole epoch's rows as a multiset, since grain's shuffle
order cannot be reproduced without grain; ``len`` and ``drop_last``; the
same batches at 0 and 2 worker processes; and ``device_augment``, which
the JAX pipeline does not apply to this route's loaders and the JAX step
then applies to their float32 images, as the port's step does.
"""

import numpy as np
import pytest
import torch

import jax

from sparsify_clip_tpu.config import ExperimentConfig as JaxConfig
from sparsify_clip_tpu.data import grain_loader as jax_grain
from sparsify_clip_tpu.data import pipeline as jax_pipeline
from sparsify_clip_tpu.data.synthetic import SyntheticCaptions as JaxSynthetic
from sparsify_clip_tpu.ops.image import augment_batch_core
from sparsify_clip_tpu.text import get_tokenizer as jax_get_tokenizer
from sparsify_clip_tpu_torch.config import ExperimentConfig
from sparsify_clip_tpu_torch.data import grain_loader, pipeline
from sparsify_clip_tpu_torch.data.synthetic import SyntheticCaptions
from sparsify_clip_tpu_torch.ops import image as image_ops
from sparsify_clip_tpu_torch.text import get_tokenizer

from sparsify_clip_tpu_torch.data.transforms import CLIP_STD
from test_torch_port_augment_train import _jax_draws
from test_torch_port_image import PIXEL_ATOL

BASE = dict(dataset="synthetic", batch_size=4, num_train_samples=12, num_test_samples=8,
            seed=5, model="tiny-test", loader_backend="grain")


def _configs(**fields):
    base = dict(BASE, **fields)
    return JaxConfig.from_dict(dict(base)), ExperimentConfig.from_dict(dict(base))


@pytest.mark.parametrize("train", [True, False])
def test_items_equal_the_jax_transforms(train):
    jax_ds, port_ds = JaxSynthetic(6, seed=2), SyntheticCaptions(6, seed=2)
    for seed, index in ((42, 0), (43, 5), (7, 3), (1000, 1)):
        want = jax_grain._DecodeTransform(jax_get_tokenizer(), train, seed, 40)(
            (index, *jax_ds[index]))
        got = grain_loader._DecodeTransform(get_tokenizer(), train, seed, 40)(
            (index, *port_ds[index]))
        assert got["images"].dtype == np.float32 and got["images"].shape == (40, 40, 3)
        np.testing.assert_array_equal(got["images"], want["images"])
        np.testing.assert_array_equal(got["tokens"], want["tokens"])


def _rows(loader, epoch):
    rows = []
    for batch in loader.epoch(epoch):
        assert batch["images"].dtype == np.float32 and batch["tokens"].dtype == np.int32
        assert batch["captions"] == [""] * len(batch["images"])
        rows += [im.tobytes() + tok.tobytes() for im, tok in zip(batch["images"],
                                                                 batch["tokens"])]
    return rows


@pytest.mark.parametrize("tokenizer", ["python", "auto"])
def test_an_epochs_rows_equal_the_jax_routes_as_a_multiset(tokenizer):
    jcfg, pcfg = _configs(tokenizer=tokenizer)
    jtrain, jtest = jax_pipeline.dataset_loader(jcfg, image_size=32)
    ptrain, ptest = pipeline.dataset_loader(pcfg, image_size=32)
    assert isinstance(ptrain, grain_loader.GrainDataLoader)
    assert pipeline.routes(ptrain) == {"loader": "grain", "image": "pil",
                                       "tokenizer": "native" if tokenizer == "auto" else "python"}
    for jl, pl in ((jtrain, ptrain), (jtest, ptest)):
        for epoch in (0, 1):
            got, want = _rows(pl, epoch), _rows(jl, epoch)
            assert len(got) == len(jl) * 4 and sorted(got) == sorted(want)
    # eval keeps the dataset's order, as grain's unshuffled sampler
    assert _rows(ptest, 0) == _rows(jtest, 0)
    assert _rows(ptrain, 0) != _rows(ptrain, 1)


def test_the_order_is_the_permutation_of_the_jax_seed():
    loader = grain_loader.GrainDataLoader(SyntheticCaptions(10, seed=1), 3, get_tokenizer(),
                                          train=True, seed=9)
    seed = int(np.random.SeedSequence([9, 2]).generate_state(1)[0])
    want = np.random.default_rng(seed).permutation(10)[:9].reshape(3, 3)
    np.testing.assert_array_equal(np.stack(loader._batches(2)), want)


@pytest.mark.parametrize("drop_last", [True, False])
def test_len_and_drop_last_as_the_jax_loader(drop_last):
    kwargs = dict(batch_size=4, train=False, seed=3, drop_last=drop_last, image_size=16)
    port = grain_loader.GrainDataLoader(SyntheticCaptions(10, seed=1), tokenizer=get_tokenizer(),
                                        **kwargs)
    jax_loader = jax_grain.GrainDataLoader(JaxSynthetic(10, seed=1),
                                           tokenizer=jax_get_tokenizer(), **kwargs)
    assert len(port) == len(jax_loader) == (2 if drop_last else 3)
    got, want = list(port.epoch(0)), list(jax_loader.epoch(0))
    assert [len(b["images"]) for b in got] == [len(b["images"]) for b in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["images"], w["images"])
        np.testing.assert_array_equal(g["tokens"], w["tokens"])


def test_two_worker_processes_give_the_same_batches():
    _, pcfg = _configs(tokenizer="auto")
    train, _ = pipeline.dataset_loader(pcfg, image_size=24)
    inline = list(train.epoch(1))
    train.num_workers = 2
    spawned = list(train.epoch(1))
    assert len(spawned) == len(inline) == 3
    for a, b in zip(inline, spawned):
        np.testing.assert_array_equal(a["images"], b["images"])
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        assert a["captions"] == b["captions"]


def test_device_augment_ships_float_images_and_the_step_augments_them(monkeypatch):
    """The JAX pipeline returns the grain loaders before its device_augment
    branch: float32 normalized images at ``image_size``.  The JAX step's
    ``augment_batch_core`` takes them as pixels (/255, crop, flip,
    normalize); the port's ``augment_batch`` does the same on the same
    draws."""
    jcfg, pcfg = _configs(device_augment=True, device_augment_staging=48)
    jtrain, _ = jax_pipeline.dataset_loader(jcfg, image_size=32)
    ptrain, _ = pipeline.dataset_loader(pcfg, image_size=32)
    want, got = next(jtrain.epoch(0)), next(ptrain.epoch(0))
    assert got["images"].dtype == want["images"].dtype == np.float32
    assert got["images"].shape == want["images"].shape == (4, 32, 32, 3)
    key = jax.random.PRNGKey(3)
    aug_key, _ = jax.random.split(key)
    jax_out = np.asarray(augment_batch_core(jax.numpy.asarray(want["images"]), aug_key, 24))
    draws = _jax_draws(key, 4)
    monkeypatch.setattr(image_ops, "augment_uniforms", lambda generator, batch, device=None: draws)
    # the same rows on both sides (the two routes' orders differ)
    port_out = image_ops.augment_batch(torch.from_numpy(want["images"]), torch.Generator(), 24)
    assert port_out.dtype == torch.float32 and port_out.shape == (4, 24, 24, 3)
    # test_torch_port_image.py's pixel tolerance, in normalized units
    atol = PIXEL_ATOL / float(CLIP_STD.min())
    np.testing.assert_allclose(port_out.numpy(), jax_out, rtol=0, atol=atol)


def test_the_port_step_trains_on_grain_batches_with_device_augment():
    from sparsify_clip_tpu_torch.train import create_train_setup

    _, pcfg = _configs(device_augment=True, fp16=False)
    train, _ = pipeline.dataset_loader(pcfg, image_size=32)
    setup = create_train_setup(pcfg, steps_per_epoch=len(train), device="cpu", image_size=32)
    state = setup.state
    for batch in train.epoch(0):
        state, metrics = setup.train_step(state, batch)
        assert np.isfinite(float(metrics["train_loss"]))
    assert state.step == len(train)
