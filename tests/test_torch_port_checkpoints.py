"""The port's checkpoints on the CPU: weights saved by the port read by
the JAX ``load_weights`` and back through ``load_jax_params``, the JAX
flat keys of every registry ViT, and the full-state save and restore
(model, AdamW moments, temperature, step), synchronous and not.  Every
comparison is exact (tolerance 0).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsify_clip_tpu.checkpoints import collect_host_arrays as jax_collect
from sparsify_clip_tpu.checkpoints import load_weights as jax_load_weights
from sparsify_clip_tpu.models import clip as jax_clip
from sparsify_clip_tpu_torch import checkpoints
from sparsify_clip_tpu_torch.config import ExperimentConfig
from sparsify_clip_tpu_torch.data import synthetic_batch
from sparsify_clip_tpu_torch.models import clip as port_clip
from sparsify_clip_tpu_torch.train import create_train_setup


def _jax_params(name):
    """The JAX model's parameter tree as shapes (no weights computed)."""
    model = jax_clip.CLIP(cfg=jax_clip.MODEL_REGISTRY[name], dtype=jnp.float32)
    cfg = model.cfg
    return jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, cfg.image_size, cfg.image_size, 3), jnp.float32),
                           jnp.zeros((1, cfg.context_length), jnp.int32), train=False)
    )["params"]


@pytest.mark.parametrize("name", ["tiny-test", "ViT-B-32", "ViT-L-14-336"])
def test_jax_paths_are_the_jax_models_keys_and_shapes(name):
    with torch.device("meta"):
        model = port_clip.CLIP(port_clip.MODEL_REGISTRY[name])
    paths = checkpoints.jax_paths(model)
    params = dict(model.named_parameters())
    leaves = jax.tree_util.tree_flatten_with_path(_jax_params(name))[0]
    want = {"/".join(k.key for k in path): leaf.shape for path, leaf in leaves}
    got = {}
    for port_name, (path, fn) in paths.items():
        got[path] = fn(np.empty(tuple(params[port_name].shape), np.float32)).shape
    assert got == want


def test_save_weights_is_read_by_the_jax_load_weights(tmp_path):
    model = port_clip.create_model("tiny-test", device="cpu", seed=7)
    path = checkpoints.save_weights(model, str(tmp_path / "sub" / "w.npz"))
    template = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                      _jax_params("tiny-test"))
    loaded = jax_load_weights(template, path)
    flat = jax_collect(loaded)
    saved = checkpoints.collect_host_arrays(model)
    assert set(flat) == set(saved)
    for key in flat:
        np.testing.assert_array_equal(flat[key], saved[key], err_msg=key)
    back = checkpoints.load_jax_params(port_clip.create_model("tiny-test", device="cpu", seed=1),
                                       flat)
    for (name, a), (_, b) in zip(model.named_parameters(), back.named_parameters()):
        assert torch.equal(a, b), name
    # and the port's own loader reads it
    again = checkpoints.load_weights(port_clip.create_model("tiny-test", device="cpu", seed=2),
                                     path[:-len(".npz")])
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))


def _setup(learnable=True):
    config = ExperimentConfig.from_dict(dict(
        model="tiny-test", batch_size=4, epochs=2, learning_rate=1e-3, fp16=False, seed=0,
        loss_type="anchor", anchor_temperature_learnable=learnable))
    return config, create_train_setup(config, steps_per_epoch=3, device="cpu")


def _step(setup, seed):
    setup.state, _ = setup.train_step(setup.state, synthetic_batch(4, 32, seed=seed))


def _assert_same_state(a, b):
    assert a.step == b.step
    assert torch.equal(a.temperature, b.temperature)
    for (name, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), name
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    assert sa["state"].keys() == sb["state"].keys()
    for k in sa["state"]:
        for field in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa["state"][k][field], sb["state"][k][field]), (k, field)


@pytest.mark.parametrize("asynchronous", [False, True])
def test_full_state_round_trip_is_exact(tmp_path, asynchronous):
    config, setup = _setup()
    for seed in range(2):
        _step(setup, seed)
    directory = str(tmp_path / "run")
    if asynchronous:
        path = checkpoints.save_full_async(setup.state, directory, config)
        _step(setup, 99)  # the snapshot was taken at the call: this step is not in it
        checkpoints.wait_for_async_saves()
        _, setup = _setup()
        for seed in range(2):
            _step(setup, seed)
    else:
        path = checkpoints.save_full(setup.state, directory, config)
    assert os.path.basename(path) == "step_2.pt"
    assert sorted(os.listdir(directory)) == ["step_2.pt"]  # no temporary left
    assert checkpoints.latest_step(directory) == 2
    assert checkpoints.latest_step(str(tmp_path / "absent")) is None

    _, fresh = _setup()
    restored = checkpoints.restore_full(directory, fresh.state)
    assert restored is fresh.state
    _assert_same_state(setup.state, fresh.state)
    assert torch.load(path, weights_only=True)["config"] == config.to_dict()
    # the next step from the restored state is the next step of the original
    _step(setup, 5)
    _step(fresh, 5)
    _assert_same_state(setup.state, fresh.state)
    _step(setup, 6)
    checkpoints.save_full(setup.state, directory)
    assert checkpoints.latest_step(directory) == 4
    _, latest = _setup()
    checkpoints.restore_full(directory, latest.state)
    _assert_same_state(setup.state, latest.state)


def test_restore_full_raises_on_an_empty_directory(tmp_path):
    _, setup = _setup()
    with pytest.raises(FileNotFoundError, match="step_"):
        checkpoints.restore_full(str(tmp_path), setup.state)
