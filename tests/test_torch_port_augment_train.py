"""``device_augment`` through the port on the CPU: the loader's uint8
staging batches against the JAX loader's, a 3-step exp-6 lockstep
against the JAX step with the port's draws replaced by the JAX step's own
(at the exp-6 lockstep's tolerances, tests/test_torch_port_exp6.py), and a
SIGTERM + ``"auto"`` resume bit-identical to the uninterrupted run.

JAX draws its crops and flips from the train state's threefry key, the
port from a ``torch.Generator`` in the train state: the lockstep reads
JAX's uniforms off the state's key, on the key splits
``augment_batch_core`` takes, and hands them to the port's step in place
of its own draws.
"""

import dataclasses
import os
import signal

import numpy as np
import pytest
import torch

import jax

from sparsify_clip_tpu import config as jax_config
from sparsify_clip_tpu.checkpoints import collect_host_arrays
from sparsify_clip_tpu.data import dataset_loader as jax_dataset_loader
from sparsify_clip_tpu.parallel.mesh import create_mesh, shard_batch
from sparsify_clip_tpu.train import create_train_setup as jax_create_train_setup
from sparsify_clip_tpu_torch import checkpoints, cli, logging
from sparsify_clip_tpu_torch import config as port_config
from sparsify_clip_tpu_torch.checkpoints import load_jax_params
from sparsify_clip_tpu_torch.data import dataset_loader
from sparsify_clip_tpu_torch.ops import image as image_ops
from sparsify_clip_tpu_torch.train import create_train_setup

from test_torch_port_cli import _records, _resume_config
from test_torch_port_exp6 import COMPONENTS, EXP6
from test_torch_port_train import _two_tier

B, STEPS, SPE, LR, STAGING = 8, 3, 2, 1e-3, 48
AUGMENT = dict(EXP6, fp16=False, device_augment=True, device_augment_staging=STAGING,
               dataset="synthetic", num_train_samples=3 * B, num_test_samples=B)


def test_loader_ships_the_jax_loaders_uint8_staging():
    jcfg = jax_config.ExperimentConfig.from_dict(AUGMENT)
    pcfg = port_config.ExperimentConfig.from_dict(AUGMENT)
    want = next(iter(jax_dataset_loader(jcfg, image_size=32, num_threads=2)[0]))
    got = next(iter(dataset_loader(pcfg, image_size=32, num_threads=2)[0]))
    assert got["images"].dtype == np.uint8 and got["images"].shape == (B, STAGING, STAGING, 3)
    np.testing.assert_array_equal(got["images"], want["images"])
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    assert got["captions"] == want["captions"]


def _jax_draws(rng, batch):
    """The unit uniforms the JAX step's ``augment_batch_core`` draws from
    ``state.rng``: (B, 4, 10) for the boxes, (B,) for the flips."""
    aug_key, _ = jax.random.split(rng)
    boxes, flips = [], []
    for key in jax.random.split(aug_key, batch):
        k_box, k_flip = jax.random.split(key)
        boxes.append(np.stack([np.asarray(jax.random.uniform(k, (image_ops.N_ATTEMPTS,)))
                               for k in jax.random.split(k_box, 4)]))
        flips.append(np.asarray(jax.random.uniform(k_flip, (), np.float32)))
    return torch.from_numpy(np.stack(boxes)), torch.from_numpy(np.stack(flips))


def test_device_augment_lockstep_with_the_jax_draws(monkeypatch):
    jcfg = jax_config.ExperimentConfig.from_dict(AUGMENT)
    mesh = create_mesh(data=1, model=1)
    jsetup = jax_create_train_setup(jcfg, steps_per_epoch=SPE, mesh=mesh)
    initial = collect_host_arrays(jsetup.state.params)  # before the step donates them
    setup = create_train_setup(port_config.ExperimentConfig.from_dict(AUGMENT),
                               steps_per_epoch=SPE, device="cpu")
    load_jax_params(setup.model, initial)
    assert setup.state.aug_generator is not None
    pending = []
    monkeypatch.setattr(image_ops, "augment_uniforms",
                        lambda generator, batch, device=None: pending.pop(0))
    rng = np.random.default_rng(4)
    jstate, state = jsetup.state, setup.state
    for step in range(STEPS):
        batch = {"images": rng.integers(0, 256, (B, STAGING, STAGING, 3), dtype=np.uint8),
                 "tokens": rng.integers(1, 49406, (B, 77)).astype(np.int32)}
        batch["tokens"][:, -1] = 49407
        pending.append(_jax_draws(jax.numpy.asarray(np.asarray(jstate.rng)), B))
        jstate, jm = jsetup.train_step(jstate, shard_batch(batch, mesh))
        state, pm = setup.train_step(state, batch)
        assert pending == []  # the step drew once, before the encode
        for key in COMPONENTS:
            assert float(pm[key]) == pytest.approx(float(jm[key]), rel=5e-4, abs=1e-7), (step, key)
    _two_tier(dict(state.model.named_parameters()), collect_host_arrays(jstate.params),
              tight_frac=0.999, cap=2 * LR * STEPS)


def test_the_generator_advances_and_its_state_is_checkpointed(tmp_path):
    cfg = port_config.ExperimentConfig.from_dict(AUGMENT)
    setup = create_train_setup(cfg, steps_per_epoch=SPE, device="cpu")
    gen = setup.state.aug_generator
    assert torch.equal(gen.get_state(), torch.Generator().manual_seed(cfg.seed).get_state())
    batch = next(iter(dataset_loader(cfg, image_size=32, num_threads=1)[0]))
    setup.train_step(setup.state, batch)
    moved = gen.get_state()
    assert not torch.equal(moved, torch.Generator().manual_seed(cfg.seed).get_state())
    checkpoints.save_full(setup.state, str(tmp_path), cfg)
    fresh = create_train_setup(cfg, steps_per_epoch=SPE, device="cpu")
    checkpoints.restore_full(str(tmp_path), fresh.state)
    assert torch.equal(fresh.state.aug_generator.get_state(), moved)


def test_sigterm_then_auto_resume_is_bit_identical(tmp_path, monkeypatch):
    fields = dict(device_augment=True, device_augment_staging=STAGING)
    full = _resume_config(tmp_path / "full", **fields)
    cli.main(full, device="cpu")

    stopped = _resume_config(tmp_path / "stopped", **fields)
    calls = {"n": 0}
    log_train_step = logging.RunLogger.log_train_step

    def signalling(self, *args, **kwargs):
        log_train_step(self, *args, **kwargs)
        calls["n"] += 1
        if calls["n"] == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    monkeypatch.setattr(logging.RunLogger, "log_train_step", signalling)
    cli.main(stopped, device="cpu")
    monkeypatch.undo()
    models = tmp_path / "stopped" / "models"
    assert sorted(os.listdir(models / "resume")) == ["step_2.pt"]
    cli.main(dataclasses.replace(stopped, resume_checkpoint="auto"), device="cpu")

    with np.load(tmp_path / "full" / "models" / "resume.npz") as a, \
            np.load(models / "resume.npz") as b:
        assert a.files == b.files
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    steps = [r["train_loss"] for r in _records(tmp_path / "stopped" / "logs" / "resume.jsonl")
             if "train_loss" in r]
    full_steps = [r["train_loss"] for r in _records(tmp_path / "full" / "logs" / "resume.jsonl")
                  if "train_loss" in r]
    assert steps == full_steps and len(steps) == 6
