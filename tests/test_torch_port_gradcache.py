"""GradCache accumulation (``grad_accum_steps > 1``) in the port's train
step against the JAX package's, on the CPU.

On one device microbatch ``i`` is the contiguous slice ``[i·mb,
(i+1)·mb)``; the JAX runs use a one-device mesh (``create_mesh(data=1,
model=1)``), so their microbatches are the same slices (over a data axis
of 8 the JAX layout puts other samples in each microbatch, and a
BatchNorm tower's per-microbatch statistics would differ).

* The exp-6 step of ``tiny-test`` at batch 8 with ``grad_accum_steps: 2``
  against the JAX step with the same, across the warm→main boundary, in
  fp32, with the tolerances of tests/test_train.py:288-329: losses 2e-5
  relative, the final embeddings of a held batch rtol 2e-3 / atol 5e-5.
* Accumulation equal to the one-shot step on the port (exp 6, SigLIP with
  its two scalars, a learnable temperature), and the learnable
  temperature against the JAX accumulated step.
* A narrow ResNet: the running statistics after an accumulated step equal
  the JAX step's, which moves them once a microbatch in pass 1 and never
  in pass 2.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sparsify_clip_tpu import config as jax_config
from sparsify_clip_tpu.checkpoints import collect_host_arrays
from sparsify_clip_tpu.parallel.mesh import create_mesh, shard_batch
from sparsify_clip_tpu.train import create_train_setup as jax_create_train_setup
from sparsify_clip_tpu_torch import config as port_config
from sparsify_clip_tpu_torch.checkpoints import load_jax_params, torch_name
from sparsify_clip_tpu_torch.data import synthetic_batch
from sparsify_clip_tpu_torch.train import create_train_setup

from test_torch_port_rn50 import NARROW, SIZE, _buffers, _jitted_flax_init

B, SPE, STEPS, LR = 8, 2, 3, 1e-3
EXP6 = dict(model="tiny-test", batch_size=B, epochs=2, learning_rate=LR, fp16=False, seed=0,
            loss_type="only_lunif_n_then_anchor+lalign+lunif(centroids)", only_lunif_epochs=1,
            anchor_temperature=0.1)
LOSS_RTOL = 2e-5          # tests/test_train.py:303-307
EMBED = dict(rtol=2e-3, atol=5e-5)  # tests/test_train.py:328-329
HELD = synthetic_batch(B, 32, seed=99)


def _batches():
    return [synthetic_batch(B, 32, seed=60 + s) for s in range(STEPS)]


def _port_setup(fields, initial):
    setup = create_train_setup(port_config.ExperimentConfig.from_dict(fields),
                               steps_per_epoch=SPE, device="cpu")
    load_jax_params(setup.model, initial)
    return setup


def _port_run(setup):
    state, log = setup.state, []
    for batch in _batches():
        state, metrics = setup.train_step(state, batch)
        log.append({k: float(v) for k, v in metrics.items()})
    return log


def _port_embeddings(setup):
    with torch.no_grad():
        img, txt = setup.model(torch.from_numpy(HELD["images"]), torch.from_numpy(HELD["tokens"]))
    return img.numpy(), txt.numpy()


@pytest.fixture(scope="module")
def exp6_runs():
    fields = dict(EXP6, grad_accum_steps=2)
    mesh = create_mesh(data=1, model=1)
    jsetup = jax_create_train_setup(jax_config.ExperimentConfig.from_dict(fields),
                                    steps_per_epoch=SPE, mesh=mesh)
    initial = collect_host_arrays(jsetup.state.params)  # before the step donates them
    jstate, jax_log = jsetup.state, []
    for batch in _batches():
        jstate, jm = jsetup.train_step(jstate, shard_batch(batch, mesh))
        jax_log.append({k: float(v) for k, v in jm.items()})
    jimg, jtxt = jsetup.model.apply({"params": jstate.params}, jnp.asarray(HELD["images"]),
                                    jnp.asarray(HELD["tokens"]), train=False)
    setup = _port_setup(fields, initial)
    return dict(jax=jax_log, port=_port_run(setup), initial=initial,
                jax_embeddings=(np.asarray(jimg), np.asarray(jtxt)),
                embeddings=_port_embeddings(setup))


def test_gradcache_exp6_lockstep_crosses_the_warm_phase_boundary(exp6_runs):
    jax_log, port_log = exp6_runs["jax"], exp6_runs["port"]
    assert set(port_log[0]) == set(jax_log[0])
    for step, (want, got) in enumerate(zip(jax_log, port_log)):
        for key in ("train_loss", "anchor", "lalign", "lunif"):
            assert got[key] == pytest.approx(want[key], rel=LOSS_RTOL, abs=1e-7), (step, key)
        assert (got["anchor"] == 0.0) == (step < SPE), step


def test_gradcache_exp6_lockstep_final_embeddings(exp6_runs):
    for got, want in zip(exp6_runs["embeddings"], exp6_runs["jax_embeddings"]):
        np.testing.assert_allclose(got, want, **EMBED)


@pytest.mark.parametrize("fields", [
    dict(EXP6),
    dict(EXP6, loss_type="siglip", only_lunif_epochs=0),
    dict(EXP6, loss_type="anchor", only_lunif_epochs=0, anchor_temperature_learnable=True),
], ids=["exp6", "siglip", "anchor-learnable-temperature"])
def test_accumulation_matches_the_one_shot_step(exp6_runs, fields):
    """The B×B loss couples every pair across microbatches: GradCache is
    the full-batch step (tests/test_train.py's and tests/test_siglip.py's
    ``*_grad_accum_matches_full_batch``), SigLIP's two scalars and the
    learnable temperature included."""
    one = _port_setup(fields, exp6_runs["initial"])
    accumulated = _port_setup(dict(fields, grad_accum_steps=4), exp6_runs["initial"])
    log_one, log_acc = _port_run(one), _port_run(accumulated)
    for step, (want, got) in enumerate(zip(log_one, log_acc)):
        for key in ("train_loss", "temperature", "siglip_scale", "siglip_bias"):
            if key in want:
                assert got[key] == pytest.approx(want[key], rel=LOSS_RTOL), (step, key)
    if accumulated.state.loss_scalars is not None:
        for key, value in accumulated.state.loss_scalars.items():
            assert float(value.detach()) == pytest.approx(
                float(one.state.loss_scalars[key].detach()), rel=1e-5), key
    for got, want in zip(_port_embeddings(accumulated), _port_embeddings(one)):
        np.testing.assert_allclose(got, want, **EMBED)


def test_gradcache_learnable_temperature_against_jax():
    """The temperature's gradient comes from the full-batch loss, beside
    the embeddings' (exp 9's string: zero in the warm steps, where AdamW
    still decays it)."""
    fields = dict(EXP6, grad_accum_steps=2, anchor_temperature_learnable=True,
                  loss_type="only_lunif_n_then_anchor+ALPHA*lalign+BETA*(lunif(text)+lunif(img))")
    mesh = create_mesh(data=1, model=1)
    jsetup = jax_create_train_setup(jax_config.ExperimentConfig.from_dict(fields),
                                    steps_per_epoch=SPE, mesh=mesh)
    setup = _port_setup(fields, collect_host_arrays(jsetup.state.params))
    jstate, want = jsetup.state, []
    for batch in _batches():
        jstate, jm = jsetup.train_step(jstate, shard_batch(batch, mesh))
        want.append(float(jm["temperature"]))
    got = [r["temperature"] for r in _port_run(setup)]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[-1] != pytest.approx(0.1 * (1 - LR * 0.01) ** STEPS, rel=1e-6)  # it learned


def test_a_batch_that_does_not_split_raises_the_jax_error(exp6_runs):
    setup = _port_setup(dict(EXP6, grad_accum_steps=4), exp6_runs["initial"])
    with pytest.raises(ValueError, match="global batch 6 not divisible by grad_accum_steps 4"):
        setup.train_step(setup.state, synthetic_batch(6, 32, seed=0))


def test_resnet_running_statistics_move_once_a_microbatch():
    """A narrow ResNet of RN50's structure, batch 8 in 2 microbatches: after
    one accumulated step the running statistics equal the JAX step's (fp32
    rounding: rtol 1e-5, atol 1e-5 of the largest entry, as
    tests/test_torch_port_rn50.py's first step).  Pass 2 re-runs each
    microbatch in train mode; had it moved them, each BatchNorm would have
    taken four updates, not two.  They also differ from the one-shot
    step's, which normalizes by the whole batch's statistics."""
    fields = dict(EXP6, model=NARROW, grad_accum_steps=2)
    mesh = create_mesh(data=1, model=1)
    with _jitted_flax_init():
        jsetup = jax_create_train_setup(jax_config.ExperimentConfig.from_dict(fields),
                                        steps_per_epoch=SPE, mesh=mesh)
    initial = collect_host_arrays(jsetup.state.params)
    initial_stats = collect_host_arrays(jsetup.state.batch_stats)
    batch = synthetic_batch(B, SIZE, seed=70)
    jstate, jm = jsetup.train_step(jsetup.state, shard_batch(batch, mesh))
    want = collect_host_arrays(jstate.batch_stats)
    runs = {}
    for accum in (2, 1):
        setup = create_train_setup(port_config.ExperimentConfig.from_dict(
            dict(fields, grad_accum_steps=accum)), steps_per_epoch=SPE, device="cpu")
        load_jax_params(setup.model, initial, initial_stats)
        _, metrics = setup.train_step(setup.state, batch)
        runs[accum] = float(metrics["train_loss"]), _buffers(setup.model)
    assert runs[2][0] == pytest.approx(float(jm["train_loss"]), rel=1e-5)
    got, one_shot = runs[2][1], runs[1][1]
    assert {torch_name(k)[0] for k in want} == set(got)
    differs = 0
    for path, arr in want.items():
        name = torch_name(path)[0]
        np.testing.assert_allclose(got[name].numpy(), arr, rtol=1e-5,
                                   atol=1e-5 * np.abs(arr).max(), err_msg=path)
        assert not np.array_equal(arr, initial_stats[path]), path
        differs += not np.allclose(one_shot[name].numpy(), arr, rtol=1e-5,
                                   atol=1e-5 * np.abs(arr).max())
    assert differs == len(want)

