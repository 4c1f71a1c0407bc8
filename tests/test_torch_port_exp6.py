"""The port's exp-6 train step against the JAX package's, on the CPU.

exp 6 (``loss_type: "only_lunif_n_then_anchor+lalign+lunif(centroids)"``,
``only_lunif_epochs: 1``, a fixed temperature of 0.1) trains one epoch
on the per-modality uniformity alone, then on InfoNCE + lalign + the
uniformity of the normalised paired centroids.  The lockstep takes 5
steps of ``tiny-test`` at batch 8 with ``steps_per_epoch=3``, so steps
0-2 are warm and steps 3-4 are main: it crosses the phase boundary.  The
JAX run is ``create_train_setup`` + ``train_step`` on a one-device CPU
mesh (its XLA twins); the port starts from the same weights and takes
the same numpy batches.  Asserted: per-step losses and loss components,
and the final parameters (two-tier, as tests/test_torch_port_train.py).

A learnable temperature gets no gradient in the warm phase.  optax still
steps it with a zero gradient (weight decay, moments, count), and
``torch.optim.AdamW`` would skip it; the temperature lockstep holds the
port's per-step temperature to the JAX one across the boundary.
"""

import numpy as np
import pytest

from sparsify_clip_tpu import config as jax_config
from sparsify_clip_tpu import schedules as jax_schedules
from sparsify_clip_tpu.checkpoints import collect_host_arrays
from sparsify_clip_tpu.parallel.mesh import create_mesh, shard_batch
from sparsify_clip_tpu.train import create_train_setup as jax_create_train_setup
from sparsify_clip_tpu_torch import config as port_config
from sparsify_clip_tpu_torch.checkpoints import load_jax_params
from sparsify_clip_tpu_torch.data import synthetic_batch
from sparsify_clip_tpu_torch.train import create_train_setup

from test_torch_port_train import _two_tier

B, STEPS, SPE, LR = 8, 5, 3, 1e-3
EXP6 = dict(model="tiny-test", batch_size=B, epochs=2, learning_rate=LR,
            loss_type="only_lunif_n_then_anchor+lalign+lunif(centroids)", only_lunif_epochs=1,
            anchor_temperature=0.1, seed=0)
COMPONENTS = ("train_loss", "anchor", "lalign", "lunif", "learning_rate")


def _batches():
    return [synthetic_batch(B, 32, seed=10 + s) for s in range(STEPS)]


def _runs(fields):
    """The same 5 steps through the JAX step and the port's step."""
    jcfg = jax_config.ExperimentConfig.from_dict(fields)
    mesh = create_mesh(data=1, model=1)
    jsetup = jax_create_train_setup(jcfg, steps_per_epoch=SPE, mesh=mesh)
    initial = collect_host_arrays(jsetup.state.params)  # before the step donates them
    setup = create_train_setup(port_config.ExperimentConfig.from_dict(fields),
                               steps_per_epoch=SPE, device="cpu")
    load_jax_params(setup.model, initial)
    jstate, state = jsetup.state, setup.state
    jax_log, port_log = [], []
    for batch in _batches():
        jstate, jm = jsetup.train_step(jstate, shard_batch(batch, mesh))
        state, pm = setup.train_step(state, batch)
        jax_log.append({k: float(v) for k, v in jm.items()})
        port_log.append({k: float(v) for k, v in pm.items()})
    return dict(jax=jax_log, port=port_log, jax_final=collect_host_arrays(jstate.params),
                params=dict(state.model.named_parameters()))


@pytest.fixture(scope="module")
def exp6_runs():
    return _runs(dict(EXP6, fp16=False))


def test_exp6_lockstep_crosses_the_warm_phase_boundary(exp6_runs):
    jax_log, port_log = exp6_runs["jax"], exp6_runs["port"]
    assert set(port_log[0]) == set(jax_log[0])
    for step, (want, got) in enumerate(zip(jax_log, port_log)):
        for key in COMPONENTS:
            assert got[key] == pytest.approx(want[key], rel=5e-4, abs=1e-7), (step, key)
        warm = step < SPE
        # the warm steps are pure uniformity; the main steps are not
        assert (got["anchor"] == 0.0 and got["lalign"] == 0.0) == warm, step
        assert got["train_loss"] == pytest.approx(
            got["lunif"] if warm else got["anchor"] + got["lalign"] + got["lunif"], rel=1e-6)
        assert got["temperature"] == 0.1  # fixed
    # the step-462 hold: the LR factor is 1.0 through both phases
    assert all(r["learning_rate"] == LR for r in port_log)


def test_exp6_lockstep_final_parameters(exp6_runs):
    _two_tier(exp6_runs["params"], exp6_runs["jax_final"], tight_frac=0.999,
              cap=2 * LR * STEPS)


# bf16 compute over fp32 parameters (the rounding differences of
# tests/test_torch_port_train.py's bf16 lockstep).  Measured over these 5
# steps: the loss and each component up to 1.1e-2 relative apart (the
# main-phase InfoNCE at T = 0.1 the most), parameters up to 5.9e-3 apart,
# the least tight share of a tensor 0.9375 (1 of the 16 coordinates of a
# text out_proj bias is loose); the bounds are about 2.7x, 1.7x (Adam's
# cap) and one more loose coordinate in 16.  fp32 on the same inputs:
# 2.7e-6 and 2.6e-5.
BF16_LOSS_RTOL = 3e-2


def test_exp6_bf16_lockstep():
    runs = _runs(dict(EXP6, fp16=True))
    for step, (want, got) in enumerate(zip(runs["jax"], runs["port"])):
        for key in COMPONENTS:
            assert got[key] == pytest.approx(want[key], rel=BF16_LOSS_RTOL, abs=1e-7), (step, key)
    _two_tier(runs["params"], runs["jax_final"], tight_frac=0.85, cap=2 * LR * STEPS)


def test_learnable_temperature_steps_through_the_warm_phase():
    """exp 9's string with a learnable temperature: in the warm steps the
    loss does not reach T, and AdamW still decays it, as optax does; in
    the main steps its Adam count must be the JAX one."""
    runs = _runs(dict(EXP6, fp16=False, anchor_temperature_learnable=True,
                      loss_type="only_lunif_n_then_anchor+ALPHA*lalign+BETA*(lunif(text)+lunif(img))"))
    want = [r["temperature"] for r in runs["jax"]]
    got = [r["temperature"] for r in runs["port"]]
    assert want[SPE - 1] == pytest.approx(0.1 * (1 - LR * 0.01) ** SPE, rel=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    for want_r, got_r in zip(runs["jax"], runs["port"]):
        assert got_r["train_loss"] == pytest.approx(want_r["train_loss"], rel=5e-4)


@pytest.mark.parametrize("step", [0, 461, 462, 463, 500])
def test_lr_schedule_across_the_step_462_hold(step):
    """The hold ends at step 462, after which the schedule is the cosine
    with warmup: the lockstep above sees only the hold."""
    from sparsify_clip_tpu_torch.schedules import make_lr_schedule

    total, warmup = 1000, 200
    want = jax_schedules.make_lr_schedule(1e-4, warmup, total, 1)(step)
    assert make_lr_schedule(1e-4, warmup, total, 1)(step) == pytest.approx(float(want), rel=1e-6)
