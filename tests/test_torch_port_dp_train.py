"""The port's data-parallel train step at 2 ranks against the JAX step on
a ``data=2`` mesh, on the CPU.

Two gloo processes (``tests/torch_dp_worker.py``) each take their 4 rows
of every batch of 8 and run the step with the rings, the gathered
``lalign``, global-batch BatchNorm and the summed gradients; the JAX
``create_train_setup`` + ``train_step`` runs on ``create_mesh(data=2,
devices=jax.devices()[:2])`` (its XLA twins: ``_pallas_route()`` is False
on the CPU).  Both start from the JAX initial weights.  Four locksteps of
5 steps across the warm→main boundary (3 steps an epoch) under exp 6, in
fp32: ``tiny-1l`` (tiny-test cut to one block a tower) and the narrow
ResNet of tests/test_torch_port_rn50.py, each one-shot and with GradCache
at 2 microbatches (JAX's shard-aligned layout: global microbatch i is
every rank's i-th chunk, and a BatchNorm normalizes by that global
microbatch).

Tolerances against JAX: the ViT's per-step loss components rtol 5e-4
(tests/test_torch_port_exp6.py's; measured 4.2e-6); the ResNet's 1e-3
(measured 4.6e-4: the single-process ResNet lockstep of
tests/test_torch_port_rn50.py is 3.7e-4 from JAX under the same fp32
rounding), with its ``train_loss``, a sum of terms of both signs, held to
that share of the terms' magnitude; the final parameters two-tier as
those files (ViT: each tensor 99.9 % within 1.2·lr + 2e-3 relative;
ResNet: 98 % within 1.2·lr + 2·lr relative); the running statistics
after the first step rtol 1e-5, atol 1e-5 of the largest entry (fp32
rounding, as tests/test_torch_port_rn50.py's first step).  Both ranks' parameters and
buffers are bit-identical (a sha256 of their bytes).

The one-shot cases also run at one rank here, on the whole batch of 8,
through the port's own step: 2 ranks with global BatchNorm compute the
same step, so the losses agree to rtol 1e-6 for the ViT over all 5 steps
(measured 1.7e-7) and for the ResNet over the first two (measured
3.2e-7; Adam then walks the BatchNorm biases whose gradient is rounding
noise, tests/test_torch_port_rn50.py, and the later steps drift to
5.2e-5, held to 2e-4).
"""

import dataclasses
import os

import numpy as np
import pytest

import jax

from sparsify_clip_tpu import config as jax_config
from sparsify_clip_tpu.checkpoints import collect_host_arrays
from sparsify_clip_tpu.models import clip as jax_clip
from sparsify_clip_tpu.parallel.mesh import create_mesh, shard_batch
from sparsify_clip_tpu.train import create_train_setup as jax_create_train_setup
from sparsify_clip_tpu_torch.checkpoints import torch_name
from sparsify_clip_tpu_torch.data import synthetic_batch
from sparsify_clip_tpu_torch.models import clip as port_clip

import test_torch_port_rn50 as rn50_tests
import test_torch_port_train as train_tests
import torch_dp_worker

WORLD = 2
B, STEPS, SPE = 8, 5, 3
TINY = "tiny-1l"
for _registry in (jax_clip.MODEL_REGISTRY, port_clip.MODEL_REGISTRY):
    _registry.setdefault(TINY, dataclasses.replace(_registry["tiny-test"], name=TINY,
                                                   vision_layers=(1,), text_layers=1))
EXP6 = dict(batch_size=B, epochs=2, fp16=False, seed=0, anchor_temperature=0.1,
            loss_type="only_lunif_n_then_anchor+lalign+lunif(centroids)", only_lunif_epochs=1)
CASES = {
    "vit": dict(EXP6, model=TINY, learning_rate=1e-3),
    "vit-gradcache": dict(EXP6, model=TINY, learning_rate=1e-3, grad_accum_steps=2),
    "resnet": dict(EXP6, model=rn50_tests.NARROW, learning_rate=1e-4),
    "resnet-gradcache": dict(EXP6, model=rn50_tests.NARROW, learning_rate=1e-4,
                             grad_accum_steps=2),
}
SIZES = {TINY: 32, rn50_tests.NARROW: rn50_tests.SIZE}
SEEDS = [80 + s for s in range(STEPS)]
COMPONENTS = ("train_loss", "anchor", "lalign", "lunif", "learning_rate")
LOSS_RTOL = {"vit": 5e-4, "resnet": 1e-3}
STATS_TOL = 1e-5
ONE_RANK_RTOL = 1e-6
ONE_RANK_DRIFT = {"vit": 1e-6, "resnet": 2e-4}


def _jax_run(fields, mesh):
    size = SIZES[fields["model"]]
    with rn50_tests._jitted_flax_init():
        jsetup = jax_create_train_setup(jax_config.ExperimentConfig.from_dict(fields),
                                        steps_per_epoch=SPE, mesh=mesh)
    initial = collect_host_arrays(jsetup.state.params)  # before the step donates them
    stats = collect_host_arrays(jsetup.state.batch_stats) if jsetup.state.batch_stats else {}
    jstate, log, first_stats = jsetup.state, [], {}
    for seed in SEEDS:
        jstate, jm = jsetup.train_step(jstate, shard_batch(synthetic_batch(B, size, seed=seed),
                                                           mesh))
        log.append({k: float(v) for k, v in jm.items()})
        if len(log) == 1 and jstate.batch_stats:
            first_stats = collect_host_arrays(jstate.batch_stats)
    return dict(initial=initial, initial_stats=stats, log=log,
                final=collect_host_arrays(jstate.params), stats=first_stats)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    directory = str(tmp_path_factory.mktemp("dp_train"))
    mesh = create_mesh(data=WORLD, model=1, devices=jax.devices()[:WORLD])
    jax_runs, cases = {}, []
    for name, fields in CASES.items():
        jax_runs[name] = run = _jax_run(fields, mesh)
        initial = os.path.join(directory, f"{name}_initial.npz")
        np.savez(initial, **run["initial"],
                 **{f"batch_stats/{k}": v for k, v in run["initial_stats"].items()})
        cases.append(dict(name=name, fields=fields, initial=initial, steps_per_epoch=SPE,
                          batch_seeds=SEEDS, image_size=SIZES[fields["model"]]))
    results = torch_dp_worker.spawn("train", dict(cases=cases), directory, WORLD)
    port = torch_dp_worker.arrays(directory, "train", 0)
    one_rank = {name: _one_rank_losses(CASES[name], jax_runs[name]) for name in ("vit", "resnet")}
    return dict(jax=jax_runs, results=results, port=port, one_rank=one_rank)


def _one_rank_losses(fields, jax_run):
    """The port's step on one rank over the whole batch of 8."""
    from sparsify_clip_tpu_torch.checkpoints import load_jax_params
    from sparsify_clip_tpu_torch.config import ExperimentConfig
    from sparsify_clip_tpu_torch.train import create_train_setup

    setup = create_train_setup(ExperimentConfig.from_dict(fields), steps_per_epoch=SPE,
                               device="cpu")
    load_jax_params(setup.model, jax_run["initial"], jax_run["initial_stats"] or None)
    state, losses = setup.state, []
    for seed in SEEDS:
        state, metrics = setup.train_step(state, synthetic_batch(B, SIZES[fields["model"]],
                                                                 seed=seed))
        losses.append(float(metrics["train_loss"]))
    return losses


@pytest.mark.parametrize("case", sorted(CASES))
def test_dp_lockstep_losses_cross_the_warm_phase_boundary(runs, case):
    want_log = runs["jax"][case]["log"]
    logs = [r[case]["log"] for r in runs["results"]]
    assert logs[0] == logs[1]  # every rank reports the same global loss
    rtol = LOSS_RTOL[case.split("-")[0]]
    for step, (want, got) in enumerate(zip(want_log, logs[0])):
        for key in COMPONENTS[1:]:
            assert got[key] == pytest.approx(want[key], rel=rtol, abs=1e-7), (step, key)
        magnitude = sum(abs(want[k]) for k in ("anchor", "lalign", "lunif"))
        assert got["train_loss"] == pytest.approx(want["train_loss"], abs=rtol * magnitude), step
        assert (got["anchor"] == 0.0) == (step < SPE), step


@pytest.mark.parametrize("case", ["vit", "resnet"])
def test_two_ranks_take_the_one_rank_step(runs, case):
    got = [r["train_loss"] for r in runs["results"][0][case]["log"]]
    want = runs["one_rank"][case]
    for step, (a, b) in enumerate(zip(got, want)):
        rtol = ONE_RANK_RTOL if step < 2 else ONE_RANK_DRIFT[case]
        assert a == pytest.approx(b, rel=rtol), step


@pytest.mark.parametrize("case", sorted(CASES))
def test_dp_lockstep_final_parameters(runs, case):
    prefix = f"{case}/params/"
    ours = {k[len(prefix):]: _tensor(v) for k, v in runs["port"].items()
            if k.startswith(prefix)}
    want = runs["jax"][case]["final"]
    if case.startswith("resnet"):
        want = {k: v for k, v in want.items() if k != rn50_tests.K_PROJ_BIAS}
        rn50_tests._two_tier(ours, want, tight_frac=0.98)
    else:
        train_tests._two_tier(ours, want, tight_frac=0.999, cap=2 * 1e-3 * STEPS)


def _tensor(a):
    import torch

    return torch.from_numpy(a)


@pytest.mark.parametrize("case", sorted(CASES))
def test_dp_ranks_hold_bit_identical_parameters(runs, case):
    digests = {r[case]["digest"] for r in runs["results"]}
    assert len(digests) == 1, digests


@pytest.mark.parametrize("case", ["resnet", "resnet-gradcache"])
def test_dp_running_statistics_are_the_global_batchs(runs, case):
    """The running statistics after the first step equal the JAX
    global-view step's (global BatchNorm; under GradCache each global
    microbatch's), and differ from where they started."""
    prefix = f"{case}/buffers1/"
    ours = {k[len(prefix):]: v for k, v in runs["port"].items() if k.startswith(prefix)}
    want = runs["jax"][case]["stats"]
    assert {torch_name(k)[0] for k in want} == set(ours)
    for path, arr in want.items():
        got = ours[torch_name(path)[0]]
        np.testing.assert_allclose(got, arr, rtol=STATS_TOL,
                                   atol=STATS_TOL * np.abs(arr).max(), err_msg=path)
        assert not np.array_equal(arr, runs["jax"][case]["initial_stats"][path]), path
