"""The sparse embedding projection (``sparse_projection``) in the port
against the JAX package, on the CPU.

* ``topk_project`` and ``l1_shrink`` against ``sparsify_clip_tpu.ops.sparsify``
  in value (rtol 1e-6) and gradient (rtol 1e-5, atol 1e-6 on unit rows):
  planted ties at the k-th magnitude (JAX's ``>=`` mask keeps them all),
  ``k`` equal to D, and an ``l1`` row whose every component is under λ
  (the 1e-12 floor: zeros forward; the port's gradient there is 0 where
  JAX's is NaN, and equal on the other rows).
* The exp-6 step with ``sparse_projection: topk`` across
  ``sparse_after_epoch``: a 5-step lockstep of ``tiny-test`` cut to one
  block a tower (``tiny-1l``: one block compiles in half the JAX time) at
  batch 8,
  2 steps an epoch (steps 0-1 unprojected and warm, 2-3 projected, 4 in
  epoch 2), against the JAX ``create_train_setup`` / ``train_step``, one
  shot and with GradCache at 2 microbatches, at the exp-6 lockstep's
  tolerances (tests/test_torch_port_exp6.py): losses 5e-4 relative, the
  final parameters two-tier.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparsify_clip_tpu import config as jax_config
from sparsify_clip_tpu.models import clip as jax_clip
from sparsify_clip_tpu.checkpoints import collect_host_arrays
from sparsify_clip_tpu.ops import sparsify as jax_sparsify
from sparsify_clip_tpu.parallel.mesh import create_mesh, shard_batch
from sparsify_clip_tpu.train import create_train_setup as jax_create_train_setup
from sparsify_clip_tpu_torch import config as port_config
from sparsify_clip_tpu_torch.checkpoints import load_jax_params
from sparsify_clip_tpu_torch.data import synthetic_batch
from sparsify_clip_tpu_torch.models import clip as port_clip
from sparsify_clip_tpu_torch.ops import sparsify
from sparsify_clip_tpu_torch.train import create_train_setup

from test_torch_port_rn50 import _jitted_flax_init
from test_torch_port_train import _two_tier

TINY = "tiny-1l"
for _registry in (jax_clip.MODEL_REGISTRY, port_clip.MODEL_REGISTRY):
    _registry.setdefault(TINY, dataclasses.replace(_registry["tiny-test"], name=TINY,
                                                   vision_layers=(1,), text_layers=1))
VALUE_RTOL = 1e-6
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)


def _rows(seed=0, n=6, d=32):
    x = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _with_ties(k):
    x = _rows(1)
    # row 0: the k-th and (k+1)-th magnitudes tie (one of them negative);
    # row 1: four components tie at the k-th magnitude
    order = np.argsort(-np.abs(x[0]))
    x[0, order[k]] = -np.abs(x[0, order[k - 1]])
    order = np.argsort(-np.abs(x[1]))
    x[1, order[k - 1:k + 3]] = np.abs(x[1, order[k - 1]])
    return x


CASES = {
    "topk-ties": (lambda x: jax_sparsify.topk_project(x, 5), lambda x: sparsify.topk_project(x, 5),
                  _with_ties(5)),
    "topk-k-equals-d": (lambda x: jax_sparsify.topk_project(x, 32),
                        lambda x: sparsify.topk_project(x, 32), _rows(2)),
    "topk-k1": (lambda x: jax_sparsify.topk_project(x, 1), lambda x: sparsify.topk_project(x, 1),
                _rows(3)),
    "l1": (lambda x: jax_sparsify.l1_shrink(x, 0.05), lambda x: sparsify.l1_shrink(x, 0.05),
           _rows(4)),
    # row 0 all under λ: projected to zeros, by the 1e-12 floor
    "l1-all-below-lambda": (lambda x: jax_sparsify.l1_shrink(x, 0.05),
                            lambda x: sparsify.l1_shrink(x, 0.05),
                            np.concatenate([0.01 * _rows(5, n=1), _rows(6, n=3)])),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_projection_matches_jax_in_value_and_gradient(case):
    jax_fn, port_fn, x = CASES[case]
    w = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)
    want_y = np.asarray(jax.jit(jax_fn)(jnp.asarray(x)))
    want_grad = np.asarray(jax.jit(jax.grad(lambda x: jnp.sum(jax_fn(x) * w)))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = port_fn(xt)
    (y * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), want_y, rtol=VALUE_RTOL, atol=1e-7)
    grad = xt.grad.numpy()
    finite = np.isfinite(want_grad).all(1)
    np.testing.assert_allclose(grad[finite], want_grad[finite], **GRAD_TOL)
    if case.startswith("topk"):
        k = {"topk-ties": 5, "topk-k-equals-d": 32, "topk-k1": 1}[case]
        kept = (y.detach() != 0).sum(1).numpy()
        assert (kept >= k).all() and np.array_equal(kept, (want_y != 0).sum(1))
        if case == "topk-ties":
            assert kept[0] == k + 1 and kept[1] == k + 3  # ties keep more than k
        np.testing.assert_allclose(np.linalg.norm(y.detach().numpy(), axis=1), 1.0, rtol=1e-6)
    if case == "l1-all-below-lambda":
        assert (y.detach().numpy()[0] == 0).all() and (grad[0] == 0).all()
        assert np.isnan(want_grad[0]).all() and finite[1:].all()
    else:
        assert finite.all()


def test_unknown_projection_raises_the_jax_message():
    with pytest.raises(ValueError) as want:
        jax_sparsify.make_projection("topq")
    with pytest.raises(ValueError) as got:
        sparsify.make_projection("topq")
    assert str(got.value) == str(want.value)
    assert sparsify.make_projection("none") is None


B, STEPS, SPE, LR = 8, 5, 2, 1e-3
FIELDS = dict(model=TINY, batch_size=B, epochs=3, learning_rate=LR, fp16=False, seed=0,
              loss_type="only_lunif_n_then_anchor+lalign+lunif(centroids)", only_lunif_epochs=1,
              anchor_temperature=0.1, sparse_projection="topk", sparse_topk=4,
              sparse_after_epoch=1)
KEYS = ("train_loss", "anchor", "lalign", "lunif")


def _lockstep(fields):
    mesh = create_mesh(data=1, model=1)
    with _jitted_flax_init():
        jsetup = jax_create_train_setup(jax_config.ExperimentConfig.from_dict(fields),
                                        steps_per_epoch=SPE, mesh=mesh)
    initial = collect_host_arrays(jsetup.state.params)  # before the step donates them
    setup = create_train_setup(port_config.ExperimentConfig.from_dict(fields),
                               steps_per_epoch=SPE, device="cpu")
    load_jax_params(setup.model, initial)
    jstate, state, logs = jsetup.state, setup.state, []
    for s in range(STEPS):
        batch = synthetic_batch(B, 32, seed=40 + s)
        jstate, jm = jsetup.train_step(jstate, shard_batch(batch, mesh))
        state, pm = setup.train_step(state, batch)
        logs.append(({k: float(jm[k]) for k in KEYS}, {k: float(pm[k]) for k in KEYS}))
    return logs, dict(state.model.named_parameters()), collect_host_arrays(jstate.params)


@pytest.mark.parametrize("accum", [1, 2], ids=["one-shot", "gradcache"])
def test_topk_lockstep_crosses_sparse_after_epoch(accum):
    logs, params, jax_final = _lockstep(dict(FIELDS, grad_accum_steps=accum))
    for step, (want, got) in enumerate(logs):
        for key in KEYS:
            assert got[key] == pytest.approx(want[key], rel=5e-4, abs=1e-7), (step, key)
    _two_tier(params, jax_final, tight_frac=0.999, cap=2 * LR * STEPS)


def test_projection_switches_on_at_sparse_after_epoch():
    """The same steps with and without the projection: equal losses
    before the epoch boundary, different after it (the epoch comes from
    ``state.step``)."""
    runs = {}
    for kind in ("topk", "none"):
        setup = create_train_setup(port_config.ExperimentConfig.from_dict(
            dict(FIELDS, sparse_projection=kind)), steps_per_epoch=SPE, device="cpu")
        state, losses = setup.state, []
        for s in range(2 * SPE):
            state, metrics = setup.train_step(state, synthetic_batch(B, 32, seed=40 + s))
            losses.append(float(metrics["train_loss"]))
        runs[kind] = losses
    assert runs["topk"][:SPE] == runs["none"][:SPE]
    assert all(a != b for a, b in zip(runs["topk"][SPE:], runs["none"][SPE:]))
