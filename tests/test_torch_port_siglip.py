"""The port's SigLIP and soft-target (``anchor-roberta``) losses and
steps against the JAX package's, on the CPU.

* ``siglip_loss`` and ``contrastive_loss_roberta``: value and gradients
  against ``jax.grad`` of the JAX functions on the same numpy inputs.
* A 5-step ``siglip`` lockstep of ``tiny-test`` at batch 8 against the
  JAX ``create_train_setup`` + ``train_step`` on a one-device mesh: the
  losses, ``siglip_scale``, ``siglip_bias`` and the final parameters
  (two-tier, as tests/test_torch_port_train.py).
* ``anchor-roberta`` through ``run_training`` with the in-repo provider
  ``_stub_roberta:soft_targets`` (tests/_stub_roberta.py) against the JAX
  ``run_training``, and the provider resolver's errors against the JAX
  resolver's, message for message.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparsify_clip_tpu import config as jax_config
from sparsify_clip_tpu import train as jax_train
from sparsify_clip_tpu.checkpoints import collect_host_arrays
from sparsify_clip_tpu.losses import contrastive as jax_contrastive
from sparsify_clip_tpu.losses import dispatch as jax_dispatch
from sparsify_clip_tpu.losses import sigmoid as jax_sigmoid
from sparsify_clip_tpu.parallel.mesh import create_mesh, shard_batch
from sparsify_clip_tpu_torch import config as port_config
from sparsify_clip_tpu_torch import train
from sparsify_clip_tpu_torch.checkpoints import load_jax_params
from sparsify_clip_tpu_torch.data import synthetic_batch
from sparsify_clip_tpu_torch.losses import contrastive_loss_roberta, dispatch, siglip_loss

from test_torch_port_train import _two_tier

# fp32 on both sides: the same arithmetic, sums taken in other orders
VALUE = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-5, atol=1e-6)
B, STEPS, LR = 8, 5, 1e-3
SIGLIP = dict(model="tiny-test", batch_size=B, epochs=2, learning_rate=LR, loss_type="siglip",
              anchor_temperature_learnable=False, fp16=False, seed=0)
STUB = "_stub_roberta:soft_targets"


def _unit_rows(n, d, seed):
    x = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _soft_targets(n, seed):
    e = np.exp(3.0 * np.random.default_rng(seed).standard_normal((n, n)))
    return (e / e.sum(axis=1, keepdims=True)).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


# ------------------------------------------------------------------ the losses


@pytest.mark.parametrize("n,d,scale,bias", [(8, 16, 10.0, -10.0), (24, 20, 3.5, 0.25),
                                            (33, 64, 25.0, -4.0)])
def test_siglip_loss_matches_the_jax_loss(n, d, scale, bias):
    img, txt = _unit_rows(n, d, n), _unit_rows(n, d, n + 1)
    want, grads = jax.value_and_grad(jax_sigmoid.siglip_loss, argnums=(0, 1, 2, 3))(
        jnp.asarray(img), jnp.asarray(txt), jnp.float32(scale), jnp.float32(bias))
    leaves = [torch.from_numpy(img), torch.from_numpy(txt), torch.tensor(scale),
              torch.tensor(bias)]
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss = siglip_loss(*leaves)
    loss.backward()
    _close(loss, want, VALUE)
    for leaf, g in zip(leaves, grads):
        _close(leaf.grad, g, GRAD)


@pytest.mark.parametrize("n,d,temp", [(8, 16, 0.1), (24, 20, 0.07), (33, 64, 0.5)])
def test_contrastive_loss_roberta_matches_the_jax_loss(n, d, temp):
    img, txt, st = _unit_rows(n, d, n), _unit_rows(n, d, n + 1), _soft_targets(n, n + 2)
    want, grads = jax.value_and_grad(jax_contrastive.contrastive_loss_roberta,
                                     argnums=(0, 1, 3))(
        jnp.asarray(img), jnp.asarray(txt), jnp.asarray(st), jnp.float32(temp))
    leaves = [torch.from_numpy(img), torch.from_numpy(txt), torch.tensor(temp)]
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss = contrastive_loss_roberta(leaves[0], leaves[1], torch.from_numpy(st), leaves[2])
    loss.backward()
    _close(loss, want, VALUE)
    for leaf, g in zip(leaves, grads):
        _close(leaf.grad, g, GRAD)


@pytest.mark.parametrize("loss_type,match", [("siglip", "logit_scale/logit_bias"),
                                             ("anchor-roberta", "'soft_targets'")])
def test_missing_context_raises_the_jax_error(loss_type, match):
    img = torch.from_numpy(_unit_rows(4, 8, 0))
    ctx = dispatch.LossContext(temperature=torch.tensor(0.1))
    jctx = jax_dispatch.LossContext(temperature=jnp.float32(0.1), beta=jnp.float32(0),
                                    alpha=jnp.float32(0), warm=jnp.bool_(False))
    with pytest.raises(ValueError, match=match) as got:
        dispatch.make_loss_fn(loss_type)(img, img, ctx)
    with pytest.raises(ValueError) as want:
        jax_dispatch.make_loss_fn(loss_type)(jnp.asarray(img.numpy()), jnp.asarray(img.numpy()),
                                             jctx)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------------ the siglip step


def _batches():
    return [synthetic_batch(B, 32, seed=20 + s) for s in range(STEPS)]


@pytest.fixture(scope="module")
def siglip_runs():
    jcfg = jax_config.ExperimentConfig.from_dict(SIGLIP)
    mesh = create_mesh(data=1, model=1)
    jsetup = jax_train.create_train_setup(jcfg, steps_per_epoch=5, mesh=mesh)
    initial = collect_host_arrays(jsetup.state.params)  # before the step donates them
    setup = train.create_train_setup(port_config.ExperimentConfig.from_dict(SIGLIP),
                                     steps_per_epoch=5, device="cpu")
    load_jax_params(setup.model, initial)
    jstate, state = jsetup.state, setup.state
    scalars0 = {k: float(v.detach()) for k, v in state.loss_scalars.items()}
    jax_log, port_log = [], []
    for batch in _batches():
        jstate, jm = jsetup.train_step(jstate, shard_batch(batch, mesh))
        state, pm = setup.train_step(state, batch)
        jax_log.append({k: float(v) for k, v in jm.items()})
        port_log.append({k: float(v) for k, v in pm.items()})
    return dict(jax=jax_log, port=port_log, jax_final=collect_host_arrays(jstate.params),
                params=dict(state.model.named_parameters()), scalars0=scalars0,
                jax_scalars={k: float(v) for k, v in jstate.loss_scalars.items()},
                scalars={k: float(v.detach()) for k, v in state.loss_scalars.items()},
                optimizer=state.optimizer, state=state)


def test_siglip_scalars_start_at_the_inits_and_are_trained(siglip_runs):
    assert np.exp(siglip_runs["scalars0"]["logit_scale"]) == pytest.approx(10.0, rel=1e-6)
    assert siglip_runs["scalars0"]["logit_bias"] == -10.0
    state = siglip_runs["state"]
    trained = {id(p) for g in siglip_runs["optimizer"].param_groups for p in g["params"]}
    assert all(id(v) in trained for v in state.loss_scalars.values())
    assert not state.temperature.requires_grad
    assert all(g["weight_decay"] == 0.01 for g in siglip_runs["optimizer"].param_groups)


def test_siglip_lockstep_losses_and_scalars(siglip_runs):
    jax_log, port_log = siglip_runs["jax"], siglip_runs["port"]
    assert set(port_log[0]) == set(jax_log[0])
    assert {"siglip_scale", "siglip_bias"} <= set(port_log[0])
    for step, (want, got) in enumerate(zip(jax_log, port_log)):
        for key in ("train_loss", "anchor", "learning_rate", "siglip_scale", "siglip_bias"):
            assert got[key] == pytest.approx(want[key], rel=5e-4, abs=1e-7), (step, key)
    # the metric is the positive scale after the step, not its log
    assert port_log[-1]["siglip_scale"] == pytest.approx(
        np.exp(siglip_runs["scalars"]["logit_scale"]), rel=1e-6)
    assert port_log[-1]["siglip_bias"] == siglip_runs["scalars"]["logit_bias"]
    for key in ("logit_scale", "logit_bias"):
        assert siglip_runs["scalars"][key] == pytest.approx(siglip_runs["jax_scalars"][key],
                                                            rel=1e-5)
        assert siglip_runs["scalars"][key] != siglip_runs["scalars0"][key]
    assert port_log[-1]["train_loss"] < port_log[0]["train_loss"]


def test_siglip_lockstep_final_parameters(siglip_runs):
    _two_tier(siglip_runs["params"], siglip_runs["jax_final"], tight_frac=0.999)


# ------------------------------------------------------------------ anchor-roberta


def _caption_batches(epoch):
    for i in range(3):
        batch = synthetic_batch(B, 32, seed=40 + i)
        batch["captions"] = [f"caption {epoch}-{i}-{j}" for j in range(B)]
        yield batch


def test_anchor_roberta_through_run_training_matches_the_jax_run():
    fields = dict(model="tiny-test", batch_size=B, epochs=1, learning_rate=LR, fp16=False,
                  seed=0, loss_type="anchor-roberta", anchor_temperature_learnable=True,
                  soft_targets_provider=STUB)
    jsetup = jax_train.create_train_setup(jax_config.ExperimentConfig.from_dict(fields),
                                          steps_per_epoch=3, mesh=create_mesh(data=1, model=1))
    initial = collect_host_arrays(jsetup.state.params)
    jax_records = []
    jstate = jax_train.run_training(jsetup, _caption_batches, log_fn=jax_records.append)
    setup = train.create_train_setup(port_config.ExperimentConfig.from_dict(fields),
                                     steps_per_epoch=3, device="cpu")
    load_jax_params(setup.model, initial)
    records = []
    state = train.run_training(setup, _caption_batches, log_fn=records.append)
    want = [r for r in jax_records if "train_loss" in r]
    got = [r for r in records if "train_loss" in r]
    assert len(got) == len(want) == 3 and set(got[0]) == set(want[0])
    for w, g in zip(want, got):
        for key in ("train_loss", "anchor", "temperature", "learning_rate"):
            assert g[key] == pytest.approx(w[key], rel=5e-4, abs=1e-7), key
    _two_tier(dict(state.model.named_parameters()), collect_host_arrays(jstate.params),
              tight_frac=0.999, cap=2 * LR * 3)
    # the soft targets reach the loss: the same run on hard targets differs
    hard = train.create_train_setup(port_config.ExperimentConfig.from_dict(
        dict(fields, loss_type="anchor", soft_targets_provider="")), steps_per_epoch=3,
        device="cpu")
    load_jax_params(hard.model, initial)
    hard_records = []
    train.run_training(hard, _caption_batches, log_fn=hard_records.append)
    assert hard_records[0]["train_loss"] != pytest.approx(got[0]["train_loss"], rel=1e-5)


def test_soft_targets_provider_resolution_matches_the_jax_resolver():
    fn = train.resolve_soft_targets_provider(STUB)
    assert fn is jax_train.resolve_soft_targets_provider(STUB)
    assert train.resolve_soft_targets_provider("_stub_roberta.soft_targets") is fn
    assert train.resolve_soft_targets_provider("") is None
    batch = {"images": np.zeros((2, 1)), "tokens": np.zeros((2, 1)), "captions": ["a", "b"]}
    st = train.apply_soft_targets(batch, fn)["soft_targets"]
    np.testing.assert_array_equal(
        st, jax_train._apply_soft_targets(batch, {}, fn)["soft_targets"])
    assert st.dtype == np.float32 and st.shape == (2, 2)
    np.testing.assert_allclose(st.sum(axis=1), 1.0, rtol=1e-6)
    assert train.apply_soft_targets(batch, None) is batch
    fields = train.batch_to_device(train.apply_soft_targets(batch, fn), torch.device("cpu"))
    assert fields["soft_targets"].dtype == torch.float32 and "captions" not in fields


@pytest.mark.parametrize("case", ["not_a_spec", "not_callable", "bad_shape", "no_captions"])
def test_soft_targets_errors_are_the_jax_errors(case):
    def run(resolve, apply):
        if case == "not_a_spec":
            resolve("justamodule")
        elif case == "not_callable":
            resolve("_stub_roberta:np")
        elif case == "bad_shape":
            apply({"captions": ["a", "b"]}, resolve("_stub_roberta:bad_shape"))
        else:
            apply({}, resolve(STUB))

    with pytest.raises((ValueError, TypeError)) as got:
        run(train.resolve_soft_targets_provider, train.apply_soft_targets)
    with pytest.raises((ValueError, TypeError)) as want:
        run(jax_train.resolve_soft_targets_provider,
            lambda batch, fn: jax_train._apply_soft_targets(batch, {}, fn))
    assert type(got.value) is type(want.value) and str(got.value) == str(want.value)
