"""``adam_mu_dtype: bfloat16`` on the port, against optax, on the CPU.

optax's ``adamw(..., mu_dtype=jnp.bfloat16)`` computes the new first
moment in fp32 from the fp32 gradient and the stored bf16 moment (whose
product with β1 it takes in bf16), takes the update from that unrounded
moment, and only then stores the moment rounded to bf16; ν stays fp32.
``sparsify_clip_tpu_torch.optim.AdamWBf16Mu`` is that update.

* The optimizer alone, 5 steps on the same gradients as optax: μ bit for
  bit (within one bf16 ulp, and no coordinate a step apart), ν and the
  parameters to fp32 rounding.
* A 5-step train lockstep of ``tiny-test`` with a learnable temperature
  against the JAX ``create_train_setup`` + ``train_step``, both with
  ``adam_mu_dtype: bfloat16``.
* The full state round-trips through ``torch.save`` with μ in bf16, and a
  mid-epoch SIGTERM then ``"auto"`` resume through the CLI is
  bit-identical to the uninterrupted run, for bf16 moments and for SigLIP
  (its two scalars in the full state).
"""

import dataclasses
import os
import signal

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

from sparsify_clip_tpu import config as jax_config
from sparsify_clip_tpu.checkpoints import collect_host_arrays
from sparsify_clip_tpu.parallel.mesh import create_mesh, shard_batch
from sparsify_clip_tpu.train import create_train_setup as jax_create_train_setup
from sparsify_clip_tpu_torch import checkpoints, cli, logging
from sparsify_clip_tpu_torch import config as port_config
from sparsify_clip_tpu_torch.checkpoints import load_jax_params, torch_name
from sparsify_clip_tpu_torch.data import synthetic_batch
from sparsify_clip_tpu_torch.optim import AdamWBf16Mu
from sparsify_clip_tpu_torch.train import create_train_setup

from test_torch_port_cli import _records, _resume_config
from test_torch_port_train import _two_tier

B, STEPS, LR = 8, 5, 1e-3
BASE = dict(model="tiny-test", batch_size=B, epochs=2, learning_rate=LR, loss_type="anchor",
            anchor_temperature_learnable=True, seed=0, fp16=False, adam_mu_dtype="bfloat16")
LRS = [0.0, 5e-4, 1e-3, 1e-3, 8e-4]


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One step of bf16 at each value: 2^(exponent - 7)."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126))) - 7)


def _as_f32(t) -> np.ndarray:
    return np.asarray(jnp.asarray(t, jnp.float32)) if not isinstance(t, torch.Tensor) \
        else t.detach().float().numpy()


@pytest.mark.parametrize("grad_scale,weight_decay", [(1e-2, 0.01), (3.0, 0.0), (1e-6, 0.01)])
def test_low_mu_adamw_matches_optax(grad_scale, weight_decay):
    rng = np.random.default_rng(int(grad_scale * 1e6) + 7)
    shapes = [(257,), (16, 33), ()]
    p0 = [np.asarray(rng.standard_normal(s), np.float32) for s in shapes]
    opt = optax.adamw(lambda c: jnp.asarray(LRS)[c], b1=0.9, b2=0.999, eps=1e-8,
                      weight_decay=weight_decay, mu_dtype=jnp.bfloat16)
    params = [jnp.asarray(p) for p in p0]
    opt_state = opt.init(params)
    ours = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    optimizer = AdamWBf16Mu(ours, lr=0.0, weight_decay=weight_decay)
    for step in range(STEPS):
        grads = [np.asarray(rng.standard_normal(s) * grad_scale, np.float32) for s in shapes]
        grads[0][::5] = 0.0  # coordinates whose gradient is 0
        updates, opt_state = opt.update([jnp.asarray(g) for g in grads], opt_state, params)
        params = optax.apply_updates(params, updates)
        for p, g in zip(ours, grads):
            p.grad = torch.from_numpy(g)
        optimizer.param_groups[0]["lr"] = LRS[step]
        optimizer.step()
        for k, p in enumerate(ours):
            state = optimizer.state[p]
            assert state["exp_avg"].dtype == torch.bfloat16
            assert state["exp_avg_sq"].dtype == torch.float32
            # the same arithmetic in the same order: the stored moments agree
            # bit for bit (the ulp bound of a moment is one step of bf16)
            np.testing.assert_array_equal(_as_f32(state["exp_avg"]),
                                          _as_f32(opt_state[0].mu[k]), err_msg=f"{step} {k}")
            np.testing.assert_allclose(state["exp_avg_sq"].numpy(), np.asarray(opt_state[0].nu[k]),
                                       rtol=1e-6, atol=0)
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]), rtol=1e-6,
                                       atol=1e-7)
    assert int(optimizer.state[ours[0]]["step"]) == STEPS


def test_the_update_takes_the_unrounded_moment():
    """One step from zero moments: μ = 0.1·g exactly in fp32, and the
    update is μ̂/(sqrt(ν̂)+eps) = g/(|g|+eps) from it, not from bf16(μ)."""
    g = torch.tensor([1.0 + 2.0 ** -10, -3.0 - 2.0 ** -9, 0.0])
    p = torch.nn.Parameter(torch.zeros(3))
    optimizer = AdamWBf16Mu([p], lr=1.0, weight_decay=0.0)
    p.grad = g.clone()
    optimizer.step()
    want = -(g / (g.abs() + 1e-8))
    torch.testing.assert_close(p.detach(), want, rtol=0, atol=2e-7)
    assert torch.equal(optimizer.state[p]["exp_avg"], (0.1 * g).to(torch.bfloat16))


@pytest.mark.parametrize("mu_dtype,kind", [("float32", torch.optim.AdamW),
                                           ("bfloat16", AdamWBf16Mu)])
def test_adam_mu_dtype_selects_the_optimizer(mu_dtype, kind):
    cfg = port_config.ExperimentConfig.from_dict(dict(BASE, adam_mu_dtype=mu_dtype))
    setup = create_train_setup(cfg, steps_per_epoch=5, device="cpu")
    assert type(setup.state.optimizer) is kind
    setup.train_step(setup.state, synthetic_batch(B, 32, seed=0))
    state = setup.state.optimizer.state[setup.state.temperature]
    assert state["exp_avg"].dtype == getattr(torch, mu_dtype)
    assert state["exp_avg_sq"].dtype == torch.float32


@pytest.fixture(scope="module")
def bf16_mu_runs():
    mesh = create_mesh(data=1, model=1)
    jsetup = jax_create_train_setup(jax_config.ExperimentConfig.from_dict(BASE),
                                    steps_per_epoch=5, mesh=mesh)
    initial = collect_host_arrays(jsetup.state.params)  # before the step donates them
    setup = create_train_setup(port_config.ExperimentConfig.from_dict(BASE), steps_per_epoch=5,
                               device="cpu")
    load_jax_params(setup.model, initial)
    jstate, state, jax_losses, losses = jsetup.state, setup.state, [], []
    for s in range(STEPS):
        batch = synthetic_batch(B, 32, seed=80 + s)
        jstate, jm = jsetup.train_step(jstate, shard_batch(batch, mesh))
        state, pm = setup.train_step(state, batch)
        jax_losses.append(float(jm["train_loss"]))
        losses.append(float(pm["train_loss"]))
    adam = jstate.opt_state[0]
    return dict(jax_losses=jax_losses, losses=losses, state=state,
                jax_final=collect_host_arrays(jstate.params),
                jax_mu=collect_host_arrays(adam.mu["model"]),
                jax_temperature=float(jstate.temperature))


def test_bf16_mu_lockstep_losses_and_parameters(bf16_mu_runs):
    np.testing.assert_allclose(bf16_mu_runs["losses"], bf16_mu_runs["jax_losses"], rtol=5e-4)
    state = bf16_mu_runs["state"]
    assert float(state.temperature.detach()) == pytest.approx(bf16_mu_runs["jax_temperature"],
                                                              rel=1e-3)
    _two_tier(dict(state.model.named_parameters()), bf16_mu_runs["jax_final"], tight_frac=0.999)


def test_bf16_mu_lockstep_first_moments(bf16_mu_runs):
    """The stored first moments are bf16 on both sides and agree within
    one bf16 ulp plus the gap of the two frameworks' gradients, which the
    moments carry: 2e-2 of each tensor's largest moment (measured over
    these 5 steps: 9.0e-3 past one ulp, text block 0's c_fc weight; the
    optimizer alone, on the same gradients, agrees bit for bit above)."""
    state = bf16_mu_runs["state"]
    params = dict(state.model.named_parameters())
    for path, want in bf16_mu_runs["jax_mu"].items():
        name, fn = torch_name(path)
        got = state.optimizer.state[params[name]]["exp_avg"]
        assert got.dtype == torch.bfloat16, name
        want = fn(np.asarray(want, np.float32))
        gap = np.abs(_as_f32(got) - want)
        assert (gap <= _bf16_ulp(want) + 2e-2 * np.abs(want).max()).all(), name


def _cli_resume_is_bit_identical(tmp_path, monkeypatch, **fields):
    """tests/test_torch_port_cli.py's SIGTERM-then-"auto" check on these
    config fields: the resumed run's weights and per-step losses equal the
    uninterrupted run's, bit for bit.  Returns the newest full state."""
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
    steps = [r for r in _records(tmp_path / "stopped" / "logs" / "resume.jsonl")
             if "train_loss" in r]
    full_steps = [r for r in _records(tmp_path / "full" / "logs" / "resume.jsonl")
                  if "train_loss" in r]
    def values(records):  # the records less their position in the log and their time
        return [{k: v for k, v in r.items() if k not in ("_step", "_time")} for r in records]

    assert values(steps) == values(full_steps)
    return torch.load(models / "resume" / "step_6.pt", weights_only=True)


def test_bf16_mu_sigterm_then_auto_resume_is_bit_identical(tmp_path, monkeypatch):
    payload = _cli_resume_is_bit_identical(tmp_path, monkeypatch, adam_mu_dtype="bfloat16")
    moments = payload["optimizer"]["state"].values()
    assert {m["exp_avg"].dtype for m in moments} == {torch.bfloat16}
    assert {m["exp_avg_sq"].dtype for m in moments} == {torch.float32}


def test_siglip_sigterm_then_auto_resume_is_bit_identical(tmp_path, monkeypatch):
    payload = _cli_resume_is_bit_identical(tmp_path, monkeypatch, loss_type="siglip",
                                           only_lunif_epochs=0, log_loss_components=True)
    scalars = payload["loss_scalars"]
    assert set(scalars) == {"logit_scale", "logit_bias"}
    assert float(scalars["logit_bias"]) != -10.0


def test_full_state_round_trip_keeps_the_bf16_moments(tmp_path):
    cfg = port_config.ExperimentConfig.from_dict(BASE)
    setup = create_train_setup(cfg, steps_per_epoch=5, device="cpu")
    for s in range(2):
        setup.state, _ = setup.train_step(setup.state, synthetic_batch(B, 32, seed=s))
    checkpoints.save_full(setup.state, str(tmp_path), cfg)
    fresh = create_train_setup(cfg, steps_per_epoch=5, device="cpu")
    checkpoints.restore_full(str(tmp_path), fresh.state)
    a, b = setup.state.optimizer.state_dict(), fresh.state.optimizer.state_dict()
    for k in a["state"]:
        for field in ("step", "exp_avg", "exp_avg_sq"):
            assert a["state"][k][field].dtype == b["state"][k][field].dtype, field
            assert torch.equal(a["state"][k][field], b["state"][k][field]), (k, field)
    batch = synthetic_batch(B, 32, seed=9)
    setup.state, m1 = setup.train_step(setup.state, batch)
    fresh.state, m2 = fresh.train_step(fresh.state, batch)
    assert float(m1["train_loss"]) == float(m2["train_loss"])
    for p, q in zip(setup.model.parameters(), fresh.model.parameters()):
        assert torch.equal(p, q)
