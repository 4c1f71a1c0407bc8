"""``remat`` / ``remat_policy`` in the port, on the CPU.

* The remat step equals the port's own no-remat step to the bit in fp32
  (loss and every gradient), under each policy name and with the fused
  LN+qkv, and recomputes: each block's forward, attention core included,
  runs twice a step.
* A 3-step exp-6 lockstep of ``tiny-1l`` (tests/test_torch_port_sparsify.py:
  ``tiny-test`` cut to one block a tower) with ``remat: true`` against the
  JAX remat step (``make_train_step`` over ``CLIP(remat=True)``), at the
  exp-6 lockstep's tolerances (losses 5e-4 relative, the final parameters
  two-tier; tests/test_torch_port_exp6.py).
* An unknown policy raises the JAX message.
* A ResNet cut in depth and width (tests/test_torch_port_rn50.py's
  ``rn50-narrow-test``): after two remat steps the running statistics, the
  parameters and the losses equal the no-remat steps' to the bit; the
  checkpoint's recompute does not move the statistics a second time.
"""

import pytest
import torch

from sparsify_clip_tpu import config as jax_config
from sparsify_clip_tpu.checkpoints import collect_host_arrays
from sparsify_clip_tpu.models import layers as jax_layers
from sparsify_clip_tpu.parallel.mesh import create_mesh, shard_batch
from sparsify_clip_tpu.train import build_optimizer, make_train_step
from sparsify_clip_tpu.train import create_train_setup as jax_create_train_setup
from sparsify_clip_tpu_torch import config as port_config
from sparsify_clip_tpu_torch.checkpoints import load_jax_params
from sparsify_clip_tpu_torch.data import synthetic_batch
from sparsify_clip_tpu_torch.models import layers
from sparsify_clip_tpu_torch.models.resnet import Bottleneck
from sparsify_clip_tpu_torch.train import create_train_setup

from test_torch_port_rn50 import NARROW, SIZE, _jitted_flax_init
from test_torch_port_sparsify import TINY
from test_torch_port_train import _two_tier

B, SPE, LR = 8, 2, 1e-3
EXP6 = dict(model="tiny-test", batch_size=B, epochs=2, learning_rate=LR, fp16=False, seed=0,
            loss_type="only_lunif_n_then_anchor+lalign+lunif(centroids)", only_lunif_epochs=1,
            anchor_temperature=0.1)
POLICIES = [None, "nothing", "full", "dots", "dots_no_batch", "attn_out"]


def _grads(fields, batch, step):
    """One step's loss and gradients (the optimizer does not step), and
    how many times the blocks' attention core ran."""
    setup = create_train_setup(port_config.ExperimentConfig.from_dict(fields),
                               steps_per_epoch=SPE, device="cpu")
    setup.state.step = step
    calls, core = [0], layers.attention_core

    def counted(*args, **kwargs):
        calls[0] += 1
        return core(*args, **kwargs)

    layers.attention_core = counted
    try:
        loss = setup.train_step.loss_and_grads(setup.state, batch)[0]
    finally:
        layers.attention_core = core
    return loss, [p.grad for p in setup.model.parameters()], calls[0]


@pytest.fixture(scope="module")
def plain_grads():
    batch = synthetic_batch(B, 32, seed=3)
    return batch, {step: _grads(EXP6, batch, step) for step in (0, SPE)}


@pytest.mark.parametrize("policy", POLICIES + ["nothing+fused_ln_qkv"], ids=str)
def test_remat_step_equals_the_plain_step_bitwise(plain_grads, policy):
    """Under every policy, and with the fused LN+qkv's autograd Function
    inside the checkpoint (against the plain fused step)."""
    batch, plain = plain_grads
    fused = policy.endswith("+fused_ln_qkv") if policy else False
    fields = dict(EXP6, fused_ln_qkv=fused)
    if fused:
        policy = "nothing"
        plain = {step: _grads(fields, batch, step) for step in (0, SPE)}
    for step in (0, SPE):  # a warm and a main step
        loss, grads, calls = _grads(dict(fields, remat=True, remat_policy=policy), batch, step)
        want_loss, want_grads, want_calls = plain[step]
        assert torch.equal(loss, want_loss), (policy, step)
        assert all(torch.equal(a, b) for a, b in zip(grads, want_grads)), (policy, step)
        # 4 blocks; the backward recomputes each block's forward
        assert (want_calls, calls) == (4, 8), (policy, step)


def test_unknown_remat_policy_raises_the_jax_message():
    with pytest.raises(ValueError) as want:
        jax_layers.resolve_remat_policy("dot")
    with pytest.raises(ValueError) as got:
        layers.resolve_remat_policy("dot")
    assert str(got.value) == str(want.value)
    for name in ("nothing", "full", None):
        assert layers.resolve_remat_policy(name) is None
    with pytest.raises(ValueError, match="Unknown remat_policy"):
        create_train_setup(port_config.ExperimentConfig.from_dict(
            dict(EXP6, remat=True, remat_policy="dot")), steps_per_epoch=SPE, device="cpu")


def test_remat_lockstep_against_the_jax_remat_step():
    fields = dict(EXP6, model=TINY, remat=True, remat_policy="nothing")
    jcfg = jax_config.ExperimentConfig.from_dict(fields)
    mesh = create_mesh(data=1, model=1)
    # the JAX state of the plain setup (the same parameters: remat changes
    # no parameter), stepped by the JAX step over CLIP(remat=True)
    with _jitted_flax_init():
        jsetup = jax_create_train_setup(jax_config.ExperimentConfig.from_dict(
            dict(EXP6, model=TINY)), steps_per_epoch=SPE, mesh=mesh)
    total = SPE * jcfg.epochs
    optimizer, schedule = build_optimizer(jcfg, total)
    jstep = make_train_step(jsetup.model.clone(remat=True, remat_policy="nothing"), jcfg,
                            optimizer, SPE, total, schedule)
    initial = collect_host_arrays(jsetup.state.params)
    setup = create_train_setup(port_config.ExperimentConfig.from_dict(fields),
                               steps_per_epoch=SPE, device="cpu")
    load_jax_params(setup.model, initial)
    jstate, state = jsetup.state, setup.state
    for s in range(3):  # warm, warm, main
        batch = synthetic_batch(B, 32, seed=20 + s)
        jstate, jm = jstep(jstate, shard_batch(batch, mesh))
        state, pm = setup.train_step(state, batch)
        for key in ("train_loss", "anchor", "lalign", "lunif"):
            assert float(pm[key]) == pytest.approx(float(jm[key]), rel=5e-4, abs=1e-7), (s, key)
    _two_tier(dict(state.model.named_parameters()), collect_host_arrays(jstate.params),
              tight_frac=0.999, cap=2 * LR * 3)


def test_resnet_remat_keeps_the_running_statistics(monkeypatch):
    runs, calls = {}, []
    forward = Bottleneck._forward
    monkeypatch.setattr(Bottleneck, "_forward",
                        lambda self, x, update: calls.append(update) or forward(self, x, update))
    for remat in (False, True):
        setup = create_train_setup(port_config.ExperimentConfig.from_dict(
            dict(EXP6, model=NARROW, batch_size=4, remat=remat)), steps_per_epoch=SPE,
            device="cpu")
        losses = []
        for seed in range(2):
            setup.state, metrics = setup.train_step(setup.state, synthetic_batch(4, SIZE, seed=seed))
            losses.append(float(metrics["train_loss"]))
        runs[remat] = (losses, {n: b.clone() for n, b in setup.model.named_buffers()},
                       {n: p.detach().clone() for n, p in setup.model.named_parameters()})
    (losses, buffers, params), (r_losses, r_buffers, r_params) = runs[False], runs[True]
    # 4 blocks: 2 steps of 4 forwards, then 2 of 4 forwards and 4 recomputes,
    # and only the forwards move the statistics
    assert calls == [True] * 8 + ([True] * 4 + [False] * 4) * 2
    assert r_losses == losses
    assert any(not torch.equal(b, torch.zeros_like(b)) for n, b in buffers.items()
               if n.endswith("running_mean"))
    for name, b in buffers.items():
        assert torch.equal(r_buffers[name], b), name
    for name, p in params.items():
        assert torch.equal(r_params[name], p), name
