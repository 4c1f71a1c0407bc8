"""The port's train step against the JAX package's, on the CPU, and the
step's refusals.

The lockstep: ``tiny-test``, ``loss_type: "anchor"``, a learnable raw
temperature, batch 8, 5 steps.  The JAX run is ``create_train_setup`` +
``train_step`` on a one-device CPU mesh (its XLA twins: einsum attention,
the XLA InfoNCE); the port's run starts from the same weights
(``load_jax_params(collect_host_arrays(...))``) and takes the same numpy
batches through its own ``create_train_setup(device="cpu")``.  Asserted:
per-step losses, the final temperature, the final parameters (two-tier,
as PARITY.md:129-134: every coordinate under Adam's 2·lr·steps cap, and
>= 99.9 % within the tight bound) and the metric keys.
"""

import os
import sys

import numpy as np
import pytest
import torch

from sparsify_clip_tpu import config as jax_config
from sparsify_clip_tpu.checkpoints import collect_host_arrays
from sparsify_clip_tpu.losses import dispatch as jax_dispatch
from sparsify_clip_tpu.parallel.mesh import create_mesh, shard_batch
from sparsify_clip_tpu.train import create_train_setup as jax_create_train_setup
from sparsify_clip_tpu_torch import config as port_config
from sparsify_clip_tpu_torch.checkpoints import load_jax_params, torch_name
from sparsify_clip_tpu_torch.data import synthetic_batch
from sparsify_clip_tpu_torch.losses import contrastive_loss, dispatch
from sparsify_clip_tpu_torch.models import clip as port_clip
from sparsify_clip_tpu_torch.ops.infonce import infonce_loss
from sparsify_clip_tpu_torch.train import create_train_setup, run_training

REPO = os.path.join(os.path.dirname(__file__), os.pardir)
B, STEPS, LR = 8, 5, 1e-3
# steps_per_epoch 5 x 2 epochs: total 10, warmup 2, so the run covers lr 0,
# the linear warmup and the cosine
BASE = dict(model="tiny-test", batch_size=B, epochs=2, learning_rate=LR, loss_type="anchor",
            anchor_temperature_learnable=True, seed=0)
METRIC_KEYS = {"train_loss", "learning_rate", "beta", "alpha", "temperature",
               "anchor", "lalign", "lunif"}


def _batches():
    return [synthetic_batch(B, 32, seed=s) for s in range(STEPS)]


def _jax_run(fp16):
    cfg = jax_config.ExperimentConfig.from_dict(dict(BASE, fp16=fp16))
    mesh = create_mesh(data=1, model=1)
    setup = jax_create_train_setup(cfg, steps_per_epoch=5, mesh=mesh)
    initial = collect_host_arrays(setup.state.params)  # before the step donates them
    state, losses = setup.state, []
    for batch in _batches():
        state, metrics = setup.train_step(state, shard_batch(batch, mesh))
        losses.append(float(metrics["train_loss"]))
    return dict(initial=initial, losses=losses, temperature=float(state.temperature),
                final=collect_host_arrays(state.params), keys=set(metrics))


def _port_run(initial, fp16):
    cfg = port_config.ExperimentConfig.from_dict(dict(BASE, fp16=fp16))
    setup = create_train_setup(cfg, steps_per_epoch=5, device="cpu")
    load_jax_params(setup.model, initial)
    state, losses, metric_log = setup.state, [], []
    for batch in _batches():
        state, metrics = setup.train_step(state, batch)
        losses.append(float(metrics["train_loss"]))
        metric_log.append(metrics)
    return dict(losses=losses, temperature=float(state.temperature.detach()),
                params=dict(state.model.named_parameters()), metrics=metric_log)


def _two_tier(port_params, jax_final, tight_frac, cap=2 * LR * STEPS):
    for path, arr in jax_final.items():
        name, fn = torch_name(path)
        ours = port_params[name].detach().float().numpy()
        want = fn(np.asarray(arr))
        if name.endswith("in_proj_bias"):
            # the key third of the fused qkv bias has a zero gradient
            # (softmax is shift-invariant over keys): both sides walk it
            # only by weight decay and rounding noise; compare q and v
            w = ours.shape[0] // 3
            ours = np.concatenate([ours[:w], ours[2 * w:]])
            want = np.concatenate([want[:w], want[2 * w:]])
        gap = np.abs(ours - want)
        assert gap.max() <= cap, f"{name}: {gap.max()} over Adam's cap {cap}"
        tight = gap <= 1.2 * LR + 2e-3 * np.abs(want)
        assert tight.mean() >= tight_frac, f"{name}: only {tight.mean():.4%} tight"


@pytest.fixture(scope="module")
def fp32_runs():
    jax_run = _jax_run(fp16=False)
    return jax_run, _port_run(jax_run["initial"], fp16=False)


def test_fp32_lockstep_losses_and_temperature(fp32_runs):
    jax_run, port_run = fp32_runs
    np.testing.assert_allclose(port_run["losses"], jax_run["losses"], rtol=5e-4)
    assert port_run["temperature"] == pytest.approx(jax_run["temperature"], rel=1e-3)
    assert port_run["temperature"] != pytest.approx(0.1, abs=1e-6)  # it was learned
    assert port_run["losses"][-1] < port_run["losses"][0]


def test_fp32_lockstep_final_parameters(fp32_runs):
    jax_run, port_run = fp32_runs
    assert set(jax_run["final"]) == {p for p in jax_run["initial"]}
    _two_tier(port_run["params"], jax_run["final"], tight_frac=0.999)


def test_metric_keys_and_values_match_the_jax_step(fp32_runs):
    jax_run, port_run = fp32_runs
    first, last = port_run["metrics"][0], port_run["metrics"][-1]
    assert set(first) == jax_run["keys"] == METRIC_KEYS
    assert float(first["learning_rate"]) == 0.0  # step 0 of the linear warmup
    assert float(port_run["metrics"][1]["learning_rate"]) == pytest.approx(LR / 2)
    assert float(last["temperature"]) == pytest.approx(port_run["temperature"])
    assert float(last["anchor"]) == float(last["train_loss"])
    assert float(last["beta"]) == float(last["alpha"]) == 0.0  # learnable temperature
    assert float(last["lalign"]) == float(last["lunif"]) == 0.0


# bf16 compute over fp32 parameters: the JAX towers round P to bf16 before
# P·V, add dense biases in bf16 and evaluate GELU's tanh form in bf16 ops;
# the port keeps P in fp32 and rounds each product once.  Measured over
# these 5 steps (this test's inputs): loss gaps up to 3.2e-3 relative, the
# final temperature 8.4e-6 relative, parameters up to 3.5e-3 apart with
# 99.96 % of coordinates tight; the bounds below are about 5x, 12x, 3x
# and 25x (in the loose fraction) those.  fp32 on the same inputs: losses
# 1.2e-6 relative, parameters 1.5e-6 apart.
BF16_LOSS_RTOL = 1.5e-2


def test_bf16_lockstep():
    jax_run = _jax_run(fp16=True)
    port_run = _port_run(jax_run["initial"], fp16=True)
    np.testing.assert_allclose(port_run["losses"], jax_run["losses"], rtol=BF16_LOSS_RTOL)
    assert port_run["temperature"] == pytest.approx(jax_run["temperature"], rel=1e-4)
    # Adam divides out the gradient's scale, so a coordinate whose
    # gradient is near zero can step the other way in bf16: every
    # coordinate stays under the 2·lr·steps cap, and 99 % stay tight
    _two_tier(port_run["params"], jax_run["final"], tight_frac=0.99)


# ------------------------------------------------------------ refusals


def test_dispatch_keeps_every_reference_string():
    assert set(dispatch._DISPATCH) == set(jax_dispatch._DISPATCH)
    assert dispatch.KNOWN_LOSS_TYPES == jax_dispatch.KNOWN_LOSS_TYPES


def test_anchor_always_goes_through_the_fused_infonce(monkeypatch):
    """On any device and under either ``use_pallas``, the anchor loss is
    ``infonce_loss`` (its kernels on the card, plain versions here)."""
    calls = []

    def spy(img, txt, temperature):
        calls.append(temperature)
        return infonce_loss(img, txt, temperature)

    monkeypatch.setattr(dispatch, "infonce_loss", spy)
    rng = np.random.default_rng(5)
    img, txt = (torch.from_numpy(rng.standard_normal((6, 16)).astype(np.float32))
                for _ in range(2))
    temp = torch.tensor(0.1)
    loss, aux = dispatch.make_loss_fn("anchor")(img, txt, dispatch.LossContext(temperature=temp))
    assert calls == [temp] and float(aux["anchor"]) == float(loss)
    torch.testing.assert_close(loss, contrastive_loss(img, txt, temp), rtol=1e-6, atol=1e-6)
    cfg = port_config.ExperimentConfig.from_dict(dict(BASE, use_pallas=False))
    setup = create_train_setup(cfg, steps_per_epoch=4, device="cpu")
    setup.train_step(setup.state, synthetic_batch(B, 32, seed=0))
    assert len(calls) == 2


def test_use_pallas_false_raises_on_the_card():
    cfg = port_config.ExperimentConfig.from_dict(dict(BASE, use_pallas=False))
    with pytest.raises(NotImplementedError, match="use_pallas: false"):
        create_train_setup(cfg, steps_per_epoch=4, device="cuda")


def test_unknown_loss_type_raises():
    with pytest.raises(ValueError, match="Unknown loss_type"):
        dispatch.make_loss_fn("anchr")


@pytest.mark.parametrize("knob,match", [
    (dict(sparse_projection="topk"), "sparse_projection"),
    (dict(remat=True), "remat"),
    (dict(onehot_embed=True), "onehot_embed"),
    (dict(ln_fp32=False), "ln_fp32"),
    (dict(pipeline=True), "pipeline"),
    (dict(fsdp=True), "fsdp"),
    (dict(mesh_model=2), "mesh_model"),
    (dict(multihost=True), "multihost"),
])
def test_knobs_not_ported_yet_raise(knob, match):
    """The knobs ported since build a setup that carries them
    (``multihost``: the step over the process group's mesh, one rank
    without a group; ``fsdp``: the JAX no-op at one rank).  A model axis of
    2 needs a world of 2, and ``pipeline`` one of at least 2 stages (the
    JAX message, train.py:471-476; tests/test_torch_port_pipeline.py runs
    it)."""
    cfg = port_config.ExperimentConfig.from_dict(dict(BASE, **knob))
    if match in ("sparse_projection", "remat", "onehot_embed", "ln_fp32", "multihost", "fsdp"):
        setup = create_train_setup(cfg, steps_per_epoch=4, device="cpu")
        if match == "sparse_projection":
            assert setup.train_step.projection is not None
        elif match == "multihost":
            assert setup.config.multihost and setup.train_step.mesh.data == 1
        elif match == "fsdp":
            assert setup.config.fsdp and getattr(setup.model, "layout", None) is None
        else:
            assert setup.model.knobs[match] == knob[match]
        return
    if match == "mesh_model":
        with pytest.raises(ValueError, match="mesh_model=2 does not divide the world size 1"):
            create_train_setup(cfg, steps_per_epoch=4, device="cpu")
        return
    with pytest.raises(ValueError, match=r"^pipeline: true needs mesh_model >= 2 \(the 'model' "
                                         r"axis size is the stage count\)$"):
        create_train_setup(cfg, steps_per_epoch=4, device="cpu")


def test_entry_points_default_to_the_card_and_raise_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port_config.ExperimentConfig.from_dict(dict(BASE))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_clip.create_model("tiny-test")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_train_setup(cfg, steps_per_epoch=4)


# ------------------------------------------------------------ the loop


def test_run_training_drives_the_callbacks():
    cfg = port_config.ExperimentConfig.from_dict(dict(
        BASE, batch_size=4, epochs=2, save_checkpoint_every_n_epochs=1, log_every_n_steps=2))
    setup = create_train_setup(cfg, steps_per_epoch=3, device="cpu")
    events = []

    def batches(epoch):
        for i in range(3):
            yield synthetic_batch(4, 32, seed=10 * epoch + i)

    state = run_training(
        setup, batches,
        eval_fn=lambda s: events.append(("eval", s.step)),
        log_fn=lambda rec: events.append(("log", dict(rec))),
        checkpoint_fn=lambda s, epoch: events.append(("ckpt", s.step, epoch)),
    )
    assert state.step == 6 and setup.state is state and not setup.stopped_early
    assert [e for e in events if e[0] == "eval"] == [("eval", 0), ("eval", 3), ("eval", 6)]
    assert [e for e in events if e[0] == "ckpt"] == [("ckpt", 3, 1), ("ckpt", 6, 2)]
    steps = [e[1] for e in events if e[0] == "log" and "train_loss" in e[1]]
    assert len(steps) == 6 and all(set(r) == METRIC_KEYS for r in steps)
    assert all(isinstance(v, float) for r in steps for v in r.values())
    epoch_logs = [e[1] for e in events if e[0] == "log" and "pairs_per_sec" in e[1]]
    assert len(epoch_logs) == 2 and epoch_logs[0]["pairs_per_sec"] > 0
    assert "train_time_s" in events[-1][1]


def test_run_training_stops_early():
    cfg = port_config.ExperimentConfig.from_dict(dict(BASE, batch_size=4, epochs=3))
    setup = create_train_setup(cfg, steps_per_epoch=3, device="cpu")
    seen, ckpts = [], []

    def batches(epoch):
        for i in range(3):
            seen.append((epoch, i))
            yield synthetic_batch(4, 32, seed=i)

    state = run_training(setup, batches, checkpoint_fn=lambda s, e: ckpts.append((s.step, e)),
                         stop_fn=lambda: len(seen) >= 5)
    # epoch 0 trains three; the lookahead has drawn the fifth batch when
    # epoch 1's first step ends, and the stop fires
    assert seen == [(0, 0), (0, 1), (0, 2), (1, 0), (1, 1)]
    assert setup.stopped_early and state.step == 4 and ckpts == [(4, 2)]


# ------------------------------------------------------------ data


def test_throughput_meter_matches_the_jax_meter(monkeypatch):
    """The port's meter and the JAX ``ThroughputMeter`` read one fake clock
    over a 120-step epoch (a slow first step, then jittered steps and a
    last batch of another size) and agree exactly after every step: both
    keep the last 50 steps, so the slow first step leaves the window."""
    import time

    from sparsify_clip_tpu.utils.profiling import ThroughputMeter
    from sparsify_clip_tpu_torch.train import ThroughputMeter as PortMeter  # utils/profiling.py

    steps = 120
    gaps = 0.1 + 0.01 * np.random.default_rng(0).random(steps)
    gaps[0] = 5.0  # the first step, with its warm-up
    clock = iter(np.concatenate([[100.0], 100.0 + np.cumsum(gaps)]).repeat(2).tolist())
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
    jax_meter, port_meter = ThroughputMeter(window=50, n_chips=1), PortMeter(n_chips=1)
    jax_meter.start()
    port_meter.start()
    for i in range(steps):
        size = 8 if i < steps - 1 else 5
        jax_meter.step(size)
        port_meter.step(size)
        for key in ("pairs_per_sec", "pairs_per_sec_per_chip", "step_time_ms"):
            assert getattr(port_meter, key) == getattr(jax_meter, key), (i, key)
    assert port_meter.step_time_ms == pytest.approx(gaps[-50:].mean() * 1e3)
    assert port_meter.pairs_per_sec == pytest.approx((49 * 8 + 5) / gaps[-50:].sum())


def test_synthetic_batch_is_the_bench_batch():
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        from _bench import synthetic_batch as bench_batch
    finally:
        sys.path.pop(0)
    got, want = synthetic_batch(6, 32, seed=3), bench_batch(6, 32, seed=3)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])
