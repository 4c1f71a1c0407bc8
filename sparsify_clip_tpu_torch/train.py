"""Training: the train state, one step, and the epoch loop, ported from
:mod:`sparsify_clip_tpu.train` (reference: sparsify_clip.py:682-986).

* Encoders compute in bf16 (``fp16: True``) over fp32 parameters; the
  embeddings and the loss are fp32.  There is no GradScaler: bf16 has
  fp32's exponent range.
* The learnable temperature is the **raw divisor**, an fp32 scalar on
  the device beside the model's parameters, not a logit scale.
* AdamW as the reference configures it: betas (0.9, 0.999), eps 1e-8,
  decoupled weight decay 0.01 on **every** trainable, the temperature
  included; the LR comes from :func:`schedules.make_lr_schedule`,
  evaluated at the 0-based optimizer count as optax does.
* β/α are evaluated at the 1-based batch index (sparsify_clip.py:755).

The JAX step is a pure function of an immutable state.  Here the state
holds the model and the optimizer, which a step updates in place; a
step returns the same state object, so the JAX call shape
``state, metrics = train_step(state, batch)`` carries over.

One device: the mesh, sharding, multi-host and pipeline paths wait for
ROADMAP Queue 1 item 11, and every config knob the step does not support
yet raises (see ``_NOT_PORTED``).  Entry points run on the card unless the
caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, Iterator, List, Optional, Tuple, Union

import torch

from sparsify_clip_tpu_torch.config import ExperimentConfig
from sparsify_clip_tpu_torch.losses import LossContext, make_loss_fn
from sparsify_clip_tpu_torch.models.clip import CLIP, create_model
from sparsify_clip_tpu_torch.schedules import get_alpha, get_beta, make_lr_schedule
from sparsify_clip_tpu_torch.utils.numerics import l2_normalize

Batch = Dict[str, Any]
Metrics = Dict[str, Union[torch.Tensor, float]]

# Config knobs the port's step does not run yet → what they wait for.
_NOT_PORTED: List[Tuple[Callable[[ExperimentConfig], bool], str]] = [
    (lambda c: c.grad_accum_steps > 1,
     "grad_accum_steps > 1 (GradCache accumulation, ROADMAP Queue 1 item 3)"),
    (lambda c: c.adam_mu_dtype != "float32",
     "adam_mu_dtype: bfloat16 (ROADMAP Queue 1 item 3)"),
    (lambda c: c.device_augment, "device_augment (ops/image.py, ROADMAP Queue 1 item 9)"),
    (lambda c: c.sparse_projection != "none",
     "sparse_projection (ops/sparsify.py, ROADMAP Queue 1 item 13)"),
    (lambda c: c.remat, "remat (ROADMAP Queue 1 item 13)"),
    (lambda c: c.onehot_embed, "onehot_embed (ROADMAP Queue 1 item 13)"),
    (lambda c: not c.ln_fp32, "ln_fp32: false (ROADMAP Queue 1 item 13)"),
    (lambda c: c.pipeline, "pipeline (parallel/pipeline.py, ROADMAP Queue 1 item 11)"),
    (lambda c: c.fsdp, "fsdp (ROADMAP Queue 1 item 11)"),
    (lambda c: c.mesh_model > 1, "mesh_model > 1 (tensor parallelism, ROADMAP Queue 1 item 11)"),
    (lambda c: c.multihost, "multihost (ROADMAP Queue 1 item 11)"),
    (lambda c: bool(c.soft_targets_provider),
     "soft_targets_provider (anchor-roberta, ROADMAP Queue 1 item 2)"),
]


def check_supported(config: ExperimentConfig) -> None:
    """Raise :class:`NotImplementedError` for the first config knob the
    port's step does not run yet; the loss type is checked by
    :func:`make_loss_fn` and ResNet towers by ``create_model``."""
    for unsupported, what in _NOT_PORTED:
        if unsupported(config):
            raise NotImplementedError(
                f"{what} is not ported to sparsify_clip_tpu_torch's train step yet"
            )


@dataclasses.dataclass
class TrainState:
    step: int                           # 0-based optimizer step count
    model: CLIP                         # fp32 parameters
    temperature: torch.Tensor           # raw fp32 scalar on the device
    optimizer: torch.optim.Optimizer    # AdamW over the trainables


def build_optimizer(params, lr_schedule: Callable[[int], float]) -> torch.optim.AdamW:
    """AdamW exactly as the reference configures it: betas (0.9, 0.999),
    eps 1e-8, decoupled wd 0.01 applied to ALL parameters (torch AdamW
    default; sparsify_clip.py:730).  The step sets the LR from the
    schedule before each update."""
    return torch.optim.AdamW(params, lr=lr_schedule(0), betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=0.01)


def batch_to_device(batch: Batch, device: torch.device) -> Dict[str, torch.Tensor]:
    """The array fields of a host (numpy) or device batch as tensors on
    ``device``: fp32 images, integer tokens."""
    return {
        "images": torch.as_tensor(batch["images"], dtype=torch.float32).to(device, non_blocking=True),
        "tokens": torch.as_tensor(batch["tokens"]).to(device, non_blocking=True),
    }


class TrainStep:
    """One training step for this experiment's loss_type
    (train.py:109-408, the ``grad_accum_steps == 1`` route):
    encode → l2_normalize → loss → backward → AdamW → metrics."""

    def __init__(self, config: ExperimentConfig, steps_per_epoch: int, total_steps: int,
                 lr_schedule: Callable[[int], float]):
        check_supported(config)
        self.config = config
        self.steps_per_epoch = steps_per_epoch
        self.total_steps = total_steps
        self.lr_schedule = lr_schedule
        self.loss_fn = make_loss_fn(config.loss_type)
        self.learnable_temp = config.anchor_temperature_learnable

    def loss_and_grads(self, state: TrainState, batch: Batch):
        """Forward and backward of the step at ``state.step``; the
        gradients are left in each trainable's ``.grad``.  Returns
        ``(loss, aux, beta, alpha)``."""
        config = self.config
        current_batch = state.step + 1  # the reference counts batches 1-based for β/α
        epoch = state.step // self.steps_per_epoch
        beta = get_beta(current_batch, self.total_steps,
                        config.beta_warmup_epoch, config.beta_decay_epoch)
        alpha = get_alpha(current_batch, self.total_steps,
                          config.alpha_warmup_epoch, config.alpha_increment_epoch)
        fields = batch_to_device(batch, state.temperature.device)
        state.optimizer.zero_grad(set_to_none=True)
        img, txt = state.model(fields["images"], fields["tokens"])
        ctx = LossContext(temperature=state.temperature, beta=beta, alpha=alpha,
                          warm=epoch < config.only_lunif_epochs)
        loss, aux = self.loss_fn(l2_normalize(img), l2_normalize(txt), ctx)
        loss.backward()
        # optax differentiates every trainable: one the loss does not reach
        # (the temperature in the warm phase) gets a zero gradient, and AdamW
        # still decays it and advances its moments and count.
        # torch.optim.AdamW skips a parameter whose .grad is None.
        for group in state.optimizer.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        return loss, aux, beta, alpha

    def __call__(self, state: TrainState, batch: Batch) -> Tuple[TrainState, Metrics]:
        lr = self.lr_schedule(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        loss, aux, beta, alpha = self.loss_and_grads(state, batch)
        state.optimizer.step()
        state.step += 1
        # device scalars stay on the device: reading them is the caller's
        # choice (run_training reads at its log cadence)
        metrics: Metrics = {
            "train_loss": loss.detach(),
            "learning_rate": lr,
            "beta": 0.0 if self.learnable_temp else beta,
            "alpha": 0.0 if self.learnable_temp else alpha,
            "temperature": (state.temperature.detach().clone() if self.learnable_temp
                            else self.config.anchor_temperature),
            **{k: v.detach() for k, v in aux.items()},
        }
        return state, metrics


@dataclasses.dataclass
class TrainSetup:
    """Everything assembled for a run: model, state, step."""

    config: ExperimentConfig
    model: CLIP
    state: TrainState
    train_step: TrainStep
    device: torch.device
    steps_per_epoch: int
    total_steps: int
    lr_schedule: Callable[[int], float]
    # set by run_training: True iff the loop returned early because
    # stop_fn fired
    stopped_early: bool = False


def create_train_setup(
    config: ExperimentConfig,
    steps_per_epoch: int,
    device: Union[str, torch.device] = "cuda",
) -> TrainSetup:
    """Assemble model, state and step on ``device`` (the card unless the
    caller asks for the CPU; without a card the default raises).
    ``config.fused_ln_qkv`` builds the blocks with the fused LN+qkv kernel
    (``ln_fp32: false`` is refused above, so the JAX condition
    ``fused_ln_qkv and ln_fp32`` holds whenever the knob is on).

    ``steps_per_epoch`` comes from the data pipeline (len(train_loader)
    in the reference, sparsify_clip.py:734).  Weights are drawn from
    ``config.seed`` by :func:`create_model`, in fp32, with bf16 compute
    when ``config.fp16``.
    """
    device = torch.device(device)
    if device.type == "cuda" and not config.use_pallas:
        # the JAX flag selects its XLA twins; the port's only twins are the
        # plain versions, which run on CPU tensors alone
        raise NotImplementedError(
            "use_pallas: false on the card: the port runs its kernels on CUDA tensors "
            "and has no second route; set use_pallas: true, or train on the CPU"
        )
    total_steps = steps_per_epoch * config.epochs
    num_warmup = int(0.20 * total_steps)  # sparsify_clip.py:735
    schedule = make_lr_schedule(config.learning_rate, num_warmup, total_steps,
                                config.only_lunif_epochs)
    train_step = TrainStep(config, steps_per_epoch, total_steps, schedule)  # refuses early
    dtype = torch.bfloat16 if config.fp16 else torch.float32
    model = create_model(config.model, dtype=dtype, device=device, seed=config.seed,
                         param_dtype=torch.float32, fused_ln_qkv=config.fused_ln_qkv).train()
    temperature = torch.tensor(config.anchor_temperature, dtype=torch.float32, device=device)
    temperature.requires_grad_(config.anchor_temperature_learnable)
    # the trainables: the model's parameters, then the temperature when
    # it is learnable (train.py:80-86)
    params = list(model.parameters()) + ([temperature] if temperature.requires_grad else [])
    state = TrainState(step=0, model=model, temperature=temperature,
                       optimizer=build_optimizer(params, schedule))
    return TrainSetup(
        config=config,
        model=model,
        state=state,
        train_step=train_step,
        device=device,
        steps_per_epoch=steps_per_epoch,
        total_steps=total_steps,
        lr_schedule=schedule,
    )


class _ThroughputMeter:
    """Windowed pairs/s and step time on the host clock: the JAX package's
    ``ThroughputMeter`` (sparsify_clip_tpu/utils/profiling.py:25-62).

    Call :meth:`start` at the start of an epoch, then :meth:`step` after
    each train step.  The window holds the last ``window`` steps: once more
    have run, the epoch's start, and the first (warm-up) step with it,
    leave it.  ``n_devices`` is the number of devices one step runs on
    (one on the port)."""

    def __init__(self, window: int = 50, n_devices: int = 1):
        self.window = window
        self.n_devices = n_devices
        self._times: Deque[Tuple[float, int]] = deque(maxlen=window + 1)

    def start(self) -> None:
        self._times.clear()
        self._times.append((time.perf_counter(), 0))

    def step(self, batch_size: int) -> None:
        self._times.append((time.perf_counter(), batch_size))

    @property
    def pairs_per_sec(self) -> float:
        if len(self._times) < 2:
            return 0.0
        (t0, _), (t1, _) = self._times[0], self._times[-1]
        pairs = sum(b for _, b in list(self._times)[1:])
        return pairs / max(t1 - t0, 1e-9)

    @property
    def pairs_per_sec_per_chip(self) -> float:
        return self.pairs_per_sec / self.n_devices

    @property
    def step_time_ms(self) -> float:
        if len(self._times) < 2:
            return 0.0
        (t0, _), (t1, _) = self._times[0], self._times[-1]
        return (t1 - t0) / (len(self._times) - 1) * 1000


def run_training(
    setup: TrainSetup,
    train_batches: Callable[[int], Iterator[Batch]],
    eval_fn: Optional[Callable[[TrainState], Dict[str, float]]] = None,
    log_fn: Optional[Callable[[Dict[str, float]], None]] = None,
    checkpoint_fn: Optional[Callable[[TrainState, int], None]] = None,
    stop_fn: Optional[Callable[[], bool]] = None,
) -> TrainState:
    """The epoch loop (train.py:648-797; reference sparsify_clip.py:739-986).

    ``train_batches(epoch)`` yields host batches (dicts of arrays);
    ``eval_fn`` runs before training and after every epoch (and every
    ``eval_every_n_steps``); ``checkpoint_fn(state, epoch)`` fires every
    ``save_checkpoint_every_n_epochs`` and when ``stop_fn`` ends the run
    early; ``log_fn`` gets each step's metrics as floats, read every
    ``log_every_n_steps`` steps.  Evaluation, logging and checkpoints
    themselves are later ports: here they are the caller's callables;
    resuming (the JAX loop's ``start_epoch``/``skip_steps``) comes with
    checkpoints.
    """
    config = setup.config
    state = setup.state
    if eval_fn is not None:
        eval_fn(state)  # pre-training eval (sparsify_clip.py:740)

    def device_batches(epoch: int):
        """One-step lookahead: the next batch's host→device copy is
        queued before the current step runs."""
        pending = None
        for batch in train_batches(epoch):
            nxt = batch_to_device(batch, setup.device)
            if pending is not None:
                yield pending
            pending = nxt
        if pending is not None:
            yield pending

    meter = _ThroughputMeter()
    t0 = time.time()
    stopped = False
    setup.stopped_early = False
    log_every = max(1, config.log_every_n_steps)
    pending_metrics: List[Metrics] = []

    def flush_metrics():
        for m in pending_metrics:
            log_fn({k: float(v) for k, v in m.items()})
        pending_metrics.clear()

    for epoch in range(config.epochs):
        meter.start()
        for batch in device_batches(epoch):
            state, metrics = setup.train_step(state, batch)
            if log_fn is not None:
                pending_metrics.append(metrics)
                if len(pending_metrics) >= log_every:
                    flush_metrics()  # float() reads wait for the step
            meter.step(config.batch_size)
            if stop_fn is not None and stop_fn():
                stopped = True
                break
            if (eval_fn is not None and config.eval_every_n_steps > 0
                    and state.step % config.eval_every_n_steps == 0):
                if log_fn is not None:
                    flush_metrics()  # keep step records ahead of eval's
                eval_fn(state)
        if log_fn is not None:
            flush_metrics()
        if stopped:
            setup.stopped_early = True
            if checkpoint_fn is not None:
                checkpoint_fn(state, epoch + 1)
            print(f"[preemption] stopped at step {state.step} (epoch {epoch + 1} in progress)",
                  flush=True)
            break
        if log_fn is not None:
            log_fn({
                "pairs_per_sec": meter.pairs_per_sec,
                "pairs_per_sec_per_chip": meter.pairs_per_sec_per_chip,
                "step_time_ms": meter.step_time_ms,
            })
        if eval_fn is not None:
            eval_fn(state)
        if (epoch + 1) % config.save_checkpoint_every_n_epochs == 0 and checkpoint_fn is not None:
            checkpoint_fn(state, epoch + 1)
    if setup.device.type == "cuda":
        torch.cuda.synchronize(setup.device)
    if log_fn is not None:
        log_fn({"train_time_s": time.time() - t0})
    setup.state = state
    return state
