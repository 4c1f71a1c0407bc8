"""Training: the train state, one step, and the epoch loop, ported from
:mod:`sparsify_clip_tpu.train` (reference: sparsify_clip.py:682-986).

* Encoders compute in bf16 (``fp16: True``) over fp32 parameters; the
  embeddings and the loss are fp32.  There is no GradScaler: bf16 has
  fp32's exponent range.
* The learnable temperature is the **raw divisor**, an fp32 scalar on
  the device beside the model's parameters, not a logit scale.
* AdamW as the reference configures it: betas (0.9, 0.999), eps 1e-8,
  decoupled weight decay 0.01 on **every** trainable, the temperature
  and SigLIP's two scalars included; the LR comes from
  :func:`schedules.make_lr_schedule`, evaluated at the 0-based optimizer
  count as optax does.  ``adam_mu_dtype: bfloat16`` stores the first
  moment in bf16 (:class:`sparsify_clip_tpu_torch.optim.AdamWBf16Mu`).
* β/α are evaluated at the 1-based batch index (sparsify_clip.py:755).
* ``grad_accum_steps > 1`` is GradCache (:meth:`TrainStep.gradcache`):
  the loss and its embedding gradients over the full batch, the encoders
  over microbatches.
* ``loss_type: "anchor-roberta"`` takes a (B, B) ``soft_targets`` matrix
  with each batch, from the config's ``soft_targets_provider`` over the
  batch's captions (:func:`resolve_soft_targets_provider`).
* ``sparse_projection: topk | l1`` projects both normalised embeddings
  inside the loss once ``epoch >= sparse_after_epoch``
  (:mod:`sparsify_clip_tpu_torch.ops.sparsify`), the epoch taken from
  ``state.step`` as the JAX step does, so resume and ``skip_steps`` keep
  it; on the GradCache path too, where the embeddings' cached gradients
  then include the projection's.
* ``remat``, ``remat_policy``, ``onehot_embed`` and ``ln_fp32`` are the
  model's (:func:`create_train_setup` passes them to ``create_model``).
* ``device_augment`` takes uint8 staging batches and crops, flips and
  normalizes them on the device before the encode, once a step (before
  any GradCache split), drawing from ``TrainState.aug_generator``, a
  generator on the device seeded from ``config.seed`` whose state the
  full checkpoint keeps.  JAX draws its crops from the state's threefry
  key: the same seed gives other crops here.

The JAX step is a pure function of an immutable state.  Here the state
holds the model and the optimizer, which a step updates in place; a
step returns the same state object, so the JAX call shape
``state, metrics = train_step(state, batch)`` carries over.

Parallelism over processes (:mod:`sparsify_clip_tpu_torch.parallel`), on
a (data, model) mesh (``create_train_setup(..., mesh=)``, by default the
process group's ``create_mesh(mesh_data, mesh_model)``):

* over the data axis each rank feeds its rows of the global batch, the
  loss takes the route of :mod:`sparsify_clip_tpu_torch.losses.dispatch`
  (the rings and the gathered terms, the same global loss on every rank),
  a ResNet tower's BatchNorms take global statistics, and the model's
  replicated gradients are summed in one flat all-reduce;
* ``mesh_model > 1`` is tensor parallelism
  (:mod:`sparsify_clip_tpu_torch.parallel.tensor`): the ranks of a model
  group hold the same rows and split the attention and MLP weights;
  with ``pipeline`` (and ``scan_layers``) the model axis is GPipe's
  stages instead (:mod:`sparsify_clip_tpu_torch.parallel.pipeline`): each
  model rank holds its stage's blocks of both trunks, and the head and
  the loss run replicated over the stages;
* ``shard_opt_state`` (ZeRO-1) and ``fsdp`` shard the moments, and under
  FSDP the parameters too, over the data axis
  (:mod:`sparsify_clip_tpu_torch.parallel.sharding`);
* ``allow_accum_gather`` with a GradCache microbatch that the data axis
  does not divide gathers the global batch onto every data rank and
  takes JAX's dp = 1 microbatches (train.py:141-162), with a warning.

One rank runs the single-device step unchanged.  Entry points run on the
card unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
import importlib
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from sparsify_clip_tpu_torch.config import ExperimentConfig
from sparsify_clip_tpu_torch.losses import LossContext, make_loss_fn
from sparsify_clip_tpu_torch.models.clip import CLIP, MODEL_REGISTRY, create_model
from sparsify_clip_tpu_torch.models.resnet import set_data_parallel
from sparsify_clip_tpu_torch.ops.image import augment_batch
from sparsify_clip_tpu_torch.ops.sparsify import make_projection
from sparsify_clip_tpu_torch.optim import AdamWBf16Mu
from sparsify_clip_tpu_torch.parallel.mesh import (
    Mesh, all_gather_rows, all_reduce_gradients, create_mesh,
)
from sparsify_clip_tpu_torch.parallel.sharding import Zero1Optimizer, layout_of, shard_model
from sparsify_clip_tpu_torch.schedules import get_alpha, get_beta, make_lr_schedule
from sparsify_clip_tpu_torch.utils.numerics import l2_normalize
from sparsify_clip_tpu_torch.utils.profiling import ThroughputMeter

Batch = Dict[str, Any]
Metrics = Dict[str, Union[torch.Tensor, float]]

def _accum_gather_message(config: ExperimentConfig, dp: int) -> str:
    mb = config.batch_size // config.grad_accum_steps
    return (f"grad_accum_steps={config.grad_accum_steps} gives microbatch {mb}, not "
            f"divisible by the data-mesh size {dp}: the fallback layout all-gathers "
            "the FULL image batch onto every device, defeating the memory savings. "
            "Pick grad_accum_steps so that (batch_size // grad_accum_steps) % "
            "mesh_data == 0, or set allow_accum_gather: true to accept the gather.")


def gathers_accum_batch(config: ExperimentConfig, dp: int) -> bool:
    """Whether the GradCache step takes the gathered layout: a microbatch
    the data axis does not divide (JAX train.py:141-162)."""
    return (dp > 1 and config.grad_accum_steps > 1
            and (config.batch_size // config.grad_accum_steps) % dp != 0)


def check_pipeline(config: ExperimentConfig, stages: int) -> None:
    """The JAX ``create_train_setup``'s refusals of ``pipeline: true`` over
    ``stages`` model ranks (train.py:467-526), in its order and with its
    messages."""
    if stages < 2:
        raise ValueError(
            "pipeline: true needs mesh_model >= 2 (the 'model' axis "
            "size is the stage count)"
        )
    if not config.scan_layers:
        raise ValueError(
            "pipeline: true requires scan_layers: true (the stacked "
            "(layers, ...) param layout is the stage split)"
        )
    if config.fsdp:
        raise ValueError(
            "pipeline is exclusive with fsdp: the block stacks are "
            "already sharded over 'model' on the layer axis; adding a "
            "data-axis shard would force a reshard inside every "
            "pipeline pass. Use shard_opt_state for moment sharding."
        )
    if config.grad_accum_steps > 1:
        raise ValueError(
            "pipeline is exclusive with grad_accum_steps > 1: the "
            "GradCache passes run the encoders inside lax.scan, which "
            "must stay collective-free. Use pipeline_microbatches "
            "for microbatching instead — the pipeline schedule is "
            "already activation-memory-bounded per (microbatch, stage)."
        )
    if config.remat:
        raise ValueError(
            "pipeline is exclusive with remat: the GPipe schedule "
            "already checkpoints per (microbatch, stage) — a "
            "remat_policy would be silently ignored by the stage "
            "loop. Drop remat: true (pipeline's memory profile is "
            "one microbatch activation per stage)."
        )
    reg_cfg = MODEL_REGISTRY.get(config.model)
    if reg_cfg is None:  # create_model names the unknown model
        return
    if reg_cfg.vision_kind != "vit":
        raise ValueError(
            "pipeline_stages > 1 pipelines transformer block stacks; "
            f"the {reg_cfg.name} vision tower is a ResNet (stage-"
            "heterogeneous blocks) — use TP (mesh_model) or FSDP instead"
        )
    for tower, depth in (
        ("vision", reg_cfg.vision_layers[0]),
        ("text", reg_cfg.text_layers),
    ):
        if depth % stages:
            raise ValueError(
                f"pipeline: {tower} tower depth {depth} not divisible "
                f"by {stages} stages (mesh_model)"
            )


def check_supported(config: ExperimentConfig, world: int = 1,
                    model: Optional[int] = None) -> None:
    """Raise for the first config knob the port's step does not run at
    data-axis size ``world`` and model-axis size ``model`` (default
    ``config.mesh_model``): :class:`ValueError` for what the JAX step
    refuses too (:func:`check_pipeline` among them), :class:`NotImplementedError`
    for a ``soft_targets_provider`` over several ranks; the loss type is
    checked by :func:`make_loss_fn`.  Every registry model trains, ViT and
    ResNet towers alike, under every loss type, GradCache accumulation
    (with ``allow_accum_gather``'s gathered layout), either
    ``adam_mu_dtype``, a ``soft_targets_provider`` (on one rank),
    ``sparse_projection``, ``remat`` under every ``remat_policy``,
    ``onehot_embed`` and either ``ln_fp32``, over any (data, model) mesh,
    with ``shard_opt_state`` (ZeRO-1) or ``fsdp``, or with ``pipeline``
    (GPipe on the model axis, with ZeRO-1); ``multihost`` joins the process
    group (:mod:`sparsify_clip_tpu_torch.parallel.multihost`), and
    ``stem_s2d`` is accepted as the TPU layout hint it is (see
    :func:`create_train_setup`)."""
    if config.pipeline:
        check_pipeline(config, config.mesh_model if model is None else model)
    if world > 1 and config.soft_targets_provider:
        # the provider reads the captions of the whole batch on one host
        raise NotImplementedError(
            "soft_targets_provider runs on a single host: each rank holds only its rows' "
            f"captions, so it is refused over {world} ranks")
    if gathers_accum_batch(config, world) and not config.allow_accum_gather:
        # JAX train.py:141-156; the dp = 1 layout gathers every image onto
        # every rank
        raise ValueError(_accum_gather_message(config, world))


@dataclasses.dataclass
class TrainState:
    step: int                           # 0-based optimizer step count
    model: CLIP                         # fp32 parameters
    temperature: torch.Tensor           # raw fp32 scalar on the device
    optimizer: Any                      # AdamW over the trainables (ZeRO-1's wrapper)
    # loss_type "siglip": {"logit_scale": log-space scale, "logit_bias"},
    # fp32 device scalars that AdamW trains beside the model; else None
    loss_scalars: Optional[Dict[str, torch.Tensor]] = None
    # device_augment: the crops' and flips' generator, on the device; else None
    aug_generator: Optional[torch.Generator] = None


def trainables(state: TrainState) -> List[torch.Tensor]:
    """What AdamW trains, in the optimizer's order: the model's parameters
    (this rank's pieces under FSDP), the temperature when it is learnable,
    SigLIP's scalars (train.py:80-86)."""
    params = list(state.model.parameters())
    params += [state.temperature] if state.temperature.requires_grad else []
    return params + list((state.loss_scalars or {}).values())


def build_optimizer(params, lr_schedule: Callable[[int], float],
                    adam_mu_dtype: str = "float32") -> torch.optim.Optimizer:
    """AdamW exactly as the reference configures it: betas (0.9, 0.999),
    eps 1e-8, decoupled wd 0.01 applied to ALL parameters (torch AdamW
    default; sparsify_clip.py:730).  ``adam_mu_dtype: bfloat16`` keeps the
    first moment in bf16 as optax's ``mu_dtype`` does (:class:`AdamWBf16Mu`).
    The step sets the LR from the schedule before each update."""
    if adam_mu_dtype == "bfloat16":
        return AdamWBf16Mu(params, lr=lr_schedule(0), betas=(0.9, 0.999), eps=1e-8,
                           weight_decay=0.01)
    return torch.optim.AdamW(params, lr=lr_schedule(0), betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=0.01)


def _to_device(x: Any, device: torch.device) -> torch.Tensor:
    t = torch.as_tensor(x)
    if device.type == "cuda" and t.device.type == "cpu":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def batch_to_device(batch: Batch, device: torch.device) -> Dict[str, torch.Tensor]:
    """The array fields of a host (numpy) or device batch as tensors on
    ``device`` (over several ranks, the rank's slice of the global batch):
    fp32 images (uint8 staging images stay uint8), integer tokens and,
    where the batch has them, the fp32 (B, B) ``soft_targets``.  Host
    arrays bound for the card go through pinned memory, so the copy is
    asynchronous."""
    images = torch.as_tensor(batch["images"])
    fields = {
        "images": _to_device(images if images.dtype == torch.uint8 else images.float(), device),
        "tokens": _to_device(batch["tokens"], device),
    }
    if batch.get("soft_targets") is not None:
        fields["soft_targets"] = _to_device(
            torch.as_tensor(batch["soft_targets"], dtype=torch.float32), device)
    return fields


class TrainStep:
    """One training step for this experiment's loss_type
    (train.py:109-408): encode → l2_normalize → loss → backward → AdamW →
    metrics, the encoders over ``grad_accum_steps`` microbatches when it
    is over 1 (:meth:`gradcache`).  Over a ``mesh`` of W > 1 data ranks a
    batch is the rank's rows of the global batch, and the model's
    replicated gradients are summed over the data ranks before AdamW; in
    the gathered GradCache layout (:func:`gathers_accum_batch`) every data
    rank gathers the global batch and runs the one-rank step, whose
    gradients are already whole."""

    def __init__(self, config: ExperimentConfig, steps_per_epoch: int, total_steps: int,
                 lr_schedule: Callable[[int], float], image_size: Optional[int] = None,
                 mesh: Optional[Mesh] = None):
        self.mesh = mesh if mesh is not None else Mesh()
        check_supported(config, self.mesh.data, self.mesh.model)
        self.gathered = gathers_accum_batch(config, self.mesh.data)
        if self.gathered:
            import warnings

            warnings.warn(_accum_gather_message(config, self.mesh.data), stacklevel=2)
        # the mesh the loss and the encoders see: the data ranks of the
        # gathered layout all hold the same rows
        self.step_mesh = self.mesh.without_data() if self.gathered else self.mesh
        self.config = config
        # the encoder's input size, which device_augment crops to
        self.image_size = image_size or MODEL_REGISTRY[config.model].image_size
        self.steps_per_epoch = steps_per_epoch
        self.total_steps = total_steps
        self.lr_schedule = lr_schedule
        self.loss_fn = make_loss_fn(config.loss_type)
        self.projection = make_projection(config.sparse_projection, config.sparse_topk,
                                          config.sparse_l1)
        self.learnable_temp = config.anchor_temperature_learnable

    def embedding_loss(self, img: torch.Tensor, txt: torch.Tensor, ctx: LossContext,
                       epoch: int):
        """The loss over the normalised embeddings (JAX
        ``loss_from_embeddings``, train.py:198-226): the sparse projection
        of both, once ``epoch >= sparse_after_epoch``, then the loss."""
        if self.projection is not None and epoch >= self.config.sparse_after_epoch:
            img, txt = self.projection(img), self.projection(txt)
        return self.loss_fn(img, txt, ctx)

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
        images, tokens = fields["images"], fields["tokens"]
        if self.gathered:  # every data rank takes the whole global batch
            images = all_gather_rows(images, self.mesh)
            tokens = all_gather_rows(tokens, self.mesh)
        mesh = self.step_mesh
        if config.device_augment:
            # every rank draws the whole global batch's crops and keeps its rows
            images = augment_batch(images, state.aug_generator, self.image_size,
                                   shard=(mesh.data_rank, mesh.data))
        state.optimizer.zero_grad(set_to_none=True)
        scalars = {}
        if state.loss_scalars is not None:
            # the scale is learned in log space: the loss sees exp of it
            scalars = {"logit_scale": torch.exp(state.loss_scalars["logit_scale"]),
                       "logit_bias": state.loss_scalars["logit_bias"]}
        ctx = LossContext(temperature=state.temperature, beta=beta, alpha=alpha,
                          warm=epoch < config.only_lunif_epochs,
                          soft_targets=fields.get("soft_targets"), mesh=mesh, **scalars)
        if config.grad_accum_steps > 1:
            loss, aux = self.gradcache(state.model, images, tokens, ctx, epoch)
        else:
            img, txt = state.model(images, tokens)
            loss, aux = self.embedding_loss(l2_normalize(img), l2_normalize(txt), ctx, epoch)
            loss.backward()
        # optax differentiates every trainable: one the loss does not reach
        # (the temperature in the warm phase) gets a zero gradient, and AdamW
        # still decays it and advances its moments and count.
        # torch.optim.AdamW skips a parameter whose .grad is None.
        for p in trainables(state):
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        # each data rank's encoders saw its rows: its model gradients are
        # its share (FSDP's shards were reduce-scattered in the backward).
        # The temperature's and the loss scalars' are already whole, and so
        # is everything in the gathered layout.
        if not self.gathered:
            layout = layout_of(state.model)
            all_reduce_gradients(state.model.parameters() if layout is None
                                 else layout.reduced_params(state.model), self.mesh)
        return loss, aux, beta, alpha

    def gradcache(self, model: CLIP, images: torch.Tensor, tokens: torch.Tensor,
                  ctx: LossContext, epoch: int):
        """GradCache accumulation (JAX ``gradcache_value_and_grad``,
        train.py:246-349), where microbatch ``i`` is the contiguous slice
        ``[i·mb, (i+1)·mb)`` of this rank's rows: over W ranks global
        microbatch ``i`` is every rank's ``i``-th chunk, the JAX
        shard-aligned layout (train.py:262-264), and a BatchNorm's
        statistics are that global microbatch's:

        1. encode every microbatch without autograd and l2-normalise it;
        2. the loss over the full batch of those embeddings, as leaves
           (:meth:`embedding_loss`, so the sparse projection's gradient
           is in the leaves' gradients once it is on):
           exactly the large-batch loss (the B×B loss couples every pair),
           whose backward leaves the embeddings' gradients on the leaves and
           the temperature's and the loss scalars' in their ``.grad``;
        3. re-encode each microbatch with autograd and back-propagate its
           slice of the embeddings' gradients: the parameters' fp32
           ``.grad`` sum the microbatches in order, as JAX's scan does
           from zero.

        Peak activation memory is one microbatch's; the cost is one extra
        encoder forward.  A BatchNorm tower normalizes by each
        microbatch's statistics in both passes; its running statistics
        move once a microbatch in pass 1 alone (JAX threads ``batch_stats``
        through pass 1 and drops pass 2's), so pass 2's in-place updates
        are undone."""
        a = self.config.grad_accum_steps
        b = images.shape[0]
        data = self.step_mesh.data
        if (b * data) % a or b % a:
            raise ValueError(f"global batch {b * data} not divisible by "
                             f"grad_accum_steps {a}")
        micro = [slice(i * b // a, (i + 1) * b // a) for i in range(a)]
        with torch.no_grad():
            encoded = [model(images[s], tokens[s]) for s in micro]
            img = torch.cat([l2_normalize(i) for i, _ in encoded]).requires_grad_(True)
            txt = torch.cat([l2_normalize(t) for _, t in encoded]).requires_grad_(True)
        del encoded
        loss, aux = self.embedding_loss(img, txt, ctx, epoch)
        loss.backward()
        d_img = img.grad if img.grad is not None else torch.zeros_like(img)
        d_txt = txt.grad if txt.grad is not None else torch.zeros_like(txt)
        running = [(buf, buf.clone()) for buf in model.buffers()]
        for s in micro:
            img_s, txt_s = model(images[s], tokens[s])
            torch.autograd.backward((l2_normalize(img_s), l2_normalize(txt_s)),
                                    (d_img[s], d_txt[s]))
        with torch.no_grad():
            for buf, kept in running:
                buf.copy_(kept)
        return loss.detach(), {k: v.detach() for k, v in aux.items()}

    def __call__(self, state: TrainState, batch: Batch) -> Tuple[TrainState, Metrics]:
        lr = self.lr_schedule(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        loss, aux, beta, alpha = self.loss_and_grads(state, batch)
        if self.config.debug_nans:
            check_finite(state, loss)
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
        if state.loss_scalars is not None:
            metrics["siglip_scale"] = torch.exp(state.loss_scalars["logit_scale"].detach())
            metrics["siglip_bias"] = state.loss_scalars["logit_bias"].detach().clone()
        return state, metrics


def check_finite(state: TrainState, loss: torch.Tensor) -> None:
    """``debug_nans``: raise :class:`FloatingPointError` on a non-finite
    loss or gradient, before the optimizer applies it (the JAX package
    sets ``jax_debug_nans``).  Reads the device, so it costs a sync a step."""
    if not torch.isfinite(loss).item():
        raise FloatingPointError(f"non-finite loss {loss.item()} at step {state.step}")
    named = list(state.model.named_parameters()) + [("temperature", state.temperature)]
    named += list((state.loss_scalars or {}).items())
    for name, p in named:
        if p.grad is not None and not torch.isfinite(p.grad).all().item():
            raise FloatingPointError(f"non-finite gradient of {name} at step {state.step}")


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
    image_size: Optional[int] = None,
    mesh: Optional[Mesh] = None,
) -> TrainSetup:
    """Assemble model, state and step on ``device`` (the card unless the
    caller asks for the CPU; without a card the default raises).
    The model takes the config's ``fused_ln_qkv``, ``ln_fp32``, ``remat``,
    ``remat_policy`` and ``onehot_embed`` (JAX train.py:527-529); the
    blocks run the fused LN+qkv kernel under the JAX condition
    ``fused_ln_qkv and ln_fp32``.
    ``config.stem_s2d`` selects nothing here: on the JAX side it runs a
    ResNet stem's first conv over the space-to-depth input, the same
    function over the same parameters laid out for the TPU's matrix unit;
    the port's stem is that function as cuDNN's one 3×3 stride-2 conv.

    The model is in train mode, so a ResNet tower's BatchNorms normalize by
    the batch statistics and each train step moves their running
    statistics once, in its one forward (the JAX step's
    ``mutable=["batch_stats"]`` apply, train.py:186-195).

    ``mesh`` is the (data, model) mesh (default: ``create_mesh(
    config.mesh_data, config.mesh_model)`` over the process group, one rank
    without one); every rank builds the same full weights from
    ``config.seed`` and keeps its pieces (:func:`~sparsify_clip_tpu_torch.
    parallel.sharding.shard_model`: tensor parallelism's slices, FSDP's
    shards), so the mesh does not change the initial values.  ZeRO-1 steps
    a :class:`~sparsify_clip_tpu_torch.parallel.sharding.Zero1Optimizer`.
    With ``pipeline`` (refused as the JAX step refuses it,
    :func:`check_pipeline`) the model is built as this model rank's stage
    of each trunk (``create_model``'s ``pipeline_stages``, the mesh's model
    axis) from the whole model's weights, and no tensor parallelism
    applies: the model axis has one meaning.

    ``steps_per_epoch`` comes from the data pipeline (len(train_loader)
    in the reference, sparsify_clip.py:734).  Weights are drawn from
    ``config.seed`` by :func:`create_model`, in fp32, with bf16 compute
    when ``config.fp16``; ``image_size`` overrides the model's input
    resolution.
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
    if mesh is None:
        mesh = create_mesh(data=config.mesh_data, model=config.mesh_model)
    train_step = TrainStep(config, steps_per_epoch, total_steps, schedule,
                           image_size, mesh)  # refuses early
    dtype = torch.bfloat16 if config.fp16 else torch.float32
    stages = mesh.model if config.pipeline else 1
    model = create_model(config.model, dtype=dtype, device=device, seed=config.seed,
                         param_dtype=torch.float32, fused_ln_qkv=config.fused_ln_qkv,
                         image_size=image_size, remat=config.remat,
                         remat_policy=config.remat_policy, ln_fp32=config.ln_fp32,
                         onehot_embed=config.onehot_embed, scan_layers=config.scan_layers,
                         pipeline_stages=stages,
                         pipeline_microbatches=config.pipeline_microbatches,
                         mesh=mesh if config.pipeline else None).train()
    layout = shard_model(model, mesh, fsdp=config.fsdp, zero1=config.shard_opt_state,
                         pipeline=config.pipeline)
    if layout is not None:
        layout.reduce_grads = not train_step.gathered
    set_data_parallel(model, train_step.step_mesh)
    temperature = torch.tensor(config.anchor_temperature, dtype=torch.float32, device=device)
    temperature.requires_grad_(config.anchor_temperature_learnable)
    loss_scalars = None
    if config.loss_type == "siglip":
        # SigLIP's learnables (losses/sigmoid.py): the scale in log space,
        # so exp keeps it positive under unconstrained AdamW, and the bias
        loss_scalars = {
            "logit_scale": torch.log(torch.tensor(config.siglip_logit_scale_init,
                                                  dtype=torch.float32, device=device)),
            "logit_bias": torch.tensor(config.siglip_logit_bias_init, dtype=torch.float32,
                                       device=device),
        }
        for scalar in loss_scalars.values():
            scalar.requires_grad_(True)
    aug_generator = None
    if config.device_augment:
        aug_generator = torch.Generator(device=device)
        aug_generator.manual_seed(config.seed)
    state = TrainState(step=0, model=model, temperature=temperature, optimizer=None,
                       loss_scalars=loss_scalars, aug_generator=aug_generator)
    params = trainables(state)
    if layout is not None and layout.zero1:
        extra = len(params) - len(list(model.parameters()))
        state.optimizer = Zero1Optimizer(
            params, layout.moment_dims(model) + [None] * extra, mesh,
            lambda blocks: build_optimizer(blocks, schedule, config.adam_mu_dtype))
    else:
        state.optimizer = build_optimizer(params, schedule, config.adam_mu_dtype)
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


def resolve_soft_targets_provider(spec: str) -> Optional[Callable[[List[str]], Any]]:
    """``"module:attr"`` / ``"module.attr"`` → the host soft-target
    callable (JAX ``resolve_soft_targets_provider``, train.py:595-626).

    The ``anchor-roberta`` loss (sparsify_clip.py:135-157) needs a (B, B)
    row-stochastic text-similarity matrix that the reference computes on
    the host from a RoBERTa sentence encoder (:711-713).  The provider is
    user code, any callable from the batch's caption strings to that
    matrix; this resolves the config's import spec once a run.  Returns
    None for the empty spec."""
    if not spec:
        return None
    if ":" in spec:
        mod_name, attr_path = spec.split(":", 1)
    else:
        mod_name, _, attr_path = spec.rpartition(".")
    if not mod_name or not attr_path:
        raise ValueError(
            f"soft_targets_provider {spec!r} is not an import spec — "
            "use 'package.module:callable'"
        )
    fn = importlib.import_module(mod_name)
    for part in attr_path.split("."):
        fn = getattr(fn, part)
    if not callable(fn):
        raise TypeError(
            f"soft_targets_provider {spec!r} resolved to non-callable {fn!r}"
        )
    return fn


def apply_soft_targets(batch: Batch, soft_fn: Optional[Callable[[List[str]], Any]]) -> Batch:
    """The host batch with its fp32 (B, B) ``soft_targets`` from the
    provider over its ``captions`` (JAX ``_apply_soft_targets``,
    train.py:628-645); the batch itself without a provider."""
    if soft_fn is None:
        return batch
    captions = batch.get("captions")
    if captions is None:
        raise ValueError(
            "soft_targets_provider is configured but the loader batch "
            "carries no 'captions' — use a caption-bearing dataset/loader"
        )
    st = np.asarray(soft_fn(captions), dtype=np.float32)
    b = len(captions)
    if st.shape != (b, b):
        raise ValueError(
            f"soft_targets_provider returned shape {st.shape}, "
            f"expected ({b}, {b}) for this batch"
        )
    return {**batch, "soft_targets": st}


def run_training(
    setup: TrainSetup,
    train_batches: Callable[[int], Iterator[Batch]],
    eval_fn: Optional[Callable[[TrainState], Dict[str, float]]] = None,
    log_fn: Optional[Callable[[Dict[str, float]], None]] = None,
    checkpoint_fn: Optional[Callable[[TrainState, int], None]] = None,
    start_epoch: int = 0,
    stop_fn: Optional[Callable[[], bool]] = None,
    skip_steps: int = 0,
    end_epoch: Optional[int] = None,
) -> TrainState:
    """The epoch loop (train.py:648-797; reference sparsify_clip.py:739-986).

    ``train_batches(epoch)`` yields host batches (dicts of arrays, with
    ``captions`` where a ``soft_targets_provider`` reads them);
    ``eval_fn`` runs before training and after every epoch (and every
    ``eval_every_n_steps``); ``checkpoint_fn(state, epoch)`` fires every
    ``save_checkpoint_every_n_epochs``; ``log_fn`` gets each step's
    metrics as floats, read every ``log_every_n_steps`` steps.

    ``stop_fn`` is polled after every step (graceful preemption, see
    :mod:`sparsify_clip_tpu_torch.utils.preemption`): when it turns true
    the loop writes a full checkpoint through ``checkpoint_fn`` (tagged
    with the interrupted epoch's 1-based index) and returns early.

    ``skip_steps`` consumes that many batches of the first epoch on the
    host without training them: with the loaders' per-(seed, epoch)
    streams the restarted run sees exactly the batches the stopped one
    never trained.  ``end_epoch`` (exclusive) overrides the default
    ``start_epoch + config.epochs``; a full-state resume passes
    ``config.epochs`` so the run completes the original schedule, whose
    position comes from the restored step.
    """
    config = setup.config
    state = setup.state
    if eval_fn is not None:
        eval_fn(state)  # pre-training eval (sparsify_clip.py:740)

    soft_fn = resolve_soft_targets_provider(config.soft_targets_provider)

    def device_batches(epoch: int, skip: int = 0):
        """One-step lookahead: the next batch's host→device copy is
        queued before the current step runs.  ``skip`` drops leading
        batches on the host, before any copy.  A configured soft-target
        provider runs on the host batch's captions, and its matrix goes
        with the batch."""
        pending = None
        it = iter(train_batches(epoch))
        for _ in range(skip):
            if next(it, None) is None:
                break
        for batch in it:
            nxt = batch_to_device(apply_soft_targets(batch, soft_fn), setup.device)
            if pending is not None:
                yield pending
            pending = nxt
        if pending is not None:
            yield pending

    meter = ThroughputMeter(n_chips=setup.train_step.mesh.world)  # one device a rank
    t0 = time.time()
    stopped = False
    setup.stopped_early = False
    log_every = max(1, config.log_every_n_steps)
    pending_metrics: List[Metrics] = []

    def flush_metrics():
        for m in pending_metrics:
            log_fn({k: float(v) for k, v in m.items()})
        pending_metrics.clear()

    last_epoch = (start_epoch + config.epochs) if end_epoch is None else end_epoch
    for epoch in range(start_epoch, last_epoch):
        meter.start()
        for batch in device_batches(epoch, skip_steps if epoch == start_epoch else 0):
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
