"""Experiment runner CLI, ported from :mod:`sparsify_clip_tpu.cli`.

    python3 -m sparsify_clip_tpu_torch.cli --config <file-or-dir> [--device N] [--smoke]
    torchrun --standalone --nproc_per_node=N -m sparsify_clip_tpu_torch.cli --config <file>

File mode runs one experiment; directory mode sweeps every ``*.yaml``
in name order (skipping empty ones).  ``--device N`` trains on
``cuda:N``; the run needs a card, except through ``main(config,
device="cpu")``.

Each run: data → pre-training eval → epochs (train, eval, weights npz
and full-state checkpoint every ``save_checkpoint_every_n_epochs``) →
final eval → final weights npz, logged to ``<log_dir>/<run_name>.jsonl``
with the JAX CLI's records; with ``plot_embeddings`` (the default) each
eval pass also writes the reference's UMAP / t-SNE / PCA sphere plots to
``<log_dir>/plots/`` on the host (:mod:`sparsify_clip_tpu_torch.viz`) and
logs them as image records.  The first record (``run_start``) also
names the data routes each loader took (``data_routes``: loader,
tokenizer, image backend) and the attention route of each tower in the
train and the eval compute types (``attention_routes``).
``resume_checkpoint`` resumes weights only
from an ``.npz`` (the reference's semantics) or the full state from
``"auto"`` (``<checkpoint_dir>/<run_name>/``) or a directory, data order
exact.  SIGTERM (``handle_preemption``) finishes the step, saves the
full state and exits 0.

Under ``torchrun`` (or ``multihost: true`` with its rendezvous keys) the
run joins the process group first thing (NCCL on the card, gloo on the
CPU) and trains data-parallel, one rank a GPU
(:mod:`sparsify_clip_tpu_torch.parallel`): ``batch_size`` is the global
batch, each rank loads and encodes its slice, and only the primary
writes the JSONL, the plots and the files.  ``run_start`` also names the
world size, the backend and the loss route taken (``parallel``).  A
SIGTERM to one rank stops every rank at the same step.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import os
import random
import time
from typing import Dict, Optional, Union

import numpy as np

from sparsify_clip_tpu_torch.config import ExperimentConfig, load_config, load_config_dir


def set_seed(seed: int) -> None:
    """Host-side RNG seeding (reference: sparsify_clip.py:1071-1078; the
    weights are drawn from an explicit generator seeded by the config)."""
    random.seed(seed)
    np.random.seed(seed)


def apply_smoke_overrides(config: ExperimentConfig) -> ExperimentConfig:
    """Shrink any experiment config into a minutes-scale end-to-end run:
    synthetic data, 1 epoch, small sample counts.  The loss stack,
    schedules, model and metric paths are untouched."""
    return dataclasses.replace(
        config,
        dataset="synthetic",
        num_train_samples=2 * config.batch_size,
        num_test_samples=config.batch_size,
        epochs=1,
        run_name=f"{config.run_name}-smoke",
        plot_embeddings=False,
        resume_checkpoint=False,  # hermetic: never read external state
    )


def _check_supported(config: ExperimentConfig, world: int = 1,
                     model: Optional[int] = None) -> None:
    """Refuse what this port does not run before any file is written."""
    from sparsify_clip_tpu_torch.train import check_supported as check_step

    if config.plot_embeddings and importlib.util.find_spec("matplotlib") is None:
        raise NotImplementedError(
            "plot_embeddings: true draws the per-eval plots with matplotlib, which is not "
            "installed; set plot_embeddings: false or run --smoke"
        )
    check_step(config, world, model)


def _attention_routes(config: ExperimentConfig, image_size: int) -> Dict[str, Dict[str, str]]:
    """The attention route each tower's blocks take in the train step's
    compute type and in the eval twin's (``ops.attention.use_head_group``
    at a rank's heads: tensor parallelism splits them, a pipeline does
    not): ``"whole-width"``, ``"head-group"``, or ``"none"`` for a ResNet
    tower, whose attention pool is plain PyTorch."""
    from sparsify_clip_tpu_torch.models.clip import MODEL_REGISTRY
    from sparsify_clip_tpu_torch.ops.attention import use_head_group

    cfg = MODEL_REGISTRY[config.model]
    tp = 1 if config.pipeline else max(1, config.mesh_model)
    towers = {"text": (cfg.context_length, cfg.text_width, cfg.text_heads)}
    if cfg.vision_kind == "vit":
        tokens = (image_size // cfg.patch_size) ** 2 + 1
        towers["vision"] = (tokens, cfg.vision_width, cfg.vision_heads)
    train_size = 2 if config.fp16 else 4
    sizes = {"train": train_size, "eval": 4 if config.eval_fp32 else train_size}
    routes = {}
    for phase, size in sizes.items():
        routes[phase] = {"vision": "none"} if cfg.vision_kind != "vit" else {}
        for tower, (l, w, heads) in towers.items():
            grouped = use_head_group(l, 3 * w // tp, size, heads // tp)
            routes[phase][tower] = "head-group" if grouped else "whole-width"
    return routes


def main(config: ExperimentConfig, image_size: Optional[int] = None,
         device: Union[str, "torch.device", None] = None) -> Dict[str, float]:
    """Full experiment: data → train w/ per-epoch eval → final eval/save
    (reference: main(), sparsify_clip.py:1084-1121).  ``device`` defaults
    to ``cuda:<config.device_id>``, or the rank's card under a launcher;
    the CPU runs only when asked for (and joins a process group over
    gloo)."""
    import torch

    from sparsify_clip_tpu_torch import checkpoints
    from sparsify_clip_tpu_torch.data import dataset_loader
    from sparsify_clip_tpu_torch.data.pipeline import routes
    from sparsify_clip_tpu_torch.eval import evaluate_model, make_eval_model
    from sparsify_clip_tpu_torch.logging import NullLogger, RunLogger
    from sparsify_clip_tpu_torch.losses.dispatch import loss_route
    from sparsify_clip_tpu_torch.models.clip import MODEL_REGISTRY
    from sparsify_clip_tpu_torch.parallel.mesh import create_mesh
    from sparsify_clip_tpu_torch.parallel.sharding import layout_of
    from sparsify_clip_tpu_torch.parallel.multihost import (
        any_process_flag, initialize_distributed, is_primary,
    )
    from sparsify_clip_tpu_torch.train import create_train_setup, run_training
    from sparsify_clip_tpu_torch.utils.preemption import GracefulShutdown
    from sparsify_clip_tpu_torch.viz import plot_all_methods

    # first thing: join the process group (a no-op at world 1 without a
    # launcher); every rank runs this function, and host side effects
    # (logs, plots, files, prints) belong to the primary
    cpu = device is not None and torch.device(device).type == "cpu"
    rank_device = initialize_distributed(config, backend="gloo" if cpu else None)
    if device is None:
        device = rank_device if rank_device is not None else f"cuda:{config.device_id}"
    device = torch.device(device)
    primary = is_primary()
    say = print if primary else (lambda *a, **k: None)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the CLI trains on the card and no CUDA device is available; "
                               "call main(config, device='cpu') to run on the CPU")
        torch.cuda.set_device(device)
    mesh = create_mesh(data=config.mesh_data, model=config.mesh_model)
    _check_supported(config, mesh.data, mesh.model)
    # compilation_cache_dir is accepted and ignored: PyTorch compiles no
    # programs per run (ROADMAP Queue 1, 'Do not port')

    set_seed(config.seed)
    say("Config:", config.to_dict())
    say("Experiment:", config.run_name)

    if image_size is None:
        image_size = MODEL_REGISTRY[config.model].image_size

    say("\nLoading the dataset...")
    train_loader, test_loader = dataset_loader(config, image_size=image_size)
    # the routes each loader took (a native library that did not build
    # falls back as on the JAX side), in the run's first record
    data_routes = {"train": routes(train_loader), "eval": routes(test_loader)}
    say("Dataset loaded.", "Routes:", data_routes, "\n")

    parallel = {"world_size": mesh.world, "backend": mesh.backend,
                "loss_route": loss_route(mesh)}
    say("Parallel:", parallel)
    logger = RunLogger(
        project=config.project_name,
        run_name=config.run_name,
        config=config.to_dict(),
        log_dir=config.log_dir,
        backend=config.log_backend,
        start={"data_routes": data_routes, "parallel": parallel,
               "attention_routes": _attention_routes(config, image_size)},
    ) if primary else NullLogger()

    setup = create_train_setup(config, steps_per_epoch=len(train_loader), device=device,
                               image_size=image_size, mesh=mesh)

    start_epoch = 0
    resume_skip = 0  # mid-epoch batches to skip on exact resume
    resume_end = None  # epoch bound override (a full resume completes the run)
    if config.resume_requested:
        resume_path = str(config.resume_checkpoint)
        if resume_path == "auto" or os.path.isdir(resume_path):
            # exact resume: model, AdamW moments, schedule position and
            # temperature, then the batches the stopped run never trained
            target = (os.path.join(config.checkpoint_dir, config.run_name)
                      if resume_path == "auto" else resume_path)
            checkpoints.restore_full(target, setup.state)
            step = setup.state.step
            start_epoch = step // len(train_loader)
            resume_skip = step % len(train_loader)
            resume_end = config.epochs
            say(f"Resumed full state from {target} at step {step} (epoch {start_epoch}, "
                  f"skipping {resume_skip} already-trained batches)")
        else:
            # weights-only resume, the reference's semantics
            # (sparsify_clip.py:719-724): optimizer, schedule and temperature
            # restart from scratch
            say(f"Resuming weights from {resume_path} at epoch {config.resume_epoch}")
            checkpoints.load_weights(setup.model, resume_path)
            start_epoch = config.resume_epoch

    eval_batches = list(test_loader.epoch(0))
    last_eval: Dict[str, float] = {}
    eval_pass = 0
    # the fp32 twin over the training parameters (the reference evaluates
    # with no autocast, sparsify_clip.py:563-593)
    # (a model laid out over the mesh gives a twin of full copies: one a
    # pass; a pipelined one, a twin of its stage over the same tensors)
    layout = layout_of(setup.model)
    eval_model = (make_eval_model(setup.model, config.eval_fp32)
                  if layout is None or layout.pipeline else None)

    def eval_fn(state):
        nonlocal last_eval, eval_pass
        if config.eval_redraw_captions and eval_pass > 0:
            # every eval pass re-draws the 1-of-5 caption
            # (sparsify_clip.py:1050-1057 via :564)
            batches = list(test_loader.epoch(eval_pass))
        else:
            batches = eval_batches
        this_pass = eval_pass
        eval_pass += 1
        plot_fn = None
        if config.plot_embeddings and primary:
            def plot_fn(txt, img):
                # the pass counter in the tag: two eval passes inside one
                # wall-clock second must not overwrite each other
                plot_all_methods(txt, img, out_dir=os.path.join(config.log_dir, "plots"),
                                 tag=f"{this_pass:04d}_{time.time():.0f}", logger=logger)
        twin = eval_model or make_eval_model(state.model, config.eval_fp32)
        metrics = evaluate_model(twin, batches, plot_embeddings=config.plot_embeddings,
                                 plot_fn=plot_fn, mesh=mesh)
        say("Evaluation Results:", metrics, "\n")
        logger.log(metrics)
        last_eval = metrics
        return metrics

    def log_fn(metrics):
        if "train_loss" in metrics:
            logger.log_train_step(metrics, config.anchor_temperature_learnable,
                                  include_components=config.log_loss_components)
        else:
            logger.log(metrics)

    def checkpoint_fn(state, epoch):
        # the primary writes, every rank waits for it (checkpoints.py)
        checkpoints.save_weights(
            state.model,
            os.path.join(config.checkpoint_dir, f"{config.run_name}_epoch_{epoch}.npz"))
        full_dir = os.path.join(config.checkpoint_dir, config.run_name)
        if config.async_checkpoint:
            checkpoints.save_full_async(state, full_dir, config)
        else:
            checkpoints.save_full(state, full_dir, config)
        say(f"Model saved at epoch {epoch}")

    def train(stop_fn=None):
        return run_training(
            setup,
            train_batches=lambda epoch: train_loader.epoch(epoch),
            eval_fn=eval_fn,
            log_fn=log_fn,
            checkpoint_fn=checkpoint_fn,
            start_epoch=start_epoch,
            stop_fn=stop_fn,
            skip_steps=resume_skip,
            end_epoch=resume_end,
        )

    say("Training the model...")
    if config.handle_preemption:
        with GracefulShutdown() as shutdown:
            # over several ranks the stop is collective: one rank's SIGTERM
            # stops every rank after the same step
            state = train(shutdown.requested_fn if mesh.world == 1
                          else lambda: any_process_flag(shutdown.requested))
        if setup.stopped_early:
            # the full-state save is written by run_training; make it
            # durable, skip the final eval and leave a resumable run
            checkpoints.wait_for_async_saves()
            logger.log({"preempted": 1.0})
            logger.finish()
            say("Preempted: training state checkpointed under "
                  f"{os.path.join(config.checkpoint_dir, config.run_name)}; "
                  'restart with resume_checkpoint: "auto" to continue.')
            return last_eval
    else:
        state = train()
    say("Training complete.\n")

    say("Final evaluation of the model...")
    final_log = eval_fn(state)
    say("Evaluation complete.\n")

    checkpoints.wait_for_async_saves()  # in-flight saves commit before the run ends
    final_path = checkpoints.save_weights(
        state.model, os.path.join(config.checkpoint_dir, f"{config.run_name}.npz"))
    logger.save_artifact(final_path)  # the reference's wandb.save (:1119)
    logger.finish()
    return final_log


def cli(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Run a sparsify-clip experiment from a yaml config"
    )
    parser.add_argument(
        "--config", type=str, required=True,
        help="Path to a yaml config file or a folder of config files",
    )
    parser.add_argument(
        "--device", type=int, default=0,
        help="CUDA device index (reference: GPU id)",
    )
    parser.add_argument(
        "--image-size", type=int, default=None,
        help="Override image resolution (e.g. tiny smoke runs)",
    )
    parser.add_argument(
        "--smoke", action="store_true",
        help="Run the config end-to-end on synthetic data for 1 epoch "
             "(validates an experiment's full wiring in minutes)",
    )
    args = parser.parse_args(argv)

    def run(config):
        if args.smoke:
            config = apply_smoke_overrides(config)
        main(config, image_size=args.image_size)

    from sparsify_clip_tpu_torch.parallel.multihost import shutdown_distributed

    try:
        if os.path.isfile(args.config):
            run(load_config(args.config, args.device))
        elif os.path.isdir(args.config):
            for config in load_config_dir(args.config, args.device):
                run(config)
        else:
            parser.error(f"--config path not found: {args.config}")
    finally:
        shutdown_distributed()


if __name__ == "__main__":
    cli()
