#!/usr/bin/env python3
"""Where the PyTorch port's train-step time goes, on one CUDA card.

    python3 scripts/profile_torch_train.py [--only anchor,l336_exp6_main] [--steps 3] \\
        [--seed 0] [--out logs/profile_torch_train]

Full-width models, fp32 parameters with bf16 compute, on a fixed
device-resident synthetic batch, through ``create_train_setup`` and
``train_step``, in these configurations, one after the other (``--only``
picks some):

* ``anchor``: ViT-B-32 at batch 256, ``loss_type: "anchor"`` with a
  learnable temperature (the configuration of ``chip_smoke.py`` phase 7);
* ``exp6_warm`` and ``exp6_main``: ViT-B-32 at batch 256, the exp-6 step
  (``loss_type: "only_lunif_n_then_anchor+lalign+lunif(centroids)"``, one
  warm epoch, fixed temperature 0.1; ``chip_smoke.py`` phase 9), started
  at a step of the warm phase and of the main phase;
* ``l336_exp6_warm`` and ``l336_exp6_main``: the same exp-6 step of
  ViT-L-14-336 at batch 64 (``chip_smoke.py`` phase 13), whose vision
  tower takes the head-group attention kernels;
* ``l336_fused_exp6_main``: that main-phase step with ``fused_ln_qkv:
  true`` (``chip_smoke.py`` phase 16): every block's ln_1 and in_proj run
  as the fused LN+qkv kernel, and their backward's LayerNorm as one kernel.

For each:

* step time: host clock around ``--steps * 4`` steps ending in a
  synchronise, after warm-up;
* one ``torch.profiler`` trace of ``--steps`` steps: device time by
  kernel and by group (the port's kernels, cuBLAS GEMMs, LayerNorm,
  the optimizer, other elementwise work), kernels per step, and the
  device's idle share between the first step's start on the host and the
  last kernel's end (the profiler slows the host, so the share is also
  given against the unprofiled step time).

Prints one JSON object and writes it, with a Chrome trace for each
configuration, under ``--out``.  Fails without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# kernel name fragment → group, first match wins (the head-group backward
# runs the shared dQ and dK/dV kernels with its `HeadGroupRows` policy; both
# forwards run the kernels of mha_fwd_tiles.cuh, the wgmma one at head_dim
# 64 past 128 rows: the ViT-L-14-336 vision tower; ln_qkv.cu's kernels go
# to their groups ahead of the generic LayerNorm and reduction fragments)
GROUPS = [
    ("headgroup", "head-group attention backward (mha_head_group.cu)"),
    ("mha_bwd", "attention backward (mha_bwd.cu)"),
    ("mha_fwd_wgmma", "attention forward, wgmma (mha_fwd_tiles.cuh)"),
    ("mha_fwd", "attention forward, mma.sync or fp32 (mha_fwd_tiles.cuh)"),
    ("infonce", "InfoNCE (infonce.cu)"),
    ("ln_fast_bwd", "fused LN+qkv backward LayerNorm (ln_qkv.cu)"),
    ("ln_qkv", "fused LN+qkv forward (ln_qkv.cu)"),
    ("ln_row_stats", "fused LN+qkv forward (ln_qkv.cu)"),
    ("lunif", "uniformity (lunif.cu)"),
    ("nvjet", "cuBLAS GEMM"),
    ("gemm", "cuBLAS GEMM"),
    ("xmma", "cuBLAS GEMM"),
    ("cutlass", "cuBLAS GEMM"),
    ("layer_norm", "LayerNorm"),
    ("gammabeta", "LayerNorm"),  # LayerNorm's weight and bias gradients
    ("multi_tensor_apply", "optimizer (AdamW foreach)"),
    ("adam", "optimizer (AdamW foreach)"),
    ("embedding", "embedding"),
    ("gelu", "GELU"),
    ("reduce", "reductions"),
    ("copy", "casts and copies"),
    ("elementwise", "other elementwise"),
]


def group_of(name: str) -> str:
    low = name.lower()
    for frag, group in GROUPS:
        if frag in low:
            return group
    return "other"


ANCHOR = dict(loss_type="anchor", anchor_temperature_learnable=True)
EXP6 = dict(loss_type="only_lunif_n_then_anchor+lalign+lunif(centroids)", only_lunif_epochs=1,
            anchor_temperature=0.1)
# name → (model, batch, configuration, epoch the profiled steps start in)
PROFILES = {
    "anchor": ("ViT-B-32", 256, ANCHOR, 0),
    "exp6_warm": ("ViT-B-32", 256, EXP6, 0),
    "exp6_main": ("ViT-B-32", 256, EXP6, 1),
    "l336_exp6_warm": ("ViT-L-14-336", 64, EXP6, 0),
    "l336_exp6_main": ("ViT-L-14-336", 64, EXP6, 1),
    "l336_fused_exp6_main": ("ViT-L-14-336", 64, dict(EXP6, fused_ln_qkv=True), 1),
}


def profile_config(name: str, args) -> dict:
    from torch.profiler import ProfilerActivity, profile, record_function

    from sparsify_clip_tpu_torch.config import ExperimentConfig
    from sparsify_clip_tpu_torch.data import synthetic_batch
    from sparsify_clip_tpu_torch.train import batch_to_device, create_train_setup

    model, batch_size, fields, start_epoch = PROFILES[name]
    config = ExperimentConfig.from_dict(dict(
        model=model, batch_size=batch_size, epochs=2, learning_rate=1e-4, fp16=True,
        seed=args.seed, **fields,
    ))
    steps = args.steps
    steps_per_epoch = 10 * steps  # every step below stays inside one epoch
    setup = create_train_setup(config, steps_per_epoch=steps_per_epoch, device="cuda")
    cfg = setup.model.cfg
    batch = batch_to_device(synthetic_batch(batch_size, cfg.image_size, cfg.context_length,
                                            seed=args.seed), setup.device)
    state = setup.state
    state.step = start_epoch * steps_per_epoch
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        state, _ = setup.train_step(state, batch)
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    for _ in range(4 * steps):
        state, _ = setup.train_step(state, batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / (4 * steps) * 1e3

    marker = "train_steps"
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(marker):
            for _ in range(steps):
                state, metrics = setup.train_step(state, batch)
        torch.cuda.synchronize()
    if (state.step - 1) // steps_per_epoch != start_epoch:
        raise AssertionError(f"{name}: the profiled steps left epoch {start_epoch}")
    warm = start_epoch < config.only_lunif_epochs
    prof.export_chrome_trace(os.path.join(args.out, f"trace_{name}.json"))
    events = prof.events()
    # record_function ranges (this script's and the optimizer's
    # "Optimizer.step#AdamW.step") show on the device timeline too: not kernels
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA and e.name != marker
               and not e.name.startswith("Optimizer.")
               and not getattr(e, "is_user_annotation", False)]
    start = min(e.time_range.start for e in events
                if e.name == marker and e.device_type != torch.autograd.DeviceType.CUDA)
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, (cur_s, cur_e) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = max(e for _, e in spans) - start
    by_name, by_group = {}, {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        total, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (total + us, count + 1)
        g = group_of(e.name)
        total, count = by_group.get(g, (0.0, 0))
        by_group[g] = (total + us, count + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    return {
        "model": model,
        "batch": batch_size,
        "loss_type": config.loss_type,
        "warm_phase": warm,
        "last_loss_components": {k: float(metrics[k]) for k in ("anchor", "lalign", "lunif")},
        "step_ms_host_clock": step_ms,
        "pairs_per_s": batch_size / step_ms * 1e3,
        "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
        "profiled_steps": steps,
        "kernels_per_step": len(kernels) / steps,
        "device_busy_ms_per_step": busy / 1e3 / steps,
        "window_ms_per_step": window / 1e3 / steps,
        "idle_share_profiled": 1 - busy / window,
        # the profiler slows the host's dispatch; against the unprofiled step:
        "idle_share_vs_host_step": 1 - busy / 1e3 / steps / step_ms,
        "groups_ms_per_step": {
            g: [t / 1e3 / steps, c / steps]
            for g, (t, c) in sorted(by_group.items(), key=lambda kv: -kv[1][0])
        },
        "top_kernels_ms_per_step": [[n[:100], t / 1e3 / steps, c / steps] for n, (t, c) in top],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default=",".join(PROFILES),
                    help="comma-separated profile names (default: all)")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="logs/profile_torch_train")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_train: no CUDA device", file=sys.stderr)
        return 1
    os.makedirs(args.out, exist_ok=True)
    result = {
        "device": torch.cuda.get_device_name(0),
        "card": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip(),
    }
    for name in args.only.split(","):
        result[name] = profile_config(name, args)
        torch.cuda.empty_cache()
    with open(os.path.join(args.out, "profile.json"), "w") as fh:
        json.dump(result, fh, indent=1)
    print(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
