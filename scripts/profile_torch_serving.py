#!/usr/bin/env python3
"""Where the PyTorch port's serving time goes, on one CUDA card.

    python3 scripts/profile_torch_serving.py [--batch 256] [--seed 0] [--out logs/profile_torch_serving]

For full-width bf16 ViT-B-32 and one batch of each tower:

* host staging: ``np.stack`` of single requests (what the server does)
  and the pageable host→device copy, host clock around a synchronise;
* device time of one encode whose input already lies on the card
  (CUDA events over repeated calls);
* one ``torch.profiler`` trace of each encode: device time by kernel
  and the device's idle share between the encode's start on the host
  and its last kernel's end.

Prints one JSON object and writes the Chrome traces under ``--out``.
Fails without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def cuda_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters=5):
    times = []
    for _ in range(iters):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t))
    return float(np.median(times))


def profile(fn, name, out_dir):
    """Device time by kernel and idle share of one call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile as torch_profile, record_function

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(name):
            fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(out_dir, f"{name}.json"))
    events = prof.events()
    # the record_function range shows on the device timeline too: not a kernel
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA and e.name != name]
    marker = [e for e in events if e.name == name and e.device_type != torch.autograd.DeviceType.CUDA]
    if not kernels or not marker:
        return {"kernels_traced": len(kernels)}
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = max(e for _, e in spans) - marker[0].time_range.start
    by_name = {}
    for e in kernels:
        total, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (total + e.time_range.elapsed_us(), count + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return {
        "kernels_traced": len(kernels),
        "busy_ms": busy / 1e3,
        "window_ms": window / 1e3,
        "idle_share": 1 - busy / window,
        "top_kernels_ms": [[n[:90], t / 1e3, c] for n, (t, c) in top],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="logs/profile_torch_serving")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_serving: no CUDA device", file=sys.stderr)
        return 1
    from sparsify_clip_tpu_torch.inference import CLIPEncoder
    from sparsify_clip_tpu_torch.models.clip import create_model

    os.makedirs(args.out, exist_ok=True)
    model = create_model("ViT-B-32", dtype=torch.bfloat16, device="cuda", seed=args.seed)
    enc = CLIPEncoder(model)
    cfg, b = model.cfg, args.batch
    rng = np.random.default_rng(args.seed)
    singles = list(rng.standard_normal((b, cfg.image_size, cfg.image_size, 3), dtype=np.float32))
    tokens = rng.integers(1, cfg.vocab_size - 2, size=(b, cfg.context_length)).astype(np.int32)
    tokens[:, -1] = cfg.vocab_size - 1
    stacked = np.stack(singles)
    x_dev = torch.as_tensor(stacked).cuda()
    t_dev = torch.as_tensor(tokens).cuda()

    result = {"device": torch.cuda.get_device_name(0), "batch": b}
    result["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    result["image"] = {
        "np_stack_ms": host_ms(lambda: np.stack(singles)),
        "h2d_ms": host_ms(lambda: torch.as_tensor(stacked).cuda()),
        "encode_host_to_result_ms": host_ms(lambda: enc.encode_images(stacked).cpu()),
        "device_ms": cuda_ms(lambda: enc.encode_images(x_dev)),
        "profile": profile(lambda: enc.encode_images(x_dev), "encode_image", args.out),
    }
    result["text"] = {
        "encode_host_to_result_ms": host_ms(lambda: enc.encode_tokens(tokens).cpu()),
        "device_ms": cuda_ms(lambda: enc.encode_tokens(t_dev)),
        "profile": profile(lambda: enc.encode_tokens(t_dev), "encode_text", args.out),
    }
    print(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
