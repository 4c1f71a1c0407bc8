#!/usr/bin/env python3
"""Time the five loss kernels (the InfoNCE forward and its two backwards,
the uniformity forward and backward) on one CUDA card.

    python3 scripts/profile_loss_kernels.py [--iters 200] [--calls 20]

At the loss shapes of the train steps, fp32 unit rows from a seed: (256,
512) for ViT-B-32 at batch 256, (200, 512), which is no multiple of any
tile, and (64, 768) for ViT-L-14-336 at batch 64.  For each wrapper it
gives ``ms``, the CUDA-event mean over ``--iters`` back-to-back calls (the
wrapper's Python, its allocations and every launch included, as
``chip_smoke.py`` times it), ``device_ms``, the summed device time of the
call's kernels under ``torch.profiler`` over ``--calls`` calls, the
kernels it ran with their device us a call, and ``plain_ms``, the plain
PyTorch version timed as ``ms``.  The script prints one JSON object with
the card's name and power limit.  Fails without a CUDA device.  To
compare two trees, run this file from each copy of the package (each in a
gitignored directory, with its own ``_build/``) within one call.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from collections import defaultdict

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SHAPES = ((256, 512), (200, 512), (64, 768))


def cuda_ms(fn, iters: int, warmup: int = 10) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_us(fn, calls: int):
    """{kernel name: device us a call} over ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    per_kernel = defaultdict(float)
    for event in prof.events():
        if event.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[event.name[:80]] += event.time_range.elapsed_us() / calls
    return dict(per_kernel)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_loss_kernels: no CUDA device", file=sys.stderr)
        return 1
    from sparsify_clip_tpu_torch.ops import infonce, lunif

    rng = np.random.default_rng(args.seed)
    result = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip(), "cases": []}
    for n, d in SHAPES:
        emb = rng.standard_normal((3, n, d), dtype=np.float32)
        emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
        img, txt, x = torch.from_numpy(emb).cuda()
        temp, g = torch.tensor(0.1, device="cuda"), torch.ones((), device="cuda")
        _, row_lse, col_lse = infonce.infonce_fwd_reference(img, txt, temp)
        bwd = (img, txt, temp, row_lse, col_lse, g)
        s, _ = lunif.lunif_fwd_reference(x)
        cases = [
            ("infonce_fwd", lambda: infonce.infonce_fwd(img, txt, temp),
             lambda: infonce.infonce_fwd_reference(img, txt, temp)),
            ("infonce_bwd_dimg", lambda: infonce.infonce_bwd_dimg(*bwd),
             lambda: infonce.infonce_bwd_dimg_reference(*bwd)),
            ("infonce_bwd_dtxt", lambda: infonce.infonce_bwd_dtxt(*bwd),
             lambda: infonce.infonce_bwd_dtxt_reference(*bwd)),
            ("lunif_fwd", lambda: lunif.lunif_fwd(x), lambda: lunif.lunif_fwd_reference(x)),
            ("lunif_bwd", lambda: lunif.lunif_bwd(x, s, g),
             lambda: lunif.lunif_bwd_reference(x, s, g)),
        ]
        for name, kernel, plain in cases:
            kernels = device_us(kernel, args.calls)
            result["cases"].append({
                "kernel": name, "n": n, "d": d,
                "ms": cuda_ms(kernel, args.iters),
                "device_ms": sum(kernels.values()) / 1e3,
                "kernels_us": kernels,
                "plain_ms": cuda_ms(plain, args.iters),
            })
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
