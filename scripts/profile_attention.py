#!/usr/bin/env python3
"""Device time of each kernel of the two attention forwards and the two
attention backwards, on one CUDA card.

    python3 scripts/profile_attention.py [--calls 5]

At the ViT-B-32 train shapes (vision (256, 50, 2304), 12 heads; causal
text (256, 77, 1536), 8 heads) it profiles ``mha_fwd`` (bf16, and fp32 at
the vision shape) and ``mha_bwd``; at the ViT-L-14-336 vision shape (64,
577, 3072), 16 heads, ``mha_fwd_head_group`` (bf16 causal and not, fp32
at batch 32 and 64) and ``mha_bwd_head_group`` (bf16, causal and not);
inputs from a seed.  Each runs a few times, then ``--calls`` times under
``torch.profiler``; the script prints one JSON object: the card's name and
power limit, and for each case the device ms a call of each kernel (the
forwards run one kernel, each backward a dQ and a dK/dV kernel).  Fails
without a CUDA device.  To compare a variant of a kernel, run this once in
each copy of the package (each in a gitignored directory, with its own
``_build/``) within one call.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_attention: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from sparsify_clip_tpu_torch.ops.attention import (
        mha_bwd, mha_bwd_head_group, mha_fwd, mha_fwd_head_group,
    )

    rng = np.random.default_rng(args.seed)

    def normal(shape, dtype=torch.bfloat16):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to("cuda", dtype)

    result = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()}
    cases = {}
    for name, b, l, heads, causal in [("vision", 256, 50, 12, False),
                                      ("text-causal", 256, 77, 8, True)]:
        qkv, dout = normal((b, l, 3 * heads * 64)), normal((b, l, heads * 64))
        lse = mha_fwd(qkv, heads, causal, with_lse=True)[1]
        cases[f"mha_fwd/{name}"] = (
            list(qkv.shape), lambda q=qkv, h=heads, c=causal: mha_fwd(q, h, c, with_lse=True))
        cases[f"mha_bwd/{name}"] = (
            list(qkv.shape), lambda q=qkv, s=lse, d=dout, h=heads, c=causal: mha_bwd(q, s, d, h, c))
    qkv32 = normal((256, 50, 2304), torch.float32)
    cases["mha_fwd/vision-fp32"] = (list(qkv32.shape), lambda: mha_fwd(qkv32, 12, False, True))
    qkv, dout = normal((64, 577, 3072)), normal((64, 577, 1024))
    for name, causal in [("vision", False), ("vision-causal", True)]:
        cases[f"mha_fwd_head_group/{name}"] = (
            list(qkv.shape), lambda c=causal: mha_fwd_head_group(qkv, 16, c))
        cases[f"mha_bwd_head_group/{name}"] = (
            list(qkv.shape), lambda c=causal: mha_bwd_head_group(qkv, dout, 16, c))
    for b in (32, 64):
        x = normal((b, 577, 3072), torch.float32)
        cases[f"mha_fwd_head_group/vision-fp32-b{b}"] = (
            list(x.shape), lambda x=x: mha_fwd_head_group(x, 16, False))

    for name, (shape, fn) in cases.items():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.calls):
                fn()
            torch.cuda.synchronize()
        kernels = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                kernels[e.name] = kernels.get(e.name, 0.0) + e.time_range.elapsed_us()
        result[name] = {"shape": shape, "kernel_ms_per_call": {
            k[:120]: us / 1e3 / args.calls for k, us in sorted(kernels.items())}}
    print(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
