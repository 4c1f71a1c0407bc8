#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, one line each; any failure exits nonzero before the final line:

1. build the CUDA kernels from ``sparsify_clip_tpu_torch/ops/csrc``;
2. hold the attention kernel against its plain PyTorch version at the
   towers' batch-256 shapes (bf16) and once in fp32, and time both;
3. build full-width ViT-B-32 in bf16 from a seed on the card;
4. serve image and token-row requests from several threads through
   ``BatchingEncoderServer`` over ``CLIPEncoder``, check the embeddings
   (finite, unit norm, equal to a direct encode, equal to the plain
   attention path) and that every attention layer ran the kernel;
5. report requests/s and latency beside the card's name and power limit.

The last lines are a JSON object of per-kernel results, the card's
``nvidia-smi`` name and power limit, and
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without
the repository beside it, the script fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch

SEED = 0
N_IMAGES = 1024
N_TOKENS = 1024
SUBMIT_THREADS = 8
MAX_BATCH = 256
# kernel vs plain version: one bf16 rounding step (2^-8 relative) where
# the two fp32 sums, taken in different orders, straddle a boundary
KERNEL_TOL = {"bfloat16": (1e-2, 1e-2), "float32": (1e-5, 1e-5)}  # (rtol, atol)
# served vs direct encode and kernel vs plain attention path, on unit
# bf16-tower embeddings: batch composition and the attention path change
# only bf16 rounding inside the towers
MIN_COSINE = 0.999
NORM_TOL = 1e-3


def log(phase: str, **fields) -> None:
    print(f"{phase}: " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_build():
    from sparsify_clip_tpu_torch.ops import _build

    t = time.perf_counter()
    path, build_log = _build.build()
    _build.library()
    usage = [ln.split(":", 1)[1].strip() for ln in build_log.splitlines() if "Used" in ln]
    log("phase 1 build", ok=True, seconds=f"{time.perf_counter() - t:.3f}",
        library=path.name, ptxas=json.dumps(usage))


def phase_kernel():
    from sparsify_clip_tpu_torch.ops.attention import mha_fwd, mha_fwd_reference

    cases = [
        ("vision", 256, 50, 12, 64, False, torch.bfloat16),
        ("text", 256, 77, 8, 64, True, torch.bfloat16),
        ("vision-fp32", 256, 50, 12, 64, False, torch.float32),
    ]
    results = {}
    rng = np.random.default_rng(SEED)
    for name, b, l, heads, head_dim, causal, dtype in cases:
        host = rng.standard_normal((b, l, 3 * heads * head_dim), dtype=np.float32)
        qkv = torch.from_numpy(host).to("cuda", dtype)
        got, got_lse = mha_fwd(qkv, heads, causal, with_lse=True)
        want, want_lse = mha_fwd_reference(qkv, heads, causal, with_lse=True)
        torch.cuda.synchronize()
        rtol, atol = KERNEL_TOL[str(dtype).split(".")[1]]
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
        torch.testing.assert_close(got_lse, want_lse, rtol=1e-5, atol=1e-5)
        err = (got.float() - want.float()).abs().max().item()
        ms = cuda_ms(lambda: mha_fwd(qkv, heads, causal))
        plain_ms = cuda_ms(lambda: mha_fwd_reference(qkv, heads, causal))
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
        log("phase 2 kernel", case=name, shape=list(qkv.shape), heads=heads,
            causal=causal, dtype=str(dtype), max_abs_err=err, rtol=rtol, atol=atol,
            ms=f"{ms:.5f}", plain_ms=f"{plain_ms:.5f}")
    return results


def token_rows(rng, n, context, vocab):
    """SOT, random ids, EOT at a random position, zero padding after it."""
    rows = rng.integers(1, vocab - 2, size=(n, context)).astype(np.int32)
    rows[:, 0] = vocab - 2
    eot = rng.integers(1, context, size=n)
    for i, e in enumerate(eot):
        rows[i, e] = vocab - 1
        rows[i, e + 1:] = 0
    return rows


def min_cosine(a, b) -> float:
    a = a / np.linalg.norm(a, axis=-1, keepdims=True)
    b = b / np.linalg.norm(b, axis=-1, keepdims=True)
    return float((a * b).sum(-1).min())


def encode_direct(fn, rows, chunk):
    return np.concatenate([fn(rows[i:i + chunk]).float().cpu().numpy()
                           for i in range(0, len(rows), chunk)])


def phase_serve(model):
    from sparsify_clip_tpu_torch.inference import CLIPEncoder
    from sparsify_clip_tpu_torch.models import layers
    from sparsify_clip_tpu_torch.ops.attention import mha_fwd, mha_fwd_reference
    from sparsify_clip_tpu_torch.serving import BatchingEncoderServer

    cfg = model.cfg
    rng = np.random.default_rng(SEED + 1)
    size = cfg.image_size
    images = rng.standard_normal((N_IMAGES, size, size, 3), dtype=np.float32)
    tokens = token_rows(rng, N_TOKENS, cfg.context_length, cfg.vocab_size)
    requests = [("image", i) for i in range(N_IMAGES)] + [("tokens", i) for i in range(N_TOKENS)]
    order = rng.permutation(len(requests))

    encoder = CLIPEncoder(model)
    server = BatchingEncoderServer(encoder, max_batch=MAX_BATCH)
    futures = [None] * len(requests)
    errors = []

    def submit(worker):
        try:
            for j in order[worker::SUBMIT_THREADS]:
                kind, i = requests[j]
                futures[j] = (server.submit_image(images[i]) if kind == "image"
                              else server.submit_tokens(tokens[i]))
        except Exception as exc:  # reported and failed below
            errors.append(exc)

    try:
        server.warmup((size, size, 3), cfg.context_length)
        mha_fwd.launches = 0
        t0 = time.perf_counter()
        threads = [threading.Thread(target=submit, args=(w,)) for w in range(SUBMIT_THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        if errors or any(t.is_alive() for t in threads):
            raise RuntimeError(f"submission failed: {errors}")
        rows = [f.result(timeout=600) for f in futures]
        wall = time.perf_counter() - t0
        launches = mha_fwd.launches
        stats = server.stats()
    finally:
        server.close()

    served_img = np.stack([rows[j] for j, (k, _) in enumerate(requests) if k == "image"])
    served_txt = np.stack([rows[j] for j, (k, _) in enumerate(requests) if k == "tokens"])
    served = np.concatenate([served_img, served_txt])
    norms = np.linalg.norm(served, axis=-1)
    if served.shape != (N_IMAGES + N_TOKENS, cfg.embed_dim) or not np.isfinite(served).all():
        raise AssertionError(f"bad embeddings: shape {served.shape}, finite {np.isfinite(served).all()}")
    if np.abs(norms - 1).max() > NORM_TOL:
        raise AssertionError(f"norms off 1 by {np.abs(norms - 1).max()}")
    if stats.errors or stats.requests != len(requests):
        raise AssertionError(f"server stats {stats}")
    depths = {cfg.vision_layers[0], cfg.text_layers}
    if len(depths) != 1 or launches != depths.pop() * stats.batches:
        raise AssertionError(
            f"{launches} kernel launches for {stats.batches} batches of "
            f"{cfg.vision_layers[0]}/{cfg.text_layers}-layer towers"
        )

    direct_img = encode_direct(encoder.encode_images, images, MAX_BATCH)
    direct_txt = encode_direct(encoder.encode_tokens, tokens, MAX_BATCH)
    cos_served = min(min_cosine(served_img, direct_img), min_cosine(served_txt, direct_txt))
    # the same encoder with the towers' attention core swapped for the
    # plain version
    kernel_core, kernel_launches = layers.attention_core, mha_fwd.launches
    layers.attention_core = lambda qkv, heads, causal=False: mha_fwd_reference(qkv, heads, causal)[0]
    try:
        plain_img = encode_direct(encoder.encode_images, images, MAX_BATCH)
        plain_txt = encode_direct(encoder.encode_tokens, tokens, MAX_BATCH)
    finally:
        layers.attention_core = kernel_core
    if mha_fwd.launches != kernel_launches:
        raise AssertionError("the plain attention pass launched the kernel")
    cos_plain = min(min_cosine(direct_img, plain_img), min_cosine(direct_txt, plain_txt))
    log("phase 4 serve", ok=True, requests=stats.requests, batches=stats.batches,
        histogram=json.dumps(stats.batch_histogram), mean_batch=f"{stats.mean_batch:.2f}",
        kernel_launches=launches, max_norm_err=float(np.abs(norms - 1).max()),
        min_cos_served_vs_direct=cos_served, min_cos_kernel_vs_plain=cos_plain,
        max_abs_served_vs_direct=float(max(np.abs(served_img - direct_img).max(),
                                           np.abs(served_txt - direct_txt).max())))
    if cos_served < MIN_COSINE or cos_plain < MIN_COSINE:
        raise AssertionError(f"cosine below {MIN_COSINE}: served {cos_served}, plain {cos_plain}")
    return dict(launches=launches, wall=wall, stats=stats)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU", file=sys.stderr)
        return 1
    from sparsify_clip_tpu_torch.models.clip import create_model

    phase_build()
    kernel = phase_kernel()

    t = time.perf_counter()
    model = create_model("ViT-B-32", dtype=torch.bfloat16, device="cuda", seed=SEED)
    log("phase 3 model", ok=True, name=model.cfg.name, dtype=str(model.dtype),
        params=sum(p.numel() for p in model.parameters()),
        seconds=f"{time.perf_counter() - t:.3f}")

    serve = phase_serve(model)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    stats = serve["stats"]
    log("phase 5 rate", requests_per_s=f"{stats.requests / serve['wall']:.1f}",
        wall_s=f"{serve['wall']:.3f}", p50_ms=f"{stats.latency_p50_ms:.3f}",
        p99_ms=f"{stats.latency_p99_ms:.3f}", card=json.dumps(smi))

    vision = kernel["vision"]
    print(json.dumps({"kernels": [{
        "name": "mha_fwd",
        "route": "cuda",
        "source": "sparsify_clip_tpu_torch/ops/csrc/mha_fwd.cu",
        "replaces": "sparsify_clip_tpu/ops/pallas_attention.py:67",
        "launches": serve["launches"],
        "max_abs_err": vision["max_abs_err"],
        "ms": vision["ms"],
        "plain_ms": vision["plain_ms"],
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
