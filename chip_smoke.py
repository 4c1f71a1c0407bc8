#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on one
NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, one line each; any failure exits nonzero before the final line:

1. build the CUDA kernels from ``sparsify_clip_tpu_torch/ops/csrc`` (one
   ``nvcc`` a source, all started together);
2. hold the attention forward kernel against its plain PyTorch version at
   the towers' batch-256 shapes (bf16) and once in fp32, and time both
   beside SDPA's forward under each backend that takes the shape (the
   fastest is the yardstick, named);
3. build full-width ViT-B-32 in bf16 from a seed on the card;
4. serve image and token-row requests from several threads through
   ``BatchingEncoderServer`` over ``CLIPEncoder``, check the embeddings
   (finite, unit norm, equal to a direct encode, equal to the plain
   attention path) and that every attention layer ran the kernel;
5. report requests/s and latency beside the card's name and power limit;
6. hold the training kernels against their plain versions at the train
   step's shapes and time both: the attention backward at the vision
   (256, 50, 2304) and causal text (256, 77, 1536) bf16 shapes and once in
   fp32, beside SDPA's backward under each backend that takes the shape
   (flash, efficient, cuDNN; the fastest is the yardstick, named); the
   InfoNCE forward and both backward kernels at (256, 512) fp32, at
   N = 200, which is no multiple of the TPU's 128-row tile or of the
   backward's 32-row tile, and at ViT-L-14-336's (64, 768);
7. train full-width ViT-B-32 (fp32 parameters, bf16 compute) at batch 256
   under ``loss_type: "anchor"`` with a learnable temperature, through
   ``create_train_setup``, ``train_step`` and ``run_training``, on a fixed
   device-resident synthetic batch.  First one step's gradients on the
   kernels against the same step with every kernel swapped for its plain
   version (that pass must launch no kernel; loss, temperature gradient
   and each parameter's gradient direction must agree); then warm-up
   steps through ``train_step`` and one timed epoch through
   ``run_training``, whose losses must be finite and fall, with exactly
   24 ``mha_fwd``, 24 ``mha_bwd`` and one launch of each InfoNCE kernel
   per step.  Step ms, pairs/s and peak device memory are printed beside
   the card's name and power limit;
8. hold the fused uniformity forward and backward kernels against their
   plain versions at phase 6's shapes, fp32 unit rows, and time both;
9. train full-width ViT-B-32 at batch 256 under the exp-6 configuration
   (``only_lunif_n_then_anchor+lalign+lunif(centroids)``, one warm epoch,
   fixed temperature 0.1, bf16 compute) through ``create_train_setup``,
   ``train_step`` and ``run_training``, two epochs of a few steps on a
   fixed device-resident batch: epoch 0 is the warm phase (uniformity
   alone), epoch 1 the main phase.  One warm and one main step are first
   held against the same step with every kernel swapped for its plain
   version (which launches none); the epochs must launch exactly 24
   ``mha_fwd``, 24 ``mha_bwd`` and 2 of each uniformity kernel a warm
   step, and 24, 24, one of each InfoNCE kernel and one of each uniformity
   kernel a main step; losses must be finite.  Step ms and pairs/s of each
   phase and the peak device memory are printed beside the card;
10. the per-epoch eval inside that ``run_training``: ``evaluate_model``
   over ``make_eval_model(model)``, the fp32 twin on the training
   parameters, over 512 synthetic pairs in two batches of 256, before
   training and after each epoch.  The 13 metrics must be present and
   finite, each eval must launch 24 ``mha_fwd`` a batch and nothing else,
   and the final eval must agree with the same eval on the plain
   attention;
11. hold the head-group attention kernels (``ops/csrc/mha_fwd.cu``'s
   head-group entry point and ``ops/csrc/mha_head_group.cu``,
   the route of sequences whose packed qkv is over 3 MB a sample) against
   their plain versions and time them beside SDPA and their bound: the
   forward at the ViT-L-14-336 vision shape (64, 577, 3072) in bf16,
   causal and not, and at (32, 577, 3072) and the eval's (64, 577, 3072)
   in fp32, beside SDPA's forward under each backend as phase 2; the
   backward at
   (64, 577, 3072) bf16 and (8, 577, 3072) fp32, beside SDPA's backward
   under each backend as phase 6.  Check that the route
   sends (577, 3072, 16 heads) in bf16 and fp32 to the head-group pair and
   the text tower's (77, 2304, 12 heads) to the whole-width pair;
12. build full-width ViT-L-14-336 in bf16 from a seed (the init time is
   printed) and serve 256 image and 256 token-row requests from several
   threads, ``max_batch`` 64, with phase 4's checks; each image batch must
   launch 24 ``mha_fwd_head_group`` and nothing else, each text batch 12
   ``mha_fwd`` and nothing else;
13. train full-width ViT-L-14-336 under exp 6 at batch 64 as phase 9 does,
   over one warm and one main epoch of 4 steps: a warm step launches
   24 ``mha_fwd_head_group``, 24 ``mha_bwd_head_group``, 12 ``mha_fwd``,
   12 ``mha_bwd`` and 2 of each uniformity kernel, a main step the same
   attention, one of each InfoNCE kernel and one of each uniformity
   kernel.  The warm and the main step held against the plain versions
   run at batch 8: at 64 the plain attention's (64, 16, 577, 577) fp32
   scores, saved for autograd in every layer, would not fit the card;
14. the eval inside that run, as phase 10: every batch launches 24 fp32
   ``mha_fwd_head_group`` and 12 fp32 ``mha_fwd`` and no backward;
15. hold the fused LayerNorm + qkv kernel (``ops/csrc/ln_qkv.cu``) against
   its plain version and time it beside the unfused pair
   ``F.linear(F.layer_norm(x))`` (two library calls) and its bound: the
   ViT-L-14-336 shapes at batch 64, vision (36928, 1024) → 3072 and text
   (4928, 768) → 2304 in bf16, vision in fp32 (the eval twin), and 1000
   rows at W 1664 in bf16 (the widest tower, a ragged last tile); then the
   backward's LayerNorm kernel (same source) against autograd of its plain
   version at the vision and text bf16 shapes and the vision fp32 one,
   timed beside ``native_layer_norm_backward`` fed the fast-variance row
   statistics plus ``F.layer_norm`` for y's recompute (two library calls)
   and its bound; two runs of each kernel must agree bit for bit;
16. train ViT-L-14-336 under exp 6 at batch 64 as phase 13, with
   ``fused_ln_qkv: true``: every train step launches phase 13's kernels,
   36 ``ln_qkv_fwd`` (24 vision, 12 text) and, in the backward, 36
   ``ln_fast_bwd``.  The warm and the main step at batch 8 are held
   against the plain versions (which launch nothing) and against the same
   step on the unfused blocks (kernels and all, no ``ln_qkv_fwd`` or
   ``ln_fast_bwd``);
17. the eval inside that run, as phase 14, plus 36 fp32 ``ln_qkv_fwd`` a
   batch and no ``ln_fast_bwd``.

Depth cuts of the ViT-L-14-336 phases: 2 epochs of 4 steps (the
reference trains 100); the eval set is 256 pairs in 4 batches of 64
(the reference's 512), evaluated 3 times (before training and after
each epoch).  The earlier phases run as they did.

The last lines are a JSON object of per-kernel results (time, plain time,
library time, the card's least time for the work, launches on the main
paths; for the loss kernels of phases 6 and 8 also ``device_ms``, the
card's own time a call, apart from the host's time to issue it), the
card's ``nvidia-smi`` name and power limit, and ``{"ok":
true, "device": {...}}``.  Without a CUDA device, or without the
repository beside it, the script fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
from typing import Optional

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
# attention backward kernel vs plain version: as the forward (one bf16
# rounding of fp32 sums taken in other orders); fp32 sums over L <= 77
BWD_TOL = {"bfloat16": (1e-2, 1e-2), "float32": (1e-4, 2e-5)}  # (rtol, atol)
# the loss kernels' shapes (phases 6 and 8): ViT-B-32's batch 256 and 512-wide
# embeddings, N = 200 (no multiple of any tile), ViT-L-14-336's batch 64 and
# 768-wide embeddings
LOSS_SHAPES = ((256, 512), (200, 512), (64, 768))
# InfoNCE kernels vs plain versions, all fp32: other summation orders over
# D <= 768 and N <= 256; gradients against their largest entry
NCE_TOL = (1e-4, 1e-6)
NCE_GRAD_TOL = (1e-4, 1e-5)  # atol relative to the gradient's largest entry
# training phase
TRAIN_BATCH = 256
TRAIN_STEPS_PER_EPOCH = 20   # one epoch of 20: LR warmup over steps 0-3, then cosine
TRAIN_WARMUP, TRAIN_TIMED = 3, 10
# kernel step vs plain step on the same state and batch (bf16 towers):
# the two paths round the same fp32 sums to bf16 in other orders
TRAIN_LOSS_RTOL = 2e-3
TRAIN_DT_RTOL = 2e-2
TRAIN_MIN_GRAD_COSINE = 0.99
# uniformity kernels vs plain versions, all fp32: S sums N(N-1) weights in
# another order, and each Gram entry is an FMA chain in another order than
# cuBLAS's; dx against its largest entry (r∘x − Wx cancels)
LUNIF_S_RTOL, LUNIF_LOSS_ATOL = 1e-5, 1e-5
LUNIF_DX_TOL = (1e-4, 1e-5)  # rtol, atol relative to the largest entry
# exp 6 as scripts/_bench.py:81-87 defines it (copied: that module imports
# the JAX package)
EXP6 = {
    "model": "ViT-B-32", "batch_size": 256, "epochs": 100,
    "learning_rate": 1e-4,
    "loss_type": "only_lunif_n_then_anchor+lalign+lunif(centroids)",
    "only_lunif_epochs": 1, "anchor_temperature": 0.1,
    "fp16": True, "seed": 42,
}
EXP6_EPOCHS, EXP6_STEPS_PER_EPOCH = 2, 8  # depth cut: one warm and one main epoch
EVAL_PAIRS = 512  # the reference's eval set (sparsify_clip_tpu/eval.py:241-242)
# kernel eval vs plain-attention eval on the same fp32 twin: fp32 towers whose
# attention sums run in other orders (embeddings ~1e-6 apart); a rank can
# flip only on a near-tie, so each recall may move by two pairs (the
# tolerance is set from the eval set's size in phase_exp6)
EVAL_GEOMETRY_ATOL = 1e-4
EVAL_MIN_COSINE = 0.99999
# ViT-L-14-336 (phases 12-14): serving, and exp 6 at the batch of the JAX
# package's ViT-L-14-336 train audit (BASELINE.md:416-419)
L336 = "ViT-L-14-336"
L336_REQUESTS = 256             # of each kind
L336_MAX_BATCH = 64
L336_BATCH = 64
L336_CHECK_BATCH = 8            # kernel step vs plain step
L336_STEPS_PER_EPOCH = 4
L336_EVAL_PAIRS = 256
# head-group backward vs plain version in fp32: against the largest entry
# (dS = P∘(dP − Dr) cancels; sums over 577 keys in other orders)
HG_BWD_FP32_TOL = (1e-4, 1e-5)  # rtol, atol relative to the largest entry
# the backward's LayerNorm kernel vs autograd of its plain version: y and dx
# are fp32 values rounded once to their type from row statistics summed in
# other orders (one step of the type, plus 1e-5 of the largest entry where
# the fp32 terms cancel); dscale and dbias sum N rows in another order
LN_BWD_STEP = {"bfloat16": 2.0 ** -7, "float32": 2.0 ** -23}
LN_BWD_CANCEL = 1e-5            # of the largest entry, y and dx
LN_BWD_GRAD_TOL = (1e-4, 1e-5)  # dscale, dbias: rtol, atol relative to the largest entry
# H100 SXM peaks (NVIDIA data sheet, dense, 700 W), for bound_ms
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


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


def device_ms(fn, iters: int = 50) -> float:
    """The card's time a call of ``fn``, without the host's: the calls are
    queued behind a sleep kernel long enough for the host to enqueue them
    all, so the card runs them back to back (``cuda_ms`` times calls as
    the host issues them, which is the host's time where it is longer)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # about 25 ms at the H100's clock
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes: float, flops: float, dtype: str):
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the peak rate for the inputs'
    type → (ms, "bytes" or "operations")."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_pairs(l: int, causal: bool) -> int:
    """(query, key) pairs the mask lets through a head."""
    return l * (l + 1) // 2 if causal else l * l


SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION")


def sdpa_backend_ms(run, what: str, iters: int, warmup: int):
    """``run()`` timed under each backend of ``SDPA_BACKENDS`` that takes
    its shape → ({backend: ms}, the fastest backend)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    times = {}
    for name in SDPA_BACKENDS:
        try:
            with sdpa_kernel(getattr(SDPBackend, name)):
                times[name.lower()] = cuda_ms(run(), iters=iters, warmup=warmup)
        except RuntimeError:  # the backend does not take this shape or type
            continue
    if not times:
        raise AssertionError(f"no SDPA backend takes {what}")
    return times, min(times, key=times.get)


def sdpa_qkv(qkv, heads: int):
    """(B, H, L, D) copies of q, k and v from a packed (B, L, 3W) qkv."""
    b, l, w3 = qkv.shape
    return qkv.view(b, l, 3, heads, w3 // (3 * heads)).permute(2, 0, 3, 1, 4).contiguous()


def sdpa_fwd_ms(qkv, heads: int, causal: bool, iters: int, warmup: int):
    """PyTorch's fused attention forward on (B, H, L, D) copies, timed under
    each backend that takes the shape → ({backend: ms}, the fastest).  A
    yardstick only: the port never calls it."""
    q, k, v = sdpa_qkv(qkv, heads)

    def run():
        return lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=causal)

    return sdpa_backend_ms(run, f"{tuple(qkv.shape)} {qkv.dtype}", iters, warmup)


def sdpa_bwd_ms(qkv, dout, heads: int, causal: bool, iters: int, warmup: int):
    """The backward of PyTorch's fused attention, from its own forward on
    (B, H, L, D) leaves, timed under each backend that takes the shape (the
    backend picked for the forward runs the backward too) → ({backend: ms},
    the fastest backend).  A yardstick only: the port never calls it."""
    b, l, w3 = qkv.shape
    q, k, v = (t.detach().requires_grad_(True) for t in sdpa_qkv(qkv, heads))
    do = dout.view(b, l, heads, w3 // (3 * heads)).transpose(1, 2).contiguous()

    def run():
        o = torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=causal)
        return lambda: torch.autograd.grad(o, (q, k, v), do, retain_graph=True)

    return sdpa_backend_ms(run, f"{tuple(qkv.shape)} {qkv.dtype}", iters, warmup)


def phase_build():
    from sparsify_clip_tpu_torch.ops import _build

    t = time.perf_counter()
    path, build_log = _build.build()
    _build.library()
    usage = _build.ptxas_usage(build_log)
    log("phase 1 build", ok=True, seconds=f"{time.perf_counter() - t:.3f}",
        library=path.name, ptxas=json.dumps(usage),
        spilling=json.dumps([u["kernel"] for u in usage if u.get("spill_stores")]),
        serialized_wgmma=json.dumps([ln for ln in build_log.splitlines() if "C752" in ln]))


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
        # yardstick: SDPA's forward, the fastest backend that takes the shape
        sdpa_ms, library = sdpa_fwd_ms(qkv, heads, causal, iters=50, warmup=5)
        library_ms = sdpa_ms[library]
        item = qkv.element_size()
        bound_ms, bound_by = bound(
            b * l * 4 * heads * head_dim * item,  # qkv read, context written
            2 * 2 * b * heads * attention_pairs(l, causal) * head_dim,  # S and P.V
            str(dtype).split(".")[1],
        )
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                             library=f"sdpa/{library}", bound_ms=bound_ms, bound_by=bound_by)
        log("phase 2 kernel", case=name, shape=list(qkv.shape), heads=heads,
            causal=causal, dtype=str(dtype), max_abs_err=err, rtol=rtol, atol=atol,
            ms=f"{ms:.5f}", plain_ms=f"{plain_ms:.5f}", library_ms=f"{library_ms:.5f}",
            library=f"sdpa/{library}", sdpa_fwd_ms=json.dumps(sdpa_ms),
            bound_ms=f"{bound_ms:.5f}", bound_by=bound_by)
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


class _BatchLaunches:
    """An encoder for the server that records each batch's kind and the
    kernel launches it made.  The server's one runner thread serves its
    one replica, so batches run one at a time and the counts are exact."""

    def __init__(self, encoder):
        self.encoder, self.device, self.batches = encoder, encoder.device, []

    def encode_images(self, images):
        return self._run("image", self.encoder.encode_images, images)

    def encode_tokens(self, tokens):
        return self._run("tokens", self.encoder.encode_tokens, tokens)

    def _run(self, kind, fn, x):
        before = read_counts()
        out = fn(x)
        after = read_counts()
        self.batches.append((kind, {k: after[k] - before[k] for k in after}))
        return out


def phase_serve(model, phase: str, n_images: int, n_tokens: int, max_batch: int,
                per_batch: dict):
    """Serve ``n_images`` image and ``n_tokens`` token-row requests from
    several threads; check the embeddings and that each batch of a kind
    launched exactly ``per_batch[kind]`` (kernel → count, the rest 0)."""
    from sparsify_clip_tpu_torch.inference import CLIPEncoder
    from sparsify_clip_tpu_torch.models import layers
    from sparsify_clip_tpu_torch.ops.attention import mha_fwd_reference
    from sparsify_clip_tpu_torch.serving import BatchingEncoderServer

    cfg = model.cfg
    rng = np.random.default_rng(SEED + 1)
    size = cfg.image_size
    images = rng.standard_normal((n_images, size, size, 3), dtype=np.float32)
    tokens = token_rows(rng, n_tokens, cfg.context_length, cfg.vocab_size)
    requests = [("image", i) for i in range(n_images)] + [("tokens", i) for i in range(n_tokens)]
    order = rng.permutation(len(requests))

    encoder = CLIPEncoder(model)
    recorder = _BatchLaunches(encoder)
    server = BatchingEncoderServer(recorder, max_batch=max_batch)
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
        recorder.batches.clear()
        reset_counts()
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
        launches = read_counts()
        stats = server.stats()
    finally:
        server.close()

    served_img = np.stack([rows[j] for j, (k, _) in enumerate(requests) if k == "image"])
    served_txt = np.stack([rows[j] for j, (k, _) in enumerate(requests) if k == "tokens"])
    served = np.concatenate([served_img, served_txt])
    norms = np.linalg.norm(served, axis=-1)
    if served.shape != (n_images + n_tokens, cfg.embed_dim) or not np.isfinite(served).all():
        raise AssertionError(f"bad embeddings: shape {served.shape}, finite {np.isfinite(served).all()}")
    if np.abs(norms - 1).max() > NORM_TOL:
        raise AssertionError(f"norms off 1 by {np.abs(norms - 1).max()}")
    if stats.errors or stats.requests != len(requests):
        raise AssertionError(f"server stats {stats}")
    zero = dict.fromkeys(KERNELS, 0)
    wrong = [(kind, c) for kind, c in recorder.batches if c != dict(zero, **per_batch[kind])]
    if wrong or len(recorder.batches) != stats.batches:
        raise AssertionError(f"batches launched {wrong[:3]}, expected {per_batch} a batch of "
                             f"each kind ({len(recorder.batches)} recorded, {stats.batches} run)")

    direct_img = encode_direct(encoder.encode_images, images, max_batch)
    direct_txt = encode_direct(encoder.encode_tokens, tokens, max_batch)
    cos_served = min(min_cosine(served_img, direct_img), min_cosine(served_txt, direct_txt))
    # the same encoder with the towers' attention core swapped for the
    # plain version
    kernel_core, kernel_launches = layers.attention_core, read_counts()
    layers.attention_core = lambda qkv, heads, causal=False: mha_fwd_reference(qkv, heads, causal)[0]
    try:
        plain_img = encode_direct(encoder.encode_images, images, max_batch)
        plain_txt = encode_direct(encoder.encode_tokens, tokens, max_batch)
    finally:
        layers.attention_core = kernel_core
    if read_counts() != kernel_launches:
        raise AssertionError("the plain attention pass launched a kernel")
    cos_plain = min(min_cosine(direct_img, plain_img), min_cosine(direct_txt, plain_txt))
    kinds = [kind for kind, _ in recorder.batches]
    log(phase, ok=True, model=cfg.name, requests=stats.requests, batches=stats.batches,
        image_batches=kinds.count("image"), text_batches=kinds.count("tokens"),
        histogram=json.dumps(stats.batch_histogram), mean_batch=f"{stats.mean_batch:.2f}",
        launches=json.dumps({k: v for k, v in launches.items() if v}),
        per_batch=json.dumps(per_batch), max_norm_err=float(np.abs(norms - 1).max()),
        min_cos_served_vs_direct=cos_served, min_cos_kernel_vs_plain=cos_plain,
        max_abs_served_vs_direct=float(max(np.abs(served_img - direct_img).max(),
                                           np.abs(served_txt - direct_txt).max())))
    if cos_served < MIN_COSINE or cos_plain < MIN_COSINE:
        raise AssertionError(f"cosine below {MIN_COSINE}: served {cos_served}, plain {cos_plain}")
    return dict(launches=launches, wall=wall, stats=stats)


def phase_train_kernels():
    """Phase 6: the attention backward and the InfoNCE kernels against
    their plain versions at the train step's shapes, timed."""
    from sparsify_clip_tpu_torch.ops.attention import mha_bwd, mha_bwd_reference, mha_fwd
    from sparsify_clip_tpu_torch.ops.infonce import (
        infonce_bwd_dimg, infonce_bwd_dimg_reference, infonce_bwd_dtxt,
        infonce_bwd_dtxt_reference, infonce_fwd, infonce_fwd_reference,
    )

    results = {}
    rng = np.random.default_rng(SEED + 2)
    cases = [
        ("vision", 256, 50, 12, 64, False, torch.bfloat16),
        ("text", 256, 77, 8, 64, True, torch.bfloat16),
        ("vision-fp32", 256, 50, 12, 64, False, torch.float32),
    ]
    for name, b, l, heads, head_dim, causal, dtype in cases:
        width = heads * head_dim
        qkv = torch.from_numpy(rng.standard_normal((b, l, 3 * width), dtype=np.float32)).to(
            "cuda", dtype)
        dout = torch.from_numpy(rng.standard_normal((b, l, width), dtype=np.float32)).to(
            "cuda", dtype)
        _, lse = mha_fwd(qkv, heads, causal, with_lse=True)
        got = mha_bwd(qkv, lse, dout, heads, causal)
        want = mha_bwd_reference(qkv, lse, dout, heads, causal)
        torch.cuda.synchronize()
        rtol, atol = BWD_TOL[str(dtype).split(".")[1]]
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
        err = (got.float() - want.float()).abs().max().item()
        ms = cuda_ms(lambda: mha_bwd(qkv, lse, dout, heads, causal), iters=20)
        plain_ms = cuda_ms(lambda: mha_bwd_reference(qkv, lse, dout, heads, causal), iters=20)
        # yardstick: SDPA's backward, the fastest backend that takes the shape
        sdpa_ms, library = sdpa_bwd_ms(qkv, dout, heads, causal, iters=20, warmup=5)
        library_ms = sdpa_ms[library]
        item = qkv.element_size()
        bound_ms, bound_by = bound(
            b * l * (3 * width * 2 + width) * item + b * l * heads * 4,  # qkv, dout, lse; dqkv
            5 * 2 * b * heads * attention_pairs(l, causal) * head_dim,  # S, dP, dV, dQ, dK
            str(dtype).split(".")[1],
        )
        results[f"mha_bwd/{name}"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                          library_ms=library_ms, library=f"sdpa/{library}",
                                          bound_ms=bound_ms, bound_by=bound_by)
        log("phase 6 kernel", kernel="mha_bwd", case=name, shape=list(qkv.shape), heads=heads,
            causal=causal, dtype=str(dtype), max_abs_err=err, rtol=rtol, atol=atol,
            ms=f"{ms:.5f}", plain_ms=f"{plain_ms:.5f}", library_ms=f"{library_ms:.5f}",
            library=f"sdpa/{library}", sdpa_bwd_ms=json.dumps(sdpa_ms),
            bound_ms=f"{bound_ms:.5f}", bound_by=bound_by)

    for n, d in LOSS_SHAPES:
        emb = rng.standard_normal((2, n, d), dtype=np.float32)
        emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
        img, txt = torch.from_numpy(emb).cuda()
        temp = torch.tensor(0.1, device="cuda")
        g = torch.ones((), device="cuda")
        fwd_args = (img, txt, temp)
        _, row_lse, col_lse = infonce_fwd_reference(*fwd_args)
        bwd_args = (img, txt, temp, row_lse, col_lse, g)
        emb_bytes = 2 * n * d * 4
        checks = [
            # name, kernel, plain, bytes, flops
            ("infonce_fwd", lambda: infonce_fwd(*fwd_args), lambda: infonce_fwd_reference(*fwd_args),
             emb_bytes + 2 * n * 4 + 8, 2 * n * n * d),
            ("infonce_bwd_dimg", lambda: infonce_bwd_dimg(*bwd_args),
             lambda: infonce_bwd_dimg_reference(*bwd_args),
             emb_bytes + 2 * n * 4 + n * d * 4 + 12, 4 * n * n * d),
            ("infonce_bwd_dtxt", lambda: infonce_bwd_dtxt(*bwd_args),
             lambda: infonce_bwd_dtxt_reference(*bwd_args),
             emb_bytes + 2 * n * 4 + n * d * 4 + 8, 4 * n * n * d),
        ]
        for name, kernel, plain, n_bytes, flops in checks:
            got, want = kernel(), plain()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            torch.cuda.synchronize()
            err = 0.0
            for a, w in zip(got, want):
                if name == "infonce_fwd":
                    torch.testing.assert_close(a, w, rtol=NCE_TOL[0], atol=NCE_TOL[1])
                else:
                    scale = w.abs().max().item()
                    torch.testing.assert_close(a, w, rtol=NCE_GRAD_TOL[0],
                                               atol=NCE_GRAD_TOL[1] * scale)
                err = max(err, (a - w).abs().max().item())
            ms, plain_ms, dev_ms = cuda_ms(kernel), cuda_ms(plain), device_ms(kernel)
            bound_ms, bound_by = bound(n_bytes, flops, "float32")
            results[f"{name}/{n}"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                          device_ms=dev_ms, library_ms=None, bound_ms=bound_ms,
                                          bound_by=bound_by)
            log("phase 6 kernel", kernel=name, n=n, d=d, max_abs_err=err,
                ms=f"{ms:.5f}", device_ms=f"{dev_ms:.5f}", plain_ms=f"{plain_ms:.5f}",
                bound_ms=f"{bound_ms:.5f}", bound_by=bound_by)
    return results


KERNELS = ("mha_fwd", "mha_bwd", "infonce_fwd", "infonce_bwd_dimg", "infonce_bwd_dtxt",
           "lunif_fwd", "lunif_bwd", "mha_fwd_head_group", "mha_bwd_head_group", "ln_qkv_fwd",
           "ln_fast_bwd")


def counters():
    from sparsify_clip_tpu_torch.ops import attention, infonce, ln_qkv, lunif

    return {"mha_fwd": attention.mha_fwd, "mha_bwd": attention.mha_bwd,
            "infonce_fwd": infonce.infonce_fwd, "infonce_bwd_dimg": infonce.infonce_bwd_dimg,
            "infonce_bwd_dtxt": infonce.infonce_bwd_dtxt, "lunif_fwd": lunif.lunif_fwd,
            "lunif_bwd": lunif.lunif_bwd, "mha_fwd_head_group": attention.mha_fwd_head_group,
            "mha_bwd_head_group": attention.mha_bwd_head_group,
            "ln_qkv_fwd": ln_qkv.ln_qkv_fwd, "ln_fast_bwd": ln_qkv.ln_fast_bwd}


def reset_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in counters().items()}


def _plain_ln_qkv(x, *args):
    from sparsify_clip_tpu_torch.ops.ln_qkv import ln_qkv_reference

    return ln_qkv_reference(x.reshape(-1, x.shape[-1]), *args).reshape(*x.shape[:-1], -1)


def _plain_paths():
    """Swap the towers' attention core and fused LN+qkv and the loss's
    fused InfoNCE and uniformity for their plain versions (autograd
    differentiates them); returns the function that puts the kernels
    back."""
    from sparsify_clip_tpu_torch.losses import contrastive_loss, dispatch
    from sparsify_clip_tpu_torch.losses.unif import lunif_loss
    from sparsify_clip_tpu_torch.models import layers
    from sparsify_clip_tpu_torch.ops.attention import mha_fwd_reference

    kept = layers.attention_core, layers.ln_qkv_core, dispatch.infonce_loss, dispatch.lunif_loss
    layers.attention_core = lambda qkv, heads, causal=False: mha_fwd_reference(qkv, heads, causal)[0]
    layers.ln_qkv_core = _plain_ln_qkv
    dispatch.infonce_loss, dispatch.lunif_loss = contrastive_loss, lunif_loss

    def restore():
        (layers.attention_core, layers.ln_qkv_core, dispatch.infonce_loss,
         dispatch.lunif_loss) = kept

    return restore


def _set_fused_ln_qkv(model, on: bool) -> None:
    """Switch every block of ``model`` between the fused LN+qkv and the
    unfused ln_1 + in_proj, over the same parameters."""
    from sparsify_clip_tpu_torch.models.layers import ResidualAttentionBlock

    for block in model.modules():
        if isinstance(block, ResidualAttentionBlock):
            block.fused_ln_qkv = on


def _grad_cosines(params, grads_a) -> list:
    """Each parameter's cosine between ``grads_a`` and its current .grad."""
    cosines = []
    for p, ga in zip(params, grads_a):
        gb = p.grad.detach()
        denom = (ga.norm() * gb.norm()).item()
        cosines.append(1.0 if denom == 0 else (ga.flatten() @ gb.flatten()).item() / denom)
    return cosines


def phase_train():
    """Phase 7: the anchor train step of full-width ViT-B-32 at batch 256."""
    from sparsify_clip_tpu_torch.config import ExperimentConfig
    from sparsify_clip_tpu_torch.data import synthetic_batch
    from sparsify_clip_tpu_torch.train import batch_to_device, create_train_setup, run_training

    config = ExperimentConfig.from_dict(dict(
        model="ViT-B-32", batch_size=TRAIN_BATCH, epochs=1, learning_rate=1e-4,
        loss_type="anchor", anchor_temperature=0.1, anchor_temperature_learnable=True,
        fp16=True, seed=SEED, log_every_n_steps=TRAIN_TIMED,  # metrics read once, at the end
    ))
    t = time.perf_counter()
    setup = create_train_setup(config, steps_per_epoch=TRAIN_STEPS_PER_EPOCH, device="cuda")
    cfg = setup.model.cfg
    batch = batch_to_device(synthetic_batch(TRAIN_BATCH, cfg.image_size, cfg.context_length,
                                            seed=SEED), setup.device)
    torch.cuda.synchronize()
    state = setup.state
    params = [p for p in state.model.parameters()]
    depth = cfg.vision_layers[0] + cfg.text_layers
    per_step = dict(dict.fromkeys(KERNELS, 0), mha_fwd=depth, mha_bwd=depth, infonce_fwd=1,
                    infonce_bwd_dimg=1, infonce_bwd_dtxt=1)
    log("phase 7 setup", name=cfg.name, params=sum(p.numel() for p in params),
        param_dtype=str(params[0].dtype), compute_dtype=str(setup.model.dtype),
        batch=TRAIN_BATCH, seconds=f"{time.perf_counter() - t:.3f}")

    # one step's gradients on the kernels, then on the plain versions
    reset_counts()
    loss_k = setup.train_step.loss_and_grads(state, batch)[0].detach()
    torch.cuda.synchronize()
    counts = read_counts()
    if counts != per_step:
        raise AssertionError(f"kernel step launched {counts}, expected {per_step}")
    grads_k = [p.grad.detach().clone() for p in params]
    dt_k = state.temperature.grad.detach().clone()
    # the same step with every kernel swapped for its plain version
    restore = _plain_paths()
    try:
        reset_counts()
        loss_p = setup.train_step.loss_and_grads(state, batch)[0].detach()
        torch.cuda.synchronize()
    finally:
        restore()
    if any(read_counts().values()):
        raise AssertionError(f"the plain step launched kernels: {read_counts()}")
    cosines = _grad_cosines(params, grads_k)
    dt_p = state.temperature.grad.detach()
    loss_gap = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    dt_gap = abs(dt_k.item() - dt_p.item()) / abs(dt_p.item())
    names = [n for n, _ in state.model.named_parameters()]
    worst = int(np.argmin(cosines))
    log("phase 7 plain", loss_kernel=loss_k.item(), loss_plain=loss_p.item(),
        loss_rel_gap=loss_gap, rtol=TRAIN_LOSS_RTOL, dT_kernel=dt_k.item(), dT_plain=dt_p.item(),
        dT_rel_gap=dt_gap, dT_rtol=TRAIN_DT_RTOL, min_grad_cosine=cosines[worst],
        min_at=names[worst], tensors=len(cosines))
    if loss_gap > TRAIN_LOSS_RTOL or dt_gap > TRAIN_DT_RTOL or cosines[worst] < TRAIN_MIN_GRAD_COSINE:
        raise AssertionError("kernel step and plain step disagree")
    state.optimizer.zero_grad(set_to_none=True)
    del grads_k

    # the main path: warm-up steps through train_step, then one epoch of
    # timed steps through run_training (which synchronises at its end)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses = []
    for _ in range(TRAIN_WARMUP):
        state, metrics = setup.train_step(state, batch)
        losses.append(float(metrics["train_loss"]))
    records = []
    t0 = time.perf_counter()
    state = run_training(setup, lambda epoch: iter([batch] * TRAIN_TIMED),
                         log_fn=records.append)
    wall = time.perf_counter() - t0
    launches = read_counts()
    step_records = [r for r in records if "train_loss" in r]
    losses = np.array(losses + [r["train_loss"] for r in step_records])
    steps = TRAIN_WARMUP + len(step_records)
    step_ms = wall / TRAIN_TIMED * 1e3
    peak = torch.cuda.max_memory_allocated()
    log("phase 7 train", steps=steps, losses=json.dumps([float(x) for x in losses]),
        lr_last=step_records[-1]["learning_rate"],
        temperature=step_records[-1]["temperature"],
        launches=json.dumps(launches), step_ms=f"{step_ms:.3f}",
        pairs_per_s=f"{TRAIN_BATCH / (step_ms / 1e3):.1f}",
        max_memory_allocated_gib=f"{peak / 2**30:.3f}")
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite and falling: {losses}")
    expected = {k: v * steps for k, v in per_step.items()}
    if launches != expected:
        raise AssertionError(f"{launches} launches in {steps} steps, expected {expected}")
    return dict(launches=launches, step_ms=step_ms, peak=peak)


def phase_lunif_kernels():
    """Phase 8: the uniformity kernels against their plain versions at the
    exp-6 step's shapes, timed."""
    from sparsify_clip_tpu_torch.ops.lunif import (
        lunif_bwd, lunif_bwd_reference, lunif_fwd, lunif_fwd_reference,
    )

    results = {}
    rng = np.random.default_rng(SEED + 3)
    for n, d in LOSS_SHAPES:
        x = rng.standard_normal((n, d), dtype=np.float32)
        x = torch.from_numpy(x / np.linalg.norm(x, axis=-1, keepdims=True)).cuda()
        g = torch.ones((), device="cuda")
        s, loss = lunif_fwd(x)
        want_s, want_loss = lunif_fwd_reference(x)
        dx, want_dx = lunif_bwd(x, want_s, g), lunif_bwd_reference(x, want_s, g)
        torch.cuda.synchronize()
        torch.testing.assert_close(s, want_s, rtol=LUNIF_S_RTOL, atol=0)
        torch.testing.assert_close(loss, want_loss, rtol=0, atol=LUNIF_LOSS_ATOL)
        scale = want_dx.abs().max().item()
        torch.testing.assert_close(dx, want_dx, rtol=LUNIF_DX_TOL[0], atol=LUNIF_DX_TOL[1] * scale)
        errors = {"lunif_fwd": max((s - want_s).abs().item(), (loss - want_loss).abs().item()),
                  "lunif_bwd": (dx - want_dx).abs().max().item()}
        # the least work: x·xᵀ is symmetric, so the i<j half of the Gram
        # (N(N−1)/2 dot products) and the N norms; the backward adds the
        # full W·x (N²·D FMAs).  An FMA is two operations.
        half_gram = n * (n - 1) * d + 2 * n * d
        checks = [
            # name, kernel, plain, bytes (x read, outputs written), flops
            ("lunif_fwd", lambda: lunif_fwd(x), lambda: lunif_fwd_reference(x),
             n * d * 4 + 8, half_gram),
            ("lunif_bwd", lambda: lunif_bwd(x, want_s, g),
             lambda: lunif_bwd_reference(x, want_s, g), 2 * n * d * 4 + 8,
             half_gram + 2 * n * n * d),
        ]
        for name, kernel, plain, n_bytes, flops in checks:
            ms, plain_ms, dev_ms = cuda_ms(kernel), cuda_ms(plain), device_ms(kernel)
            bound_ms, bound_by = bound(n_bytes, flops, "float32")
            results[f"{name}/{n}"] = dict(max_abs_err=errors[name], ms=ms, plain_ms=plain_ms,
                                          device_ms=dev_ms, library_ms=None, bound_ms=bound_ms,
                                          bound_by=bound_by)
            log("phase 8 kernel", kernel=name, n=n, d=d, max_abs_err=errors[name],
                s_rtol=LUNIF_S_RTOL, loss_atol=LUNIF_LOSS_ATOL, dx_tol=json.dumps(LUNIF_DX_TOL),
                ms=f"{ms:.5f}", device_ms=f"{dev_ms:.5f}", plain_ms=f"{plain_ms:.5f}",
                bound_ms=f"{bound_ms:.5f}", bound_by=bound_by)
    return results


def _rel_gap(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def phase_exp6(smi: str, model: str, phases, batch_size: int, check_batch: int,
               steps_per_epoch: int, eval_pairs: int, warm_step: dict, main_step: dict,
               per_eval_batch: dict, overrides: Optional[dict] = None):
    """Phases 9 and 10 (13 and 14, 16 and 17): the exp-6 step of a
    full-width model at ``batch_size`` over one warm and one main epoch of
    ``steps_per_epoch``, with the per-epoch eval over ``eval_pairs`` in
    batches of ``batch_size``.  A warm and a main step at ``check_batch``
    are held against the plain versions first and, with ``fused_ln_qkv``
    among the config ``overrides``, against the same step on the unfused
    blocks.  ``warm_step``, ``main_step`` and ``per_eval_batch`` are the
    launches of each kernel (the rest 0)."""
    from sparsify_clip_tpu_torch.config import ExperimentConfig
    from sparsify_clip_tpu_torch.data import synthetic_batch
    from sparsify_clip_tpu_torch.eval import (
        GEOMETRY_KEYS, compute_all_metrics, encode_eval_set, evaluate_model, make_eval_model,
        metric_values,
    )
    from sparsify_clip_tpu_torch.train import batch_to_device, create_train_setup, run_training

    train_phase, eval_phase = (f"phase {n}" for n in phases)
    spe = steps_per_epoch
    config = ExperimentConfig.from_dict(dict(EXP6, model=model, batch_size=batch_size,
                                             epochs=EXP6_EPOCHS, log_every_n_steps=spe,
                                             **(overrides or {})))
    t = time.perf_counter()
    setup = create_train_setup(config, steps_per_epoch=spe, device="cuda")
    torch.cuda.synchronize()
    setup_seconds = time.perf_counter() - t
    cfg, state = setup.model.cfg, setup.state
    size, context = cfg.image_size, cfg.context_length
    batch = batch_to_device(synthetic_batch(batch_size, size, context, seed=SEED), setup.device)
    check = batch_to_device(synthetic_batch(check_batch, size, context, seed=SEED), setup.device)
    eval_batches = [batch_to_device(synthetic_batch(batch_size, size, context, seed=SEED + 10 + k),
                                    setup.device) for k in range(eval_pairs // batch_size)]
    torch.cuda.synchronize()
    params = list(state.model.parameters())
    names = [n for n, _ in state.model.named_parameters()]
    zero = dict.fromkeys(KERNELS, 0)
    warm_step, main_step = dict(zero, **warm_step), dict(zero, **main_step)
    log(f"{train_phase} setup", name=cfg.name, loss_type=config.loss_type,
        only_lunif_epochs=config.only_lunif_epochs, temperature=config.anchor_temperature,
        learnable=config.anchor_temperature_learnable, batch=batch_size, check_batch=check_batch,
        steps_per_epoch=spe, epochs=config.epochs, fused_ln_qkv=config.fused_ln_qkv,
        params=sum(p.numel() for p in params), seconds=f"{setup_seconds:.3f}")

    # one warm and one main step's gradients on the kernels, then on the
    # plain versions (loss_and_grads neither steps the optimizer nor
    # advances the step count)
    for phase, step, expected in (("warm", 0, warm_step), ("main", spe, main_step)):
        state.step = step
        reset_counts()
        loss_k, aux_k, _, _ = setup.train_step.loss_and_grads(state, check)
        torch.cuda.synchronize()
        counts = read_counts()
        if counts != expected:
            raise AssertionError(f"{phase} kernel step launched {counts}, expected {expected}")
        grads_k = [p.grad.detach().clone() for p in params]
        if config.fused_ln_qkv:
            # the same step on the unfused blocks: the card's version of the
            # JAX test_block_fused_path_matches_unfused.  The fused path
            # rounds the qkv product and then its bias sum, the unfused one
            # adds the bias inside the product's fp32 epilogue: bf16 apart
            _set_fused_ln_qkv(setup.model, False)
            try:
                reset_counts()
                loss_u, aux_u, _, _ = setup.train_step.loss_and_grads(state, check)
                torch.cuda.synchronize()
            finally:
                _set_fused_ln_qkv(setup.model, True)
            unfused_expected = dict(expected, ln_qkv_fwd=0, ln_fast_bwd=0)
            if read_counts() != unfused_expected:
                raise AssertionError(f"the unfused {phase} step launched {read_counts()}, "
                                     f"expected {unfused_expected}")
            cosines = _grad_cosines(params, grads_k)
            gaps = {k: _rel_gap(aux_k[k].item(), aux_u[k].item()) for k in aux_k}
            gaps["loss"] = _rel_gap(loss_k.item(), loss_u.item())
            worst = int(np.argmin(cosines))
            log(f"{train_phase} unfused", loss_phase=phase, step=step, batch=check_batch,
                loss_fused=loss_k.item(), loss_unfused=loss_u.item(), rel_gaps=json.dumps(gaps),
                rtol=TRAIN_LOSS_RTOL, min_grad_cosine=cosines[worst], min_at=names[worst],
                min_cosine=TRAIN_MIN_GRAD_COSINE, tensors=len(cosines))
            if max(gaps.values()) > TRAIN_LOSS_RTOL or cosines[worst] < TRAIN_MIN_GRAD_COSINE:
                raise AssertionError(f"{phase}: fused step and unfused step disagree")
        restore = _plain_paths()
        try:
            reset_counts()
            loss_p, aux_p, _, _ = setup.train_step.loss_and_grads(state, check)
            torch.cuda.synchronize()
        finally:
            restore()
        if any(read_counts().values()):
            raise AssertionError(f"the plain {phase} step launched kernels: {read_counts()}")
        cosines = _grad_cosines(params, grads_k)
        gaps = {k: _rel_gap(aux_k[k].item(), aux_p[k].item()) for k in aux_k}
        gaps["loss"] = _rel_gap(loss_k.item(), loss_p.item())
        worst = int(np.argmin(cosines))
        log(f"{train_phase} plain", loss_phase=phase, step=step, batch=check_batch,
            loss_kernel=loss_k.item(), loss_plain=loss_p.item(), components_kernel=json.dumps(
                {k: v.item() for k, v in aux_k.items()}),
            rel_gaps=json.dumps(gaps), rtol=TRAIN_LOSS_RTOL, min_grad_cosine=cosines[worst],
            min_at=names[worst], tensors=len(cosines))
        if max(gaps.values()) > TRAIN_LOSS_RTOL or cosines[worst] < TRAIN_MIN_GRAD_COSINE:
            raise AssertionError(f"{phase}: kernel step and plain step disagree")
        if phase == "warm" and (aux_k["anchor"].item() != 0 or aux_k["lalign"].item() != 0):
            raise AssertionError(f"the warm step is not uniformity alone: {aux_k}")
        del grads_k
    state.step = 0
    del check
    state.optimizer.zero_grad(set_to_none=True)

    # the main path: run_training over the warm and the main epoch, with the
    # eval before training and after each epoch.  The counts are set to 0
    # before each segment (training, eval) and read after it.
    eval_model = make_eval_model(setup.model, config.eval_fp32)
    segments, evals, records = [], [], []

    def eval_fn(st):
        segments.append(("train", read_counts()))
        reset_counts()
        t_eval = time.perf_counter()
        metrics = evaluate_model(eval_model, eval_batches)
        evals.append(dict(step=st.step, metrics=metrics, seconds=time.perf_counter() - t_eval))
        segments.append(("eval", read_counts()))
        reset_counts()
        return metrics

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    state = run_training(setup, lambda epoch: iter([batch] * spe), eval_fn=eval_fn,
                         log_fn=records.append)
    segments.append(("train", read_counts()))
    peak = torch.cuda.max_memory_allocated()
    train_segments = [c for kind, c in segments if kind == "train"]
    eval_segments = [c for kind, c in segments if kind == "eval"]
    expected_train = [zero, {k: v * spe for k, v in warm_step.items()},
                      {k: v * spe for k, v in main_step.items()}, zero]
    if train_segments != expected_train:
        raise AssertionError(f"training launched {train_segments}, expected {expected_train}")
    per_eval = dict(zero, **{k: v * len(eval_batches) for k, v in per_eval_batch.items()})
    if eval_segments != [per_eval] * (EXP6_EPOCHS + 1):
        raise AssertionError(f"evals launched {eval_segments}, expected {per_eval} each")
    step_records = [r for r in records if "train_loss" in r]
    epoch_records = [r for r in records if "step_time_ms" in r]
    losses = np.array([r["train_loss"] for r in step_records])
    if len(step_records) != EXP6_EPOCHS * spe or not np.isfinite(losses).all():
        raise AssertionError(f"losses not finite: {losses}")
    warm_records, main_records = step_records[:spe], step_records[spe:]
    if any(r["anchor"] != 0 for r in warm_records) or any(r["anchor"] <= 0 for r in main_records):
        raise AssertionError("the warm/main switch did not follow the epoch")
    rates = {phase: dict(step_ms=r["step_time_ms"], pairs_per_s=r["pairs_per_sec"])
             for phase, r in zip(("warm", "main"), epoch_records)}
    log(f"{train_phase} train", steps=len(step_records), losses=json.dumps(losses.tolist()),
        components_last=json.dumps({k: main_records[-1][k] for k in ("anchor", "lalign", "lunif")}),
        lr_last=step_records[-1]["learning_rate"], launches_warm=json.dumps(train_segments[1]),
        launches_main=json.dumps(train_segments[2]))
    for phase in ("warm", "main"):
        log(f"{train_phase} rate", loss_phase=phase, step_ms=f"{rates[phase]['step_ms']:.3f}",
            pairs_per_s=f"{rates[phase]['pairs_per_s']:.1f}",
            max_memory_allocated_gib=f"{peak / 2**30:.3f}", card=json.dumps(smi))

    # phase 10: the 13 metrics of every eval, and the last eval against the
    # same eval on the plain attention at the final weights
    # a rank can flip only on a near-tie: each recall may move by two pairs
    recall_atol = 2 * 100 / eval_pairs
    keys = set(evals[0]["metrics"])
    for e in evals:
        if len(keys) != 13 or set(e["metrics"]) != keys or not np.isfinite(
                list(e["metrics"].values())).all():
            raise AssertionError(f"eval at step {e['step']}: {e['metrics']}")
    img_k, txt_k = encode_eval_set(eval_model, eval_batches)
    restore = _plain_paths()
    try:
        reset_counts()
        img_p, txt_p = encode_eval_set(eval_model, eval_batches)
        torch.cuda.synchronize()
    finally:
        restore()
    if any(read_counts().values()):
        raise AssertionError(f"the plain eval launched kernels: {read_counts()}")
    cos = min(torch.nn.functional.cosine_similarity(a, b, dim=-1).min().item()
              for a, b in ((img_k, img_p), (txt_k, txt_p)))
    values_k, values_p = metric_values(img_k, txt_k), metric_values(img_p, txt_p)
    rounded_k, rounded_p = compute_all_metrics(img_k, txt_k), compute_all_metrics(img_p, txt_p)
    geometry_gap = max(abs(values_k[k].item() - values_p[k].item()) for k in GEOMETRY_KEYS)
    recall_gap = max(abs(rounded_k[k] - rounded_p[k]) for k in keys if k not in GEOMETRY_KEYS)
    ranks_moved = sum(int((values_k[k] != values_p[k]).sum()) for k in ("rank_f", "rank_b"))
    log(f"{eval_phase} eval", evals=len(evals), pairs=eval_pairs,
        metrics_first=json.dumps(evals[0]["metrics"]), metrics_last=json.dumps(evals[-1]["metrics"]),
        eval_seconds=json.dumps([round(e["seconds"], 3) for e in evals]),
        launches_each=json.dumps(eval_segments[0]), min_cos_kernel_vs_plain=cos,
        geometry_max_abs_gap=geometry_gap, geometry_atol=EVAL_GEOMETRY_ATOL,
        recall_max_abs_gap=recall_gap, recall_atol=f"{recall_atol:.4f}",
        ranks_moved=ranks_moved, card=json.dumps(smi))
    if cos < EVAL_MIN_COSINE or geometry_gap > EVAL_GEOMETRY_ATOL or recall_gap > recall_atol:
        raise AssertionError("kernel eval and plain-attention eval disagree")
    return dict(train=train_segments[1:3], eval=eval_segments, rates=rates, peak=peak)


def phase_head_group_kernels(smi: str):
    """Phase 11: the route at the ViT-L-14-336 shapes, and the head-group
    kernels against their plain versions at the vision tower's shapes,
    timed beside SDPA and their bound."""
    from sparsify_clip_tpu_torch.ops.attention import (
        mha_bwd_head_group, mha_bwd_head_group_reference, mha_fwd_head_group,
        mha_fwd_head_group_reference, use_head_group,
    )

    routes = {"vision_bf16": use_head_group(577, 3072, 2, 16),
              "vision_fp32": use_head_group(577, 3072, 4, 16),
              "text_bf16": use_head_group(77, 2304, 2, 12)}
    log("phase 11 route", head_group=json.dumps(routes))
    if routes != {"vision_bf16": True, "vision_fp32": True, "text_bf16": False}:
        raise AssertionError(f"ViT-L-14-336 routes {routes}")

    results = {}
    rng = np.random.default_rng(SEED + 4)
    l, heads, head_dim = 577, 16, 64
    width = heads * head_dim

    def normal(shape, dtype):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to("cuda", dtype)

    # fp32 at batch 32 (the shape timed before, kept comparable) and at the eval's 64
    for name, b, causal, dtype in [("vision", 64, False, torch.bfloat16),
                                   ("vision-causal", 64, True, torch.bfloat16),
                                   ("vision-fp32", 32, False, torch.float32),
                                   ("vision-fp32-b64", L336_BATCH, False, torch.float32)]:
        dname = str(dtype).split(".")[1]
        qkv = normal((b, l, 3 * width), dtype)
        got = mha_fwd_head_group(qkv, heads, causal)
        want = mha_fwd_head_group_reference(qkv, heads, causal)
        torch.cuda.synchronize()
        rtol, atol = KERNEL_TOL[dname]
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
        err = (got.float() - want.float()).abs().max().item()
        del got, want
        ms = cuda_ms(lambda: mha_fwd_head_group(qkv, heads, causal), iters=20, warmup=2)
        plain_ms = cuda_ms(lambda: mha_fwd_head_group_reference(qkv, heads, causal), iters=5,
                           warmup=1)
        # yardstick: SDPA's forward, the fastest backend that takes the shape
        sdpa_ms, library = sdpa_fwd_ms(qkv, heads, causal, iters=20, warmup=2)
        library_ms = sdpa_ms[library]
        bound_ms, bound_by = bound(
            b * l * 4 * width * qkv.element_size(),  # qkv read, context written
            2 * 2 * b * heads * attention_pairs(l, causal) * head_dim,  # S and P.V
            dname,
        )
        results[f"mha_fwd_head_group/{name}"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
            library=f"sdpa/{library}", bound_ms=bound_ms, bound_by=bound_by)
        log("phase 11 kernel", kernel="mha_fwd_head_group", case=name, shape=list(qkv.shape),
            heads=heads, causal=causal, dtype=str(dtype), max_abs_err=err, rtol=rtol, atol=atol,
            ms=f"{ms:.5f}", plain_ms=f"{plain_ms:.5f}", library_ms=f"{library_ms:.5f}",
            library=f"sdpa/{library}", sdpa_fwd_ms=json.dumps(sdpa_ms),
            bound_ms=f"{bound_ms:.5f}", bound_by=bound_by, card=json.dumps(smi))
        del qkv

    for name, b, dtype in [("vision", 64, torch.bfloat16), ("vision-fp32", 8, torch.float32)]:
        dname = str(dtype).split(".")[1]
        qkv, dout = normal((b, l, 3 * width), dtype), normal((b, l, width), dtype)
        got = mha_bwd_head_group(qkv, dout, heads)
        want = mha_bwd_head_group_reference(qkv, dout, heads)
        torch.cuda.synchronize()
        if dtype == torch.bfloat16:
            rtol, atol = BWD_TOL[dname]
        else:
            rtol, atol = HG_BWD_FP32_TOL[0], HG_BWD_FP32_TOL[1] * want.abs().max().item()
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
        err = (got.float() - want.float()).abs().max().item()
        del got, want
        ms = cuda_ms(lambda: mha_bwd_head_group(qkv, dout, heads), iters=5, warmup=1)
        plain_ms = cuda_ms(lambda: mha_bwd_head_group_reference(qkv, dout, heads), iters=3,
                           warmup=1)
        # yardstick: SDPA's backward, the fastest backend that takes the shape
        sdpa_ms, library = sdpa_bwd_ms(qkv, dout, heads, False, iters=10, warmup=2)
        library_ms = sdpa_ms[library]
        bound_ms, bound_by = bound(
            b * l * (3 * width * 2 + width) * qkv.element_size(),  # qkv, dout; dqkv
            5 * 2 * b * heads * attention_pairs(l, False) * head_dim,  # S, dP, dV, dQ, dK
            dname,
        )
        results[f"mha_bwd_head_group/{name}"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
            library=f"sdpa/{library}", bound_ms=bound_ms, bound_by=bound_by)
        log("phase 11 kernel", kernel="mha_bwd_head_group", case=name, shape=list(qkv.shape),
            heads=heads, causal=False, dtype=str(dtype), max_abs_err=err, rtol=rtol,
            atol=f"{atol:.3g}", ms=f"{ms:.5f}", plain_ms=f"{plain_ms:.5f}",
            library_ms=f"{library_ms:.5f}", library=f"sdpa/{library}",
            sdpa_bwd_ms=json.dumps(sdpa_ms), bound_ms=f"{bound_ms:.5f}", bound_by=bound_by,
            card=json.dumps(smi))
        del qkv, dout
    return results


def phase_ln_qkv_kernels(smi: str):
    """Phase 15: the fused LN+qkv kernel and the backward's LayerNorm
    kernel against their plain versions at the ViT-L-14-336 batch-64
    shapes, timed beside their library yardsticks and their bound."""
    from sparsify_clip_tpu_torch.ops.ln_qkv import (
        ln_fast_bwd, ln_fast_bwd_reference, ln_qkv_fwd, ln_qkv_reference, row_stats_reference,
    )

    F = torch.nn.functional
    eps = 1e-5
    results = {}
    rng = np.random.default_rng(SEED + 5)

    def normal(shape, std=1.0):
        return torch.from_numpy((std * rng.standard_normal(shape)).astype(np.float32)).cuda()

    for name, n, w, dtype in [("vision", 64 * 577, 1024, torch.bfloat16),
                              ("text", 64 * 77, 768, torch.bfloat16),
                              ("vision-fp32", 64 * 577, 1024, torch.float32),
                              ("wide-ragged", 1000, 1664, torch.bfloat16)]:
        dname = str(dtype).split(".")[1]
        # a training model's operands: x in the compute type, fp32 parameters
        x = normal((n, w)).to(dtype)
        scale, bias = 1 + normal((w,), 0.1), normal((w,), 0.1)
        weight, kbias = normal((3 * w, w), w ** -0.5), normal((3 * w,), 0.1)
        args = (x, scale, bias, weight, kbias, eps, dtype)
        got, want = ln_qkv_fwd(*args), ln_qkv_reference(*args)
        torch.cuda.synchronize()
        # KERNEL_TOL: bf16 rounds the product and then the bias sum, each
        # at most one step apart; fp32 sums W terms in another order
        rtol, atol = KERNEL_TOL[dname]
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
        err = (got.float() - want.float()).abs().max().item()
        if not torch.equal(got, ln_qkv_fwd(*args)):
            raise AssertionError(f"ln_qkv_fwd/{name}: two runs differ")
        del got, want
        slow = dtype == torch.float32
        ms = cuda_ms(lambda: ln_qkv_fwd(*args), iters=5 if slow else 20, warmup=2)
        plain_ms = cuda_ms(lambda: ln_qkv_reference(*args), iters=5 if slow else 20, warmup=2)
        # yardstick: the unfused pair, two library calls, on operands cast
        # to the compute type beforehand
        sc, bi, wt, kb = (t.to(dtype) for t in (scale, bias, weight, kbias))
        library_ms = cuda_ms(lambda: F.linear(F.layer_norm(x, (w,), sc, bi, eps), wt, kb),
                             iters=5 if slow else 20, warmup=2)
        item = x.element_size()
        bound_ms, bound_by = bound(
            (n * w + 3 * w * w + 3 * w + n * 3 * w) * item + 2 * w * 4,  # x, W, b; out; LN fp32
            2 * n * w * 3 * w,
            dname,
        )
        results[f"ln_qkv_fwd/{name}"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                             library_ms=library_ms, bound_ms=bound_ms,
                                             bound_by=bound_by,
                                             library="F.linear(F.layer_norm(x)), two calls")
        log("phase 15 kernel", kernel="ln_qkv_fwd", case=name, shape=[n, w, 3 * w],
            dtype=str(dtype), max_abs_err=err, rtol=rtol, atol=atol, ms=f"{ms:.5f}",
            plain_ms=f"{plain_ms:.5f}", library_ms=f"{library_ms:.5f}",
            library="F.linear(F.layer_norm(x)), two calls", bound_ms=f"{bound_ms:.5f}",
            bound_by=bound_by, card=json.dumps(smi))
        del x, args, weight, wt

    # the backward's LayerNorm: from x and dy = g.W, y again, dx, dscale, dbias
    for name, n, w, dtype in [("vision", 64 * 577, 1024, torch.bfloat16),
                              ("text", 64 * 77, 768, torch.bfloat16),
                              ("vision-fp32", 64 * 577, 1024, torch.float32)]:
        dname = str(dtype).split(".")[1]
        x, dy = normal((n, w)).to(dtype), normal((n, w)).to(dtype)
        scale, bias = 1 + normal((w,), 0.1), normal((w,), 0.1)
        args = (x, dy, scale, bias, eps, dtype)
        got, want = ln_fast_bwd(*args), ln_fast_bwd_reference(*args)
        torch.cuda.synchronize()
        errs = {}
        for part, a, b in zip(("y", "dx", "dscale", "dbias"), got, want):
            big = b.float().abs().max().item()
            if part in ("y", "dx"):
                tol = dict(rtol=LN_BWD_STEP[dname], atol=LN_BWD_CANCEL * big)
            else:
                tol = dict(rtol=LN_BWD_GRAD_TOL[0], atol=LN_BWD_GRAD_TOL[1] * big)
            torch.testing.assert_close(a.float(), b.float(), msg=f"ln_fast_bwd/{name} {part}",
                                       **tol)
            errs[part] = (a.float() - b.float()).abs().max().item()
        if not all(torch.equal(a, b) for a, b in zip(got, ln_fast_bwd(*args))):
            raise AssertionError(f"ln_fast_bwd/{name}: two runs differ")
        del got, want
        ms = cuda_ms(lambda: ln_fast_bwd(*args), iters=20, warmup=2)
        plain_ms = cuda_ms(lambda: ln_fast_bwd_reference(*args), iters=5, warmup=2)
        # yardstick: LayerNorm's backward fed the fast-variance statistics,
        # and y's recompute, two library calls on operands in the compute type
        sc, bi = scale.to(dtype), bias.to(dtype)
        _, m0, _ = torch.native_layer_norm(x, [w], sc, bi, eps)  # the statistics' type and shape
        stats = row_stats_reference(x, eps).to(m0.dtype)
        mean, rstd = stats[:, :1].reshape(m0.shape), stats[:, 1:].reshape(m0.shape)
        del m0

        def library():
            torch.ops.aten.native_layer_norm_backward(dy, x, [w], mean, rstd, sc, bi,
                                                      [True, True, True])
            F.layer_norm(x, (w,), sc, bi, eps)

        library_ms = cuda_ms(library, iters=20, warmup=2)
        item = x.element_size()
        bound_ms, bound_by = bound(
            4 * n * w * item + 4 * w * 4,  # x, dy read; y, dx written; scale, bias; dscale, dbias
            14 * n * w,  # x̂, y, dŷ, dx and the four sums, a few operations an element
            dname,
        )
        results[f"ln_fast_bwd/{name}"] = dict(
            max_abs_err=errs["dx"], ms=ms, plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=bound_ms, bound_by=bound_by,
            library="native_layer_norm_backward + F.layer_norm, two calls")
        log("phase 15 kernel", kernel="ln_fast_bwd", case=name, shape=[n, w], dtype=str(dtype),
            max_abs_err=json.dumps(errs), ms=f"{ms:.5f}", plain_ms=f"{plain_ms:.5f}",
            library_ms=f"{library_ms:.5f}",
            library="native_layer_norm_backward + F.layer_norm, two calls",
            bound_ms=f"{bound_ms:.5f}", bound_by=bound_by, card=json.dumps(smi))
        del x, dy, args, stats, mean, rstd
    return results


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

    serve = phase_serve(model, "phase 4 serve", N_IMAGES, N_TOKENS, MAX_BATCH,
                        per_batch={"image": {"mha_fwd": 12}, "tokens": {"mha_fwd": 12}})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    stats = serve["stats"]
    log("phase 5 rate", requests_per_s=f"{stats.requests / serve['wall']:.1f}",
        wall_s=f"{serve['wall']:.3f}", p50_ms=f"{stats.latency_p50_ms:.3f}",
        p99_ms=f"{stats.latency_p99_ms:.3f}", card=json.dumps(smi))
    del model
    torch.cuda.empty_cache()

    train_kernels = phase_train_kernels()
    train = phase_train()
    log("phase 7 rate", step_ms=f"{train['step_ms']:.3f}",
        pairs_per_s=f"{TRAIN_BATCH / (train['step_ms'] / 1e3):.1f}",
        max_memory_allocated_gib=f"{train['peak'] / 2**30:.3f}", card=json.dumps(smi))
    torch.cuda.empty_cache()

    lunif_kernels = phase_lunif_kernels()
    exp6 = phase_exp6(
        smi, "ViT-B-32", (9, 10), TRAIN_BATCH, TRAIN_BATCH, EXP6_STEPS_PER_EPOCH, EVAL_PAIRS,
        warm_step=dict(mha_fwd=24, mha_bwd=24, lunif_fwd=2, lunif_bwd=2),
        main_step=dict(mha_fwd=24, mha_bwd=24, infonce_fwd=1, infonce_bwd_dimg=1,
                       infonce_bwd_dtxt=1, lunif_fwd=1, lunif_bwd=1),
        per_eval_batch=dict(mha_fwd=24))
    torch.cuda.empty_cache()

    head_group = phase_head_group_kernels(smi)
    torch.cuda.empty_cache()
    t = time.perf_counter()
    model = create_model(L336, dtype=torch.bfloat16, device="cuda", seed=SEED)
    torch.cuda.synchronize()
    log("phase 12 model", ok=True, name=model.cfg.name, dtype=str(model.dtype),
        params=sum(p.numel() for p in model.parameters()),
        seconds=f"{time.perf_counter() - t:.3f}")
    # vision: 577 tokens, the head-group route; text: 77, the whole-width one
    serve_l336 = phase_serve(model, "phase 12 serve", L336_REQUESTS, L336_REQUESTS,
                             L336_MAX_BATCH, per_batch={"image": {"mha_fwd_head_group": 24},
                                                        "tokens": {"mha_fwd": 12}})
    stats = serve_l336["stats"]
    log("phase 12 rate", requests_per_s=f"{stats.requests / serve_l336['wall']:.1f}",
        wall_s=f"{serve_l336['wall']:.3f}", p50_ms=f"{stats.latency_p50_ms:.3f}",
        p99_ms=f"{stats.latency_p99_ms:.3f}", card=json.dumps(smi))
    del model
    torch.cuda.empty_cache()

    attention = dict(mha_fwd_head_group=24, mha_bwd_head_group=24, mha_fwd=12, mha_bwd=12)
    exp6_l336 = phase_exp6(
        smi, L336, (13, 14), L336_BATCH, L336_CHECK_BATCH, L336_STEPS_PER_EPOCH, L336_EVAL_PAIRS,
        warm_step=dict(attention, lunif_fwd=2, lunif_bwd=2),
        main_step=dict(attention, infonce_fwd=1, infonce_bwd_dimg=1, infonce_bwd_dtxt=1,
                       lunif_fwd=1, lunif_bwd=1),
        per_eval_batch=dict(mha_fwd_head_group=24, mha_fwd=12))
    torch.cuda.empty_cache()

    ln_qkv = phase_ln_qkv_kernels(smi)
    torch.cuda.empty_cache()
    # 24 vision and 12 text blocks each run the fused LN+qkv once a forward
    # and its LayerNorm backward once a backward
    fused = dict(attention, ln_qkv_fwd=36, ln_fast_bwd=36)
    exp6_fused = phase_exp6(
        smi, L336, (16, 17), L336_BATCH, L336_CHECK_BATCH, L336_STEPS_PER_EPOCH, L336_EVAL_PAIRS,
        warm_step=dict(fused, lunif_fwd=2, lunif_bwd=2),
        main_step=dict(fused, infonce_fwd=1, infonce_bwd_dimg=1, infonce_bwd_dtxt=1,
                       lunif_fwd=1, lunif_bwd=1),
        per_eval_batch=dict(mha_fwd_head_group=24, mha_fwd=12, ln_qkv_fwd=36),
        overrides=dict(fused_ln_qkv=True))

    sources = {
        "mha_fwd": ("ops/csrc/mha_fwd.cu", "sparsify_clip_tpu/ops/pallas_attention.py:67",
                    kernel["vision"]),
        "mha_bwd": ("ops/csrc/mha_bwd.cu", "sparsify_clip_tpu/ops/pallas_attention.py:95",
                    train_kernels["mha_bwd/vision"]),
        "infonce_fwd": ("ops/csrc/infonce.cu", "sparsify_clip_tpu/ops/pallas_infonce.py:64",
                        train_kernels["infonce_fwd/256"]),
        "infonce_bwd_dimg": ("ops/csrc/infonce.cu",
                             "sparsify_clip_tpu/ops/pallas_infonce.py:185",
                             train_kernels["infonce_bwd_dimg/256"]),
        "infonce_bwd_dtxt": ("ops/csrc/infonce.cu",
                             "sparsify_clip_tpu/ops/pallas_infonce.py:222",
                             train_kernels["infonce_bwd_dtxt/256"]),
        "lunif_fwd": ("ops/csrc/lunif.cu", "sparsify_clip_tpu/ops/pallas_lunif.py:41",
                      lunif_kernels["lunif_fwd/256"]),
        "lunif_bwd": ("ops/csrc/lunif.cu", "sparsify_clip_tpu/ops/pallas_lunif.py:91",
                      lunif_kernels["lunif_bwd/256"]),
        "mha_fwd_head_group": ("ops/csrc/mha_fwd.cu",
                               "sparsify_clip_tpu/ops/pallas_attention.py:204",
                               head_group["mha_fwd_head_group/vision"]),
        "mha_bwd_head_group": ("ops/csrc/mha_head_group.cu",
                               "sparsify_clip_tpu/ops/pallas_attention.py:228",
                               head_group["mha_bwd_head_group/vision"]),
        "ln_qkv_fwd": ("ops/csrc/ln_qkv.cu", "sparsify_clip_tpu/ops/pallas_ln_qkv.py:55",
                       ln_qkv["ln_qkv_fwd/vision"]),
        "ln_qkv_fwd/fp32": ("ops/csrc/ln_qkv.cu", "sparsify_clip_tpu/ops/pallas_ln_qkv.py:55",
                            ln_qkv["ln_qkv_fwd/vision-fp32"]),
        "ln_fast_bwd": ("ops/csrc/ln_qkv.cu",
                        "sparsify_clip_tpu/ops/pallas_ln_qkv.py:135 _vjp_bwd (XLA vjp of the "
                        "twin, no pallas_call)", ln_qkv["ln_fast_bwd/vision"]),
    }
    # the fused LN+qkv runs in bf16 on the train paths and in fp32 (the twin)
    # on the eval paths: each case counts its own paths' launches
    counted = {"ln_qkv_fwd": ("ln_qkv_fwd", lambda path: not path.startswith("eval")),
               "ln_qkv_fwd/fp32": ("ln_qkv_fwd", lambda path: path.startswith("eval"))}
    entries = []
    for name in (*KERNELS[:KERNELS.index("ln_qkv_fwd") + 1], "ln_qkv_fwd/fp32",
                 *KERNELS[KERNELS.index("ln_qkv_fwd") + 1:]):
        source, replaces, r = sources[name]
        counter, on_path = counted.get(name, (name, lambda path: True))
        by_path = {
            "train": train["launches"][counter],
            "train_exp6": sum(c[counter] for c in exp6["train"]),
            "eval": sum(c[counter] for c in exp6["eval"]),
            "serve": serve["launches"][counter],
            "train_exp6_l336": sum(c[counter] for c in exp6_l336["train"]),
            "eval_l336": sum(c[counter] for c in exp6_l336["eval"]),
            "serve_l336": serve_l336["launches"][counter],
            "train_exp6_l336_fused": sum(c[counter] for c in exp6_fused["train"]),
            "eval_l336_fused": sum(c[counter] for c in exp6_fused["eval"]),
        }
        by_path = {path: count for path, count in by_path.items() if on_path(path)}
        entries.append({
            "name": name,
            "route": "cuda",
            "source": f"sparsify_clip_tpu_torch/{source}",
            "replaces": replaces,
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "device_ms": r.get("device_ms"),
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "library": r.get("library"),
        })
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
