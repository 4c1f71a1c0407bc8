#!/usr/bin/env python3
"""Where the port's host data path spends its time: the CLI's loader for
``dataset: synthetic`` at ViT-B-32's 224 px and batch 256.

    python3 scripts/profile_torch_loader.py [--batches 4] [--out FILE]

Host work only (no CUDA needed); run it on the machine whose host feeds
the card.  It times, on one thread, each part of one item (the synthetic
image, the crop sample + bilinear resize to 224, to-float + flip +
normalize, the caption draw) and the BPE of a batch's 256 captions; then
the loader's ms a batch (``DataLoader.epoch``, prefetch included) at 1,
2, 4 and 8 worker threads, each in a child process, once as the
environment sets BLAS threading and once with ``OPENBLAS_NUM_THREADS=1``
and ``OMP_NUM_THREADS=1`` (numpy's matrix products in each worker on one
thread).  Then the grain route (``loader_backend: grain``,
``data/grain_loader.py``) at 0 (in process), 1, 2, 4 and 8 worker
processes, each in a child process with one BLAS thread, and the native
tokenizer's ms for the same 256 captions beside the Python one's (where
``g++`` builds it).  Prints one JSON object, with ``nvidia-smi``'s card
name and power limit when there is a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CONFIG = dict(dataset="synthetic", model="ViT-B-32", batch_size=256, seed=42,
              num_train_samples=2048, num_test_samples=512)


def loader_ms(threads: int, batches: int, grain: bool = False) -> float:
    """ms a batch of the train loader at ``threads`` workers (threads, or
    with ``grain`` worker processes), after one batch of warm-up (the
    tokenizer's tables, the resize coefficients, the workers' start)."""
    from sparsify_clip_tpu_torch.config import ExperimentConfig
    from sparsify_clip_tpu_torch.data import dataset_loader

    config = ExperimentConfig.from_dict(dict(CONFIG, num_train_samples=256 * (batches + 1),
                                             loader_backend="grain" if grain else "threads"))
    loader, _ = dataset_loader(config, image_size=224, num_threads=threads)
    if grain:
        loader.num_workers = threads
    it = loader.epoch(0)
    next(it)
    t = time.perf_counter()
    n = sum(1 for _ in it)
    return (time.perf_counter() - t) / n * 1e3


def parts_ms(items: int = 64) -> dict:
    import numpy as np

    from sparsify_clip_tpu_torch.data import transforms
    from sparsify_clip_tpu_torch.data.synthetic import SyntheticCaptions
    from sparsify_clip_tpu_torch.text import get_tokenizer

    ds = SyntheticCaptions(items, seed=1)
    rng = np.random.default_rng(0)
    ds[0]
    t = time.perf_counter()
    data = [ds[i] for i in range(items)]
    item_ms = (time.perf_counter() - t) / items * 1e3
    crops = []
    t = time.perf_counter()
    for img, _ in data:
        top, left, h, w = transforms.sample_resized_crop_params(*img.shape[:2], rng)
        crops.append(transforms.resize_bilinear(img[top:top + h, left:left + w], (224, 224)))
    resize_ms = (time.perf_counter() - t) / items * 1e3
    t = time.perf_counter()
    for crop in crops:
        arr = transforms.to_float(crop)
        if rng.random() < 0.5:
            arr = arr[:, ::-1, :]
        transforms.normalize(arr)
    normalize_ms = (time.perf_counter() - t) / items * 1e3
    tok = get_tokenizer(CONFIG["model"])
    captions = [caps[int(rng.integers(0, len(caps)))] for _, caps in data] * (256 // items)
    tok(captions)  # the pattern's tables and the BPE cache
    t = time.perf_counter()
    tok(captions)
    tokenize_ms = (time.perf_counter() - t) * 1e3
    # the tokenizer's parts over the same 256 captions
    from sparsify_clip_tpu_torch.text import tokenizer as text

    def batch_ms(fn, texts):
        t = time.perf_counter()
        out = [fn(x) for x in texts]
        return (time.perf_counter() - t) * 1e3, out

    basic, cleaned = batch_ms(text._basic_clean, captions)
    space, spaced = batch_ms(lambda x: text._whitespace_clean(x).lower(), cleaned)
    split, pieces = batch_ms(text.pre_tokenize, spaced)
    bpe, _ = batch_ms(lambda ps: [tok.bpe("".join(tok.byte_encoder[b] for b in p.encode()))
                                  for p in ps], pieces)
    native_ms = None
    from sparsify_clip_tpu_torch.text import native

    if native.ensure_built() is not None:
        fast = native.NativeCLIPTokenizer()
        if not (fast(captions) == tok(captions)).all():
            raise AssertionError("the native tokenizer differs from the Python one")
        t = time.perf_counter()
        fast(captions)
        native_ms = (time.perf_counter() - t) * 1e3
    return dict(item_ms=item_ms, crop_resize_ms=resize_ms, float_flip_normalize_ms=normalize_ms,
                tokenize_batch_ms=tokenize_ms, native_tokenize_batch_ms=native_ms,
                tokenize_parts_batch_ms=dict(
                    basic_clean=basic, whitespace_clean_lower=space, pre_tokenize=split,
                    bytes_and_bpe=bpe))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--out", default=None)
    ap.add_argument("--parts-only", action="store_true", help="skip the loader runs")
    ap.add_argument("--child", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--grain", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        print(json.dumps(loader_ms(args.child, args.batches, grain=args.grain)))
        return 0

    import numpy as np

    result = {"cpu_count": os.cpu_count(), "numpy": np.__version__,
              "parts_one_thread": parts_ms(), "loader_ms_per_batch": {}}
    for blas in () if args.parts_only else ("default", "one"):
        env = dict(os.environ)
        if blas == "one":
            env.update(OPENBLAS_NUM_THREADS="1", OMP_NUM_THREADS="1")
        for threads in (1, 2, 4, 8):
            out = subprocess.run([sys.executable, __file__, "--child", str(threads),
                                  "--batches", str(args.batches)], env=env, check=True,
                                 capture_output=True, text=True, timeout=1200)
            result["loader_ms_per_batch"][f"threads={threads},blas={blas}"] = json.loads(
                out.stdout.strip().splitlines()[-1])
    env = dict(os.environ, OPENBLAS_NUM_THREADS="1", OMP_NUM_THREADS="1")
    for workers in () if args.parts_only else (0, 1, 2, 4, 8):
        out = subprocess.run([sys.executable, __file__, "--child", str(workers), "--grain",
                              "--batches", str(args.batches)], env=env, check=True,
                             capture_output=True, text=True, timeout=1200)
        result["loader_ms_per_batch"][f"grain,workers={workers},blas=one"] = json.loads(
            out.stdout.strip().splitlines()[-1])
    try:
        result["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        result["card"] = None
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
