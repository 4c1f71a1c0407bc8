"""Batch embedding export, ported from :mod:`sparsify_clip_tpu.encode`:
a trained checkpoint → L2-normalized embeddings for downstream retrieval
and serving.

    python -m sparsify_clip_tpu_torch.encode \\
        --model RN50 --weights models/run.npz \\
        --images data/coco/images/val2017 --texts captions.txt \\
        --out embeddings.npz [--device cuda|cpu]

Writes an ``.npz`` with ``image_embeddings`` (N, D) / ``image_files``
and/or ``text_embeddings`` (M, D) / ``texts``, all L2-normalized fp32,
the JAX CLI's keys, and prints a retrieval smoke: with both modalities,
the top-1 text of the first few images.  The towers compute in bf16 (the
JAX CLI's), on the card unless ``--device cpu``.

Weights: a ``save_weights`` ``.npz`` of either package.  Images take the
eval transform (squash-resize and CLIP normalization): a JPEG through the
native pipeline where its library builds
(:mod:`sparsify_clip_tpu_torch.data.native_imaging`), as the JAX CLI
does, any other file (or a JPEG the library cannot decode) through PIL,
imported at the first decode, and Pillow's bilinear resize, to the bit
(``data/transforms.py``).
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional, Sequence

import numpy as np

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def _list_images(path: str) -> List[str]:
    if os.path.isfile(path):
        return [path]
    return sorted(os.path.join(path, f) for f in os.listdir(path)
                  if f.lower().endswith(IMAGE_EXTS))


def _load_image_batch(paths: Sequence[str], image_size: int) -> np.ndarray:
    """The eval protocol's pixels: decode, squash-resize, normalize, a
    JPEG through the native pipeline where it builds."""
    from sparsify_clip_tpu_torch.data.coco import decode_image
    from sparsify_clip_tpu_torch.data.native_imaging import get_pipeline
    from sparsify_clip_tpu_torch.data.transforms import test_transform

    native = get_pipeline()
    out = np.empty((len(paths), image_size, image_size, 3), np.float32)
    for i, p in enumerate(paths):
        if native is not None and p.lower().endswith((".jpg", ".jpeg")):
            with open(p, "rb") as fh:
                try:
                    out[i] = native.transform(fh.read(), image_size)
                    continue
                except ValueError:
                    pass
        out[i] = test_transform(decode_image(p), image_size)
    return out


def main(argv: Optional[Sequence[str]] = None) -> str:
    ap = argparse.ArgumentParser(description="Export L2-normalized CLIP embeddings to .npz")
    ap.add_argument("--model", default="RN50")
    ap.add_argument("--weights", required=True,
                    help=".npz from save_weights / the periodic checkpoints")
    ap.add_argument("--images", default=None, help="image file or directory (jpg/png/...)")
    ap.add_argument("--texts", default=None, help="text file, one caption per line")
    ap.add_argument("--out", required=True)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--image-size", type=int, default=None)
    ap.add_argument("--bpe-vocab", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if not args.images and not args.texts:
        ap.error("need --images and/or --texts")

    import torch

    from sparsify_clip_tpu_torch.checkpoints import load_weights
    from sparsify_clip_tpu_torch.inference import CLIPEncoder, RetrievalIndex
    from sparsify_clip_tpu_torch.models.clip import create_model
    from sparsify_clip_tpu_torch.text import get_tokenizer

    model = create_model(args.model, dtype=torch.bfloat16, device=args.device,
                         image_size=args.image_size)
    load_weights(model, args.weights)
    encoder = CLIPEncoder(model, get_tokenizer(args.model, bpe_path=args.bpe_vocab))
    image_size = model.cfg.image_size

    payload = {}
    if args.images:
        files = _list_images(args.images)
        chunks = [encoder.encode_images(_load_image_batch(files[i:i + args.batch_size],
                                                          image_size)).cpu().numpy()
                  for i in range(0, len(files), args.batch_size)]
        payload["image_embeddings"] = np.concatenate(chunks, axis=0)
        payload["image_files"] = np.asarray(files)
        print(f"encoded {len(files)} images -> {payload['image_embeddings'].shape}")
    if args.texts:
        with open(args.texts) as fh:
            texts = [line.rstrip("\n") for line in fh if line.strip()]
        chunks = [encoder.encode_texts(texts[i:i + args.batch_size]).cpu().numpy()
                  for i in range(0, len(texts), args.batch_size)]
        payload["text_embeddings"] = np.concatenate(chunks, axis=0)
        payload["texts"] = np.asarray(texts)
        print(f"encoded {len(texts)} texts -> {payload['text_embeddings'].shape}")

    if "image_embeddings" in payload and "text_embeddings" in payload:
        index = RetrievalIndex(payload["text_embeddings"])
        scores, idx = index.search(payload["image_embeddings"][:3], k=1)
        for i in range(idx.shape[0]):
            print(f"image {os.path.basename(str(payload['image_files'][i]))!r} -> "
                  f"text {str(payload['texts'][idx[i, 0]])!r} ({scores[i, 0]:.3f})")

    np.savez(args.out, **payload)
    print(f"wrote {args.out}")
    return args.out


if __name__ == "__main__":
    main()
