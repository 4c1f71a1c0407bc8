"""Synthetic data: the procedural image-caption set of
:mod:`sparsify_clip_tpu.data.synthetic`, and a CLIP-shaped random batch.

* :class:`SyntheticCaptions` yields (image, captions) with real caption
  strings, so the tokenizer runs; its images are the JAX set's uint8
  arrays, returned as arrays where the JAX set wraps them in a PIL image.
* :func:`synthetic_batch` is a copy of ``scripts/_bench.py::synthetic_batch``
  (the batch every JAX bench feeds the train step), for the profile
  scripts and ``chip_smoke.py``.

The JAX module's ``write_coco_fixture`` (JPEG files) is not ported: the
tests make their fixtures with it.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

_OBJECTS = [
    "cat", "dog", "surfboard", "pizza", "bicycle", "giraffe", "kite",
    "train", "umbrella", "sandwich", "bench", "clock",
]
_VERBS = ["sitting on", "riding", "holding", "next to", "jumping over", "eating"]
_PLACES = ["a beach", "the street", "a table", "the park", "a field", "snow"]


def make_caption(rng: np.random.Generator) -> str:
    return (
        f"a {_OBJECTS[rng.integers(len(_OBJECTS))]} "
        f"{_VERBS[rng.integers(len(_VERBS))]} "
        f"{_PLACES[rng.integers(len(_PLACES))]}"
    )


def make_image(rng: np.random.Generator, size: int = 64) -> np.ndarray:
    """Structured noise (colored gradient + blobs) so crops differ:
    (size, size, 3) uint8."""
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / size
    base = np.stack(
        [
            0.5 + 0.5 * np.sin(2 * np.pi * (x * rng.uniform(1, 3) + rng.random())),
            0.5 + 0.5 * np.cos(2 * np.pi * (y * rng.uniform(1, 3) + rng.random())),
            rng.random() * np.ones_like(x),
        ],
        axis=-1,
    )
    noise = rng.random((size, size, 3)).astype(np.float32) * 0.3
    arr = np.clip(base * 0.7 + noise, 0, 1)
    return (arr * 255).astype(np.uint8)


class SyntheticCaptions:
    """In-memory dataset with the CocoCaptions item interface."""

    def __init__(self, num_samples: int = 256, seed: int = 0, image_size: int = 64,
                 captions_per_image: int = 5):
        self.num_samples = num_samples
        self.seed = seed
        self.image_size = image_size
        self.captions_per_image = captions_per_image

    def __len__(self) -> int:
        return self.num_samples

    def __getitem__(self, i: int) -> Tuple[np.ndarray, List[str]]:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, i]))
        img = make_image(rng, self.image_size)
        captions = [make_caption(rng) for _ in range(self.captions_per_image)]
        return img, captions


def synthetic_batch(batch: int, image_size: int, context: int = 77,
                    seed: int = 0) -> Dict[str, np.ndarray]:
    """{"images": (B, S, S, 3) fp32 N(0, 1), "tokens": (B, context) int32}
    with SOT (49406) first, EOT (49407) last and random ids between."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, 49000, size=(batch, context)).astype(np.int32)
    tokens[:, 0], tokens[:, -1] = 49406, 49407
    images = rng.standard_normal((batch, image_size, image_size, 3))
    return {"images": images.astype(np.float32), "tokens": tokens}
