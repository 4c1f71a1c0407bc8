"""Threaded prefetching batch loader, ported from
:mod:`sparsify_clip_tpu.data.loader`.

Decode, transform, caption choice and tokenization run in worker
threads (numpy releases the GIL in the resize's matrix products), and
batches are prefetched into a bounded queue so host work overlaps the
device step.  A producer's error is re-raised in the consumer.

Batch schema: ``{"images": (B,S,S,3) f32, "tokens": (B,77) i32,
"captions": list[str]}``; with ``raw_uint8`` the images are (B,S,S,3)
uint8 staging pixels, squash-resized and not augmented (the
``device_augment`` path: :mod:`sparsify_clip_tpu_torch.ops.image` crops,
flips and normalizes them on the card).

Determinism: the epoch order is a permutation drawn from (seed, epoch),
and each item's crop, flip and caption draws from (seed, epoch, index,
train), the JAX loader's streams, so data order, crops, flips and
captions equal the JAX loader's whatever the thread schedule.  One
process loads every batch: the JAX loader's per-process slices
(``process_index``/``process_count``) wait for ROADMAP Queue 1, 'Multi-GPU'.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from sparsify_clip_tpu_torch.data.transforms import (
    resize_bilinear, test_transform, train_transform,
)


class DataLoader:
    """Iterable over prefetched batches for one dataset split."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        tokenizer,
        train: bool,
        seed: int = 42,
        shuffle: Optional[bool] = None,
        drop_last: bool = True,
        num_threads: int = 4,
        prefetch: int = 2,
        image_size: int = 224,
        raw_uint8: bool = False,
    ):
        """``raw_uint8``: skip the host augmentation; squash-resize each
        decoded image to ``image_size`` (Pillow's bilinear, to the bit)
        and ship uint8."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.tokenizer = tokenizer
        self.train = train
        self.seed = seed
        self.shuffle = train if shuffle is None else shuffle
        self.drop_last = drop_last
        self.num_threads = max(1, num_threads)
        self.prefetch = prefetch
        self.image_size = image_size
        self.raw_uint8 = raw_uint8
        self._pool = None
        if self.num_threads > 1:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(max_workers=self.num_threads)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _load_item(self, index: int, epoch: int):
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch, index, int(self.train)])
        )
        img, captions = self.dataset[index]
        if self.raw_uint8:
            arr = resize_bilinear(img, (self.image_size, self.image_size))
        elif self.train:
            arr = train_transform(img, rng, self.image_size)
        else:
            arr = test_transform(img, self.image_size)
        # one random caption out of the ≤5 (sparsify_clip.py:1050-1057)
        caption = captions[int(rng.integers(0, len(captions)))] if captions else ""
        return arr, caption

    def _make_batch(self, indices: np.ndarray, epoch: int) -> Dict[str, np.ndarray]:
        if self._pool is not None and len(indices) > 1:
            items = list(self._pool.map(lambda i: self._load_item(int(i), epoch), indices))
        else:
            items = [self._load_item(int(i), epoch) for i in indices]
        images = np.stack([it[0] for it in items]).astype(
            np.uint8 if self.raw_uint8 else np.float32)
        captions = [it[1] for it in items]
        tokens = self.tokenizer(captions)
        return {"images": images, "tokens": tokens, "captions": captions}

    def epoch(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            order = np.random.default_rng(
                np.random.SeedSequence([self.seed, epoch])
            ).permutation(n)
        nb = len(self)
        batches = [order[i * self.batch_size:(i + 1) * self.batch_size] for i in range(nb)]
        if not batches:
            return

        out: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        error: list = []  # producer exception, re-raised in the consumer

        def _put(item) -> bool:
            # bounded put that stays responsive to abandonment
            while not stop.is_set():
                try:
                    out.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for idx_block in batches:
                    if stop.is_set():
                        return
                    if not _put(self._make_batch(idx_block, epoch)):
                        return
            except Exception as exc:  # decode/tokenize failures must
                error.append(exc)     # surface, not truncate the epoch
            finally:
                _put(None)  # sentinel; skipped when the consumer already stopped

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                batch = out.get()
                if batch is None:
                    break
                yield batch
            if error:
                raise RuntimeError(f"data loader worker failed at epoch {epoch}") from error[0]
        finally:
            stop.set()
            while thread.is_alive():  # drain so the producer can exit
                try:
                    out.get_nowait()
                except queue.Empty:
                    break
            thread.join(timeout=5)

    def __iter__(self):
        return self.epoch(0)
