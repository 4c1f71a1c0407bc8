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
captions equal the JAX loader's whatever the thread schedule.

``image_backend``: ``"pil"`` decodes through PIL and transforms in numpy
(:mod:`sparsify_clip_tpu_torch.data.transforms`); ``"native"`` decodes a
JPEG and crops, resizes, flips and normalizes it in one C++ call
(:mod:`sparsify_clip_tpu_torch.data.native_imaging`) and raises where that
library cannot be built; ``"auto"`` takes the native library where it
builds, else the PIL route, as the JAX loader does.  Both routes draw the
crop, the flip and the caption from the same stream in the same order,
so the backend never changes the data order, only the resize's
arithmetic (about 1/255).  An item the native route cannot take (a
dataset without ``raw_bytes``, a non-JPEG file) takes the PIL route.
``image_backend_taken`` says which route the loader holds.

``process_count > 1`` (data parallelism over processes): this process
loads only its contiguous ``batch_size // process_count`` slice of every
global batch.  The epoch order and every per-item draw are keyed by
(seed, epoch, global index), so the union of the processes' slices is
the single-process epoch to the bit.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from sparsify_clip_tpu_torch.data.transforms import (
    resize_bilinear, sample_resized_crop_params, test_transform, train_transform,
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
        image_backend: str = "pil",
        process_index: int = 0,
        process_count: int = 1,
    ):
        """``raw_uint8``: skip the host augmentation; squash-resize each
        decoded image to ``image_size`` (Pillow's bilinear, to the bit, on
        the PIL route) and ship uint8.  ``process_index`` of
        ``process_count``: the slice of every global batch this process
        loads (the JAX loader's checks and messages)."""
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
        if process_count > 1 and batch_size % process_count:
            raise ValueError(
                f"batch_size {batch_size} not divisible by "
                f"{process_count} processes (ragged per-host batches "
                "would deadlock collectives)"
            )
        if not 0 <= process_index < process_count:
            raise ValueError(
                f"process_index {process_index} out of range for "
                f"process_count {process_count}"
            )
        if process_count > 1 and not drop_last:
            raise ValueError(
                "process_count > 1 requires drop_last=True (a ragged "
                "final batch cannot split evenly across processes)"
            )
        self.process_index = process_index
        self.process_count = process_count
        self._native = None
        if image_backend in ("native", "auto"):
            from sparsify_clip_tpu_torch.data import native_imaging

            self._native = native_imaging.get_pipeline()
            if self._native is None and image_backend == "native":
                error = native_imaging.build_error()
                raise RuntimeError(f"image_backend='native' but {error}") from error
        # native where the library loaded and the dataset hands out JPEG bytes
        self.image_backend_taken = ("native" if self._native is not None
                                    and hasattr(dataset, "raw_bytes") else "pil")
        self.tokenizer_backend = getattr(tokenizer, "backend", type(tokenizer).__name__)
        self._pool = None
        if self.num_threads > 1:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(max_workers=self.num_threads)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _item_rng(self, index: int, epoch: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch, index, int(self.train)]))

    def _load_item(self, index: int, epoch: int):
        rng = self._item_rng(index, epoch)
        if self._native is not None:
            item = self._load_item_native(index, rng)
            if item is not None:
                return item
            # a fresh stream: a failed native attempt may have drawn from it
            rng = self._item_rng(index, epoch)
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

    def _load_item_native(self, index: int, rng: np.random.Generator):
        """The C++ decode and transform.  Draws from ``rng`` in the PIL
        route's order (crop, flip, caption); None sends the item to the
        PIL route (no raw bytes, or a file the library cannot decode)."""
        raw = getattr(self.dataset, "raw_bytes", None)
        if raw is None:
            return None
        jpeg = raw(index)
        if jpeg is None:
            return None
        try:
            if self.raw_uint8:
                arr = self._native.transform(jpeg, self.image_size, uint8=True)
            elif self.train:
                h, w = self._native.dims(jpeg)
                top, left, ch, cw = sample_resized_crop_params(h, w, rng)
                flip = rng.random() < 0.5
                arr = self._native.transform(jpeg, self.image_size, crop=(top, left, ch, cw),
                                             flip=flip)
            else:
                arr = self._native.transform(jpeg, self.image_size)
        except ValueError:
            return None
        captions = self._captions_of(index)
        caption = captions[int(rng.integers(0, len(captions)))] if captions else ""
        return arr, caption

    def _captions_of(self, index: int):
        """An item's captions without decoding its image."""
        ds = self.dataset
        while hasattr(ds, "indices"):  # a Subset chain
            index, ds = ds.indices[index], ds.dataset
        if hasattr(ds, "index"):  # CocoCaptions
            return ds.index.captions[index]
        return ds[index][1]

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
        if self.process_count > 1:
            # this process's contiguous slice of every global batch
            local = self.batch_size // self.process_count
            lo = self.process_index * local
            batches = [idx[lo:lo + local] for idx in batches]
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
