"""The ``loader_backend: "grain"`` route, ported from
:mod:`sparsify_clip_tpu.data.grain_loader` onto
``torch.utils.data.DataLoader`` worker processes (``grain`` is not a
dependency of the port).

Items are the JAX ``_DecodeTransform``'s to the bit: the stream
``SeedSequence([seed + epoch, index, train])`` (not the thread loader's
``[seed, epoch, index, train]``), the host train or test transform at
``image_size``, one caption drawn from the stream, then tokenized.  A
batch holds float32 ``images``, int32 ``tokens`` and ``captions`` blanked
to ``""``, as the JAX route ships them.

The epoch order is a permutation drawn from the seed
``SeedSequence([seed, epoch]).generate_state(1)[0]``, the seed the JAX
route gives grain's ``IndexSampler``.  grain's own shuffle cannot be
reproduced without grain, so the order differs from the JAX route's; the
rows of a whole epoch are the same multiset
(``tests/test_torch_port_grain.py``).

``num_workers > 0`` runs the items in that many ``spawn`` worker
processes: the dataset and the tokenizer are pickled to each (the native
tokenizer rebuilds its library handle there), and the workers touch no
CUDA.  A batch comes back as shared-memory tensors and leaves as numpy.
The pipeline passes no worker count, as the JAX pipeline passes none.

``device_augment`` does not change what this route ships: the JAX
pipeline returns the grain loaders before its ``device_augment`` branch,
and the JAX step then augments these float32, already normalized images
as if they were pixels (divided by 255, cropped, flipped, normalized
again).  The port's step does the same
(:func:`sparsify_clip_tpu_torch.ops.image.augment_batch`).
"""

from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np

from sparsify_clip_tpu_torch.data.transforms import test_transform, train_transform


class _DecodeTransform:
    """(index, image, captions) → a batchable dict, the JAX transform's."""

    def __init__(self, tokenizer, train: bool, seed: int, image_size: int):
        self.tokenizer = tokenizer
        self.train = train
        self.seed = seed
        self.image_size = image_size

    def __call__(self, record):
        index, img, captions = record
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, index, int(self.train)]))
        if self.train:
            arr = train_transform(img, rng, self.image_size)
        else:
            arr = test_transform(img, self.image_size)
        caption = captions[int(rng.integers(0, len(captions)))] if captions else ""
        tokens = self.tokenizer([caption])[0]
        return {"images": arr.astype(np.float32), "tokens": tokens}


class _Items:
    """A map-style dataset of one epoch's decoded items."""

    def __init__(self, dataset, transform: _DecodeTransform):
        self.dataset = dataset
        self.transform = transform

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, i: int):
        img, captions = self.dataset[int(i)]
        return self.transform((int(i), img, captions))


def _collate(items: List[dict]):
    """Stacked tensors: the worker hands them over in shared memory."""
    import torch

    return {"images": torch.from_numpy(np.stack([it["images"] for it in items])),
            "tokens": torch.from_numpy(np.stack([it["tokens"] for it in items]))}


class GrainDataLoader:
    """The JAX ``GrainDataLoader``'s interface on torch's DataLoader."""

    image_backend_taken = "pil"  # the host transforms, as the JAX route

    def __init__(
        self,
        dataset,
        batch_size: int,
        tokenizer,
        train: bool,
        seed: int = 42,
        shuffle=None,
        drop_last: bool = True,
        num_workers: int = 0,
        image_size: int = 224,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.tokenizer = tokenizer
        self.train = train
        self.seed = seed
        self.shuffle = train if shuffle is None else shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.image_size = image_size
        self.tokenizer_backend = getattr(tokenizer, "backend", type(tokenizer).__name__)

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batches(self, epoch: int) -> List[np.ndarray]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            seed = int(np.random.SeedSequence([self.seed, epoch]).generate_state(1)[0])
            order = np.random.default_rng(seed).permutation(n)
        return [order[i:i + self.batch_size] for i in range(0, len(self) * self.batch_size,
                                                             self.batch_size)]

    def epoch(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        from torch.utils.data import DataLoader

        items = _Items(self.dataset, _DecodeTransform(self.tokenizer, self.train,
                                                      self.seed + epoch, self.image_size))
        loader = DataLoader(
            items, batch_sampler=[b.tolist() for b in self._batches(epoch)],
            num_workers=self.num_workers, collate_fn=_collate,
            multiprocessing_context="spawn" if self.num_workers > 0 else None)
        for batch in loader:
            images = batch["images"].numpy()
            yield {"images": images, "tokens": batch["tokens"].numpy(),
                   "captions": [""] * images.shape[0]}

    def __iter__(self):
        return self.epoch(0)
