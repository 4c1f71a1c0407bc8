"""dataset_loader: config → (train_loader, test_loader), ported from
:mod:`sparsify_clip_tpu.data.pipeline`.

COCO train2017/val2017 under ``config.data_root``, head-subsets via
``num_{train,test}_samples``, train shuffled + drop_last, eval ordered +
drop_last (so ``num_test_samples: 512`` at batch 256 yields exactly 2
batches, the reference protocol).  With ``device_augment`` the train
loader ships uint8 staging images at ``device_augment_staging`` and the
train step augments them on the card (ops/image.py).  ``dataset: "synthetic"`` swaps in
the procedural set (2048 train and 512 test samples when the counts are
-1).

The routes fall back as the JAX pipeline's do: ``tokenizer: native``
takes the C++ BPE (:mod:`sparsify_clip_tpu_torch.text.native`) and raises
where it cannot be built, ``auto`` takes it where it builds, else the
Python tokenizer; ``image_backend`` goes to both thread loaders
(:class:`DataLoader`); ``loader_backend: grain`` returns the grain-route
loaders (:mod:`sparsify_clip_tpu_torch.data.grain_loader`) before the
``device_augment`` branch, as the JAX pipeline does.  Each loader names
the routes it took (``tokenizer_backend``, ``image_backend_taken``);
:func:`routes` collects them.

Over a process group of W > 1 ranks each rank's loaders load its slice
of every global batch (``process_index`` / ``process_count``, the JAX
pipeline's multihost slicing); the grain route carries no slicing and is
refused there, as ``multihost: true`` refuses it on both sides
(config.py:400).
"""

from __future__ import annotations

import os
from typing import Dict

from sparsify_clip_tpu_torch.config import ExperimentConfig
from sparsify_clip_tpu_torch.data.coco import CocoCaptions, Subset, require_decoder
from sparsify_clip_tpu_torch.data.loader import DataLoader
from sparsify_clip_tpu_torch.data.synthetic import SyntheticCaptions
from sparsify_clip_tpu_torch.text import get_tokenizer


def _select_tokenizer(config: ExperimentConfig):
    """The JAX ``_select_tokenizer`` (data/pipeline.py:27-36)."""
    if config.tokenizer in ("native", "auto"):
        try:
            from sparsify_clip_tpu_torch.text.native import NativeCLIPTokenizer

            return NativeCLIPTokenizer(merges_path=config.bpe_vocab_path)
        except (RuntimeError, OSError):
            if config.tokenizer == "native":
                raise
    return get_tokenizer(config.model, bpe_path=config.bpe_vocab_path)


def routes(loader) -> Dict[str, str]:
    """The routes a loader took: loader, tokenizer and image backend."""
    from sparsify_clip_tpu_torch.data.grain_loader import GrainDataLoader

    return {"loader": "grain" if isinstance(loader, GrainDataLoader) else "threads",
            "tokenizer": loader.tokenizer_backend, "image": loader.image_backend_taken}


def dataset_loader(config: ExperimentConfig, image_size: int = 224, num_threads: int = 4):
    from sparsify_clip_tpu_torch.parallel.multihost import rank, world_size

    # each data rank loads its slice of every global batch, and the ranks
    # of a model group the same slice (world rank = data rank · model +
    # model rank, parallel/mesh.py); one process, all
    model = max(1, config.mesh_model)
    process_index, process_count = rank() // model, max(1, world_size() // model)
    if process_count > 1 and config.loader_backend == "grain":
        raise ValueError(
            f"loader_backend: grain over {process_count} processes: the grain route carries "
            "no per-process batch slicing; use loader_backend: threads or run single-process")
    tokenizer = _select_tokenizer(config)

    if config.dataset == "synthetic":
        n_train = 2048 if config.num_train_samples == -1 else config.num_train_samples
        n_test = 512 if config.num_test_samples == -1 else config.num_test_samples
        train_ds = SyntheticCaptions(n_train, seed=config.seed)
        test_ds = SyntheticCaptions(n_test, seed=config.seed + 1)
    else:
        if config.image_backend == "pil" or config.loader_backend == "grain":
            require_decoder()
        root = config.data_root
        train_ds = CocoCaptions(
            os.path.join(root, "images", "train2017"),
            os.path.join(root, "annotations", "captions_train2017.json"),
        )
        test_ds = CocoCaptions(
            os.path.join(root, "images", "val2017"),
            os.path.join(root, "annotations", "captions_val2017.json"),
        )
        if config.num_train_samples != -1:
            train_ds = Subset(train_ds, range(config.num_train_samples))
        if config.num_test_samples != -1:
            test_ds = Subset(test_ds, range(config.num_test_samples))

    if config.loader_backend == "grain":
        from sparsify_clip_tpu_torch.data.grain_loader import GrainDataLoader

        train_loader = GrainDataLoader(
            train_ds, config.batch_size, tokenizer, train=True, seed=config.seed,
            shuffle=True, drop_last=True, image_size=image_size,
        )
        test_loader = GrainDataLoader(
            test_ds, config.batch_size, tokenizer, train=False, seed=config.seed,
            shuffle=False, drop_last=True, image_size=image_size,
        )
        return train_loader, test_loader

    train_loader = DataLoader(
        train_ds, config.batch_size, tokenizer, train=True, seed=config.seed,
        shuffle=True, drop_last=True, num_threads=num_threads,
        image_size=config.device_augment_staging if config.device_augment else image_size,
        raw_uint8=config.device_augment, image_backend=config.image_backend,
        process_index=process_index, process_count=process_count,
    )
    test_loader = DataLoader(
        test_ds, config.batch_size, tokenizer, train=False, seed=config.seed,
        shuffle=False, drop_last=True, num_threads=num_threads, image_size=image_size,
        image_backend=config.image_backend,
        process_index=process_index, process_count=process_count,
    )
    return train_loader, test_loader
