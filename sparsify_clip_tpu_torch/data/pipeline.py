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

The JAX pipeline's other routes raise here and name the ROADMAP item
they wait for (see ``_NOT_PORTED``).
"""

from __future__ import annotations

import os
from typing import Callable, List, Tuple

from sparsify_clip_tpu_torch.config import ExperimentConfig
from sparsify_clip_tpu_torch.data.coco import CocoCaptions, Subset, require_decoder
from sparsify_clip_tpu_torch.data.loader import DataLoader
from sparsify_clip_tpu_torch.data.synthetic import SyntheticCaptions
from sparsify_clip_tpu_torch.text import get_tokenizer

# Data-pipeline knobs the port does not run yet → what they wait for.
_NOT_PORTED: List[Tuple[Callable[[ExperimentConfig], bool], str]] = [
    (lambda c: c.tokenizer in ("native", "auto"),
     "tokenizer: native/auto (the C++ BPE of text/native.py, ROADMAP Queue 1, 'Tokenizer')"),
    (lambda c: c.loader_backend == "grain",
     "loader_backend: grain (ROADMAP Queue 1, 'Data without PIL')"),
    (lambda c: c.image_backend in ("native", "auto"),
     "image_backend: native/auto (the native image decoder, "
     "ROADMAP Queue 1, 'Data without PIL')"),
]


def check_supported(config: ExperimentConfig) -> None:
    """Raise :class:`NotImplementedError` for the first data knob the
    port does not run yet."""
    for unsupported, what in _NOT_PORTED:
        if unsupported(config):
            raise NotImplementedError(
                f"{what} is not ported to sparsify_clip_tpu_torch's data pipeline yet"
            )


def dataset_loader(
    config: ExperimentConfig, image_size: int = 224, num_threads: int = 4
) -> Tuple[DataLoader, DataLoader]:
    check_supported(config)
    tokenizer = get_tokenizer(config.model, bpe_path=config.bpe_vocab_path)

    if config.dataset == "synthetic":
        n_train = 2048 if config.num_train_samples == -1 else config.num_train_samples
        n_test = 512 if config.num_test_samples == -1 else config.num_test_samples
        train_ds = SyntheticCaptions(n_train, seed=config.seed)
        test_ds = SyntheticCaptions(n_test, seed=config.seed + 1)
    else:
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

    train_loader = DataLoader(
        train_ds, config.batch_size, tokenizer, train=True, seed=config.seed,
        shuffle=True, drop_last=True, num_threads=num_threads,
        image_size=config.device_augment_staging if config.device_augment else image_size,
        raw_uint8=config.device_augment,
    )
    test_loader = DataLoader(
        test_ds, config.batch_size, tokenizer, train=False, seed=config.seed,
        shuffle=False, drop_last=True, num_threads=num_threads, image_size=image_size,
    )
    return train_loader, test_loader
