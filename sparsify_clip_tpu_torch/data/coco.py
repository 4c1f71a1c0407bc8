"""COCO captions dataset, ported from :mod:`sparsify_clip_tpu.data.coco`:
a pure-Python JSON index, no pycocotools.

Items are ordered by ascending image id, as torchvision's CocoDetection
iterates ``sorted(coco.imgs.keys())``, so ``num_{train,test}_samples``
head-subsets (sparsify_clip.py:1034-1046) select the same images.

JPEGs decode through PIL, imported at the first decode; the item is the
decoded (H, W, 3) uint8 RGB array.  ``raw_bytes(i)`` hands the undecoded
JPEG to the native pipeline (:mod:`sparsify_clip_tpu_torch.data.native_imaging`,
``image_backend: native/auto``), which needs no PIL.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


def require_decoder():
    """PIL's ``Image`` module, or a RuntimeError that names the native
    decoder."""
    try:
        from PIL import Image
    except ImportError as exc:
        raise RuntimeError(
            "dataset: coco decodes JPEGs through PIL, which is not importable here; "
            "image_backend: native decodes them without PIL where libjpeg is installed "
            "(ROADMAP Queue 1, 'Data without PIL'). Or use dataset: synthetic."
        ) from exc
    return Image


def decode_image(path: str) -> np.ndarray:
    """A JPEG (or any PIL-readable file) → (H, W, 3) uint8 RGB."""
    with require_decoder().open(path) as img:
        return np.asarray(img.convert("RGB"), dtype=np.uint8)


class CocoCaptionIndex:
    """image-id-ordered index of (file_name, [captions])."""

    def __init__(self, annotation_file: str):
        with open(annotation_file, "r") as fh:
            raw = json.load(fh)
        files: Dict[int, str] = {
            img["id"]: img["file_name"] for img in raw.get("images", [])
        }
        captions: Dict[int, List[str]] = {img_id: [] for img_id in files}
        for ann in raw.get("annotations", []):
            img_id = ann["image_id"]
            if img_id in captions:
                captions[img_id].append(ann["caption"])
        self.ids: List[int] = sorted(files)
        self.file_names: List[str] = [files[i] for i in self.ids]
        self.captions: List[List[str]] = [captions[i] for i in self.ids]

    def __len__(self) -> int:
        return len(self.ids)


class CocoCaptions:
    """(image, captions) dataset over a COCO image dir + caption JSON.
    ``transform(image: np.ndarray)`` runs per item when given."""

    def __init__(
        self,
        root: str,
        annotation_file: str,
        transform: Optional[Callable] = None,
    ):
        self.root = root
        self.index = CocoCaptionIndex(annotation_file)
        self.transform = transform

    def __len__(self) -> int:
        return len(self.index)

    def image_path(self, i: int) -> str:
        return os.path.join(self.root, self.index.file_names[i])

    def __getitem__(self, i: int) -> Tuple[np.ndarray, List[str]]:
        img = decode_image(self.image_path(i))
        if self.transform is not None:
            img = self.transform(img)
        return img, self.index.captions[i]

    def raw_bytes(self, i: int) -> Optional[bytes]:
        """Undecoded JPEG bytes for the native image pipeline (None for a
        non-JPEG file: the loader decodes that item through PIL)."""
        path = self.image_path(i)
        if not path.lower().endswith((".jpg", ".jpeg")):
            return None
        with open(path, "rb") as fh:
            return fh.read()


class Subset:
    """Head-subset wrapper (torch.utils.data.Subset as used at
    sparsify_clip.py:1034-1046)."""

    def __init__(self, dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, i: int):
        return self.dataset[self.indices[i]]

    def raw_bytes(self, i: int) -> Optional[bytes]:
        inner = getattr(self.dataset, "raw_bytes", None)
        return inner(self.indices[i]) if inner is not None else None
