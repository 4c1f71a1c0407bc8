"""ctypes binding for the native (C++) image pipeline, ported from
:mod:`sparsify_clip_tpu.data.native_imaging`: JPEG decode (libjpeg),
crop, Pillow-compatible antialiased bilinear resize, flip and CLIP
normalization in one native call.

``csrc/clip_image.cpp`` is a byte-for-byte copy of the JAX package's
``native/imaging/clip_image.cpp``, built at first use with its Makefile's
flags (``g++ -O3 -std=c++17 -fPIC -Wall -shared ... -ljpeg``) into
``sparsify_clip_tpu_torch/_build/``
(:mod:`sparsify_clip_tpu_torch.utils.native_build`).  The JAX package's
``native/imaging/libclip_image.so`` is never loaded.  The build needs
libjpeg's header and library; where they are missing (a machine without
``jpeglib.h``), :func:`get_pipeline` returns None, ``image_backend:
auto`` takes the PIL decode and numpy transforms as the JAX loader does,
and ``image_backend: native`` raises with the compiler's reason.

Its pixels equal the JAX ``NativeImagePipeline``'s to the bit and differ
from the PIL route's resize by about 1/255
(``tests/test_torch_port_native_imaging.py``).  Every function is
reentrant and ctypes releases the GIL during calls, so the loader's
threads decode in parallel.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from sparsify_clip_tpu_torch.utils import native_build

SOURCE = Path(__file__).resolve().parent / "csrc" / "clip_image.cpp"
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall")  # native/imaging/Makefile
LIBS = ("-ljpeg",)


def build_library() -> Path:
    """The imaging library, built on first call; raises RuntimeError with
    the compiler's reason where it cannot be built."""
    return native_build.build(SOURCE, CXXFLAGS, LIBS)


class NativeImagePipeline:
    """Native decode and transform of JPEG bytes."""

    def __init__(self, lib_path: Optional[str] = None):
        try:
            path = lib_path or str(build_library())
        except RuntimeError as exc:
            raise RuntimeError(f"native imaging library unavailable: {exc}") from exc
        lib = native_build.load(path, "native imaging")
        lib.clip_jpeg_dims.restype = ctypes.c_int
        lib.clip_jpeg_dims.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.clip_decode_transform.restype = ctypes.c_int
        lib.clip_decode_transform.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        self._lib = lib

    def dims(self, jpeg: bytes) -> Tuple[int, int]:
        """(height, width) from the JPEG header only."""
        w = ctypes.c_int(0)
        h = ctypes.c_int(0)
        if self._lib.clip_jpeg_dims(jpeg, len(jpeg), ctypes.byref(w), ctypes.byref(h)):
            raise ValueError("not a decodable JPEG")
        return h.value, w.value

    def transform(
        self,
        jpeg: bytes,
        size: int,
        crop: Optional[Tuple[int, int, int, int]] = None,
        flip: bool = False,
        uint8: bool = False,
    ) -> np.ndarray:
        """Decode → crop (top, left, h, w; None = the full frame, squashed)
        → resize to (size, size) → optional left-right flip → (S, S, 3)
        float32 CLIP-normalized, or uint8 pixels with ``uint8=True``."""
        top, left, ch, cw = crop if crop is not None else (0, 0, -1, -1)
        out = np.empty((size, size, 3), dtype=np.uint8 if uint8 else np.float32)
        rc = self._lib.clip_decode_transform(
            jpeg, len(jpeg), top, left, ch, cw, size, int(flip), 1 if uint8 else 0,
            out.ctypes.data_as(ctypes.c_void_p))
        if rc == 1:
            raise ValueError("JPEG decode failed")
        if rc == 2:
            raise ValueError(f"crop window {crop} outside image")
        return out


_pipeline: Optional[NativeImagePipeline] = None
_error: Optional[RuntimeError] = None


def get_pipeline() -> Optional[NativeImagePipeline]:
    """The process's pipeline, built on first call; None where the
    library cannot be built (:func:`build_error` says why).  A failed
    build is not retried in the same process."""
    global _pipeline, _error
    if _pipeline is None and _error is None:
        try:
            _pipeline = NativeImagePipeline()
        except RuntimeError as exc:
            _error = exc
    return _pipeline


def build_error() -> Optional[RuntimeError]:
    """Why :func:`get_pipeline` returned None, or None."""
    return _error
