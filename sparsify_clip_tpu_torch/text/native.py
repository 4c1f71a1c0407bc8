"""ctypes binding for the native (C++) CLIP BPE tokenizer, ported from
:mod:`sparsify_clip_tpu.text.native`.

``csrc/clip_bpe.cpp`` is a byte-for-byte copy of the JAX package's
``native/tokenizer/clip_bpe.cpp``, built at first use with its Makefile's
flags (``g++ -O2 -std=c++17 -fPIC -Wall -shared``) into
``sparsify_clip_tpu_torch/_build/`` (:mod:`sparsify_clip_tpu_torch.utils.native_build`).
The JAX package's ``native/tokenizer/libclip_bpe.so`` is never loaded.

The ids equal the JAX ``NativeCLIPTokenizer``'s to the bit, which is the
tokenizer that ``tokenizer: auto`` picks on the JAX side where it builds
(``tests/test_torch_port_native_tokenizer.py``).  Against the Python
tokenizer (:class:`sparsify_clip_tpu_torch.text.tokenizer.CLIPTokenizer`)
it is exact on ASCII text without HTML entities, COCO's captions
included, and departs in two ways, both the C++ core's:

* no ``html.unescape``: the Python tokenizer unescapes twice, so
  ``'&gt'`` or ``'&#0'`` become ``'>'`` or U+FFFD there and stay
  four or three characters here;
* non-ASCII bytes are grouped as punctuation runs, where the Python
  tokenizer splits by Unicode letter and number classes.

Neither is repaired here: the port's ``auto`` would then differ from the
JAX package's.
"""

from __future__ import annotations

import ctypes
import gzip
import os
import tempfile
from pathlib import Path
from typing import Optional, Sequence, Union

import numpy as np

from sparsify_clip_tpu_torch.text.tokenizer import default_bpe_path
from sparsify_clip_tpu_torch.utils import native_build

SOURCE = Path(__file__).resolve().parent / "csrc" / "clip_bpe.cpp"
CXXFLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall")  # native/tokenizer/Makefile


def build_library() -> Path:
    """The tokenizer library, built on first call; raises RuntimeError
    with the compiler's reason where it cannot be built."""
    return native_build.build(SOURCE, CXXFLAGS)


def ensure_built() -> Optional[str]:
    """The library's path, or None where it cannot be built."""
    try:
        return str(build_library())
    except RuntimeError:
        return None


class NativeCLIPTokenizer:
    """Batch tokenizer backed by the C++ core: texts → (n, ctx) int32.

    Pickles by rebuilding from its arguments (the library handle and the
    C++ tokenizer are process-local), so a worker process gets its own."""

    backend = "native"

    def __init__(
        self,
        merges_path: Optional[str] = None,
        context_length: int = 77,
        lib_path: Optional[str] = None,
    ):
        try:
            path = lib_path or str(build_library())
        except RuntimeError as exc:
            raise RuntimeError(f"native tokenizer library unavailable: {exc}") from exc
        self._args = (merges_path, context_length, path)
        merges_path = merges_path or default_bpe_path()
        lib = native_build.load(path, "native tokenizer")
        lib.clip_bpe_create.restype = ctypes.c_void_p
        lib.clip_bpe_create.argtypes = [ctypes.c_char_p]
        lib.clip_bpe_destroy.restype = None
        lib.clip_bpe_destroy.argtypes = [ctypes.c_void_p]
        lib.clip_bpe_encode_batch.restype = ctypes.c_int
        lib.clip_bpe_encode_batch.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32),
        ]
        self._lib = lib
        self._handle = None
        # the C++ core reads plain-text merges, once, inside clip_bpe_create:
        # a gzipped file is unpacked to a temporary file deleted right after
        tmp = None
        if merges_path and merges_path.endswith(".gz") and os.path.exists(merges_path):
            with gzip.open(merges_path, "rt", encoding="utf-8") as fh:
                data = fh.read()
            with tempfile.NamedTemporaryFile("w", suffix=".txt", delete=False,
                                             encoding="utf-8") as out:
                out.write(data)
            tmp = merges_path = out.name
        try:
            self._handle = lib.clip_bpe_create((merges_path or "").encode())
        finally:
            if tmp is not None:
                os.unlink(tmp)
        if not self._handle:
            raise RuntimeError("clip_bpe_create failed")
        self.context_length = context_length
        self.sot_id = 49406
        self.eot_id = 49407
        self.vocab_size = 49408

    def __reduce__(self):
        return (NativeCLIPTokenizer, self._args)

    def __call__(
        self, texts: Union[str, Sequence[str]], context_length: Optional[int] = None
    ) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        ctx = context_length or self.context_length
        n = len(texts)
        out = np.zeros((n, ctx), dtype=np.int32)
        arr = (ctypes.c_char_p * n)(*[t.encode("utf-8") for t in texts])
        rc = self._lib.clip_bpe_encode_batch(
            self._handle, arr, n, ctx, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        if rc != 0:
            raise RuntimeError(f"clip_bpe_encode_batch failed: rc={rc}")
        return out

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.clip_bpe_destroy(handle)
            self._handle = None
