"""Build the port's CUDA kernels from ``csrc/*.cu`` and load them.

The sources are compiled by ``nvcc`` into one shared library with a
plain C interface, which is loaded with ``ctypes`` (no PyTorch headers:
the build takes seconds, not minutes).  The library lands in
``sparsify_clip_tpu_torch/_build/`` under a name that carries a hash of
the sources and flags, so an edited source is rebuilt on first use and
an unchanged one is loaded as it is.

Nothing is built when the module is imported: the first kernel launch
calls :func:`library`.  A machine without ``nvcc`` raises there.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # registers, shared memory and spills, kept in the build log
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then ``PATH``, then
    ``/usr/local/cuda/bin/nvcc``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (tried $CUDA_HOME/bin, PATH, /usr/local/cuda/bin): "
        "the CUDA kernels of sparsify_clip_tpu_torch are compiled from "
        "ops/csrc at first use and need the CUDA toolkit"
    )


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libsparsify_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Tuple[Path, str]:
    """Compile the library unless it exists; return its path and the
    compiler's output (empty when nothing was compiled)."""
    target = library_path()
    if target.exists():
        return target, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(s) for s in _sources() if s.suffix == ".cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n{' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, target)  # atomic: a concurrent loader never sees half a file
    return target, proc.stdout + proc.stderr


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call, with every entry
    point's argument and result types declared."""
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.sparsify_mha_fwd.argtypes = [
                p, p, p,        # qkv, out, lse (may be null)
                i, i, i, i,     # batch, seq, heads, head_dim
                i, i,           # causal, dtype (0 fp32, 1 bf16)
                ctypes.c_float,  # scale
                p,              # cudaStream_t
            ]
            lib.sparsify_mha_fwd.restype = i
            _lib = lib
        return _lib
