"""Build the port's CUDA kernels from ``csrc/*.cu`` and load them.

Each source is compiled by its own ``nvcc``, all started together, and
the objects are linked into one shared library with a plain C
interface, which is loaded with ``ctypes`` (no PyTorch headers: the
build takes seconds, not minutes).  The library lands in
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
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
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
    nvcc, tag = nvcc_path(), f"{target.stem}.{os.getpid()}"
    jobs = []
    for src in (s for s in _sources() if s.suffix == ".cu"):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((cmd, obj, proc))
    logs, failures = [], []
    for cmd, obj, proc in jobs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            failures.append(f"exit code {proc.returncode}:\n{' '.join(cmd)}\n{out}")
    objects = [obj for _, obj, _ in jobs]
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    try:
        if failures:
            raise RuntimeError("nvcc failed with " + "\n".join(failures))
        cmd = [nvcc, "-shared", "-o", str(tmp), *(str(o) for o in objects)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed with exit code {proc.returncode}:\n{' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, target)  # atomic: a concurrent loader never sees half a file
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objects:
            obj.unlink(missing_ok=True)
    return target, "".join(logs)


def demangle(symbols: list) -> list:
    """The C++ names of mangled symbols, without their parameter types,
    from the toolkit's ``cu++filt`` (beside ``nvcc``)."""
    if not symbols:
        return []
    tool = os.path.join(os.path.dirname(nvcc_path()), "cu++filt")
    proc = subprocess.run([tool, "-p", *symbols], capture_output=True, text=True, check=True)
    return proc.stdout.splitlines()


def ptxas_usage(build_log: str) -> list:
    """Each kernel's registers, spilled bytes and static shared memory from
    the ``-Xptxas=-v`` lines of a build log: a dict a kernel, with its
    source file and its name (:func:`demangle`)."""
    usage = []
    for ln in build_log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", ln)
        if entry:
            unit = re.search(r"_\d+_(\w+?)_cu_", entry.group(1))
            usage.append({"source": f"{unit.group(1)}.cu" if unit else "",
                          "kernel": entry.group(1)})
            continue
        if not usage:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if spill:
            usage[-1]["spill_stores"], usage[-1]["spill_loads"] = map(int, spill.groups())
        regs = re.search(r"Used (\d+) registers", ln)
        if regs:
            usage[-1]["registers"] = int(regs.group(1))
            smem = re.search(r"(\d+) bytes smem", ln)
            usage[-1]["static_smem"] = int(smem.group(1)) if smem else 0
    for u, name in zip(usage, demangle([u["kernel"] for u in usage])):
        u["kernel"] = name
    return usage


def launch(fn, device, *args) -> int:
    """``fn(*args, stream)``, an entry point of :func:`library`, on the
    current stream of ``device`` (a CUDA ``torch.device``), with the device
    made current for the call only where it is not: a device switch and the
    public stream object cost microseconds a call, which a train step's
    host pays for every launch."""
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    if device.index == torch.cuda.current_device():
        return fn(*args, stream)
    with torch.cuda.device(device):
        return fn(*args, stream)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call, with every entry
    point's argument and result types declared."""
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.sparsify_mha_fwd.argtypes = [
                p, p, p,        # qkv, out, lse (may be null)
                i, i, i, i,     # batch, seq, heads, head_dim
                i, i,           # causal, dtype (0 fp32, 1 bf16)
                f,              # scale
                p,              # cudaStream_t
            ]
            lib.sparsify_mha_fwd.restype = i
            lib.sparsify_mha_bwd.argtypes = [
                p, p, p, p, p,  # qkv, lse, dout, dqkv, drow scratch
                i, i, i, i,     # batch, seq, heads, head_dim
                i, i,           # causal, dtype (0 fp32, 1 bf16)
                f,              # scale
                p,              # cudaStream_t
            ]
            lib.sparsify_mha_bwd.restype = i
            lib.sparsify_mha_fwd_head_group.argtypes = [
                p, p,           # qkv, out
                i, i, i, i,     # batch, seq, heads, head_dim
                i, i,           # causal, dtype (0 fp32, 1 bf16)
                f,              # scale
                p,              # cudaStream_t
            ]
            lib.sparsify_mha_fwd_head_group.restype = i
            lib.sparsify_mha_bwd_head_group.argtypes = [
                p, p, p,        # qkv, dout, dqkv
                p, p, p,        # row max, row sum, drow scratch
                i, i, i, i,     # batch, seq, heads, head_dim
                i, i,           # causal, dtype (0 fp32, 1 bf16)
                f,              # scale
                p,              # cudaStream_t
            ]
            lib.sparsify_mha_bwd_head_group.restype = i
            lib.sparsify_infonce_fwd.argtypes = [
                p, p, p,        # img, txt, temperature (device scalar)
                i, i,           # n, d
                p, p, p, p,     # loss, row_lse, col_lse, scratch
                p,              # cudaStream_t
            ]
            lib.sparsify_infonce_fwd.restype = i
            lib.sparsify_infonce_fwd_scratch.argtypes = [i, i]  # n, d
            lib.sparsify_infonce_fwd_scratch.restype = ctypes.c_longlong
            lib.sparsify_infonce_bwd_dimg.argtypes = [
                p, p, p, p,     # img, txt, temperature, g (device scalars)
                p, p,           # row_lse, col_lse
                i, i,           # n, d
                p, p, p,        # d_img, scratch, d_temp
                p,              # cudaStream_t
            ]
            lib.sparsify_infonce_bwd_dimg.restype = i
            lib.sparsify_infonce_bwd_dtxt.argtypes = [
                p, p, p, p,     # img, txt, temperature, g
                p, p,           # row_lse, col_lse
                i, i,           # n, d
                p, p,           # d_txt, scratch
                p,              # cudaStream_t
            ]
            lib.sparsify_infonce_bwd_dtxt.restype = i
            lib.sparsify_infonce_bwd_scratch.argtypes = [i, i]  # n, d
            lib.sparsify_infonce_bwd_scratch.restype = ctypes.c_longlong
            lib.sparsify_lunif_fwd.argtypes = [
                p, i, i, f,     # x, n, d, t
                p,              # scratch (partial sums)
                p, p,           # S, loss (device scalars)
                p,              # cudaStream_t
            ]
            lib.sparsify_lunif_fwd.restype = i
            lib.sparsify_lunif_fwd_scratch.argtypes = [i, i]  # n, d
            lib.sparsify_lunif_fwd_scratch.restype = ctypes.c_longlong
            lib.sparsify_lunif_bwd.argtypes = [
                p, p, p,        # x, S, g (device scalars)
                i, i, f,        # n, d, t
                p, p,           # scratch, dx
                p,              # cudaStream_t
            ]
            lib.sparsify_lunif_bwd.restype = i
            lib.sparsify_lunif_bwd_scratch.argtypes = [i, i]  # n, d
            lib.sparsify_lunif_bwd_scratch.restype = ctypes.c_longlong
            lib.sparsify_ln_qkv_fwd.argtypes = [
                p, p, p,        # x, LayerNorm scale, LayerNorm bias (fp32)
                p, p, p,        # weight (C, W), bias (C,), out (N, C): C = 3W or 3W / tp
                p,              # row statistics scratch (N, 2) fp32
                i, i, i, f,     # n, width, C, eps
                i,              # dtype (0 fp32, 1 bf16)
                p,              # cudaStream_t
            ]
            lib.sparsify_ln_qkv_fwd.restype = i
            lib.sparsify_ln_fast_bwd_scratch.argtypes = [i, i]  # n, width
            lib.sparsify_ln_fast_bwd_scratch.restype = ctypes.c_longlong
            lib.sparsify_ln_fast_bwd.argtypes = [
                p, p, p, p,     # x, dy, LayerNorm scale, LayerNorm bias (fp32)
                p, p,           # y, dx (N, W)
                p, p,           # partials scratch, dscale then dbias (2W,) fp32
                i, i, f,        # n, width, eps
                i,              # dtype (0 fp32, 1 bf16)
                p,              # cudaStream_t
            ]
            lib.sparsify_ln_fast_bwd.restype = i
            _lib = lib
        return _lib
