"""Build the port's host-side C++ libraries (the native BPE tokenizer and
the native JPEG pipeline) with ``g++`` and load them with ``ctypes``.

Each library is compiled from its source in the package (a byte-for-byte
copy of the JAX package's ``native/`` source) with the flags of that
source's Makefile, at first use, into ``sparsify_clip_tpu_torch/_build/``
under a name that carries a hash of the source and the command, so an
edited source is rebuilt and an unchanged one is loaded as it is.  The
JAX package's own build artifacts under ``native/`` are never loaded.

Nothing is built when a module is imported.  A machine without a C++
compiler, or without a header or library the source needs, raises
:class:`RuntimeError` with the compiler's reason.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"


def compiler() -> str:
    """The C++ compiler: ``$CXX``, else ``g++`` on ``PATH``."""
    cxx = os.environ.get("CXX") or "g++"
    path = shutil.which(cxx)
    if path is None:
        raise RuntimeError(f"no C++ compiler: {cxx!r} is not on PATH")
    return path


def library_path(source: Path, flags: Sequence[str], libs: Sequence[str]) -> Path:
    """Where the library built from ``source`` with these flags lives."""
    digest = hashlib.sha256(" ".join([*flags, "|", *libs]).encode())
    digest.update(source.read_bytes())
    return BUILD_DIR / f"lib{source.stem}_{digest.hexdigest()[:16]}.so"


def build(source: Path, flags: Sequence[str], libs: Sequence[str] = ()) -> Path:
    """Compile ``source`` into a shared library unless it exists; return
    its path.  ``g++ <flags> -shared -o <lib> <source> <libs>``, the
    Makefile's command."""
    target = library_path(source, flags, libs)
    if target.exists():
        return target
    cxx = compiler()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    cmd = [cxx, *flags, "-shared", "-o", str(tmp), str(source), *libs]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed with exit code {proc.returncode}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, target)  # atomic: a concurrent loader never sees half a file
    finally:
        tmp.unlink(missing_ok=True)
    return target


def load(path: str, what: str) -> ctypes.CDLL:
    """``ctypes.CDLL(path)``; a library that does not load (a shared
    library it links is missing) raises RuntimeError naming ``what``."""
    try:
        return ctypes.CDLL(path)
    except OSError as exc:
        raise RuntimeError(f"{what} library unavailable: {exc}") from exc
