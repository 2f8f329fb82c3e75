"""Loader for the native host kernels (native/columnar_native.cpp), and
the g++ build the port's three ctypes wrappers share.

The reference's runtime around the device compute path is C++
(SparkResourceAdaptorJni, kudo merge, join prep); here each native
library is compiled on first use with the system g++ from the sources in
``native/`` and bound through ctypes.  The port builds into
``build/native/`` at the repository root (listed in .gitignore), never
into ``native/``, where the JAX package's wrappers write their own
libraries: the two packages never race on one file.  A library's file
name carries a hash of its sources and flags, so an edited source builds
anew.  The build runs outside any lock (it can take a while, and a lock
held across it would stall every first caller); two first callers at
once each compile into a file of their own and the atomic rename keeps
one.  ``available()`` is false when the build fails or
``SPARK_RAPIDS_TPU_DISABLE_NATIVE=1``; callers then take their
pure-Python path, as the JAX package's do.  All of this is host code."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

NATIVE_SRC = Path(__file__).resolve().parents[2] / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")


def disabled() -> bool:
    return os.environ.get("SPARK_RAPIDS_TPU_DISABLE_NATIVE") == "1"


def library_path(name: str, sources: Sequence[str],
                 flags: Sequence[str] = (), root: Path = NATIVE_SRC,
                 build_dir: Path = BUILD_DIR) -> Path:
    """Where lib<name> built from <root>/<sources> (or absolute source
    paths) lives once built."""
    digest = hashlib.sha256(" ".join((*_FLAGS, *flags)).encode())
    for src in sources:
        digest.update((root / src).read_bytes())
    return build_dir / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_library(name: str, main_source: str,
                  headers: Sequence[str] = (),
                  flags: Sequence[str] = (), libs: Sequence[str] = (),
                  root: Path = NATIVE_SRC,
                  build_dir: Path = BUILD_DIR) -> Path:
    """Compile <root>/<main_source> (which includes <root>/<headers>)
    with g++ into <build_dir> unless it is built already; return the
    library's path.  ``flags`` go before the source, ``libs`` (the
    linker's -L/-l/-Wl options) after it; both are hashed into the
    name.  Raises ``subprocess.CalledProcessError`` (g++'s output in
    its ``stderr``) or ``OSError`` when g++ fails or is missing."""
    path = library_path(name, (main_source, *headers), (*flags, *libs),
                        root, build_dir)
    if path.exists():
        return path
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(
        f"{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        subprocess.run(["g++", *_FLAGS, *flags, "-o", str(tmp),
                        str(root / main_source), *libs],
                       check=True, capture_output=True, text=True,
                       timeout=300)
        os.replace(tmp, path)
    finally:
        if tmp.exists():
            tmp.unlink()
    return path


_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if disabled():
        return None
    with _lock:
        if _tried:
            return _lib
    lib: Optional[ctypes.CDLL] = None
    try:
        lib = ctypes.CDLL(str(build_library("columnar_native",
                                            "columnar_native.cpp")))
        lib.rank_strings.restype = ctypes.c_int64
        lib.rank_strings.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p]
    except (OSError, subprocess.SubprocessError):
        lib = None
    with _lock:
        if not _tried:
            _lib, _tried = lib, True
        return _lib


def available() -> bool:
    return _load() is not None


def rank_strings(chars: np.ndarray, offsets: np.ndarray
                 ) -> Optional[np.ndarray]:
    """Dense lexicographic ranks for an Arrow string buffer (numpy
    arrays, or tensors, read to the host through ``.cpu()``); None when
    the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    if isinstance(chars, torch.Tensor):
        chars = chars.cpu().numpy()
    if isinstance(offsets, torch.Tensor):
        offsets = offsets.cpu().numpy()
    n = len(offsets) - 1
    chars = np.ascontiguousarray(chars, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    out = np.empty(n, np.int64)
    lib.rank_strings(
        chars.ctypes.data_as(ctypes.c_void_p),
        offsets.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(n),
        out.ctypes.data_as(ctypes.c_void_p))
    return out
