"""Build the port's CUDA sources and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface.  At first use it is
compiled by `nvcc` for sm_90a into a shared library under
`build/torch_kernels/` at the repository root (listed in .gitignore).  The
library's file name carries a hash of the source and the flags, so an
edited source builds anew and an unchanged one is reused.  `-Xptxas -v`
output (registers, shared memory, spills) is kept beside the library in a
`.log` file.  A failed build raises with the compiler's output.  Builds
and loads run under one lock, so two threads that meet a kernel for the
first time at once (the query server's pool threads) build it once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence, Tuple

from spark_rapids_tpu_torch.analysis.lockdep import make_lock

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C signature of an exported function: (restype, argtypes)
Signature = Tuple[object, Sequence[object]]

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOAD_LOCK = make_lock("cuda_build.load")


def nvcc_path() -> str:
    """nvcc from CUDA_HOME / CUDA_PATH, else PATH, else the toolkit's
    default install prefix."""
    for var in ("CUDA_HOME", "CUDA_PATH"):
        home = os.environ.get(var)
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    """Where the library of csrc/<name>.cu lives once built."""
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless it is built already; return the
    library's path.  Raises with the compiler's output if nvcc fails."""
    path = library_path(name)
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True, check=False)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
            f"{proc.stdout}")
    path.with_suffix(".log").write_text(proc.stdout)
    os.replace(tmp, path)
    return path


def build_log(name: str) -> str:
    """The compiler's output (ptxas register/shared-memory report) from
    the build of csrc/<name>.cu."""
    return library_path(name).with_suffix(".log").read_text()


def load(name: str, signatures: Dict[str, Signature]) -> ctypes.CDLL:
    """The built library of csrc/<name>.cu, with `restype` and `argtypes`
    set for each function in `signatures`."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    with _LOAD_LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            for fn, (restype, argtypes) in signatures.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = list(argtypes)
            _LOADED[name] = lib
    return lib
