"""Spark platform/version predicates + device attributes + file IO SPI
(reference version.hpp / SparkPlatformType.java, DeviceAttr.java,
fileio/RapidsFileIO.java).

The device the JNI door's entries make columns on lives here:
``entry_device()`` is ``"cuda"`` unless ``shim.jni_entry.initialize``
read ``SPARK_RAPIDS_TPU_PLATFORM=cpu``, and ``is_integrated_gpu`` reads
it; so does ``mesh_ranks_allowed``, the most ranks the door's mesh
entries may run."""

from __future__ import annotations

import io
import os
from dataclasses import dataclass

import torch

# SparkPlatformType.java:17-37 (enum kept in sync with version.hpp)
VANILLA_SPARK = 0
DATABRICKS = 1
CLOUDERA = 2


@dataclass(frozen=True)
class SparkSystem:
    """version.hpp spark_system: platform + version predicates passed to
    kernels whose semantics differ per Spark distro."""

    platform: int
    major: int
    minor: int
    patch: int = 0

    def is_vanilla_320(self) -> bool:
        return (self.platform == VANILLA_SPARK
                and (self.major, self.minor) == (3, 2))

    def is_databricks_14_3_or_later(self) -> bool:
        return (self.platform == DATABRICKS
                and (self.major, self.minor) >= (14, 3))

    def is_vanilla(self) -> bool:
        return self.platform == VANILLA_SPARK


_ENTRY_DEVICE = ["cuda"]


def entry_device() -> str:
    """The device the JNI door's entries put columns made from host
    values on: "cuda" (the card) or "cpu"."""
    return _ENTRY_DEVICE[0]


def set_entry_device(device: str) -> None:
    if device not in ("cuda", "cpu"):
        raise ValueError(f"entry device must be 'cuda' or 'cpu', got "
                         f"{device!r}")
    _ENTRY_DEVICE[0] = device


_MESH_CPU_RANKS = [1]


def set_mesh_cpu_ranks(n: int) -> None:
    """How many CPU ranks the JNI door's mesh entries may run (read by
    ``jni_entry.initialize`` from SPARK_RAPIDS_TPU_CPU_DEVICES; 1 by
    default, as the JAX package's CPU backend has one device)."""
    n = int(n)
    if n < 1:
        raise ValueError(f"mesh CPU ranks must be at least 1, got {n}")
    _MESH_CPU_RANKS[0] = n


def mesh_ranks_allowed() -> int:
    """The most ranks a mesh entry may run on the entries' device: the
    CPU ranks set at initialize on the CPU, one rank per card on the
    card (NCCL gives every rank its own GPU)."""
    if entry_device() == "cpu":
        return _MESH_CPU_RANKS[0]
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def is_integrated_gpu() -> bool:
    """DeviceAttr.isIntegratedGPU: whether the entries' device shares
    host memory.  True when the entries run on the CPU; on the card,
    the CUDA device property (false on a discrete H100; the JAX package
    answers true only for its CPU backend)."""
    if entry_device() == "cpu":
        return True
    props = torch.cuda.get_device_properties(torch.cuda.current_device())
    return bool(props.is_integrated)


# ----------------------------------------------------- file IO SPI
# (fileio/RapidsFileIO.java:28 — pluggable storage for e.g. parquet
# footers; local-file default, other schemes plug in via subclassing)


class SeekableInputStream(io.BufferedReader):
    """SeekableInputStream contract: read/seek/tell over any storage."""


class RapidsInputFile:
    def __init__(self, path: str):
        self._path = path

    def get_length(self) -> int:
        return os.path.getsize(self._path)

    def open(self) -> "SeekableInputStream":
        return SeekableInputStream(open(self._path, "rb", buffering=0))


class RapidsFileIO:
    """Default local-filesystem implementation of the SPI."""

    def open_input_file(self, path: str) -> RapidsInputFile:
        return RapidsInputFile(path)
