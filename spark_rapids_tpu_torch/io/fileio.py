"""Pluggable file-IO layer (reference fileio/RapidsFileIO.java,
RapidsInputFile.java:32-100, SeekableInputStream.java:26-41,
RapidsOutputFile.java / RapidsOutputStream.java): an abstraction over
the underlying storage (local fs, object store, ...) consumed by the
iceberg/parquet readers.  The local implementation is the default, as
the reference's tests use the Hadoop local filesystem.

`read_vectored` preserves the reference's contract
(RapidsInputFile.java:68-95): ranges are validated against the output
buffer before any IO, empty range lists are a no-op, and reads are
performed through a single opened stream.
"""

from __future__ import annotations

import io
import os
import threading
import time
from contextlib import closing
from dataclasses import dataclass
from typing import List, Optional, Protocol

from spark_rapids_tpu_torch import observability as _obs
from spark_rapids_tpu_torch.analysis import lockdep


@dataclass(frozen=True)
class CopyRange:
    """One vectored-read request (RapidsInputFile.java:146-171)."""
    input_offset: int
    length: int
    output_offset: int


class SeekableInputStream(Protocol):
    """read()/seek()/tell() contract (SeekableInputStream.java:26-41)."""

    def read(self, n: int = -1) -> bytes: ...
    def seek(self, pos: int, whence: int = 0) -> int: ...
    def tell(self) -> int: ...
    def close(self) -> None: ...


class RapidsInputFile:
    """A readable file handle (RapidsInputFile.java:32)."""

    def get_length(self) -> int:
        raise NotImplementedError

    def open(self) -> SeekableInputStream:
        raise NotImplementedError

    def read_fully(self) -> bytes:
        with closing(self.open()) as f:
            return f.read()

    def read_vectored(self, output: bytearray,
                      ranges: List[CopyRange]) -> None:
        """Scatter byte ranges of this file into `output`
        (RapidsInputFile.java:68-95).  All ranges are validated before
        any byte is read."""
        if ranges is None:
            raise ValueError("copyRanges can't be null")
        if not ranges:
            return
        for r in ranges:
            if r.length < 0 or r.input_offset < 0 or r.output_offset < 0:
                raise ValueError(f"negative field in {r}")
            if r.output_offset + r.length > len(output):
                raise ValueError(
                    f"range {r} exceeds output buffer "
                    f"({len(output)} bytes)")
        with closing(self.open()) as f:
            for r in ranges:
                f.seek(r.input_offset)
                data = f.read(r.length)
                if len(data) != r.length:
                    raise EOFError(
                        f"short read: wanted {r.length} at "
                        f"{r.input_offset}, got {len(data)}")
                output[r.output_offset:r.output_offset + r.length] = data


class RapidsOutputFile:
    """A writable file handle (RapidsOutputFile.java:27)."""

    def create(self) -> io.BufferedWriter:
        raise NotImplementedError


class RapidsFileIO:
    """Factory for input/output files (RapidsFileIO.java:28).  Output
    is optional — the base class refuses, as the reference's default
    method does."""

    def new_input_file(self, path: str) -> RapidsInputFile:
        raise NotImplementedError

    def new_output_file(self, path: str) -> RapidsOutputFile:
        raise NotImplementedError("Output file not supported")


class _LocalInputFile(RapidsInputFile):
    def __init__(self, path: str):
        self._path = path

    def get_length(self) -> int:
        return os.path.getsize(self._path)

    def open(self) -> SeekableInputStream:
        return open(self._path, "rb")


class _LocalOutputFile(RapidsOutputFile):
    def __init__(self, path: str):
        self._path = path

    def create(self) -> io.BufferedWriter:
        return open(self._path, "wb")


class LocalFileIO(RapidsFileIO):
    """Local-filesystem implementation (the reference tests' Hadoop
    local-fs counterpart)."""

    def new_input_file(self, path: str) -> RapidsInputFile:
        return _LocalInputFile(path)

    def new_output_file(self, path: str) -> RapidsOutputFile:
        return _LocalOutputFile(path)


class RangeReader:
    """One opened stream serving many instrumented range fetches —
    the column-chunk loop opens the file ONCE per read_table, not once
    per chunk (a 212-column file is hundreds of chunks).  A lock keeps
    each seek and its read together when threads share the reader;
    short reads raise ``EOFError`` like ``read_vectored``."""

    def __init__(self, path: str,
                 fileio: Optional[RapidsFileIO] = None):
        self._path = path
        inp = (fileio or LocalFileIO()).new_input_file(path)
        self._length = inp.get_length()
        self._f = inp.open()
        self._lock = threading.Lock()

    @property
    def length(self) -> int:
        return self._length

    def read(self, offset: int, length: int) -> bytes:
        """Fetch exactly ``[offset, offset + length)``."""
        if offset < 0 or length < 0:
            raise ValueError(
                f"negative range: offset={offset} length={length}")
        # lockdep blocking marker: a storage fetch under a held lock
        # is the latency bug the analyzer hunts (one bool read when
        # lockdep is off)
        lockdep.note_blocking("fileio.read_range")
        t0 = time.perf_counter_ns()
        with self._lock:
            self._f.seek(offset)
            data = self._f.read(length)
        if len(data) != length:
            raise EOFError(
                f"short read: wanted {length} bytes at {offset} of "
                f"{self._path}, got {len(data)}")
        _obs.record_io_read(self._path, length,
                            time.perf_counter_ns() - t0)
        return data

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "RangeReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_range(path: str, offset: int, length: int,
               fileio: Optional[RapidsFileIO] = None) -> bytes:
    """One-shot :class:`RangeReader` fetch (opens, reads, closes) —
    the row-group column-chunk primitive for callers outside a batch
    loop."""
    with RangeReader(path, fileio) as r:
        return r.read(offset, length)

