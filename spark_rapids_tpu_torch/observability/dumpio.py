"""Atomic file dumps: tmp-file + rename for every observability sink.

Every dump this package writes (journal JSONL, span JSONL, incident
bundles) may race a crash — the whole point of the flight recorder is
that the process is usually dying when these files matter.  A plain
``open(path, "w")`` that dies mid-write leaves a truncated JSONL that
the doctor/exporters then choke on, which is exactly when they must
not.  This helper is the one place that gets the dance right:

  * write to a uniquely-named sibling tmp file (same directory, so the
    rename is not a cross-device copy),
  * flush + fsync before the rename (the rename must never beat the
    data to disk),
  * ``os.replace`` into place (atomic on POSIX; readers see either the
    old complete file or the new complete file, never a torn one),
  * unlink the tmp on ANY failure so aborted dumps leave no litter.

Callers that accept "path or open file" keep their file-object branch
untouched — a caller-owned stream's durability is the caller's
contract.
"""

from __future__ import annotations

import os
import tempfile
from typing import Callable, TypeVar

T = TypeVar("T")

# mkstemp creates 0600 files; a dump must end up with the same
# permissions a plain open(path, "w") would have produced (0666 minus
# umask), or cross-user readers — log shippers, the JVM side — lose
# access.  Read the umask once at import (single-threaded there; the
# set/restore dance is not thread-safe later).
_UMASK = os.umask(0)
os.umask(_UMASK)


def atomic_write(path: str, writer: Callable[..., T], mode: str = "w") -> T:
    """Run ``writer(f)`` against a tmp file, then atomically replace
    ``path`` with it.  Returns whatever ``writer`` returns.  On any
    failure the tmp file is removed and ``path`` is left exactly as it
    was (present and complete, or absent)."""
    directory = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=directory,
                               prefix=os.path.basename(path) + ".",
                               suffix=".tmp")
    try:
        os.fchmod(fd, 0o666 & ~_UMASK)
        with os.fdopen(fd, mode) as f:
            result = writer(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return result
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def dump_via(path_or_file, writer: Callable[..., T]) -> T:
    """Shared path-or-file dispatch: an open file object is written
    directly (caller owns its lifecycle); a path goes through
    :func:`atomic_write`."""
    if hasattr(path_or_file, "write"):
        return writer(path_or_file)
    return atomic_write(path_or_file, writer)
