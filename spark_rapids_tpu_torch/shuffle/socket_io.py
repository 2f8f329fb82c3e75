"""Socket endpoints for the kudo wire format.

The kudo reader has a non-seekable mode: on a live stream the trailer
peek is skipped and CRC verification is DEFERRED one record (the
stashed-checksum path).  That machinery stashes state as attributes on
the stream object, which a raw ``socket.makefile('rb')`` silently
refuses (C-implemented io objects have no ``__dict__``), so a bare
socket file never verifies anything.  :class:`SocketStream` is a small
python-level file-like wrapper over a connected socket that

  * loops ``recv`` until exactly ``n`` bytes arrive (or EOF): kudo's
    framing assumes ``read(n)`` is all-or-short-at-EOF;
  * reports ``seekable() == False`` so the reader takes the deferred
    trailer path;
  * accepts arbitrary attributes, so ``_kudo_pushback`` (resync) and
    ``_kudo_pending_crc`` (late trailer verify) work as designed.

``read_tables(SocketStream(sock), resync=True)`` therefore streams
multiple KCRC-trailed tables off a live socket, drops a corrupted one
on its deferred trailer check, scans past garbage via the pushback
stash, and returns every intact table: the socket twin of the seekable
salvage mode.
"""

from __future__ import annotations

import socket
from typing import List

from spark_rapids_tpu_torch.shuffle import kudo as _kudo


class SocketStream:
    """Non-seekable read adapter over a connected socket.

    ``read(n)`` returns exactly ``n`` bytes unless the peer closed the
    connection, in which case it returns what arrived (possibly
    ``b""``), the contract kudo's ``_stream_read`` expects.  A recv
    timeout set on the socket surfaces as ``socket.timeout`` (an
    ``OSError``), which link-level retry treats as a transient failure.
    """

    def __init__(self, sock: socket.socket):
        self._sock = sock

    def read(self, n: int) -> bytes:
        if n <= 0:
            return b""
        parts: List[bytes] = []
        remaining = n
        while remaining > 0:
            chunk = self._sock.recv(remaining)
            if not chunk:
                break  # peer closed: short read signals EOF upstream
            parts.append(chunk)
            remaining -= len(chunk)
        return b"".join(parts)

    def seekable(self) -> bool:
        return False

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


def send_tables(sock: socket.socket, payload: bytes) -> int:
    """Write an already-serialized kudo stream to a socket (the
    transport frames it first; this is the raw-stream endpoint for
    unframed peer links and the socketpair tests)."""
    sock.sendall(payload)
    return len(payload)


def recv_tables(sock: socket.socket, *,
                resync: bool = False) -> List[_kudo.KudoTable]:
    """Read kudo tables straight off a socket until the peer closes:
    the non-seekable read path (deferred CRC trailers, pushback-based
    resync).  Reading to EOF is what makes the LAST table's deferred
    trailer check fire (a bounded-count read would return before its
    checksum was ever compared); framed transports that know the
    payload length up front parse the buffered bytes instead
    (distributed/transport.py)."""
    return _kudo.read_tables(SocketStream(sock), resync=resync)
