"""Peer-to-peer shuffle transport: framed kudo streams over
TCP/unix sockets (layer 1 of 2: the ShuffleService in service.py owns
partitioning/merging; this module owns bytes on wires).  The bytes on
the wire are the JAX package's, frame for frame, so ranks of either
package can share one fleet.

Wire protocol (one directed link = one persistent connection from the
sending rank to the receiving rank's listener):

  frame:   "SRTS" | u8 kind | u32 src_rank | u32 op_id | u32 seq |
           u64 payload_len   (big-endian, 25 bytes)
  payload: a kudo table stream — the EXISTING inter-host wire format:
           optional KTRX trace-context extension + KUD0 header/body +
           KCRC integrity trailer per table.  The transport adds
           nothing to the bytes the shuffle already knows how to
           write, verify, and merge.

Delivery contract (push + ack):

  * DATA: sender transmits frame+payload, then blocks for a 1-byte
    verdict: b"A" (payload parsed AND CRC-verified by the receiving
    kudo reader) or b"N" (corrupt — the reader raised
    KudoCorruptException).  Anything else — EOF, reset, timeout — is a
    transient link failure.
  * Retries ride :func:`robustness.links.with_link_retry` (the shared
    RetryPolicy: bounded attempts, decorrelated-jitter backoff,
    wall-clock deadline); a NAK or link error resends the sender's
    INTACT copy of the payload over a fresh connection if needed.
    Budget exhaustion raises PeerDiedException.
  * Duplicates (an ACK lost in flight makes the sender resend a
    payload the receiver already accepted) are deduplicated by
    (src, op_id, seq) and re-ACKed without re-delivery.

Elastic extension: frames of kind EDATA carry an 8-byte
extension — ``u32 epoch | u32 part`` — between the base header and the
payload.  ``epoch`` is the sender's fleet-membership epoch
(robustness/fleet.py): a receiver whose view is AHEAD answers the
``E`` verdict (1 byte + its current u32 epoch) instead of merging, so
a zombie rank cannot push partitions into a round that already
rebalanced away from it.  ``part`` names the logical partition; the
receive side dedups by (op, part) — the FIRST verified copy wins,
later copies (speculation losers, rebalance replays) are byte-compared
and dropped (counted in ``STATS``).  A re-split hot
partition travels as sub-frames whose part field packs
(part, sub-index, sub-count); the :class:`PartInbox` stitches them
back in index order.  CTRL frames (same extension) carry small JSON
control payloads: death notices, joins, replay fetches.

Fault injection for the chaos/dist/elastic gates: set
``SPARK_RAPIDS_TPU_DIST_FAULT="corrupt:<dst>:<op>"`` (or
``trunc:<dst>:<op>``) in a worker's environment and its FIRST send to
that destination/op is corrupted (one payload byte XOR'd after CRC
computation) or truncated mid-payload with a hard close — the receiver
NAKs / the ack read fails, and the retry loop must recover with a
clean resend.  ``drop:<dst>:<op>`` silently drops the frame (the
sender forges local success, the receiver never sees it — the
speculation path's chaos mode), and ``slow:<dst>:<ms>`` injects a
PERSISTENT per-frame delay of ``ms`` milliseconds on every send to
``dst`` (the straggler chaos mode).  ``<dst>``/``<op>`` accept ``-1``
as a wildcard.  Programmatic twin: :func:`set_link_fault`.

``STATS`` counts frames, payload bytes, NAKs and resends for the worker
summaries, and :func:`link_bytes` the bytes per (direction, peer); the
same deliveries feed the ``srt_shuffle_link_*`` metrics while
observability is on, a ``shuffle_send`` span wraps each send, and the
link locks are lockdep's (``dist.*`` classes).
"""


from __future__ import annotations

import io
import os
import socket
import struct
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

from spark_rapids_tpu_torch import observability as _obs
from spark_rapids_tpu_torch.analysis import lockdep
from spark_rapids_tpu_torch.analysis.lockdep import make_lock
from spark_rapids_tpu_torch.robustness.fleet import StaleEpochError
from spark_rapids_tpu_torch.robustness.links import (
    PeerDiedException, ShuffleLinkError, with_link_retry)
from spark_rapids_tpu_torch.robustness.retry import RetryPolicy
from spark_rapids_tpu_torch.shuffle import kudo as _kudo
from spark_rapids_tpu_torch.shuffle.socket_io import SocketStream

FRAME_MAGIC = b"SRTS"
FRAME_FMT = ">4sBIIIQ"
FRAME_LEN = struct.calcsize(FRAME_FMT)  # 25
# elastic extension: u32 epoch | u32 part, between header and payload
EXT_FMT = ">II"
EXT_LEN = struct.calcsize(EXT_FMT)  # 8
KIND_DATA = 1
KIND_EDATA = 2   # elastic data: epoch-fenced, (op, part)-deduped
KIND_CTRL = 3    # elastic control: JSON payload (death/join/fetch)
ACK = b"A"
NAK = b"N"
STALE = b"E"     # stale-epoch fence; followed by the receiver's u32 epoch
MAX_PAYLOAD = 1 << 30  # sanity bound: refuse absurd frame lengths

# re-split part-field packing: flag | part(15b) | sub k (8b) | nsub (8b)
RESPLIT_FLAG = 0x80000000
MAX_RESPLIT_PART = (1 << 15) - 1
MAX_RESPLIT_SUBS = (1 << 8) - 1


def pack_resplit(part: int, k: int, nsub: int) -> int:
    if not (0 <= part <= MAX_RESPLIT_PART
            and 0 <= k < nsub <= MAX_RESPLIT_SUBS):
        raise ValueError(f"resplit out of range: part={part} k={k} "
                         f"nsub={nsub}")
    return RESPLIT_FLAG | (part << 16) | (k << 8) | nsub


def unpack_resplit(field: int) -> Optional[Tuple[int, int, int]]:
    """(part, k, nsub) when ``field`` is a re-split sub-frame, else
    None (a plain part id)."""
    if not field & RESPLIT_FLAG:
        return None
    return (field >> 16) & MAX_RESPLIT_PART, (field >> 8) & 0xFF, \
        field & 0xFF


def _parse_addr(addr: str):
    """'unix:/path' -> (AF_UNIX, path); 'host:port' -> (AF_INET, ...)."""
    if addr.startswith("unix:"):
        return socket.AF_UNIX, addr[5:]
    host, _, port = addr.rpartition(":")
    return socket.AF_INET, (host or "127.0.0.1", int(port))


# ------------------------------------------------------------ counters

_STATS_LOCK = make_lock("dist.stats")
# frames_sent / bytes_sent: DATA/EDATA/CTRL frames this process sent
# and ACKed (payload bytes, frames' headers not counted); frames_recv /
# bytes_recv: frames delivered here; naks_sent: corrupt payloads this
# listener refused; naks_recv: NAKs this sender got; resends: send
# attempts past the first; stale_naks: E verdicts answered;
# dup_dropped: (op, part) copies that lost the dedup
STATS: Dict[str, int] = {}
_LINK_BYTES: Dict[Tuple[str, int], int] = {}


def reset_stats() -> None:
    with _STATS_LOCK:
        STATS.clear()
        STATS.update(frames_sent=0, bytes_sent=0, frames_recv=0,
                     bytes_recv=0, naks_sent=0, naks_recv=0, resends=0,
                     stale_naks=0, dup_dropped=0)
        _LINK_BYTES.clear()


reset_stats()


def count(key: str, n: int = 1) -> None:
    with _STATS_LOCK:
        STATS[key] += n


def _note_link(direction: str, peer: int, nbytes: int,
               op_id: int = 0) -> None:
    """One delivered payload: 'send' = acked by the peer, 'recv' =
    received AND CRC-verified (``srt_shuffle_link_*`` counts the same
    deliveries)."""
    _obs.record_shuffle_link(direction, peer, nbytes, op_id)
    with _STATS_LOCK:
        key = "frames_sent" if direction == "send" else "frames_recv"
        STATS[key] += 1
        STATS["bytes_" + ("sent" if direction == "send" else "recv")] \
            += nbytes
        k = (direction, int(peer))
        _LINK_BYTES[k] = _LINK_BYTES.get(k, 0) + nbytes


def link_bytes() -> Dict[Tuple[str, int], int]:
    """Cumulative payload bytes per (direction, peer) in this process
    (the JAX package's srt_shuffle_link_bytes_total series)."""
    with _STATS_LOCK:
        return dict(_LINK_BYTES)


# ----------------------------------------------------- fault injection

_FAULT_LOCK = make_lock("dist.fault")
# {(mode, dst, op): remaining}: armed once from env or set_link_fault
_FAULTS: Dict[Tuple[str, int, int], int] = {}
# {dst: delay_ms}: PERSISTENT per-frame injected delay (dst -1 = any)
_SLOW: Dict[int, int] = {}


def set_link_fault(mode: str, dst: int, op_id: int,
                   times: int = 1) -> None:
    """Arm a one-shot (default) send fault: ``mode`` 'corrupt' flips a
    payload byte after serialization; 'trunc' sends half the payload
    and hard-closes the connection; 'drop' silently discards the frame
    (the sender forges success: the receiver must recover by
    speculation or rebalance, not resend).  ``mode`` 'slow' is
    different: the third argument is a PER-FRAME delay in
    milliseconds, applied to every send to ``dst`` until cleared (the
    injected-straggler mode).  ``dst``/``op_id`` of -1 match any."""
    with _FAULT_LOCK:
        if mode == "slow":
            _SLOW[int(dst)] = int(op_id)
        else:
            _FAULTS[(mode, int(dst), int(op_id))] = int(times)


def clear_link_faults() -> None:
    with _FAULT_LOCK:
        _FAULTS.clear()
        _SLOW.clear()


def _env_faults() -> None:
    spec = os.environ.get("SPARK_RAPIDS_TPU_DIST_FAULT", "")
    if not spec:
        return
    for one in spec.split(","):
        try:
            mode, dst, op = one.strip().split(":")
            set_link_fault(mode, int(dst), int(op))
        except ValueError:
            pass  # garbled spec: ignore, like the fault injector does


_env_faults()


def _take_fault(dst: int, op_id: int) -> Optional[str]:
    with _FAULT_LOCK:
        for mode in ("corrupt", "trunc", "drop"):
            for key in ((mode, dst, op_id), (mode, -1, op_id),
                        (mode, dst, -1), (mode, -1, -1)):
                left = _FAULTS.get(key, 0)
                if left > 0:
                    _FAULTS[key] = left - 1
                    return mode
    return None


def _slow_ms(dst: int) -> int:
    with _FAULT_LOCK:
        return _SLOW.get(dst, _SLOW.get(-1, 0))


# -------------------------------------------------------------- inbox


class Inbox:
    """Received, CRC-verified payloads keyed by (op_id, src_rank).
    ``wait`` blocks until every listed source delivered (or the
    deadline lapses -> PeerDiedException naming the missing peers)."""

    def __init__(self):
        self._lock = make_lock("dist.inbox")
        self._cv = threading.Condition(self._lock)
        self._slots: Dict[Tuple[int, int], List[_kudo.KudoTable]] = {}
        # (op_id, src) keys whose round died in wait(): a handler
        # thread that was mid-verify when the deadline lapsed may
        # still put() AFTER the cleanup below; each tombstone absorbs
        # exactly that one late delivery (one-shot, so a genuinely new
        # round reusing the op id starts clean)
        self._dead: Dict[Tuple[int, int], bool] = {}

    def put(self, op_id: int, src: int,
            tables: List[_kudo.KudoTable]) -> None:
        with self._cv:
            if self._dead.pop((op_id, src), None):
                return  # late delivery for a timed-out round: drop
            self._slots[(op_id, src)] = tables
            self._cv.notify_all()

    def wait(self, op_id: int, srcs, timeout_s: float
             ) -> Dict[int, List[_kudo.KudoTable]]:
        want = set(int(s) for s in srcs)
        with self._cv:
            ok = self._cv.wait_for(
                lambda: all((op_id, s) in self._slots for s in want),
                timeout=timeout_s)
            if not ok:
                missing = sorted(s for s in want
                                 if (op_id, s) not in self._slots)
                # the round is dead: discard what DID arrive for it,
                # so a retried exchange reusing this op id can never
                # merge a previous attempt's partitions; missing peers
                # get a tombstone so an in-flight late delivery is
                # absorbed too (bounded: one entry per missing peer)
                for s in want:
                    if self._slots.pop((op_id, s), None) is None:
                        self._dead[(op_id, s)] = True
                        if len(self._dead) > 1024:
                            self._dead.pop(next(iter(self._dead)))
                raise PeerDiedException(
                    ",".join(map(str, missing)), 0,
                    detail=f"no payload for op {op_id} within "
                           f"{timeout_s:.1f}s")
            return {s: self._slots.pop((op_id, s)) for s in want}


# --------------------------------------------------------- part inbox


class PartInbox:
    """Elastic receive state: verified tables keyed by (op, part),
    FIRST verified copy wins.  Also stitches re-split sub-frames back
    into whole parts (index order) and keeps the verified payload
    bytes per part: the byte-safe replay store a FETCH control
    message re-serves (kudo frames are CRC'd end to end, so a replayed
    payload is provably the original bytes)."""

    MAX_OPS = 32  # replay store bound: oldest op evicted past this

    def __init__(self):
        self._lock = make_lock("dist.part_inbox")
        self._cv = threading.Condition(self._lock)
        # op -> {part: [KudoTable]}; payloads keyed (op, part)
        self._parts: Dict[int, Dict[int, list]] = {}
        self._payloads: Dict[Tuple[int, int], bytes] = {}
        # in-flight re-split assembly: (op, part) -> {k: (tables, blob)}
        self._subs: Dict[Tuple[int, int], Dict[int, tuple]] = {}
        # parts stitched from sub-frames: their stored payload is a
        # sub-blob concatenation, NOT byte-comparable against a
        # whole-table serialization of the same rows
        self._assembled: Set[Tuple[int, int]] = set()
        self._order: List[int] = []

    def _op_slot(self, op_id: int) -> Dict[int, list]:
        cur = self._parts.get(op_id)
        if cur is None:
            cur = self._parts[op_id] = {}
            self._order.append(op_id)
            while len(self._order) > self.MAX_OPS:
                old = self._order.pop(0)
                for p in self._parts.pop(old, {}):
                    self._payloads.pop((old, p), None)
                    self._assembled.discard((old, p))
                for key in [k for k in self._subs if k[0] == old]:
                    self._subs.pop(key, None)
        return cur

    def put(self, op_id: int, part: int, tables: list,
            payload: bytes) -> str:
        """Deliver one whole part.  Returns 'new' when this copy won,
        'dup_identical' / 'dup_mismatch' when a copy already merged
        (the byte compare is the speculative-winner contract:
        deterministic recomputes MUST collide byte-identically), or
        'dup_framing' when the winning copy was stitched from re-split
        sub-frames: same rows, different framing, so the byte compare
        is inapplicable (NOT corruption evidence)."""
        with self._cv:
            return self._put_locked(op_id, part, tables, payload)

    def _put_locked(self, op_id: int, part: int, tables, payload,
                    assembled: bool = False):
        cur = self._op_slot(op_id)
        if part in cur:
            if assembled or (op_id, part) in self._assembled:
                return "dup_framing"
            same = payload == self._payloads.get((op_id, part))
            return "dup_identical" if same else "dup_mismatch"
        cur[part] = tables
        self._payloads[(op_id, part)] = payload
        if assembled:
            self._assembled.add((op_id, part))
        self._subs.pop((op_id, part), None)
        self._cv.notify_all()
        return "new"

    def put_sub(self, op_id: int, part: int, k: int, nsub: int,
                tables: list, payload: bytes) -> str:
        """One re-split sub-frame.  When the last sub arrives the part
        assembles in index order (row-slice concatenation: the merged
        table is byte-identical to the unsplit original).  Returns
        'sub' (still assembling), 'new' (assembled just now),
        'dup_identical'/'dup_mismatch' for a duplicate sub-frame, or
        'dup_framing' when the whole part already merged."""
        with self._cv:
            cur = self._op_slot(op_id)
            if part in cur:
                return "dup_framing"  # whole part already won
            entry = self._subs.setdefault((op_id, part), {})
            if k in entry:
                return ("dup_identical" if payload == entry[k][1]
                        else "dup_mismatch")
            entry[k] = (tables, payload)
            if len(entry) < nsub:
                return "sub"
            all_tables: list = []
            blobs: List[bytes] = []
            for i in range(nsub):
                t, b = entry[i]
                all_tables.extend(t)
                blobs.append(b)
            return self._put_locked(op_id, part, all_tables,
                                    b"".join(blobs), assembled=True)

    def have(self, op_id: int) -> Set[int]:
        with self._cv:
            return set(self._parts.get(op_id, ()))

    def get(self, op_id: int) -> Dict[int, list]:
        with self._cv:
            return dict(self._parts.get(op_id, {}))

    def payloads(self, op_id: int) -> Dict[int, bytes]:
        """The replay store for one op (FETCH serves these)."""
        with self._cv:
            return {p: self._payloads[(op_id, p)]
                    for p in self._parts.get(op_id, ())}

    def wait_any(self, op_id: int, want, timeout_s: float) -> bool:
        """Block until any part in ``want`` is present (or any
        membership wake poke): the gather loop re-evaluates policy on
        every wake, so spurious wakes are cheap."""
        want = set(want)
        with self._cv:
            return self._cv.wait_for(
                lambda: bool(want & set(self._parts.get(op_id, ()))),
                timeout=timeout_s)

    def wake(self) -> None:
        """Membership changed: poke every waiter so gather loops
        re-read the fleet view immediately instead of riding out their
        poll timeout."""
        with self._cv:
            self._cv.notify_all()


# ----------------------------------------------------------- listener


class Listener:
    """This rank's receive side: a bounded accept loop; one handler
    thread per inbound connection reading frames, verifying the kudo
    payload (CRC included) and answering A/N.  Short payloads (a
    truncated link) drop the partial bytes and close: the sender's ack
    read fails and its retry resends."""

    def __init__(self, rank: int, addr: str, inbox: Inbox,
                 sink=None):
        self.rank = rank
        self.addr = addr
        self.inbox = inbox
        # elastic sink (the ShuffleService in elastic mode): receives
        # EDATA/CTRL frames and returns the verdict bytes; without one
        # those kinds are protocol violations (plain fleets)
        self.sink = sink
        self._sock: Optional[socket.socket] = None
        self._threads: List[threading.Thread] = []
        self._conns: set = set()
        self._conns_lock = make_lock("dist.listener.conns")
        self._stop = threading.Event()
        # (src, op, seq) already delivered: a resend after a lost ACK
        # re-ACKs without re-inserting.  Recorded only AFTER a
        # successful verify+deliver (a NAKed payload was never
        # delivered, so its clean resend must not be deduped).
        # Bounded: 4096 message ids dwarf any in-flight window.
        self._seen: Dict[Tuple[int, int, int], bool] = {}
        self._seen_order: List[Tuple[int, int, int]] = []
        self._seen_lock = make_lock("dist.listener.seen")

    def start(self) -> "Listener":
        fam, target = _parse_addr(self.addr)
        if fam == socket.AF_UNIX:
            try:
                os.unlink(target)
            except OSError:
                pass
        s = socket.socket(fam, socket.SOCK_STREAM)
        if fam == socket.AF_INET:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(target)
        s.listen(16)
        s.settimeout(0.2)
        self._sock = s
        t = threading.Thread(target=self._accept_loop,
                             name=f"srt-shuffle-accept-{self.rank}",
                             daemon=True)
        t.start()
        self._threads.append(t)
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        # close accepted connections so handler threads blocked in
        # stream.read unwind immediately instead of riding out their
        # 60s socket timeout past the join below
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.close()
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=2.0)
        fam, target = _parse_addr(self.addr)
        if fam == socket.AF_UNIX:
            try:
                os.unlink(target)
            except OSError:
                pass

    # ------------------------------------------------------- internals

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # listener closed
            with self._conns_lock:
                self._conns.add(conn)
            t = threading.Thread(
                target=self._serve, args=(conn,),
                name=f"srt-shuffle-recv-{self.rank}", daemon=True)
            t.start()
            # prune finished handlers so a fault-heavy run (every
            # reconnect is a new connection) doesn't accrete dead
            # Thread objects
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)

    def _already_delivered(self, key: Tuple[int, int, int]) -> bool:
        with self._seen_lock:
            return key in self._seen

    def _mark_delivered(self, key: Tuple[int, int, int]) -> None:
        with self._seen_lock:
            if key in self._seen:
                return
            self._seen[key] = True
            self._seen_order.append(key)
            if len(self._seen_order) > 4096:
                old = self._seen_order.pop(0)
                self._seen.pop(old, None)

    def _serve(self, conn: socket.socket) -> None:
        conn.settimeout(60.0)
        stream = SocketStream(conn)
        try:
            while not self._stop.is_set():
                head = stream.read(FRAME_LEN)
                if len(head) < FRAME_LEN:
                    return  # clean close (or trailing garbage: drop)
                magic, kind, src, op_id, seq, length = struct.unpack(
                    FRAME_FMT, head)
                elastic = kind in (KIND_EDATA, KIND_CTRL)
                if (magic != FRAME_MAGIC or length > MAX_PAYLOAD
                        or not (kind == KIND_DATA
                                or (elastic
                                    and self.sink is not None))):
                    return  # protocol violation: drop the connection
                epoch = part = 0
                if elastic:
                    ext = stream.read(EXT_LEN)
                    if len(ext) < EXT_LEN:
                        return
                    epoch, part = struct.unpack(EXT_FMT, ext)
                payload = stream.read(length)
                if len(payload) < length:
                    # truncated link mid-payload: the partial bytes
                    # are unusable; drop them, close, let the sender's
                    # retry resend over a fresh connection
                    _obs.record_kudo_corruption(
                        "resync", skipped_bytes=len(payload),
                        detail=f"truncated link from rank {src} "
                               f"op {op_id}")
                    return
                if kind == KIND_DATA:
                    self._answer(conn, src, op_id, seq, payload)
                else:
                    self._answer_elastic(conn, kind, src, op_id, seq,
                                         epoch, part, payload)
        except OSError:
            return
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _answer(self, conn, src: int, op_id: int, seq: int,
                payload: bytes) -> None:
        key = (src, op_id, seq)
        if self._already_delivered(key):
            conn.sendall(ACK)  # duplicate after a lost ACK
            return
        try:
            # the verify pass IS the normal kudo read: every KCRC
            # trailer present is checked, impossible headers raise
            tables = _kudo.read_tables(io.BytesIO(payload))
        except (ValueError, EOFError):
            # corrupt payload: NAK; nothing was delivered, so nothing
            # is remembered and the clean resend goes through
            count("naks_sent")
            conn.sendall(NAK)
            return
        self.inbox.put(op_id, src, tables)
        self._mark_delivered(key)
        _note_link("recv", src, len(payload), op_id)
        conn.sendall(ACK)

    def _answer_elastic(self, conn, kind: int, src: int, op_id: int,
                        seq: int, epoch: int, part: int,
                        payload: bytes) -> None:
        """EDATA/CTRL dispatch to the elastic sink.  The sink returns
        the verdict bytes (ACK, NAK, or STALE + its current epoch);
        the (src, op, seq) link-level dedup still short-circuits exact
        resends after a lost ACK: logical (op, part) dedup of DISTINCT
        copies (speculation, replay) is the sink's job."""
        key = (src, op_id, seq)
        if kind == KIND_EDATA and self._already_delivered(key):
            conn.sendall(ACK)
            return
        try:
            if kind == KIND_CTRL:
                verdict = self.sink.on_ctrl(src, epoch, payload)
            else:
                verdict = self.sink.on_edata(src, op_id, seq, epoch,
                                             part, payload)
        except (ValueError, EOFError):
            count("naks_sent")
            conn.sendall(NAK)  # corrupt payload: sender resends clean
            return
        if kind == KIND_EDATA and verdict[:1] == ACK:
            self._mark_delivered(key)
        conn.sendall(verdict)


# ---------------------------------------------------------- peer link


class PeerLink:
    """The sending half of one directed link.  Lazily connects (with
    connect itself inside the retry loop so a slow-starting peer is a
    transient, not an error) and keeps the connection for subsequent
    sends."""

    def __init__(self, my_rank: int, peer_rank: int, addr: str, *,
                 policy: Optional[RetryPolicy] = None,
                 ack_timeout_s: float = 30.0):
        self.my_rank = my_rank
        self.peer_rank = peer_rank
        self.addr = addr
        self.policy = policy
        self.ack_timeout_s = ack_timeout_s
        self._sock: Optional[socket.socket] = None
        # seq namespace is per-INCARNATION: peers keep a persistent
        # (src, op, seq) dedup table, so a respawned worker whose links
        # restarted at 0 would collide with its predecessor's entries
        # and have fresh frames falsely re-ACKed without delivery; the
        # pid offset keeps incarnations disjoint
        self._seq = (os.getpid() & 0x7FFF) << 16
        self._lock = make_lock("dist.peer_link")

    # ------------------------------------------------------- plumbing

    def _connect(self) -> socket.socket:
        if self._sock is not None:
            return self._sock
        fam, target = _parse_addr(self.addr)
        s = socket.socket(fam, socket.SOCK_STREAM)
        s.settimeout(self.ack_timeout_s)
        s.connect(target)
        self._sock = s
        return s

    def _drop(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def close(self) -> None:
        with self._lock:
            self._drop()

    def await_listening(self, timeout_s: float) -> None:
        """Block until the peer's listener accepts a connection: a probe,
        closed at once, from which the listener reads no frame.  Raises
        PeerDiedException after ``timeout_s``.  A worker calls this once
        at boot, so a peer still starting is not taken for a dead one."""
        fam, target = _parse_addr(self.addr)
        t0 = time.monotonic()
        while True:
            s = socket.socket(fam, socket.SOCK_STREAM)
            try:
                s.settimeout(1.0)
                s.connect(target)
                return
            except OSError as e:
                if time.monotonic() - t0 >= timeout_s:
                    raise PeerDiedException(
                        self.peer_rank, 0, last=e,
                        detail=f"not listening after {timeout_s:.1f}s"
                    ) from e
            finally:
                s.close()
            time.sleep(0.05)

    # ----------------------------------------------------------- send

    def send(self, op_id: int, payload: bytes, *,
             kind: int = KIND_DATA, epoch: int = 0,
             part: int = 0) -> int:
        """Deliver one payload; returns bytes sent.  Blocks until the
        peer ACKs (payload verified) or the retry budget dies.  Kinds
        EDATA/CTRL prepend the elastic (epoch, part) extension; a peer
        whose membership view is ahead answers the stale-epoch fence,
        surfaced as :class:`StaleEpochError` (NOT retried: resending
        the same stale frame can never merge)."""
        with self._lock:
            self._seq += 1
            seq = self._seq
        head = struct.pack(FRAME_FMT, FRAME_MAGIC, kind,
                           self.my_rank, op_id, seq, len(payload))
        if kind != KIND_DATA:
            head += struct.pack(EXT_FMT, epoch, part)
        tries = [0]

        def attempt() -> int:
            with self._lock:
                tries[0] += 1
                if tries[0] > 1:
                    count("resends")
                try:
                    s = self._connect()
                    # arm the injected fault only once a connection
                    # exists: a transient connect failure must not burn
                    # the one-shot injection before any faulty byte
                    # could hit the wire
                    fault = _take_fault(self.peer_rank, op_id)
                    if fault == "drop":
                        # injected silent frame loss: forge local
                        # success; the receiver never sees the frame
                        # and must recover by speculation/rebalance
                        return len(payload)
                    if fault == "trunc":
                        # inject a truncated link: half the payload,
                        # then a hard close mid-message
                        s.sendall(head + payload[: len(payload) // 2])
                        self._drop()
                        raise ShuffleLinkError(
                            "injected truncated link", reason="link")
                    wire = payload
                    if fault == "corrupt":
                        flip = len(payload) // 2
                        wire = (payload[:flip]
                                + bytes([payload[flip] ^ 0xFF])
                                + payload[flip + 1:])
                    delay_ms = _slow_ms(self.peer_rank)
                    if delay_ms > 0:
                        # injected per-frame straggler delay
                        time.sleep(delay_ms / 1000.0)
                    # lockdep marker: this link mutex is held across
                    # the wire round-trip BY DESIGN (it serializes one
                    # peer's protocol); the evidence lets an operator
                    # see exactly how long-held it is
                    lockdep.note_blocking("transport.send")
                    s.sendall(head + wire)
                    verdict = s.recv(1)
                    peer_epoch = b""
                    if verdict == STALE:
                        while len(peer_epoch) < 4:
                            chunk = s.recv(4 - len(peer_epoch))
                            if not chunk:
                                break
                            peer_epoch += chunk
                except OSError:
                    self._drop()
                    raise
                if verdict == ACK:
                    return len(payload)
                if verdict == STALE and len(peer_epoch) == 4:
                    # the connection stays healthy: the peer answered a
                    # complete fence verdict, it just refuses this
                    # epoch; the ELASTIC layer fast-forwards and
                    # replays, the link layer must not resend
                    raise StaleEpochError(
                        self.peer_rank, struct.unpack(">I",
                                                      peer_epoch)[0])
                self._drop()
                if verdict == NAK:
                    count("naks_recv")
                    raise ShuffleLinkError(
                        f"peer {self.peer_rank} NAKed op {op_id} "
                        f"seq {seq}", reason="nak")
                raise ShuffleLinkError(
                    f"link to peer {self.peer_rank} closed before "
                    f"verdict (op {op_id})", reason="link")

        with _obs.TRACER.span("shuffle_send", kind="shuffle_send",
                              attrs={"peer": self.peer_rank,
                                     "op": op_id,
                                     "bytes": len(payload)}):
            n = with_link_retry(attempt, peer=self.peer_rank,
                                policy=self.policy)
        _note_link("send", self.peer_rank, n, op_id)
        return n
