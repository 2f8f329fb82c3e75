"""The distributed shuffle service: partition -> kudo write -> socket
-> kudo merge, rank-ordered and byte-deterministic (layer 2 of 2 over
transport.py).

One :class:`ShuffleService` per worker process.  It implements the
pluggable table-transport interface of ``parallel/exchange.py``
(``exchange`` / ``allgather``), so pipeline code written against
``exchange.exchange_tables`` runs unchanged on one process (loopback)
or N (this service):

  * ``exchange(op_id, tables_by_dest)``: all-to-all.  Partition d goes
    to rank d; returns the merge (in SOURCE-RANK ORDER: the determinism
    the byte-identity checks lean on) of every partition addressed to
    this rank, on the device this rank's own partition lives on.
  * ``allgather(op_id, table)``: every rank contributes one table,
    every rank gets the rank-ordered concatenation.
  * ``barrier(op_id)``: an allgather of a 1-row sentinel; used to keep
    listeners alive until every peer is done.

The wire bytes are the kudo format end to end, the JAX package's byte
for byte (the port's writer never emits the KTRX trace extension, the
JAX writer only while span tracing is on), with the KCRC trailer the
receiver's verify + NAK/resend loop needs: construction fails fast if
CRC mode is off.  So a JAX rank and a port rank can share one fleet.

``op_id`` discipline: each logical exchange in a query plan gets a
distinct op id per (query, stage); the service namespaces nothing.
Collisions across CONCURRENT exchanges would cross payloads; the
distributed runner allocates ids centrally (runner.OpIds).

Elastic mode: constructed with ``elastic=True`` the service also
speaks the part-granular elastic protocol over the SAME links
(``broadcast_part`` / ``gather_parts`` / ``elastic_barrier``), with an
:class:`~spark_rapids_tpu_torch.robustness.fleet.ElasticFleet` deciding
membership and policy:

  * a ``PeerDiedException`` on any link marks the peer departed, bumps
    the membership epoch, gossips a death notice to every survivor
    (assignment is a pure function of the departed set, so agreement
    on WHO died is agreement on who inherits), and the inheritor
    recomputes the dead rank's partitions from the seeded inputs;
  * a partition still missing past the straggler signal is
    speculatively re-executed by the least-loaded survivor: the first
    verified copy wins the (op, part) dedup, and an original arriving
    mid-speculation cancels the speculative task through the
    cooperative QueryContext machinery;
  * a hot partition (payload >> the op's median, cross-checked against
    the per-link byte counters) re-splits into per-rank sub-frames
    stitched back in index order;
  * every verified part payload is retained (bounded) as a REPLAY
    store: a FETCH control message re-serves the original CRC'd bytes,
    which is how a respawned worker catches up to a round that finished
    without it.

``events`` keeps the fleet's decisions (``fleet_inherit``,
``fleet_speculation``, ``fleet_resplit``, ``shuffle_dup_dropped``); the
same decisions go to the observability journal and ``srt_fleet_*``
counters, exchanges and gathers open ``shuffle_exchange`` /
``elastic_gather`` spans with their wire and wait times recorded, and
sender and control threads adopt the caller's (or ``trace_ctx``'s)
span context.  Rank 0 holds the fleet timeseries merger
(``fleet_timeseries``): workers ship their windowed telemetry
snapshots to it with :meth:`ShuffleService.publish_timeseries` over a
``timeseries`` control message.
"""

from __future__ import annotations

import io
import json
import os
import struct
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Set

import torch

from spark_rapids_tpu_torch import observability as _obs
from spark_rapids_tpu_torch.analysis.lockdep import make_lock

from spark_rapids_tpu_torch.columns import dtypes
from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.columns.table import Table
from spark_rapids_tpu_torch.distributed import transport as _tr
from spark_rapids_tpu_torch.distributed.transport import (
    ACK, KIND_CTRL, KIND_EDATA, MAX_RESPLIT_SUBS, STALE, Inbox,
    Listener, PartInbox, PeerLink, pack_resplit, unpack_resplit)
from spark_rapids_tpu_torch.observability.timeseries import FleetTimeseries
from spark_rapids_tpu_torch.parallel import exchange as _exchange
from spark_rapids_tpu_torch.robustness.fleet import (
    ElasticFleet, StaleEpochError)
from spark_rapids_tpu_torch.robustness.links import PeerDiedException
from spark_rapids_tpu_torch.robustness.retry import RetryPolicy
from spark_rapids_tpu_torch.shuffle import kudo as _kudo
from spark_rapids_tpu_torch.shuffle.schema import schema_of_table


def _sentinel(rank: int) -> Table:
    """The one-row INT64 table a barrier round carries."""
    return Table([Column(dtypes.INT64, 1, data=torch.tensor(
        [rank], dtype=torch.int64))])


class ShuffleService:
    """N-rank shuffle fabric over TCP/unix sockets."""

    def __init__(self, rank: int, world: int,
                 addresses: Sequence[str], *,
                 policy: Optional[RetryPolicy] = None,
                 recv_timeout_s: float = 120.0,
                 elastic: bool = False,
                 fleet: Optional[ElasticFleet] = None):
        if len(addresses) != world:
            raise ValueError(
                f"need {world} addresses, got {len(addresses)}")
        if not _kudo.crc_enabled():
            raise RuntimeError(
                "ShuffleService requires KCRC trailers "
                "(kudo.set_crc_enabled(True) or "
                "SPARK_RAPIDS_TPU_KUDO_CRC=1): the link NAK/resend "
                "protocol verifies payloads by CRC")
        self.rank = int(rank)
        self.world = int(world)
        self.addresses = list(addresses)
        self.recv_timeout_s = recv_timeout_s
        self.inbox = Inbox()
        self.fleet = fleet or (ElasticFleet(rank, world)
                               if elastic else None)
        self.parts = PartInbox() if self.fleet is not None else None
        self.listener = Listener(
            self.rank, self.addresses[self.rank], self.inbox,
            sink=self if self.fleet is not None else None)
        self.links: Dict[int, PeerLink] = {
            r: PeerLink(self.rank, r, addresses[r], policy=policy)
            for r in range(world) if r != self.rank}
        self._started = False
        # fleet telemetry merger: every rank holds one (cheap), but
        # only rank 0 receives publishes — workers ship their windowed
        # snapshots here over the CTRL path
        self.fleet_timeseries = FleetTimeseries()
        self._lock = make_lock("dist.service")
        # per-op first-touch monotonic ns: arrival gaps feed the
        # straggler window relative to when THIS rank engaged the op
        self._op_t0: Dict[int, int] = {}
        self._op_t0_lock = make_lock("dist.service.op_t0")
        self.events: List[dict] = []
        self._events_lock = make_lock("dist.service.events")
        # this process's incarnation, sent in its joins, and the last
        # incarnation each peer joined with: a join resent after a lost
        # ACK carries the same one and changes nothing
        self.incarnation = os.urandom(8).hex()
        self._joined: Dict[int, str] = {}
        self._join_lock = make_lock("dist.service.join")
        # fallback trace context for control/replay daemon threads
        # (they have no ambient span: without this every replayed
        # shuffle_send would root a fresh orphan trace and break the
        # one-stitched-tree invariant across a worker respawn)
        self.trace_ctx = None

    # ------------------------------------------------------- lifecycle

    def start(self) -> "ShuffleService":
        with self._lock:
            if not self._started:
                self.listener.start()
                self._started = True
        return self

    def stop(self) -> None:
        with self._lock:
            if not self._started:
                return
            self._started = False
        for link in self.links.values():
            link.close()
        self.listener.stop()

    def await_peers(self, timeout_s: Optional[float] = None) -> None:
        """Block until every peer listens (PeerLink.await_listening),
        for at most ``timeout_s`` (default ``recv_timeout_s``) a peer."""
        t = self.recv_timeout_s if timeout_s is None else timeout_s
        for link in self.links.values():
            link.await_listening(t)

    def __enter__(self) -> "ShuffleService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _event(self, kind: str, **detail) -> None:
        with self._events_lock:
            self.events.append(dict(kind=kind, **detail))

    # ------------------------------------------------------- transport

    def _serialize(self, table) -> bytes:
        buf = io.BytesIO()
        _kudo.write_to_stream_with_metrics(
            table.columns, buf, 0, table.num_rows)
        return buf.getvalue()

    def exchange(self, op_id: int, tables_by_dest, fields=None):
        """All-to-all one round: returns the Table merged from every
        rank's partition addressed to this rank, sources concatenated
        in rank order, on the device of this rank's own partition."""
        if len(tables_by_dest) != self.world:
            raise ValueError(
                f"need {self.world} destination partitions, got "
                f"{len(tables_by_dest)}")
        mine = tables_by_dest[self.rank]
        if fields is None:
            fields = schema_of_table(mine)
        with _obs.TRACER.span("shuffle_exchange", kind="stage",
                              attrs={"op": op_id,
                                     "world": self.world}) as sp:
            # serialize once per DISTINCT table: allgather passes the
            # same object to every destination, so an N-rank gather
            # pays one kudo write, not N identical ones
            t_wire = time.monotonic_ns()
            blob_cache: Dict[int, bytes] = {}
            payloads = []
            for t in tables_by_dest:
                blob = blob_cache.get(id(t))
                if blob is None:
                    blob = blob_cache[id(t)] = self._serialize(t)
                payloads.append(blob)
            # local partition loops back through the same parsed form
            # (read_tables verifies its CRC too: uniform path)
            local = _kudo.read_tables(io.BytesIO(payloads[self.rank]))
            # wire vs wait are sequential, non-overlapping segments on
            # this thread (_send_all joins every sender before the
            # inbox wait starts)
            sent = self._send_all(op_id, payloads)
            t_wait = time.monotonic_ns()
            _obs.record_shuffle_wire(op_id, t_wait - t_wire)
            others = [r for r in range(self.world) if r != self.rank]
            received = self.inbox.wait(op_id, others,
                                       self.recv_timeout_s) \
                if others else {}
            _obs.record_shuffle_wait(
                op_id, time.monotonic_ns() - t_wait)
            received[self.rank] = local
            tables: List[_kudo.KudoTable] = []
            for src in range(self.world):
                tables.extend(received[src])
            sp.set_attr("bytes_sent", sent)
            return _kudo.merge_to_table_with_metrics(
                tables, fields, _exchange.table_device(mine))[0]

    def _send_all(self, op_id: int, payloads) -> int:
        """One send per peer link, all in flight CONCURRENTLY: every
        send blocks for its peer's verify+ACK (or its retry budget), so
        a sequential loop would serialize world-1 round trips.  Joins
        all senders; the first failure (after every thread settled)
        escalates."""
        sent = [0] * self.world
        errs: List[Optional[BaseException]] = [None] * self.world
        # sender threads start with an EMPTY tracer context stack:
        # adopt the caller's open span so each link's shuffle_send
        # span parents under the exchange instead of rooting a new
        # (orphan) trace
        ctx = _obs.TRACER.current_context()

        def one(dst: int) -> None:
            holder = _obs.TRACER.activate(ctx)
            try:
                sent[dst] = self.links[dst].send(op_id, payloads[dst])
            # srt-lint: disable=SRT007 captured into errs and re-raised by the collector after every worker joins
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errs[dst] = e
            finally:
                holder.end()

        workers = [threading.Thread(
            target=one, args=(dst,),
            name=f"srt-shuffle-send-{self.rank}-{dst}", daemon=True)
            for dst in range(self.world) if dst != self.rank]
        for w in workers:
            w.start()
        for w in workers:
            w.join()
        for e in errs:
            if e is not None:
                raise e
        return sum(sent)

    def allgather(self, op_id: int, table, fields=None):
        """Every rank contributes ``table``; everyone receives the
        rank-ordered concatenation."""
        return self.exchange(op_id, [table] * self.world, fields)

    def barrier(self, op_id: int) -> None:
        """Block until every rank reached this op: an allgather of a
        one-row sentinel.  Run before teardown so no peer's listener
        disappears while another rank still owes/awaits payloads."""
        out = self.allgather(op_id, _sentinel(self.rank))
        if out.num_rows != self.world:
            raise RuntimeError(
                f"barrier saw {out.num_rows} ranks, want {self.world}")

    # ------------------------------------------------- elastic: sink
    # (listener handler threads call these for EDATA/CTRL frames)

    def _op_start(self, op_id: int) -> int:
        with self._op_t0_lock:
            t0 = self._op_t0.get(op_id)
            if t0 is None:
                t0 = self._op_t0[op_id] = time.monotonic_ns()
                if len(self._op_t0) > 256:
                    self._op_t0.pop(next(iter(self._op_t0)))
            return t0

    def _dup(self, src: int, op_id: int, part: int, status: str) -> None:
        _tr.count("dup_dropped")
        identical = (None if status == "dup_framing"
                     else status == "dup_identical")
        _obs.record_shuffle_dup_dropped(src, op_id, part, identical)
        self._event("shuffle_dup_dropped", src=src, op=op_id, part=part,
                    identical=identical)

    def on_edata(self, src: int, op_id: int, seq: int, epoch: int,
                 part_field: int, payload: bytes) -> bytes:
        """Verify + deliver one elastic data frame; returns the verdict
        bytes.  Raises ValueError/EOFError on a corrupt payload (the
        listener answers NAK)."""
        fleet = self.fleet
        if fleet.is_stale(epoch):
            _obs.record_fleet_stale_nak(src, epoch, fleet.epoch)
            _tr.count("stale_naks")
            return STALE + struct.pack(">I", fleet.epoch)
        fleet.learn_epoch(epoch)
        # a current-epoch frame from a departed rank is merged (the
        # data is fine) but does NOT resurrect its membership: a
        # respawned worker announces itself with an explicit join CTRL
        # (ordered before its data on the same link), while a late
        # in-flight frame from a peer that gracefully LEFT must not
        # pull it back into the live set
        tables = _kudo.read_tables(io.BytesIO(payload))
        t0 = self._op_start(op_id)
        sub = unpack_resplit(part_field)
        if sub is None:
            part = part_field
            status = self.parts.put(op_id, part, tables, payload)
        else:
            part, k, nsub = sub
            status = self.parts.put_sub(op_id, part, k, nsub, tables,
                                        payload)
        if status.startswith("dup"):
            self._dup(src, op_id, part, status)
        elif status == "new":
            fleet.note_arrival(op_id, part, src,
                               time.monotonic_ns() - t0)
            # received payloads feed the op's skew window too
            fleet.note_part_bytes(op_id, len(payload))
        _tr._note_link("recv", src, len(payload), op_id)
        return ACK

    def on_ctrl(self, src: int, epoch: int, payload: bytes) -> bytes:
        """Control dispatch: death notices, joins, leaves, replay
        fetches, membership-view answers.  Always ACKs (notices are
        idempotent); malformed JSON raises ValueError -> NAK."""
        obj = json.loads(payload.decode("utf-8"))
        fleet = self.fleet
        typ = obj.get("type")
        if typ == "death":
            if fleet.note_death(obj.get("dead", ()),
                                epoch_hint=int(obj.get("epoch", 0))):
                self.parts.wake()
        elif typ == "join":
            joiner = int(obj.get("rank", src))
            inc = obj.get("inc")
            with self._join_lock:
                if (inc is not None and self._joined.get(joiner) != inc
                        and joiner != self.rank
                        and joiner in fleet.view().live):
                    # only a respawned worker joins: a NEW incarnation
                    # of a rank we still count live means the old one
                    # died unseen (it came back before a link to it
                    # failed, its part speculated or still awaited).
                    # Fold the death in first, so the membership
                    # records it, its shards move as after a seen
                    # death, and the view we answer carries the new
                    # epoch the joiner waits for.  A resent copy of
                    # the same join (lost ACK) finds its incarnation
                    # recorded and only re-notes the join
                    fleet.note_death([joiner])
                if inc is not None:
                    self._joined[joiner] = inc
                fleet.note_join(joiner)
            self.parts.wake()
            # answer the joiner with our view so it fast-forwards its
            # epoch + departed set without waiting to be fenced
            self._spawn(self._send_view, joiner)
        elif typ == "leave":
            if fleet.note_leave(int(obj.get("rank", src))):
                self.parts.wake()
        elif typ == "view":
            fleet.note_death(obj.get("departed", ()),
                             epoch_hint=int(obj.get("epoch", 0)))
            fleet.learn_epoch(int(obj.get("epoch", 0)))
            self.parts.wake()
        elif typ == "fetch":
            # byte-safe replay: re-serve the retained CRC'd payloads
            # for the op (off the handler thread: replay sends block
            # for ACKs and must not stall this connection's reads)
            self._spawn(self._replay, src, int(obj.get("op", -1)),
                        obj.get("parts"))
        elif typ == "timeseries":
            # windowed telemetry publish: fold into the fleet merger —
            # dup windows dedup by sequence, snapshots from a stale
            # membership epoch are fenced outright (the frame-level
            # epoch fence already rejected older CARRIER epochs; this
            # guards the snapshot's own claimed epoch)
            snap = obj.get("snap") or {}
            outcome = self.fleet_timeseries.offer(snap)
            _obs.record_timeseries_merge(
                outcome, int(snap.get("rank", src)))
        else:
            raise ValueError(f"unknown control type {typ!r}")
        return ACK

    def _spawn(self, fn, *args) -> None:
        ctx = _obs.TRACER.current_context() or self.trace_ctx

        def run() -> None:
            holder = _obs.TRACER.activate(ctx)
            try:
                fn(*args)
            finally:
                holder.end()

        threading.Thread(target=run, daemon=True,
                         name=f"srt-fleet-ctrl-{self.rank}").start()

    # ----------------------------------------- elastic: send helpers

    def _elastic_send(self, dst: int, op_id: int, part_field: int,
                      payload: bytes, *, kind: int = KIND_EDATA
                      ) -> int:
        """One elastic send with stale-epoch fast-forward: a fence
        verdict teaches us the peer's epoch and the frame replays under
        it (bounded: a peer that keeps advancing mid-send is still
        making progress, not failing)."""
        for _ in range(3):
            try:
                return self.links[dst].send(
                    op_id, payload, kind=kind,
                    epoch=self.fleet.epoch, part=part_field)
            except StaleEpochError as e:
                self.fleet.learn_epoch(e.epoch)
        return 0  # persistently fenced: the peer no longer needs us

    def _send_ctrl(self, dst: int, obj: dict) -> None:
        payload = json.dumps(obj, sort_keys=True).encode("utf-8")
        self._elastic_send(dst, 0, 0, payload, kind=KIND_CTRL)

    def _send_view(self, dst: int) -> None:
        view = self.fleet.view()
        try:
            self._send_ctrl(dst, {
                "type": "view", "epoch": view.epoch,
                "departed": sorted(view.departed)})
        except (PeerDiedException, OSError):
            pass  # the joiner died again; its next join retries

    def publish_timeseries(self, snap: Optional[dict] = None
                           ) -> Optional[str]:
        """Ship this rank's windowed telemetry snapshot to rank 0's
        fleet merger over the CTRL path (rank 0 folds locally).  The
        send blocks for the ACK, so a completed publish IS merged —
        callers sequencing publish-then-barrier get a fully folded
        rank-0 view after the barrier.  Returns the merge outcome
        ('merged'/'dup'/'stale_epoch') on rank 0, 'sent' elsewhere,
        None when there is no elastic fabric (the launcher dump-dir
        tier covers that case offline)."""
        if self.fleet is None:
            return None
        if snap is None:
            snap = _obs.timeseries_snapshot(rank=self.rank,
                                            epoch=self.fleet.epoch)
        if self.rank == 0:
            outcome = self.fleet_timeseries.offer(snap)
            _obs.record_timeseries_merge(outcome, self.rank)
            return outcome
        try:
            self._send_ctrl(0, {"type": "timeseries", "snap": snap})
            return "sent"
        except (PeerDiedException, OSError):
            return None  # rank 0 is gone; nothing to publish to

    def _replay(self, dst: int, op_id: int, parts=None) -> None:
        blobs = self.parts.payloads(op_id)
        want = None if parts is None else set(int(p) for p in parts)
        for part, blob in sorted(blobs.items()):
            if want is not None and part not in want:
                continue
            try:
                self._elastic_send(dst, op_id, part, blob)
            except (PeerDiedException, OSError):
                return  # requester gone; nothing to do

    def _report_death(self, dead_rank: int) -> None:
        """A link to ``dead_rank`` exhausted its budget: fold the death
        in and gossip the notice to every survivor, the fleet-wide
        membership barrier.  Survivors that also failed to reach the
        peer converge on the same (departed, epoch) facts; assignment
        being a pure function of those facts IS the agreement."""
        fleet = self.fleet
        pending = {int(dead_rank)}
        while pending:
            d = pending.pop()
            if not fleet.note_death([d]):
                continue
            self.parts.wake()
            view = fleet.view()
            notice = {"type": "death", "dead": sorted(view.departed),
                      "epoch": view.epoch}
            for peer in sorted(view.live):
                if peer == self.rank:
                    continue
                try:
                    self._send_ctrl(peer, notice)
                except (PeerDiedException, OSError):
                    pending.add(peer)  # it died too: fold + re-gossip

    # -------------------------------------------- elastic: broadcast

    def broadcast_part(self, op_id: int, part: int, table, *,
                       resplit: bool = True) -> int:
        """Deliver one logical partition to EVERY live rank (self
        included: the local copy seeds the replay store and wins the
        dedup race for our own work).  A payload flagged hot by the
        fleet's skew signal re-splits into per-rank sub-frames.  A peer
        dying mid-fanout triggers the membership barrier and the
        broadcast continues to the survivors."""
        if self.fleet is None:
            raise RuntimeError("broadcast_part requires elastic=True")
        self._op_start(op_id)
        payload = self._serialize(table)
        hot = self.fleet.hot_part(op_id, len(payload)) \
            if resplit else None
        self.fleet.note_part_bytes(op_id, len(payload))
        if hot and table.num_rows >= 2:
            return self._broadcast_resplit(op_id, part, table, hot)
        status = self.parts.put(
            op_id, part, _kudo.read_tables(io.BytesIO(payload)),
            payload)
        if status != "new":
            return len(payload)  # a copy already won: spare the wire
        self._fanout(op_id, [(part, payload)])
        return len(payload)

    def _broadcast_resplit(self, op_id: int, part: int, table,
                           hot: dict) -> int:
        """Second sub-partitioned exchange round for a hot partition:
        row-sliced into one sub-frame per live rank, stitched back in
        index order by every receiver (concatenation of row slices is
        byte-identical to the unsplit table)."""
        view = self.fleet.view()
        rows = int(table.num_rows)
        nsub = max(2, min(self.fleet.policy.resplit_factor(view),
                          rows, MAX_RESPLIT_SUBS))
        subs: List[tuple] = []
        for k in range(nsub):
            lo = k * rows // nsub
            hi = (k + 1) * rows // nsub
            buf = io.BytesIO()
            _kudo.write_to_stream_with_metrics(
                table.columns, buf, lo, hi - lo)
            blob = buf.getvalue()
            self.parts.put_sub(
                op_id, part, k, nsub,
                _kudo.read_tables(io.BytesIO(blob)), blob)
            subs.append((pack_resplit(part, k, nsub), blob))
        total = sum(len(b) for _, b in subs)
        evidence = dict(hot, link_skew=self.fleet.link_skew())
        _obs.record_fleet_resplit(op_id, part, nsub, total,
                                  evidence=evidence)
        self._event("fleet_resplit", op=op_id, part=part, nsub=nsub,
                    bytes=total, evidence=evidence)
        self._fanout(op_id, subs)
        return total

    def _fanout(self, op_id: int, frames: List[tuple]) -> None:
        """Send (part_field, payload) frames to every live peer
        concurrently (one thread per peer, frames in order on each
        link).  Peer deaths fold into the membership barrier instead of
        failing the broadcast."""
        view = self.fleet.view()
        peers = [r for r in sorted(view.live) if r != self.rank]
        if not peers:
            return
        t_wire = time.monotonic_ns()
        dead: List[int] = []  # list.append is GIL-atomic
        ctx = _obs.TRACER.current_context()

        def one(dst: int) -> None:
            holder = _obs.TRACER.activate(ctx)
            try:
                for part_field, payload in frames:
                    self._elastic_send(dst, op_id, part_field, payload)
            except (PeerDiedException, OSError):
                dead.append(dst)
            finally:
                holder.end()

        workers = [threading.Thread(
            target=one, args=(d,), daemon=True,
            name=f"srt-fleet-bcast-{self.rank}-{d}") for d in peers]
        for w in workers:
            w.start()
        for w in workers:
            w.join()
        _obs.record_shuffle_wire(op_id,
                                 time.monotonic_ns() - t_wire)
        for d in dead:
            self._report_death(d)

    # ----------------------------------------------- elastic: gather

    def gather_parts(self, op_id: int, want,
                     *,
                     owner_of: Optional[Callable[[int], int]] = None,
                     compute: Optional[Callable] = None,
                     deadline_s: Optional[float] = None,
                     fetch_after_s: Optional[float] = None,
                     drop_departed: bool = False) -> Dict[int, list]:
        """Collect logical partitions, elastically.

        ``want``: part ids, or a callable ``view -> part ids`` (the
        barrier's membership-sensitive want).  ``owner_of``: part ->
        ORIGINAL owner rank (default: the fleet assignment, i.e. part
        == shard).  ``compute``: ``(part, ctx) -> Table``
        deterministic recompute; enables rebalance inheritance and
        straggler speculation; ``ctx`` is a cancel-capable QueryContext
        (None for non-speculative recomputes).  ``drop_departed``: on
        deadline, departed owners' parts are dropped from the want set
        instead of failing (barrier semantics).  Returns {part:
        [KudoTable...]}."""
        if self.fleet is None:
            raise RuntimeError("gather_parts requires elastic=True")
        fleet = self.fleet
        deadline = (deadline_s if deadline_s is not None
                    else self.recv_timeout_s)
        fetch_after = (fetch_after_s if fetch_after_s is not None
                       else min(2.0, fleet.spec_delay_s))
        t0 = time.monotonic()
        self._op_start(op_id)
        done: Set[int] = set()       # parts I computed/speculated
        spec_seen: Set[int] = set()  # parts with a resolved decision
        last_fetch = 0.0
        fetch_rr = 0
        # gather idle, split by cause: waits while any missing part is
        # under a live speculation decision are a straggler's story
        # (speculation_wait), the rest ordinary inbox idle
        wait_ns = 0
        spec_wait_ns = 0
        with _obs.TRACER.span("elastic_gather", kind="stage",
                              attrs={"op": op_id}) as sp:
            while True:
                view = fleet.view()
                want_now = set(want(view) if callable(want) else want)
                missing = sorted(want_now - self.parts.have(op_id))
                if not missing:
                    break
                elapsed = time.monotonic() - t0
                for p in missing:
                    if owner_of is not None:
                        orig = resp = owner_of(p)
                    elif 0 <= p < view.world0:
                        # shard gather: shard p started on rank p; the
                        # CURRENT assignment names who answers for it after
                        # any rebalance
                        orig, resp = p, view.owner(p)
                    else:
                        orig = resp = p
                    if compute is not None and resp == self.rank \
                            and p not in done:
                        # my part: mine originally, or inherited from a
                        # departed rank at this epoch
                        if orig != self.rank:
                            _obs.JOURNAL.emit(
                                "fleet_inherit", op=op_id, part=p,
                                dead_owner=orig, epoch=view.epoch)
                            self._event("fleet_inherit", op=op_id, part=p,
                                        dead_owner=orig, epoch=view.epoch)
                        done.add(p)
                        self.broadcast_part(op_id, p, compute(p, None))
                        continue
                    if compute is not None and p not in spec_seen \
                            and resp != self.rank \
                            and resp not in view.departed:
                        ev = fleet.should_speculate(op_id,
                                                    int(elapsed * 1e9))
                        if ev:
                            spec_seen.add(p)
                            if fleet.policy.speculator(
                                    view, resp) == self.rank:
                                done.add(p)
                                self._speculate(op_id, p, resp, compute, ev)
                if missing and elapsed - last_fetch >= fetch_after \
                        and elapsed >= fetch_after:
                    # replay fetch (periodic): covers silently-dropped
                    # frames, late joiners catching up on a finished round,
                    # and replays lost to a peer's death (a failed fetch IS
                    # the death detection).  One peer per interval,
                    # round-robin.
                    last_fetch = elapsed
                    fetch_peers = [p for p in sorted(view.live)
                                   if p != self.rank]
                    if fetch_peers:
                        peer = fetch_peers[fetch_rr % len(fetch_peers)]
                        fetch_rr += 1
                        self._spawn(self._fetch_from, peer, op_id,
                                    list(missing))
                if elapsed >= deadline:
                    missing = sorted(set(want_now) - self.parts.have(op_id))
                    if not missing:
                        break
                    if drop_departed:
                        live_missing = [
                            p for p in missing
                            if (owner_of(p) if owner_of else p)
                            not in view.departed]
                        if not live_missing:
                            break  # only ghosts missing: proceed
                        missing = live_missing
                    if compute is not None:
                        # terminal fallback: every input is seeded and
                        # deterministic, so local recompute converges (the
                        # fleet may be unreachable, the answer is not)
                        for p in missing:
                            self.broadcast_part(op_id, p, compute(p, None))
                        continue
                    raise PeerDiedException(
                        ",".join(str(owner_of(p) if owner_of else p)
                                 for p in missing),
                        0, detail=f"elastic gather op {op_id}: parts "
                                  f"{missing} missing after "
                                  f"{deadline:.1f}s")
                t_w = time.monotonic_ns()
                self.parts.wait_any(op_id, missing, 0.1)
                dt = time.monotonic_ns() - t_w
                if spec_seen.intersection(missing):
                    spec_wait_ns += dt
                else:
                    wait_ns += dt
            _obs.record_shuffle_wait(op_id, wait_ns, spec_wait_ns)
            have = self.parts.get(op_id)
            want_final = set(want(fleet.view()) if callable(want) else want)
            sp.set_attr("parts", len(want_final))
            sp.set_attr("epoch", fleet.epoch)
            return {p: have[p] for p in want_final if p in have}

    def _fetch_from(self, peer: int, op_id: int, parts=None) -> None:
        try:
            self._send_ctrl(peer, {"type": "fetch", "op": op_id,
                                   "parts": parts})
        except (PeerDiedException, OSError):
            self._report_death(peer)

    def _speculate(self, op_id: int, part: int, owner: int, compute,
                   evidence: dict) -> None:
        """Speculatively re-execute a straggler's partition.  The first
        byte-identical result wins the (op, part) dedup; if the
        original arrives while we compute, the cancel event trips and
        the speculative task unwinds through the cooperative
        QueryContext machinery (outcome 'cancelled')."""
        from spark_rapids_tpu_torch.models import (QueryCancelled,
                                                   QueryContext)
        cancel = threading.Event()
        done = threading.Event()

        def watch() -> None:
            # trip the cancel the moment the original lands
            while not done.is_set():
                if self.parts.wait_any(op_id, {part}, 0.2):
                    cancel.set()
                    return

        threading.Thread(target=watch, daemon=True,
                         name=f"srt-fleet-spec-watch-{self.rank}").start()
        ctx = QueryContext(query_id=f"spec:{op_id}:{part}",
                           cancel_event=cancel)

        def outcome(what: str) -> None:
            _obs.record_fleet_speculation(op_id, part, owner, self.rank,
                                          what, evidence)
            self._event("fleet_speculation", op=op_id, part=part,
                        owner=owner, by=self.rank, outcome=what,
                        evidence=evidence)

        try:
            table = compute(part, ctx)
        except QueryCancelled:
            outcome("cancelled")
            return
        finally:
            done.set()
        payload = self._serialize(table)
        status = self.parts.put(
            op_id, part, _kudo.read_tables(io.BytesIO(payload)),
            payload)
        if status == "new":
            outcome("won")
            self._fanout(op_id, [(part, payload)])
        else:
            outcome("lost")

    # ---------------------------------------------- elastic: barrier

    def elastic_barrier(self, op_id: int,
                        deadline_s: Optional[float] = None) -> None:
        """Membership-tolerant barrier: every rank broadcasts a
        sentinel part keyed by its RANK and waits for the sentinels of
        the ranks it owes waiting to: the live set, or (when the
        launcher may respawn the dead: SPARK_RAPIDS_TPU_FLEET_RESPAWN)
        the full original world but the ranks that left gracefully, so
        a rejoining worker finds its peers still listening and can
        catch up by replay.  Departed ranks that never return are
        dropped at the deadline.

        A leave proves the leaver passed its own barrier, so it never
        holds a waiter up.  The JAX package keeps a leaver in the
        full-world want: a respawned rank that joined after the
        survivors' sentinels went out waited out the whole deadline
        for ranks that had already left."""
        if deadline_s is None:
            try:
                deadline_s = float(os.environ.get(
                    "SPARK_RAPIDS_TPU_FLEET_BARRIER_S", "") or 120.0)
            except ValueError:
                deadline_s = 120.0
        await_all = os.environ.get(
            "SPARK_RAPIDS_TPU_FLEET_RESPAWN", "") == "1"
        self.broadcast_part(op_id, self.rank, _sentinel(self.rank),
                            resplit=False)

        def want(view):
            return (set(range(view.world0)) - self.fleet.left
                    if await_all else set(view.live))

        self.gather_parts(op_id, want, owner_of=lambda p: p,
                          deadline_s=deadline_s, drop_departed=True)

    def leave_fleet(self) -> None:
        """Graceful departure: tell every live peer we are leaving so
        their barrier wants shrink NOW instead of waiting out a death
        detection (sent after this rank passed its own barrier, so a
        peer dropping us from its want set is provably safe).
        Best-effort: peers already gone are skipped."""
        if self.fleet is None:
            return
        view = self.fleet.view()
        for peer in sorted(view.live):
            if peer == self.rank:
                continue
            try:
                self._send_ctrl(peer, {"type": "leave",
                                       "rank": self.rank})
            except (PeerDiedException, OSError):
                continue

    def join_fleet(self, timeout_s: float = 10.0) -> None:
        """(Re)join a running fleet: announce to every peer, then wait
        briefly for a view answer so our epoch + departed set are
        current before we start fencing/being fenced."""
        if self.fleet is None:
            raise RuntimeError("join_fleet requires elastic=True")
        base = self.fleet.epoch
        for peer in range(self.world):
            if peer == self.rank:
                continue
            try:
                self._send_ctrl(peer, {"type": "join",
                                       "rank": self.rank,
                                       "inc": self.incarnation})
            except (PeerDiedException, OSError):
                continue
        t0 = time.monotonic()
        while time.monotonic() - t0 < timeout_s:
            if self.fleet.epoch > base:
                return
            time.sleep(0.05)

    # ---------------------------------------------------- installation

    def install(self) -> "ShuffleService":
        """Register as the process's table transport
        (parallel/exchange.exchange_tables routes here)."""
        _exchange.set_table_transport(self)
        return self

    def uninstall(self) -> None:
        if _exchange._TABLE_TRANSPORT[0] is self:
            _exchange.set_table_transport(None)
