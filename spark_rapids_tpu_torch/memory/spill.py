"""Tiered spill store: run THROUGH memory pressure instead of around it.

The OOM state machine (memory/spark_resource_adaptor.py) can only roll
a blocked thread back (BUFN -> GpuRetryOOM) or make it split its input
toward a one-element floor.  The reference's L3b design pairs that
machinery with a spill framework: device buffers registered as
SPILLABLE move down a tier ladder under pressure and stream back on
demand, so an over-memory join completes out-of-core instead of
shedding.  This module is that framework:

  device tier   the registered column batch, resident; its bytes are
                reserved through the installed SparkResourceAdaptor
  host tier     the batch serialized as ONE kudo table with a FORCED
                KCRC trailer (spilled bytes are corruption-checked on
                read-back) held in host memory, device reservation
                released and the columns dropped
  disk tier     the same kudo bytes in a file under
                ``SPARK_RAPIDS_TPU_SPILL_DIR``, demoted when host
                bytes exceed ``SPARK_RAPIDS_TPU_SPILL_HOST_LIMIT_BYTES``

The spilled bytes equal the JAX package's for the same table.  A batch
on a CUDA device is packed by the device split (shuffle/device_split.py:
the byte-identical blob in one ``torch.cat``) and copied to the host
once; restore copies the table back to the handle's device once and
assembles it there.  CPU batches take the host writer and merger
(``SPARK_RAPIDS_TPU_FORCE_DEVICE_SHUFFLE`` picks as in
shuffle/split_assemble.py).  The handle records its columns' device at
``register`` and restore lands there: nothing falls back to another
device.  A spill frees device memory only when the caller holds no other
reference to the columns: the store drops its own.

Victim selection is driven by the memory ledger: candidates are
ranked (lowest task priority first, largest resident-task bytes
first, largest handle first) — the same ordering the adaptor's
deadlock breaker uses to pick who rolls back, so the store spills
exactly the data whose owner would otherwise be BUFN'd.

``ensure_headroom(bytes)`` is the synchronous hook the state machine
calls BEFORE escalating a blocked thread to BUFN/retry-split (see
SparkResourceAdaptor.allocate / _check_and_update_for_bufn).  All
device-side releases/re-acquisitions run inside
``spill_range_start/done`` so the adaptor's recursive-allocation path
recognizes them as spill-side work and keeps task footprints honest.

A corrupt spill file (CRC mismatch on read-back) surfaces *file path
+ spill generation* in :class:`KudoCorruptException` and — when the
handle registered a ``recompute`` callback — triggers recompute-from-
source instead of query failure.

Spills, restores, waits and corrupt read-backs are recorded through
the observability spine (``record_spill*``), one switch read while it
is off.
"""

from __future__ import annotations

import io
import os
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch import observability as _obs

TIER_DEVICE = "device"
TIER_HOST = "host"
TIER_DISK = "disk"
TIER_FREED = "freed"

_MAX_PRIORITY = 2**63 - 1


def task_priority(task_id: Optional[int]) -> int:
    """The adaptor's thread-priority formula (larger = higher
    priority = spilled LAST): pool/shuffle data (no task) outranks
    every task; among tasks, lower task ids are older and keep their
    memory longer."""
    if task_id is None:
        return _MAX_PRIORITY
    return _MAX_PRIORITY - (int(task_id) + 1)


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name, "")
    if not v:
        return None
    try:
        return int(v)
    except ValueError:
        return None


def device_budget_bytes() -> Optional[int]:
    """``SPARK_RAPIDS_TPU_DEVICE_BUDGET_BYTES`` — the build-side
    budget past which ops/out_of_core partitions and spills (None =
    unlimited, the disabled path).  Read on every call."""
    return _env_int("SPARK_RAPIDS_TPU_DEVICE_BUDGET_BYTES")


def columns_nbytes(columns: Sequence) -> int:
    """Byte size of a column batch (data + validity + offsets +
    children), used as the handle's device reservation size when the
    caller doesn't pass one.  Tensor metadata only: no device sync."""
    total = 0
    for c in columns:
        for buf in (c.data, c.validity, c.offsets):
            if buf is not None:
                total += buf.numel() * buf.element_size()
        total += columns_nbytes(c.children)
    return total


class SpillHandle:
    """One registered spillable column batch.  State transitions are
    owned by the store; callers hold the handle and use :meth:`get`
    (restore-on-demand) and :meth:`close`."""

    __slots__ = ("store", "handle_id", "name", "task_id", "stage",
                 "device_bytes", "device", "columns", "fields", "payload",
                 "path", "tier", "generation", "closed", "busy", "pins",
                 "recompute", "_priority", "spill_seq", "disk_nbytes")

    def __init__(self, store: "SpillStore", handle_id: int, name: str,
                 columns, device_bytes: int, task_id: Optional[int],
                 stage: str, priority: Optional[int],
                 recompute: Optional[Callable[[], Sequence]]):
        self.store = store
        self.handle_id = handle_id
        self.name = name
        self.task_id = task_id
        self.stage = stage
        self.device_bytes = int(device_bytes)
        self.columns = list(columns)
        # restore lands on the device the columns were registered on
        self.device = (self.columns[0].device if self.columns
                       else torch.device("cpu"))
        self.fields = None          # captured at first spill
        self.payload = None         # host tier: kudo bytes (bytes/ndarray)
        self.path: Optional[str] = None
        self.tier = TIER_DEVICE
        self.generation = 0         # bumps on every device->host spill
        self.closed = False
        self.busy = False           # a restore/demotion is in flight
        self.pins = 0               # callers computing on the columns
        self.recompute = recompute
        self._priority = priority
        self.spill_seq = 0          # FIFO order for host->disk demotion
        self.disk_nbytes = 0        # bytes on disk (accounting, locked)

    @property
    def priority(self) -> int:
        return (self._priority if self._priority is not None
                else task_priority(self.task_id))

    def get(self):
        """The batch's columns, restoring from host/disk when spilled.
        Synchronous; the restore-side device reservation runs inside a
        spill range so the OOM machinery sees it as spill-path work.

        NOTE: the returned columns are NOT protected from a concurrent
        ``ensure_headroom`` — the handle stays victim-eligible and its
        device reservation may be released while the caller computes.
        Callers that hold the columns across further allocations must
        use :meth:`pin` instead."""
        return self.store._materialize(self)

    def pin(self) -> "_Pin":
        """Context manager: materialize AND pin.  While entered, the
        handle is excluded from victim selection (``ensure_headroom``
        will not spill it), so its device reservation is guaranteed to
        cover the returned columns for the caller's whole compute:

            with handle.pin() as cols:
                ...  # cols stay resident here
        """
        return _Pin(self)

    def spill(self) -> int:
        """Force this handle down one tier (device->host, host->disk);
        returns device bytes freed (0 if it wasn't resident)."""
        return self.store._spill_handle(self)

    def close(self) -> int:
        """Drop the batch and its spilled bytes.  Returns the device
        bytes whose reservation stays with the caller: the handle's
        when the batch was resident at close (the store releases a
        reservation only when it spills), else 0."""
        return self.store._close_handle(self)


class _Pin:
    """Materialize-and-pin guard (see :meth:`SpillHandle.pin`): the
    pin count is taken under the store lock at restore commit, so from
    the moment ``__enter__`` returns until ``__exit__`` the handle is
    invisible to ``_victims``/``spillable_bytes`` and its reservation
    stays backing the returned columns."""

    __slots__ = ("handle",)

    def __init__(self, handle: SpillHandle):
        self.handle = handle

    def __enter__(self):
        return self.handle.store._materialize(self.handle, pin=True)

    def __exit__(self, *exc) -> None:
        self.handle.store._unpin(self.handle)


def _unlink(path: Optional[str]) -> None:
    if path:
        try:
            os.unlink(path)
        except OSError:
            pass


class SpillStore:
    """Registry of spillable handles + the tier ladder + the
    ``ensure_headroom`` hook.  Thread-safe; blocking or slow calls —
    restore's device re-acquisition, spill's kudo serialization, every
    torch call that waits on the device, the adaptor-side release — run
    OUTSIDE the store lock, so a blocked restore can never wedge a
    concurrent spill and an adaptor-lock holder probing
    ``spillable_bytes()`` never waits on store I/O or the device (the
    lock-order discipline that prevents an ABBA deadlock with
    ``SparkResourceAdaptor._check_and_update_for_bufn``)."""

    def __init__(self, *, spill_dir: Optional[str] = None,
                 host_limit_bytes: Optional[int] = None):
        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        self._handles: Dict[int, SpillHandle] = {}
        self._next_id = 1
        self._spill_seq = 1
        self._dir = spill_dir
        self._host_limit = host_limit_bytes
        self._host_bytes = 0
        self._disk_bytes = 0
        self.spill_count = {TIER_HOST: 0, TIER_DISK: 0}
        self.spill_bytes = {TIER_HOST: 0, TIER_DISK: 0}   # kudo bytes
        self.restore_count = 0
        self.corrupt_count = 0
        self.recompute_count = 0

    # ------------------------------------------------------------- config

    def spill_dir(self) -> str:
        d = self._dir or os.environ.get("SPARK_RAPIDS_TPU_SPILL_DIR", "")
        if not d:
            d = os.path.join(tempfile.gettempdir(),
                             f"srt_spill_{os.getpid()}")
        os.makedirs(d, exist_ok=True)
        return d

    def host_limit_bytes(self) -> Optional[int]:
        if self._host_limit is not None:
            return self._host_limit
        return _env_int("SPARK_RAPIDS_TPU_SPILL_HOST_LIMIT_BYTES")

    # ----------------------------------------------------------- registry

    def register(self, columns, *, device_bytes: Optional[int] = None,
                 name: str = "", task_id: Optional[int] = None,
                 stage: str = "", priority: Optional[int] = None,
                 recompute: Optional[Callable[[], Sequence]] = None
                 ) -> SpillHandle:
        """Register a resident device column batch as spillable.  The
        caller already holds the device reservation; the store releases
        it on spill and re-acquires it on restore (both through the
        installed adaptor, inside a spill range)."""
        nbytes = (int(device_bytes) if device_bytes is not None
                  else columns_nbytes(columns))
        with self._lock:
            hid = self._next_id
            self._next_id += 1
            h = SpillHandle(self, hid, name or f"spill-{hid}", columns,
                            nbytes, task_id, stage, priority, recompute)
            self._handles[hid] = h
            return h

    def _close_handle(self, h: SpillHandle) -> int:
        with self._lock:
            if h.closed:
                return 0
            h.closed = True
            self._handles.pop(h.handle_id, None)
            # a resident batch's reservation is the caller's (an
            # in-flight spill that sees ``closed`` releases nothing; an
            # in-flight restore releases what it acquired itself)
            held = h.device_bytes if h.tier == TIER_DEVICE else 0
            if h.busy:
                # an in-flight restore/demotion owns the payload and
                # file right now; it observes ``closed`` at commit and
                # performs this cleanup itself (nothing leaks, and the
                # racing reader still gets its columns)
                return held
            h.columns = None
            if h.payload is not None:
                self._host_bytes -= len(h.payload)
                h.payload = None
            path, h.path = h.path, None
            self._disk_bytes -= h.disk_nbytes   # accounting under the
            h.disk_nbytes = 0                   # lock; unlink outside
            h.tier = TIER_FREED
        _unlink(path)
        return held

    def close(self) -> None:
        """Drop every handle and its spill files."""
        with self._lock:
            handles = list(self._handles.values())
        for h in handles:
            self._close_handle(h)

    # -------------------------------------------------------- adaptor glue

    def _adaptor(self):
        from spark_rapids_tpu_torch.memory import rmm_spark
        return rmm_spark.installed_adaptor()

    def _release_device(self, nbytes: int) -> None:
        ad = self._adaptor()
        if ad is None or nbytes <= 0:
            return
        ad.spill_range_start()
        try:
            ad.deallocate(nbytes)
        finally:
            ad.spill_range_done()

    def _acquire_device(self, nbytes: int) -> None:
        ad = self._adaptor()
        if ad is None or nbytes <= 0:
            return
        ad.spill_range_start()
        try:
            ad.allocate(nbytes)
        finally:
            ad.spill_range_done()

    # ------------------------------------------------------------ spilling

    def _unpin(self, h: SpillHandle) -> None:
        with self._lock:
            if h.pins > 0:
                h.pins -= 1

    def spillable_bytes(self) -> int:
        """Device bytes the store could free right now — the OOM state
        machine's pre-BUFN probe.  Lock-cheap: no I/O, torch or adaptor
        calls happen under the store lock, so this is safe to call while
        holding the adaptor lock."""
        with self._lock:
            return sum(h.device_bytes for h in self._handles.values()
                       if h.tier == TIER_DEVICE and not h.busy
                       and h.pins == 0)

    def _victims(self) -> List[SpillHandle]:
        """Device-tier handles in spill order: lowest task priority
        first, then largest resident-task bytes (the memory ledger),
        then largest handle.  Pinned handles (a caller is computing on
        their columns) are not candidates."""
        resident: Dict[Optional[int], int] = {}
        ad = self._adaptor()
        if ad is not None:
            try:
                for tid, row in (ad.memory_ledger(timeline=0)
                                 .get("tasks") or {}).items():
                    resident[int(tid)] = int(row.get("active_bytes", 0))
            except Exception:
                resident = {}
        with self._lock:
            cands = [h for h in self._handles.values()
                     if h.tier == TIER_DEVICE and not h.busy
                     and h.pins == 0]
        cands.sort(key=lambda h: (h.priority,
                                  -resident.get(h.task_id, 0),
                                  -h.device_bytes, h.handle_id))
        return cands

    def ensure_headroom(self, nbytes: int) -> int:
        """Synchronously spill victims until ``nbytes`` of device
        memory have been freed (or nothing spillable remains);
        returns the bytes actually freed.  Called by the adaptor's
        alloc-failure path BEFORE a blocked thread escalates to
        BUFN/retry-split."""
        t0 = time.monotonic_ns()
        freed = 0
        for h in self._victims():
            if freed >= nbytes:
                break
            freed += self._spill_handle(h)
        if freed > 0:
            _obs.record_spill_wait(time.monotonic_ns() - t0,
                                   stage="ensure_headroom")
        return freed

    def _serialize(self, h: SpillHandle, cols: Sequence):
        """The batch as one kudo table plus its KCRC trailer (CRC forced
        ON: spilled bytes are always corruption-checked on read-back,
        whatever the wire default).  Runs outside the store lock."""
        from spark_rapids_tpu_torch.columns.table import Table
        from spark_rapids_tpu_torch.shuffle import device_split, kudo
        from spark_rapids_tpu_torch.shuffle.schema import schema_of_table
        from spark_rapids_tpu_torch.shuffle.split_assemble import \
            _use_device
        cols = list(cols)
        if h.fields is None:
            h.fields = schema_of_table(Table(cols))
        rows = int(cols[0].length) if cols else 0
        if not (cols and _use_device(h.device)):
            buf = io.BytesIO()
            kudo.write_to_stream(cols, buf, 0, rows, crc=True)
            return buf.getvalue()
        # the device blob is the host writer's table byte for byte; one
        # copy to the host, then the trailer over those bytes
        blob, _ = device_split.device_shuffle_split(Table(cols), [])
        n = blob.shape[0]
        payload = np.empty(n + kudo.CRC_TRAILER_LEN, np.uint8)
        torch.from_numpy(payload[:n]).copy_(blob)
        del blob
        payload[n:] = np.frombuffer(kudo.crc_trailer(payload[:n]), np.uint8)
        return payload

    def _spill_handle(self, h: SpillHandle) -> int:
        """device->host (and maybe host->disk under the host budget).
        Returns device bytes freed."""
        t0 = time.monotonic_ns()
        with self._lock:
            if (h.closed or h.busy or h.pins > 0
                    or h.tier != TIER_DEVICE):
                return 0
            h.busy = True
            cols = h.columns
        # serialize OUTSIDE the store lock: a long kudo write (and its
        # wait on the device) must not stall spillable_bytes() probes,
        # which run under the adaptor lock (ABBA otherwise); ``busy``
        # keeps the handle ours
        try:
            payload = self._serialize(h, cols)
        except BaseException:
            with self._cv:
                h.busy = False
                self._cv.notify_all()
                if h.closed:
                    h.columns = None
                    h.tier = TIER_FREED
            raise
        del cols
        with self._cv:
            h.busy = False
            self._cv.notify_all()
            if h.closed:
                # closed while serializing: drop the payload, finish
                # the deferred cleanup close() left to the busy owner
                h.columns = None
                h.tier = TIER_FREED
                return 0
            h.payload = payload
            h.columns = None
            h.tier = TIER_HOST
            h.generation += 1
            h.spill_seq = self._spill_seq
            self._spill_seq += 1
            self._host_bytes += len(payload)
            self.spill_count[TIER_HOST] += 1
            self.spill_bytes[TIER_HOST] += len(payload)
        # release OUTSIDE the lock: deallocation wakes blocked threads
        self._release_device(h.device_bytes)
        _obs.record_spill(stage=h.stage, tier=TIER_HOST,
                          nbytes=h.device_bytes,
                          ns=time.monotonic_ns() - t0, task=h.task_id,
                          name=h.name, generation=h.generation)
        self._enforce_host_limit()
        return h.device_bytes

    def _enforce_host_limit(self) -> None:
        limit = self.host_limit_bytes()
        if limit is None:
            return
        while True:
            with self._lock:
                if self._host_bytes <= limit:
                    return
                hosted = [h for h in self._handles.values()
                          if h.tier == TIER_HOST and not h.busy]
                if not hosted:
                    return
                h = min(hosted, key=lambda x: x.spill_seq)  # oldest
            self._demote_to_disk(h)

    def _demote_to_disk(self, h: SpillHandle) -> None:
        t0 = time.monotonic_ns()
        with self._lock:
            if h.closed or h.busy or h.tier != TIER_HOST:
                return
            payload = h.payload
            path = os.path.join(
                self.spill_dir(),
                f"{h.name}.g{h.generation}.kudo")
            h.busy = True
        try:
            with open(path, "wb") as f:
                f.write(payload)
        except OSError:
            with self._cv:
                h.busy = False
                self._cv.notify_all()
                if h.closed:
                    # closed while the failed write was in flight:
                    # same deferred cleanup as the success path, or
                    # the host payload leaks with tier still HOST
                    if h.payload is not None:
                        self._host_bytes -= len(h.payload)
                        h.payload = None
                    h.columns = None
                    h.tier = TIER_FREED
            _unlink(path)                  # any partial write
            return
        closed = False
        with self._cv:
            h.busy = False
            self._cv.notify_all()
            if h.closed:
                # closed while the file write was in flight: finish
                # the deferred cleanup close() left to us
                if h.payload is not None:
                    self._host_bytes -= len(h.payload)
                    h.payload = None
                h.columns = None
                h.tier = TIER_FREED
                closed = True
            else:
                self._host_bytes -= len(payload)
                self._disk_bytes += len(payload)
                h.payload = None
                h.path = path
                h.disk_nbytes = len(payload)
                h.tier = TIER_DISK
                self.spill_count[TIER_DISK] += 1
                self.spill_bytes[TIER_DISK] += len(payload)
        if closed:
            _unlink(path)
            return
        _obs.record_spill(stage=h.stage, tier=TIER_DISK,
                          nbytes=len(payload),
                          ns=time.monotonic_ns() - t0, task=h.task_id,
                          name=h.name, generation=h.generation)

    # ------------------------------------------------------------- restore

    def _drop_spilled_payload_locked(self, h: SpillHandle,
                                     charge_host: bool = True
                                     ) -> Optional[str]:
        """Drop a handle's host payload and disk accounting (caller
        holds the store lock); returns the file path the CALLER must
        unlink AFTER releasing the lock (filesystem work never runs
        under the store lock)."""
        if h.payload is not None:
            if charge_host:
                self._host_bytes -= len(h.payload)
            h.payload = None
        self._disk_bytes -= h.disk_nbytes
        h.disk_nbytes = 0
        path, h.path = h.path, None
        return path

    def _materialize(self, h: SpillHandle, pin: bool = False):
        with self._cv:
            while h.busy:
                self._cv.wait()
            if h.closed:
                raise ValueError(
                    f"spill handle {h.name!r} is closed")
            if h.tier == TIER_DEVICE:
                if pin:
                    h.pins += 1
                return h.columns
            h.busy = True
            src_tier = h.tier
            payload = h.payload
            path = h.path
            gen = h.generation
            fields = h.fields
        t0 = time.monotonic_ns()
        acquired = False
        try:
            # blocking device re-acquisition OUTSIDE the lock (it may
            # itself trigger ensure_headroom on other handles)
            self._acquire_device(h.device_bytes)
            acquired = True
            cols = self._deserialize(h, src_tier, payload, path, gen,
                                     fields)
            ns = time.monotonic_ns() - t0
            del payload
            release_owed = 0
            with self._cv:
                h.busy = False
                self._cv.notify_all()
                if h.closed:
                    # restore-under-concurrent-free race: the caller
                    # still gets its data; the reservation and the
                    # handle's tiers are released, nothing leaks.
                    # close() deferred payload/file cleanup to us.
                    unlink_path = self._drop_spilled_payload_locked(h)
                    h.columns = None
                    h.tier = TIER_FREED
                    # the release runs AFTER the lock is dropped:
                    # deallocate takes the adaptor lock, whose holder
                    # may be probing our spillable_bytes() (ABBA
                    # deadlock if we called it here)
                    release_owed = h.device_bytes
                else:
                    unlink_path = self._drop_spilled_payload_locked(
                        h, charge_host=(src_tier == TIER_HOST))
                    h.columns = list(cols)
                    h.tier = TIER_DEVICE
                    if pin:
                        h.pins += 1
                    self.restore_count += 1
            _unlink(unlink_path)
            if release_owed:
                self._release_device(release_owed)
                return cols
            _obs.record_spill_restore(stage=h.stage, tier=src_tier,
                                      nbytes=h.device_bytes, ns=ns,
                                      task=h.task_id, name=h.name)
            _obs.record_spill_wait(ns, stage=h.stage or "restore")
            return cols
        except BaseException:
            unlink_path = None
            with self._cv:
                h.busy = False
                self._cv.notify_all()
                if h.closed:
                    # deferred close cleanup (see _close_handle)
                    unlink_path = self._drop_spilled_payload_locked(h)
                    h.columns = None
                    h.tier = TIER_FREED
            _unlink(unlink_path)
            if acquired:
                self._release_device(h.device_bytes)
            raise

    def _deserialize(self, h: SpillHandle, src_tier: str, payload,
                     path: Optional[str], generation: int, fields):
        """Read the kudo table back (its KCRC trailer verified) onto the
        handle's device: assembled there from one copy of the table's
        bytes on a CUDA device (the payload checked in place), merged on
        the host otherwise."""
        from spark_rapids_tpu_torch.shuffle import device_split, kudo
        from spark_rapids_tpu_torch.shuffle.split_assemble import \
            _use_device
        if src_tier == TIER_DISK:
            try:
                payload = np.fromfile(path, np.uint8)
            except OSError as e:
                return self._corrupt(h, kudo.KudoCorruptException(
                    f"unreadable spill file: {e}", reason="truncated",
                    path=path, generation=generation), path, generation)
        try:
            n = (kudo.checked_table_length(payload)
                 if fields and _use_device(h.device) else 0)
            if not n:
                kts = kudo.read_tables(io.BytesIO(payload))
                return list(kudo.merge_to_table(kts, fields,
                                                device=h.device).columns)
            raw = (payload if isinstance(payload, np.ndarray)
                   else np.frombuffer(bytearray(payload), np.uint8))
            blob = torch.from_numpy(raw[:n]).to(h.device)
            return list(device_split.device_shuffle_assemble(
                fields, blob, np.array([0, n], np.int64)).columns)
        except (kudo.KudoCorruptException, EOFError, ValueError) as e:
            if not isinstance(e, kudo.KudoCorruptException):
                e = kudo.KudoCorruptException(str(e), reason="truncated")
            if e.path is None and path is not None:
                e = kudo.annotate_spill_corruption(e, path, generation)
            return self._corrupt(h, e, path, generation)

    def _corrupt(self, h: SpillHandle, err, path, generation):
        """A spill payload failed verification on read-back.  With a
        ``recompute`` callback the batch is rebuilt from source instead
        of failing the query; without one the annotated error (file
        path + spill generation) escalates; both outcomes are counted
        (srt_spill_corrupt_total)."""
        self.corrupt_count += 1
        if h.recompute is not None:
            _obs.record_spill_corrupt(
                "recomputed", path=path or "", generation=generation,
                name=h.name, stage=h.stage, task=h.task_id)
            self.recompute_count += 1
            return list(h.recompute())
        _obs.record_spill_corrupt(
            "failed", path=path or "", generation=generation,
            name=h.name, stage=h.stage, task=h.task_id)
        raise err

    # --------------------------------------------------------------- stats

    def stats(self) -> dict:
        with self._lock:
            tiers: Dict[str, dict] = {
                TIER_DEVICE: {"handles": 0, "bytes": 0},
                TIER_HOST: {"handles": 0,
                            "bytes": int(self._host_bytes)},
                TIER_DISK: {"handles": 0,
                            "bytes": int(self._disk_bytes)},
            }
            for h in self._handles.values():
                row = tiers.get(h.tier)
                if row is not None:
                    row["handles"] += 1
                    if h.tier == TIER_DEVICE:
                        row["bytes"] += h.device_bytes
            return {
                "handles": len(self._handles),
                "tiers": tiers,
                "spills_host": self.spill_count[TIER_HOST],
                "spills_disk": self.spill_count[TIER_DISK],
                "restores": self.restore_count,
                "corrupt": self.corrupt_count,
                "recomputes": self.recompute_count,
                "spillable_bytes": sum(
                    h.device_bytes for h in self._handles.values()
                    if h.tier == TIER_DEVICE and not h.busy
                    and h.pins == 0),
            }


# ------------------------------------------------------- global install

_store: Optional[SpillStore] = None
_install_lock = threading.Lock()


def install(store: Optional[SpillStore] = None) -> SpillStore:
    """Install the process spill store and wire it into the installed
    adaptor's OOM state machine (idempotent; a fresh store replaces
    the prior one)."""
    global _store
    with _install_lock:
        if store is None:
            store = SpillStore()
        _store = store
        from spark_rapids_tpu_torch.memory import rmm_spark
        ad = rmm_spark.installed_adaptor()
        if ad is not None:
            ad.set_spill_hook(store)
        return store


def uninstall() -> None:
    global _store
    with _install_lock:
        store, _store = _store, None
        from spark_rapids_tpu_torch.memory import rmm_spark
        ad = rmm_spark.installed_adaptor()
        if ad is not None:
            ad.set_spill_hook(None)
        if store is not None:
            store.close()


def installed_store() -> Optional[SpillStore]:
    return _store


def ensure_store() -> SpillStore:
    """The installed store, installing a default one on first use
    (the out-of-core operators' entry)."""
    return _store if _store is not None else install()
