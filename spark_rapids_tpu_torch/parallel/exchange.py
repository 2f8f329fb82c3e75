"""The fixed-capacity exchange over a process group, and the
centralized overflow retry for fixed-capacity programs.

The JAX package moves columns between the chips of a mesh with
``jax.lax.all_to_all`` inside ``shard_map``.  The port runs the same
SPMD program over a ``torch.distributed`` group (distributed/mesh.py):
columns stay tensors on each rank's device and move with
``all_to_all_single``.  Partitions travel in fixed-capacity slots, as
XLA's static shapes need there: each rank sends an
``(n_parts, capacity, ...)`` padded block per column plus its true
per-destination counts, and receives ``(n_parts * capacity, ...)``
padded rows and a validity mask.  Rows past the capacity are dropped
from the slots, but the true sizes travel alongside, so overflow is
detectable, never silent.

`with_capacity_retry` wraps a capacity-parameterized program factory
and re-runs it at double the budget whenever the program reports
overflow, under the same RetryPolicy the task-level retry drivers use
(robustness/retry.py).  Given a mesh, the decision is collective: the
overflow indicator is all-reduced (MAX) first, so every rank doubles
in lockstep and the next collective pairs up the same calls.

Table-granularity exchanges (the kudo shuffle) go through a pluggable
TRANSPORT: by default an in-process loopback that still round-trips
the real wire bytes (kudo write -> kudo read/merge), and, when the
distributed runtime installs its ShuffleService
(spark_rapids_tpu_torch/distributed/), unix/TCP socket links between
worker processes.  Callers write against ``exchange_tables`` and never
know which side of a process boundary their peers live on.

Each capacity-retry run opens an ``exchange_capacity_retry`` span and
records every doubling (``srt_exchange_capacity_doublings_total``) and
an episode that saw an overflow in the retry journal; its steps live
in the process compile cache (perf/jit_cache.py).
"""
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch import observability as _obs
from spark_rapids_tpu_torch.perf import jit_cache as _jc
from spark_rapids_tpu_torch.robustness.retry import RetryPolicy


class CapacityExceeded(RuntimeError):
    """Raised when a budgeted program still overflows at the retry
    ceiling.

    ``send_counts`` carries the observed overflow indicator from the
    last attempt when the caller opted into a counts indicator: the
    TRUE per-destination sizes, so the caller can see HOW FAR over
    budget the program was, not just that it overflowed."""

    def __init__(self, capacity: int, doublings: int,
                 send_counts=None, reason: str = "overflowed"):
        super().__init__(
            f"exchange capacity {capacity} still {reason} after "
            f"{doublings} doublings"
            + (f" (observed counts {send_counts})"
               if send_counts is not None else ""))
        self.capacity = capacity
        self.doublings = doublings
        self.send_counts = send_counts


# counting-sort rank working-set cap: the (rows, n_parts) int32 cumsum
# beyond this falls back to the stable-argsort layout
_COUNTING_SORT_MAX_BYTES = 64 << 20


def build_padded_sends(arrays: Sequence[torch.Tensor], part: torch.Tensor,
                       n_parts: int, capacity: int):
    """Pack rows into per-destination padded slots.

    arrays: per-column arrays (rows, ...) sharing axis 0.
    part:   (rows,) destination partition per row.
    Returns (sends, counts): sends[i] has shape (n_parts, capacity, ...);
    counts is (n_parts,) int32 true row counts (may exceed capacity: the
    caller checks).

    A row's slot is its stable rank within its partition.  Under
    ``_COUNTING_SORT_MAX_BYTES`` the rank is one (rows, n_parts) one-hot
    cumsum; past it, the stable-argsort layout, which gives the same
    (partition, rank) slots.  Rows past the capacity, and rows whose
    partition is out of range, are dropped."""
    pi = part.to(torch.int64)
    rows = int(pi.shape[0])
    dev = pi.device
    if rows * max(n_parts, 1) * 4 <= _COUNTING_SORT_MAX_BYTES:
        onehot = pi[:, None] == torch.arange(n_parts, device=dev)[None, :]
        rank = torch.cumsum(onehot.to(torch.int32), 0).gather(
            1, pi.clamp(0, n_parts - 1)[:, None])[:, 0] - 1
        counts = onehot.sum(0, dtype=torch.int32)
    else:
        order = torch.sort(pi, stable=True).indices
        inside = (pi >= 0) & (pi < n_parts)
        counts = torch.bincount(torch.where(inside, pi, n_parts),
                                minlength=n_parts + 1)[:n_parts]
        starts = torch.cumsum(counts, 0) - counts
        rank_sorted = (torch.arange(rows, device=dev)
                       - starts[pi[order].clamp(0, n_parts - 1)])
        rank = torch.empty(rows, dtype=torch.int64, device=dev)
        rank[order] = rank_sorted
        counts = counts.to(torch.int32)
    keep = (rank < capacity) & (pi >= 0) & (pi < n_parts)
    # dropped rows land in one spare slot past the block, cut off after
    slot = torch.where(keep, pi * capacity + rank, n_parts * capacity)
    sends = []
    for a in arrays:
        buf = a.new_zeros((n_parts * capacity + 1,) + tuple(a.shape[1:]))
        buf.index_put_((slot,), a)
        sends.append(buf[:-1].reshape((n_parts, capacity)
                                      + tuple(a.shape[1:])))
    return sends, counts


def exchange(arrays: Sequence[torch.Tensor], part: torch.Tensor, mesh,
             n_parts: int, capacity: int):
    """All-to-all hash exchange over ``mesh`` (distributed/mesh.Mesh),
    run by every rank at once.

    Each rank keeps the rows with part == its own rank after the
    exchange.  Returns (received arrays each (n_parts*capacity, ...),
    valid mask (n_parts*capacity,), total_received (int32 scalar),
    send_counts (n_parts,) int32: the TRUE outbound sizes; an entry
    over the capacity means rows were dropped and the caller must retry
    with a larger budget).  Received rows come in (source rank, slot)
    order."""
    if n_parts != mesh.size:
        raise ValueError(f"{n_parts} partitions over {mesh.size} ranks")
    sends, send_counts = build_padded_sends(arrays, part, n_parts,
                                            capacity)
    recv_counts = mesh.all_to_all(
        send_counts.reshape(n_parts, 1)).reshape(n_parts)
    recv_counts = torch.minimum(recv_counts,
                                torch.tensor(capacity, dtype=torch.int32,
                                             device=recv_counts.device))
    received = []
    for s in sends:
        r = mesh.all_to_all(s)
        received.append(r.reshape((n_parts * capacity,)
                                  + tuple(s.shape[2:])))
    idx = torch.arange(n_parts * capacity, device=recv_counts.device)
    valid = (idx % capacity) < recv_counts[idx // capacity]
    return (received, valid, recv_counts.sum().to(torch.int32),
            send_counts)


def _host(x) -> np.ndarray:
    """An overflow indicator on the host (one device sync)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _observed_counts(indicator: np.ndarray):
    """The true sizes carried into CapacityExceeded (the first 64)."""
    if indicator.size:
        return [int(x) for x in indicator.reshape(-1)[:64]]
    return None


def with_capacity_retry(make_step: Callable[[int], Callable],
                        initial_capacity: int, *,
                        max_doublings: int = 6,
                        overflow_index: int = -1,
                        policy: Optional[RetryPolicy] = None,
                        counts_indicator: bool = False,
                        check: Optional[Callable[[], None]] = None,
                        mesh=None):
    """Overflow retry for a fixed-capacity program.

    make_step(capacity) must return a callable whose output tuple
    carries an overflow indicator at `overflow_index`.  By default it
    is a truthiness flag (any shape; any true/non-zero element means
    rows were dropped).  With ``counts_indicator=True`` it is instead
    the raw true sizes: the retry compares them with the current
    capacity itself, and a terminal CapacityExceeded reports them.  The
    wrapper runs the program, reads the indicator on the host, and
    re-builds at double the capacity until clean.  Each capacity's
    program is built once per wrapper.

    ``policy`` bounds the attempts (default ``max_doublings + 1``, no
    backoff), applies its backoff between rebuilds, and its wall-clock
    deadline: a spent attempt budget raises CapacityExceeded, and so
    does a deadline hit, early, instead of building ever-larger
    programs.

    ``check`` (optional) runs at the top of every capacity attempt, so
    a caller can cancel between attempts by raising from it.

    With a ``mesh`` (distributed/mesh.Mesh) every rank runs this loop
    over its own shard, and the indicator is all-reduced (MAX) before
    the decision, so all ranks retry or return together (a rank that
    doubled alone would pair its next collective with a peer's
    different one).  The program's own output keeps the rank's flag;
    the counts a terminal CapacityExceeded carries are the largest
    over the ranks.

    Returns run(*args) -> (outputs, capacity_used)."""
    steps = {}
    pol = policy or RetryPolicy(max_attempts=max_doublings + 1,
                                base_backoff_s=0.0)

    def _step_for(cap: int):
        """Capacity-parameterized steps live in the process compile
        cache (perf/jit_cache.py): one entry per (factory, capacity),
        so steady-state budgets survive across driver instances, show
        up in srt_jit_cache_* stats, and participate in LRU eviction.
        The factory object itself is the entry owner — identity-checked
        on hits, so a recycled id() can never resurrect a stale step."""
        if not _jc.CACHE.enabled():
            if cap not in steps:
                steps[cap] = make_step(cap)
            return steps[cap]
        return _jc.CACHE.get_or_build(
            "exchange.step", f"factory@{id(make_step)}", cap,
            lambda: make_step(cap), owner=make_step,
            counts_compile=False)

    def run(*args):
        # stage-level span: one per driver invocation, covering every
        # capacity attempt (per-attempt sub-spans would double-count
        # the final successful run's time)
        with _obs.TRACER.span("exchange_capacity_retry",
                              kind="stage") as sp:
            cap = int(initial_capacity)
            t0 = pol.clock()
            attempt = 0
            lost_ns = 0
            prev_backoff = 0.0
            while True:
                if check is not None:
                    check()
                attempt_t0 = time.monotonic_ns()
                out = _step_for(cap)(*args)
                indicator = _host(out[overflow_index])
                if mesh is not None:
                    indicator = _host(mesh.pmax(torch.as_tensor(
                        indicator.astype(np.int64),
                        device=mesh.device)))
                if counts_indicator:
                    overflowed = bool(np.any(indicator > cap))
                else:
                    overflowed = bool(np.any(indicator))
                if not overflowed:
                    sp.set_attr("capacity", cap)
                    sp.set_attr("attempts", attempt + 1)
                    if attempt:
                        _obs.record_retry_episode(
                            "exchange_capacity", attempts=attempt + 1,
                            retries=attempt, splits=0,
                            max_split_depth=0, lost_ns=lost_ns,
                            outcome="success",
                            errors=["CapacityOverflow"] * attempt)
                    return out, cap
                attempt += 1
                lost_ns += time.monotonic_ns() - attempt_t0
                deadline_hit = (pol.deadline_s is not None
                                and pol.clock() - t0 >= pol.deadline_s)
                if attempt >= pol.max_attempts or deadline_hit:
                    counts = (_observed_counts(indicator)
                              if counts_indicator else None)
                    sp.set_attr("capacity", cap)
                    sp.set_attr("overflowed", True)
                    _obs.JOURNAL.emit("exchange_capacity_exceeded",
                                      capacity=cap,
                                      doublings=attempt - 1,
                                      send_counts=counts)
                    _obs.record_retry_episode(
                        "exchange_capacity", attempts=attempt,
                        retries=attempt, splits=0, max_split_depth=0,
                        lost_ns=lost_ns, outcome="exhausted:deadline"
                        if deadline_hit else "exhausted:attempts",
                        errors=["CapacityOverflow"] * attempt)
                    raise CapacityExceeded(
                        cap, attempt - 1, send_counts=counts,
                        reason="over deadline" if deadline_hit
                        else "overflowed")
                _obs.record_exchange_doubling(cap, cap * 2, attempt - 1)
                # thread the previous pause through so jittered
                # policies get true decorrelated backoff
                # (robustness/retry.py)
                backoff = pol.backoff_for(attempt, prev_backoff)
                prev_backoff = backoff
                if backoff > 0:
                    pol.sleep(backoff)
                cap *= 2

    return run


# ------------------------------------------------- pluggable transport


class InProcessKudoTransport:
    """Single-process loopback transport: every destination is this
    process.  Partitions still serialize through the kudo wire format
    and merge back through ``read_tables``/``merge_to_table`` (KCRC
    trailers included), so the byte path is the socket transport's,
    only the socket is elided.  The merge lands on the device the
    caller's tables live on."""

    rank = 0
    world = 1

    def exchange(self, op_id: int, tables_by_dest, fields=None):
        import io

        from spark_rapids_tpu_torch.shuffle import kudo as _kudo
        from spark_rapids_tpu_torch.shuffle.schema import schema_of_table
        if len(tables_by_dest) != 1:
            raise ValueError(
                "in-process transport has world=1; got "
                f"{len(tables_by_dest)} destinations (install a "
                "distributed transport via set_table_transport)")
        table = tables_by_dest[0]
        if fields is None:
            fields = schema_of_table(table)
        buf = io.BytesIO()
        _kudo.write_to_stream_with_metrics(
            table.columns, buf, 0, table.num_rows)
        buf.seek(0)
        return _kudo.merge_to_table(_kudo.read_tables(buf), fields,
                                    device=table_device(table))

    def allgather(self, op_id: int, table, fields=None):
        return self.exchange(op_id, [table], fields)


def table_device(table) -> torch.device:
    """The device a table's columns live on (the CPU for a table
    without columns)."""
    return table.device if table.num_columns else torch.device("cpu")


_TABLE_TRANSPORT = [None]


def set_table_transport(transport) -> object:
    """Install the process's table transport (the distributed runtime
    registers its ShuffleService here; ``None`` restores the in-process
    loopback).  Returns the prior transport."""
    prior = _TABLE_TRANSPORT[0]
    _TABLE_TRANSPORT[0] = transport
    return prior


def table_transport():
    """The installed transport, or the in-process loopback default."""
    t = _TABLE_TRANSPORT[0]
    if t is None:
        t = _TABLE_TRANSPORT[0] = InProcessKudoTransport()
    return t


def exchange_tables(op_id: int, tables_by_dest, fields=None):
    """All-to-all at table granularity over the installed transport:
    ``tables_by_dest[d]`` goes to rank ``d``; returns the merged Table
    of everything addressed to THIS rank, partitions concatenated in
    source-rank order (a deterministic merge: the property the
    byte-identity checks rest on)."""
    return table_transport().exchange(op_id, tables_by_dest, fields)


def allgather_table(op_id: int, table, fields=None):
    """Every rank contributes ``table``; every rank receives the
    rank-ordered concatenation of all contributions."""
    return table_transport().allgather(op_id, table, fields)
