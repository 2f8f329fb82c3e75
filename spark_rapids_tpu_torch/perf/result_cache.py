"""Semantic result + subplan cache with incremental aggregation.

The serving tier's traffic is wildly redundant — the same dashboards
and aggregates re-requested as each micro-batch lands — yet every
submit used to recompute the whole query from scratch.  This module
makes a repeated query re-serve in O(delta) instead of O(total):

  * **Result cache** — a finished catalog query's host rows, keyed by
    (query name, parameter-binding digest, ingest-epoch vector).  The
    server answers a warm hit BEFORE admission (no pool slot, no
    scheduler charge) with a distinct ``cache_hit`` outcome.
  * **Subplan cache** — reusable intermediate outputs at two grains:
    content-keyed stage outputs (``plan/compiler.py`` consults per
    stage, so an unchanged upstream stage short-circuits while only
    the delta recomputes) and resident partial-aggregate states at
    the q5/q72 ``ShuffleBoundary`` seam, which new batches FOLD into
    via the exact-int64 merge property of segment sums (additive;
    overflow flags merge by OR) instead of recomputing history.
  * **Ingest epochs** — a registry Parquet/Arrow ingest and the
    catalog data generators bump.  Epoch vectors ride every result
    key, so new data invalidates results naturally while the resident
    partial states keep their second life.

Residency: payloads are encoded as one uint8 byte column on the
device they came from (a stage's outputs stay on the stage's device)
and registered in the tiered :class:`~spark_rapids_tpu_torch.memory.
spill.SpillStore` at priority ``CACHE_PRIORITY`` (0) — strictly below
every task priority, so memory pressure evicts cached results BEFORE it
demotes live queries, and an evicted entry demotes device->host->disk
for a byte-identical disk second life instead of vanishing.  With no
store installed the payload stays as its tensors under this module's
own LRU byte budget.

Cross-tenant safety gate: a result entry is shared across tenants
only when its query's :class:`CacheSpec` says ``shared`` (pure
functions of their parameter binding over shared sources); otherwise
the tenant rides the key and tenant A's private binding can never
serve tenant B.  Stage-scope entries are keyed by the CONTENT digest
of their inputs — identical digests over identical bytes — which is
the only sharing the safety gate permits.

Everything is observable: ``srt_result_cache_{hits,misses,evictions,
bytes,incremental_folds}_total``, a ``cache`` section in query
profiles, and a ``cache_lookup`` attribution bucket.  Off by default
(``SPARK_RAPIDS_TPU_RESULT_CACHE=1`` opts in) so byte-level serving
semantics never change under anyone's feet.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from collections import OrderedDict
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.analysis.lockdep import make_rlock

# SpillStore priority for cache residents: strictly below
# task_priority() of ANY live task (those are huge positive numbers),
# so ensure_headroom victimizes cached results first — results are
# recomputable luxuries, queries are work in flight
CACHE_PRIORITY = 0

SCOPE_RESULT = "result"
SCOPE_STAGE = "stage"
SCOPE_SUBPLAN = "subplan"


def cache_enabled() -> bool:
    """Dynamic env check (``SPARK_RAPIDS_TPU_RESULT_CACHE=1`` opts
    in).  Off by default: a semantic cache changes server outcomes
    (``cache_hit`` instead of a recompute), which operators must ask
    for, never discover."""
    return os.environ.get("SPARK_RAPIDS_TPU_RESULT_CACHE", "0") == "1"


# --------------------------------------------------------- ingest epochs
# source name -> (epoch, last fingerprint).  A fingerprint-carrying
# note (parquet reads pass size+mtime) bumps only when the fingerprint
# CHANGES — re-reading an unchanged file must not invalidate warm
# results; a fingerprint-less bump (arrow ingest, arriving stream
# batches) always advances.

_EPOCH_LOCK = make_rlock("perf.result_cache.epochs")
_EPOCHS: Dict[str, Tuple[int, Optional[str]]] = {}


def ingest_epoch(source: str) -> int:
    with _EPOCH_LOCK:
        return _EPOCHS.get(str(source), (0, None))[0]


def bump_ingest_epoch(source: str, n: int = 1) -> int:
    """Advance ``source``'s epoch (new data arrived): every result
    keyed over it goes stale; resident partial states survive and
    fold the delta."""
    source = str(source)
    with _EPOCH_LOCK:
        epoch = _EPOCHS.get(source, (0, None))[0] + max(int(n), 1)
        _EPOCHS[source] = (epoch, None)
        return epoch


def note_ingest(source: str, fingerprint: Optional[str] = None) -> int:
    """Ingest-door hook (parquet/arrow readers): records that
    ``source`` was read with ``fingerprint`` identifying its bytes
    (size+mtime for files).  The epoch bumps only when the
    fingerprint changes; ``None`` always bumps."""
    source = str(source)
    with _EPOCH_LOCK:
        epoch, last = _EPOCHS.get(source, (0, None))
        if fingerprint is None or fingerprint != last:
            epoch += 1
            _EPOCHS[source] = (epoch, fingerprint)
        return epoch


def epoch_vector(sources: Sequence[str]) -> Tuple[int, ...]:
    with _EPOCH_LOCK:
        return tuple(_EPOCHS.get(str(s), (0, None))[0]
                     for s in sources)


def reset_ingest_epochs() -> None:
    """Drop every recorded epoch (tests)."""
    with _EPOCH_LOCK:
        _EPOCHS.clear()


# ----------------------------------------------------------- cache specs
# Only queries with a registered spec are result-cacheable: the spec
# is the declaration that the query is a pure function of (binding,
# source epochs), and whether its results may be shared across
# tenants.  The built-in catalog queries register theirs in
# models/__init__.py.


class CacheSpec:
    """Result-cacheability declaration for one catalog query."""

    __slots__ = ("query", "shared", "sources", "source_param")

    def __init__(self, query: str, *, shared: bool = False,
                 sources: Tuple[str, ...] = (),
                 source_param: str = ""):
        self.query = query
        self.shared = bool(shared)
        self.sources = tuple(sources)
        self.source_param = source_param

    def sources_for(self, params: dict) -> Tuple[str, ...]:
        """The epoch sources this binding reads: a ``source_param``
        value in the binding overrides the spec's static list (the
        incremental queries name their stream per submit)."""
        if self.source_param:
            s = (params or {}).get(self.source_param)
            if s:
                return (str(s),)
        return self.sources


_SPEC_LOCK = make_rlock("perf.result_cache.specs")
_SPECS: Dict[str, CacheSpec] = {}


def register_cache_spec(query: str, *, shared: bool = False,
                        sources: Sequence[str] = (),
                        source_param: str = "") -> CacheSpec:
    spec = CacheSpec(str(query), shared=shared,
                     sources=tuple(sources),
                     source_param=source_param)
    with _SPEC_LOCK:
        _SPECS[spec.query] = spec
    return spec


def unregister_cache_spec(query: str) -> None:
    with _SPEC_LOCK:
        _SPECS.pop(str(query), None)


def cache_spec(query: str) -> Optional[CacheSpec]:
    with _SPEC_LOCK:
        return _SPECS.get(str(query))


# --------------------------------------------------------------- digests


def binding_digest(params: Optional[dict]) -> str:
    """Stable digest of a parameter binding (canonical JSON, sorted
    keys — dict order must not fork cache identities)."""
    s = json.dumps(params or {}, sort_keys=True, default=str,
                   separators=(",", ":"))
    return hashlib.sha1(s.encode()).hexdigest()[:16]


def _host_bits(a) -> np.ndarray:
    """One operand as a contiguous host array of its bits: a tensor is
    copied to the host once; FLOAT64 contributes its int64 bit
    pattern, so -0.0/0.0 and NaN payloads stay distinct."""
    if isinstance(a, torch.Tensor):
        t = a.detach()
        if t.dtype == torch.float64:
            t = t.view(torch.int64)
        return t.cpu().contiguous().numpy()
    return np.ascontiguousarray(np.asarray(a))


def data_digest(arrays: Sequence) -> str:
    """Content digest of operand tensors: dtype + shape + raw bytes.
    This is the subplan safety gate — stage outputs are shared ONLY
    between runs whose input bytes are identical, which makes
    cross-tenant reuse of a private binding structurally impossible
    (different data, different key)."""
    h = hashlib.sha1()
    for a in arrays:
        host = _host_bits(a)
        h.update(str(host.dtype).encode())
        h.update(str(host.shape).encode())
        h.update(host.reshape(-1).view(np.uint8))
    return h.hexdigest()[:16]


def _encode_json(value) -> torch.Tensor:
    """A JSON-able result as a uint8 host tensor (the spillable
    payload form; byte-identity is by construction — same bytes in,
    same bytes out)."""
    raw = json.dumps(value, separators=(",", ":")).encode()
    return torch.frombuffer(bytearray(raw), dtype=torch.uint8)


def _decode_json(t: torch.Tensor):
    return json.loads(t.cpu().numpy().tobytes())


def _nbytes(arrays) -> int:
    return sum(a.numel() * a.element_size() for a in arrays)


def _torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name.rsplit(".", 1)[-1])


# ----------------------------------------------------------------- cache


class _Entry:
    __slots__ = ("arrays", "handle", "meta", "nbytes", "scope", "hits")

    def __init__(self, arrays, handle, meta, nbytes, scope):
        self.arrays = arrays        # the tensors when no store
        self.handle = handle        # SpillHandle when a store holds it
        self.meta = meta
        self.nbytes = int(nbytes)
        self.scope = scope
        self.hits = 0


class ResultCache:
    """LRU semantic cache over (scope, key) with SpillStore-backed
    residency.  Same locking discipline as perf/jit_cache.py: store
    round trips (register/materialize/close) run OUTSIDE the cache
    lock, so a blocked restore never serializes unrelated lookups and
    the lock order against the store lock stays one-way."""

    def __init__(self, max_entries: Optional[int] = None,
                 max_bytes: Optional[int] = None):
        self._lock = make_rlock("perf.result_cache")
        self._entries: "OrderedDict[tuple, _Entry]" = OrderedDict()
        self._max_entries = max_entries
        self._max_bytes = max_bytes
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.puts = 0
        self.folds = 0
        self.lookup_ns_total = 0

    # ------------------------------------------------------------ budgets

    def max_entries(self) -> int:
        if self._max_entries is not None:
            return self._max_entries
        try:
            return int(os.environ.get(
                "SPARK_RAPIDS_TPU_RESULT_CACHE_ENTRIES", "256"))
        except ValueError:
            return 256

    def max_bytes(self) -> int:
        if self._max_bytes is not None:
            return self._max_bytes
        try:
            return int(os.environ.get(
                "SPARK_RAPIDS_TPU_RESULT_CACHE_BYTES", str(256 << 20)))
        except ValueError:
            return 256 << 20

    def enabled(self) -> bool:
        return cache_enabled()

    # ------------------------------------------------------------- stats

    def stats(self) -> dict:
        with self._lock:
            by_scope: Dict[str, int] = {}
            for e in self._entries.values():
                by_scope[e.scope] = by_scope.get(e.scope, 0) + 1
            return {
                "enabled": self.enabled(),
                "entries": len(self._entries),
                "bytes": self._bytes,
                "max_entries": self.max_entries(),
                "max_bytes": self.max_bytes(),
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "puts": self.puts,
                "folds": self.folds,
                "lookup_ns_total": self.lookup_ns_total,
                "by_scope": by_scope,
            }

    def clear(self, reset_stats: bool = False) -> int:
        """Drop every entry (spill handles are closed); returns the
        number dropped.  Cumulative stats survive unless
        ``reset_stats``."""
        with self._lock:
            dropped = list(self._entries.values())
            n = len(dropped)
            self._entries.clear()
            self._bytes = 0
            if reset_stats:
                self.hits = self.misses = self.evictions = 0
                self.puts = self.folds = self.lookup_ns_total = 0
        for e in dropped:
            self._close_entry(e)
        return n

    @staticmethod
    def _close_entry(e: _Entry) -> None:
        h, e.handle, e.arrays = e.handle, None, None
        if h is not None:
            try:
                h.close()
            except Exception:
                pass   # a torn-down store must not fail cache cleanup

    # ------------------------------------------------------- raw get/put

    def _get(self, key: tuple):
        """(arrays, meta) or None.  The spill-store materialize (a
        possible disk restore) runs outside the cache lock."""
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                return None
            self._entries.move_to_end(key)
            e.hits += 1
            handle, arrays, meta = e.handle, e.arrays, e.meta
        if handle is not None:
            try:
                cols = handle.get()
            except Exception:
                # the store lost the payload (torn down, corrupt past
                # recovery): drop the entry and report a miss upstream
                self.invalidate(key)
                return None
            # payloads travel the store as ONE uint8 byte column (a
            # registration is a table, so its columns must share a
            # length, which mixed dtypes/shapes would violate); slice
            # the original tensors back out by dtype/shape from the
            # meta, each into fresh storage so its dtype view aligns
            blob = cols[0].data
            arrays, off = [], 0
            for dt, shape in zip(meta["_dtypes"], meta["_shapes"]):
                dt = _torch_dtype(dt)
                n = int(np.prod(shape, dtype=np.int64)) * \
                    torch.empty((), dtype=dt).element_size()
                arrays.append(blob[off:off + n].clone().view(dt)
                              .reshape(shape))
                off += n
        return arrays, meta

    def _put(self, key: tuple, arrays, meta, scope: str,
             nbytes: int) -> None:
        from spark_rapids_tpu_torch import observability as _obs
        from spark_rapids_tpu_torch.memory.spill import installed_store

        handle = None
        store = installed_store()
        if store is not None:
            try:
                from spark_rapids_tpu_torch.columns import dtypes
                from spark_rapids_tpu_torch.columns.column import Column
                # store-side form is ONE uint8 byte column on the
                # payload's device (a registration is a table, so its
                # columns must share a length — mixed dtypes/shapes
                # would violate that); _get slices the tensors back
                # out by dtype/shape from the meta
                meta = dict(meta)
                meta["_dtypes"] = [str(a.dtype) for a in arrays]
                meta["_shapes"] = [tuple(a.shape) for a in arrays]
                views = [a.contiguous().reshape(-1).view(torch.uint8)
                         for a in arrays]
                blob = (torch.cat(views) if views
                        else torch.zeros(0, dtype=torch.uint8))
                cols = [Column(dtypes.UINT8, int(blob.shape[0]),
                               data=blob)]
                handle = store.register(
                    cols, device_bytes=nbytes,
                    name=f"result_cache:{scope}",
                    stage="result_cache", priority=CACHE_PRIORITY)
                arrays = None   # the store owns the payload now
            except Exception:
                handle = None   # unsupported payload: keep it in-proc
        entry = _Entry(arrays, handle, meta, nbytes, scope)
        evicted = []
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
                evicted.append((None, old))
            self._entries[key] = entry
            self._bytes += entry.nbytes
            self.puts += 1
            max_e, max_b = self.max_entries(), self.max_bytes()
            while len(self._entries) > max(1, max_e) or \
                    (self._bytes > max_b and len(self._entries) > 1):
                k, e = self._entries.popitem(last=False)
                self._bytes -= e.nbytes
                self.evictions += 1
                evicted.append((e.scope, e))
        for scope_ev, e in evicted:
            self._close_entry(e)
            if scope_ev is not None:
                _obs.record_result_cache("eviction", scope_ev)
        _obs.record_result_cache("put", scope, nbytes=nbytes)

    def invalidate(self, key: tuple) -> bool:
        with self._lock:
            e = self._entries.pop(key, None)
            if e is not None:
                self._bytes -= e.nbytes
        if e is None:
            return False
        self._close_entry(e)
        return True

    # ------------------------------------------------------ result scope

    def _result_key(self, spec: CacheSpec, tenant: str, query: str,
                    params: Optional[dict]) -> tuple:
        return (SCOPE_RESULT, query, binding_digest(params),
                epoch_vector(spec.sources_for(params or {})),
                "" if spec.shared else str(tenant))

    def lookup_result(self, tenant: str, query: str,
                      params: Optional[dict]):
        """(value, lookup_ns) — value is None on a miss or for a
        query with no cache spec (uncacheable queries count nothing).
        The hit/miss lands in metrics with per-tenant attribution."""
        from spark_rapids_tpu_torch import observability as _obs

        spec = cache_spec(query)
        if spec is None:
            return None, 0
        t0 = time.monotonic_ns()
        got = self._get(self._result_key(spec, tenant, query, params))
        ns = time.monotonic_ns() - t0
        with self._lock:
            self.lookup_ns_total += ns
            if got is None:
                self.misses += 1
            else:
                self.hits += 1
        if got is None:
            _obs.record_result_cache("miss", SCOPE_RESULT,
                                     tenant=tenant, query=query, ns=ns)
            return None, ns
        arrays, _meta = got
        try:
            value = _decode_json(arrays[0])
        except Exception:
            return None, ns   # corrupt past the store's own recovery
        _obs.record_result_cache("hit", SCOPE_RESULT, tenant=tenant,
                                 query=query, ns=ns)
        return value, ns

    def store_result(self, tenant: str, query: str,
                     params: Optional[dict], value) -> bool:
        """Cache one finished query's JSON-able result; no-op for
        queries without a spec (never silently cache a query nobody
        declared pure)."""
        spec = cache_spec(query)
        if spec is None or value is None:
            return False
        try:
            payload = _encode_json(value)
        except (TypeError, ValueError):
            return False   # non-JSON-able result: not cacheable
        self._put(self._result_key(spec, tenant, query, params),
                  [payload], {"encoding": "json"}, SCOPE_RESULT,
                  _nbytes([payload]))
        return True

    # ----------------------------------------------------- subplan scope

    def get_subplan(self, key_parts: Sequence):
        """(meta, arrays) for a resident partial-aggregate state, or
        None.  Keys are caller-composed tuples (query shape +
        binding); states are shared only through identical keys."""
        from spark_rapids_tpu_torch import observability as _obs
        t0 = time.monotonic_ns()
        got = self._get((SCOPE_SUBPLAN,) + tuple(key_parts))
        ns = time.monotonic_ns() - t0
        with self._lock:
            self.lookup_ns_total += ns
            if got is None:
                self.misses += 1
            else:
                self.hits += 1
        _obs.record_result_cache("hit" if got else "miss",
                                 SCOPE_SUBPLAN, ns=ns)
        if got is None:
            return None
        arrays, meta = got
        return meta, arrays

    def put_subplan(self, key_parts: Sequence, arrays,
                    meta: Optional[dict] = None) -> None:
        arrays = [a if isinstance(a, torch.Tensor)
                  else torch.from_numpy(np.ascontiguousarray(a))
                  for a in arrays]
        nbytes = _nbytes(arrays)
        self._put((SCOPE_SUBPLAN,) + tuple(key_parts), arrays,
                  dict(meta or {}), SCOPE_SUBPLAN, nbytes)

    def record_fold(self, query: str, ns: int = 0) -> None:
        """One arriving batch folded into a resident partial state
        (the O(delta) event the bench counts).  Disarmed runs fold
        into a throwaway state — that is a full recompute, not an
        incremental serve, so it does not count."""
        from spark_rapids_tpu_torch import observability as _obs
        if not self.enabled():
            return
        with self._lock:
            self.folds += 1
        _obs.record_result_cache("fold", SCOPE_SUBPLAN, query=query,
                                 ns=ns)

    # ------------------------------------------------------- stage scope

    def stage_run(self, cs, stage_inputs):
        """Content-keyed short-circuit for one compiled stage: inputs
        whose bytes were seen before return the cached outputs without
        executing (reported as an engine-``cached`` stage record so
        srt-explain shows the short-circuit); anything else runs and
        is cached.  Byte-identical by the data_digest contract.  The
        outputs come back as tensors on the stage's device (the device
        of its first input)."""
        from spark_rapids_tpu_torch import observability as _obs

        t0 = time.monotonic_ns()
        try:
            flat = [a for inp in cs.plan.inputs
                    for a in stage_inputs[inp.name]]
            key = (SCOPE_STAGE, cs.plan.digest, data_digest(flat))
        except Exception:
            return cs.run(stage_inputs)   # undigestable inputs: run
        got = self._get(key)
        ns = time.monotonic_ns() - t0
        with self._lock:
            self.lookup_ns_total += ns
            if got is None:
                self.misses += 1
            else:
                self.hits += 1
        if got is not None:
            arrays, _meta = got
            _obs.record_result_cache("hit", SCOPE_STAGE,
                                     query=cs.plan.name, ns=ns)
            if _obs.PROFILER.active():
                t_end = time.monotonic_ns()
                _obs.PROFILER.note_stage({
                    "stage": cs.plan.name, "digest": key[2],
                    "engine": "cached", "compiled": False,
                    "compile_ns": 0, "wall_ns": ns,
                    "t_start_ns": t_end - ns, "t_end_ns": t_end,
                    "dispatches": 0,
                    "nodes_total": cs.dispatch_count,
                    "nodes": [], "inputs": []})
            from spark_rapids_tpu_torch.plan.compiler import _first_device
            dev = _first_device(stage_inputs, cs.plan)
            return tuple(a.to(dev) for a in arrays)
        _obs.record_result_cache("miss", SCOPE_STAGE,
                                 query=cs.plan.name, ns=ns)
        out = cs.run(stage_inputs)
        # a copy: the caller owns the returned outputs and may write
        # into them
        kept = [o.detach().clone() for o in out]
        self._put(key, kept, {}, SCOPE_STAGE, _nbytes(kept))
        return out


# ---------------------------------------------------------- fold helpers


def fold_partials(state: Sequence[torch.Tensor],
                  delta: Sequence[torch.Tensor],
                  or_indices: Sequence[int] = ()) -> list:
    """Merge one batch's partial-aggregate outputs into the resident
    state via the exact-int64 property: segment sums are additive
    across batches (bit-exact, no float reassociation), overflow
    flags merge by OR.  ``or_indices`` name the flag positions."""
    ors = {i % len(state) for i in or_indices}
    out = []
    for i, (s, d) in enumerate(zip(state, delta)):
        if i in ors:
            out.append(torch.logical_or(s.bool(), d.bool()))
        else:
            out.append(s + d)
    return out


CACHE = ResultCache()
