"""Composed pipelines, and the named query catalog that serves them.

A server admits work as ``(tenant, query_name, params)``; this module
turns a name into a runnable pipeline.  Every built-in runner is a
pure function of its ``params`` dict (data generated from a seed,
pipeline built once per parameter signature and cached), so a query
run beside seven others returns the same bytes as the query run alone.
Each runner reads ``params["device"]`` (default ``"cuda"``) for where
its data and pipeline run; the JAX package's runners ignore keys they
do not know, so one params dict can drive both.

Runners receive an optional :class:`QueryContext` carrying tenant /
query-id attribution and a cooperative cancel flag and deadline; the
built-in runners check it before any work.

Left unregistered until their queue items land: the file-backed
``tpcds_*_file`` runners (ROADMAP A13), the incremental
``tpcds_*_incremental`` runners and the result-cache specs (A14).  A
lookup of those names raises :class:`UnknownQueryError`.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional


class QueryCancelled(Exception):
    """Raised by a runner that observed its cancel flag."""


class QueryDeadlineExceeded(QueryCancelled):
    """Raised by a cooperative checkpoint once the query's deadline
    has passed (a :class:`QueryCancelled`, so runners unwind the
    same way)."""


class QueryContext:
    """Per-execution attribution + cooperative cancellation/deadline
    handle."""

    __slots__ = ("query_id", "tenant", "_cancel", "deadline_ns")

    def __init__(self, query_id: str = "", tenant: str = "",
                 cancel_event: Optional[threading.Event] = None,
                 deadline_ns: Optional[int] = None):
        self.query_id = query_id
        self.tenant = tenant
        self._cancel = cancel_event
        self.deadline_ns = deadline_ns

    def cancelled(self) -> bool:
        return self._cancel is not None and self._cancel.is_set()

    def remaining_s(self) -> Optional[float]:
        """Seconds until the deadline (negative once past), or None
        when the query has no deadline."""
        if self.deadline_ns is None:
            return None
        return (self.deadline_ns - time.monotonic_ns()) / 1e9

    def check_cancel(self) -> None:
        # ROADMAP A14: each poll also beats the lifeguard's heartbeat
        # an explicit cancel wins over the deadline
        if self.cancelled():
            raise QueryCancelled(self.query_id or "query")
        if self.deadline_ns is not None \
                and time.monotonic_ns() > self.deadline_ns:
            raise QueryDeadlineExceeded(self.query_id or "query")


class UnknownQueryError(KeyError):
    """Submitted name is not in the catalog."""


# name -> fn(params: dict, ctx: QueryContext) -> JSON-able result
_CATALOG: Dict[str, Callable] = {}
_CATALOG_LOCK = threading.Lock()
# pipelines keyed by (name, param signature), LRU-bounded: the
# signature includes caller-supplied params, so varying them recycles
# slots instead of growing the process
_PIPELINES: Dict[tuple, Any] = {}
_PIPELINES_LOCK = threading.Lock()
_PIPELINES_MAX = 32


def register_query(name: str, fn: Callable) -> None:
    """Register (or replace) a catalog entry.  ``fn(params, ctx)``
    must be safe to call from several threads at once."""
    with _CATALOG_LOCK:
        _CATALOG[name] = fn


def unregister_query(name: str) -> None:
    with _CATALOG_LOCK:
        _CATALOG.pop(name, None)


def catalog_queries() -> List[str]:
    with _CATALOG_LOCK:
        return sorted(_CATALOG)


def has_query(name: str) -> bool:
    with _CATALOG_LOCK:
        return name in _CATALOG


def run_catalog_query(name: str, params: Optional[dict] = None,
                      ctx: Optional[QueryContext] = None):
    """Resolve ``name`` and run it."""
    with _CATALOG_LOCK:
        fn = _CATALOG.get(name)
    if fn is None:
        raise UnknownQueryError(name)
    return fn(dict(params or {}), ctx or QueryContext())


def _pipeline(key: tuple, build: Callable):
    with _PIPELINES_LOCK:
        fn = _PIPELINES.pop(key, None)
        if fn is not None:
            _PIPELINES[key] = fn      # re-insert at the LRU tail
            return fn
    # build outside the lock, so a first-touch signature does not stall
    # every other thread's hit; the first one published wins, so all
    # callers share one pipeline per signature
    fn = build()
    with _PIPELINES_LOCK:
        fn = _PIPELINES.pop(key, fn)  # keep an earlier publisher
        _PIPELINES[key] = fn
        while len(_PIPELINES) > _PIPELINES_MAX:
            _PIPELINES.pop(next(iter(_PIPELINES)))
        return fn


def _rows(*arrays) -> List[list]:
    """Pipeline outputs as plain host lists of rows (python ints and
    floats only): JSON-able and comparable byte for byte."""
    import numpy as np
    cols = [(a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a))
            .reshape(-1) for a in arrays]
    return [[float(v) if isinstance(v, np.floating) else int(v)
             for v in row] for row in zip(*cols)]


def _device(params: dict) -> str:
    return str(params.get("device", "cuda"))


# ------------------------------------------------------- built-in runners
# (each: seeded data + cached pipeline + overflow check + host rows)


def _run_q5(params: dict, ctx: QueryContext):
    from spark_rapids_tpu_torch.models import tpcds
    ctx.check_cancel()
    rows = int(params.get("rows", 2048))
    stores = int(params.get("stores", 8))
    seed = int(params.get("seed", 5))
    cap = int(params.get("join_capacity", 1 << 12))
    d = tpcds.gen_q5(rows=rows, stores=stores, days=60, seed=seed,
                     device=_device(params))
    q = _pipeline(("q5", stores, cap),
                  lambda: tpcds.make_q5(stores, join_capacity=cap))
    k, sales, rets, profit, of = q(d)
    if bool(of):
        raise RuntimeError("q5 join capacity overflow")
    return _rows(k, sales, rets, profit)


def _run_q9(params: dict, ctx: QueryContext):
    from spark_rapids_tpu_torch.models import tpcds
    ctx.check_cancel()
    rows = int(params.get("rows", 4096))
    seed = int(params.get("seed", 9))
    data = tpcds.gen_q9(rows=rows, seed=seed, device=_device(params))
    return _rows(*tpcds.run_q9(*data))


def _run_q72(params: dict, ctx: QueryContext):
    from spark_rapids_tpu_torch.models import tpcds
    ctx.check_cancel()
    rows = int(params.get("rows", 2048))
    items = int(params.get("items", 64))
    max_week = int(params.get("max_week", 16))
    seed = int(params.get("seed", 72))
    cap = int(params.get("join_capacity", 1 << 17))
    week0 = 11_000 // 7
    d = tpcds.gen_q72(cs_rows=rows, inv_rows=rows // 2, items=items,
                      days=35, seed=seed, device=_device(params))
    q = _pipeline(("q72", items, max_week, cap),
                  lambda: tpcds.make_q72(items, max_week,
                                         join_capacity=cap, week0=week0))
    i, w, c, of = q(d)
    if bool(of):
        raise RuntimeError("q72 join capacity overflow")
    return _rows(i, w, c)


def _q3_data(params: dict):
    from spark_rapids_tpu_torch.models import tpcds
    return tpcds.gen_q3(rows=int(params.get("rows", 2048)),
                        items=int(params.get("items", 128)), days=730,
                        brands=int(params.get("brands", 16)),
                        seed=int(params.get("seed", 3)),
                        device=_device(params))


def _run_q3(params: dict, ctx: QueryContext):
    from spark_rapids_tpu_torch.models import tpcds
    ctx.check_cancel()
    brands = int(params.get("brands", 16))
    manufact = int(params.get("manufact", 3))
    base = 10_957
    d = _q3_data(params)
    q = _pipeline(("q3", base, brands, manufact),
                  lambda: tpcds.make_q3(base, years=2, brands=brands,
                                        manufact=manufact))
    year, brand, sums, total = q(d)
    return _rows(year, brand, sums) + [[int(total)]]


def _run_q7(params: dict, ctx: QueryContext):
    from spark_rapids_tpu_torch.models import tpcds
    ctx.check_cancel()
    rows = int(params.get("rows", 2048))
    items = int(params.get("items", 64))
    seed = int(params.get("seed", 7))
    d = tpcds.gen_q7(rows=rows, items=items, demos=256, promos=32,
                     seed=seed, device=_device(params))
    q = _pipeline(("q7", items), lambda: tpcds.make_q7(items))
    return _rows(*q(d))


# stage-IR variants (plan/catalog.py): the same queries through the
# stage compiler, byte-identical to the hand pipelines; the compiler
# memoizes each stage per plan digest, so no _pipeline layer here


def _run_q5_fused(params: dict, ctx: QueryContext):
    from spark_rapids_tpu_torch.models import tpcds
    from spark_rapids_tpu_torch.plan import catalog as plan_catalog
    ctx.check_cancel()
    rows = int(params.get("rows", 2048))
    stores = int(params.get("stores", 8))
    seed = int(params.get("seed", 5))
    cap = int(params.get("join_capacity", 1 << 12))
    d = tpcds.gen_q5(rows=rows, stores=stores, days=60, seed=seed,
                     device=_device(params))
    k, sales, rets, profit, of = plan_catalog.run_q5(d, stores, cap)
    if bool(of):
        raise RuntimeError("q5 join capacity overflow")
    return _rows(k, sales, rets, profit)


def _run_q3_fused(params: dict, ctx: QueryContext):
    from spark_rapids_tpu_torch.plan import catalog as plan_catalog
    ctx.check_cancel()
    brands = int(params.get("brands", 16))
    manufact = int(params.get("manufact", 3))
    d = _q3_data(params)
    year, brand, sums, total = plan_catalog.run_q3(
        d, 10_957, years=2, brands=brands, manufact=manufact)
    return _rows(year, brand, sums) + [[int(total)]]


def _run_q72_fused(params: dict, ctx: QueryContext):
    from spark_rapids_tpu_torch.models import tpcds
    from spark_rapids_tpu_torch.plan import catalog as plan_catalog
    ctx.check_cancel()
    rows = int(params.get("rows", 2048))
    items = int(params.get("items", 64))
    max_week = int(params.get("max_week", 16))
    seed = int(params.get("seed", 72))
    cap = int(params.get("join_capacity", 1 << 17))
    d = tpcds.gen_q72(cs_rows=rows, inv_rows=rows // 2, items=items,
                      days=35, seed=seed, device=_device(params))
    i, w, c, of = plan_catalog.run_q72(d, items, max_week, cap,
                                       week0=11_000 // 7)
    if bool(of):
        raise RuntimeError("q72 join capacity overflow")
    return _rows(i, w, c)


register_query("tpcds_q3", _run_q3)
register_query("tpcds_q5", _run_q5)
register_query("tpcds_q7", _run_q7)
register_query("tpcds_q9", _run_q9)
register_query("tpcds_q72", _run_q72)
register_query("tpcds_q3_fused", _run_q3_fused)
register_query("tpcds_q5_fused", _run_q5_fused)
register_query("tpcds_q72_fused", _run_q72_fused)
