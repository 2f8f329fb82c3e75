"""Process-wide compile cache with shape bucketing.

The cache answers one question for the hot paths: "I need THIS kernel
for THIS schema layout at THIS row count — give me a compiled program
without recompiling".  Two mechanisms make that cheap:

  * **Row bucketing** — row counts are rounded up to the next power of
    two before keying, and operands are zero-padded to the bucket, so
    repeated batches of nearby sizes share one compiled program.
    Padded output rows are sliced off by the caller.
  * **Build once** — a miss runs the caller's ``build()`` once (for
    :meth:`JitCache.cached_call`, ``torch.compile(fn)`` warmed on the
    padded operands) and stores the result; a hit calls it directly,
    so a hit never compiles (:meth:`JitCache.stats` counts both).

PyTorch has no operand donation, so a padded operand is a plain
throwaway copy; nothing here emulates donation.

Eviction is LRU under two budgets: an entry count and an estimated
byte footprint (the sum of operand bytes per entry — a proxy for the
program's workspace; the compiler does not expose the true number).
Every hit/miss/eviction also lands in the observability registry
(``srt_jit_cache_*``) when metrics are enabled.
"""

from __future__ import annotations

import hashlib
import os
import time
from collections import OrderedDict
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from spark_rapids_tpu_torch.analysis.lockdep import make_rlock

_MIN_BUCKET = 8


def cache_enabled() -> bool:
    """Dynamic env check so operators can flip the cache off per run
    (``SPARK_RAPIDS_TPU_JIT_CACHE=0``) without code changes."""
    return os.environ.get("SPARK_RAPIDS_TPU_JIT_CACHE", "1") != "0"


def bucket_rows(n: int, min_bucket: int = _MIN_BUCKET) -> int:
    """Power-of-two row bucket: smallest 2^k >= n (floor min_bucket)."""
    if n <= min_bucket:
        return min_bucket
    return 1 << (int(n) - 1).bit_length()


def pad_axis0(arr: torch.Tensor, bucket: int) -> torch.Tensor:
    """Zero-pad the leading (rows) axis up to ``bucket`` on the
    tensor's own device.  A tensor already at the bucket is returned
    as is: PyTorch has no operand donation, so a compiled program
    never takes ownership of the caller's buffer and no defensive copy
    is needed."""
    n = int(arr.shape[0])
    if n == bucket:
        return arr
    return torch.cat([arr, arr.new_zeros(
        (bucket - n,) + tuple(arr.shape[1:]))])


def schema_digest(schema: Sequence, nullable: Sequence[bool] = (),
                  extra: str = "") -> str:
    """Stable digest of a schema layout: one (kind, scale) pair per
    column plus the nullability pattern (validity presence changes the
    kernel's pytree signature) plus a free-form discriminator."""
    parts = ";".join(f"{dt.kind}:{dt.scale}" for dt in schema)
    nulls = "".join("1" if b else "0" for b in nullable)
    s = f"{parts}|{nulls}|{extra}"
    return hashlib.sha1(s.encode()).hexdigest()[:16]


def _tree_nbytes(tree) -> int:
    total = 0
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_nbytes(v) for v in tree)
    nb = getattr(tree, "nbytes", None)
    return int(nb) if nb is not None else 0


class _Entry:
    __slots__ = ("fn", "cost_bytes", "owner", "compile_ns")

    def __init__(self, fn, cost_bytes, owner, compile_ns):
        self.fn = fn
        self.cost_bytes = int(cost_bytes)
        self.owner = owner
        self.compile_ns = int(compile_ns)


class JitCache:
    """LRU registry of compiled kernels keyed by
    (kernel name, digest, row bucket)."""

    def __init__(self, max_entries: Optional[int] = None,
                 max_bytes: Optional[int] = None):
        self._lock = make_rlock("perf.jit_cache")
        self._entries: "OrderedDict[Tuple[str, str, int], _Entry]" = \
            OrderedDict()
        self._max_entries = max_entries
        self._max_bytes = max_bytes
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.compiles = 0
        self.compile_ns_total = 0
        self._by_kernel: Dict[str, Dict[str, int]] = {}

    # ------------------------------------------------------------ budgets

    def max_entries(self) -> int:
        if self._max_entries is not None:
            return self._max_entries
        try:
            return int(os.environ.get(
                "SPARK_RAPIDS_TPU_JIT_CACHE_ENTRIES", "256"))
        except ValueError:
            return 256

    def max_bytes(self) -> int:
        if self._max_bytes is not None:
            return self._max_bytes
        try:
            return int(os.environ.get(
                "SPARK_RAPIDS_TPU_JIT_CACHE_BYTES", str(8 << 30)))
        except ValueError:
            return 8 << 30

    def enabled(self) -> bool:
        return cache_enabled()

    # ------------------------------------------------------------- stats

    def _kernel_stat(self, name: str) -> Dict[str, int]:
        return self._by_kernel.setdefault(
            name, {"hits": 0, "misses": 0, "evictions": 0})

    def stats(self) -> dict:
        with self._lock:
            return {
                "enabled": self.enabled(),
                "entries": len(self._entries),
                "bytes": self._bytes,
                "max_entries": self.max_entries(),
                "max_bytes": self.max_bytes(),
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "compiles": self.compiles,
                "compile_ns_total": self.compile_ns_total,
                "kernels": {k: dict(v)
                            for k, v in sorted(self._by_kernel.items())},
            }

    def clear(self, reset_stats: bool = False) -> int:
        """Drop every entry (compiled programs are released);
        returns the number dropped.  Cumulative stats survive unless
        ``reset_stats``."""
        with self._lock:
            n = len(self._entries)
            self._entries.clear()
            self._bytes = 0
            if reset_stats:
                self.hits = self.misses = self.evictions = 0
                self.compiles = self.compile_ns_total = 0
                self._by_kernel.clear()
            return n

    # ------------------------------------------------------------ lookup

    def get_or_build(self, name: str, digest: str, bucket: int,
                     build: Callable[[], Callable], *,
                     cost_bytes: int = 0, owner=None,
                     counts_compile: bool = True) -> Callable:
        """Return the cached callable for (name, digest, bucket),
        invoking ``build()`` on a miss.  ``owner`` (optional) is held
        strongly in the entry and identity-checked on hits — callers
        keyed by object identity (exchange step factories) use it to
        make id-reuse collisions impossible."""
        from spark_rapids_tpu_torch import observability as _obs

        key = (name, digest, int(bucket))
        with self._lock:
            e = self._entries.get(key)
            if e is not None and (owner is None or e.owner is owner):
                self._entries.move_to_end(key)
                self.hits += 1
                self._kernel_stat(name)["hits"] += 1
                _obs.record_jit_cache("hit", name)
                return e.fn

        # build outside the lock: compiles can take seconds and must
        # not serialize unrelated kernels.  A racing thread may build
        # the same entry twice; last insert wins (both are correct).
        # compile_begin marks the START too: a multi-second
        # compile is the classic slow-but-alive window, and the
        # lifeguard's heartbeat hook must see a sign of life on BOTH
        # edges or a first-touch compile longer than the hang
        # threshold reads as a hung worker
        _obs.record_jit_cache("compile_begin", name)
        t0 = time.monotonic_ns()
        fn = build()
        dt = time.monotonic_ns() - t0

        with self._lock:
            self.misses += 1
            ks = self._kernel_stat(name)
            ks["misses"] += 1
            if counts_compile:
                self.compiles += 1
                self.compile_ns_total += dt
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.cost_bytes
            self._entries[key] = _Entry(fn, cost_bytes, owner, dt)
            self._bytes += int(cost_bytes)
            evicted = self._evict_over_budget()
        _obs.record_jit_cache("miss", name, compile_ns=dt)
        for ev_name in evicted:
            _obs.record_jit_cache("eviction", ev_name)
        return fn

    def _evict_over_budget(self):
        """Caller holds the lock.  Returns kernel names evicted."""
        evicted = []
        max_e, max_b = self.max_entries(), self.max_bytes()
        while len(self._entries) > max(1, max_e) or \
                (self._bytes > max_b and len(self._entries) > 1):
            key, e = self._entries.popitem(last=False)
            self._bytes -= e.cost_bytes
            self.evictions += 1
            self._kernel_stat(key[0])["evictions"] += 1
            evicted.append(key[0])
        return evicted

    # ------------------------------------------------------- cached call

    def cached_call(self, name: str, digest: str, fn: Callable,
                    args: tuple, *, bucket: int):
        """Run ``fn(*args)`` through a program compiled once and cached
        under (name, digest, bucket): a miss builds
        ``torch.compile(fn)`` and runs it on ``args`` once (the first
        call traces and compiles, so the compile lands inside the
        miss); a hit calls the cached program.  ``args`` must already
        be padded to the bucket; every later call with the same key
        must pass the same shapes and dtypes (bucketing guarantees this
        for row-shaped operands)."""
        cost = _tree_nbytes(args)
        first = []

        def build():
            compiled = torch.compile(fn, fullgraph=True, dynamic=False)
            first.append(compiled(*args))
            return compiled

        compiled = self.get_or_build(name, digest, bucket, build,
                                     cost_bytes=cost)
        if first:
            return first[0]
        return compiled(*args)


CACHE = JitCache()
