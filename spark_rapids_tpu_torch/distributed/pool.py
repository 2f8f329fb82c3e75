"""A pool of rank processes that share one process group.

A mesh program runs as SPMD: one process per rank, every rank in the
same ``torch.distributed`` group (distributed/mesh.py).  A caller that
is itself one process (the JVM's embedded interpreter, a test, the
chip script) starts a :class:`RankPool` once and sends it functions:
``pool.run(fn, *args)`` calls ``fn(mesh, *args)`` on every rank at
once and returns the ranks' results in rank order.  ``fn`` travels by
its import path (a top-level function of an importable module); its
results come back with every tensor copied to a numpy array.

Nothing hangs for good: the rendezvous and every collective carry the
group's timeout, the pool waits for each result until a deadline, and
a rank that fails, dies or misses the deadline fails the call, stops
every rank and closes the pool (the group's pending collectives can no
longer be matched).  A pool left open is stopped when it is collected
or the caller's interpreter exits.  The caller's own process never
joins a group.
"""

from __future__ import annotations

import multiprocessing
import os
import shutil
import tempfile
import time
import traceback
import weakref
from typing import Callable, Dict, List, Optional


class RankFailed(RuntimeError):
    """A rank raised, died or missed its deadline; the pool is closed.
    ``retryable``: the rank raised an OOM the retry drivers re-run
    (robustness/retry.RETRYABLE or SPLITTABLE), so the whole call may
    be run again on fresh ranks."""

    def __init__(self, rank: int, detail: str, retryable: bool = False):
        super().__init__(f"rank {rank}: {detail}")
        self.rank = rank
        self.detail = detail
        self.retryable = retryable



def to_host(obj):
    """``obj`` with every tensor replaced by a numpy copy (tuples,
    named tuples, lists and dicts walked)."""
    import torch
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(to_host(x) for x in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_host(x) for x in obj)
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    return obj


def _rank_main(rank: int, world: int, init_method: str, device: str,
               backend: Optional[str], timeout_s: float, conn,
               env: Dict[str, str]) -> None:
    """A rank's life: join the group, report ready, then run what the
    pool sends until it sends None or goes away."""
    os.environ.update(env)
    t0 = time.perf_counter()
    try:
        import torch

        from spark_rapids_tpu_torch.distributed.mesh import (form_group,
                                                             leave_group)
        mesh = form_group(rank, world, init_method, device=device,
                          backend=backend, timeout_s=timeout_s)
        if mesh.device.type == "cuda":
            torch.zeros(1, device=mesh.device)   # the context
        conn.send(("ready", {"group_s": time.perf_counter() - t0,
                             "ready_at": time.time(),
                             "backend": mesh.backend,
                             "device": str(mesh.device),
                             "pid": os.getpid()}))
    except Exception:  # noqa: BLE001 — reported, then the rank exits
        conn.send(("err", traceback.format_exc()))
        return
    try:
        while True:
            try:
                msg = conn.recv()
            except EOFError:
                break
            if msg is None:
                break
            fn, args, kwargs = msg
            try:
                out = to_host(fn(mesh, *args, **kwargs))
            except Exception as e:  # noqa: BLE001 — sent to the caller
                from spark_rapids_tpu_torch.robustness.retry import \
                    is_retryable
                # stay in the group until the pool stops us: a peer
                # waiting on us then blocks rather than fails, so the
                # caller hears this rank's error first
                conn.send(("oom" if is_retryable(e) else "err",
                           traceback.format_exc()))
                continue
            conn.send(("ok", out))
    finally:
        leave_group()


def _stop(procs, conns, store_dir, grace_s: float) -> None:
    """Ask every rank to exit (grace_s > 0), kill what is left, close
    the pipes and remove the group's store."""
    if grace_s > 0:
        for conn in conns:
            try:
                conn.send(None)
            except (BrokenPipeError, OSError):
                pass
    deadline = time.monotonic() + grace_s
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    for conn in conns:
        conn.close()
    shutil.rmtree(store_dir, ignore_errors=True)


class RankPool:
    """``world`` rank processes in one group on ``device`` (``cpu``, or
    ``cuda``: rank r on card r mod cards).  ``backend`` defaults as
    mesh.default_backend says.  ``timeout_s`` is the group's timeout
    and each call's default deadline; ``boot_timeout_s`` bounds the
    start.  ``env`` is set in each rank before it imports torch.

    ``ranks`` holds each rank's start: ``boot_s`` from its spawn to its
    group formed (imports included), ``group_s`` the rendezvous alone,
    its ``backend``, ``device`` and ``pid``; ``boot_wall_s`` is the
    whole pool's."""

    def __init__(self, world: int, *, device: str = "cuda",
                 backend: Optional[str] = None, timeout_s: float = 120.0,
                 boot_timeout_s: float = 300.0,
                 env: Optional[Dict[str, str]] = None):
        self.world = int(world)
        self.timeout_s = float(timeout_s)
        self._dir = tempfile.mkdtemp(prefix="srt_mesh_")
        init_method = "file://" + os.path.join(self._dir, "store")
        ctx = multiprocessing.get_context("spawn")
        rank_env = dict(env or {})
        self._procs = []
        self._conns = []
        self.closed = False
        # stops the ranks if the caller never closes the pool
        self._finalizer = weakref.finalize(self, _stop, self._procs,
                                           self._conns, self._dir, 0.0)
        t0 = time.perf_counter()
        spawned = []
        for r in range(self.world):
            parent, child = ctx.Pipe()
            spawned.append(time.time())
            p = ctx.Process(target=_rank_main, name=f"srt-rank-{r}",
                            args=(r, self.world, init_method, device,
                                  backend, self.timeout_s, child,
                                  rank_env))
            p.start()
            child.close()
            self._procs.append(p)
            self._conns.append(parent)
        self.ranks = self._collect("boot", boot_timeout_s)
        for info, at in zip(self.ranks, spawned):
            info["boot_s"] = info.pop("ready_at") - at
        self.backend = self.ranks[0]["backend"]
        self.boot_wall_s = time.perf_counter() - t0

    def _collect(self, what: str, timeout_s: float) -> List:
        """Every rank's answer, in rank order, by the deadline."""
        deadline = time.monotonic() + timeout_s
        out: List = [None] * self.world
        pending = set(range(self.world))
        failure = None
        while pending and failure is None:
            for r in sorted(pending):
                conn = self._conns[r]
                if conn.poll(0.05):
                    try:
                        tag, val = conn.recv()
                    except EOFError:
                        failure = RankFailed(r, f"{what}: exited "
                                             f"rc={self._procs[r].exitcode}")
                        break
                    if tag not in ("ok", "ready"):
                        failure = RankFailed(r, f"{what} raised:\n{val}",
                                             retryable=tag == "oom")
                        break
                    out[r] = val
                    pending.discard(r)
                elif not self._procs[r].is_alive() and not conn.poll(0):
                    failure = RankFailed(r, f"{what}: exited "
                                         f"rc={self._procs[r].exitcode}")
                    break
            if failure is None and pending and time.monotonic() > deadline:
                failure = RankFailed(min(pending),
                                     f"{what}: no answer in {timeout_s} s")
        if failure is not None:
            self.close(force=True)
            raise failure
        return out

    def run(self, fn: Callable, *args, timeout_s: Optional[float] = None,
            **kwargs) -> List:
        """``fn(mesh, *args, **kwargs)`` on every rank; the results in
        rank order.  Raises :class:`RankFailed` (and closes the pool)
        when a rank fails."""
        if self.closed:
            raise RuntimeError("the rank pool is closed")
        for conn in self._conns:
            conn.send((fn, args, kwargs))
        return self._collect(getattr(fn, "__name__", "call"),
                             self.timeout_s if timeout_s is None
                             else timeout_s)

    def close(self, force: bool = False, timeout_s: float = 30.0) -> None:
        """Stop every rank (asking first unless ``force``) and remove
        the group's store."""
        if self.closed:
            return
        self.closed = True
        self._finalizer.detach()
        _stop(self._procs, self._conns, self._dir,
              0.0 if force else timeout_s)

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
