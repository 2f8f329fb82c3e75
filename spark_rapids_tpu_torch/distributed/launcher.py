"""Multi-process launch harness: spawn N shuffle workers, hand out the
address map, babysit the processes, and collect their summaries.

The launcher is a library, so tests and `chip_smoke.py` drive the same
code path.  Workers run ``python -m spark_rapids_tpu_torch.distributed.
runner`` on ``device`` ("cuda" unless the caller asks for the CPU);
several workers may share one card.

The babysitter POLLS the whole fleet: a worker exiting nonzero kills
the remaining ranks and propagates its exit code IMMEDIATELY
(:class:`WorkerFailed` carries rank + rc) instead of leaving the
survivors to ride out the full inbox deadline.  In ``elastic=True``
runs a death is an EXPECTED event: the launcher respawns the dead rank
once (``respawn=True``), without the injected-death env, and the
rejoined worker converges by rebalance + replay.

One trace covers the fleet: the launcher opens the root span, seeds
its context into every worker (``SPARK_RAPIDS_TPU_DIST_TRACE_CTX``)
and dumps its own spans beside the workers' (:func:`span_files`).
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class _DeferredSpawn:
    """A respawn scheduled for the future, shaped like a Popen so the
    babysitter polls it like any worker.  Real orchestrators take tens
    of seconds to reschedule a dead pod; the delay keeps the death
    window OBSERVABLE (survivors' sends must fail and trigger the
    membership barrier before the endpoint is resurrected)."""

    def __init__(self, delay_s: float, factory: Callable):
        self._due = time.monotonic() + delay_s
        self._factory = factory
        self._proc = None

    def _materialize(self):
        if self._proc is None and time.monotonic() >= self._due:
            self._proc = self._factory()
        return self._proc

    def poll(self):
        p = self._materialize()
        return None if p is None else p.poll()

    def kill(self) -> None:
        if self._proc is not None:
            self._proc.kill()
        self._due = float("inf")  # cancel a still-pending spawn

    def wait(self, timeout=None):
        if self._proc is not None:
            return self._proc.wait(timeout=timeout)
        return 0


class WorkerFailed(RuntimeError):
    """A worker exited nonzero (or the fleet timed out).  ``rank`` and
    ``rc`` let a caller propagate the worker's own exit code."""

    def __init__(self, rank: int, rc: Optional[int], tail: str = ""):
        self.rank = int(rank)
        self.rc = rc
        if rc is None:
            msg = f"worker rank {rank} timed out ({tail})"
        else:
            msg = f"worker rank {rank} exited rc={rc}: {tail}"
        super().__init__(msg)


def babysit(procs: Dict[int, object], timeout_s: float, *,
            on_death: Optional[Callable] = None,
            poll_s: float = 0.2,
            clock=time.monotonic, sleep=time.sleep) -> None:
    """Poll every worker until all exit 0.  A nonzero exit consults
    ``on_death(rank, rc)``: return a replacement process to keep going
    (elastic respawn), or None to fail the fleet NOW: every surviving
    process is killed and :class:`WorkerFailed` carries the dead rank's
    exit code out immediately."""
    active = dict(procs)
    deadline = clock() + timeout_s
    try:
        while active:
            progressed = False
            for r in sorted(active):
                rc = active[r].poll()
                if rc is None:
                    continue
                progressed = True
                del active[r]
                if rc == 0:
                    continue
                repl = on_death(r, rc) if on_death is not None \
                    else None
                if repl is None:
                    raise WorkerFailed(r, rc)
                active[r] = repl
            if active:
                if clock() >= deadline:
                    raise WorkerFailed(min(active), None,
                                       tail=f"after {timeout_s}s")
                if not progressed:
                    sleep(poll_s)
    except WorkerFailed:
        for p in active.values():
            try:
                if p.poll() is None:
                    p.kill()
            except Exception:  # noqa: BLE001 — best-effort reap
                pass
        for p in active.values():
            try:
                p.wait(timeout=10)
            except Exception:  # noqa: BLE001 — best-effort reap
                pass
        raise


def make_addresses(world: int, outdir: str,
                   transport: str = "unix") -> List[str]:
    """Per-rank listen addresses.  Unix sockets (default) live in the
    run directory: no port allocation races; TCP mode binds throwaway
    sockets to reserve free localhost ports (the map is then passed to
    every worker, so all peers agree)."""
    if transport == "unix":
        return [f"unix:{os.path.join(outdir, f'shuffle_{r}.sock')}"
                for r in range(world)]
    # hold every probe socket open until the whole map is built: a
    # closed never-listened port is immediately reusable, so closing
    # per-iteration could hand the SAME ephemeral port to two ranks
    probes = []
    addrs = []
    try:
        for _ in range(world):
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.bind(("127.0.0.1", 0))
            probes.append(s)
            addrs.append(f"127.0.0.1:{s.getsockname()[1]}")
    finally:
        for s in probes:
            s.close()
    return addrs


def launch(world: int, outdir: str, *,
           ops: Sequence[str] = ("q5", "q72"),
           transport: str = "unix",
           params: Optional[dict] = None,
           fault: Optional[str] = None,
           fault_rank: int = 1,
           die: Optional[str] = None,
           die_rank: int = 2,
           elastic: bool = False,
           respawn: bool = False,
           respawn_delay_s: float = 0.0,
           device: str = "cuda",
           worker_env: Optional[Dict[str, str]] = None,
           mesh: str = "0",
           timeout_s: float = 300.0) -> Dict:
    """Run ``world`` worker processes on ``device`` to completion.
    Returns ``{"summaries": [...], "addresses": [...], "outdir": ...,
    "deaths": [...], "respawns": [...], "spawned": {rank: [t, ...]},
    "wall_s": s}``; ``spawned`` holds each incarnation's spawn time
    (``time.time()``), which with a summary's ``t_ready`` gives its boot
    seconds.

    ``fault`` is a transport fault spec (e.g. ``"corrupt:0:101"`` or
    ``"slow:-1:2000"``) armed on ``fault_rank``'s environment; ``die``
    injects a worker death (``"q5:partials"``, see runner._die_spec) on
    ``die_rank``.  With ``elastic`` the workers speak the elastic fleet
    protocol; ``respawn`` additionally restarts a dead rank ONCE
    (injected death stripped) and tells workers to await it at the
    fleet barrier.  A worker dying outside the respawn budget kills the
    remaining ranks and raises :class:`WorkerFailed` with its exit code
    immediately.  The workers inherit this process's environment
    (inductor's and Triton's cache directories included) plus
    ``worker_env``.  The result also names the fleet's ``trace_id``.

    ``mesh`` is the workers' SPARK_RAPIDS_TPU_DIST_MESH: ``"0"`` keeps
    the harness; ``"1"``/``"auto"`` has each worker also form the
    process group at a ``file://`` store in ``outdir`` (the summary's
    ``mesh`` reports the mode, the backend, or why it fell back)."""
    from spark_rapids_tpu_torch import observability as obs

    t_launch = time.perf_counter()
    os.makedirs(outdir, exist_ok=True)
    addrs = make_addresses(world, outdir, transport)
    if mesh != "0" and os.path.exists(os.path.join(outdir, "mesh_store")):
        os.remove(os.path.join(outdir, "mesh_store"))

    # one trace for the whole fleet: the launcher owns the root span;
    # workers parent their process spans under it via the env context
    prior_tracing = obs.TRACER.enabled
    obs.enable_tracing()
    root = obs.TRACER.start_span(
        "dist_query", kind="query",
        attrs={"world": world, "ops": ",".join(ops),
               "transport": transport, "elastic": elastic})
    trace_ctx = f"{root.trace_id:016x}:{root.span_id:016x}"

    def worker_cmd(r: int) -> List[str]:
        cmd = [sys.executable, "-m",
               "spark_rapids_tpu_torch.distributed.runner",
               "--rank", str(r), "--world", str(world),
               "--addresses", ",".join(addrs),
               "--ops", ",".join(ops),
               "--outdir", outdir,
               "--params", json.dumps(params or {}),
               "--device", device]
        if mesh != "0":
            cmd += ["--coordinator",
                    "file://" + os.path.join(outdir, "mesh_store")]
        if elastic:
            cmd.append("--elastic")
        return cmd

    def worker_environ(r: int, *, respawned: bool = False) -> dict:
        env = dict(os.environ)
        env.update({
            "SPARK_RAPIDS_TPU_KUDO_CRC": "1",
            "SPARK_RAPIDS_TPU_DIST_TRACE_CTX": trace_ctx,
            "SPARK_RAPIDS_TPU_DIST_MESH": mesh,
            "PYTHONPATH": _REPO_ROOT + os.pathsep
            + env.get("PYTHONPATH", ""),
        })
        env.pop("SPARK_RAPIDS_TPU_DIST_DIE", None)
        env.pop("SPARK_RAPIDS_TPU_DIST_RESPAWN", None)
        env.update(worker_env or {})
        if elastic and respawn:
            # workers' elastic barrier awaits the full original world
            # (the dead rank is coming back)
            env["SPARK_RAPIDS_TPU_FLEET_RESPAWN"] = "1"
        if fault and r == fault_rank:
            env["SPARK_RAPIDS_TPU_DIST_FAULT"] = fault
        if die and r == die_rank and not respawned:
            env["SPARK_RAPIDS_TPU_DIST_DIE"] = die
        if respawned:
            env["SPARK_RAPIDS_TPU_DIST_RESPAWN"] = "1"
        return env

    procs: List[subprocess.Popen] = []
    logs = []
    deaths: List[dict] = []
    respawns: List[dict] = []
    spawned: Dict[int, List[float]] = {}
    failed = True

    def spawn(r: int, *, respawned: bool = False) -> subprocess.Popen:
        suffix = "_respawn" if respawned else ""
        log = open(os.path.join(
            outdir, f"worker_rank{r}{suffix}.log"), "w")
        logs.append(log)
        spawned.setdefault(r, []).append(time.time())
        p = subprocess.Popen(
            worker_cmd(r), cwd=_REPO_ROOT,
            env=worker_environ(r, respawned=respawned),
            stdout=log, stderr=subprocess.STDOUT)
        procs.append(p)
        return p

    def on_death(r: int, rc: int):
        deaths.append({"rank": r, "rc": rc,
                       "t_mono": time.monotonic()})
        budget_left = elastic and respawn and not any(
            x["rank"] == r for x in respawns)
        if not budget_left:
            raise WorkerFailed(r, rc, tail=_tail(outdir, r))
        respawns.append({"rank": r, "t_mono": time.monotonic(),
                         "delay_s": respawn_delay_s})
        if respawn_delay_s > 0:
            return _DeferredSpawn(
                respawn_delay_s, lambda: spawn(r, respawned=True))
        return spawn(r, respawned=True)

    try:
        active = {r: spawn(r) for r in range(world)}
        try:
            babysit(active, timeout_s, on_death=on_death)
        except WorkerFailed as e:
            if e.rc is None:
                # re-raise the timeout with the hung worker's log tail
                # (babysit is outdir-blind)
                raise WorkerFailed(
                    e.rank, None,
                    tail=f"after {timeout_s}s; log: "
                         f"{_tail(outdir, e.rank)}") from None
            raise
        failed = False
    finally:
        if failed:
            # ANY error exit (spawn-loop failure included) must not
            # leak live workers holding sockets, CPU and card memory
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                try:
                    p.wait(timeout=10)
                except Exception:  # noqa: BLE001 — best-effort reap
                    pass
        for log in logs:
            log.close()
        root.end()
        _dump_launcher_spans(outdir, f"{root.trace_id:016x}")
        if not prior_tracing:
            obs.disable_tracing()

    summaries = []
    for r in range(world):
        with open(os.path.join(outdir,
                               f"summary_rank{r}.json")) as f:
            summaries.append(json.load(f))
    return {"summaries": summaries, "addresses": addrs,
            "trace_id": f"{root.trace_id:016x}",
            "outdir": outdir, "world": world, "ops": list(ops),
            "deaths": deaths, "respawns": respawns, "spawned": spawned,
            "wall_s": time.perf_counter() - t_launch}


def _dump_launcher_spans(outdir: str, trace_id: str) -> None:
    """Write the launcher's OWN spans for this trace (the fleet root)
    so the cross-process merge has the tree's apex."""
    from spark_rapids_tpu_torch import observability as obs
    from spark_rapids_tpu_torch.observability.dumpio import dump_via

    recs = [r for r in obs.TRACER.records()
            if r.get("trace_id") == trace_id]

    def _write(f):
        for r in recs:
            f.write(json.dumps(r) + "\n")
        return len(recs)

    dump_via(os.path.join(outdir, "spans_launcher.jsonl"), _write)


def _tail(outdir: str, rank: int, n: int = 2000) -> str:
    # a respawned incarnation logs to its own file: when it exists, IT
    # is the incarnation whose failure is being diagnosed
    for suffix in ("_respawn", ""):
        try:
            with open(os.path.join(
                    outdir, f"worker_rank{rank}{suffix}.log")) as f:
                return f.read()[-n:]
        except OSError:
            continue
    return "<no log>"


def span_files(outdir: str, world: int) -> List[str]:
    """Every per-process span dump of a finished run, launcher first."""
    paths = [os.path.join(outdir, "spans_launcher.jsonl")]
    paths += [os.path.join(outdir, f"spans_rank{r}.jsonl")
              for r in range(world)]
    return [p for p in paths if os.path.exists(p)]
