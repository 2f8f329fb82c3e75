"""Local-socket front door: JSON-lines over a unix domain socket.

The in-process API (``QueryServer.submit/poll/cancel/stats``) is the
primary surface (the JVM shim calls it through ``jni_entry``); this
module is the process-boundary twin for sidecar callers — one request
per line, one response per line:

    {"op": "submit", "tenant": "a", "query": "tpcds_q9",
     "params": {"rows": 1024}}
    -> {"ok": true, "query_id": "q-000001"}

    {"op": "poll", "query_id": "q-000001", "timeout_s": 5}
    -> {"ok": true, "status": {...}}

    {"op": "cancel", "query_id": "q-000001"}
    -> {"ok": true, "cancelled": true}

    {"op": "stats"}
    -> {"ok": true, "stats": {...}}

    {"op": "profile", "query_id": "q-000001"}
    -> {"ok": true, "profile": {...}}     # EXPLAIN ANALYZE artifact

    {"op": "drain", "deadline_s": 30}
    -> {"ok": true, "report": {"state": "drained", ...}}

Backpressure crosses the wire typed: a refused submit answers
``{"ok": false, "error": {"type": "ServerOverloaded", "reason":
"queue_full", "retry_after_s": ...}}`` so a remote client can
distinguish "slow down" from "broken".  One thread per connection —
the front door is a local control plane, not a data plane (batches
ride the shim's bulk entries, per the zero-copy Arrow handoff story).
"""

from __future__ import annotations

import json
import os
import socket
import threading
from typing import Callable, Optional

from spark_rapids_tpu_torch.models import UnknownQueryError
from spark_rapids_tpu_torch.server.admission import ServerOverloaded

IDLE_ENV = "SPARK_RAPIDS_TPU_SERVER_SOCKET_IDLE_S"
DEFAULT_IDLE_S = 120.0


def _idle_from_env() -> float:
    try:
        return float(os.environ.get(IDLE_ENV, "") or DEFAULT_IDLE_S)
    except ValueError:
        return DEFAULT_IDLE_S


class SocketFrontDoor:
    """Accept loop + per-connection request threads over AF_UNIX.

    Connections carry a read/idle timeout (``idle_s``, env
    ``SPARK_RAPIDS_TPU_SERVER_SOCKET_IDLE_S``, 0 disables): a
    half-open client holding the line without completing a request —
    or parking forever between requests — gets a typed ``IdleTimeout``
    error and a close instead of pinning a connection thread (and its
    read buffer) on the resident server indefinitely.

    ``drain_fn`` backs the ``drain`` op; the default drains the bound
    server instance directly, the process-global wiring passes
    ``server.drain_server`` so the singleton is cleared too."""

    def __init__(self, server, path: str,
                 idle_s: Optional[float] = None,
                 drain_fn: Optional[Callable] = None):
        self.server = server
        self.path = path
        self.idle_s = _idle_from_env() if idle_s is None \
            else float(idle_s)
        self._drain_fn = drain_fn
        self._sock: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._stopping = False

    def start(self) -> "SocketFrontDoor":
        if self._sock is not None:
            return self
        if os.path.exists(self.path):
            # only reclaim a genuinely DEAD socket: silently stealing
            # a live server's path would strand its clients on the
            # wrong server with no error anywhere
            probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            try:
                probe.settimeout(0.2)
                probe.connect(self.path)
            except OSError:
                os.unlink(self.path)   # refused/stale: safe to take
            else:
                raise OSError(
                    f"socket path {self.path!r} already has a live "
                    f"server bound")
            finally:
                probe.close()
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.bind(self.path)
        sock.listen(16)
        # bounded accept() blocks: closing a listening unix socket
        # does not reliably wake a blocked accept(), so the loop polls
        # the stop flag instead of parking forever (stop() would
        # otherwise eat its whole join timeout)
        sock.settimeout(0.2)
        self._sock = sock
        self._stopping = False
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="srt-server-door",
            daemon=True)
        self._accept_thread.start()
        return self

    def stop(self) -> None:
        self._stopping = True
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        try:
            os.unlink(self.path)
        except OSError:
            pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5)
            self._accept_thread = None

    # ------------------------------------------------------------ internals

    def _accept_loop(self) -> None:
        while not self._stopping:
            sock = self._sock
            if sock is None:
                return
            try:
                conn, _ = sock.accept()
            except socket.timeout:
                continue               # re-check the stop flag
            except OSError:
                return                 # closed under us: clean stop
            # per-connection read/idle bound (0 = block forever)
            conn.settimeout(self.idle_s if self.idle_s > 0 else None)
            threading.Thread(target=self._serve_connection,
                             args=(conn,), daemon=True).start()

    MAX_LINE = 1 << 20   # the one ingress everything else's bounds
    #                      depend on: a client streaming gigabytes
    #                      without a newline must not balloon the
    #                      resident server

    def _serve_connection(self, conn: socket.socket) -> None:
        try:
            with conn, conn.makefile("rwb") as f:
                while True:
                    try:
                        line = f.readline(self.MAX_LINE + 1)
                    except socket.timeout:
                        # idle/half-open client: answer typed, then
                        # close — the read buffer may hold a partial
                        # line, so the framing is unrecoverable anyway
                        try:
                            f.write(json.dumps({
                                "ok": False,
                                "error": {
                                    "type": "IdleTimeout",
                                    "message": "no complete request "
                                               f"within {self.idle_s}"
                                               "s; closing"}})
                                .encode() + b"\n")
                            f.flush()
                        except (OSError, ValueError):
                            pass
                        break
                    if not line:
                        break          # EOF: client closed
                    if len(line) > self.MAX_LINE:
                        f.write(json.dumps({
                            "ok": False,
                            "error": {"type": "RequestTooLarge",
                                      "message": "request line over "
                                                 f"{self.MAX_LINE} "
                                                 "bytes"}}).encode()
                            + b"\n")
                        f.flush()
                        break          # stream framing is now unknown
                    line = line.strip()
                    if not line:
                        continue
                    resp = self._dispatch(line)
                    try:
                        payload = json.dumps(resp)
                    except (TypeError, ValueError):
                        # a custom runner returned something non-
                        # JSON-able: answer typed, never drop the
                        # connection (the contract every other error
                        # path honors)
                        payload = json.dumps({
                            "ok": False,
                            "error": {"type": "UnserializableResult",
                                      "message": "response is not "
                                                 "JSON-serializable"}})
                    f.write(payload.encode() + b"\n")
                    f.flush()
        except (OSError, ValueError):
            pass                       # client went away mid-exchange

    def _dispatch(self, raw: bytes) -> dict:
        try:
            req = json.loads(raw)
            if not isinstance(req, dict):
                raise ValueError("request must be a JSON object")
            op = req.get("op")
            if op == "submit":
                deadline = req.get("deadline_s")
                qid = self.server.submit(str(req.get("tenant", "?")),
                                         str(req.get("query", "")),
                                         req.get("params") or {},
                                         deadline_s=float(deadline)
                                         if deadline is not None
                                         else None)
                return {"ok": True, "query_id": qid}
            if op == "poll":
                timeout = req.get("timeout_s")
                status = self.server.poll(
                    str(req.get("query_id", "")),
                    timeout_s=float(timeout)
                    if timeout is not None else None)
                return {"ok": True, "status": status}
            if op == "cancel":
                return {"ok": True, "cancelled": self.server.cancel(
                    str(req.get("query_id", "")))}
            if op == "stats":
                return {"ok": True, "stats": self.server.stats()}
            if op == "profile":
                qid = str(req.get("query_id", ""))
                prof = self.server.profile(qid)
                if prof is None:
                    return {"ok": False,
                            "error": {"type": "UnknownProfile",
                                      "message": f"no retained "
                                                 f"profile for "
                                                 f"{qid!r} (never "
                                                 "profiled, or "
                                                 "evicted)"}}
                return {"ok": True, "profile": prof}
            if op == "drain":
                deadline = req.get("deadline_s")
                kw = {"deadline_s": float(deadline)
                      if deadline is not None else None,
                      "flush_dir": str(req["flush_dir"])
                      if req.get("flush_dir") else None}
                fn = self._drain_fn or self.server.drain
                return {"ok": True, "report": fn(**kw)}
            return {"ok": False,
                    "error": {"type": "BadRequest",
                              "message": f"unknown op {op!r}"}}
        except ServerOverloaded as e:
            return {"ok": False, "error": e.to_dict()}
        except UnknownQueryError as e:
            return {"ok": False,
                    "error": {"type": "UnknownQuery",
                              "message": str(e)}}
        except Exception as e:  # noqa: BLE001 — protocol boundary:
            # a bad request must answer, not kill the connection
            return {"ok": False,
                    "error": {"type": type(e).__name__,
                              "message": str(e)[:300]}}
