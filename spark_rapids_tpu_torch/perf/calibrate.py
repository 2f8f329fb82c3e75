"""Measured kernel-path calibration, and operand digests.

Where an op has several engines that give the same bytes (the join
router's four), the first large input of a given schema shape times
each candidate on a sample and the winner is cached per
``(op, digest, backend)``: in-process for the steady state, and in a
small JSON file so later processes skip the timing.

  * every candidate MUST give the same bytes on the same input: the
    calibration picks for speed only, never for correctness;
  * candidates are thunks over a caller-built sample; one that raises
    is left out of the pick, never an op failure;
  * the whole calibration runs under a wall-clock budget
    (``SPARK_RAPIDS_TPU_CALIB_BUDGET_S``): when it trips mid-way the
    best candidate measured so far wins, or the caller's default when
    nothing finished.

The backend names the torch device the operands live on
(``torch-cuda:<card name>`` or ``torch-cpu``), so a verdict taken on
the CPU never steers the card, and none that the JAX package wrote
(keyed by its own backend names, ``@cpu``, ``@tpu``) is ever read here.
A timed call ends in ``torch.cuda.synchronize`` when its result holds
CUDA tensors: launch time alone would crown an engine that has not run.

Operators pin a path per op with ``SPARK_RAPIDS_TPU_PATH_<OP>=<path>``
(op uppercased, non-alnum -> ``_``), bypassing measurement, and point
the verdict file elsewhere with ``SPARK_RAPIDS_TPU_CALIB_CACHE`` (the
JAX package's file by default; an empty string disables the file
layer).  ``SPARK_RAPIDS_TPU_CALIB_CACHE_TTL`` is a verdict's life in
seconds (a day by default).
"""

import hashlib
import json
import os
import re
import tempfile
import threading
import time
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from spark_rapids_tpu_torch.perf.jit_cache import bucket_rows

# ROADMAP A14: the JAX package's lock carries a lockdep rank
_LOCK = threading.RLock()
_PROC_CACHE: Dict[Tuple[str, str, str], str] = {}

DEFAULT_TTL_S = 86400.0


def _backend(device) -> str:
    """The verdict key's backend: the operands' torch device, with the
    card's name for CUDA."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return f"torch-cuda:{torch.cuda.get_device_name(dev)}"
    return f"torch-{dev.type}"


def _cuda_devices(out) -> set:
    if isinstance(out, torch.Tensor):
        return {out.device} if out.is_cuda else set()
    if isinstance(out, (tuple, list)):
        return set().union(*map(_cuda_devices, out))
    return set()


def _synced(out):
    """Fence the CUDA work behind a candidate's result before the timer
    stops: an engine that returns unsynced device tensors would be
    measured at launch cost, and the too-fast verdict cached for a day.
    Results with no CUDA tensor come from host code that has finished."""
    for dev in _cuda_devices(out):
        torch.cuda.synchronize(dev)
    return out


def cache_path() -> str:
    """Verdict file.  An empty string disables the file layer (the
    process cache still works)."""
    return os.environ.get(
        "SPARK_RAPIDS_TPU_CALIB_CACHE",
        os.path.join(tempfile.gettempdir(), "srt_rowconv_calib.json"))


def _load(path: str) -> dict:
    if not path:
        return {}
    try:
        with open(path) as f:
            d = json.load(f)
        return d if isinstance(d, dict) else {}
    except (OSError, ValueError):
        return {}


def _store(path: str, d: dict) -> None:
    """Atomic tmp+replace write: a reader racing a plain truncate-write
    would see torn JSON, _load would answer {}, and the next store
    would persist that empty dict, wiping every cached verdict."""
    if not path:
        return
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump(d, f)
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass


def _ttl() -> float:
    try:
        return float(os.environ.get(
            "SPARK_RAPIDS_TPU_CALIB_CACHE_TTL", DEFAULT_TTL_S))
    except ValueError:
        return DEFAULT_TTL_S


def _budget() -> float:
    try:
        return float(os.environ.get(
            "SPARK_RAPIDS_TPU_CALIB_BUDGET_S", "120"))
    except ValueError:
        return 120.0


def cached_verdict(key: str) -> Optional[str]:
    """Unexpired file-cache verdict for an opaque key."""
    rec = _load(cache_path()).get(key)
    if not isinstance(rec, dict):
        return None
    v = rec.get("verdict")
    try:
        fresh = time.time() - float(rec.get("t", 0)) < _ttl()
    except (TypeError, ValueError):
        fresh = False
    return v if isinstance(v, str) and fresh else None


def store_verdict(key: str, verdict: str) -> None:
    with _LOCK:
        path = cache_path()
        d = _load(path)
        d[key] = {"verdict": verdict, "t": time.time()}
        _store(path, d)


def operands_digest(parts, extra: str = "") -> str:
    """Stable digest folding EVERY operand of a multi-input op/stage:
    each part is ``(layout, rows)`` — a layout string (schema digest,
    dtype join, anything stable) plus a row count that folds as its
    power-of-two bucket class (``rows <= 0`` means the layout string
    already encodes the exact shape).  Folding all operands keeps a key
    for one operand's size class from being reused when another
    operand changed class."""
    items = []
    for layout, rows in parts:
        bucket = bucket_rows(int(rows)) if rows and rows > 0 else 0
        items.append(f"{layout}@{bucket}")
    s = "|".join(items) + f"|{extra}"
    return hashlib.sha1(s.encode()).hexdigest()[:16]


def pinned_path(op: str) -> Optional[str]:
    env = "SPARK_RAPIDS_TPU_PATH_" + re.sub(r"[^A-Za-z0-9]", "_",
                                            op).upper()
    return os.environ.get(env) or None


def forget(op: Optional[str] = None) -> None:
    """Drop process-cache verdicts (tests, operator resets).  The file
    layer keeps its entries: point SPARK_RAPIDS_TPU_CALIB_CACHE at a
    throwaway file for that."""
    with _LOCK:
        if op is None:
            _PROC_CACHE.clear()
        else:
            for k in [k for k in _PROC_CACHE if k[0] == op]:
                del _PROC_CACHE[k]


def pick_path(op: str, digest: str,
              candidates: Mapping[str, Callable[[], object]],
              default: str, *, device, repeats: int = 1) -> str:
    """Name of the winning candidate for (op, digest, the backend of
    ``device``, where the operands live).

    ``candidates`` maps path name -> thunk over a caller-built sample.
    Measurement: one warm call, then ``repeats`` timed calls, per
    candidate, under the calibration budget.  The verdict is cached
    process-wide and in the verdict file; an env pin short-circuits
    everything, even to a path the caller did not offer (callers check
    membership)."""
    pin = pinned_path(op)
    if pin is not None:
        return pin
    backend = _backend(device)
    pkey = (op, digest, backend)
    with _LOCK:
        v = _PROC_CACHE.get(pkey)
    if v is not None:
        return v
    fkey = f"{op}:{digest}@{backend}"
    v = cached_verdict(fkey)
    if v is not None and v in candidates:
        with _LOCK:
            _PROC_CACHE[pkey] = v
        return v

    budget = _budget()
    t_start = time.perf_counter()
    timings: Dict[str, float] = {}
    errors: Dict[str, str] = {}
    for name, thunk in candidates.items():
        if time.perf_counter() - t_start > budget:
            errors[name] = "budget_exceeded"
            continue
        try:
            t_w = time.perf_counter()
            _synced(thunk())             # warm: allocator, caches
            warm_s = time.perf_counter() - t_w
            if time.perf_counter() - t_start > budget:
                # the warm call alone tripped the budget: its wall time
                # is the measurement (a path this slow only needs to
                # lose), and the repeats are skipped
                timings[name] = warm_s
                continue
            t0 = time.perf_counter()
            for _ in range(max(1, repeats)):
                _synced(thunk())
            timings[name] = (time.perf_counter() - t0) / max(1, repeats)
        except Exception as e:  # noqa: BLE001 — a broken engine is a
            # calibration datum, never an op failure
            errors[name] = f"error:{type(e).__name__}"
    if timings:
        verdict = min(timings, key=timings.get)
        if (timings[verdict] > budget
                and errors.get(default) == "budget_exceeded"):
            # every measured candidate alone blew the whole budget and
            # the default never got a turn: a path that slow must not
            # win by starving the rest (callers order expected-fast
            # candidates first)
            verdict = default
    else:
        verdict = default
    with _LOCK:
        _PROC_CACHE[pkey] = verdict
    store_verdict(fkey, verdict)
    # ROADMAP A14: the JAX package journals a kernel_calibrated record
    # (timings, errors) here
    return verdict


def last_verdict(op: str, digest: str, device) -> Optional[str]:
    """Process-cache peek (reports, tests)."""
    with _LOCK:
        return _PROC_CACHE.get((op, digest, _backend(device)))
