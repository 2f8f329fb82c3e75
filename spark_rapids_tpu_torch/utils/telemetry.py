"""Device telemetry (reference NVMLJni.cpp + nvml/*.java: device info,
utilization, memory, periodic NVMLMonitor with callback interface).

The port of the JAX package's ``utils/telemetry.py``, with
``jax.devices()`` replaced by ``torch.cuda``: the card's name from
``get_device_name``, the bytes in use from ``memory_allocated`` (the
caching allocator's live tensor bytes, the counterpart of libtpu's
``bytes_in_use``) and the limit from the device properties'
``total_memory``.  The functions read the card; ``device="cpu"`` asks
for the host, which (like the JAX CPU backend) has one device and no
memory counters.  With no card and no such request they raise.

Utilization, power and clock raise :class:`TelemetryNotSupported`
where the JAX package does: utilization is HBM occupancy when memory
counters exist, and power and clock are never read (the port reads no
NVML, as the JAX package reads no counterpart)."""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch

from spark_rapids_tpu_torch import observability as _obs


@dataclass
class DeviceInfo:
    index: int
    kind: str
    platform: str
    process_index: int
    memory_stats: Dict[str, int] = field(default_factory=dict)


def _on_cpu(device) -> bool:
    """True when the caller asked for the host; raises when the card
    is asked for (the default) and there is none."""
    if device is not None and torch.device(device).type == "cpu":
        return True
    if not torch.cuda.is_available():
        raise RuntimeError(
            "device telemetry: no CUDA device (pass device='cpu' for "
            "the host)")
    return False


def get_device_count(device=None) -> int:
    return 1 if _on_cpu(device) else torch.cuda.device_count()


def get_device_info(index: int = 0, device=None) -> DeviceInfo:
    if _on_cpu(device):
        if index != 0:
            raise IndexError(f"cpu device index {index} out of range")
        return DeviceInfo(index=0, kind="cpu", platform="cpu",
                          process_index=0)
    stats = {
        "bytes_in_use": int(torch.cuda.memory_allocated(index)),
        "bytes_limit": int(
            torch.cuda.get_device_properties(index).total_memory),
    }
    return DeviceInfo(index=index,
                      kind=torch.cuda.get_device_name(index),
                      platform="gpu", process_index=0,
                      memory_stats=stats)


def get_memory_info(index: int = 0, device=None) -> Dict[str, int]:
    """{'total': .., 'used': .., 'free': ..} when the device exposes
    memory counters (the NVML memory query analog)."""
    stats = get_device_info(index, device).memory_stats
    out = {}
    if "bytes_limit" in stats:
        out["total"] = stats["bytes_limit"]
    if "bytes_in_use" in stats:
        out["used"] = stats["bytes_in_use"]
        if "total" in out:
            out["free"] = out["total"] - out["used"]
    return out


class TelemetryNotSupported(RuntimeError):
    """Explicit NVML_ERROR_NOT_SUPPORTED analog: queries the current
    backend/platform cannot answer raise instead of returning
    plausible-looking zeros."""


def get_device_utilization(index: int = 0, device=None) -> float:
    """Device duty-cycle analog of nvmlDeviceGetUtilizationRates:
    HBM occupancy ``used/total``, as in the JAX package.  Raises
    TelemetryNotSupported when the device has no memory counters (the
    host)."""
    mem = get_memory_info(index, device)
    if "total" not in mem or "used" not in mem or not mem["total"]:
        raise TelemetryNotSupported(
            "device utilization: backend exposes no HBM counters")
    return mem["used"] / mem["total"]


def get_power_usage_watts(index: int = 0, device=None) -> float:
    """nvmlDeviceGetPowerUsage analog — kept as an explicit
    unsupported surface so callers can distinguish 'no data' from
    'zero watts'."""
    raise TelemetryNotSupported("power telemetry not exposed")


def get_clock_mhz(index: int = 0, device=None) -> float:
    """nvmlDeviceGetClockInfo analog — same explicit-unsupported story
    as power."""
    raise TelemetryNotSupported("clock telemetry not exposed")


def get_host_cpu_times() -> Dict[str, int]:
    """Host CPU jiffies from /proc/stat (user/system/idle/iowait) —
    sample twice and diff for utilization."""
    try:
        with open("/proc/stat") as f:
            parts = f.readline().split()
    except OSError as e:
        raise TelemetryNotSupported(f"/proc/stat unreadable: {e}")
    v = [int(x) for x in parts[1:8]]
    if not any(v):
        # gVisor-style sandboxes expose /proc/stat with every jiffy
        # counter zero; that carries no signal, same as no counters
        raise TelemetryNotSupported("/proc/stat reports zero jiffies")
    return {"user": v[0] + v[1], "system": v[2], "idle": v[3],
            "iowait": v[4]}


def get_host_memory_info() -> Dict[str, int]:
    """Host RAM from /proc/meminfo (the NVML host-side counterpart the
    RmmSpark host-alloc hooks budget against)."""
    out: Dict[str, int] = {}
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                k, rest = line.split(":", 1)
                if k in ("MemTotal", "MemAvailable", "MemFree"):
                    out[k] = int(rest.strip().split()[0]) * 1024
    except OSError as e:
        raise TelemetryNotSupported(f"/proc/meminfo unreadable: {e}")
    return out


class Monitor:
    """Periodic sampler with listener callback (NVMLMonitor.java:49).

    Samples carry device info plus host CPU/memory; sampling or
    listener errors are surfaced through `on_error` (and counted in
    `error_count`) rather than swallowed.  ``device`` is passed to
    every device query (None = the card)."""

    def __init__(self, period_millis: int,
                 listener: Callable[[List[DeviceInfo]], None],
                 on_error: Optional[Callable[[Exception], None]] = None,
                 device=None):
        self.period = period_millis / 1000.0
        self.listener = listener
        self.on_error = on_error
        self.device = device
        self.error_count = 0
        self.sample_count = 0
        self.last_host_cpu: Optional[Dict[str, int]] = None
        self.last_cpu_utilization: Optional[float] = None
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._lifecycle = threading.Lock()

    def start(self):
        with self._lifecycle:
            if self._running:
                return
            self._running = True
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()

    def stop(self, timeout: Optional[float] = None):
        """Idempotent shutdown: safe to call repeatedly, concurrently,
        before start, and even from the listener callback (the sampler
        thread never joins itself).  Joins with a bounded timeout so a
        wedged backend query can never hang the caller."""
        with self._lifecycle:
            self._running = False
            t, self._thread = self._thread, None
        if t is not None and t is not threading.current_thread():
            t.join(timeout if timeout is not None
                   else self.period * 4 + 1)

    def _report(self, exc: Exception):
        self.error_count += 1
        if self.on_error is not None:
            try:
                self.on_error(exc)
            except Exception:
                pass  # an error-handler bug must not kill the monitor

    def _loop(self):
        # `me` check: stop() clears _thread before (maybe) joining, so a
        # stop/start pair that beats this loop's next _running read still
        # terminates the old sampler — only the thread start() installed
        # may keep looping, never two at once
        me = threading.current_thread()
        while self._running and self._thread is me:
            try:
                infos = [get_device_info(i, self.device)
                         for i in range(get_device_count(self.device))]
            except Exception as e:  # device sampling failure
                self._report(e)
                time.sleep(self.period)
                continue
            # HBM occupancy -> observability gauge (NVML-monitor role in
            # the reference's metrics pipeline); no-op when disabled
            for info in infos:
                b = info.memory_stats.get("bytes_in_use")
                if b is not None:
                    _obs.record_hbm_sample(info.index, b)
            try:
                # host CPU is best-effort: an unreadable /proc/stat
                # (non-Linux) must not starve the device listener
                cpu = get_host_cpu_times()
                if self.last_host_cpu is not None:
                    busy = (cpu["user"] + cpu["system"]
                            - self.last_host_cpu["user"]
                            - self.last_host_cpu["system"])
                    total = busy + (cpu["idle"] + cpu["iowait"]
                                    - self.last_host_cpu["idle"]
                                    - self.last_host_cpu["iowait"])
                    if total > 0:
                        self.last_cpu_utilization = busy / total
                self.last_host_cpu = cpu
            except Exception as e:
                self._report(e)
            self.sample_count += 1
            # liveness stamp + telemetry-plane drive (windowed ticks /
            # SLO burn evaluation run at window granularity off THIS
            # thread; two attribute reads when the plane is off)
            _obs.record_monitor_sample()
            try:
                self.listener(infos)
            except Exception as e:
                self._report(e)
            time.sleep(self.period)
