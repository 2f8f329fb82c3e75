"""Test isolation for the process-wide observability planes and caches
of both packages (the JAX package and its PyTorch port).

Each package keeps singletons that outlive a test in one pytest worker:
the flight recorder, the query profiler with its attribution switch,
the data-statistics collector and its store file, the timeseries
sampler, the SLO monitor, the result cache with its ingest epochs, the
compile cache, the calibration verdicts and the Monitor's liveness
stamp; and the query server's: the server singleton with its socket
door, the lifeguard's heartbeat table and hook count, and the stage
compiler's plan-verify memo; and the op layer's sidecars: the installed
fault injector (with its watcher thread), the in-process profiler and
``FAULT_INJECTOR_CONFIG_PATH``, which both injectors read.
``isolate(monkeypatch, tmp_path)`` gives a test a clean copy of
all of them in both packages, points every file they write at
``tmp_path``, and puts the switches back afterwards.  Test files use it
as an autouse fixture:

    @pytest.fixture(autouse=True)
    def planes(monkeypatch, tmp_path):
        yield from isolate(monkeypatch, tmp_path)
"""

import threading

from spark_rapids_tpu import observability as jobs
from spark_rapids_tpu.observability import flight_recorder as JFR
from spark_rapids_tpu.perf import calibrate as JCAL
from spark_rapids_tpu.perf import jit_cache as JJC
from spark_rapids_tpu.perf import result_cache as JRC
from spark_rapids_tpu_torch import observability as obs
from spark_rapids_tpu_torch.observability import flight_recorder as FR
from spark_rapids_tpu_torch.perf import calibrate as CAL
from spark_rapids_tpu_torch.perf import jit_cache as JC
from spark_rapids_tpu_torch.perf import result_cache as RC

# (observability module, flight_recorder module, jit_cache, result_cache,
#  calibrate) of each package
PACKAGES = ((jobs, JFR, JJC, JRC, JCAL), (obs, FR, JC, RC, CAL))


def stop_stray_monitors():
    """Stop every telemetry Monitor thread an earlier test left running:
    its next sample would stamp ``_LAST_MONITOR_SAMPLE`` and drive the
    timeseries and SLO planes in the middle of a comparison."""
    from spark_rapids_tpu.utils import telemetry as JT
    from spark_rapids_tpu_torch.utils import telemetry as PT
    for t in threading.enumerate():
        owner = getattr(getattr(t, "_target", None), "__self__", None)
        if isinstance(owner, (JT.Monitor, PT.Monitor)):
            owner.stop()


def stop_stray_servers():
    """Stop every query server, socket door and watchdog an earlier test
    left running (in either package), stop both singletons, and reset
    the lifeguard's heartbeat table and hook count and the compiler's
    plan-verify memo.  The port's compiled-stage memo goes with its
    verify memo: each stage in it was verified when it was compiled, and
    the server phase checks that every stage in the memo is in the
    verify memo, so clearing one alone breaks that check for stages an
    earlier test compiled."""
    from spark_rapids_tpu import server as jsrv
    from spark_rapids_tpu.plan import compiler as JPC
    from spark_rapids_tpu.robustness import lifeguard as JLG
    from spark_rapids_tpu_torch import server as psrv
    from spark_rapids_tpu_torch.plan import compiler as PPC
    from spark_rapids_tpu_torch.robustness import lifeguard as PLG
    for srv in (jsrv, psrv):
        srv.stop_server(timeout_s=5)
    kinds = (jsrv.QueryServer, psrv.QueryServer, jsrv.SocketFrontDoor,
             psrv.SocketFrontDoor, JLG.Watchdog, PLG.Watchdog)
    seen = set()
    for t in threading.enumerate():
        owner = getattr(getattr(t, "_target", None), "__self__", None)
        if isinstance(owner, kinds) and id(owner) not in seen:
            seen.add(id(owner))
            if isinstance(owner, (jsrv.QueryServer, psrv.QueryServer)):
                if owner._started:
                    owner.stop(timeout_s=5)
            else:
                owner.stop()
    for lg in (JLG, PLG):
        while lg._HOOK_INSTALLS > 0:
            lg.release_heartbeat_hook()
        with lg._BEATS_LOCK:
            lg._BEATS.clear()
    for pc in (JPC, PPC):
        pc._VERIFIED.clear()
    PPC._STAGE_MEMO.clear()


def stop_sidecars():
    """Uninstall both packages' fault injectors (stopping their watcher
    threads) and shut both in-process profilers down."""
    from spark_rapids_tpu.utils import fault_injection as JFI
    from spark_rapids_tpu.utils import profiler as JPROF
    from spark_rapids_tpu_torch.utils import fault_injection as PFI
    from spark_rapids_tpu_torch.utils import profiler as PPROF
    for fi in (JFI, PFI):
        fi.uninstall()
    for prof in (JPROF, PPROF):
        prof.Profiler.shutdown()


def _clear(o, jc, rc, cal):
    o.reset()
    jc.CACHE.clear(reset_stats=True)
    rc.CACHE.clear(reset_stats=True)
    rc.reset_ingest_epochs()
    cal.forget()


def isolate(monkeypatch, tmp_path):
    stop_stray_monitors()
    stop_stray_servers()
    stop_sidecars()
    monkeypatch.delenv("FAULT_INJECTOR_CONFIG_PATH", raising=False)
    monkeypatch.setenv("SPARK_RAPIDS_TPU_STATS_STORE",
                       str(tmp_path / "stats_store.json"))
    monkeypatch.setenv("SPARK_RAPIDS_TPU_CALIB_CACHE",
                       str(tmp_path / "calib.json"))
    monkeypatch.setenv("SPARK_RAPIDS_TPU_FLIGHT_RECORDER_DIR",
                       str(tmp_path / "incidents"))
    for var in ("SPARK_RAPIDS_TPU_RESULT_CACHE",
                "SPARK_RAPIDS_TPU_JIT_CACHE",
                "SPARK_RAPIDS_TPU_STAGE_FUSION"):
        monkeypatch.delenv(var, raising=False)
    for o, fr, jc, rc, cal in PACKAGES:
        monkeypatch.setattr(o, "FLIGHT", fr.FlightRecorder(
            out_dir=str(tmp_path / "incidents" / o.__name__)))
        monkeypatch.setattr(o, "_LAST_MONITOR_SAMPLE", None)
        monkeypatch.setattr(o, "_LAST_ATTRIBUTION", None)
        monkeypatch.setattr(o.METRICS, "enabled", o.METRICS.enabled)
        monkeypatch.setattr(o._SWITCH, "enabled", o._SWITCH.enabled)
        for plane in (o.TRACER, o.PROFILER, o.ATTRIBUTION, o.TIMESERIES,
                      o.SLO, o.STATS):
            monkeypatch.setattr(plane, "enabled", False)
        for attr in ("window_s", "capacity", "_windows"):
            monkeypatch.setattr(o.TIMESERIES, attr,
                                getattr(o.TIMESERIES, attr))
        o.disable()
        _clear(o, jc, rc, cal)
    yield
    stop_stray_monitors()
    stop_stray_servers()
    stop_sidecars()
    for o, _fr, jc, rc, cal in PACKAGES:
        _clear(o, jc, rc, cal)
