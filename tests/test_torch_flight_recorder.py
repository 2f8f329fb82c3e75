"""PyTorch port: the flight recorder (``observability/flight_recorder.py``),
its anomaly detectors (``observability/anomaly.py``) and their feeds in
``observability/__init__`` (spans, retry episodes, HBM samples, task
leaks, ``trigger_incident``, ``health()``), held against the JAX
package's.

The same trigger sequences go through a JAX recorder and a port
recorder under the same fake clocks; the bundles they write have equal
directory names, equal file lists, equal manifest keys and equal
``trigger.json``, and the same triggers are suppressed for the same
reason.  Left out of the comparison: the pid, the measured times and
the environment fingerprint (``env.json`` names torch and CUDA in the
port, JAX in the reference), and the contents of the ring dumps (each
package's own registry).  Tolerance: exact everywhere else.
"""

import json
import os

import pytest

from spark_rapids_tpu import observability as jobs
from spark_rapids_tpu.observability import anomaly as JA
from spark_rapids_tpu.observability import flight_recorder as JFR
from spark_rapids_tpu_torch import observability as obs
from spark_rapids_tpu_torch.observability import anomaly as A
from spark_rapids_tpu_torch.observability import flight_recorder as FR
from torch_planes import isolate


@pytest.fixture(autouse=True)
def planes(monkeypatch, tmp_path):
    yield from isolate(monkeypatch, tmp_path)


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt
        return self.t


def both(fn):
    return fn(A, FR), fn(JA, JFR)


def _detectors(an, _fr):
    clock = FakeClock()
    out = []
    st = an.StragglerDetector(threshold=6.0, min_samples=8,
                              cooldown_s=10.0, clock=clock)
    for i in range(12):
        out.append(st.observe("stage.a", 1_000_000 + 1000 * (i % 3),
                              task=i))
    out.append(st.observe("stage.a", 90_000_000, task=99))
    out.append(st.observe("stage.a", 95_000_000, task=98))   # cooldown
    clock.advance(11.0)
    out.append(st.observe("stage.a", 99_000_000, task=97))
    rs = an.RetryStormDetector(threshold=3, window_s=5.0, clock=clock)
    for i in range(5):
        out.append(rs.observe(f"s{i % 2}"))
        clock.advance(1.0 if i < 3 else 6.0)
    hb = an.HbmPressureDetector(threshold_bytes=1000, sustain_s=2.0,
                                clock=clock)
    for b in (500, 1500, 1600, 1700, 200, 1800):
        out.append(hb.observe("cuda:0", b))
        clock.advance(1.5)
    out.append(an.HbmPressureDetector(clock=clock).observe("x", 1 << 40))
    lk = an.LeakDetector(min_bytes=1024)
    out.append(lk.observe(7, 512))
    out.append(lk.observe(7, 4096, holders=[{"thread": 3,
                                             "bytes": 4096}]))
    out.append(an.robust_z(10.0, [1.0, 2.0, 3.0, 2.0]))
    return out


def test_detectors_match_reference():
    port, ref = both(_detectors)
    assert port == ref
    assert port[12] is not None and port[13] is None


def _bundle_view(path):
    """What of a bundle is compared: its file list, manifest keys and
    trigger record."""
    names = sorted(os.listdir(path))
    with open(os.path.join(path, "MANIFEST.json")) as f:
        manifest = json.load(f)
    with open(os.path.join(path, "trigger.json")) as f:
        trig = json.load(f)
    assert trig.pop("t_mono_ns") > 0
    return (os.path.basename(path), names, sorted(manifest),
            sorted(manifest["files"]), trig)


def _writer(_an, fr, base):
    clock, wall = FakeClock(), FakeClock(1_754_200_000.0)
    rec = fr.FlightRecorder(enabled=True, out_dir=str(base / "inc"),
                            max_bytes=8 << 20, min_interval_s=30.0,
                            clock=clock, wallclock=wall)
    paths = [rec.trigger("unit_test", cause=ValueError("boom"),
                         note="x")]
    paths.append(rec.trigger("unit_test"))            # rate limited
    clock.advance(31.0)
    wall.advance(31.0)
    paths.append(rec.trigger("retry_storm", severity="warn"))
    clock.advance(0.001)
    paths.append(rec.trigger("retry_exhausted", severity="error",
                             cause=RuntimeError("x")))
    paths.append(rec.trigger("straggler", severity="warn"))
    paths.append(rec.trigger("manual", force=True, reason="r"))
    rec.enabled = False
    paths.append(rec.trigger("quiet"))
    views = [None if p is None else _bundle_view(p) for p in paths]
    st = rec.stats()
    small = fr.FlightRecorder(enabled=True, out_dir=str(base / "tiny"),
                              max_bytes=512, clock=clock, wallclock=wall)
    tiny = small.trigger("big")
    return (views, st["suppressed"], st["bundles_written"],
            [(os.path.basename(i["path"]), i["kind"], i["severity"])
             for i in rec.incident_list()],
            tiny, small.stats()["suppressed"])


def test_bundle_writer_matches_reference(tmp_path):
    port = _writer(A, FR, tmp_path / "port")
    ref = _writer(JA, JFR, tmp_path / "ref")
    assert port == ref
    views, suppressed, written, listing, tiny, tiny_sup = port
    assert views[1] is None and views[4] is None and views[6] is None
    assert views[0][1] == sorted(
        ["MANIFEST.json", "trigger.json", "metrics.json",
         "journal.jsonl", "spans.jsonl", "memory_ledger.json",
         "threads.json", "jit_cache.json", "fault_rules.json",
         "env.json"])
    assert views[0][4]["cause_chain"] == [{"type": "ValueError",
                                           "message": "boom"}]
    assert suppressed == {"rate_limit": 2} and written == 4
    assert [k for _n, k, _s in listing] == [
        "unit_test", "retry_storm", "retry_exhausted", "manual"]
    assert tiny is None and tiny_sup == {"byte_budget": 1}


def test_env_fingerprint_names_torch_not_jax(monkeypatch):
    import torch
    monkeypatch.setenv("TORCH_SHOW_CPP_STACKTRACES", "1")
    monkeypatch.setenv("CUDA_LAUNCH_BLOCKING", "0")
    monkeypatch.setenv("XLA_FLAGS", "--x")
    fp = FR.FlightRecorder._env_fingerprint()
    assert fp["torch"] == torch.__version__
    assert fp["cuda"] == torch.version.cuda
    assert "jax" not in fp
    assert {"TORCH_SHOW_CPP_STACKTRACES", "CUDA_LAUNCH_BLOCKING"} <= \
        set(fp["env"])
    assert "XLA_FLAGS" not in fp["env"]


def test_bundle_carries_profile_attribution_and_jit_cache(tmp_path):
    from spark_rapids_tpu_torch.perf import jit_cache as JC
    JC.CACHE.get_or_build("k", "d", 8, lambda: (lambda: 0))
    obs.enable_profiling()
    obs.enable_attribution()
    sess = obs.PROFILER.begin("q1", query="q")
    obs.PROFILER.end(sess)
    rec = FR.FlightRecorder(enabled=True, out_dir=str(tmp_path / "b"),
                            min_interval_s=0.0)
    path = rec.trigger("manual")
    names = os.listdir(path)
    assert "profile.json" in names and "attribution.json" in names
    with open(os.path.join(path, "jit_cache.json")) as f:
        assert json.load(f)["misses"] == 1
    with open(os.path.join(path, "fault_rules.json")) as f:
        assert json.load(f) == []


def _feeds(o, base):
    o.enable()
    o.enable_tracing()
    o.enable_flight_recorder(out_dir=str(base / o.__name__),
                             max_bytes=8 << 20, min_interval_s=0.0)
    o.FLIGHT.hbm = (A if o is obs else JA).HbmPressureDetector(
        threshold_bytes=100, sustain_s=0.0)
    for _ in range(12):
        o.TRACER.start_span("t_stage", kind="stage").end()
    slow = o.TRACER.start_span("t_stage", kind="stage")
    slow.t0_ns -= 10_000_000_000
    slow.end()
    for _ in range(11):
        o.record_retry_episode("storm", attempts=2, retries=1,
                               splits=0, max_split_depth=0, lost_ns=5,
                               outcome="success", errors=["GpuRetryOOM"])
    o.record_hbm_sample(0, 500)
    o.record_hbm_sample(0, 600)
    o.record_task_leak(9, 8 << 20, holders=[{"thread": 1,
                                             "bytes": 8 << 20}])
    o.trigger_incident("manual_probe", severity="info", why="test")
    kinds = sorted(i["kind"] for i in o.FLIGHT.incident_list())
    fam = o.METRICS.family_snapshot("srt_incidents_total")
    o.disable_flight_recorder()
    return kinds, fam


def test_feeds_and_trigger_incident_match_reference(tmp_path):
    port, ref = _feeds(obs, tmp_path), _feeds(jobs, tmp_path)
    assert port == ref
    assert port[0] == ["hbm_pressure", "manual_probe", "memory_leak",
                       "retry_storm", "straggler"]
    assert sum(s["value"] for s in port[1]["series"]) == 5


def test_disarmed_recorder_writes_nothing(tmp_path):
    assert obs.trigger_incident("x") is None
    obs.record_task_leak(1, 1 << 30)
    assert obs.FLIGHT.incident_list() == []


def test_health_matches_reference():
    hs = []
    for o in (obs, jobs):
        o.enable()
        h = o.health()
        for k in ("snapshot_unix_ms", "start_unix_ms", "uptime_s", "pid"):
            assert h.pop(k) > 0
        h["flight_recorder"].pop("dir")
        hs.append(h)
    assert hs[0] == hs[1]


def test_shim_incident_entries_match_reference(tmp_path):
    from spark_rapids_tpu.shim import jni_entry as JE
    from spark_rapids_tpu_torch.shim import jni_api, jni_entry
    got = []
    for e, name in ((jni_entry, "port"), (JE, "ref")):
        assert e.flight_recorder_set_enabled(True) is False
        assert e.flight_recorder_enabled() is True
        e.flight_recorder_configure(str(tmp_path / name), 1 << 20, 0.0)
        path = e.incident_dump("probe")
        listing = json.loads(e.incident_list())
        health = json.loads(e.health_json())
        assert e.flight_recorder_set_enabled(False) is True
        got.append((os.path.basename(path).split("-")[2:],
                    [i["kind"] for i in listing],
                    sorted(health), health["flight_recorder"][
                        "bundles_written"]))
    assert got[0] == got[1]
    assert got[0][:2] == (["manual", "001"], ["manual"])
    assert got[0][3] == 1
    assert jni_api.incident_list() == jni_entry.incident_list()
