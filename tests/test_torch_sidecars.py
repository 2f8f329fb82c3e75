"""PyTorch port: the op layer's sidecars (``utils/profiler.py``,
``utils/fault_injection.py``, ``utils/tracing.py``) and where they are
wired (the op table in ``ops/__init__``, the JVM door's brackets in
``shim/jni_api``, the retry drivers' attempt start, the adaptor's
alloc/free records, the flight recorder's ``fault_rules.json`` and the
shim's ``profiler_*`` / ``fault_injection_*`` entries), held against
the JAX package's.

The cases mirror ``tests/test_sidecars.py``'s profiler, fault-injection,
op-layer, alloc-capture and shim-bracket cases.  Where both packages
run: one seeded rules file drives both injectors and the same
exceptions must fire at the same calls; one op sequence drives both
profilers and the decoded streams must hold the same record kinds and
names, in order.  Tolerance: exact (times excepted).
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from spark_rapids_tpu.columns import dtypes as JD
from spark_rapids_tpu.columns.column import Column as JColumn
from spark_rapids_tpu.columns.table import Table as JTable
from spark_rapids_tpu.utils import fault_injection as jfi
from spark_rapids_tpu.utils import profiler as jprof
from spark_rapids_tpu_torch import observability as obs
from spark_rapids_tpu_torch.columns import dtypes as PD
from spark_rapids_tpu_torch.columns.column import Column as PColumn
from spark_rapids_tpu_torch.columns.table import Table as PTable
from spark_rapids_tpu_torch.memory import exceptions as exc
from spark_rapids_tpu_torch.utils import fault_injection as fi
from spark_rapids_tpu_torch.utils import profiler as prof
from spark_rapids_tpu_torch.utils import tracing
from torch_planes import isolate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def planes(monkeypatch, tmp_path):
    yield from isolate(monkeypatch, tmp_path)


def rules_file(tmp_path, spec, name="faults.json"):
    path = tmp_path / name
    path.write_text(json.dumps(spec))
    return str(path)


def capture(P, fn, **cfg):
    """The decoded records of package profiler module `P` while `fn`
    runs under a started profiler."""
    blobs = []
    p = P.Profiler.init(lambda b: blobs.append(bytes(b)),
                        P.Config(write_buffer_size=1, **cfg))
    try:
        p.start()
        fn()
        p.stop()
        p.flush()
    finally:
        P.Profiler.shutdown()
    return [r for b in blobs for r in P.iter_records(b)]


def shape(records):
    """(kind, name) of each record, in order; times dropped."""
    return [(r["kind"], r.get("name")) for r in records]


# ------------------------------------------------------------ profiler


def test_profiler_lifecycle_and_records():
    def body():
        with prof.op_range("murmur3_32", rows=100):
            pass
        with prof.op_range("convert_to_rows"):
            pass

    records = capture(prof, body)
    kinds = [r["kind"] for r in records]
    assert kinds[0] == "profiler_start" and kinds[-1] == "profiler_stop"
    ops = [r for r in records if r["kind"] == "op_range"]
    assert [o["name"] for o in ops] == ["murmur3_32", "convert_to_rows"]
    assert ops[0]["rows"] == 100
    assert all(o["dur_ns"] >= 0 for o in ops)


def test_profiler_streams_decode_alike_in_both_packages():
    def body(P):
        def run():
            with P.op_range("murmur3_32", rows=10):
                with P.op_range("xxhash64"):
                    pass
            P.record_alloc("alloc", 1024)
            with P.op_range("convert_to_rows"):
                pass
            P.record_alloc("free", 1024)
        return run

    port = capture(prof, body(prof), alloc_capture=True)
    ref = capture(jprof, body(jprof), alloc_capture=True)
    assert shape(port) == shape(ref)
    assert [sorted(r) for r in port] == [sorted(r) for r in ref]
    # either package's decoder reads the other's stream
    blob = b"".join(
        len(json.dumps(r).encode()).to_bytes(4, "little")
        + json.dumps(r).encode() for r in port)
    assert list(jprof.iter_records(blob)) == port


def test_profiler_double_init_and_idle_ranges():
    blobs = []
    prof.Profiler.init(blobs.append)
    with pytest.raises(RuntimeError):
        prof.Profiler.init(blobs.append)
    # ranges while not started are not recorded
    with prof.op_range("idle_op"):
        pass
    prof.Profiler.get().flush()
    assert not any(r["kind"] == "op_range"
                   for b in blobs for r in prof.iter_records(b))


def test_profiler_reentrant_writer_no_deadlock():
    done = []

    def writer(blob):
        p = prof.Profiler.get()
        if p is not None:
            p.flush()  # re-entrant call
        done.append(blob)

    p = prof.Profiler.init(writer, prof.Config(write_buffer_size=1))
    p.start()
    with prof.op_range("x"):
        pass
    p.stop()
    assert done


def test_profiler_flush_thread_and_device_trace(tmp_path):
    """A flush period starts a flusher that stop() joins; a trace
    directory starts a torch.profiler session whose Chrome trace lands
    there on stop."""
    blobs = []
    p = prof.Profiler.init(blobs.append, prof.Config(
        flush_period_millis=5, device_trace_dir=str(tmp_path / "trace")))
    p.start()
    flusher = p._flusher
    with prof.op_range("traced_op"):
        time.sleep(0.02)
    p.stop()
    assert flusher is not None and not flusher.is_alive()
    names = [r.get("name") for b in blobs for r in prof.iter_records(b)]
    assert "traced_op" in names
    assert any(f.endswith(".json")
               for f in os.listdir(tmp_path / "trace"))


# ----------------------------------------------------- fault injection


def test_fault_injection_rules(tmp_path):
    cfg = rules_file(tmp_path, {
        "seed": 1,
        "faults": [
            {"match": "hash", "repeat": 2, "exception": "CudfException"},
            {"match": "alloc", "probability": 0.0},
        ]})
    inj = fi.FaultInjector(cfg)
    with pytest.raises(exc.CudfException, match="injected fault in hash"):
        inj.maybe_inject("hash")
    with pytest.raises(exc.CudfException):
        inj.maybe_inject("hash")
    inj.maybe_inject("hash")       # repeat exhausted
    inj.maybe_inject("alloc")      # probability 0
    inj.maybe_inject("other_op")   # no matching rule


def test_fault_injection_wildcard_and_oom(tmp_path):
    cfg = rules_file(tmp_path, {"faults": [
        {"match": "*", "exception": "GpuRetryOOM", "repeat": 1}]})
    inj = fi.FaultInjector(cfg)
    with pytest.raises(exc.GpuRetryOOM):
        inj.maybe_inject("anything")
    inj.maybe_inject("anything")


@pytest.mark.parametrize("seed", [0, 7, 42])
def test_seeded_injectors_fire_at_the_same_calls(tmp_path, seed):
    """One seeded rules file, both injectors: probabilistic rules draw
    from random.Random(seed) in both, so the same calls raise the same
    exception types."""
    rng = np.random.default_rng(seed)
    cfg = rules_file(tmp_path, {"seed": seed, "faults": [
        {"match": "murmur3_32", "probability": 0.3, "repeat": 9,
         "exception": "GpuRetryOOM"},
        {"match": "*", "probability": 0.1,
         "exception": "GpuSplitAndRetryOOM"},
        {"match": "convert_to_rows", "probability": 0.5,
         "exception": "CpuRetryOOM"},
        {"match": "xxhash64", "repeat": 2, "exception": "GpuOOM"},
        {"match": "nope", "exception": "NoSuchException"},
    ]})
    names = ["murmur3_32", "xxhash64", "convert_to_rows", "gather",
             "nope"]
    calls = [names[i] for i in rng.integers(0, len(names), 400)]

    def fired(mod):
        inj = mod.FaultInjector(cfg)
        out = []
        for name in calls:
            try:
                inj.maybe_inject(name)
                out.append(None)
            except Exception as e:  # noqa: BLE001 — the outcome is data
                out.append(type(e).__name__)
        return out, inj.active_rules()

    port, ref = fired(fi), fired(jfi)
    assert port == ref
    assert len({x for x in port[0] if x}) >= 4


def test_fault_injection_hot_reload_and_watcher_stops(tmp_path):
    cfg = tmp_path / "faults.json"
    cfg.write_text(json.dumps({"faults": []}))
    inj = fi.install(str(cfg), watch=True, interval_ms=10)
    watcher = inj._watcher
    inj.maybe_inject("op")  # no rules yet
    cfg.write_text(json.dumps({
        "faults": [{"match": "op", "exception": "CudfException"}]}))
    os.utime(cfg, (time.time() + 5, time.time() + 5))
    deadline = time.time() + 5
    injected = False
    while time.time() < deadline:
        try:
            inj.maybe_inject("op")
        except exc.CudfException:
            injected = True
            break
        time.sleep(0.01)
    assert injected, "hot reload never picked up the new rule"
    # deleting the file is the operator's off switch
    cfg.unlink()
    deadline = time.time() + 5
    while inj.active_rules() and time.time() < deadline:
        time.sleep(0.01)
    assert inj.active_rules() == []
    fi.uninstall()
    assert fi.installed() is None
    assert not watcher.is_alive()


def test_global_injector_install_replaces_and_stops_previous(tmp_path):
    fi.uninstall()
    fi.maybe_inject("noop")  # no injector installed: no-op
    assert fi._global is None
    cfg = rules_file(tmp_path, {"faults": []}, "f.json")
    first = fi.install(cfg, watch=True)
    fi.install(cfg, watch=False)
    assert first._watching is False and first._watcher is None
    fi.uninstall()


def test_fault_injector_reads_the_config_env(tmp_path, monkeypatch):
    cfg = rules_file(tmp_path, {"faults": [{"match": "x"}]})
    monkeypatch.setenv(fi.CONFIG_ENV, cfg)
    monkeypatch.setenv(fi.INTERVAL_ENV, "garbled")
    inj = fi.FaultInjector()
    assert inj.config_path == cfg
    assert inj.interval_ms == fi.DEFAULT_INTERVAL_MS
    assert inj.active_rules() == jfi.FaultInjector(cfg).active_rules()


# ------------------------------------------------------------ op layer


def port_ints():
    return PTable([PColumn.from_pylist([1, 2, 3], PD.INT32, "cpu")])


def jax_ints():
    return JTable([JColumn.from_pylist([1, 2, 3], JD.INT32)])


def test_op_layer_injection_and_ranges(tmp_path):
    from spark_rapids_tpu_torch import ops
    cfg = rules_file(tmp_path, {"seed": 1, "faults": [
        {"match": "murmur3_32", "repeat": 1,
         "exception": "CudfException"}]})
    fi.install(cfg)
    with pytest.raises(exc.CudfException,
                       match="injected fault in murmur3_32"):
        ops.murmur3_32(port_ints(), 42)
    out = ops.murmur3_32(port_ints(), 42)   # repeat exhausted
    assert out.length == 3
    fi.uninstall()
    names = [r["name"] for r in capture(
        prof, lambda: ops.murmur3_32(port_ints(), 42))
        if r["kind"] == "op_range"]
    assert names == ["murmur3_32"]


def test_op_sequences_record_alike_in_both_packages(tmp_path):
    """The same op calls under a seeded probabilistic rule: the same
    calls fail, and the profiler streams hold the same op ranges."""
    from spark_rapids_tpu import ops as jops
    from spark_rapids_tpu_torch import ops as pops
    cfg = rules_file(tmp_path, {"seed": 3, "faults": [
        {"match": "*", "probability": 0.4, "exception": "GpuRetryOOM"}]})
    seq = ["murmur3_32", "xxhash64", "hive_hash", "murmur3_32",
           "xxhash64", "hive_hash", "murmur3_32", "xxhash64"]

    def run(o, table, out):
        def go():
            for name in seq:
                args = (table(),) if name == "hive_hash" else (table(), 42)
                try:
                    getattr(o, name)(*args)
                    out.append(None)
                except Exception as e:  # noqa: BLE001 — data
                    out.append(type(e).__name__)
        return go

    port_out, ref_out = [], []
    fi.install(cfg, watch=False)
    port = capture(prof, run(pops, port_ints, port_out))
    fi.uninstall()
    jfi.install(cfg, watch=False)
    ref = capture(jprof, run(jops, jax_ints, ref_out))
    jfi.uninstall()
    assert port_out == ref_out and None in port_out and \
        "GpuRetryOOM" in port_out
    assert [x for x in shape(port) if x[0] == "op_range"] == \
        [x for x in shape(ref) if x[0] == "op_range"]


def test_recursive_call_from_another_frame_brackets_twice():
    """The double-bracket skip is keyed by frame: a traced op called
    from inside its own bracket, but from a different frame, records
    again (both packages)."""
    def names(P, T):
        @T.traced(name="rec_op")
        def rec(n):
            return rec(n - 1) if n else 0

        return [r["name"] for r in capture(P, lambda: rec(2))
                if r["kind"] == "op_range"]

    from spark_rapids_tpu.utils import tracing as jtracing
    assert names(prof, tracing) == names(jprof, jtracing) == \
        ["rec_op"] * 3


def test_sidecars_off_calls_the_op_directly(monkeypatch):
    """With every sidecar off the traced wrapper opens no bracket; any
    one switch on brings the bracket (and record_op) back."""
    seen = []
    monkeypatch.setattr(obs, "record_op",
                        lambda name, dur: seen.append(name))
    probe = tracing.traced(lambda: prof.active_op_names(), name="probe")
    assert tracing.sidecars_off()
    assert probe() == set() and seen == []
    obs.enable()
    try:
        assert not tracing.sidecars_off()
        assert probe() == {"probe"} and seen == ["probe"]
    finally:
        obs.disable()
    obs.set_heartbeat_hook(lambda op: None)
    try:
        assert probe() == {"probe"}
    finally:
        obs.set_heartbeat_hook(None)
    assert tracing.sidecars_off()


def test_an_nvtx_tool_opens_the_bracket(monkeypatch):
    """An NVTX tool (Nsight Systems sets ``NVTX_INJECTION64_PATH`` in
    the process it launches) sees the op ranges: with it attached the
    wrapper opens the bracket though every in-process sidecar is off."""
    probe = tracing.traced(lambda: prof.active_op_names(), name="probe")
    assert tracing.sidecars_off() and probe() == set()
    monkeypatch.setattr(prof, "NVTX_TOOL", True)
    assert not tracing.sidecars_off() and probe() == {"probe"}
    code = ("from spark_rapids_tpu_torch.utils import profiler as p; "
            "print(p.NVTX_TOOL)")
    env = dict(os.environ, NVTX_INJECTION64_PATH="libtool.so")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "True"


def test_op_close_beats_the_lifeguard_heartbeat():
    beats = []
    obs.set_heartbeat_hook(beats.append)
    try:
        from spark_rapids_tpu_torch import ops
        ops.xxhash64(port_ints())
    finally:
        obs.set_heartbeat_hook(None)
    assert beats == ["xxhash64"]


def test_op_table_matches_the_reference():
    """The port instruments the JAX package's op names, module by
    module, and re-exports the wrapped bindings."""
    import importlib

    import spark_rapids_tpu.ops as J
    import spark_rapids_tpu_torch.ops as P
    port = {m.replace("spark_rapids_tpu_torch.", ""): n
            for m, n in P._TRACED.items()}
    ref = {m.replace("spark_rapids_tpu.", ""): n
           for m, n in J._TRACED.items()}
    assert port == ref
    for m, names in P._TRACED.items():
        mod = importlib.import_module(m)
        for n in names:
            assert getattr(getattr(mod, n), "__srt_traced__", False), n
            if hasattr(P, n) and callable(getattr(P, n)):
                assert getattr(P, n) is getattr(mod, n)


def test_flagship_step_holds_one_range_per_op():
    from spark_rapids_tpu_torch.models import flagship as F
    a, b, c = F.example_inputs(64, device="cpu")
    names = [r["name"] for r in capture(prof,
                                        lambda: F.flagship_step(a, b, c))
             if r["kind"] == "op_range"]
    assert names == ["murmur3_32", "xxhash64", "convert_to_rows"]


# ------------------------------------------------------- alloc capture


def test_alloc_capture_via_adaptor():
    """alloc/free records flow when enabled, none when disabled, in
    both packages."""
    from spark_rapids_tpu.memory import resource as JR
    from spark_rapids_tpu.memory import spark_resource_adaptor as JSRA
    from spark_rapids_tpu_torch.memory import resource as PR
    from spark_rapids_tpu_torch.memory import spark_resource_adaptor as PSRA

    def kinds(P, R, SRA, capture_on):
        def go():
            a = SRA.SparkResourceAdaptor(R.LimitingMemoryResource(10000))
            a.start_dedicated_task_thread(1, 100)
            a.allocate(64)
            a.deallocate(64)
            a.task_done(100)
        return [(r["kind"], r["bytes"]) for r in capture(
            P, go, alloc_capture=capture_on)
            if r["kind"] in ("alloc", "free")]

    for on, want in ((True, [("alloc", 64), ("free", 64)]), (False, [])):
        assert kinds(prof, PR, PSRA, on) == kinds(jprof, JR, JSRA, on) \
            == want


# ------------------------------------------------------------ JVM door


def test_shim_op_bracket_fires_once(tmp_path):
    """The door's bracket plus the op layer's traced wrapper inject and
    record exactly ONCE per call, as in the JAX package."""
    from spark_rapids_tpu.shim import jni_api as japi
    from spark_rapids_tpu_torch.shim import jni_api
    cfg = rules_file(tmp_path, {"seed": 1, "faults": [
        {"match": "murmur3_32", "repeat": 1,
         "exception": "CudfException"}]})

    def run(api, inj, P, h):
        inj.install(cfg)
        try:
            with pytest.raises(Exception) as ei:
                api.murmur_hash3_32(42, [h])
            out = api.murmur_hash3_32(42, [h])
            assert out > 0
        finally:
            inj.uninstall()
        names = [r["name"] for r in capture(
            P, lambda: api.murmur_hash3_32(42, [h]))
            if r["kind"] == "op_range"]
        return type(ei.value).__name__, names

    ph = jni_api.make_column_from_host([1, 2, 3], PD.INT32, device="cpu")
    jh = japi.make_column_from_host([1, 2, 3], JD.INT32)
    assert run(jni_api, fi, prof, ph) == run(japi, jfi, jprof, jh) == \
        ("CudfException", ["murmur3_32"])


@pytest.mark.parametrize("export,op", [
    ("xx_hash_64", "xxhash64"), ("hive_hash", "hive_hash"),
    ("convert_to_rows", "convert_to_rows")])
def test_door_exports_raise_the_typed_exception(tmp_path, export, op):
    from spark_rapids_tpu_torch.shim import jni_api
    cfg = rules_file(tmp_path, {"faults": [
        {"match": op, "repeat": 1, "exception": "CudfException"}]})
    h = jni_api.make_column_from_host([1, 2, 3], PD.INT32, device="cpu")
    args = {"xx_hash_64": (42, [h]), "hive_hash": ([h],),
            "convert_to_rows": ([h],)}[export]
    fi.install(cfg)
    with pytest.raises(exc.CudfException, match=f"injected fault in {op}"):
        getattr(jni_api, export)(*args)
    assert getattr(jni_api, export)(*args) > 0
    fi.uninstall()


def test_shim_entries_match_the_reference(tmp_path):
    from spark_rapids_tpu.shim import jni_entry as JE
    from spark_rapids_tpu_torch.shim import jni_entry as PE
    cfg = rules_file(tmp_path, {"seed": 5, "faults": [
        {"match": "a", "probability": 0.5, "repeat": 3,
         "exception": "GpuOOM"}, {"match": "*"}]})
    got = []
    for e in (PE, JE):
        assert e.fault_injection_config_path() == ""
        assert e.fault_injection_rules_json() == "[]"
        got.append((e.fault_injection_install(cfg, False, 0),
                    e.fault_injection_config_path(),
                    e.fault_injection_rules_json()))
        e.fault_injection_uninstall()
    assert got[0] == got[1] and got[0][0] == 2
    # the profiler's file sink: one process's stream, decodable by
    # either package
    for e, P in ((PE, prof), (JE, jprof)):
        path = str(tmp_path / f"{P.__name__}.bin")
        e.profiler_init(path, 0, True)
        with pytest.raises(RuntimeError):
            e.profiler_init(path, 0, True)
        e.profiler_start()
        with P.op_range("sink_op"):
            P.record_alloc("alloc", 8)
        e.profiler_stop()
        e.profiler_shutdown()
        with open(path, "rb") as f:
            blob = f.read()
        assert shape(prof.iter_records(blob)) == \
            shape(jprof.iter_records(blob)) == [
                ("profiler_start", None), ("alloc", None),
                ("op_range", "sink_op"), ("profiler_stop", None)]


# ------------------------------------------------- retry and bundles


def test_retry_attempt_start_runs_the_rules_and_bundle_names_them(
        tmp_path):
    """A rule on a retried section fires at every attempt start: the
    episode exhausts, and the retry_exhausted bundle's fault_rules.json
    holds the live rule, as the JAX package's does."""
    from spark_rapids_tpu import observability as jobs
    from spark_rapids_tpu.robustness import retry as JRT
    from spark_rapids_tpu_torch.robustness import retry as PRT
    cfg = rules_file(tmp_path, {"seed": 2, "faults": [
        {"match": "section_x", "exception": "GpuRetryOOM"}]})

    def run(o, RT, inj, out):
        o.enable_flight_recorder(out_dir=str(tmp_path / out),
                                 min_interval_s=0.0)
        inj.install(cfg, watch=False)
        calls = []
        try:
            with pytest.raises(RT.RetryExhausted) as ei:
                RT.with_retry(lambda: calls.append(1), name="section_x",
                              policy=RT.RetryPolicy(
                                  max_attempts=3, base_backoff_s=0.0,
                                  jitter=False))
        finally:
            inj.uninstall()
            o.disable_flight_recorder()
        bundles = sorted(n for n in os.listdir(tmp_path / out)
                         if n.startswith("incident-"))
        with open(tmp_path / out / bundles[-1] / "fault_rules.json") as f:
            rules = json.load(f)
        with open(tmp_path / out / bundles[-1] / "trigger.json") as f:
            kind = json.load(f)["kind"]
        return calls, ei.value.reason, kind, rules

    port = run(obs, PRT, fi, "port")
    ref = run(jobs, JRT, jfi, "ref")
    assert port == ref
    assert port[0] == [] and port[2] == "retry_exhausted"
    assert port[3] == [{"match": "section_x", "probability": 1.0,
                        "remaining": -1, "exception": "GpuRetryOOM"}]


def test_bundle_without_an_injector_says_no_rules(tmp_path):
    obs.enable_flight_recorder(out_dir=str(tmp_path / "inc"),
                               min_interval_s=0.0)
    try:
        path = obs.trigger_incident("manual")
    finally:
        obs.disable_flight_recorder()
    with open(os.path.join(path, "fault_rules.json")) as f:
        assert json.load(f) == []


# ------------------------------------------------------ import hygiene


def test_new_modules_import_without_jax():
    mods = ["spark_rapids_tpu_torch.utils.profiler",
            "spark_rapids_tpu_torch.utils.fault_injection",
            "spark_rapids_tpu_torch.utils.tracing",
            "spark_rapids_tpu_torch.tools"] + [
        f"spark_rapids_tpu_torch.tools.{m}" for m in (
            "bench_trend", "doctor", "metrics_report", "profile_converter",
            "srt_check", "srt_explain", "srt_top", "trace_export")]
    code = ("import sys, importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "assert 'jax' not in sys.modules\n"
            "assert not [m for m in sys.modules\n"
            "            if m.split('.')[0] == 'spark_rapids_tpu']\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   env=dict(os.environ, PYTHONPATH=REPO))


def test_timeseries_pair_is_cut_from_one_registry_fold():
    """tick_with_registry returns the registry fold its window was cut
    from: a count landing after the tick is in the live registry but in
    neither the window sums nor the returned fold."""
    from spark_rapids_tpu_torch.observability import timeseries as TS
    obs.enable()
    obs.enable_timeseries(window_s=60.0)
    try:
        obs.record_shuffle_link("send", "1", 100)
        obs.TIMESERIES.tick()
        obs.record_shuffle_link("send", "1", 50)
        window, fold = obs.TIMESERIES.tick_with_registry()
        obs.record_shuffle_link("recv", "1", 7)     # a peer's late frame
        fam = "srt_shuffle_link_bytes_total"
        sums = TS.sum_counter_windows(obs.TIMESERIES.windows(), fam)
        folded = {"|".join(s["labels"]): float(s["value"])
                  for s in fold[fam]["series"]}
        live = {"|".join(s["labels"]): float(s["value"])
                for s in obs.METRICS.snapshot()[fam]["series"]}
        assert sums == folded == {"send|1": 150.0}
        assert live == {"send|1": 150.0, "recv|1": 7.0}
        assert window["counters"][fam] == {"send|1": 50}
    finally:
        obs.disable_timeseries()
        obs.disable()


def test_watcher_thread_is_named_and_daemon(tmp_path):
    cfg = rules_file(tmp_path, {"faults": []})
    inj = fi.install(cfg, watch=True, interval_ms=5)
    names = [t.name for t in threading.enumerate() if t.daemon]
    fi.uninstall()
    assert "srt-faultinj-watch" in names and not inj._watching
