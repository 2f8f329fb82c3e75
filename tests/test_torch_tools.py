"""PyTorch port: the offline tools (``spark_rapids_tpu_torch/tools/``)
held against the JAX package's.

Each tool of each package runs on one set of files, in process through
its ``main(argv)``; the exit codes and everything written (stdout, and
any output file) must be byte-equal.  The files come from two places:

  * a live workload run through each package (metrics, tracing, the
    query profiler with attribution, the timeseries plane, the flight
    recorder, the op-layer profiler and an injected fault exhausting a
    retried section), so each tool also reads the other package's
    journal, span, profile, timeseries and profiler dumps and its
    incident bundles;
  * the reference suites' fixtures: ``tests/data`` (the mini bundle and
    the goldens), ``test_query_profile.GOLDEN_PROFILE`` and
    ``_rank_profile``, ``test_attribution``'s synthetic profiles and
    two-rank trace, ``test_timeseries_slo.snap_for`` and
    ``test_bench_trend``'s round files.

Tolerance: exact.
"""

import contextlib
import copy
import importlib
import io
import json
import os
import threading

import pytest

from test_attribution import synth_profile, two_rank_trace
from test_query_profile import GOLDEN_PROFILE, _rank_profile
from test_timeseries_slo import snap_for
from test_tracing_spans import _golden_span_records
from torch_planes import isolate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
MINI_BUNDLE = os.path.join(DATA, "mini_bundle",
                           "incident-1754200000000-retry_exhausted-001")
PACKAGES = ("spark_rapids_tpu_torch", "spark_rapids_tpu")
SOURCES = ("port", "jax")


@pytest.fixture(autouse=True)
def planes(monkeypatch, tmp_path):
    yield from isolate(monkeypatch, tmp_path)


def run_tool(pkg, tool, argv):
    """(exit code, stdout) of ``<pkg>.tools.<tool>.main(argv)``."""
    mod = importlib.import_module(f"{pkg}.tools.{tool}")
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = mod.main(list(argv))
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue()


def both(tool, argv, out_file=None):
    """Run the port's tool and the JAX tool on the same argv; their
    exit codes, stdout and ``out_file`` bytes must be equal.  Returns
    the port's (rc, stdout, out_file bytes)."""
    got = []
    for pkg in PACKAGES:
        if out_file is not None and os.path.exists(out_file):
            os.remove(out_file)
        rc, text = run_tool(pkg, tool, argv)
        blob = None
        if out_file is not None:
            with open(out_file, "rb") as f:
                blob = f.read()
        got.append((rc, text, blob))
    assert got[0] == got[1], (tool, argv)
    return got[0]


# --------------------------------------------------------- the workload


def _namespace(pkg):
    mods = {
        "obs": "observability", "models": "models",
        "retry": "robustness.retry", "fi": "utils.fault_injection",
        "prof": "utils.profiler", "entry": "shim.jni_entry",
        "server": "server", "ops": "ops", "rc": "ops.row_conversion",
        "dtypes": "columns.dtypes",
        "column": "columns.column", "table": "columns.table",
        "rmm": "memory.rmm_spark"}
    return {k: importlib.import_module(f"{pkg}.{m}")
            for k, m in mods.items()}


def workload(pkg, out):
    """Drive one package with every plane on and dump what its tools
    read: journal.jsonl, spans.jsonl, profile.json,
    timeseries_rank0.json, prof.bin and the incidents/ bundles."""
    P = _namespace(pkg)
    o = P["obs"]
    os.makedirs(out, exist_ok=True)
    device = {"device": "cpu"} if pkg.endswith("_torch") else {}
    o.enable()
    o.enable_tracing()
    o.enable_profiling()
    o.enable_attribution()
    o.enable_timeseries(window_s=60.0)
    o.enable_slo()
    o.enable_flight_recorder(out_dir=os.path.join(out, "incidents"),
                             min_interval_s=0.0)
    P["entry"].profiler_init(os.path.join(out, "prof.bin"), 0, True)
    P["entry"].profiler_start()
    adaptor = P["rmm"].set_event_handler(1 << 30)
    rules = os.path.join(out, "faults.json")
    with open(rules, "w") as f:
        json.dump({"seed": 4, "faults": [
            {"match": "convert_to_rows", "exception": "GpuRetryOOM"}]}, f)
    try:
        P["rmm"].current_thread_is_dedicated_to_task(41)
        adaptor.allocate(3 << 20)
        col = P["column"].Column.from_pylist(
            list(range(-50, 50)), P["dtypes"].INT64, **device)
        table = P["table"].Table([col])
        o.TIMESERIES.tick()
        with o.TRACER.span("tools_q9", kind="query"):
            sess = o.PROFILER.begin("tools-q9", tenant="acme",
                                    query="tpcds_q9")
            try:
                P["models"].run_catalog_query(
                    "tpcds_q9", dict(rows=1 << 10, **device))
                P["ops"].murmur3_32(table, 42)
                P["ops"].xxhash64(table)
                P["rc"].convert_to_rows(table)
            finally:
                prof = o.PROFILER.end(sess)
        o.SLO.observe("acme", "success", 5_000_000)
        P["fi"].install(rules, watch=False)
        try:
            P["retry"].with_retry(
                lambda: P["rc"].convert_to_rows(table),
                name="tools_section", policy=P["retry"].RetryPolicy(
                    max_attempts=3, base_backoff_s=0.0, jitter=False))
        except P["retry"].RetryExhausted:
            pass
        finally:
            P["fi"].uninstall()
        adaptor.deallocate(3 << 20)
        server_traffic(P["server"])
        o.TIMESERIES.tick()
        snap = o.timeseries_snapshot(rank=0, epoch=0)
        with open(os.path.join(out, "timeseries_rank0.json"), "w") as f:
            f.write(json.dumps(snap, sort_keys=True))
        with open(os.path.join(out, "profile.json"), "w") as f:
            json.dump(prof, f, sort_keys=True, default=str)
        o.dump_journal_jsonl(os.path.join(out, "journal.jsonl"))
        o.TRACER.dump_jsonl(os.path.join(out, "spans.jsonl"))
    finally:
        P["entry"].profiler_stop()
        P["entry"].profiler_shutdown()
        P["rmm"].remove_current_thread_association()
        P["rmm"].clear_event_handler()
        P["fi"].uninstall()
        for off in (o.disable_profiling, o.disable_attribution,
                    o.disable_timeseries, o.disable_slo,
                    o.disable_flight_recorder, o.disable_tracing,
                    o.disable):
            off()
        o.reset()
    return out


def server_traffic(S):
    """A few server requests: one success, one queued behind a gated
    one, one refused by the full queue."""
    gate, started = threading.Event(), []

    def runner(query, params, ctx):
        if query == "q_ok":
            return [1]
        started.append(query)
        gate.wait(20)
        return [2]

    s = S.QueryServer(S.ServerConfig(max_concurrency=1, max_queue=1,
                                     stall_ms=0), runner=runner).start()
    try:
        assert s.poll(s.submit("acme", "q_ok"), timeout_s=20)["state"] \
            == "done"
        s.submit("acme", "blocker")
        for _ in range(2000):
            if started:
                break
            threading.Event().wait(0.005)
        s.submit("acme", "queued")
        with pytest.raises(S.ServerOverloaded):
            s.submit("acme", "flood")
    finally:
        gate.set()
        s.stop()


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    """Each package's workload dumps, made once for the module with the
    stage engine pinned op by op and the calibration and statistics
    files kept under the fixture's directory."""
    root = tmp_path_factory.mktemp("tool_dumps")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SPARK_RAPIDS_TPU_STAGE_FUSION", "0")
        mp.setenv("SPARK_RAPIDS_TPU_CALIB_CACHE", str(root / "calib.json"))
        mp.setenv("SPARK_RAPIDS_TPU_STATS_STORE", str(root / "stats.json"))
        mp.delenv("FAULT_INJECTOR_CONFIG_PATH", raising=False)
        return {"port": workload(PACKAGES[0], str(root / "port")),
                "jax": workload(PACKAGES[1], str(root / "jax"))}


def bundles_of(path):
    return sorted(os.path.join(path, "incidents", n)
                  for n in os.listdir(os.path.join(path, "incidents"))
                  if n.startswith("incident-"))


# ------------------------------------------------------------- doctor


@pytest.mark.parametrize("src", SOURCES)
def test_doctor_on_workload_bundles(dumps, src):
    bundles = bundles_of(dumps[src])
    assert len(bundles) == 1
    rc, text, _ = both("doctor", [bundles[0], "--json"])
    report = json.loads(text)
    assert rc == 0
    top = report["findings"][0]
    assert top["kind"] == "fault_injection" and top["severity"] == 95
    assert "match='convert_to_rows'" in top["message"]
    exhausted = [f for f in report["findings"]
                 if f["kind"] == "retry_exhausted"][0]
    assert "task 41" in exhausted["message"] and \
        "3.0 MiB" in exhausted["message"]
    both("doctor", [bundles[0]])
    both("doctor", [os.path.join(dumps[src], "incidents"), "--json"])


def test_doctor_on_the_reference_fixtures(tmp_path):
    rc, text, _ = both("doctor", [MINI_BUNDLE])
    with open(os.path.join(DATA, "doctor_golden.txt")) as f:
        assert rc == 0 and text == f.read()
    rc, text, _ = both("doctor", [os.path.dirname(MINI_BUNDLE), "--json"])
    assert json.loads(text)["findings"][0]["kind"] == "fault_injection"
    assert both("doctor", [str(tmp_path)])[0] == 2


# ----------------------------------------------------- metrics_report


@pytest.mark.parametrize("src", SOURCES)
def test_metrics_report_on_workload_journal(dumps, src):
    journal = os.path.join(dumps[src], "journal.jsonl")
    rc, text, _ = both("metrics_report", [journal, "--json"])
    report = json.loads(text)
    assert rc == 0 and report["has_registry_snapshot"]
    rows = {(r["tenant"], r["query"]): r for r in report["server"]}
    assert rows[("acme", "*")]["rejected"] >= 1
    assert rows[("acme", "q_ok")]["success"] == 1
    both("metrics_report", [journal])
    both("metrics_report", [journal, "--window", "2"])
    both("metrics_report", [bundles_of(dumps[src])[0], "--json"])


def test_metrics_report_on_the_mini_bundle():
    rc, text, _ = both("metrics_report", [MINI_BUNDLE])
    assert rc == 0 and "retry episodes" in text
    both("metrics_report", [MINI_BUNDLE, "--json"])


# ------------------------------------------------------- trace_export


@pytest.mark.parametrize("src", SOURCES)
def test_trace_export_on_workload_spans(dumps, src, tmp_path):
    from spark_rapids_tpu_torch.tools import trace_export
    spans = os.path.join(dumps[src], "spans.jsonl")
    out = str(tmp_path / "trace.json")
    rc, text, blob = both("trace_export", [spans, "-o", out, "--stats"],
                          out_file=out)
    assert rc == 0 and "orphans=0" in text
    names = {e.get("name") for e in json.loads(blob)["traceEvents"]}
    assert {"tools_q9", "murmur3_32", "convert_to_rows"} <= names
    files = trace_export.load_files([spans])
    assert trace_export.find_orphans(
        [r for _, recs in files for r in trace_export.spans_of(recs)]) \
        == []
    both("trace_export", [spans])


def test_trace_export_on_the_reference_fixtures(tmp_path):
    p1, p2 = _golden_span_records()
    paths = []
    for i, recs in enumerate((p1, p2), 1):
        path = tmp_path / f"proc{i}.jsonl"
        path.write_text("\n".join(json.dumps(r) for r in recs))
        paths.append(str(path))
    out = str(tmp_path / "trace.json")
    both("trace_export", paths + ["-o", out, "--stats"], out_file=out)
    both("trace_export", [MINI_BUNDLE, "-o", out, "--stats"],
         out_file=out)
    from spark_rapids_tpu_torch.tools import trace_export
    trace = trace_export.to_chrome_trace([("proc1.jsonl", p1),
                                          ("proc2.jsonl", p2)])
    with open(os.path.join(DATA, "trace_export_golden.json")) as f:
        assert json.dumps(trace, indent=2, sort_keys=True) == \
            f.read().rstrip("\n")


# -------------------------------------------------------- srt_explain


@pytest.mark.parametrize("src", SOURCES)
def test_srt_explain_on_workload_profile(dumps, src):
    prof = os.path.join(dumps[src], "profile.json")
    rc, text, _ = both("srt_explain", [prof, "--json"])
    assert rc == 0 and json.loads(text)["query"] == "tpcds_q9"
    for extra in ([], ["--nodes"], ["--where"], ["--where", "--json"],
                  ["--diff", prof]):
        assert both("srt_explain", [prof] + extra)[0] == 0
    bundle = bundles_of(dumps[src])[0]
    both("srt_explain", [bundle, "--json"])


def write_json(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f)
    return str(path)


def test_srt_explain_on_the_reference_fixtures(tmp_path):
    base = write_json(tmp_path / "base.json", GOLDEN_PROFILE)
    assert both("srt_explain", [base])[0] == 0
    assert both("srt_explain", [base, "--diff", base])[0] == 0
    slowed = copy.deepcopy(GOLDEN_PROFILE)
    for s in slowed["stages"]:
        s["wall_ns"] = s["wall_ns"] * 4 + 50_000_000
    slow = write_json(tmp_path / "slow.json", slowed)
    assert both("srt_explain", [slow, "--diff", base])[0] == 1
    ranks = [write_json(tmp_path / f"rank{r}.json", _rank_profile(
        r, {"q5_partials": (r + 1) * 1_000_000})) for r in range(2)]
    rc, text, _ = both("srt_explain", ranks + ["--json"])
    assert json.loads(text)["ranks"] == [0, 1]

    def full(**kw):
        p = synth_profile(**kw)
        p.setdefault("hot_stage", "s_fused")
        p["ops"] = {}
        p["shuffle_links"] = {"bytes": {}}
        return p

    cur = write_json(tmp_path / "cur.json", full(
        fused=100_000_000, wait=400_000_000))
    old = write_json(tmp_path / "old.json", full(fused=100_000_000))
    both("srt_explain", [cur, "--where"])
    both("srt_explain", [cur, "--where", "--json"])
    assert both("srt_explain", [cur, "--diff", old])[0] in (0, 1)
    span_paths = []
    for r, recs in two_rank_trace().items():
        span_paths.append(str(tmp_path / f"spans_rank{r}.jsonl"))
        with open(span_paths[-1], "w") as f:
            f.write("\n".join(json.dumps(s) for s in recs))
    both("srt_explain", span_paths + ["--critical-path"])
    both("srt_explain", span_paths + ["--critical-path", "--json"])
    junk = write_json(tmp_path / "junk.json", {"nope": 1})
    assert both("srt_explain", [junk])[0] == 2


# ------------------------------------------------------------ srt_top


@pytest.mark.parametrize("src", SOURCES)
def test_srt_top_on_workload_snapshot(dumps, src):
    snap = os.path.join(dumps[src], "timeseries_rank0.json")
    first = both("srt_top", [snap, "--once", "--json"])
    assert first == both("srt_top", [snap, "--once", "--json"])
    assert "0" in json.loads(first[1])["ranks"]
    both("srt_top", [snap, "--once"])
    both("srt_top", ["--dump-dir", dumps[src], "--once", "--json"])


def test_srt_top_on_the_reference_fixtures(tmp_path):
    snap = snap_for(0, 1, [1, 2, 3])
    snap["windows"][-1]["counters"]["srt_server_completed_total"] = \
        {"acme|success": 4}
    snap["windows"][-1]["gauges"]["srt_server_running"] = {"acme": 2.0}
    path = write_json(tmp_path / "timeseries_rank0.json", snap)
    rc, text, _ = both("srt_top", [path, "--once", "--json"])
    assert rc == 0 and json.loads(text)["tenants"]["acme"]["running"] \
        == 2.0
    assert both("srt_top", ["--once"])[0] == 2


# -------------------------------------------------------- bench_trend


def test_bench_trend_on_round_files(tmp_path):
    for name, parsed in (
            ("BENCH_r01.json", {"metric": "jcudf_to_rows", "value": 0.7,
                                "unit": "GB/s", "vs_baseline": 2.5}),
            ("BENCH_r02.json", {"metric": "jcudf_to_rows", "value": 0.6,
                                "unit": "GB/s"}),
            ("BENCH_r07.json", {"stage_fusion": {"q5": {"speedup": 3.26}},
                                "executables": {
                                    "second_same_bucket_query_compiles":
                                        0}}),
            ("BENCH_r99.json", {"novel": 1})):
        write_json(tmp_path / name, {"parsed": parsed})
    (tmp_path / "BENCH_r98.json").write_text("{torn")
    rc, text, _ = both("bench_trend", ["--dir", str(tmp_path), "--json"])
    assert rc == 1          # r02 dropped more than the tolerance
    both("bench_trend", ["--dir", str(tmp_path)])
    both("bench_trend", ["--dir", str(tmp_path), "--tolerance", "0.5",
                         "--json"])
    from spark_rapids_tpu_torch.tools import bench_trend
    assert bench_trend.repo_root() == REPO
    both("bench_trend", ["--json"])


# -------------------------------------------------- profile_converter


@pytest.mark.parametrize("src", SOURCES)
def test_profile_converter_on_workload_stream(dumps, src, tmp_path):
    stream = os.path.join(dumps[src], "prof.bin")
    out = str(tmp_path / "chrome.json")
    rc, text, blob = both("profile_converter",
                          [stream, "--chrome", out, "--summary"],
                          out_file=out)
    assert rc == 0
    events = json.loads(blob)["traceEvents"]
    names = [e["name"] for e in events if e.get("ph") == "X"]
    # the injected attempts raised before their bracket opened
    assert names == ["murmur3_32", "xxhash64", "convert_to_rows"]
    assert "allocs: 1" in text
    journal = os.path.join(dumps[src], "journal.jsonl")
    both("profile_converter", [stream, journal, "--summary"])


# ---------------------------------------------------------- srt_check


def test_srt_check_outputs_match(tmp_path):
    assert both("srt_check", ["--list-rules"])[0] == 0
    rc, text, _ = both("srt_check", ["--plan", "--json"])
    plans = json.loads(text)["plans"]
    assert rc == 0 and len(plans) == 7 and all(p["ok"] for p in plans)
    (tmp_path / "tool_case.py").write_text(
        "try:\n    pass\nexcept:\n    pass\n")
    rc, text, _ = both("srt_check", ["--root", str(tmp_path),
                                     "--no-docs-check", "--json",
                                     "tool_case.py"])
    assert rc == 1 and [f["rule"] for f in json.loads(text)["findings"]] \
        == ["SRT007"]
    # each package's digest-bearing module, under its own path
    outs = []
    for pkg in PACKAGES:
        rel = f"{pkg}/plan/ir.py"
        os.makedirs(tmp_path / pkg / "plan", exist_ok=True)
        (tmp_path / rel).write_text("import time\nt = time.time()\n")
        rc, text = run_tool(pkg, "srt_check", [
            "--root", str(tmp_path), "--no-docs-check", "--json", rel])
        outs.append((rc, text.replace(pkg + "/", "<pkg>/")))
    assert outs[0] == outs[1] and outs[0][0] == 1


# ------------------------------------------------- chip_smoke step 21


def test_tools_phase_rehearsal_on_cpu(monkeypatch, tmp_path):
    """chip_smoke's step 21 on the CPU at a small size: step 20 (small)
    keeps its bundles and drain dumps, two rank profiles and a
    timeseries snapshot stand for steps 17 and 19."""
    import chip_smoke as C
    from spark_rapids_tpu_torch.plan import compiler as PC
    monkeypatch.setattr(C, "_BUILD", str(tmp_path))
    monkeypatch.setenv("SPARK_RAPIDS_TPU_STAGE_FUSION", "0")
    # the phase checks every memoized stage was verified in this
    # process; the module's workload compiled stages before isolate
    # cleared the verify memo, so start the stage memo empty too
    monkeypatch.setattr(PC, "_STAGE_MEMO", {})
    C.server_phase("cpu", params=C.SERVER_SMALL, flagship_rows=1 << 10,
                   q9_rows=1 << 10, deadline_q5=C.SERVER_SMALL_DEADLINE_Q5)
    for r in range(2):
        C.keep_json_for_tools(_rank_profile(
            r, {"q5_partials": (r + 1) * 1_000_000}), "dist",
            f"profile_q5_rank{r}.json")
    C.keep_json_for_tools(snap_for(0, 1, [1, 2, 3]), "plane",
                          "timeseries_rank0.json")
    res = C.tools_phase("cpu", flagship_rows=1 << 10)
    sc, fl = res["sidecars"], res["files"]
    assert sc["op_ranges"] == {op: C.TOOLS_ITERS for op in C.TOOLS_OPS}
    assert sc["allocs"] == {"alloc": C.TOOLS_ITERS,
                            "free": C.TOOLS_ITERS}
    assert set(sc["ms"]) == {"off", "bracket", "profiler", "tracing",
                             "off_after"}
    assert res["faults"]["doctor_first"]["kind"] == "fault_injection"
    assert sorted(fl["doctor_first"]) == ["admission_stall", "query_hang"]
    assert fl["server_rows"] > 0 and fl["spans"] > 0
    assert not os.path.exists(C.tools_dir())
