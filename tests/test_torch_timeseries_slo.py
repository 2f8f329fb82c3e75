"""PyTorch port: the windowed timeseries sampler
(``observability/timeseries.py``), the SLO burn-rate monitor
(``observability/slo.py``), the fleet merger and their wiring in
``observability/__init__`` (the Monitor's drive, ``evaluate_slo``, the
``slo_burn`` incident, the journal dump's records), held against the
JAX package's.

Every case runs one scripted sequence through both packages under an
injected clock and compares windows, burn rates, statuses, alerts and
merge outcomes; one case launches two elastic CPU workers of the port
and reads the windows they dump and publish to rank 0.  Tolerance: exact everywhere, except the windows'
wall-clock stamps (``t_unix_ms``), which must be present, and the
tick-time histogram's values, which must be counted.
"""

import json
import os

import pytest

from spark_rapids_tpu import observability as jobs
from spark_rapids_tpu.observability import slo as JSLO
from spark_rapids_tpu.observability import timeseries as JTS
from spark_rapids_tpu_torch import observability as obs
from spark_rapids_tpu_torch.observability import slo as SLO
from spark_rapids_tpu_torch.observability import timeseries as TS
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


class FakeRegistry:
    def __init__(self):
        self.snap = {}

    def snapshot(self):
        return json.loads(json.dumps(self.snap))


def counter(value, labels=()):
    return {"kind": "counter", "help": "", "labels": [],
            "series": [{"labels": list(labels), "value": value}]}


def gauge(value):
    return {"kind": "gauge", "help": "", "labels": [],
            "series": [{"labels": [], "value": value}]}


def histogram(bucket_counts, total, count, buckets=(1e3, 1e6, 1e9)):
    return {"kind": "histogram", "help": "", "labels": [],
            "buckets": list(buckets),
            "series": [{"labels": [], "sum": total, "count": count,
                        "bucket_counts": list(bucket_counts)}]}


def both(fn):
    return fn(TS, SLO), fn(JTS, JSLO)


SCRIPT = [
    {"srt_x_total": counter(100), "srt_g": gauge(7.0),
     "srt_h_ns": histogram([90, 0, 0, 0], 90e2, 90)},
    {"srt_x_total": counter(130), "srt_g": gauge(3.0),
     "srt_h_ns": histogram([90, 0, 10, 0], 90e2 + 10e8, 100)},
    {"srt_x_total": counter(130), "srt_g": gauge(3.0),
     "srt_h_ns": histogram([90, 0, 10, 0], 90e2 + 10e8, 100)},
    {"srt_x_total": counter(171, ("a",)), "srt_g": gauge(9.5),
     "srt_h_ns": histogram([91, 5, 10, 2], 95e8, 108)},
]


def _windows(ts, _slo, capacity=3):
    reg = FakeRegistry()
    clock = FakeClock()
    s = ts.TimeseriesSampler(reg, window_s=5.0, capacity=capacity,
                             clock=clock, wall_clock=clock)
    out = [s.maybe_tick()]                # disabled: a noop
    s.enabled = True
    for snap in SCRIPT:
        reg.snap = snap
        out.append(s.tick())
        clock.advance(2.0)
        out.append(s.maybe_tick())         # window not yet elapsed
        clock.advance(3.5)
    out.append(s.windows())
    out.append(s.recent_histogram("srt_h_ns", n=2))
    out.append(s.rate("srt_x_total", n=3))
    out.append(ts.sum_counter_windows(s.windows(), "srt_x_total"))
    out.append(s.last_tick_age_s(now=clock.t + 1.0))
    return out


@pytest.mark.parametrize("capacity", [2, 3, 8])
def test_windows_match_reference(capacity):
    port, ref = both(lambda ts, slo: _windows(ts, slo, capacity))
    assert json.dumps(port, sort_keys=True) == \
        json.dumps(ref, sort_keys=True)
    assert len(port[-5]) == min(capacity, len(SCRIPT))


def test_histogram_quantile_matches_reference():
    for counts in ([90, 0, 10, 0], [0, 0, 0, 5], [1, 2, 3, 4], [0] * 4):
        for q in (0.0, 0.5, 0.9, 0.99, 1.0):
            assert TS.histogram_quantile([1e3, 1e6, 1e9], counts, q) == \
                JTS.histogram_quantile([1e3, 1e6, 1e9], counts, q)


def _burns(ts, slo):
    clock = FakeClock()
    burns = []
    m = slo.SloMonitor(configs={"*": slo.SloConfig(objective=0.9)},
                       fast_s=60.0, slow_s=600.0, threshold=4.0,
                       cooldown_s=100.0, clock=clock,
                       on_burn=lambda t, a: burns.append((t, a)))
    m.enabled = True
    out = []
    for _ in range(400):
        m.observe("t", "success", 1_000_000)
        m.observe("u", "success", 1_000_000)
        clock.advance(1.0)
    for _ in range(30):
        m.observe("t", "failed", 1_000_000)
        m.observe("u", "cache_hit", 1)
        clock.advance(1.0)
    out.append(m.evaluate())
    out.append(m.status())
    for _ in range(300):
        m.observe("t", "failed", 1_000_000)
        clock.advance(1.0)
    out.append(m.evaluate())
    clock.advance(10.0)
    out.append(m.evaluate())
    out.append(m.maybe_evaluate())
    clock.advance(200.0)
    for _ in range(20):
        m.observe("t", "failed", 1_000_000)
    out.append(m.evaluate())
    out.append(m.status())
    out.append(burns)
    out.append(m.attainment("t"))
    return out


def test_burn_rates_alerts_and_cooldown_match_reference():
    port, ref = both(_burns)
    assert json.dumps(port, sort_keys=True) == \
        json.dumps(ref, sort_keys=True)
    assert port[1]["t"]["burn_fast"] >= 4.0 > port[1]["t"]["burn_slow"]
    assert port[0] == [] and len(port[2]) == 1 and port[3] == []
    assert port[6]["t"]["breaches"] == 2


def test_slo_config_parse_matches_reference(tmp_path):
    p = tmp_path / "slo.json"
    p.write_text('{"acme": {"latency_ms": 50, "objective": 0.5}}')
    for spec in ('{"*": {"latency_ms": 100, "objective": 0.95}}',
                 "@" + str(p)):
        got, want = SLO.parse_slo_config(spec), JSLO.parse_slo_config(spec)
        assert {k: (v.latency_target_ns, v.objective)
                for k, v in got.items()} == \
            {k: (v.latency_target_ns, v.objective)
             for k, v in want.items()}
    for bad in ("{not json", '{"*": {"objective": 1.5}}'):
        with pytest.raises(ValueError):
            SLO.parse_slo_config(bad)
        with pytest.raises(ValueError):
            JSLO.parse_slo_config(bad)
    assert SLO._NEUTRAL_OUTCOMES == JSLO._NEUTRAL_OUTCOMES


def snap_for(rank, epoch, seqs, value=10):
    return {"rank": rank, "epoch": epoch,
            "windows": [{"window": q, "t_unix_ms": 0, "dur_s": 1.0,
                         "counters": {"srt_x_total": {"": value}},
                         "gauges": {}, "histograms": {}}
                        for q in seqs]}


def _fleet(ts, _slo):
    fleet = ts.FleetTimeseries(capacity_per_rank=3)
    out = [fleet.offer(snap_for(0, 3, [1, 2])),
           fleet.offer(snap_for(1, 3, [1])),
           fleet.offer(snap_for(0, 3, [1, 2])),
           fleet.offer(snap_for(1, 2, [5, 6])),
           fleet.offer(snap_for(1, 4, [2])),
           fleet.offer(snap_for(0, 4, [2, 3, 4, 5])),
           fleet.offer({"rank": 2, "epoch": 4, "windows": []}),
           fleet.epoch, fleet.ranks(), fleet.rank_windows(0),
           fleet.totals("srt_x_total"), fleet.merged()]
    return out


def test_fleet_merge_matches_reference():
    port, ref = both(_fleet)
    assert port == ref
    assert port[:5] == ["merged", "merged", "dup", "stale_epoch",
                        "merged"]


def _live_plane(o, clock, monkeypatch):
    """The package's own sampler over its registry, driven by the
    Monitor hook at an injected clock."""
    o.enable()
    o.enable_timeseries(window_s=1.0, capacity=16)
    monkeypatch.setattr(o.TIMESERIES, "_clock", clock)
    o.record_monitor_sample()              # first sample: tick 1
    o.record_shuffle_write(1000, 5, 10)
    o.record_jit_cache("hit", "k")
    clock.advance(0.4)
    o.record_monitor_sample()              # inside the window
    clock.advance(0.7)
    o.record_shuffle_write(500, 7, 3)
    o.record_monitor_sample()              # tick 2
    o.record_shuffle_write(250, 1, 1)
    o.TIMESERIES.tick()                    # close the last window
    ws = o.TIMESERIES.windows()
    for w in ws:
        assert w.pop("t_unix_ms") > 0
        w.pop("dur_s")
        w["histograms"] = sorted(w["histograms"])
        for fam in ("srt_timeseries_tick_ns",
                    "srt_monitor_last_sample_age_s"):
            w["counters"].pop(fam, None)
            w["gauges"].pop(fam, None)
    return ws


def test_monitor_drive_and_conservation_match_reference(monkeypatch):
    port = _live_plane(obs, FakeClock(), monkeypatch)
    ref = _live_plane(jobs, FakeClock(), monkeypatch)
    assert port == ref and len(port) == 3
    # conservation: windowed deltas sum to the registry's cumulative
    # values
    total = TS.sum_counter_windows(obs.TIMESERIES.windows(),
                                   "srt_shuffle_write_bytes_total")
    fam = obs.METRICS.family_snapshot("srt_shuffle_write_bytes_total")
    assert total == {"": float(fam["series"][0]["value"])} == \
        {"": 1750.0}
    assert obs.METRICS.family_snapshot("srt_timeseries_windows_total") == \
        jobs.METRICS.family_snapshot("srt_timeseries_windows_total")


def test_slo_burn_freezes_one_incident_like_reference(tmp_path):
    results = []
    for o in (obs, jobs):
        o.enable()
        o.enable_flight_recorder(out_dir=str(tmp_path / o.__name__))
        o.enable_slo()
        for _ in range(25):
            o.SLO.observe("acme", "success", 1_000_000_000)
        fired = o.evaluate_slo()
        again = o.evaluate_slo()
        kinds = [b["kind"] for b in o.FLIGHT.incident_list()]
        fams = {f: o.METRICS.family_snapshot(f) for f in (
            "srt_slo_breaches_total", "srt_slo_burn_rate",
            "srt_slo_attainment")}
        results.append((fired, again, kinds, fams, o.SLO.status()))
    assert results[0] == results[1]
    fired, again, kinds, _f, _s = results[0]
    assert [a["tenant"] for a in fired] == ["acme"] and again == []
    assert kinds == ["slo_burn"]


def test_dump_journal_carries_timeseries_and_slo_records(tmp_path):
    kinds = []
    for o in (obs, jobs):
        o.enable()
        o.enable_timeseries(window_s=60.0)
        o.enable_slo()
        o.SLO.observe("acme", "success", 1_000)
        o.TIMESERIES.tick()
        path = tmp_path / f"{o.__name__}.jsonl"
        o.dump_journal_jsonl(str(path))
        recs = [json.loads(ln) for ln in path.read_text().splitlines()]
        kinds.append([r["kind"] for r in recs])
        snap = [r for r in recs if r["kind"] == "timeseries_snapshot"]
        assert snap[0]["rank"] == 0 and snap[0]["slo"]["acme"]
    assert kinds[0] == kinds[1]
    assert kinds[0][-2:] == ["timeseries_snapshot", "slo_status"]


def test_timeseries_snapshot_and_health_match_reference():
    shapes = []
    for o in (obs, jobs):
        o.enable()
        o.enable_timeseries(window_s=60.0)
        o.enable_attribution()
        o.TIMESERIES.tick()
        snap = o.timeseries_snapshot(rank=2, epoch=5)
        o.record_monitor_sample(now=100.0)
        h = o.health()
        shapes.append((sorted(snap), snap["rank"], snap["epoch"],
                       sorted(h), sorted(h["monitor"]),
                       sorted(h["flight_recorder"]),
                       sorted(h["profiler"]), h["monitor"][
                           "timeseries_windows"],
                       h["monitor"]["attribution_enabled"]))
    assert shapes[0] == shapes[1]
    assert shapes[0][1:3] == (2, 5)


def test_shim_telemetry_entries_match_reference():
    from spark_rapids_tpu.shim import jni_entry as JE
    from spark_rapids_tpu_torch.shim import jni_api, jni_entry
    for e in (jni_entry, JE):
        assert e.timeseries_set_enabled(True) is False
        assert e.slo_set_enabled(True) is False
        assert e.timeseries_enabled() and e.slo_enabled()
    for o in (obs, jobs):
        o.SLO.observe("t", "success", 10)
    port = json.loads(jni_entry.timeseries_snapshot_json())
    ref = json.loads(JE.timeseries_snapshot_json())
    assert sorted(port) == sorted(ref)
    assert json.loads(jni_api.slo_status_json()) == \
        json.loads(JE.slo_status_json())
    assert json.loads(jni_entry.slo_evaluate_json()) == \
        json.loads(JE.slo_evaluate_json()) == []
    for e in (jni_entry, JE):
        assert e.timeseries_set_enabled(False) is True
        assert e.slo_set_enabled(False) is True


def test_elastic_workers_dump_and_publish_their_windows(tmp_path):
    """Two elastic CPU workers with the timeseries plane and profiling
    on: each rank dumps its windows beside a same-moment registry (the
    windows' link-byte deltas sum to it) and a query profile, and rank 0
    merges both ranks' windows into fleet_timeseries.json."""
    from spark_rapids_tpu_torch.distributed import launcher as DL
    out = str(tmp_path)
    DL.launch(2, out, ops=("q5",), device="cpu", elastic=True,
              worker_env={"SPARK_RAPIDS_TPU_STAGE_FUSION": "0",
                          "SPARK_RAPIDS_TPU_TIMESERIES": "1",
                          "SPARK_RAPIDS_TPU_PROFILE": "1"},
              timeout_s=120.0)
    for r in range(2):
        with open(os.path.join(out, f"timeseries_rank{r}.json")) as f:
            snap = json.load(f)
        with open(os.path.join(out, f"metrics_ts_rank{r}.json")) as f:
            reg = json.load(f)
        assert snap["rank"] == r and snap["windows"]
        want = {"|".join(x["labels"]): float(x["value"]) for x in
                reg["srt_shuffle_link_bytes_total"]["series"]}
        assert TS.sum_counter_windows(
            snap["windows"], "srt_shuffle_link_bytes_total") == want
        with open(os.path.join(out, f"profile_q5_rank{r}.json")) as f:
            prof = json.load(f)
        assert prof["query"] == "dist_q5" and prof["rank"] == r
    with open(os.path.join(out, "fleet_timeseries.json")) as f:
        fleet = json.load(f)
    assert sorted(fleet["ranks"]) == ["0", "1"]
