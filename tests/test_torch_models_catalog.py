"""PyTorch port: the named query catalog (`spark_rapids_tpu_torch.models`)
against the JAX package's (`spark_rapids_tpu.models`): the eight built-in
names (and the three file-backed ones, tests/test_torch_filesource.py,
and the two incremental ones, tests/test_torch_result_cache.py) give the reference's rows with `{"device": "cpu"}` (the reference
ignores the key), cancel and deadline raise before any work, unknown
and not-yet-ported names raise UnknownQueryError, the pipeline cache
stays bounded, and eight threads give the bytes of a serial run.  The
stage-IR names run op by op here; tests/test_torch_catalog_fused.py
covers the fused engine."""

import threading
import time
from concurrent.futures import ThreadPoolExecutor

import pytest

import spark_rapids_tpu.models as JM
import spark_rapids_tpu_torch.models as TM

NAMES = ["tpcds_q3", "tpcds_q3_fused", "tpcds_q5", "tpcds_q5_fused",
         "tpcds_q7", "tpcds_q72", "tpcds_q72_fused", "tpcds_q9"]
FILE_NAMES = ["tpcds_q3_file", "tpcds_q7_file", "tpcds_q9_file"]
INCREMENTAL_NAMES = ["tpcds_q5_incremental", "tpcds_q72_incremental"]
PARAMS = [{}, {"rows": 3001, "seed": 1}]


@pytest.fixture(autouse=True)
def op_by_op(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_TPU_STAGE_FUSION", "0")


def _run(m, name, params):
    return m.run_catalog_query(name, dict(params, device="cpu"))


def test_the_eight_names_are_registered():
    every = NAMES + FILE_NAMES + INCREMENTAL_NAMES
    assert TM.catalog_queries() == sorted(every)
    assert all(TM.has_query(n) for n in every)
    assert set(every) <= set(JM.catalog_queries())


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("params", PARAMS)
def test_rows_match_reference(name, params):
    got = _run(TM, name, params)
    want = _run(JM, name, params)
    assert got == want
    for g, w in zip(got, want):
        assert [type(x) for x in g] == [type(x) for x in w]


def test_hand_and_stage_names_agree():
    for hand in ("tpcds_q3", "tpcds_q5", "tpcds_q72"):
        assert _run(TM, hand, {}) == _run(TM, hand + "_fused", {})


@pytest.mark.parametrize("name", ["tpcds_q5_file", "tpcds_q72_file",
                                  "tpcds_q67_file", "tpcds_q5_stream",
                                  "tpcds_q72_stream", "tpcds_q99"])
def test_unported_and_unknown_names_raise(name):
    assert not TM.has_query(name)
    with pytest.raises(TM.UnknownQueryError):
        TM.run_catalog_query(name, {"device": "cpu"})


@pytest.mark.parametrize("name", NAMES)
def test_cancel_raises_before_any_work(name, monkeypatch):
    from spark_rapids_tpu_torch.models import tpcds

    def no_work(*a, **k):
        raise AssertionError("ran after a cancel")

    for gen in ("gen_q3", "gen_q5", "gen_q7", "gen_q9", "gen_q72"):
        monkeypatch.setattr(tpcds, gen, no_work)
    ev = threading.Event()
    ev.set()
    with pytest.raises(TM.QueryCancelled) as got:
        TM.run_catalog_query(name, {"device": "cpu"},
                             TM.QueryContext(query_id="q", cancel_event=ev))
    assert type(got.value) is TM.QueryCancelled
    past = time.monotonic_ns() - 1
    with pytest.raises(TM.QueryDeadlineExceeded):
        TM.run_catalog_query(name, {"device": "cpu"},
                             TM.QueryContext(deadline_ns=past))


def test_context_deadline_and_cancel_order():
    ctx = TM.QueryContext()
    assert not ctx.cancelled() and ctx.remaining_s() is None
    ctx.check_cancel()
    later = TM.QueryContext(deadline_ns=time.monotonic_ns() + 60 * 10**9)
    assert 0 < later.remaining_s() <= 60
    later.check_cancel()
    ev = threading.Event()
    ev.set()
    both = TM.QueryContext(cancel_event=ev, deadline_ns=0)
    with pytest.raises(TM.QueryCancelled) as got:
        both.check_cancel()       # an explicit cancel wins
    assert type(got.value) is TM.QueryCancelled
    assert issubclass(TM.QueryDeadlineExceeded, TM.QueryCancelled)
    assert issubclass(TM.UnknownQueryError, KeyError)


def test_register_and_unregister():
    TM.register_query("custom", lambda params, ctx: [[params["x"]]])
    try:
        assert TM.has_query("custom")
        assert TM.run_catalog_query("custom", {"x": 3}) == [[3]]
    finally:
        TM.unregister_query("custom")
    assert not TM.has_query("custom")
    TM.unregister_query("custom")      # a second removal is a no-op


def test_pipeline_cache_is_a_bounded_lru(monkeypatch):
    monkeypatch.setattr(TM, "_PIPELINES", {})
    for i in range(TM._PIPELINES_MAX + 8):
        assert TM._pipeline(("k", i), lambda i=i: i) == i
        TM._pipeline(("k", 0), lambda: "rebuilt")   # keep 0 hot
    assert len(TM._PIPELINES) == TM._PIPELINES_MAX
    assert TM._pipeline(("k", 0), lambda: "rebuilt") == 0
    assert ("k", 1) not in TM._PIPELINES
    assert ("k", TM._PIPELINES_MAX + 7) in TM._PIPELINES


def test_pipeline_first_publisher_wins(monkeypatch):
    monkeypatch.setattr(TM, "_PIPELINES", {})

    def racing_build():
        # another thread publishes the same key while this one builds
        TM._pipeline(("race",), lambda: "first")
        return "second"

    assert TM._pipeline(("race",), racing_build) == "first"
    assert TM._pipeline(("race",), lambda: "third") == "first"


def test_eight_threads_give_the_serial_bytes():
    jobs = [(n, p) for n in NAMES for p in PARAMS]
    serial = [_run(TM, n, p) for n, p in jobs]
    with ThreadPoolExecutor(8) as pool:
        threaded = list(pool.map(lambda j: _run(TM, *j), jobs))
    assert threaded == serial
