"""The port's process harness (shuffle/socket_io.py, robustness/links.py,
parallel/exchange.py's table transport, distributed/) held to the JAX
package: the non-seekable kudo socket path, the framed ACK/NAK
transport, the rank-ordered shuffle service, distributed q5/q72 with
two ranks in one process over unix sockets byte-equal to the JAX
package's single-process results, a MIXED fleet (a JAX ShuffleService
as rank 0, the port's as rank 1) exchanging the same tables both ways,
the process launcher with two CPU workers, the group attempt, and the
import rule of the slice's new modules.

The in-process queries run op by op (SPARK_RAPIDS_TPU_STAGE_FUSION=0,
the runner's escape hatch, whose bytes the fused engine must give:
tests/test_torch_distributed_fused.py runs q5 fused).
"""

import ast
import io
import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from spark_rapids_tpu_torch.columns import dtypes
from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.columns.table import Table
from spark_rapids_tpu_torch.shuffle import kudo
from spark_rapids_tpu_torch.shuffle.schema import schema_of_table
from spark_rapids_tpu_torch.shuffle.socket_io import SocketStream
from torch_port_data import table_parts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def crc_on():
    prior = kudo.set_crc_enabled(True)
    yield
    kudo.set_crc_enabled(prior)


@pytest.fixture
def op_by_op(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_TPU_STAGE_FUSION", "0")


def _table(vals=(1, None, 3, 4)):
    return Table([Column.from_pylist(list(vals), dtypes.INT64, "cpu"),
                  Column.from_strings(["a", "bb", None, "cc"], "cpu")])


def _jax_table(vals=(1, None, 3, 4)):
    from spark_rapids_tpu.columns import dtypes as jdt
    from spark_rapids_tpu.columns.column import Column as JColumn
    from spark_rapids_tpu.columns.table import Table as JTable
    return JTable([JColumn.from_pylist(list(vals), jdt.INT64),
                   JColumn.from_strings(["a", "bb", None, "cc"])])


def _record_bytes(t):
    buf = io.BytesIO()
    kudo.write_to_stream(t.columns, buf, 0, t.num_rows)
    return bytearray(buf.getvalue())


def _feed(blob: bytes):
    """Socketpair with a daemon writer pushing `blob` (through the
    socket_io write endpoint) then closing."""
    from spark_rapids_tpu_torch.shuffle.socket_io import send_tables
    a, b = socket.socketpair()

    def run():
        send_tables(a, blob)
        a.close()

    threading.Thread(target=run, daemon=True).start()
    return b


def _merge(tables, like):
    return kudo.merge_to_table(tables, schema_of_table(like), device="cpu")


# ------------------------------------------------- non-seekable reader


class TestKudoOverSockets:

    def test_record_bytes_equal_jax(self, crc_on):
        """The port's CRC'd kudo record is the JAX package's, byte for
        byte (the payload both packages put on a link)."""
        from spark_rapids_tpu.shuffle import kudo as jkudo
        prior = jkudo.set_crc_enabled(True)
        try:
            jt = _jax_table()
            buf = io.BytesIO()
            jkudo.write_to_stream(jt.columns, buf, 0, jt.num_rows)
        finally:
            jkudo.set_crc_enabled(prior)
        assert bytes(_record_bytes(_table())) == buf.getvalue()

    def test_clean_stream_roundtrip(self, crc_on):
        from spark_rapids_tpu_torch.shuffle.socket_io import recv_tables
        t = _table()
        blob = b"".join(bytes(_record_bytes(t)) for _ in range(3))
        got = recv_tables(_feed(blob))
        assert len(got) == 3
        assert _merge(got, t).num_rows == 12

    def test_deferred_crc_detects_corruption(self, crc_on):
        """Without resync, a corrupted middle record raises at the NEXT
        header read (the deferred late-trailer verify)."""
        t = _table()
        recs = [_record_bytes(t) for _ in range(2)]
        hdr = 4 + 24 + 1  # magic + six i32 + 1-byte validity bitset
        recs[0][hdr + 10] ^= 0xFF
        with pytest.raises(kudo.KudoCorruptException) as ei:
            kudo.read_tables(SocketStream(_feed(b"".join(
                bytes(r) for r in recs))))
        assert ei.value.deferred

    def test_resync_drops_corrupt_record(self, crc_on):
        t = _table()
        recs = [_record_bytes(t) for _ in range(4)]
        hdr = 4 + 24 + 1
        recs[1][hdr + 20] ^= 0x55
        got = kudo.read_tables(SocketStream(_feed(b"".join(
            bytes(r) for r in recs))), resync=True)
        assert len(got) == 3
        merged = _merge(got, t)
        assert merged.num_rows == 12
        assert merged.to_pylist()[:4] == _table().to_pylist()

    def test_resync_scans_past_garbage(self, crc_on):
        from spark_rapids_tpu_torch.shuffle.socket_io import recv_tables
        t = _table()
        recs = [bytes(_record_bytes(t)) for _ in range(3)]
        blob = recs[0] + b"\x81" * 97 + recs[1] + recs[2]
        assert len(recv_tables(_feed(blob), resync=True)) == 3

    def test_truncated_tail_returns_survivors(self, crc_on):
        t = _table()
        recs = [bytes(_record_bytes(t)) for _ in range(2)]
        blob = recs[0] + recs[1][: len(recs[1]) // 2]
        got = kudo.read_tables(SocketStream(_feed(blob)), resync=True)
        assert len(got) == 1

    def test_seekable_resync_unchanged(self, crc_on):
        t = _table()
        recs = [_record_bytes(t) for _ in range(3)]
        hdr = 4 + 24 + 1
        recs[1][hdr + 8] ^= 0xFF
        buf = io.BytesIO(b"".join(bytes(r) for r in recs))
        assert len(kudo.read_tables(buf, resync=True)) == 2


# ------------------------------------------------------ link transport


class TestTransport:

    def _pair(self, tmp_path, policy=None):
        from spark_rapids_tpu_torch.distributed.transport import (
            Inbox, Listener, PeerLink)
        addr = f"unix:{os.path.join(str(tmp_path), 'l.sock')}"
        inbox = Inbox()
        listener = Listener(0, addr, inbox).start()
        return listener, PeerLink(1, 0, addr, policy=policy), inbox

    def _payload(self):
        t = _table()
        return bytes(_record_bytes(t)), t

    def test_frame_layout(self):
        from spark_rapids_tpu.distributed import transport as JTR
        from spark_rapids_tpu_torch.distributed import transport as TR
        for name in ("FRAME_MAGIC", "FRAME_FMT", "FRAME_LEN", "EXT_FMT",
                     "EXT_LEN", "KIND_DATA", "KIND_EDATA", "KIND_CTRL",
                     "ACK", "NAK", "STALE", "MAX_PAYLOAD", "RESPLIT_FLAG"):
            assert getattr(TR, name) == getattr(JTR, name), name
        assert TR.FRAME_LEN == 25 and TR.EXT_LEN == 8
        for args in ((300, 2, 5), (0, 0, 1), (32767, 254, 255)):
            assert TR.pack_resplit(*args) == JTR.pack_resplit(*args)

    def test_ack_roundtrip(self, tmp_path, crc_on):
        listener, link, inbox = self._pair(tmp_path)
        try:
            payload, t = self._payload()
            assert link.send(7, payload) == len(payload)
            got = inbox.wait(7, [1], timeout_s=10.0)
            assert _merge(got[1], t).to_pylist() == t.to_pylist()
        finally:
            link.close()
            listener.stop()

    def test_corrupt_payload_nak_then_clean_resend(self, tmp_path, crc_on):
        from spark_rapids_tpu_torch.distributed import transport as TR
        from spark_rapids_tpu_torch.robustness import links
        listener, link, inbox = self._pair(tmp_path)
        TR.reset_stats()
        naks = links.LINK_STATS["nak"]
        try:
            TR.set_link_fault("corrupt", 0, 9)
            payload, t = self._payload()
            link.send(9, payload)
            got = inbox.wait(9, [1], timeout_s=10.0)
            assert _merge(got[1], t).to_pylist() == t.to_pylist()
            assert links.LINK_STATS["nak"] == naks + 1
            assert TR.STATS["naks_sent"] == TR.STATS["naks_recv"] == 1
            assert TR.STATS["resends"] == 1
            assert TR.link_bytes() == {("send", 0): len(payload),
                                       ("recv", 1): len(payload)}
        finally:
            TR.clear_link_faults()
            link.close()
            listener.stop()

    def test_truncated_link_reconnect_resend(self, tmp_path, crc_on):
        from spark_rapids_tpu_torch.distributed import transport as TR
        listener, link, inbox = self._pair(tmp_path)
        try:
            TR.set_link_fault("trunc", 0, 11)
            payload, t = self._payload()
            link.send(11, payload)
            got = inbox.wait(11, [1], timeout_s=10.0)
            assert _merge(got[1], t).num_rows == t.num_rows
        finally:
            TR.clear_link_faults()
            link.close()
            listener.stop()

    def test_dead_peer_raises_typed(self, tmp_path, crc_on):
        from spark_rapids_tpu_torch.distributed.transport import PeerLink
        from spark_rapids_tpu_torch.robustness.links import \
            PeerDiedException
        from spark_rapids_tpu_torch.robustness.retry import RetryPolicy
        link = PeerLink(
            1, 0, f"unix:{os.path.join(str(tmp_path), 'gone.sock')}",
            policy=RetryPolicy(max_attempts=2, base_backoff_s=0.0,
                               sleep=lambda s: None))
        with pytest.raises(PeerDiedException) as ei:
            link.send(1, b"xx")
        assert ei.value.peer == "0"
        assert ei.value.attempts == 2

    def test_inbox_wait_timeout_names_missing(self):
        from spark_rapids_tpu_torch.distributed.transport import Inbox
        from spark_rapids_tpu_torch.robustness.links import \
            PeerDiedException
        inbox = Inbox()
        inbox.put(3, 1, [])
        with pytest.raises(PeerDiedException) as ei:
            inbox.wait(3, [1, 2], timeout_s=0.05)
        assert ei.value.peer == "2"

    def test_link_retry_driver_budget(self):
        from spark_rapids_tpu_torch.robustness.links import (
            PeerDiedException, ShuffleLinkError, with_link_retry)
        from spark_rapids_tpu_torch.robustness.retry import RetryPolicy
        calls = []

        def attempt():
            calls.append(1)
            raise ShuffleLinkError("nak again", reason="nak")

        with pytest.raises(PeerDiedException):
            with_link_retry(
                attempt, peer=5,
                policy=RetryPolicy(max_attempts=3, base_backoff_s=0.0,
                                   sleep=lambda s: None))
        assert len(calls) == 3

    def test_link_retry_passes_non_transient(self):
        from spark_rapids_tpu_torch.robustness.links import with_link_retry

        def attempt():
            raise KeyError("not a link problem")

        with pytest.raises(KeyError):
            with_link_retry(attempt, peer=0)


# ------------------------------------------------------ table exchange


def _services(tmp_path, world=2, prefix="s"):
    from spark_rapids_tpu_torch.distributed.service import ShuffleService
    addrs = [f"unix:{os.path.join(str(tmp_path), f'{prefix}{r}.sock')}"
             for r in range(world)]
    return [ShuffleService(r, world, addrs).start() for r in range(world)]


def _run_ranks(fns, timeout=180):
    outs = [None] * len(fns)
    errs = [None] * len(fns)

    def work(r):
        try:
            outs[r] = fns[r]()
        except Exception as e:  # noqa: BLE001
            errs[r] = e

    ts = [threading.Thread(target=work, args=(r,))
          for r in range(len(fns))]
    [t.start() for t in ts]
    [t.join(timeout) for t in ts]
    assert errs == [None] * len(fns), errs
    return outs


def _int64(vals):
    return Table([Column(dtypes.INT64, len(vals), data=torch.tensor(
        vals, dtype=torch.int64))])


class TestShuffleService:

    def test_requires_crc(self):
        from spark_rapids_tpu_torch.distributed.service import \
            ShuffleService
        prior = kudo.set_crc_enabled(False)
        try:
            with pytest.raises(RuntimeError, match="KCRC"):
                ShuffleService(0, 1, ["unix:/tmp/x.sock"])
        finally:
            kudo.set_crc_enabled(prior)

    def test_exchange_rank_order_and_allgather(self, tmp_path, crc_on):
        svcs = _services(tmp_path)
        try:
            def work(r):
                # dest d gets [100*r + d, 100*r + d + 10]
                parts = [_int64([100 * r + d, 100 * r + d + 10])
                         for d in range(2)]
                merged = svcs[r].exchange(21, parts)
                gathered = svcs[r].allgather(22, _int64([r, r]))
                return (merged.columns[0].data.tolist(),
                        gathered.columns[0].data.tolist())

            outs = _run_ranks([lambda r=r: work(r) for r in range(2)], 60)
            # rank 0 receives its own partition then rank 1's: in SOURCE
            # order regardless of arrival
            assert outs[0][0] == [0, 10, 100, 110]
            assert outs[1][0] == [1, 11, 101, 111]
            assert outs[0][1] == outs[1][1] == [0, 0, 1, 1]
        finally:
            for s in svcs:
                s.stop()

    def test_await_peers_waits_for_a_late_listener(self, tmp_path,
                                                   crc_on):
        """A peer that starts listening late is awaited, and the probe
        moves no frame; one that never listens raises typed."""
        from spark_rapids_tpu_torch.distributed import transport as TR
        from spark_rapids_tpu_torch.distributed.service import \
            ShuffleService
        from spark_rapids_tpu_torch.robustness.links import \
            PeerDiedException
        addrs = [f"unix:{tmp_path}/late{r}.sock" for r in range(2)]
        svcs = [ShuffleService(r, 2, addrs) for r in range(2)]
        svcs[0].start()
        try:
            TR.reset_stats()
            with pytest.raises(PeerDiedException, match="not listening"):
                svcs[0].await_peers(timeout_s=0.3)
            later = threading.Timer(0.5, svcs[1].start)
            later.start()
            t0 = time.monotonic()
            svcs[0].await_peers(timeout_s=20)
            assert 0.3 < time.monotonic() - t0 < 10
            later.join()
            svcs[1].await_peers(timeout_s=5)
            assert TR.STATS["frames_sent"] == TR.STATS["frames_recv"] == 0
        finally:
            for s in svcs:
                s.stop()

    @pytest.mark.slow  # the JAX test's mark
    def test_barrier(self, tmp_path, crc_on):
        svcs = _services(tmp_path)
        try:
            _run_ranks([lambda r=r: svcs[r].barrier(900)
                        for r in range(2)], 30)
        finally:
            for s in svcs:
                s.stop()

    def test_inprocess_loopback_transport(self, crc_on):
        from spark_rapids_tpu_torch.parallel import exchange as X
        X.set_table_transport(None)
        t = _table()
        out = X.exchange_tables(5, [t])
        assert out.to_pylist() == t.to_pylist()
        assert out.device == torch.device("cpu")
        assert X.allgather_table(6, t).to_pylist() == t.to_pylist()
        with pytest.raises(ValueError, match="world=1"):
            X.exchange_tables(5, [t, t])

    def test_install_uninstall(self, tmp_path, crc_on):
        from spark_rapids_tpu_torch.parallel import exchange as X
        svcs = _services(tmp_path, world=1)
        try:
            svcs[0].install()
            assert X.table_transport() is svcs[0]
            svcs[0].uninstall()
            assert X.table_transport() is not svcs[0]
        finally:
            for s in svcs:
                s.stop()


class TestMixedFleet:
    """A JAX ShuffleService as rank 0 and the port's as rank 1 on one
    pair of unix sockets: the same frames and kudo bytes on the wire, so
    each side's exchange and allgather merge the same tables."""

    def test_jax_and_port_ranks_exchange_both_ways(self, tmp_path, crc_on):
        from spark_rapids_tpu.distributed.service import \
            ShuffleService as JService
        from spark_rapids_tpu.shuffle import kudo as jkudo
        from spark_rapids_tpu_torch.distributed.service import \
            ShuffleService as TService
        addrs = [f"unix:{os.path.join(str(tmp_path), f'm{r}.sock')}"
                 for r in range(2)]
        prior = jkudo.set_crc_enabled(True)
        jsvc = JService(0, 2, addrs).start()
        tsvc = TService(1, 2, addrs).start()
        vals = {(s, d): [10 * s + d, None, 100 * s + d, 7]
                for s in range(2) for d in range(2)}
        try:
            def jax_rank():
                merged = jsvc.exchange(31, [_jax_table(vals[(0, d)])
                                            for d in range(2)])
                return merged, jsvc.allgather(32, _jax_table(vals[(0, 0)]))

            def port_rank():
                merged = tsvc.exchange(31, [_table(vals[(1, d)])
                                            for d in range(2)])
                return merged, tsvc.allgather(32, _table(vals[(1, 1)]))

            (jm, jg), (tm, tg) = _run_ranks([jax_rank, port_rank], 60)
        finally:
            jsvc.stop()
            tsvc.stop()
            jkudo.set_crc_enabled(prior)
        # each side merges the concatenation in source-rank order; both
        # sides' allgathers are the same table
        from spark_rapids_tpu_torch.ops.copying import concat_tables

        def both(a, b):
            return concat_tables([_table(vals[a]), _table(vals[b])])

        assert table_parts(jm) == table_parts(both((0, 0), (1, 0)))
        assert table_parts(tm) == table_parts(both((0, 1), (1, 1)))
        gathered = both((0, 0), (1, 1))
        assert table_parts(jg) == table_parts(tg) == table_parts(gathered)


# ------------------------------------------------- distributed queries


def _query_pair(tmp_path, fn, prefix="q"):
    svcs = _services(tmp_path, 2, prefix)
    try:
        return _run_ranks([lambda r=r: fn(svcs[r]) for r in range(2)])
    finally:
        for s in svcs:
            s.stop()


def _same(got, want, keys):
    for k in keys:
        assert got[k].tobytes() == np.asarray(want[k]).tobytes(), k


class TestDistributedQueries:

    def test_q5_two_ranks_byte_equal_jax_single(self, tmp_path, crc_on,
                                                op_by_op):
        from spark_rapids_tpu.distributed import runner as JR
        from spark_rapids_tpu_torch.distributed import runner as R
        params = dict(rows=1024, join_capacity=1 << 12)
        outs = _query_pair(tmp_path, lambda s: R.run_dist_q5(
            params, transport=s, device="cpu"))
        ref = JR.single_q5(dict(params, world=2))
        for r in range(2):
            _same(outs[r], ref, ("key", "sales", "rets", "profit"))
            assert bool(outs[r]["overflow"]) == bool(ref["overflow"])
        _same(R.single_q5(dict(params, world=2), device="cpu"), ref,
              ("key", "sales", "rets", "profit", "overflow"))

    def test_q72_two_ranks_under_corrupt_link(self, tmp_path, crc_on,
                                              op_by_op):
        from spark_rapids_tpu.distributed import runner as JR
        from spark_rapids_tpu_torch.distributed import runner as R
        from spark_rapids_tpu_torch.distributed import transport as TR
        params = dict(cs_rows=1024, join_capacity=1 << 15)
        TR.reset_stats()
        TR.set_link_fault("corrupt", 0, R.OpIds.Q72_REDUCE_SCATTER)
        try:
            outs = _query_pair(tmp_path, lambda s: R.run_dist_q72(
                params, transport=s, device="cpu"))
        finally:
            TR.clear_link_faults()
        assert TR.STATS["naks_sent"] == 1 and TR.STATS["resends"] == 1
        ref = JR.single_q72(dict(params, world=2))
        for r in range(2):
            _same(outs[r], ref, ("item", "week", "cnt"))
        _same(R.single_q72(dict(params, world=2), device="cpu"), ref,
              ("item", "week", "cnt", "overflow"))

    def test_dist_query_world1_loopback(self, crc_on, op_by_op):
        """The same runner code on the default in-process transport
        (world=1): the degenerate chunking path."""
        from spark_rapids_tpu.distributed import runner as JR
        from spark_rapids_tpu_torch.distributed import runner as R
        from spark_rapids_tpu_torch.parallel import exchange as X
        X.set_table_transport(None)
        params = dict(rows=512, join_capacity=1 << 11)
        got = R.run_dist_q5(params, device="cpu")
        _same(got, JR.single_q5(params), ("key", "sales", "rets", "profit"))
        assert set(R.LAST_TIMES["q5"]) == {"partials_ms", "exchange_ms"}


# ------------------------------------------- worker processes, the group


def test_launch_two_cpu_workers(tmp_path):
    """The launcher with two worker processes on the CPU at Q5_PARAMS:
    both ranks' results byte-equal to the JAX single-process q5, every
    summary complete (the launch's own time limit is 120 s)."""
    from spark_rapids_tpu.distributed import runner as JR
    from spark_rapids_tpu_torch.distributed import launcher as DL
    res = DL.launch(2, str(tmp_path), ops=("q5",), device="cpu",
                    worker_env={"SPARK_RAPIDS_TPU_STAGE_FUSION": "0"},
                    timeout_s=120.0)
    ref = JR.single_q5({"world": 2})
    for r in range(2):
        got = dict(np.load(os.path.join(str(tmp_path),
                                        f"result_q5_rank{r}.npz")))
        _same(got, ref, ("key", "sales", "rets", "profit"))
        s = res["summaries"][r]
        assert s["rc"] == 0 and s["device"] == "cpu"
        assert s["mesh"]["mode"] == "harness"
        assert s["link"]["frames_sent"] == s["link"]["frames_recv"] == 3
        assert s["t_ready"] >= res["spawned"][r][0]
    assert res["deaths"] == [] and res["wall_s"] > 0


def test_launch_dumps_per_rank_observability_under_one_trace(tmp_path):
    """Workers run with metrics and tracing on, as the JAX worker does:
    each rank dumps its spans, metrics and journal beside its summary;
    every span of every rank carries the launcher's trace id and
    descends from the launcher's root; the link byte counters equal the
    bytes the summaries count."""
    from spark_rapids_tpu_torch.distributed import launcher as DL
    out = str(tmp_path)
    res = DL.launch(2, out, ops=("q5",), device="cpu",
                    worker_env={"SPARK_RAPIDS_TPU_STAGE_FUSION": "0"},
                    timeout_s=120.0)
    trace = res["trace_id"]
    files = DL.span_files(out, 2)
    assert [os.path.basename(f) for f in files] == [
        "spans_launcher.jsonl", "spans_rank0.jsonl", "spans_rank1.jsonl"]
    spans = {}
    for f in files:
        with open(f) as fh:
            for line in fh:
                rec = json.loads(line)
                assert rec["trace_id"] == trace, f
                spans[rec["span_id"]] = rec
    (root,) = [r for r in spans.values() if r["parent_id"] is None]
    assert root["name"] == "dist_query" and root["span_kind"] == "query"
    for rec in spans.values():       # one connected tree
        hops = 0
        while rec["parent_id"] is not None:
            rec = spans[rec["parent_id"]]
            hops += 1
            assert hops < 64
        assert rec is root
    names = {r["name"] for r in spans.values()}
    assert {"dist_worker", "dist_q5", "shuffle_exchange", "shuffle_send",
            "kudo_write", "kudo_merge"} <= names
    for r in range(2):
        s = res["summaries"][r]
        with open(os.path.join(out, f"metrics_rank{r}.json")) as fh:
            reg = json.load(fh)
        link = {(x["labels"][0], x["labels"][1]): x["value"]
                for x in reg["srt_shuffle_link_bytes_total"]["series"]}
        assert link[("send", str(1 - r))] == s["link"]["bytes_sent"]
        assert link[("recv", str(1 - r))] == s["link"]["bytes_recv"]
        msgs = {tuple(x["labels"]): x["value"]
                for x in reg["srt_shuffle_link_msgs_total"]["series"]}
        assert msgs[("send", str(1 - r))] == s["link"]["frames_sent"]
        with open(os.path.join(out, f"journal_rank{r}.jsonl")) as fh:
            kinds = [json.loads(line)["kind"] for line in fh]
        assert kinds[-1] == "registry_snapshot"
        assert {"shuffle_link", "shuffle_write", "shuffle_merge",
                "span"} <= set(kinds)


def test_launch_fast_fails_on_boot_death(tmp_path):
    """A worker dying at boot fails the fleet at once with its code."""
    from spark_rapids_tpu_torch.distributed import launcher as DL
    with pytest.raises(DL.WorkerFailed) as ei:
        DL.launch(2, str(tmp_path), ops=("q5",), device="cpu",
                  die="boot:9", die_rank=1, timeout_s=60.0)
    assert ei.value.rank == 1 and ei.value.rc == 9


def test_group_attempt_never_raises():
    """The port runs in the process-per-shard harness: whatever it is
    given, try_form_mesh reports harness mode and this process's CUDA
    devices (none here)."""
    from spark_rapids_tpu_torch.distributed import mesh as M
    assert M.mesh_mode() == "harness"
    for kw in ({}, {"coordinator": "localhost:1", "timeout_s": 1.0}):
        got = M.try_form_mesh(1, 2, **kw)
        assert got["mode"] == "harness" and got["local_devices"] == 0


# ------------------------------------------------------------ import rule

NEW_MODULES = ("ops/protobuf.py", "ops/protobuf_device.py",
               "shuffle/socket_io.py", "robustness/links.py",
               "robustness/fleet.py", "distributed/__init__.py",
               "distributed/transport.py", "distributed/service.py",
               "distributed/mesh.py", "distributed/runner.py",
               "distributed/launcher.py", "analysis/__init__.py",
               "analysis/lockdep.py", "observability/__init__.py",
               "observability/dumpio.py", "observability/journal.py",
               "observability/registry.py",
               "observability/task_metrics.py",
               "observability/tracing.py", "utils/telemetry.py")


@pytest.mark.parametrize("path", NEW_MODULES)
def test_new_module_imports_no_jax(path):
    """Each module of the slice imports torch-side code only: no `jax`
    and nothing of the JAX package, at any depth of its source."""
    src = open(os.path.join(REPO, "spark_rapids_tpu_torch", path)).read()
    for node in ast.walk(ast.parse(src)):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for n in names:
            root = n.split(".")[0]
            assert root not in ("jax", "jaxlib", "spark_rapids_tpu"), \
                (path, n)


def test_slice_imports_without_jax():
    code = ("import sys; import spark_rapids_tpu_torch.distributed, "
            "spark_rapids_tpu_torch.distributed.runner, "
            "spark_rapids_tpu_torch.distributed.launcher, "
            "spark_rapids_tpu_torch.ops.protobuf, "
            "spark_rapids_tpu_torch.ops.protobuf_device; "
            "assert 'jax' not in sys.modules, 'jax imported'")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)
