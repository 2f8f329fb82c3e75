"""The port's elastic fleet (robustness/fleet.py, the elastic half of
distributed/transport.py and distributed/service.py, the launcher's
babysitter) on tests/test_elastic_fleet.py's cases: membership policy
and epoch fencing, (op, part) dedup of duplicated speculative winners,
the drop/slow chaos modes, death -> rebalance, straggler -> speculation
(win AND cancel), skew -> re-split, the membership-tolerant barrier
with a graceful leave, and the launcher's fast-fail and respawn.
Deterministic observations (assignments, speculators, epochs, views,
speculation and skew verdicts, membership records) are compared with
the JAX package's classes on the same inputs.  The JAX tests' metrics
report and doctor cases are A14 tools and stay there.
"""

import io
import json
import os
import struct
import threading
import time

import pytest
import torch

from spark_rapids_tpu_torch.columns import dtypes
from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.columns.table import Table
from spark_rapids_tpu_torch.robustness.fleet import (
    ElasticFleet, ElasticPolicy, StaleEpochError, robust_z)
from spark_rapids_tpu_torch.robustness.retry import RetryPolicy
from spark_rapids_tpu_torch.shuffle import kudo
from spark_rapids_tpu_torch.shuffle.schema import schema_of_table


@pytest.fixture
def crc_on():
    prior = kudo.set_crc_enabled(True)
    yield
    kudo.set_crc_enabled(prior)


@pytest.fixture
def stats():
    from spark_rapids_tpu_torch.distributed import transport as TR
    TR.reset_stats()
    yield TR.STATS


FAST = RetryPolicy(max_attempts=2, base_backoff_s=0.01,
                   max_backoff_s=0.05, deadline_s=5.0)


def mk(vals):
    return Table([Column(dtypes.INT64, len(vals), data=torch.tensor(
        vals, dtype=torch.int64))])


def col0(tables):
    merged = kudo.merge_to_table(tables, schema_of_table(mk([0])),
                                 device="cpu")
    return merged.columns[0].data.tolist()


def payload_of(t):
    buf = io.BytesIO()
    kudo.write_to_stream(t.columns, buf, 0, t.num_rows)
    return buf.getvalue()


def _services(tmp_path, world, *, live=None, fleets=None, **kw):
    from spark_rapids_tpu_torch.distributed.service import ShuffleService
    addrs = [f"unix:{os.path.join(str(tmp_path), f'e{r}.sock')}"
             for r in range(world)]
    svcs = []
    for r in range(world):
        fleet = fleets[r] if fleets else None
        s = ShuffleService(r, world, addrs, elastic=True,
                           policy=FAST, fleet=fleet, **kw)
        if live is None or r in live:
            s.start()
        svcs.append(s)
    return svcs


def _run(fns, timeout=60):
    errs = []

    def wrap(fn):
        try:
            fn()
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    ts = [threading.Thread(target=wrap, args=(f,)) for f in fns]
    [t.start() for t in ts]
    [t.join(timeout) for t in ts]
    assert not errs, errs


def events_of(svcs, kind):
    return [e for s in svcs for e in s.events if e["kind"] == kind]


# ------------------------------------------------------------- policy


def jax_fleet(*a, **kw):
    from spark_rapids_tpu.robustness.fleet import ElasticFleet as JFleet
    return JFleet(*a, **kw)


class TestElasticPolicy:

    def test_assign_identity_when_all_live(self):
        assert ElasticPolicy().assign(4, set()) == (0, 1, 2, 3)

    @pytest.mark.parametrize("world,dead", [
        (4, {1}), (4, {1, 2}), (4, {0, 2}), (6, {2}), (6, {0, 3}),
        (6, {1, 2, 3}), (3, {0, 1, 2})])
    def test_assign_equals_jax(self, world, dead):
        from spark_rapids_tpu.robustness.fleet import ElasticPolicy as JP
        assert ElasticPolicy().assign(world, dead) == \
            JP().assign(world, dead)

    def test_assign_dead_goes_to_least_loaded_lowest_rank(self):
        p = ElasticPolicy()
        assert p.assign(4, {1}) == (0, 0, 2, 3)
        assert p.assign(4, {1, 2}) == (0, 0, 3, 3)
        assert p.assign(4, {0, 2}) == (1, 1, 3, 3)

    def test_speculator_least_loaded_excludes_owner(self):
        for F in (ElasticFleet, jax_fleet):
            fleet = F(0, 4)
            view = fleet.view()
            assert fleet.policy.speculator(view, 1) == 0
            assert fleet.policy.speculator(view, 0) == 1
            fleet.note_death([3])  # rank 0 inherits shard 3 (load 2)
            view = fleet.view()
            assert fleet.policy.speculator(view, 1) == 2

    def test_membership_epoch_and_moves_equal_jax(self):
        from spark_rapids_tpu import observability as obs
        obs.enable()
        obs.reset()
        try:
            fleets = (ElasticFleet(0, 4), jax_fleet(0, 4))
            for fleet in fleets:
                assert fleet.epoch == 0
                assert fleet.note_death([2])
                assert fleet.epoch == 1
                assert fleet.view().owner(2) == 0
                assert not fleet.note_death([2])  # idempotent
                assert fleet.note_join(2)
                v = fleet.view()
                assert 2 in v.live and v.owner(2) == 0  # no churn-back
                assert fleet.note_leave(1)
            jax_ev = [r for r in obs.JOURNAL.records()
                      if r.get("kind") == "fleet_membership"]
        finally:
            obs.disable()
        assert fleets[0].view().to_dict() == fleets[1].view().to_dict()
        keys = ("change", "dead", "epoch", "live")
        assert [{k: e.get(k) for k in keys} for e in fleets[0].events] \
            == [{k: e.get(k) for k in keys} for e in jax_ev]
        assert fleets[0].events[0]["moved"] == {2: 0}
        assert jax_ev[0]["moved"] == {"2": 0}

    def test_never_marks_self_dead(self):
        fleet = ElasticFleet(1, 3)
        assert not fleet.note_death([1])
        assert 1 in fleet.view().live

    def test_leave_is_departure(self):
        fleet = ElasticFleet(0, 3)
        assert fleet.note_leave(2)
        assert 2 in fleet.view().departed
        assert fleet.left == {2}
        assert fleet.events[-1]["change"] == "leave"
        assert fleet.note_join(2) and fleet.left == frozenset()

    def test_learn_epoch_only_fast_forwards(self):
        fleet = ElasticFleet(0, 2)
        fleet.learn_epoch(5)
        assert fleet.epoch == 5
        fleet.learn_epoch(3)
        assert fleet.epoch == 5
        assert fleet.is_stale(4) and not fleet.is_stale(5)

    def test_should_speculate_floor_and_z_equal_jax(self):
        fleets = [F(0, 4, spec_delay_s=1.0, min_arrivals=3)
                  for F in (ElasticFleet, jax_fleet)]
        for fleet in fleets:
            assert fleet.should_speculate(9, int(0.5e9)) is None
            ev = fleet.should_speculate(9, int(1.5e9))
            assert ev and ev["reason"] == "delay_floor"
            for src in range(3):
                fleet.note_arrival(9, src, src, 10_000_000)  # 10ms each
        got = [f.should_speculate(9, int(0.5e9)) for f in fleets]
        assert got[0] == got[1] and got[0]["reason"] == "robust_z"

    def test_robust_z_equals_jax(self):
        from spark_rapids_tpu.observability.anomaly import robust_z as jz
        for v, xs in ((5.0, [1, 2, 3]), (1e9, [1e7] * 4), (0.0, []),
                      (7.5, [1.0, 9.0, 3.0, 4.0]), (2.0, [2.0])):
            assert robust_z(v, xs) == jz(v, xs)

    def test_hot_part_needs_history_equal_jax(self):
        for fleet in (ElasticFleet(0, 2, skew_ratio=3.0),
                      jax_fleet(0, 2, skew_ratio=3.0)):
            assert fleet.hot_part(7, 1 << 20) is None  # no history
            fleet.note_part_bytes(7, 1000)
            fleet.note_part_bytes(7, 1200)
            hot = fleet.hot_part(7, 50_000)
            assert hot == {"median_bytes": 1200, "bytes": 50_000,
                           "ratio": 41.67}
            assert fleet.hot_part(7, 2000) is None

    def test_link_skew(self):
        fleet = ElasticFleet(0, 3)
        got = fleet.link_skew({("recv", 1): 9000, ("recv", 2): 1000,
                               ("send", 1): 500})
        assert got["skew_ratio"] == 9.0
        assert got["deltas"] == {"recv:1": 9000.0, "recv:2": 1000.0,
                                 "send:1": 500.0}
        again = fleet.link_skew({("recv", 1): 9000, ("recv", 2): 3000})
        assert again["deltas"]["recv:2"] == 2000.0


# ------------------------------------------------- frames + part inbox


class TestWire:

    def test_resplit_field_roundtrip(self):
        from spark_rapids_tpu_torch.distributed.transport import (
            pack_resplit, unpack_resplit)
        f = pack_resplit(300, 2, 5)
        assert unpack_resplit(f) == (300, 2, 5)
        assert unpack_resplit(300) is None
        with pytest.raises(ValueError):
            pack_resplit(300, 5, 5)  # k must be < nsub

    def test_part_inbox_first_copy_wins(self):
        from spark_rapids_tpu_torch.distributed.transport import PartInbox
        pi = PartInbox()
        assert pi.put(1, 0, ["t"], b"abc") == "new"
        assert pi.put(1, 0, ["u"], b"abc") == "dup_identical"
        assert pi.put(1, 0, ["v"], b"xyz") == "dup_mismatch"
        assert pi.get(1) == {0: ["t"]}

    def test_part_inbox_sub_assembly_in_order(self):
        from spark_rapids_tpu_torch.distributed.transport import PartInbox
        pi = PartInbox()
        assert pi.put_sub(1, 4, 1, 2, ["b"], b"B") == "sub"
        assert pi.put_sub(1, 4, 1, 2, ["b"], b"B") == "dup_identical"
        assert pi.put_sub(1, 4, 1, 2, ["x"], b"X") == "dup_mismatch"
        assert pi.put_sub(1, 4, 0, 2, ["a"], b"A") == "new"
        assert pi.get(1)[4] == ["a", "b"]
        assert pi.payloads(1)[4] == b"AB"
        assert pi.put(1, 4, ["ab"], b"whole") == "dup_framing"
        assert pi.put_sub(1, 4, 0, 2, ["a"], b"A") == "dup_framing"

    def test_part_inbox_bounds_ops(self):
        from spark_rapids_tpu_torch.distributed.transport import PartInbox
        pi = PartInbox()
        for op in range(PartInbox.MAX_OPS + 4):
            pi.put(op, 0, ["t"], b"x")
        assert pi.have(0) == set()          # oldest evicted
        assert pi.have(PartInbox.MAX_OPS + 3) == {0}

    def test_drop_fault_forges_success(self, tmp_path, crc_on):
        from spark_rapids_tpu_torch.distributed import transport as TR
        from spark_rapids_tpu_torch.robustness.links import \
            PeerDiedException
        inbox = TR.Inbox()
        listener = TR.Listener(
            0, f"unix:{os.path.join(str(tmp_path), 'd.sock')}",
            inbox).start()
        link = TR.PeerLink(1, 0, listener.addr, policy=FAST)
        try:
            TR.set_link_fault("drop", 0, 33)
            payload = payload_of(mk([1, 2, 3]))
            assert link.send(33, payload) == len(payload)  # sender's view
            with pytest.raises(PeerDiedException):
                inbox.wait(33, [1], timeout_s=0.3)  # receiver never saw
        finally:
            TR.clear_link_faults()
            link.close()
            listener.stop()

    def test_slow_fault_delays_each_frame(self, tmp_path, crc_on):
        from spark_rapids_tpu_torch.distributed import transport as TR
        inbox = TR.Inbox()
        listener = TR.Listener(
            0, f"unix:{os.path.join(str(tmp_path), 's.sock')}",
            inbox).start()
        link = TR.PeerLink(1, 0, listener.addr, policy=FAST)
        try:
            TR.set_link_fault("slow", 0, 300)
            t0 = time.monotonic()
            link.send(44, payload_of(mk([1])))
            assert time.monotonic() - t0 >= 0.3
        finally:
            TR.clear_link_faults()
            link.close()
            listener.stop()

    def test_stale_epoch_fenced_with_E(self, tmp_path, crc_on, stats):
        """A frame carrying an old epoch is answered E + the receiver's
        epoch, surfaced typed, and never merged."""
        svcs = _services(tmp_path, 3, live={0})
        try:
            svcs[0].fleet.note_death([2])  # receiver is at epoch 1
            from spark_rapids_tpu_torch.distributed.transport import (
                KIND_EDATA, PeerLink)
            link = PeerLink(1, 0, svcs[0].addresses[0], policy=FAST)
            with pytest.raises(StaleEpochError) as ei:
                link.send(55, payload_of(mk([5])), kind=KIND_EDATA,
                          epoch=0, part=0)
            assert ei.value.epoch == 1
            assert svcs[0].parts.have(55) == set()
            assert stats["stale_naks"] == 1
            link.close()
        finally:
            svcs[0].stop()


# ------------------------------------------------------------- dedup


class TestSpeculativeWinnerDedup:

    def test_two_ranks_same_part_merge_exactly_once(self, tmp_path, crc_on,
                                                     stats):
        from spark_rapids_tpu_torch.distributed.transport import (
            KIND_EDATA, PeerLink)
        svcs = _services(tmp_path, 3, live={0})
        try:
            payload = payload_of(mk([7, 8, 9]))
            links = [PeerLink(src, 0, svcs[0].addresses[0], policy=FAST)
                     for src in (1, 2)]
            for link in links:
                assert link.send(66, payload, kind=KIND_EDATA,
                                 epoch=0, part=4) == len(payload)
            got = svcs[0].parts.get(66)
            assert set(got) == {4}
            assert col0(got[4]) == [7, 8, 9]
            dups = events_of(svcs[:1], "shuffle_dup_dropped")
            assert [(e["src"], e["identical"]) for e in dups] == [(2, True)]
            assert stats["dup_dropped"] == 1
            for link in links:
                link.close()
        finally:
            svcs[0].stop()

    def test_link_level_resend_is_not_a_dup(self, tmp_path, crc_on, stats):
        """An exact (src, op, seq) resend after a lost ACK re-ACKs without
        touching the dup count (link plumbing, not a speculation
        loser)."""
        import socket as _socket
        from spark_rapids_tpu_torch.distributed import transport as TR
        svcs = _services(tmp_path, 2, live={0})
        try:
            payload = payload_of(mk([1, 2]))
            head = struct.pack(TR.FRAME_FMT, TR.FRAME_MAGIC,
                               TR.KIND_EDATA, 1, 77, 9, len(payload))
            head += struct.pack(TR.EXT_FMT, 0, 0)
            fam, target = TR._parse_addr(svcs[0].addresses[0])
            s = _socket.socket(fam, _socket.SOCK_STREAM)
            s.connect(target)
            for _ in range(2):
                s.sendall(head + payload)
                assert s.recv(1) == TR.ACK
            s.close()
            assert stats["dup_dropped"] == 0
            assert not events_of(svcs[:1], "shuffle_dup_dropped")
        finally:
            svcs[0].stop()


# --------------------------------------------- elastic exchange e2e


def _broadcast_gather(svcs, op, world, ranks, mult, deadline=20, **kw):
    outs = {}

    def work(r):
        def compute(p, ctx):
            return mk([p * mult, p * mult + 1])
        svcs[r].broadcast_part(op, r, compute(r, None))
        got = svcs[r].gather_parts(op, range(world), compute=compute,
                                   deadline_s=deadline, **kw)
        outs[r] = {p: col0(t) for p, t in got.items()}

    _run([lambda r=r: work(r) for r in ranks])
    return outs


class TestElasticExchange:

    def test_broadcast_gather_converges(self, tmp_path, crc_on):
        svcs = _services(tmp_path, 2)
        try:
            outs = _broadcast_gather(svcs, 50, 2, (0, 1), 10)
        finally:
            for s in svcs:
                s.stop()
        assert outs[0] == outs[1] == {0: [0, 1], 1: [10, 11]}

    def test_dead_rank_rebalances_to_inheritor(self, tmp_path, crc_on):
        """Rank 2 never starts: survivors detect the death on their
        failed sends, gossip the membership change, and the
        fleet-assigned inheritor (rank 0) recomputes shard 2."""
        svcs = _services(tmp_path, 3, live={0, 1})
        try:
            outs = _broadcast_gather(svcs, 60, 3, (0, 1), 10, deadline=30)
        finally:
            for s in svcs[:2]:
                s.stop()
        want = {0: [0, 1], 1: [10, 11], 2: [20, 21]}
        assert outs[0] == outs[1] == want
        assert svcs[0].fleet.view().departed == {2}
        assert svcs[0].fleet.view().to_dict() == \
            svcs[1].fleet.view().to_dict()
        deaths = [e for s in svcs[:2] for e in s.fleet.events
                  if e["change"] == "death"]
        assert deaths and all(e["dead"] == [2] for e in deaths)
        inherit = events_of(svcs[:2], "fleet_inherit")
        assert [(e["part"], e["dead_owner"]) for e in inherit] == [(2, 2)]
        assert inherit[0] in svcs[0].events

    def test_straggler_speculation_wins_and_loser_dedups(
            self, tmp_path, crc_on, stats):
        from spark_rapids_tpu_torch.distributed import transport as TR
        fleets = [ElasticFleet(r, 2, spec_delay_s=0.3) for r in range(2)]
        svcs = _services(tmp_path, 2, fleets=fleets)
        try:
            TR.set_link_fault("slow", 0, 1200)  # rank1 -> rank0 slow
            outs = _broadcast_gather(svcs, 70, 2, (0, 1), 7)
        finally:
            TR.clear_link_faults()
            for s in svcs:
                s.stop()
        assert outs[0] == outs[1] == {0: [0, 1], 1: [7, 8]}
        spec = events_of(svcs, "fleet_speculation")
        assert spec and spec[0]["outcome"] == "won"
        assert spec[0]["owner"] == 1 and spec[0]["by"] == 0
        assert stats["dup_dropped"] >= 1

    def test_speculation_cancelled_when_original_arrives(self, tmp_path,
                                                         crc_on):
        """The original lands while the speculative task computes: the
        watcher trips the cancel event and the task unwinds through
        QueryContext (outcome 'cancelled')."""
        svc = _services(tmp_path, 1, live=set())[0]

        def compute(p, ctx):
            for _ in range(100):
                time.sleep(0.02)
                ctx.check_cancel()
            return mk([0])

        payload = payload_of(mk([3, 4]))

        def land_original():
            time.sleep(0.15)
            svc.parts.put(80, 0, kudo.read_tables(io.BytesIO(payload)),
                          payload)

        threading.Thread(target=land_original, daemon=True).start()
        svc._speculate(80, 0, owner=9, compute=compute,
                       evidence={"reason": "test"})
        assert [e["outcome"] for e in svc.events] == ["cancelled"]
        assert col0(svc.parts.get(80)[0]) == [3, 4]

    def test_hot_part_resplits_byte_identical(self, tmp_path, crc_on):
        fleets = [ElasticFleet(r, 2, skew_ratio=3.0) for r in range(2)]
        svcs = _services(tmp_path, 2, fleets=fleets)
        outs = {}
        try:
            def work(r):
                if r == 0:
                    svcs[r].broadcast_part(81, 0, mk([1, 2]))
                    time.sleep(0.4)  # let rank1's part seed the window
                    svcs[r].broadcast_part(81, 2, mk(list(range(4000))))
                else:
                    svcs[r].broadcast_part(81, 1, mk([3, 4]))
                got = svcs[r].gather_parts(
                    81, [0, 1, 2],
                    owner_of=lambda p: 0 if p in (0, 2) else 1,
                    deadline_s=20)
                outs[r] = {p: col0(t) for p, t in got.items()}

            _run([lambda r=r: work(r) for r in range(2)])
        finally:
            for s in svcs:
                s.stop()
        assert outs[0] == outs[1]
        assert outs[0][2] == list(range(4000))
        ev = events_of(svcs, "fleet_resplit")
        assert ev and ev[0]["nsub"] >= 2
        assert "link_skew" in ev[0]["evidence"]

    def test_elastic_barrier_with_graceful_leave(self, tmp_path, crc_on):
        """Rank 1 passes the barrier, leaves, and exits; rank 0 entering
        LATE still completes because the leave shrank its want set."""
        svcs = _services(tmp_path, 2)
        try:
            def late0():
                time.sleep(0.3)
                svcs[0].elastic_barrier(901, deadline_s=15)

            def fast1():
                svcs[1].elastic_barrier(901, deadline_s=15)
                svcs[1].leave_fleet()
                svcs[1].stop()

            t0 = time.monotonic()
            _run([late0, fast1], 30)
            assert time.monotonic() - t0 < 10
        finally:
            svcs[0].stop()

    def test_respawn_barrier_skips_ranks_that_left(self, tmp_path, crc_on,
                                                   monkeypatch):
        """With SPARK_RAPIDS_TPU_FLEET_RESPAWN=1 the barrier awaits the
        whole original world, but not a rank that left: it passed its
        own barrier (the JAX package waits out the deadline there)."""
        monkeypatch.setenv("SPARK_RAPIDS_TPU_FLEET_RESPAWN", "1")
        svcs = _services(tmp_path, 2)
        try:
            svcs[0].fleet.note_leave(1)
            t0 = time.monotonic()
            svcs[0].elastic_barrier(902, deadline_s=20)
            assert time.monotonic() - t0 < 5
        finally:
            for s in svcs:
                s.stop()

    def test_respawn_barrier_skips_a_leaver_gossiped_dead(
            self, tmp_path, crc_on, monkeypatch):
        """A rank marked dead by gossip while it was alive (slow to boot)
        and then leaving gracefully is left, not only departed: the
        respawn-mode barrier does not wait out its deadline for it."""
        monkeypatch.setenv("SPARK_RAPIDS_TPU_FLEET_RESPAWN", "1")
        svcs = _services(tmp_path, 2)
        try:
            fleet = svcs[0].fleet
            assert fleet.note_death([1])
            epoch = fleet.epoch
            assert fleet.note_leave(1) and fleet.left == {1}
            assert fleet.epoch == epoch and not fleet.note_leave(1)
            t0 = time.monotonic()
            svcs[0].elastic_barrier(903, deadline_s=20)
            assert time.monotonic() - t0 < 5
        finally:
            for s in svcs:
                s.stop()

    def test_join_from_a_rank_counted_live_records_its_death(
            self, tmp_path, crc_on):
        """Only a respawned worker joins, so a join from a new
        incarnation of a rank still counted live proves the previous
        one died unseen (the launcher respawned it before any link to
        it failed): the survivor records the death, then the join, and
        answers the joiner a view at the new epoch.  The same join
        delivered twice (a resend after a lost ACK) records one death;
        a join after a seen death records the join alone."""
        svcs = _services(tmp_path, 3)
        try:
            fleet = svcs[0].fleet
            join = json.dumps({"type": "join", "rank": 2,
                               "inc": "a1"}).encode()
            svcs[0].on_ctrl(2, 0, join)
            assert [(e["change"], e["dead"]) for e in fleet.events] == [
                ("death", [2]), ("join", [])]
            assert fleet.epoch == 2 and 2 in fleet.view().live
            assert 2 in fleet.view().departed
            svcs[0].on_ctrl(2, 0, join)
            assert [e["change"] for e in fleet.events].count("death") == 1
            assert fleet.epoch == 2 and 2 in fleet.view().live
            svcs[1].fleet.note_death([2])
            svcs[1].on_ctrl(2, 0, join)
            assert [(e["change"], e["dead"]) for e in
                    svcs[1].fleet.events] == [("death", [2]), ("join", [])]
            assert svcs[1].fleet.epoch == 2
        finally:
            for s in svcs:
                s.stop()

    def test_join_without_an_incarnation_records_no_death(
            self, tmp_path, crc_on):
        """A join that names no incarnation (the JAX service's form)
        cannot be told from a resend, so it records the join alone, as
        the JAX service does."""
        svcs = _services(tmp_path, 3)
        try:
            fleet = svcs[0].fleet
            join = json.dumps({"type": "join", "rank": 2}).encode()
            svcs[0].on_ctrl(2, 0, join)
            svcs[0].on_ctrl(2, 0, join)
            assert fleet.events == []
            assert fleet.epoch == 0 and 2 in fleet.view().live
        finally:
            for s in svcs:
                s.stop()

    def test_elastic_q5_loopback_degenerates(self, crc_on, monkeypatch):
        from spark_rapids_tpu.distributed import runner as JR
        from spark_rapids_tpu_torch.distributed import runner as R
        from spark_rapids_tpu_torch.parallel import exchange as X
        monkeypatch.setenv("SPARK_RAPIDS_TPU_STAGE_FUSION", "0")
        X.set_table_transport(None)
        params = dict(rows=512, join_capacity=1 << 11)
        got = R.run_elastic_q5(params, device="cpu")
        ref = JR.single_q5(params)
        for k in ("key", "sales", "rets", "profit"):
            assert got[k].tobytes() == ref[k].tobytes(), k

    @pytest.mark.slow  # the JAX test's mark
    def test_elastic_q5_two_ranks_byte_identical(self, tmp_path, crc_on,
                                                 monkeypatch):
        from spark_rapids_tpu.distributed import runner as JR
        from spark_rapids_tpu_torch.distributed import runner as R
        monkeypatch.setenv("SPARK_RAPIDS_TPU_STAGE_FUSION", "0")
        svcs = _services(tmp_path, 2)
        params = dict(rows=1024, join_capacity=1 << 12)
        outs = [None, None]
        try:
            def work(r):
                outs[r] = R.run_elastic_q5(params, transport=svcs[r],
                                           device="cpu")
            _run([lambda r=r: work(r) for r in range(2)], 120)
        finally:
            for s in svcs:
                s.stop()
        ref = JR.single_q5(dict(params, world=2))
        for r in range(2):
            for k in ("key", "sales", "rets", "profit"):
                assert outs[r][k].tobytes() == ref[k].tobytes(), (r, k)


# ----------------------------------------------------- launcher logic


class _StubProc:
    def __init__(self, exits_after=0.0, rc=0):
        self._t0 = time.monotonic()
        self._exits_after = exits_after
        self._rc = rc
        self.killed = False

    def poll(self):
        if self.killed:
            return -9
        if time.monotonic() - self._t0 >= self._exits_after:
            return self._rc
        return None

    def kill(self):
        self.killed = True

    def wait(self, timeout=None):
        return self.poll() if self.poll() is not None else 0


class TestBabysitter:

    def test_nonzero_exit_kills_fleet_and_propagates_immediately(self):
        from spark_rapids_tpu_torch.distributed.launcher import (
            WorkerFailed, babysit)
        bad = _StubProc(exits_after=0.0, rc=7)
        slow = _StubProc(exits_after=60.0, rc=0)
        t0 = time.monotonic()
        with pytest.raises(WorkerFailed) as ei:
            babysit({0: slow, 1: bad}, timeout_s=30.0, poll_s=0.01)
        assert ei.value.rank == 1 and ei.value.rc == 7
        assert time.monotonic() - t0 < 5.0  # no deadline ride-out
        assert slow.killed  # survivors are reaped

    def test_on_death_respawn_keeps_fleet_alive(self):
        from spark_rapids_tpu_torch.distributed.launcher import babysit
        bad = _StubProc(exits_after=0.0, rc=13)
        ok = _StubProc(exits_after=0.1, rc=0)
        seen = []

        def on_death(rank, rc):
            seen.append((rank, rc))
            return _StubProc(exits_after=0.05, rc=0)

        babysit({0: ok, 1: bad}, timeout_s=10.0, poll_s=0.01,
                on_death=on_death)
        assert seen == [(1, 13)]

    def test_timeout_kills_and_raises(self):
        from spark_rapids_tpu_torch.distributed.launcher import (
            WorkerFailed, babysit)
        hung = _StubProc(exits_after=60.0, rc=0)
        with pytest.raises(WorkerFailed) as ei:
            babysit({0: hung}, timeout_s=0.1, poll_s=0.01)
        assert ei.value.rc is None
        assert hung.killed

    def test_deferred_spawn_materializes_after_delay(self):
        from spark_rapids_tpu_torch.distributed.launcher import \
            _DeferredSpawn
        made = []

        def factory():
            made.append(1)
            return _StubProc(exits_after=0.0, rc=0)

        d = _DeferredSpawn(0.1, factory)
        assert d.poll() is None and not made
        time.sleep(0.12)
        assert d.poll() == 0 and made == [1]

    def test_deferred_spawn_kill_cancels_pending(self):
        from spark_rapids_tpu_torch.distributed.launcher import \
            _DeferredSpawn
        d = _DeferredSpawn(0.05, lambda: _StubProc())
        d.kill()
        time.sleep(0.1)
        assert d.poll() is None  # never materialized

    def test_elastic_launch_respawns_a_dead_rank(self, tmp_path):
        """Three CPU workers on the elastic protocol; rank 2 dies after
        its partials and is respawned once: every rank's q5 byte-equal to
        the JAX single-process q5, the death and the inheritor recorded."""
        import numpy as np
        from spark_rapids_tpu.distributed import runner as JR
        from spark_rapids_tpu_torch.distributed import launcher as DL
        res = DL.launch(3, str(tmp_path), ops=("q5",), device="cpu",
                        elastic=True, die="q5:partials", die_rank=2,
                        respawn=True, respawn_delay_s=1.0,
                        worker_env={"SPARK_RAPIDS_TPU_STAGE_FUSION": "0"},
                        timeout_s=120.0)
        ref = JR.single_q5({"world": 3})
        for r in range(3):
            got = dict(np.load(os.path.join(str(tmp_path),
                                            f"result_q5_rank{r}.npz")))
            for k in ("key", "sales", "rets", "profit"):
                assert got[k].tobytes() == ref[k].tobytes(), (r, k)
        assert [(d["rank"], d["rc"]) for d in res["deaths"]] == [(2, 13)]
        assert res["summaries"][2]["respawned"]
        survivors = res["summaries"][:2]
        assert any(e["change"] == "death" and e["dead"] == [2]
                   for s in survivors for e in s["fleet_events"])
        assert any(e["kind"] in ("fleet_inherit", "fleet_speculation")
                   and e["part"] == 2
                   for s in survivors for e in s["service_events"])
        assert res["wall_s"] < 60
