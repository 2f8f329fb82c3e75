"""Elastic-fleet policy: who inherits a dead rank's work, who
speculates for a straggler, when a hot partition re-splits, and the
epoch fence that keeps stale peers out.

A fixed-N world turns a dead peer into a terminal
``PeerDiedException`` and lets a slow rank stall every exchange
barrier.  This module is the judgement layer that turns those events
into *policy*:

  * :class:`FleetView`: an EPOCH-STAMPED membership snapshot, the live
    set, the departed set, and a deterministic shard assignment.  The
    assignment is a pure function of ``(world0, departed)``: every
    survivor that agrees on who is dead agrees on who inherits WITHOUT
    a consensus round (int64 partials are order-independent and
    recomputes are seeded-deterministic, so any agreeing subset
    converges to the same bytes).
  * :class:`ElasticPolicy`: the choices.  A dead rank's shards go to
    the least-loaded survivors (ties to the lowest rank); the
    speculator for a straggling shard is the least-loaded live rank
    that is not the flagged owner; a partition re-splits when its
    payload dwarfs the median of its op's other partitions.
  * :class:`ElasticFleet`: one per worker.  Tracks membership + epoch,
    feeds per-stage wall times and part arrival gaps into the
    flight-recorder :class:`~spark_rapids_tpu_torch.observability.
    anomaly.StragglerDetector`, decides speculation (robust-z over the
    arrival window, with a wall-clock floor so a cold window still
    speculates) and keeps every membership change in ``events``.

Membership changes and the epoch go to the observability spine
(``srt_fleet_epoch``, ``srt_fleet_*`` counters, ``fleet_membership``
journal events, ``fleet_straggler`` for a detector outlier), and a
death freezes a ``fleet_incident`` flight-recorder bundle.

Epoch fencing: every elastic frame carries the sender's epoch; a
receiver ahead of the sender answers the ``E`` verdict (stale-epoch
NAK) instead of merging, so a zombie rank that everyone rebalanced away
from cannot push partitions into a round that already reassigned its
work.  The zombie learns the current epoch from the verdict and must
re-join before it is merged again.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

from spark_rapids_tpu_torch import observability as _obs
from spark_rapids_tpu_torch.observability.anomaly import (  # noqa: F401
    StragglerDetector, robust_z)


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


class StaleEpochError(RuntimeError):
    """A peer fenced our frame: its membership epoch is ahead of ours
    (``E`` verdict).  Carries the peer's epoch so the sender can
    fast-forward its view and replay under the current epoch instead
    of burning its resend budget on frames that will never merge."""

    def __init__(self, peer, epoch: int):
        self.peer = str(peer)
        self.epoch = int(epoch)
        super().__init__(
            f"peer {peer} fenced a stale-epoch frame (peer epoch "
            f"{epoch})")


class FleetView:
    """Immutable epoch-stamped membership + shard-assignment
    snapshot."""

    __slots__ = ("epoch", "world0", "live", "departed", "assignment")

    def __init__(self, epoch: int, world0: int, live, departed,
                 assignment: Tuple[int, ...]):
        self.epoch = int(epoch)
        self.world0 = int(world0)
        self.live = frozenset(int(r) for r in live)
        self.departed = frozenset(int(r) for r in departed)
        self.assignment = tuple(int(r) for r in assignment)

    def owner(self, shard: int) -> int:
        return self.assignment[shard]

    def shards_of(self, rank: int) -> List[int]:
        return [s for s, r in enumerate(self.assignment) if r == rank]

    def loads(self) -> Dict[int, int]:
        out = {r: 0 for r in self.live}
        for r in self.assignment:
            if r in out:
                out[r] += 1
        return out

    def to_dict(self) -> dict:
        return {"epoch": self.epoch, "world0": self.world0,
                "live": sorted(self.live),
                "departed": sorted(self.departed),
                "assignment": list(self.assignment)}


class ElasticPolicy:
    """The fleet's deterministic choices.  Pure functions of a view (no
    clocks, no randomness), so every rank computing a decision from the
    same membership facts reaches the same answer."""

    def assign(self, world0: int, departed) -> Tuple[int, ...]:
        """Shard -> owner.  Shard ``i`` starts on rank ``i``; each
        departed rank's shards move to the least-loaded survivor (ties
        to the lowest rank), dead shards reassigned in index order so
        the walk is reproducible everywhere."""
        dead = set(int(r) for r in departed)
        survivors = [r for r in range(world0) if r not in dead]
        if not survivors:
            return tuple(range(world0))  # nobody left to inherit
        load = {r: 1 for r in survivors}
        assignment = list(range(world0))
        for shard in range(world0):
            if shard in dead:
                heir = min(survivors, key=lambda r: (load[r], r))
                assignment[shard] = heir
                load[heir] += 1
        return tuple(assignment)

    def speculator(self, view: FleetView, owner: int) -> Optional[int]:
        """Least-loaded live rank other than the flagged owner (ties to
        the lowest rank); None when the owner is the only rank left."""
        candidates = sorted(r for r in view.live if r != owner)
        if not candidates:
            return None
        load = view.loads()
        return min(candidates, key=lambda r: (load.get(r, 0), r))

    def resplit_factor(self, view: FleetView) -> int:
        """How many sub-partitions a hot partition splits into: one per
        live rank so the whole fleet shares the hot key's bytes."""
        return max(len(view.live), 1)


class ElasticFleet:
    """Per-worker membership + elasticity brain.

    Thread-safe; the shuffle service consults it from the exchange
    thread AND the listener's handler threads (death notices, joins,
    stale-epoch checks arrive on connections)."""

    def __init__(self, rank: int, world: int, *,
                 policy: Optional[ElasticPolicy] = None,
                 detector: Optional[StragglerDetector] = None,
                 spec_delay_s: Optional[float] = None,
                 skew_ratio: Optional[float] = None,
                 min_arrivals: int = 3,
                 clock=time.monotonic):
        self.rank = int(rank)
        self.world0 = int(world)
        self.policy = policy or ElasticPolicy()
        # the flight-recorder straggler spine: per-stage wall times
        # and arrival gaps feed the SAME detector class the recorder
        # watches, so a flagged straggler is bundle-able evidence, not
        # a private heuristic (min_samples lowered: a fleet op has
        # world-1 arrivals, not 8 task repetitions)
        self.detector = detector or StragglerDetector(
            threshold=4.0, min_samples=min_arrivals, cooldown_s=5.0,
            clock=clock)
        self.spec_delay_s = (spec_delay_s if spec_delay_s is not None
                             else _env_float(
                                 "SPARK_RAPIDS_TPU_FLEET_SPEC_DELAY_S",
                                 5.0))
        self.skew_ratio = (skew_ratio if skew_ratio is not None
                           else _env_float(
                               "SPARK_RAPIDS_TPU_FLEET_SKEW_RATIO",
                               4.0))
        self.min_arrivals = int(min_arrivals)
        self.clock = clock
        self._lock = threading.Lock()
        self._epoch = 0
        self._departed: set = set()
        self._left: set = set()      # departed by a graceful leave
        self._live: set = set(range(self.world0))
        self._view: Optional[FleetView] = None
        self._arrivals: Dict[int, deque] = {}
        self._part_bytes: Dict[int, deque] = {}
        self._link_base: Dict[Tuple[str, str], float] = {}
        # membership changes, in order ({"change", "dead", "epoch",
        # "live", "moved"[, "joined"]}): the journal's
        # fleet_membership records of the journal
        self.events: List[dict] = []
        _obs.set_fleet_epoch(0)

    # ---------------------------------------------------- membership

    def view(self) -> FleetView:
        with self._lock:
            if self._view is None:
                self._view = FleetView(
                    self._epoch, self.world0, self._live,
                    self._departed,
                    self.policy.assign(self.world0, self._departed))
            return self._view

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    def _record(self, change: str, **detail) -> None:
        with self._lock:
            self.events.append(dict(change=change, **detail))

    def note_death(self, ranks: Iterable[int],
                   epoch_hint: int = 0) -> bool:
        """Fold newly-observed dead ranks into the view.  Returns True
        when membership actually changed (the caller then gossips a
        death notice so every survivor converges without waiting out
        its own timeout).  Epoch = max(local+1, peer hint) so relayed
        notices can never rewind the fence."""
        with self._lock:
            # a rank never marks ITSELF departed: a respawned worker
            # receiving the survivors' view (which lists its previous
            # incarnation as dead) must stay live: it recomputes its
            # old shards and the (op, part) dedup collapses them
            # against the inheritor's byte-identical copies
            new = (set(int(r) for r in ranks) - self._departed
                   - {self.rank})
            if not new:
                if epoch_hint > self._epoch:
                    self._epoch = int(epoch_hint)
                    self._view = None
                    _obs.set_fleet_epoch(self._epoch)
                return False
            before = self.policy.assign(self.world0, self._departed)
            self._departed |= new
            self._live -= new
            self._epoch = max(self._epoch + 1, int(epoch_hint))
            self._view = None
            after = self.policy.assign(self.world0, self._departed)
            epoch = self._epoch
            live = sorted(self._live)
        moved = {s: after[s] for s in range(self.world0)
                 if after[s] != before[s]}
        _obs.record_fleet_membership(
            "death", dead=sorted(new), epoch=epoch,
            live=live, moved=moved)
        _obs.FLIGHT.trigger(
            "fleet_incident", severity="warn", rank=self.rank,
            change="death", dead=sorted(new), epoch=epoch,
            shards_moved=moved, live=live)
        self._record("death", dead=sorted(new), epoch=epoch, live=live,
                     moved=moved)
        return True

    def note_leave(self, rank: int) -> bool:
        """A peer announced a GRACEFUL departure (teardown after its
        work completed): same membership consequences as a death
        (departed set, epoch bump, assignment) but recorded as a
        'leave'.  A waiter blocked on the leaver's barrier sentinel
        unblocks: the leave proves the peer passed its own barrier.

        A leave from a rank already departed (one a peer's gossip
        declared dead while it was alive, e.g. slow to boot) still
        records it as left, so a respawn-mode barrier stops waiting for
        its sentinel; the membership is unchanged.  The JAX package
        drops such a leave."""
        rank = int(rank)
        with self._lock:
            if rank == self.rank or rank in self._left:
                return False
            if rank in self._departed:
                self._left.add(rank)
                return True
            before = self.policy.assign(self.world0, self._departed)
            self._departed.add(rank)
            self._left.add(rank)
            self._live.discard(rank)
            self._epoch += 1
            self._view = None
            after = self.policy.assign(self.world0, self._departed)
            epoch = self._epoch
            live = sorted(self._live)
        moved = {s: after[s] for s in range(self.world0)
                 if after[s] != before[s]}
        _obs.record_fleet_membership("leave", dead=[rank],
                                     epoch=epoch, live=live,
                                     moved=moved)
        self._record("leave", dead=[rank], epoch=epoch, live=live,
                     moved=moved)
        return True

    def note_join(self, rank: int) -> bool:
        """A (re)joining worker: live again for barriers and FUTURE
        work, but the shard assignment keeps riding the departed set:
        mid-query ownership must not churn back under a round that
        already rebalanced away from it."""
        rank = int(rank)
        with self._lock:
            if rank in self._live:
                return False
            self._live.add(rank)
            self._left.discard(rank)
            self._epoch += 1
            self._view = None
            epoch = self._epoch
            live = sorted(self._live)
        _obs.record_fleet_membership("join", dead=[], epoch=epoch,
                                     live=live, joined=rank)
        self._record("join", dead=[], epoch=epoch, live=live,
                     joined=rank)
        return True

    @property
    def left(self) -> frozenset:
        """Ranks departed by a graceful leave (and not back since)."""
        with self._lock:
            return frozenset(self._left)

    def learn_epoch(self, epoch: int) -> None:
        """Fast-forward the fence after a stale-epoch (``E``) verdict
        or a peer's view notice.  Membership facts arrive separately
        (death notices); the epoch alone fences our outbound frames."""
        with self._lock:
            if int(epoch) > self._epoch:
                self._epoch = int(epoch)
                self._view = None
                _obs.set_fleet_epoch(self._epoch)

    def is_stale(self, frame_epoch: int) -> bool:
        with self._lock:
            return int(frame_epoch) < self._epoch

    # --------------------------------------------------- straggling

    def note_stage_wall(self, stage: str, wall_ns: int) -> None:
        """Distributed runners feed their per-stage wall times here;
        a robust-z outlier fires the existing straggler spine (journal
        + the flight recorder's trigger matrix)."""
        fired = self.detector.observe(f"fleet.{stage}", int(wall_ns))
        if fired:
            _obs.JOURNAL.emit("fleet_straggler", rank=self.rank,
                              **fired)

    def note_arrival(self, op_id: int, part: int, src: int,
                     dt_ns: int) -> None:
        with self._lock:
            win = self._arrivals.get(op_id)
            if win is None:
                win = self._arrivals[op_id] = deque(maxlen=64)
            win.append(float(dt_ns))
        self.detector.observe(f"fleet.op{op_id}.arrival", int(dt_ns),
                              task=src)

    def should_speculate(self, op_id: int, elapsed_ns: int
                         ) -> Optional[dict]:
        """Is a still-missing part a straggler worth re-executing?
        Judged as a robust-z outlier of the CURRENT wait against the
        op's arrival-gap window; a cold window (fewer arrivals than
        ``min_arrivals``) falls back to the wall-clock floor so the
        fleet still makes progress when there is nothing to compare
        against.  Returns the evidence dict (None = keep waiting)."""
        with self._lock:
            win = list(self._arrivals.get(op_id, ()))
        if len(win) >= self.min_arrivals:
            z = robust_z(float(elapsed_ns), win)
            if z >= self.detector.threshold:
                return {"reason": "robust_z", "robust_z": round(z, 2),
                        "samples": len(win),
                        "elapsed_ms": elapsed_ns // 1_000_000}
            # an arrival window dominated by fast peers: ALSO honor the
            # floor (a window with one prior slow arrival must not mute
            # the floor forever)
        if elapsed_ns >= self.spec_delay_s * 1e9:
            return {"reason": "delay_floor",
                    "floor_s": self.spec_delay_s,
                    "elapsed_ms": elapsed_ns // 1_000_000,
                    "samples": len(win)}
        return None

    # --------------------------------------------------------- skew

    def note_part_bytes(self, op_id: int, nbytes: int) -> None:
        with self._lock:
            win = self._part_bytes.get(op_id)
            if win is None:
                win = self._part_bytes[op_id] = deque(maxlen=64)
            win.append(int(nbytes))

    def hot_part(self, op_id: int, nbytes: int) -> Optional[dict]:
        """Is this payload a skew outlier for its op?  Compared to the
        median of the op's PRIOR partition payloads (>=2 samples so a
        first-of-op payload can never be "hot" against nothing)."""
        with self._lock:
            win = sorted(self._part_bytes.get(op_id, ()))
        if len(win) < 2:
            return None
        med = win[len(win) // 2]
        if med > 0 and nbytes > self.skew_ratio * med:
            return {"median_bytes": int(med), "bytes": int(nbytes),
                    "ratio": round(nbytes / med, 2)}
        return None

    def link_skew(self, link_bytes: Optional[dict] = None) -> dict:
        """Per-peer link byte deltas since the last call + the fleet
        skew ratio (max/median of per-peer recv bytes), the live-counter
        signal the re-split decision reads.  ``link_bytes`` maps
        (direction, peer) to cumulative bytes; by default the
        transport's own counters, which equal
        ``srt_shuffle_link_bytes_total`` (the JAX package reads that
        family, so its deltas need the metrics switch on)."""
        if link_bytes is None:
            from spark_rapids_tpu_torch.distributed import transport
            link_bytes = transport.link_bytes()
        deltas: Dict[Tuple[str, str], float] = {}
        with self._lock:
            for key, cur in link_bytes.items():
                key = (str(key[0]), str(key[1]))
                deltas[key] = float(cur) - self._link_base.get(key, 0.0)
                self._link_base[key] = float(cur)
        recv = sorted(v for (d, _p), v in deltas.items()
                      if d == "recv" and v > 0)
        ratio = None
        med = recv[(len(recv) - 1) // 2] if recv else 0  # lower median
        if len(recv) >= 2 and med > 0:
            ratio = round(recv[-1] / med, 2)
        return {"deltas": {f"{d}:{p}": v
                           for (d, p), v in sorted(deltas.items())},
                "skew_ratio": ratio}
