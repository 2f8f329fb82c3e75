"""Stage IR: the typed plan nodes whole-stage fusion compiles.

A *stage* is everything a query does between two shuffle boundaries:
scan, join probe, filter, segment aggregate, sort.  This module makes
that composition a data structure, so the compiler (plan/compiler.py)
can run ANY stage as one compiled program or op by op, key the
compiled program by the plan's digest, and new operators (window
functions, rollup/cube) become IR nodes instead of hand pipelines.

The node classes, their ``key()`` strings and the digests are the JAX
package's (`spark_rapids_tpu/plan/ir.py`) character for character, so
a plan built here has the same digest as the same plan built there.

Design rules:

  * nodes are frozen dataclasses with a canonical ``key()`` string;
    the stage digest is a sha1 over every node's key, so two builds of
    the same logical stage — in different processes, sessions, or
    plan-object identities — hit the same compiled program;
  * expressions (`Col`/`Lit`/`Bin`/`Un`/`Where`/`Idx`/...) are scalarish
    columnar algebra: they evaluate to tensors with the reference's
    dtype promotion (python literals stay weak-typed; `Lit(v, dtype)`
    pins a dtype like a 0-d tensor of that dtype), which is what makes
    results byte-identical to the hand pipelines;
  * static shapes only: joins are the fixed-capacity device probe
    (`ops/device_join.inner_join_device`), filters are masks, group
    tables are sized by the query's domain;
  * `Reduce` marks the cross-shard reduction point: identity in one
    process, and the place a multi-process runner reduces across ranks
    (ROADMAP A10);
  * `ShuffleBoundary` is the typed seam between stages of a
    `Pipeline`: the compiler fuses everything between boundaries into
    one program.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ------------------------------------------------------------- expressions


class Expr:
    """Base class for stage expressions (columnar algebra)."""

    def key(self) -> str:  # pragma: no cover - abstract
        raise NotImplementedError


def _k(e) -> str:
    """Canonical key of an Expr operand (plain ints/strings allowed as
    static parameters)."""
    return e.key() if isinstance(e, Expr) else repr(e)


@dataclass(frozen=True)
class Col(Expr):
    """Reference to a bound column (a scan-bind column, a node output,
    or a join-probe output like ``j.li``)."""
    name: str

    def key(self):
        return f"c({self.name})"


@dataclass(frozen=True)
class Lit(Expr):
    """Literal. ``dtype=None`` stays a weak python scalar (promotes
    exactly like a literal in the hand kernels); a dtype string
    ('int32', 'int64', 'float64', ...) pins it like a 0-d tensor of
    that dtype."""
    value: object
    dtype: Optional[str] = None

    def key(self):
        return f"l({self.value!r}:{self.dtype})"


@dataclass(frozen=True)
class Bin(Expr):
    """Binary op: add sub mul floordiv mod and or eq ne lt le gt ge
    max min."""
    op: str
    a: Expr
    b: Expr

    def key(self):
        return f"b({self.op},{_k(self.a)},{_k(self.b)})"


@dataclass(frozen=True)
class Un(Expr):
    """Unary op: neg, not, i32/i64/f64/b (casts), sum (full reduction
    to a scalar)."""
    op: str
    a: Expr

    def key(self):
        return f"u({self.op},{_k(self.a)})"


@dataclass(frozen=True)
class Where(Expr):
    cond: Expr
    a: Expr
    b: Expr

    def key(self):
        return f"w({_k(self.cond)},{_k(self.a)},{_k(self.b)})"


@dataclass(frozen=True)
class Idx(Expr):
    """Gather: ``src[idx]`` — dense-dimension lookups and join-pair
    gathers."""
    src: Expr
    idx: Expr

    def key(self):
        return f"i({_k(self.src)},{_k(self.idx)})"


@dataclass(frozen=True)
class Mask(Expr):
    """Row-validity of a bucketed input: True for real rows, False for
    the pad tail (``arange(bucket) < n_valid``).  All-true for
    unbucketed inputs.  Plans AND this into their keep conditions so
    pad rows can never reach an aggregate."""
    input: str

    def key(self):
        return f"m({self.input})"


@dataclass(frozen=True)
class Arange(Expr):
    n: int
    dtype: str = "int64"

    def key(self):
        return f"a({self.n}:{self.dtype})"


@dataclass(frozen=True)
class Sl(Expr):
    """Static slice ``x[start:stop]`` (ORDER BY ... LIMIT)."""
    a: Expr
    start: int
    stop: int

    def key(self):
        return f"s({_k(self.a)},{self.start},{self.stop})"


@dataclass(frozen=True)
class Stack(Expr):
    """Stack of scalar expressions (q9's bucket vectors)."""
    parts: Tuple[Expr, ...]

    def key(self):
        return "k(" + ",".join(_k(p) for p in self.parts) + ")"


# ------------------------------------------------------------------- nodes


class Node:
    """Base class for stage nodes.  ``outs()`` names every column the
    node defines; ``key()`` is the canonical digest contribution."""

    def outs(self) -> Tuple[str, ...]:  # pragma: no cover - abstract
        raise NotImplementedError

    def key(self) -> str:  # pragma: no cover - abstract
        raise NotImplementedError


@dataclass(frozen=True)
class Project(Node):
    """Bind ``out`` to an expression (projections AND filter masks —
    a filter in this static-shape world is a boolean column)."""
    out: str
    expr: Expr

    def outs(self):
        return (self.out,)

    def key(self):
        return f"P({self.out}={_k(self.expr)})"


@dataclass(frozen=True)
class JoinProbe(Node):
    """Fixed-capacity device inner-join probe
    (ops/device_join.inner_join_device, inlined into the stage).  Defines ``<p>.li`` ``<p>.ri``
    (int32 pair indices), ``<p>.valid`` (bool per slot) and
    ``<p>.total`` (int64 TRUE pair count; ``total > capacity`` is the
    overflow signal the capacity retry doubles on)."""
    prefix: str
    left: Expr
    right: Expr
    capacity: int
    left_valid: Optional[Expr] = None
    right_valid: Optional[Expr] = None

    def outs(self):
        p = self.prefix
        return (f"{p}.li", f"{p}.ri", f"{p}.valid", f"{p}.total")

    def key(self):
        return (f"J({self.prefix},{_k(self.left)},{_k(self.right)},"
                f"{self.capacity},{_k(self.left_valid)},"
                f"{_k(self.right_valid)})")


@dataclass(frozen=True)
class SegmentSum(Node):
    """Hash-aggregate workhorse: ``segment_sum(value, ids,
    num_segments)`` over dictionary-encoded group ids."""
    out: str
    value: Expr
    ids: Expr
    num_segments: int

    def outs(self):
        return (self.out,)

    def key(self):
        return (f"G({self.out}={_k(self.value)}@{_k(self.ids)}"
                f"/{self.num_segments})")


@dataclass(frozen=True)
class Sort(Node):
    """Stable sort over equal-length 1-D operands; the first
    ``num_keys`` operands are the lexicographic sort keys (ORDER BY)."""
    names: Tuple[str, ...]
    operands: Tuple[Expr, ...]
    num_keys: int

    def outs(self):
        return self.names

    def key(self):
        return ("S(" + ",".join(self.names) + "="
                + ",".join(_k(o) for o in self.operands)
                + f"/{self.num_keys})")


@dataclass(frozen=True)
class Reduce(Node):
    """Cross-shard reduction point: identity in one process; a
    multi-process runner reduces across ranks here (ROADMAP A10).
    kind 'sum' (exact int64 partials — any reduction order is
    byte-identical) or 'any' (overflow flags)."""
    out: str
    value: Expr
    kind: str = "sum"

    def outs(self):
        return (self.out,)

    def key(self):
        return f"R({self.out}={_k(self.value)}:{self.kind})"


@dataclass(frozen=True)
class WindowSum(Node):
    """Window aggregate ``sum(value) OVER (PARTITION BY part)``
    broadcast back to every row: segment-sum + gather."""
    out: str
    part: Expr
    value: Expr
    num_partitions: int

    def outs(self):
        return (self.out,)

    def key(self):
        return (f"WS({self.out}={_k(self.value)}@{_k(self.part)}"
                f"/{self.num_partitions})")


@dataclass(frozen=True)
class WindowRank(Node):
    """``rank() OVER (PARTITION BY part ORDER BY order ASC)`` (callers
    negate for DESC), 0-based, ties broken by row index — one
    stable sort + cummax, no data-dependent loops."""
    out: str
    part: Expr
    order: Expr

    def outs(self):
        return (self.out,)

    def key(self):
        return f"WR({self.out}={_k(self.order)}@{_k(self.part)})"


@dataclass(frozen=True)
class Rollup(Node):
    """GROUP BY ROLLUP/CUBE over two key columns with cardinalities
    ``cards`` — the grouping-sets aggregate as one node.  Defines
    ``<p>.sum0``/``<p>.cnt0`` (k1 x k2 finest level), ``<p>.sum1``/
    ``<p>.cnt1`` (per-k1, k2 rolled up), ``<p>.sumt``/``<p>.cntt``
    (grand total), and for mode='cube' additionally ``<p>.sum2``/
    ``<p>.cnt2`` (per-k2).  Coarser levels fold from the finest level's
    exact int sums, so every level is byte-stable in any order."""
    prefix: str
    keys: Tuple[Expr, Expr]
    cards: Tuple[int, int]
    value: Expr
    mask: Expr
    mode: str = "rollup"

    def outs(self):
        p = self.prefix
        base = (f"{p}.sum0", f"{p}.cnt0", f"{p}.sum1", f"{p}.cnt1",
                f"{p}.sumt", f"{p}.cntt")
        if self.mode == "cube":
            base = base + (f"{p}.sum2", f"{p}.cnt2")
        return base

    def key(self):
        return (f"U({self.prefix},{_k(self.keys[0])},{_k(self.keys[1])}"
                f",{self.cards},{_k(self.value)},{_k(self.mask)},"
                f"{self.mode})")


# ------------------------------------------------------------------ inputs


@dataclass(frozen=True)
class ColSpec:
    """One bound input column.  ``pad`` is the value the compiler pads
    the bucket tail with — join-key columns use side-specific
    sentinels (-1 vs -2) so pad rows can never match each other, and
    dense-lookup indices pad with an in-range value while ``Mask``
    kills their contribution."""
    name: str
    pad: int = 0


@dataclass(frozen=True)
class ScanBind(Node):
    """Stage input: binds caller arrays to named columns.  Bucketed
    inputs (facts) are padded to the next power-of-two row bucket and
    carry an ``n_valid`` scalar tensor (so nearby batch sizes share
    one program); unbucketed inputs (group tables, dims, scalars)
    keep exact shapes, folded into the digest."""
    name: str
    columns: Tuple[ColSpec, ...]
    bucket: bool = True

    def outs(self):
        return tuple(c.name for c in self.columns)

    def key(self):
        cols = ",".join(f"{c.name}:{c.pad}" for c in self.columns)
        return f"I({self.name},[{cols}],{int(self.bucket)})"


@dataclass(frozen=True)
class ShuffleBoundary:
    """Typed seam between two stages of a Pipeline: ``carry`` names the
    columns that cross (one process: direct handoff; a multi-process
    runner ships them over the shuffle, ROADMAP A10).  Everything on
    either side fuses into its own single program."""
    carry: Tuple[str, ...]

    def key(self):
        return "B(" + ",".join(self.carry) + ")"


# ------------------------------------------------------------------- plans


@dataclass(frozen=True)
class StagePlan:
    """One fusable stage: inputs, an SSA-ordered node list (each node
    may only reference columns defined above it), and named outputs."""
    name: str
    inputs: Tuple[ScanBind, ...]
    nodes: Tuple[Node, ...]
    outputs: Tuple[str, ...]

    @property
    def digest(self) -> str:
        s = ";".join([self.name]
                     + [i.key() for i in self.inputs]
                     + [n.key() for n in self.nodes]
                     + list(self.outputs))
        return hashlib.sha1(s.encode()).hexdigest()[:16]

    def validate(self) -> "StagePlan":
        defined = set()
        for i in self.inputs:
            defined.update(i.outs())
        for n in self.nodes:
            for out in n.outs():
                if out in defined:
                    raise ValueError(f"duplicate column {out!r} in "
                                     f"stage {self.name!r}")
                defined.add(out)
        missing = [o for o in self.outputs if o not in defined]
        if missing:
            raise ValueError(f"stage {self.name!r} outputs undefined "
                             f"columns {missing}")
        return self


@dataclass(frozen=True)
class Pipeline:
    """Stages joined by typed shuffle boundaries:
    ``stages[i] -> boundaries[i] -> stages[i+1]``.  A stage after a
    boundary binds the carried columns through a ScanBind whose column
    names EQUAL the carry names (the compiler feeds them by name)."""
    name: str
    stages: Tuple[StagePlan, ...]
    boundaries: Tuple[ShuffleBoundary, ...] = field(default=())

    @property
    def digest(self) -> str:
        s = ";".join([self.name] + [st.digest for st in self.stages]
                     + [b.key() for b in self.boundaries])
        return hashlib.sha1(s.encode()).hexdigest()[:16]
