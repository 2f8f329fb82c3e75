"""Whole-stage fusion compiler.

Takes a :class:`~spark_rapids_tpu_torch.plan.ir.StagePlan` and runs it
with one evaluator on two engines:

  * :meth:`CompiledStage.run_unfused` — the op-by-op walk: every node
    runs as eager PyTorch ops on the inputs' device;
  * the fused engine — the whole stage as ONE
    ``torch.compile(fullgraph=True, dynamic=False)`` program per (plan
    digest, operand digest, power-of-two row bucket, device), kept in
    the stage's memo, so a second same-bucket query compiles nothing.

Both engines are byte-identical by contract (same evaluator, exact
integer aggregates, stable sorts); fusion is a speed choice only.
``SPARK_RAPIDS_TPU_STAGE_FUSION=1|0`` pins the engine; unset ('auto'),
the first run of a (plan, operand shapes, device) measures both on a
sample of at most ``_STAGE_CALIB_MAX_ROWS`` rows through
perf/calibrate's ``pick_path`` and every later run takes the winner.

The evaluator follows the JAX package's semantics (x64 mode), not
PyTorch's defaults, wherever the two differ:

  * type promotion is JAX's lattice: a python literal (``Lit`` without
    a dtype) is weak, a pinned ``Lit`` promotes as a full operand (a
    0-d tensor ranks below a dimensioned one in PyTorch);
  * integer true division gives float32, or float64 from 64-bit ints;
  * integer floordiv and mod by zero give XLA's values
    (``x // 0`` is -1 or -2, ``x % 0`` is 0), and INT_MIN // -1 wraps;
  * float-to-int casts saturate and take NaN to 0;
  * gathers wrap negative indices, then clamp;
  * segment sums drop ids outside ``[0, num_segments)``;
  * sorts are stable and lexicographic; float keys tie -0.0 with 0.0
    and put NaN last.

A stage also runs once per hash partition of spilled inputs
(:meth:`CompiledStage.run_spilled`, each partition through :meth:`run`).

Every run records ``srt_stage_fusion_total{stage,outcome}`` and a
``stage_fusion`` journal event while observability is on, and a fused
key's first call (tracing and compiling) opens a ``stage_compile``
span.  With the stats plane on, a run taps its data-dependent row
counts (join totals, predicate popcounts) into ``observability.STATS``;
while a query is profiled, each run adds one stage record to its
profile.  A pipeline consults the semantic result cache per stage when
it is armed (perf/result_cache).  Every plan is verified once before
it first compiles or runs (analysis/plan_verify).  For a rank of a mesh
program, :func:`fused_pipeline_fn` gives the whole pipeline as one
function whose ``Reduce`` nodes all-reduce over the rank's process
group, and :class:`FusedProgram` compiles it as one graph.
"""

import os
import time
import types
from typing import Dict, Mapping, Sequence, Tuple

import torch

from spark_rapids_tpu_torch import observability as _obs
from spark_rapids_tpu_torch.ops.device_join import inner_join_device
from spark_rapids_tpu_torch.ops.joins import _lex_order
from spark_rapids_tpu_torch.perf.calibrate import operands_digest
from spark_rapids_tpu_torch.perf.jit_cache import bucket_rows
from spark_rapids_tpu_torch.plan import ir

# ------------------------------------------------------------------- knobs


# calibration samples: bucketed inputs past this many rows are row-sliced
# for the fused-vs-op-by-op measurement
_STAGE_CALIB_MAX_ROWS = 1 << 18


def fusion_mode() -> str:
    """'off' | 'on' | 'auto' from SPARK_RAPIDS_TPU_STAGE_FUSION (read on
    every run, so flipping it mid-process works)."""
    v = os.environ.get("SPARK_RAPIDS_TPU_STAGE_FUSION", "")
    if v == "0":
        return "off"
    if v == "1":
        return "on"
    return "auto"


def _canon_dtype(t: torch.Tensor) -> str:
    """The reference's name for a tensor's dtype (``int32``, ``int64``,
    ``float64``, ``bool``), so run digests equal the JAX package's."""
    return str(t.dtype).removeprefix("torch.")


# ------------------------------------------------------ type promotion
# JAX's promotion lattice (x64 mode): each type and the types just above
# it.  "i*" and "f*" are the weak python int and float.

_UP = {
    torch.bool: ("i*",),
    "i*": (torch.uint8, torch.int8),
    torch.uint8: (torch.int16, torch.uint16),
    torch.uint16: (torch.int32, torch.uint32),
    torch.uint32: (torch.int64, torch.uint64),
    torch.uint64: ("f*",),
    torch.int8: (torch.int16,),
    torch.int16: (torch.int32,),
    torch.int32: (torch.int64,),
    torch.int64: ("f*",),
    "f*": (torch.float16, torch.bfloat16),
    torch.float16: (torch.float32,),
    torch.bfloat16: (torch.float32,),
    torch.float32: (torch.float64,),
    torch.float64: (),
}
_WEAK = {"i*": torch.int64, "f*": torch.float64}


def _closure(t) -> frozenset:
    seen, todo = {t}, [t]
    while todo:
        for u in _UP[todo.pop()]:
            if u not in seen:
                seen.add(u)
                todo.append(u)
    return frozenset(seen)


def _least_upper_bound(a, b):
    common = _closure(a) & _closure(b)
    return next(t for t in common if _closure(t) == common)


# a table, so the traced program only looks types up
_JOIN = {(a, b): _least_upper_bound(a, b) for a in _UP for b in _UP}
# integer true division's float type (jax.dtypes.to_inexact_dtype)
_INEXACT = {torch.bool: torch.float32, torch.uint8: torch.float32,
            torch.int8: torch.float32, torch.uint16: torch.float32,
            torch.int16: torch.float32, torch.uint32: torch.float32,
            torch.int32: torch.float32, torch.uint64: torch.float64,
            torch.int64: torch.float64}


def _lattice_type(x):
    if isinstance(x, torch.Tensor):
        return x.dtype
    if isinstance(x, bool):
        return torch.bool
    return "i*" if isinstance(x, int) else "f*"


def _result_dtype(*xs) -> torch.dtype:
    """The dtype JAX gives an op over ``xs``: the least upper bound of
    their types, a weak bound taking its canonical 64-bit dtype."""
    t = _lattice_type(xs[0])
    for x in xs[1:]:
        t = _JOIN[(t, _lattice_type(x))]
    return _WEAK.get(t, t)


def _all_weak(*xs) -> bool:
    return not any(isinstance(x, (torch.Tensor, bool)) for x in xs)


def _refuse_weak_array(what: str):
    # JAX keeps such an array weak, so its dtype would still give way to
    # a later operand's; a strong 64-bit tensor would not.  No catalog
    # plan builds one.
    raise NotImplementedError(
        f"{what} over unpinned literals alone: pin one Lit's dtype")


def _as(x, dt: torch.dtype, dev) -> torch.Tensor:
    """``x`` as a tensor of ``dt`` (a python scalar as a 0-d one)."""
    if isinstance(x, torch.Tensor):
        return x.to(dt)
    return torch.tensor(x, dtype=dt, device=dev)


# -------------------------------------------------------------- arithmetic


def _xla_divrem(x: torch.Tensor, y: torch.Tensor):
    """Integer truncating division and remainder with XLA's values
    where C's are undefined: x / 0 = -1 (all ones unsigned), x % 0 = x,
    INT_MIN / -1 = INT_MIN, INT_MIN % -1 = 0."""
    zero = y == 0
    bad = zero
    if x.dtype.is_signed:
        bad = bad | ((x == torch.iinfo(x.dtype).min) & (y == -1))
    safe = torch.where(bad, 1, y)
    q = torch.div(x, safe, rounding_mode="trunc")
    r = torch.fmod(x, safe)
    q = torch.where(zero, -1 if x.dtype.is_signed
                    else torch.iinfo(x.dtype).max, q)
    return q, torch.where(zero, x, r)


def _round_away(d: torch.Tensor) -> torch.Tensor:
    """Round half away from zero (lax.round's default)."""
    t = torch.trunc(d)
    return torch.where((d - t).abs() >= 0.5, t + torch.sign(d), t)


def _floordiv(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """jnp.floor_divide."""
    if x.dtype.is_floating_point:
        # CPython's float_divmod, as JAX writes it
        mod = torch.fmod(x, y)
        div = (x - mod) / y
        ind = (mod != 0) & (torch.sign(y) != torch.sign(mod))
        return _round_away(torch.where(ind, div - 1, div))
    q, r = _xla_divrem(x, y)
    if not x.dtype.is_signed:
        return q
    return torch.where((torch.sign(x) != torch.sign(y)) & (r != 0),
                       q - 1, q)


def _mod(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """jnp.remainder: the remainder takes the divisor's sign; an
    integer divisor of 0 counts as 1."""
    if x.dtype.is_floating_point:
        tm = torch.fmod(x, y)
    else:
        y = torch.where(y == 0, 1, y)
        tm = _xla_divrem(x, y)[1]
    plus = ((tm < 0) != (y < 0)) & (tm != 0)
    return torch.where(plus, tm + y, tm)


def _cast(a: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """``astype`` with XLA's float-to-int conversion: saturating, NaN
    to 0."""
    if (not a.dtype.is_floating_point or dt.is_floating_point
            or dt == torch.bool):
        return a.to(dt)
    info = torch.iinfo(dt)
    hi = a >= float(info.max) + 1.0        # 2^(bits-1), exact in floats
    lo = a <= float(info.min)
    out = torch.where(torch.isnan(a) | hi | lo, 0, a).to(dt)
    return torch.where(hi, info.max, torch.where(lo, info.min, out))


_PY = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "div": lambda a, b: a / b,
    "floordiv": lambda a, b: a // b,
    "mod": lambda a, b: a % b,
    "and": lambda a, b: a & b,
    "or": lambda a, b: a | b,
    "eq": lambda a, b: a == b,
    "ne": lambda a, b: a != b,
    "lt": lambda a, b: a < b,
    "le": lambda a, b: a <= b,
    "gt": lambda a, b: a > b,
    "ge": lambda a, b: a >= b,
}

_TENSOR = {
    "floordiv": _floordiv,
    "mod": _mod,
    "max": torch.maximum,
    "min": torch.minimum,
}


def _binary(op: str, a, b, dev):
    if not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
        if op in ("max", "min"):
            _refuse_weak_array(op)
        return _PY[op](a, b)     # python scalars, as the reference does
    dt = _result_dtype(a, b)
    if op == "div":
        dt = _INEXACT.get(dt, dt)
    if op in ("floordiv", "mod") and type(b) is int and b not in (0, -1) \
            and not dt.is_floating_point:
        # a literal divisor other than 0 and -1: PyTorch's floor ops
        # agree with jnp and need no guard (inductor's integer range
        # analysis also fails on the guards' constant booleans there)
        a = _as(a, dt, dev)
        return (torch.div(a, b, rounding_mode="floor") if op == "floordiv"
                else torch.remainder(a, b))
    if op in _TENSOR:
        return _TENSOR[op](_as(a, dt, dev), _as(b, dt, dev))
    # a python scalar stays python: PyTorch then computes in dt, since
    # the tensor side already has the promoted dtype
    a = a.to(dt) if isinstance(a, torch.Tensor) else a
    b = b.to(dt) if isinstance(b, torch.Tensor) else b
    return _PY[op](a, b)


def _where(c, a, b, dev):
    if _all_weak(a, b):
        _refuse_weak_array("where")
    dt = _result_dtype(a, b)
    if not isinstance(c, torch.Tensor):
        c = torch.tensor(c, device=dev)
    if c.dtype != torch.bool:
        c = c != 0
    return torch.where(c, _as(a, dt, dev), _as(b, dt, dev))


def _gather(src: torch.Tensor, idx):
    """``src[idx]`` as JAX gathers: negative indices wrap, then every
    index clamps into range."""
    if isinstance(idx, torch.Tensor):
        n = src.shape[0]
        idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    return src[idx]


def segment_sum(value: torch.Tensor, ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """jax.ops.segment_sum over integer values: ids outside
    ``[0, num_segments)`` are dropped."""
    if not isinstance(value, torch.Tensor) or value.dtype in (
            torch.bool, torch.float16, torch.bfloat16, torch.float32,
            torch.float64):
        # an integer sum is exact in any order, so the card's atomic
        # adds cannot change a byte; a float sum would need a fixed
        # order.  Every catalog sum is int64.
        raise NotImplementedError(
            "segment sums take integer values only; got "
            f"{getattr(value, 'dtype', type(value).__name__)}")
    keep = (ids >= 0) & (ids < num_segments)
    trail = (1,) * (value.dim() - 1)
    idx = torch.where(keep, ids, 0).to(torch.int64).reshape(
        keep.shape + trail).expand(value.shape)
    out = torch.zeros((num_segments,) + tuple(value.shape[1:]),
                      dtype=value.dtype, device=value.device)
    # scatter_add, not index_add: compiled, index_add becomes an
    # accumulating index_put, which on the card sorts the ids and adds
    # each id's values one after another
    return out.scatter_add(0, idx, torch.where(keep.reshape(
        keep.shape + trail), value, 0))


def _sort_key(k: torch.Tensor) -> torch.Tensor:
    """A key PyTorch sorts in lax.sort's order: -0.0 ties with 0.0 and
    every NaN (either sign) sorts last."""
    if k.dtype == torch.bool:
        return k.to(torch.uint8)
    if k.is_floating_point():
        k = torch.where(k == 0, 0.0, k)
        k = torch.where(torch.isnan(k), float("nan"), k)
    return k


def sort_lex(operands: Sequence[torch.Tensor], num_keys: int) -> tuple:
    """lax.sort(operands, num_keys): the operands reordered by the
    first ``num_keys`` as a lexicographic key, ties kept in row order
    (one stable sort a key, the last key first)."""
    perm = _lex_order([_sort_key(k) for k in operands[:num_keys]])
    return tuple(o[perm] for o in operands)


# -------------------------------------------------------------- evaluation

_CAST = {"i32": torch.int32, "i64": torch.int64, "f64": torch.float64,
         "b": torch.bool}


def _eval(e, env):
    dev = env["__device__"]
    if isinstance(e, ir.Col):
        return env[e.name]
    if isinstance(e, ir.Lit):
        if e.dtype is None:
            return e.value          # weak python scalar, like a literal
        return torch.tensor(e.value, dtype=getattr(torch, e.dtype),
                            device=dev)
    if isinstance(e, ir.Bin):
        return _binary(e.op, _eval(e.a, env), _eval(e.b, env), dev)
    if isinstance(e, ir.Un):
        a = _eval(e.a, env)
        if e.op == "neg":
            return -a
        if e.op == "not":
            return ~a
        if not isinstance(a, torch.Tensor):
            _refuse_weak_array(e.op)
        if e.op == "sum":
            return torch.sum(a)     # small ints and bool sum as int64
        return _cast(a, _CAST[e.op])
    if isinstance(e, ir.Where):
        return _where(_eval(e.cond, env), _eval(e.a, env),
                      _eval(e.b, env), dev)
    if isinstance(e, ir.Idx):
        return _gather(_eval(e.src, env), _eval(e.idx, env))
    if isinstance(e, ir.Mask):
        return env[f"__mask__{e.input}"]
    if isinstance(e, ir.Arange):
        return torch.arange(e.n, dtype=getattr(torch, e.dtype),
                            device=dev)
    if isinstance(e, ir.Sl):
        return _eval(e.a, env)[e.start:e.stop]
    if isinstance(e, ir.Stack):
        parts = [_eval(p, env) for p in e.parts]
        if _all_weak(*parts):
            _refuse_weak_array("stack")
        dt = _result_dtype(*parts)
        return torch.stack([_as(p, dt, dev) for p in parts])
    raise TypeError(f"unknown expr {type(e).__name__}")


def _eval_node(node, env, reduce_group=None) -> None:
    """Evaluate one node into ``env`` (shared by the fused program and
    the op-by-op walk — one evaluator, so the two engines cannot
    drift).  ``Reduce`` nodes reduce across ``reduce_group`` (a
    distributed/mesh.Mesh) when one is given, else pass through."""
    dev = env["__device__"]
    if isinstance(node, ir.Project):
        env[node.out] = _eval(node.expr, env)
    elif isinstance(node, ir.JoinProbe):
        lv = (None if node.left_valid is None
              else _eval(node.left_valid, env))
        rv = (None if node.right_valid is None
              else _eval(node.right_valid, env))
        pairs = inner_join_device(_eval(node.left, env),
                                  _eval(node.right, env),
                                  node.capacity,
                                  left_valid=lv, right_valid=rv)
        p = node.prefix
        env[f"{p}.li"] = pairs.left_indices
        env[f"{p}.ri"] = pairs.right_indices
        env[f"{p}.valid"] = pairs.valid
        env[f"{p}.total"] = pairs.total
    elif isinstance(node, ir.SegmentSum):
        env[node.out] = segment_sum(_eval(node.value, env),
                                    _eval(node.ids, env),
                                    node.num_segments)
    elif isinstance(node, ir.Sort):
        res = sort_lex([_eval(o, env) for o in node.operands],
                       node.num_keys)
        for name, arr in zip(node.names, res):
            env[name] = arr
    elif isinstance(node, ir.Reduce):
        v = _eval(node.value, env)
        if reduce_group is None:
            env[node.out] = v
        elif node.kind == "any":
            env[node.out] = reduce_group.pany(v)
        else:
            env[node.out] = reduce_group.psum(v)
    elif isinstance(node, ir.WindowSum):
        part = _eval(node.part, env)
        sums = segment_sum(_eval(node.value, env), part,
                           node.num_partitions)
        env[node.out] = _gather(sums, part)
    elif isinstance(node, ir.WindowRank):
        part = _cast(_eval(node.part, env), torch.int64)
        okey = _cast(_eval(node.order, env), torch.int64)
        n = part.shape[0]
        iota = torch.arange(n, dtype=torch.int64, device=dev)
        p_s, _o, row_s = sort_lex((part, okey, iota), 3)
        # rank within partition = sorted position minus the running
        # partition start (one cummax, no data-dependent loops)
        first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                           p_s[1:] != p_s[:-1]])
        start = torch.cummax(torch.where(first, iota, 0), 0).values
        env[node.out] = torch.zeros(n, dtype=torch.int64,
                                    device=dev).scatter(0, row_s,
                                                        iota - start)
    elif isinstance(node, ir.Rollup):
        n1, n2 = node.cards
        m = _eval(node.mask, env)
        k1 = _where(m, _eval(node.keys[0], env), 0, dev)
        k2 = _where(m, _eval(node.keys[1], env), 0, dev)
        w = _where(m, _eval(node.value, env), 0, dev)
        c = m.to(torch.int64)
        gid = _binary("add", _binary("mul", k1.to(torch.int64), n2, dev),
                      k2, dev)
        sum0 = segment_sum(w, gid, n1 * n2)
        cnt0 = segment_sum(c, gid, n1 * n2)
        p = node.prefix
        env[f"{p}.sum0"], env[f"{p}.cnt0"] = sum0, cnt0
        # coarser grouping sets fold from the finest level's exact int
        # sums — byte-stable in any fold order
        env[f"{p}.sum1"] = sum0.reshape(n1, n2).sum(1)
        env[f"{p}.cnt1"] = cnt0.reshape(n1, n2).sum(1)
        env[f"{p}.sumt"] = torch.sum(sum0)
        env[f"{p}.cntt"] = torch.sum(cnt0)
        if node.mode == "cube":
            env[f"{p}.sum2"] = sum0.reshape(n1, n2).sum(0)
            env[f"{p}.cnt2"] = cnt0.reshape(n1, n2).sum(0)
    else:
        raise TypeError(f"unknown node {type(node).__name__}")


def _expr_is_bool(e, bool_names=frozenset()) -> bool:
    """Statically decide whether an expression evaluates to a boolean
    (a predicate/mask) from the IR alone — the tap planner must pick
    its nodes BEFORE tracing, and the choice must be a pure function
    of the plan so tapped programs key on digest alone.
    ``bool_names`` carries the names already known boolean upstream
    (JoinProbe ``.valid`` outputs, earlier predicate Projects), so a
    conjunction like ``j.valid AND qty < limit`` still taps."""
    if isinstance(e, ir.Bin):
        if e.op in ("and", "or"):
            return (_expr_is_bool(e.a, bool_names)
                    and _expr_is_bool(e.b, bool_names))
        return e.op in ("eq", "ne", "lt", "le", "gt", "ge")
    if isinstance(e, ir.Un):
        if e.op == "not":
            return _expr_is_bool(e.a, bool_names)
        return e.op == "b"
    if isinstance(e, ir.Where):
        return (_expr_is_bool(e.a, bool_names)
                and _expr_is_bool(e.b, bool_names))
    if isinstance(e, ir.Mask):
        return True
    if isinstance(e, ir.Idx):
        return _expr_is_bool(e.src, bool_names)
    if isinstance(e, ir.Sl):
        return _expr_is_bool(e.a, bool_names)
    if isinstance(e, ir.Lit):
        return isinstance(e.value, bool)
    if isinstance(e, ir.Col):
        return e.name in bool_names
    return False


def _tap_spec(plan: ir.StagePlan) -> list:
    """The per-node row-count taps this plan admits, in node order:
    ``(node_id, kind, env_key)`` triples.  Only DATA-DEPENDENT
    cardinalities are tapped — JoinProbe match totals (already
    computed by the probe) and boolean Project predicates (one
    popcount each); every other node's output size is statically
    known from its inputs, so observing it would buy nothing."""
    taps = []
    bool_names = set()
    for node in plan.nodes:
        if isinstance(node, ir.JoinProbe):
            bool_names.add(f"{node.prefix}.valid")
            taps.append((node.prefix, "JoinProbe",
                         f"{node.prefix}.total"))
        elif isinstance(node, ir.Project) and \
                _expr_is_bool(node.expr, bool_names):
            bool_names.add(node.out)
            taps.append((node.out, "Project", node.out))
    return taps


def _tap_counts(plan: ir.StagePlan, env) -> list:
    """Scalar int32 observed-row counts for every tap, evaluated from
    the node outputs ALREADY in ``env`` (shared by the fused program
    and the eager walk — same expressions, so the two engines observe
    identical counts).  A predicate popcount is one reduction over a
    value the program computed anyway; compiled, it fuses into the
    same program."""
    vals = []
    for _nid, kind, key in _tap_spec(plan):
        v = env[key]
        if kind == "JoinProbe":
            vals.append(torch.as_tensor(v).to(torch.int32))
        else:
            vals.append(torch.sum(v.to(torch.int32)).to(torch.int32))
    return vals


def _all_true_mask(first: torch.Tensor) -> torch.Tensor:
    rows = first.shape[0] if first.dim() else 0
    return torch.ones(rows, dtype=torch.bool, device=first.device)


# --------------------------------------------------------- compiled stage


class CompiledStage:
    """One stage, two engines (fused and op-by-op), one evaluator.

    ``compiles`` counts the fused programs this stage has compiled (the
    compiler backend's own calls); ``compile_seconds`` holds each fused
    key's first call, tracing and compiling included."""

    def __init__(self, plan: ir.StagePlan):
        self.plan = plan.validate()
        self._fused: Dict[tuple, object] = {}
        self.compiles = 0
        self.compile_seconds: Dict[tuple, float] = {}

    @property
    def dispatch_count(self) -> int:
        return len(self.plan.nodes)

    # ------------------------------------------------------------ binding

    def _shape_parts(self, inputs: Mapping[str, Sequence]):
        """Digest ingredients for operands_digest — every input's
        canonical dtypes plus its row bucket (exact shape for
        unbucketed inputs) — without building any padded copy.
        Returns (parts, max_bucket)."""
        parts, max_bucket = [], 0
        for inp in self.plan.inputs:
            arrs = list(inputs[inp.name])
            if len(arrs) != len(inp.columns):
                raise ValueError(
                    f"input {inp.name!r} expects {len(inp.columns)} "
                    f"columns, got {len(arrs)}")
            if inp.bucket:
                b = bucket_rows(int(arrs[0].shape[0]))
                max_bucket = max(max_bucket, b)
                parts.append((",".join(_canon_dtype(a)
                                       for a in arrs), b))
            else:
                parts.append((",".join(
                    f"{_canon_dtype(a)}{tuple(a.shape)}" for a in arrs), 0))
        return parts, max_bucket

    def _bind_args(self, inputs: Mapping[str, Sequence]):
        """Pad bucketed inputs to their power-of-two row bucket (with
        each column's ``pad``) and flatten to the fused arg list:
        [*columns..., *n_valids...].  Returns (args, parts, bucket)."""
        parts, max_bucket = self._shape_parts(inputs)
        cols, nvalids = [], []
        for inp in self.plan.inputs:
            arrs = list(inputs[inp.name])
            if inp.bucket:
                rows = int(arrs[0].shape[0])
                b = bucket_rows(rows)
                for spec, a in zip(inp.columns, arrs):
                    if a.shape[0] != rows:
                        raise ValueError(f"ragged input {inp.name!r}")
                    if rows != b:
                        a = torch.cat([a, a.new_full(
                            (b - rows,) + tuple(a.shape[1:]), spec.pad)])
                    cols.append(a.contiguous())
                nvalids.append(torch.tensor(rows, dtype=torch.int32,
                                            device=arrs[0].device))
            else:
                cols.extend(a.contiguous() for a in arrs)
        return cols + nvalids, parts, max_bucket

    def _fused_callable(self, taps: bool = False):
        """The evaluator as a pure fn(*args): binds the flat arg list
        back to named columns and row masks, then walks the nodes.
        With ``taps`` the program additionally returns one stacked
        int32 vector of per-node observed row counts: the values
        already exist inside the program (JoinProbe totals, predicate
        masks), so the same single program carries them out."""
        plan = self.plan

        def fn(*args):
            env: Dict[str, object] = {"__device__": args[0].device}
            pos = 0
            bucketed = []
            for inp in plan.inputs:
                for spec in inp.columns:
                    env[spec.name] = args[pos]
                    pos += 1
                if inp.bucket:
                    bucketed.append(inp)
                else:
                    env[f"__mask__{inp.name}"] = _all_true_mask(
                        env[inp.columns[0].name])
            for i, inp in enumerate(bucketed):
                first = env[inp.columns[0].name]
                env[f"__mask__{inp.name}"] = torch.arange(
                    first.shape[0], dtype=torch.int32,
                    device=first.device) < args[pos + i]
            for node in plan.nodes:
                _eval_node(node, env)
            outs = tuple(env[o] for o in plan.outputs)
            if taps:
                vals = _tap_counts(plan, env)
                counts = (torch.stack(vals) if vals else torch.zeros(
                    0, dtype=torch.int32, device=args[0].device))
                return outs + (counts,)
            return outs

        return fn

    def fused_fn(self, reduce_group=None):
        """Unpadded evaluator for a rank of a mesh program: args are the
        raw input columns (flattened in input order, no n_valid
        scalars); ``Reduce`` nodes all-reduce over ``reduce_group``."""
        plan = self.plan

        def fn(*args):
            env: Dict[str, object] = {"__device__": args[0].device}
            pos = 0
            for inp in plan.inputs:
                for spec in inp.columns:
                    env[spec.name] = args[pos]
                    pos += 1
                env[f"__mask__{inp.name}"] = _all_true_mask(
                    env[inp.columns[0].name])
            for node in plan.nodes:
                _eval_node(node, env, reduce_group)
            return tuple(env[o] for o in plan.outputs)

        return fn

    # ------------------------------------------------------------ engines

    def _run_digest(self, parts) -> str:
        """stage-plan digest | all-operand schema digest: the fused
        engine's compile key with the bucket and the device."""
        return f"{self.plan.digest}|{operands_digest(parts)}"

    def _compile(self, key, taps: bool = False) -> object:
        """torch.compile of the evaluator for one key, with a code
        object of its own: dynamo keeps its compiled graphs per code
        object and runs a frame eagerly once that object has been
        recompiled past its limit, so stages sharing one closure's
        code would quietly fall back to eager after a few keys."""
        fn = self._fused_callable(taps=taps)
        name = f"stage_{self.plan.name}_{len(self._fused)}"
        fn = types.FunctionType(fn.__code__.replace(co_name=name),
                                fn.__globals__, name, None,
                                fn.__closure__)

        def backend(gm, example_inputs):
            from torch._inductor.compile_fx import compile_fx
            self.compiles += 1
            return compile_fx(gm, example_inputs)

        return torch.compile(fn, backend=backend, fullgraph=True,
                             dynamic=False)

    def _run_fused(self, inputs, run_digest=None,
                   taps: bool = False) -> tuple:
        """One compiled program per (run digest, row bucket, device),
        kept in the stage's memo.  Returns (outputs, compile_ns,
        run_digest, counts): ``compile_ns`` is the first call's wall
        (tracing and compiling) when THIS call built the program, 0 on
        a memo hit; ``counts`` is the tapped per-node row-count vector
        (None without ``taps``).  A tapped program is a DIFFERENT
        program, so its memo key gets a ``|taps`` suffix while the
        reported run digest stays the base one — journal, profile and
        calibration rows fold together whichever way the stats switch
        points."""
        args, parts, bucket = self._bind_args(inputs)
        digest = run_digest or self._run_digest(parts)
        key_digest = f"{digest}|taps" if taps else digest
        key = (key_digest, bucket, str(args[0].device))
        fn = self._fused.get(key)
        compile_ns = 0
        if fn is not None:
            out = fn(*args)
        else:
            fn = self._compile(key, taps=taps)
            before = self.compiles
            t0 = time.perf_counter_ns()
            with _obs.TRACER.span(
                    "stage_compile", kind="compile",
                    attrs={"stage": self.plan.name, "digest": digest,
                           "bucket": bucket,
                           "nodes": self.dispatch_count}):
                out = fn(*args)
            compile_ns = max(time.perf_counter_ns() - t0, 1)
            self.compile_seconds[key] = compile_ns / 1e9
            if self.compiles == before:
                raise RuntimeError(
                    f"stage {self.plan.name!r} ran without compiling: "
                    "the fused engine must not fall back to eager")
            self._fused[key] = fn
        counts = None
        if taps:
            counts, out = out[-1], out[:-1]
        return out, compile_ns, digest, counts

    def _walk_env(self, inputs) -> Dict[str, object]:
        """The op-by-op walk's environment (every node output by name)
        on the unpadded inputs."""
        env: Dict[str, object] = {}
        for inp in self.plan.inputs:
            arrs = list(inputs[inp.name])
            env.setdefault("__device__", arrs[0].device)
            for spec, a in zip(inp.columns, arrs):
                env[spec.name] = a
            env[f"__mask__{inp.name}"] = _all_true_mask(arrs[0])
        for node in self.plan.nodes:
            _eval_node(node, env)
        return env

    def run_unfused(self, inputs) -> tuple:
        """Op-by-op walk on unpadded inputs: every node runs as its
        own eager ops.  Byte-identical to the fused program."""
        env = self._walk_env(inputs)
        return tuple(env[o] for o in self.plan.outputs)

    def _host_counts(self, env) -> list:
        """Tapped counts off an eager walk's env, as python ints."""
        return [int(v) for v in _tap_counts(self.plan, env)]

    # -------------------------------------------------------------- entry

    def run(self, inputs: Mapping[str, Sequence]) -> tuple:
        """Execute the stage under the current fusion mode: 'on' the
        fused engine, 'off' the op-by-op walk, 'auto' the measured
        winner (:meth:`_run_calibrated`).  With observability on the
        run is recorded (``srt_stage_fusion_total{stage,outcome}`` and
        a ``stage_fusion`` journal event) with its wall measured past
        a device sync; with the stats plane on the per-node row counts
        are tapped and folded (:meth:`_note_stats`); while the calling
        thread profiles a query, one stage record goes to its profile.
        With all of them off and a pinned engine nothing is synced."""
        mode = fusion_mode()
        # data-statistics tap: ONE attribute read when the stats plane
        # is off — no observation dict, no extra outputs
        taps = _obs.STATS.enabled
        observed = _obs.is_enabled() or taps or _obs.PROFILER.active()
        counts = None
        compile_ns = 0
        if mode == "auto":
            out, compiled, outcome, wall_ns, digest, compile_ns, \
                counts = self._run_calibrated(inputs, taps=taps)
        else:
            t0 = time.monotonic_ns()
            if mode == "off":
                if taps:
                    env = self._walk_env(inputs)
                    out = tuple(env[o] for o in self.plan.outputs)
                    counts = self._host_counts(env)
                else:
                    out = self.run_unfused(inputs)
                outcome, compiled = "unfused", False
                digest = None
            else:
                out, compile_ns, digest, counts = self._run_fused(
                    inputs, taps=taps)
                outcome, compiled = "fused", bool(compile_ns)
            wall_ns = None
            if observed:
                _sync(out)
                wall_ns = time.monotonic_ns() - t0
        if observed:
            if digest is None:
                digest = self._run_digest(self._shape_parts(inputs)[0])
            _obs.record_stage_fusion(
                self.plan.name, outcome, digest=digest,
                wall_ns=wall_ns, nodes=self.dispatch_count,
                compiled=compiled)
            stats = (self._note_stats(inputs, digest, counts)
                     if taps else None)
            # query-profile feed: one structured record per stage
            # execution while the calling thread profiles a query
            if _obs.PROFILER.active():
                _obs.PROFILER.note_stage(self._profile_record(
                    inputs, digest=digest, engine=outcome,
                    wall_ns=wall_ns, compiled=compiled,
                    compile_ns=compile_ns, stats=stats))
        return out

    def _note_stats(self, inputs, digest: str, counts):
        """Fold one execution's observation into the stats plane and
        return the profile's per-stage ``stats`` section.  Input row
        counts are host-known; tapped counts arrive as the program's
        int32 vector (fused, one copy to the host) or python ints (the
        eager walk)."""
        spec = _tap_spec(self.plan)
        vals = []
        if counts is not None:
            if isinstance(counts, torch.Tensor):
                counts = counts.cpu().reshape(-1).tolist()
            vals = [int(x) for x in list(counts)[:len(spec)]]
        nodes = [{"node": nid, "kind": kind, "rows": v}
                 for (nid, kind, _key), v in zip(spec, vals)]
        ins, cols = [], {}
        for inp in self.plan.inputs:
            arrs = inputs.get(inp.name)
            if not arrs:
                continue
            shape = tuple(arrs[0].shape)
            ins.append({"name": inp.name,
                        "rows": int(shape[0]) if shape else 0})
            cols[inp.name] = arrs[0]
        return _obs.STATS.note_stage(
            {"stage": self.plan.name,
             "plan_digest": self.plan.digest,
             "run_digest": digest, "inputs": ins, "nodes": nodes},
            columns=cols)

    def run_spilled(self, partitions: Sequence[Mapping[str, object]]
                    ) -> list:
        """A ShuffleBoundary is also a SPILL boundary: run this stage
        once per hash partition of spilled inputs — WITHOUT unfusing:
        every partition goes through the ordinary :meth:`run` entry, so
        same-bucket partitions share ONE fused program (the second
        partition compiles nothing).

        Each element of ``partitions`` maps input name -> either a
        plain tensor sequence or a memory/spill.SpillHandle, whose
        batch is streamed back onto its device just-in-time for its
        partition, PINNED (victim-ineligible) while the partition runs,
        and stays registered — spillable again — afterwards; the
        CALLER owns handle close().  A handle's columns reach the stage
        as their data tensors (the logical values, nulls not masked).
        Returns the per-partition output tuples in partition order
        (correctness requires hash-partitioned, per-partition-complete
        inputs — the ops/out_of_core contract)."""
        import contextlib

        from spark_rapids_tpu_torch.memory.spill import SpillHandle
        outs = []
        for part in partitions:
            with contextlib.ExitStack() as pins:
                stage_inputs = {}
                for name, v in part.items():
                    if isinstance(v, SpillHandle):
                        v = [c.data for c in pins.enter_context(v.pin())]
                    stage_inputs[name] = tuple(v)
                outs.append(self.run(stage_inputs))
        return outs

    def _profile_record(self, inputs, *, digest: str, engine: str,
                        wall_ns, compiled: bool,
                        compile_ns: int = 0, stats=None) -> dict:
        """The typed per-stage profile row: plan structure (node
        kinds + outputs), per-input rows/bucket/pad-waste, engine,
        wall, compile-vs-memo-hit (plus the build's own wall, for the
        attribution ledger's compile bucket), dispatch count, and the
        monotonic dispatch window the critical path orders by."""
        ins = []
        for inp in self.plan.inputs:
            arrs = inputs.get(inp.name)
            if not arrs:
                continue
            shape = tuple(arrs[0].shape)
            rows = int(shape[0]) if shape else 0
            bucket = bucket_rows(rows) if inp.bucket else rows
            ins.append({"name": inp.name, "rows": rows,
                        "bucket": bucket,
                        "pad_rows": max(bucket - rows, 0)})
        t_end_ns = time.monotonic_ns()
        rec = {
            "stage": self.plan.name,
            "digest": digest,
            "engine": ("unfused" if engine == "unfused" else "fused"),
            "compiled": bool(compiled),
            "compile_ns": int(compile_ns),
            "wall_ns": int(wall_ns or 0),
            "t_start_ns": t_end_ns - int(wall_ns or 0),
            "t_end_ns": t_end_ns,
            "dispatches": (self.dispatch_count
                           if engine == "unfused" else 1),
            "nodes_total": self.dispatch_count,
            "nodes": [{"kind": type(n).__name__,
                       "outs": list(n.outs())}
                      for n in self.plan.nodes],
            "inputs": ins,
        }
        if stats is not None:
            rec["stats"] = stats
        return rec

    def _calibration_sample(self, inputs):
        """Row-slice oversized bucketed inputs for the measurement
        runs (the verdict still keys on the FULL-size digest — size
        class separation is operands_digest's job).  Returns
        (sample_inputs, sampled?)."""
        sampled = False
        out = {}
        for inp in self.plan.inputs:
            arrs = tuple(inputs[inp.name])
            if inp.bucket and \
                    int(arrs[0].shape[0]) > _STAGE_CALIB_MAX_ROWS:
                arrs = tuple(a[:_STAGE_CALIB_MAX_ROWS] for a in arrs)
                sampled = True
            out[inp.name] = arrs
        return out, sampled

    def _run_calibrated(self, inputs, taps: bool = False):
        """Stage-granularity engine verdict: the first stage of a
        given (plan digest, operand shapes, device) measures fused vs
        op-by-op — on row-sliced samples past _STAGE_CALIB_MAX_ROWS,
        so a huge first query does not pay two full-size runs — and
        every later one takes the cached winner (perf/calibrate's
        verdict cache, keyed by the torch device).  Both engines are
        byte-identical, so calibration is a speed choice only.  Returns
        (outputs, compiled, outcome, wall_ns, run_digest, compile_ns,
        counts) with the wall of the winning engine's OWN execution
        (measurement runs excluded); ``counts`` is the winner's tapped
        row-count vector (None without ``taps``, and None when a
        sampled measurement won on sliced inputs — sliced counts would
        reconcile against nothing)."""
        from spark_rapids_tpu_torch.perf import calibrate

        parts, _bucket = self._shape_parts(inputs)
        digest = self._run_digest(parts)
        compiled = []
        last: Dict[str, tuple] = {}
        walls: Dict[str, int] = {}
        tap_cell: Dict[str, object] = {}
        calib_inputs, sampled = self._calibration_sample(inputs)

        def timed(tag, fn):
            def go():
                t0 = time.monotonic_ns()
                out = fn()
                _sync(out)
                last[tag] = out
                walls[tag] = time.monotonic_ns() - t0
                return out
            return go

        def fused_body():
            # sampled inputs key their own (smaller) program; the
            # full-size digest stays the verdict key
            out, c, _d, cts = self._run_fused(
                calib_inputs, run_digest=None if sampled else digest,
                taps=taps)
            if c:
                compiled.append(c)
            if cts is not None:
                tap_cell["fused"] = cts
            return out

        def unfused_body():
            if not taps:
                return self.run_unfused(calib_inputs)
            env = self._walk_env(calib_inputs)
            tap_cell["op_by_op"] = self._host_counts(env)
            return tuple(env[o] for o in self.plan.outputs)

        path = calibrate.pick_path(
            f"stage:{self.plan.name}", digest,
            {"fused": timed("fused", fused_body),
             "op_by_op": timed("op_by_op", unfused_body)},
            default="fused", device=_first_device(inputs, self.plan))
        if path not in ("fused", "op_by_op"):
            # pick_path returns env pins verbatim — callers validate
            # membership; an unknown pin falls back to the default
            path = "fused"
        outcome = "unfused" if path == "op_by_op" else "fused"
        if not sampled and path in last:
            # calibration just ran the winner on the REAL inputs —
            # reuse its outputs and its measured wall instead of
            # paying a third execution
            return (last[path], bool(compiled), outcome, walls[path],
                    digest, sum(compiled), tap_cell.get(path))
        t0 = time.monotonic_ns()
        counts = None
        if path == "op_by_op":
            if taps:
                env = self._walk_env(inputs)
                out = tuple(env[o] for o in self.plan.outputs)
                counts = self._host_counts(env)
            else:
                out = self.run_unfused(inputs)
        else:
            out, c, _d, counts = self._run_fused(
                inputs, run_digest=digest, taps=taps)
            if c:
                compiled.append(c)
        _sync(out)
        return (out, bool(compiled), outcome,
                time.monotonic_ns() - t0, digest, sum(compiled),
                counts)


def _sync(out) -> None:
    """Wait for the device that holds ``out`` (a tuple of tensors): a
    wall read past this covers the work, not just its launch."""
    for o in out:
        if isinstance(o, torch.Tensor):
            if o.device.type == "cuda":
                torch.cuda.synchronize(o.device)
            return


def _first_device(inputs, plan) -> torch.device:
    for inp in plan.inputs:
        for a in inputs[inp.name]:
            if isinstance(a, torch.Tensor):
                return a.device
    return torch.device("cpu")


# plan-verify gate: every distinct plan digest is verified ONCE before
# anything compiles, so a malformed plan fails as a typed
# PlanVerifyError naming the offending node instead of a dtype error
# from inside a compiled graph.  Memoized by digest so the hot path
# pays a dict hit; SPARK_RAPIDS_TPU_PLAN_VERIFY=0 is the escape hatch.
# Its callers: stage compilation, pipeline compilation and
# fused_pipeline_fn.
_VERIFIED: Dict[str, bool] = {}
_VERIFIED_CAP = 4096


def _verify_once(plan_or_pipeline) -> None:
    if os.environ.get("SPARK_RAPIDS_TPU_PLAN_VERIFY", "") == "0":
        return
    digest = plan_or_pipeline.digest
    if digest in _VERIFIED:
        return
    from spark_rapids_tpu_torch.analysis import plan_verify
    if isinstance(plan_or_pipeline, ir.Pipeline):
        plan_verify.verify_pipeline(plan_or_pipeline)
    else:
        plan_verify.verify_stage(plan_or_pipeline)
    if len(_VERIFIED) >= _VERIFIED_CAP:
        for k in list(_VERIFIED)[:_VERIFIED_CAP // 2]:
            del _VERIFIED[k]
    _VERIFIED[digest] = True


# one CompiledStage per plan digest, process-wide: catalog entry points
# build plans per call, and the stage's compiled programs must survive
# across calls.  Bounded: oldest half dropped past the cap (plan digests
# are few — catalog shapes x capacity steps).
_STAGE_MEMO: Dict[str, CompiledStage] = {}
_STAGE_MEMO_CAP = 128


def compile_stage(plan: ir.StagePlan) -> CompiledStage:
    cs = _STAGE_MEMO.get(plan.digest)
    if cs is None:
        _verify_once(plan)
        cs = CompiledStage(plan)
        if len(_STAGE_MEMO) >= _STAGE_MEMO_CAP:
            for k in list(_STAGE_MEMO)[:_STAGE_MEMO_CAP // 2]:
                del _STAGE_MEMO[k]
        _STAGE_MEMO[plan.digest] = cs
    return cs


# ------------------------------------------------------------- pipelines


class CompiledPipeline:
    """Stages executed in order; columns carried across each boundary
    feed the next stage's matching ScanBind by name (one process:
    direct handoff)."""

    def __init__(self, pipeline: ir.Pipeline):
        _verify_once(pipeline)      # seam checks on top of per-stage
        self.pipeline = pipeline
        self.stages = [compile_stage(s) for s in pipeline.stages]

    def run(self, inputs: Mapping[str, Sequence]) -> tuple:
        # semantic stage cache: with the result cache armed, each stage
        # consults a content-keyed entry (plan digest + input bytes)
        # before executing — an unchanged upstream stage
        # short-circuits and only the delta recomputes
        from spark_rapids_tpu_torch.perf import result_cache as _rc
        cache = _rc.CACHE if _rc.cache_enabled() else None
        feed: Dict[str, object] = {}
        out: Tuple = ()
        for cs in self.stages:
            stage_inputs = {}
            for inp in cs.plan.inputs:
                if feed and all(c.name in feed for c in inp.columns):
                    stage_inputs[inp.name] = tuple(
                        feed[c.name] for c in inp.columns)
                else:
                    stage_inputs[inp.name] = inputs[inp.name]
            if cache is not None:
                out = cache.stage_run(cs, stage_inputs)
            else:
                out = cs.run(stage_inputs)
            feed.update(zip(cs.plan.outputs, out))
        return out


def compile_pipeline(pipeline: ir.Pipeline) -> CompiledPipeline:
    return CompiledPipeline(pipeline)


def fused_pipeline_fn(pipeline: ir.Pipeline, reduce_group=None):
    """The WHOLE pipeline as one function (boundaries elided, ``Reduce``
    -> all_reduce over ``reduce_group``, a distributed/mesh.Mesh) for a
    rank of a mesh program: :class:`FusedProgram` compiles it as one
    graph per rank, the collectives inside.  Args are the external
    inputs' columns flattened in declaration order; boundary-fed
    ScanBinds (every column already defined upstream) consume no args.
    Returns (fn, n_args)."""
    _verify_once(pipeline)
    defined = set()
    external = []
    for stage in pipeline.stages:
        for inp in stage.inputs:
            if not all(c.name in defined for c in inp.columns):
                external.append(inp)
                defined.update(c.name for c in inp.columns)
        for node in stage.nodes:
            defined.update(node.outs())
    n_args = sum(len(i.columns) for i in external)
    last = pipeline.stages[-1]

    def fn(*args):
        env: Dict[str, object] = {"__device__": args[0].device}
        pos = 0
        for inp in external:
            for spec in inp.columns:
                env[spec.name] = args[pos]
                pos += 1
        for stage in pipeline.stages:
            for inp in stage.inputs:
                env[f"__mask__{inp.name}"] = _all_true_mask(
                    env[inp.columns[0].name])
            for node in stage.nodes:
                _eval_node(node, env, reduce_group)
        return tuple(env[o] for o in last.outputs)

    return fn, n_args


class FusedProgram:
    """``fn`` as one ``torch.compile(fullgraph=True, dynamic=False)``
    program, with its code object renamed to ``name`` (dynamo keeps
    graphs per code object).  ``compiles`` counts the graphs the
    backend compiled, ``compile_s`` the first call's wall (tracing and
    compiling), ``calls`` the calls.  The collectives of a mesh program
    (functional all_reduce) trace into the graph, so a rank runs one
    graph between its inputs and its outputs."""

    def __init__(self, fn, name: str):
        fn = types.FunctionType(fn.__code__.replace(co_name=name),
                                fn.__globals__, name, None,
                                fn.__closure__)
        self.name = name
        self.compiles = 0
        self.compile_s = None
        self.calls = 0

        def backend(gm, example_inputs):
            from torch._inductor.compile_fx import compile_fx
            self.compiles += 1
            return compile_fx(gm, example_inputs)

        self._compiled = torch.compile(fn, backend=backend,
                                       fullgraph=True, dynamic=False)

    def __call__(self, *args):
        t0 = time.perf_counter()
        out = self._compiled(*args)
        if self.compile_s is None:
            _sync(out)
            self.compile_s = time.perf_counter() - t0
        self.calls += 1
        return out
