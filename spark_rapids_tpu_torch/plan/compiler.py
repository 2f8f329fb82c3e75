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
``SPARK_RAPIDS_TPU_STAGE_FUSION=1|0`` picks the engine.

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

Left out until their queue items land: the stats taps and the stage
profile records (ROADMAP A14), fused-vs-op-by-op calibration (A14:
``auto`` takes the fused engine meanwhile), spilled execution (A12),
plan verification (A8), the result cache (A14) and the whole-pipeline
function for multi-process runs (A10).
"""

import os
import time
import types
from typing import Dict, Mapping, Sequence, Tuple

import torch

from spark_rapids_tpu_torch.ops.device_join import inner_join_device
from spark_rapids_tpu_torch.ops.joins import _lex_order
from spark_rapids_tpu_torch.perf.calibrate import operands_digest
from spark_rapids_tpu_torch.perf.jit_cache import bucket_rows
from spark_rapids_tpu_torch.plan import ir

# ------------------------------------------------------------------- knobs


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


def _eval_node(node, env) -> None:
    """Evaluate one node into ``env`` (shared by the fused program and
    the op-by-op walk — one evaluator, so the two engines cannot
    drift)."""
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
        # identity in one process; ROADMAP A10 reduces across ranks here
        env[node.out] = _eval(node.value, env)
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

    def _fused_callable(self):
        """The evaluator as a pure fn(*args): binds the flat arg list
        back to named columns and row masks, then walks the nodes."""
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
            return tuple(env[o] for o in plan.outputs)

        return fn

    # ------------------------------------------------------------ engines

    def _run_digest(self, parts) -> str:
        """stage-plan digest | all-operand schema digest: the fused
        engine's compile key with the bucket and the device."""
        return f"{self.plan.digest}|{operands_digest(parts)}"

    def _compile(self, key) -> object:
        """torch.compile of the evaluator for one key, with a code
        object of its own: dynamo keeps its compiled graphs per code
        object and runs a frame eagerly once that object has been
        recompiled past its limit, so stages sharing one closure's
        code would quietly fall back to eager after a few keys."""
        fn = self._fused_callable()
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

    def _run_fused(self, inputs) -> tuple:
        args, parts, bucket = self._bind_args(inputs)
        key = (self._run_digest(parts), bucket, str(args[0].device))
        fn = self._fused.get(key)
        if fn is not None:
            return fn(*args)
        fn = self._compile(key)
        before = self.compiles
        t0 = time.perf_counter()
        out = fn(*args)
        self.compile_seconds[key] = time.perf_counter() - t0
        if self.compiles == before:
            raise RuntimeError(
                f"stage {self.plan.name!r} ran without compiling: the "
                "fused engine must not fall back to eager")
        self._fused[key] = fn
        return out

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

    # -------------------------------------------------------------- entry

    def run(self, inputs: Mapping[str, Sequence]) -> tuple:
        """Execute the stage under the current fusion mode.  'auto'
        takes the fused engine until the measured calibration of
        ROADMAP A14 lands."""
        if fusion_mode() == "off":
            return self.run_unfused(inputs)
        return self._run_fused(inputs)


# one CompiledStage per plan digest, process-wide: catalog entry points
# build plans per call, and the stage's compiled programs must survive
# across calls.  Bounded: oldest half dropped past the cap (plan digests
# are few — catalog shapes x capacity steps).
_STAGE_MEMO: Dict[str, CompiledStage] = {}
_STAGE_MEMO_CAP = 128


def compile_stage(plan: ir.StagePlan) -> CompiledStage:
    # ROADMAP A8: the JAX package verifies each new plan once here
    cs = _STAGE_MEMO.get(plan.digest)
    if cs is None:
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
        self.pipeline = pipeline
        self.stages = [compile_stage(s) for s in pipeline.stages]

    def run(self, inputs: Mapping[str, Sequence]) -> tuple:
        # ROADMAP A14: the JAX package's semantic result cache can
        # short-circuit an unchanged stage here
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
            out = cs.run(stage_inputs)
            feed.update(zip(cs.plan.outputs, out))
        return out


def compile_pipeline(pipeline: ir.Pipeline) -> CompiledPipeline:
    return CompiledPipeline(pipeline)
