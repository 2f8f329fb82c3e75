"""plan-verify: static checker over stage plans (the port of the JAX
package's ``analysis/plan_verify.py``: the same checks, verdicts and
messages over the port's ``plan/ir.py``).

The stage compiler (plan/compiler.py) runs a whole plan as one compiled
program or op by op, so a malformed plan would surface as a dtype or
shape error from deep inside a compiled graph with no mention of which
NODE was wrong.  This verifier runs BEFORE anything compiles
(compile_stage/compile_pipeline call it once per digest, memoized;
``SPARK_RAPIDS_TPU_PLAN_VERIFY=0`` is the escape hatch) and turns every
class of malformation into a typed :class:`PlanVerifyError` that NAMES
the offending node:

  * **SSA / binding**: a node referencing a column no input or
    earlier node defines, duplicate column definitions, outputs that
    nothing defines, ``Mask`` over a non-input name;
  * **node legality**: unknown Bin/Un ops, Sort ``num_keys`` out of
    range, Reduce kinds outside {sum, any}, Rollup modes outside
    {rollup, cube}, non-positive capacities/cardinalities/segment
    counts, backwards slices;
  * **digest purity**: every node must be hashable with
    recursively-immutable fields (str/int/float/bool/None/tuple/
    Expr/ColSpec); a list or dict smuggled into a frozen dataclass
    field makes ``plan.digest`` unstable across processes and silently
    forks the compiled-stage memo;
  * **dtype flow** (when the caller supplies input dtypes): the
    expression algebra's promotion is walked against the reference's
    promotion lattice (:data:`_PROMOTE`, the JAX package's
    ``jnp.promote_types`` answers kept here as data): boolean
    conditions for Where/filter-and, integer ids for gathers and
    segment aggregates, integer join keys;
  * **pipeline seams**: boundary count matches stage count, carried
    columns exist in the producing stage, and a boundary-fed ScanBind
    consumes ONLY carried columns (a column that exists upstream but
    is not carried works single-process and breaks distributed: the
    exact drift this check forbids).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from spark_rapids_tpu_torch.plan import ir

_BIN_OPS = frozenset((
    "add", "sub", "mul", "div", "floordiv", "mod", "and", "or",
    "eq", "ne", "lt", "le", "gt", "ge", "max", "min"))
_UN_OPS = frozenset(("neg", "not", "sum", "i32", "i64", "f64", "b"))
_REDUCE_KINDS = frozenset(("sum", "any"))
_ROLLUP_MODES = frozenset(("rollup", "cube"))

_COMPARES = frozenset(("eq", "ne", "lt", "le", "gt", "ge"))

_IMMUTABLE_SCALARS = (str, int, float, bool, bytes, type(None))


class PlanVerifyError(ValueError):
    """Typed verification failure.  ``node`` is the offending node's
    canonical key (or a stage/pipeline name for seam errors) so the
    error message survives serialization across the shim."""

    def __init__(self, plan_name: str, node: str, reason: str):
        self.plan_name = plan_name
        self.node = node
        self.reason = reason
        super().__init__(
            f"plan {plan_name!r}: node {node}: {reason}")


def _node_label(node) -> str:
    try:
        k = node.key()
    except Exception:
        k = repr(node)
    return f"{type(node).__name__} {k[:80]}"


# ----------------------------------------------------------- purity


def _check_immutable(plan_name: str, label: str, value,
                     path: str) -> None:
    if isinstance(value, _IMMUTABLE_SCALARS):
        return
    if isinstance(value, tuple):
        for i, v in enumerate(value):
            _check_immutable(plan_name, label, v, f"{path}[{i}]")
        return
    if isinstance(value, (ir.Expr, ir.Node, ir.ColSpec,
                          ir.ShuffleBoundary)):
        for f, v in getattr(value, "__dataclass_fields__", {}).items():
            _check_immutable(plan_name, label, getattr(value, f),
                             f"{path}.{f}")
        return
    raise PlanVerifyError(
        plan_name, label,
        f"field {path} holds a {type(value).__name__} — node fields "
        f"must be immutable/hashable or the plan digest forks the "
        f"jit cache")


def _check_purity(plan_name: str, node) -> None:
    label = _node_label(node)
    _check_immutable(plan_name, label, node, "node")
    try:
        hash(node)
    except TypeError as e:
        raise PlanVerifyError(
            plan_name, label, f"node is unhashable ({e})") from e
    key = node.key()
    if not isinstance(key, str) or not key:
        raise PlanVerifyError(
            plan_name, label, "key() must return a non-empty string")


# ------------------------------------------------------ expr walking


def _expr_refs(e, out: List[Tuple[str, str]]) -> None:
    """Collect ('col'|'mask', name) references under an expression."""
    if isinstance(e, ir.Col):
        out.append(("col", e.name))
    elif isinstance(e, ir.Mask):
        out.append(("mask", e.input))
    elif isinstance(e, ir.Bin):
        _expr_refs(e.a, out)
        _expr_refs(e.b, out)
    elif isinstance(e, (ir.Un, ir.Sl)):
        _expr_refs(e.a, out)
    elif isinstance(e, ir.Where):
        _expr_refs(e.cond, out)
        _expr_refs(e.a, out)
        _expr_refs(e.b, out)
    elif isinstance(e, ir.Idx):
        _expr_refs(e.src, out)
        _expr_refs(e.idx, out)
    elif isinstance(e, ir.Stack):
        for p in e.parts:
            _expr_refs(p, out)


def _check_expr_ops(plan_name: str, label: str, e) -> None:
    if isinstance(e, ir.Bin):
        if e.op not in _BIN_OPS:
            raise PlanVerifyError(plan_name, label,
                                  f"unknown binary op {e.op!r}")
        _check_expr_ops(plan_name, label, e.a)
        _check_expr_ops(plan_name, label, e.b)
    elif isinstance(e, ir.Un):
        if e.op not in _UN_OPS:
            raise PlanVerifyError(plan_name, label,
                                  f"unknown unary op {e.op!r}")
        _check_expr_ops(plan_name, label, e.a)
    elif isinstance(e, ir.Where):
        for sub in (e.cond, e.a, e.b):
            _check_expr_ops(plan_name, label, sub)
    elif isinstance(e, ir.Idx):
        _check_expr_ops(plan_name, label, e.src)
        _check_expr_ops(plan_name, label, e.idx)
    elif isinstance(e, ir.Sl):
        if e.start < 0 or e.stop < e.start:
            raise PlanVerifyError(
                plan_name, label,
                f"backwards slice [{e.start}:{e.stop}]")
        _check_expr_ops(plan_name, label, e.a)
    elif isinstance(e, ir.Arange):
        if e.n < 0:
            raise PlanVerifyError(plan_name, label,
                                  f"negative Arange({e.n})")
    elif isinstance(e, ir.Stack):
        if not e.parts:
            raise PlanVerifyError(plan_name, label, "empty Stack")
        for p in e.parts:
            _check_expr_ops(plan_name, label, p)


def _node_exprs(node) -> List[ir.Expr]:
    out: List[ir.Expr] = []
    for f in getattr(node, "__dataclass_fields__", {}):
        v = getattr(node, f)
        if isinstance(v, ir.Expr):
            out.append(v)
        elif isinstance(v, tuple):
            out.extend(x for x in v if isinstance(x, ir.Expr))
    return out


# ------------------------------------------------------- dtype flow


class _Weak:
    """A weak python literal: adopts the other operand's dtype family
    exactly like an unpinned literal in the hand kernels."""

    def __init__(self, kind: str):  # 'int' | 'float' | 'bool'
        self.kind = kind

    def __repr__(self):
        return f"weak-{self.kind}"


# The reference's promotion lattice (64-bit types on) over every dtype
# the plan IR admits: row ``a``, column ``b`` (in _PROMOTE_ORDER) is
# the dtype ``a op b`` takes.  torch.promote_types is not used: it
# answers differently for mixed signed/unsigned pairs (int8 with
# uint64) and has no promotion for uint16/32/64.
_SHORT = {"b": "bool", "i8": "int8", "i16": "int16", "i32": "int32",
          "i64": "int64", "u8": "uint8", "u16": "uint16",
          "u32": "uint32", "u64": "uint64", "f16": "float16",
          "bf16": "bfloat16", "f32": "float32", "f64": "float64"}
_PROMOTE_ORDER = ("b", "i8", "i16", "i32", "i64", "u8", "u16", "u32",
                  "u64", "f16", "bf16", "f32", "f64")
_PROMOTE_ROWS = {
    "b": "b i8 i16 i32 i64 u8 u16 u32 u64 f16 bf16 f32 f64",
    "i8": "i8 i8 i16 i32 i64 i16 i32 i64 f64 f16 bf16 f32 f64",
    "i16": "i16 i16 i16 i32 i64 i16 i32 i64 f64 f16 bf16 f32 f64",
    "i32": "i32 i32 i32 i32 i64 i32 i32 i64 f64 f16 bf16 f32 f64",
    "i64": "i64 i64 i64 i64 i64 i64 i64 i64 f64 f16 bf16 f32 f64",
    "u8": "u8 i16 i16 i32 i64 u8 u16 u32 u64 f16 bf16 f32 f64",
    "u16": "u16 i32 i32 i32 i64 u16 u16 u32 u64 f16 bf16 f32 f64",
    "u32": "u32 i64 i64 i64 i64 u32 u32 u32 u64 f16 bf16 f32 f64",
    "u64": "u64 f64 f64 f64 f64 u64 u64 u64 u64 f16 bf16 f32 f64",
    "f16": "f16 f16 f16 f16 f16 f16 f16 f16 f16 f16 f32 f32 f64",
    "bf16": "bf16 bf16 bf16 bf16 bf16 bf16 bf16 bf16 bf16 f32 bf16 "
            "f32 f64",
    "f32": "f32 f32 f32 f32 f32 f32 f32 f32 f32 f32 f32 f32 f64",
    "f64": "f64 f64 f64 f64 f64 f64 f64 f64 f64 f64 f64 f64 f64",
}
_PROMOTE: Dict[Tuple[str, str], str] = {
    (_SHORT[a], _SHORT[b]): _SHORT[c]
    for a, row in _PROMOTE_ROWS.items()
    for b, c in zip(_PROMOTE_ORDER, row.split())}


def promote_types(a, b) -> str:
    """The reference lattice's join of two dtype names; TypeError for
    a name the plan IR does not admit."""
    out = _PROMOTE.get((str(a), str(b)))
    if out is None:
        bad = str(a) if (str(a), "bool") not in _PROMOTE else str(b)
        raise TypeError(f"dtype {bad!r} is not a plan IR dtype")
    return out


def _promote(plan_name: str, label: str, a, b):
    if isinstance(a, _Weak) and isinstance(b, _Weak):
        return a if a.kind == "float" or b.kind != "float" else b
    if isinstance(a, _Weak):
        a, b = b, a
    if isinstance(b, _Weak):
        if b.kind == "float" and not str(a).startswith("float"):
            return "float64"  # weak float promotes integer operands
        return a
    try:
        return promote_types(a, b)
    except Exception as e:
        raise PlanVerifyError(
            plan_name, label,
            f"dtypes {a} and {b} do not promote: {e}") from e


def _is_integer(dt) -> bool:
    return (isinstance(dt, _Weak) and dt.kind == "int") or (
        isinstance(dt, str) and (dt.startswith("int")
                                 or dt.startswith("uint")))


def _is_bool(dt) -> bool:
    return (isinstance(dt, _Weak) and dt.kind == "bool") or dt == "bool"


def _expr_dtype(plan_name: str, label: str, e, env: Dict[str, object]):
    """Static dtype of an expression under ``env`` (column -> dtype
    string or _Weak).  Mirrors compiler._eval's promotion behavior."""
    if isinstance(e, ir.Col):
        return env[e.name]
    if isinstance(e, ir.Mask):
        return "bool"
    if isinstance(e, ir.Lit):
        if e.dtype is not None:
            return str(e.dtype)
        if isinstance(e.value, bool):
            return _Weak("bool")
        if isinstance(e.value, int):
            return _Weak("int")
        if isinstance(e.value, float):
            return _Weak("float")
        return _Weak("int")
    if isinstance(e, ir.Bin):
        a = _expr_dtype(plan_name, label, e.a, env)
        b = _expr_dtype(plan_name, label, e.b, env)
        if e.op in _COMPARES:
            _promote(plan_name, label, a, b)   # must be promotable
            return "bool"
        if e.op in ("and", "or"):
            for side, dt in (("left", a), ("right", b)):
                if not (_is_bool(dt) or _is_integer(dt)):
                    raise PlanVerifyError(
                        plan_name, label,
                        f"bitwise {e.op!r} over non-bool/int "
                        f"{side} operand ({dt})")
            return _promote(plan_name, label, a, b)
        if e.op == "div":
            p = _promote(plan_name, label, a, b)
            return p if str(p).startswith("float") else "float64"
        return _promote(plan_name, label, a, b)
    if isinstance(e, ir.Un):
        a = _expr_dtype(plan_name, label, e.a, env)
        if e.op == "not":
            return a
        if e.op == "neg" or e.op == "sum":
            return a
        return {"i32": "int32", "i64": "int64",
                "f64": "float64", "b": "bool"}[e.op]
    if isinstance(e, ir.Where):
        c = _expr_dtype(plan_name, label, e.cond, env)
        if not _is_bool(c):
            raise PlanVerifyError(
                plan_name, label,
                f"Where condition has dtype {c}, expected bool")
        return _promote(plan_name, label,
                        _expr_dtype(plan_name, label, e.a, env),
                        _expr_dtype(plan_name, label, e.b, env))
    if isinstance(e, ir.Idx):
        idx = _expr_dtype(plan_name, label, e.idx, env)
        if not (_is_integer(idx) or _is_bool(idx)):
            raise PlanVerifyError(
                plan_name, label,
                f"gather index has dtype {idx}, expected integer")
        return _expr_dtype(plan_name, label, e.src, env)
    if isinstance(e, ir.Arange):
        return str(e.dtype)
    if isinstance(e, ir.Sl):
        return _expr_dtype(plan_name, label, e.a, env)
    if isinstance(e, ir.Stack):
        dts = [_expr_dtype(plan_name, label, p, env) for p in e.parts]
        out = dts[0]
        for d in dts[1:]:
            out = _promote(plan_name, label, out, d)
        return out
    raise PlanVerifyError(plan_name, label,
                          f"unknown expr {type(e).__name__}")


def _require_int(plan_name: str, label: str, what: str, dt) -> None:
    if not _is_integer(dt):
        raise PlanVerifyError(
            plan_name, label, f"{what} has dtype {dt}, expected an "
            f"integer dtype")


# ------------------------------------------------------- stage verify


def verify_stage(plan: ir.StagePlan,
                 input_dtypes: Optional[Dict[str, Tuple[str, ...]]]
                 = None) -> ir.StagePlan:
    """Verify one stage plan; returns it unchanged on success, raises
    :class:`PlanVerifyError` naming the offending node otherwise.
    ``input_dtypes`` (input name -> one dtype string per column)
    additionally enables dtype-flow checking."""
    name = plan.name
    defined: Dict[str, object] = {}
    input_names = set()
    for inp in plan.inputs:
        _check_purity(name, inp)
        if inp.name in input_names:
            raise PlanVerifyError(name, _node_label(inp),
                                  f"duplicate input {inp.name!r}")
        input_names.add(inp.name)
        if not inp.columns:
            raise PlanVerifyError(name, _node_label(inp),
                                  "ScanBind with no columns")
        dts: Tuple[str, ...] = ()
        if input_dtypes is not None:
            dts = tuple(input_dtypes.get(inp.name, ()))
            if dts and len(dts) != len(inp.columns):
                raise PlanVerifyError(
                    name, _node_label(inp),
                    f"input {inp.name!r} declares "
                    f"{len(inp.columns)} columns but "
                    f"{len(dts)} dtypes were supplied")
        for i, spec in enumerate(inp.columns):
            if spec.name in defined:
                raise PlanVerifyError(
                    name, _node_label(inp),
                    f"duplicate column {spec.name!r}")
            defined[spec.name] = dts[i] if i < len(dts) else None

    check_dtypes = input_dtypes is not None and all(
        v is not None for v in defined.values())

    for node in plan.nodes:
        label = _node_label(node)
        _check_purity(name, node)

        # -- duplicate definitions (before dtype flow assigns) --------
        for out in node.outs():
            if out in defined:
                raise PlanVerifyError(
                    name, label, f"duplicate column {out!r}")

        # -- SSA: every referenced column defined above ---------------
        refs: List[Tuple[str, str]] = []
        for e in _node_exprs(node):
            _check_expr_ops(name, label, e)
            _expr_refs(e, refs)
        for kind, ref in refs:
            if kind == "mask":
                if ref not in input_names:
                    raise PlanVerifyError(
                        name, label,
                        f"Mask({ref!r}) does not name a stage input")
            elif ref not in defined:
                raise PlanVerifyError(
                    name, label,
                    f"unbound column reference {ref!r}")

        # -- node-specific legality ----------------------------------
        if isinstance(node, ir.JoinProbe) and node.capacity < 1:
            raise PlanVerifyError(
                name, label,
                f"non-positive join capacity {node.capacity}")
        if isinstance(node, ir.SegmentSum) and node.num_segments < 1:
            raise PlanVerifyError(
                name, label,
                f"non-positive num_segments {node.num_segments}")
        if isinstance(node, ir.WindowSum) and node.num_partitions < 1:
            raise PlanVerifyError(
                name, label,
                f"non-positive num_partitions {node.num_partitions}")
        if isinstance(node, ir.Sort):
            if len(node.names) != len(node.operands):
                raise PlanVerifyError(
                    name, label,
                    f"{len(node.names)} names for "
                    f"{len(node.operands)} operands")
            if not (1 <= node.num_keys <= len(node.operands)):
                raise PlanVerifyError(
                    name, label,
                    f"num_keys {node.num_keys} outside "
                    f"[1, {len(node.operands)}]")
        if isinstance(node, ir.Reduce) \
                and node.kind not in _REDUCE_KINDS:
            raise PlanVerifyError(
                name, label, f"unknown Reduce kind {node.kind!r}")
        if isinstance(node, ir.Rollup):
            if node.mode not in _ROLLUP_MODES:
                raise PlanVerifyError(
                    name, label, f"unknown Rollup mode {node.mode!r}")
            if node.cards[0] < 1 or node.cards[1] < 1:
                raise PlanVerifyError(
                    name, label,
                    f"non-positive cardinalities {node.cards}")

        # -- dtype flow ----------------------------------------------
        if check_dtypes:
            env = defined
            if isinstance(node, ir.Project):
                env[node.out] = _expr_dtype(name, label, node.expr,
                                            env)
            elif isinstance(node, ir.JoinProbe):
                for side, e in (("left key", node.left),
                                ("right key", node.right)):
                    _require_int(name, label, side,
                                 _expr_dtype(name, label, e, env))
                p = node.prefix
                env[f"{p}.li"] = env[f"{p}.ri"] = "int32"
                env[f"{p}.valid"] = "bool"
                env[f"{p}.total"] = "int64"
            elif isinstance(node, ir.SegmentSum):
                _require_int(name, label, "segment ids",
                             _expr_dtype(name, label, node.ids, env))
                env[node.out] = _expr_dtype(name, label, node.value,
                                            env)
            elif isinstance(node, ir.Sort):
                for nm, op_ in zip(node.names, node.operands):
                    env[nm] = _expr_dtype(name, label, op_, env)
            elif isinstance(node, ir.Reduce):
                v = _expr_dtype(name, label, node.value, env)
                env[node.out] = "bool" if node.kind == "any" else v
            elif isinstance(node, ir.WindowSum):
                _require_int(name, label, "partition ids",
                             _expr_dtype(name, label, node.part, env))
                env[node.out] = _expr_dtype(name, label, node.value,
                                            env)
            elif isinstance(node, ir.WindowRank):
                _require_int(name, label, "partition ids",
                             _expr_dtype(name, label, node.part, env))
                _expr_dtype(name, label, node.order, env)
                env[node.out] = "int64"
            elif isinstance(node, ir.Rollup):
                for i, k in enumerate(node.keys):
                    _require_int(name, label, f"key {i}",
                                 _expr_dtype(name, label, k, env))
                c = _expr_dtype(name, label, node.mask, env)
                if not _is_bool(c):
                    raise PlanVerifyError(
                        name, label,
                        f"Rollup mask has dtype {c}, expected bool")
                v = _expr_dtype(name, label, node.value, env)
                for out in node.outs():
                    env[out] = ("int64" if ".cnt" in out else v)

        # -- definitions (dtype flow above already filled env slots
        # for the nodes it understands; plain None otherwise) ---------
        for out in node.outs():
            defined.setdefault(out, None)

    missing = [o for o in plan.outputs if o not in defined]
    if missing:
        raise PlanVerifyError(
            name, f"outputs of stage {name!r}",
            f"outputs reference undefined columns {missing}")
    return plan


def verify_pipeline(pipeline: ir.Pipeline,
                    input_dtypes: Optional[Dict[str, Tuple[str, ...]]]
                    = None) -> ir.Pipeline:
    """Verify every stage plus the shuffle-boundary seams."""
    name = pipeline.name
    if not pipeline.stages:
        raise PlanVerifyError(name, "pipeline", "no stages")
    if pipeline.boundaries and \
            len(pipeline.boundaries) != len(pipeline.stages) - 1:
        raise PlanVerifyError(
            name, "pipeline",
            f"{len(pipeline.boundaries)} boundaries for "
            f"{len(pipeline.stages)} stages (need stages-1)")
    for st in pipeline.stages:
        verify_stage(st, input_dtypes)
    for i, b in enumerate(pipeline.boundaries):
        prev, nxt = pipeline.stages[i], pipeline.stages[i + 1]
        label = f"ShuffleBoundary {b.key()}"
        if len(set(b.carry)) != len(b.carry):
            raise PlanVerifyError(name, label,
                                  "duplicate carried columns")
        prev_outs = set(prev.outputs)
        for c in b.carry:
            if c not in prev_outs:
                raise PlanVerifyError(
                    name, label,
                    f"carries {c!r} which stage {prev.name!r} does "
                    f"not output")
        carry = set(b.carry)
        for inp in nxt.inputs:
            cols = [c.name for c in inp.columns]
            if all(c in prev_outs for c in cols):
                # boundary-fed ScanBind: distributed execution ships
                # ONLY the carry, so consuming an uncarried upstream
                # column drifts single-process vs fleet
                stray = [c for c in cols if c not in carry]
                if stray:
                    raise PlanVerifyError(
                        name, _node_label(inp),
                        f"boundary-fed input consumes uncarried "
                        f"columns {stray}")
    return pipeline
