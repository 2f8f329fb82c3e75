"""PyTorch port: the stage IR and its compiler against the JAX package.

Plan digests and run digests equal the reference's; each semantics case
(dtype promotion, division by zero, out-of-range gathers and segment
ids, stable and float-keyed sorts, window and rollup nodes) runs through
the reference evaluator and the port's op-by-op walk on the same numpy
arrays, and all of them together through the port's fused engine, with
exact bytes and dtypes.  The fused engine compiles once per key, more
keys than dynamo's recompile limit, and never runs eagerly."""

import os

os.environ.setdefault("TORCHINDUCTOR_COMPILE_THREADS", "1")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from spark_rapids_tpu.plan import catalog as JC  # noqa: E402
from spark_rapids_tpu.plan import compiler as JPC  # noqa: E402
from spark_rapids_tpu.plan import ir as JIR  # noqa: E402
from spark_rapids_tpu_torch.models import tpcds as TT  # noqa: E402
from spark_rapids_tpu_torch.plan import catalog as TC  # noqa: E402
from spark_rapids_tpu_torch.plan import compiler as PC  # noqa: E402
from spark_rapids_tpu_torch.plan import ir as TIR  # noqa: E402

I32_MIN = -2**31
NAN = float("nan")


def _cases():
    """name -> (input columns, nodes(ir), outputs).  Every node reads
    the case's own columns; names are prefixed per case when the cases
    run together."""
    rng = np.random.default_rng(6)
    i32 = np.array([0, 1, 2, -5, 7, -7, I32_MIN, 2**31 - 1], np.int32)
    div = rng.integers(-4, 5, 8).astype(np.int32)
    div[[0, 3, 6]] = [0, 0, -1]
    f64 = np.array([0.0, -0.0, 5.5, -5.5, 1e300, -7.25, np.inf, -np.inf])
    fdiv = np.array([2.0, -2.0, 2.0, 2.0, -3.0, 0.5, 2.0, np.inf])
    ties = rng.integers(0, 3, 40).astype(np.int32)
    return {
        "pinned_lit_promotes": (
            {"a": i32},
            lambda ir: [ir.Project("o", ir.Bin("add", ir.Col("a"),
                                               ir.Lit(1, "int64")))],
            ["o"]),
        "where_pinned_lit": (
            {"c": rng.random(8) < 0.5, "a": i32},
            lambda ir: [ir.Project("o", ir.Where(
                ir.Col("c"), ir.Col("a"), ir.Lit(2**40, "int64")))],
            ["o"]),
        "true_div": (
            {"a": i32[1:6], "b": np.array([3, -2, 7, 4, 9], np.int32),
             "x": i32[1:6].astype(np.int64),
             "y": np.array([3, -2, 7, 4, 9], np.int64)},
            lambda ir: [ir.Project("o32", ir.Bin("div", ir.Col("a"),
                                                 ir.Col("b"))),
                        ir.Project("o64", ir.Bin("div", ir.Col("x"),
                                                 ir.Col("y"))),
                        ir.Project("ow", ir.Bin("div", ir.Col("a"),
                                                ir.Lit(2)))],
            ["o32", "o64", "ow"]),
        "int_floordiv_mod": (
            {"a": i32, "b": div},
            lambda ir: [ir.Project("q", ir.Bin("floordiv", ir.Col("a"),
                                               ir.Col("b"))),
                        ir.Project("r", ir.Bin("mod", ir.Col("a"),
                                               ir.Col("b")))],
            ["q", "r"]),
        "int_by_zero": (
            {"a": np.array([0, 1, 2, -5], np.int64)},
            lambda ir: [ir.Project("q", ir.Bin("floordiv", ir.Col("a"),
                                               ir.Lit(0))),
                        ir.Project("r", ir.Bin("mod", ir.Col("a"),
                                               ir.Lit(0))),
                        ir.Project("qp", ir.Bin("floordiv", ir.Col("a"),
                                                ir.Lit(0, "int64")))],
            ["q", "r", "qp"]),
        "literal_divisors": (
            {"a": i32},
            lambda ir: [ir.Project("q", ir.Bin("floordiv", ir.Col("a"),
                                               ir.Lit(7))),
                        ir.Project("r", ir.Bin("mod", ir.Col("a"),
                                               ir.Lit(-3))),
                        ir.Project("m", ir.Bin("floordiv", ir.Col("a"),
                                               ir.Lit(-1)))],
            ["q", "r", "m"]),
        "float_floordiv_mod": (
            {"a": f64, "b": fdiv},
            lambda ir: [ir.Project("q", ir.Bin("floordiv", ir.Col("a"),
                                               ir.Col("b"))),
                        ir.Project("r", ir.Bin("mod", ir.Col("a"),
                                               ir.Col("b")))],
            ["q", "r"]),
        "float_to_int_casts": (
            {"a": np.array([NAN, 1e30, -1e30, 2.7, -2.7, 2.0**63,
                            -2.0**63, 2.0**31])},
            lambda ir: [ir.Project("o64", ir.Un("i64", ir.Col("a"))),
                        ir.Project("o32", ir.Un("i32", ir.Col("a"))),
                        ir.Project("ob", ir.Un("b", ir.Col("a")))],
            ["o64", "o32", "ob"]),
        "weak_literals": (
            {"a": i32, "u": np.array([1, 200, 3, 4, 5, 6, 7, 8], np.uint8),
             "s": np.array([-1, 2, -3, 4, -5, 6, -7, 8], np.int8),
             "c": rng.random(8) < 0.5},
            lambda ir: [ir.Project("f", ir.Bin("mul", ir.Col("a"),
                                               ir.Lit(1.5))),
                        ir.Project("i", ir.Bin("add", ir.Col("a"),
                                               ir.Lit(3))),
                        ir.Project("us", ir.Bin("add", ir.Col("u"),
                                                ir.Col("s"))),
                        ir.Project("bi", ir.Bin("add", ir.Col("c"),
                                                ir.Lit(1))),
                        ir.Project("mx", ir.Bin("max", ir.Col("a"),
                                                ir.Lit(3))),
                        ir.Project("eq", ir.Bin("eq", ir.Col("a"),
                                                ir.Lit(7))),
                        ir.Project("nt", ir.Un("not", ir.Col("c")))],
            ["f", "i", "us", "bi", "mx", "eq", "nt"]),
        "idx_out_of_range": (
            {"i": np.array([5, -1, -9, 2, 3, -4], np.int32)},
            lambda ir: [ir.Project("o", ir.Idx(ir.Arange(4, "int64"),
                                               ir.Col("i")))],
            ["o"]),
        "segment_sum_drops_ids": (
            {"v": np.array([1, 2, 4, 8], np.int64),
             "g": np.array([-1, 5, 0, 2], np.int32)},
            lambda ir: [ir.SegmentSum("o", ir.Col("v"), ir.Col("g"), 3),
                        ir.Project("t", ir.Un("sum", ir.Col("g"))),
                        ir.Project("st", ir.Stack((ir.Col("t"),
                                                   ir.Lit(9, "int32"))))],
            ["o", "t", "st"]),
        "sort_keeps_ties_in_row_order": (
            {"k": ties, "k2": rng.integers(0, 2, 40).astype(np.int64),
             "v": np.arange(40, dtype=np.int64)},
            lambda ir: [ir.Sort(("k_s", "v_s"), (ir.Col("k"), ir.Col("v")),
                                num_keys=1),
                        ir.Sort(("a_s", "b_s", "v2_s"),
                                (ir.Col("k"), ir.Col("k2"), ir.Col("v")),
                                num_keys=2)],
            ["k_s", "v_s", "a_s", "b_s", "v2_s"]),
        "sort_float_keys": (
            {"k": np.array([0.0, -0.0, NAN, 1.0, -np.inf, 0.0, -NAN, -0.0,
                            np.inf, -1.0]),
             "v": np.arange(10, dtype=np.int32)},
            lambda ir: [ir.Sort(("k_s", "v_s"), (ir.Col("k"), ir.Col("v")),
                                num_keys=1)],
            ["k_s", "v_s"]),
        "window_sum": (
            {"p": np.array([0, 1, 0, 4, 2, 1, 7, -1, 0], np.int32),
             "v": np.arange(9, dtype=np.int64) * 10},
            lambda ir: [ir.WindowSum("o", ir.Col("p"), ir.Col("v"), 5)],
            ["o"]),
        "window_rank": (
            {"p": rng.integers(0, 3, 30).astype(np.int32),
             "s": rng.integers(0, 4, 30).astype(np.int64)},
            lambda ir: [ir.WindowRank("o", ir.Col("p"),
                                      ir.Un("neg", ir.Col("s")))],
            ["o"]),
        "rollup_and_cube": (
            {"k1": rng.integers(0, 3, 50).astype(np.int32),
             "k2": rng.integers(0, 4, 50).astype(np.int32),
             "v": rng.integers(-100, 1000, 50).astype(np.int64),
             "m": rng.random(50) < 0.8},
            lambda ir: [
                ir.Rollup("r", (ir.Col("k1"), ir.Col("k2")), (3, 4),
                          ir.Col("v"), ir.Col("m")),
                ir.Rollup("c", (ir.Col("k1"), ir.Col("k2")), (3, 4),
                          ir.Col("v"), ir.Col("m"), mode="cube"),
                ir.Reduce("any", ir.Col("m"), kind="any")],
            ["r.sum0", "r.cnt0", "r.sum1", "r.cnt1", "r.sumt", "r.cntt",
             "c.sum0", "c.cnt1", "c.sum2", "c.cnt2", "any"]),
    }


CASES = _cases()


def _plan(ir, name, case, prefix=""):
    cols, nodes, outs = case
    return ir.StagePlan(
        name, (ir.ScanBind("f", tuple(ir.ColSpec(prefix + c) for c in cols),
                           bucket=False),),
        tuple(_prefixed(ir, n, prefix) for n in nodes(ir)),
        tuple(prefix + o for o in outs))


def _prefixed(ir, node, prefix):
    """`node` with every column name it defines or reads prefixed."""
    import dataclasses
    if not prefix:
        return node
    if isinstance(node, (ir.Col,)):
        return ir.Col(prefix + node.name)
    if isinstance(node, tuple):
        return tuple(_prefixed(ir, x, prefix) for x in node)
    if not dataclasses.is_dataclass(node):
        return node
    kw = {}
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        if f.name in ("out", "prefix"):
            v = prefix + v
        elif f.name == "names":
            v = tuple(prefix + x for x in v)
        else:
            v = _prefixed(ir, v, prefix)
        kw[f.name] = v
    return type(node)(**kw)


def _ref_run(plan, cols):
    return JPC.CompiledStage(plan).run_unfused(
        {"f": tuple(jnp.asarray(a) for a in cols)})


def _same(got, want):
    """Equal dtypes, shapes and bytes; a NaN matches any NaN (its sign
    and payload are the arithmetic library's, in either package)."""
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.cpu().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.dtype == w.dtype, (i, g.dtype, w.dtype)
        assert g.shape == w.shape, (i, g.shape, w.shape)
        if g.dtype.kind == "f":
            nan = np.isnan(w)
            assert (np.isnan(g) == nan).all(), (i, g, w)
            g, w = g[~nan], w[~nan]
        assert g.tobytes() == w.tobytes(), (i, g, w)


# ------------------------------------------------------------ digests


@pytest.mark.parametrize("build", [
    lambda m: m.q5_partials_plan(16, 1 << 13),
    lambda m: m.q5_partials_plan(402, 1 << 23),
    lambda m: m.q5_finish_plan(16),
    lambda m: m.q5_pipeline(16, 1 << 13),
    lambda m: m.q72_partials_plan(64, 16, 1 << 18, 11_000 // 7),
    lambda m: m.q72_finish_plan(204_000, 16, 100, 11_000 // 7),
    lambda m: m.q72_pipeline(64, 16, 1 << 18, week0=11_000 // 7),
    lambda m: m.q72_pipeline(4, 16, 1 << 26, limit=7),
    lambda m: m.q3_plan(10_957, 3, 8, 2),
    lambda m: m.q3_plan(10_957, 5, 1000, 3, month=11, limit=100),
    lambda m: m.q9_plan(),
    lambda m: m.q67_plan(6, 5),
    lambda m: m.q67_plan(10, 16),
    lambda m: m.cube_plan(4, 3),
    lambda m: m.q89_plan(402, 204_000),
])
def test_catalog_digests_match_reference(build):
    ours, ref = build(TC), build(JC)
    assert ours.digest == ref.digest
    if isinstance(ref, JIR.StagePlan):
        assert [n.key() for n in ours.nodes] == \
            [n.key() for n in ref.nodes]


def test_run_digests_match_reference():
    d = TT.gen_q5(rows=3000, stores=16, days=60, device="cpu")
    for plan, inputs in (
            (TC.q5_partials_plan(16, 1 << 13),
             {"s": d[0:4], "r": d[4:8], "d": (d.d_date,)}),
            (TC.q5_finish_plan(16),
             {"xchg": (d.s_price[:16], d.s_price[:16], d.s_price[:16],
                       d.s_price[:16], torch.tensor(False)),
              "dims": (d.st_id,)})):
        ours = PC.CompiledStage(plan)
        ref = JPC.CompiledStage(JC.q5_partials_plan(16, 1 << 13)
                                if plan.name == "q5_partials"
                                else JC.q5_finish_plan(16))
        jin = {k: tuple(jnp.asarray(a.numpy()) for a in v)
               for k, v in inputs.items()}
        assert ours._shape_parts(inputs) == ref._shape_parts(jin)
        assert ours._run_digest(ours._shape_parts(inputs)[0]) == \
            ref._run_digest(ref._shape_parts(jin)[0])


# ---------------------------------------------------------- semantics


@pytest.mark.parametrize("name", sorted(CASES))
def test_semantics_match_reference_op_by_op(name):
    cols = list(CASES[name][0].values())
    want = _ref_run(_plan(JIR, name, CASES[name]), cols)
    got = PC.CompiledStage(_plan(TIR, name, CASES[name])).run_unfused(
        {"f": tuple(torch.from_numpy(a) for a in cols)})
    _same(got, want)


def test_every_case_fused_matches_reference_and_op_by_op(monkeypatch):
    """All cases in one stage through the fused engine: one compiled
    program, byte-equal to the reference and to the op-by-op walk."""
    monkeypatch.setenv("SPARK_RAPIDS_TPU_STAGE_FUSION", "1")
    cols, outs, want = [], [], []
    for name in sorted(CASES):
        case_cols = list(CASES[name][0].values())
        cols += case_cols
        want += list(_ref_run(_plan(JIR, name, CASES[name]), case_cols))
    parts = {}
    for name in sorted(CASES):
        parts[name] = _plan(TIR, name, CASES[name], prefix=name + ".")
    plan = TIR.StagePlan(
        "all_cases",
        (TIR.ScanBind("f", tuple(c for p in parts.values()
                                 for c in p.inputs[0].columns),
                      bucket=False),),
        tuple(n for p in parts.values() for n in p.nodes),
        tuple(o for p in parts.values() for o in p.outputs))
    st = PC.CompiledStage(plan)
    inputs = {"f": tuple(torch.from_numpy(a) for a in cols)}
    fused = st.run(inputs)
    assert st.compiles == 1
    _same(fused, want)
    _same(fused, [t.numpy() for t in st.run_unfused(inputs)])


def test_float_sums_and_weak_arrays_are_refused():
    f = {"f": (torch.tensor([1.0, 2.0]), torch.tensor([0, 1]),
               torch.tensor([True, False]))}
    cols = (TIR.ColSpec("v"), TIR.ColSpec("g"), TIR.ColSpec("c"))
    for node in (TIR.SegmentSum("o", TIR.Col("v"), TIR.Col("g"), 2),
                 TIR.WindowSum("o", TIR.Col("g"), TIR.Col("v"), 2),
                 TIR.Project("o", TIR.Where(TIR.Col("c"), TIR.Lit(0),
                                            TIR.Lit(1)))):
        st = PC.CompiledStage(TIR.StagePlan(
            "refused", (TIR.ScanBind("f", cols, bucket=False),), (node,),
            ("o",)))
        with pytest.raises(NotImplementedError):
            st.run_unfused(f)


# ------------------------------------------------------ fused engine


def _probe_plan():
    return TIR.StagePlan(
        "compile_probe", (TIR.ScanBind("f", (TIR.ColSpec("x"),)),),
        (TIR.Project("y", TIR.Where(TIR.Mask("f"),
                                    TIR.Bin("mul", TIR.Col("x"),
                                            TIR.Lit(3)), TIR.Lit(0))),
         TIR.Project("t", TIR.Un("sum", TIR.Col("y")))),
        ("t",))


def test_fused_engine_compiles_each_key_once(monkeypatch):
    """More row buckets than dynamo's recompile limit: each compiles
    exactly once (no key falls back to eager), and a second query in a
    bucket already seen compiles nothing."""
    monkeypatch.setenv("SPARK_RAPIDS_TPU_STAGE_FUSION", "1")
    st = PC.CompiledStage(_probe_plan())
    rows = [5 + (8 << k) for k in range(9)]   # buckets 16 .. 4096
    assert len(rows) > torch._dynamo.config.recompile_limit
    for n in rows:
        x = torch.arange(n, dtype=torch.int64)
        before = st.compiles
        (t,) = st.run({"f": (x,)})
        assert st.compiles == before + 1
        assert int(t) == 3 * int(x.sum())
    assert len(st._fused) == len(rows)
    for n in rows:
        x = torch.arange(n + 2, dtype=torch.int64)   # same bucket
        (t,) = st.run({"f": (x,)})
        assert int(t) == 3 * int(x.sum())
    assert st.compiles == len(rows)


def test_fused_engine_never_runs_eagerly(monkeypatch):
    """With dynamo switched off the stage refuses to run, and a graph
    break inside the stage raises instead of splitting the program."""
    monkeypatch.setenv("SPARK_RAPIDS_TPU_STAGE_FUSION", "1")
    x = {"f": (torch.arange(5, dtype=torch.int64),)}
    monkeypatch.setattr(torch._dynamo.config, "disable", True)
    with pytest.raises(RuntimeError, match="eager|no compiled frames"):
        PC.CompiledStage(_probe_plan()).run(x)
    monkeypatch.setattr(torch._dynamo.config, "disable", False)
    real = PC._gather

    def breaks(src, idx):
        torch._dynamo.graph_break()
        return real(src, idx)

    monkeypatch.setattr(PC, "_gather", breaks)
    plan = TIR.StagePlan(
        "breaks", (TIR.ScanBind("f", (TIR.ColSpec("x"),)),),
        (TIR.Project("y", TIR.Idx(TIR.Col("x"), TIR.Lit(0))),), ("y",))
    with pytest.raises(Exception, match="graph_break|graph break"):
        PC.CompiledStage(plan).run(x)


def test_fusion_mode_reads_the_environment(monkeypatch):
    for v, mode in (("0", "off"), ("1", "on"), ("", "auto"),
                    ("x", "auto")):
        monkeypatch.setenv("SPARK_RAPIDS_TPU_STAGE_FUSION", v)
        assert PC.fusion_mode() == mode == JPC.fusion_mode()
