"""PyTorch port: srt-lint (``analysis/lint.py``), the metrics/knobs
catalog (``analysis/catalog.py``) and the plan verifier
(``analysis/plan_verify.py``) held against the JAX package's.

The port's lint runs over the JAX reference suite's source fixtures,
their paths mapped from ``spark_rapids_tpu/`` onto
``spark_rapids_tpu_torch/``, and must give the same findings (rule,
line, message) and suppression counts; its own tree must be clean.
Its catalog holds the JAX catalog's names and kinds.  The verifier
gives the same verdict and message as the JAX verifier on every catalog
plan (each package building its own from its ``plan/catalog.py``) and
every malformed plan of the reference suite, and its promotion table
equals ``jnp.promote_types`` on every dtype pair the IR admits.
Tolerance: exact everywhere.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_tpu.analysis import catalog as JCAT
from spark_rapids_tpu.analysis import lint as JL
from spark_rapids_tpu.analysis import plan_verify as JPV
from spark_rapids_tpu.plan import catalog as JPC
from spark_rapids_tpu.plan import compiler as JCOMP
from spark_rapids_tpu.plan import ir as JIR
from spark_rapids_tpu_torch.analysis import catalog as TCAT
from spark_rapids_tpu_torch.analysis import lint as TL
from spark_rapids_tpu_torch.analysis import plan_verify as TPV
from spark_rapids_tpu_torch.plan import catalog as TPC
from spark_rapids_tpu_torch.plan import compiler as TCOMP
from spark_rapids_tpu_torch.plan import ir as TIR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port_path(relpath):
    return relpath.replace("spark_rapids_tpu/", "spark_rapids_tpu_torch/",
                           1)


def findings(lint, src, relpath):
    found, suppressed = lint.lint_source(src, relpath)
    return [(f.rule, f.line, f.message) for f in found], suppressed


# ------------------------------------------------------------ lint rules

# the reference suite's fixtures (tests/test_srt_check.py TestLintRules):
# (source, path); the path is the JAX package's and is mapped for the
# port
FIXTURES = {
    "metric_prefix": ('M.counter("srtx_bad_name", "help")\n', None),
    "metric_not_catalogued": ('M.gauge("srt_not_a_real_family", "h")\n',
                              None),
    "metric_kind": ('M.counter("srt_op_latency_ns", "help")\n', None),
    "metric_good": ('M.histogram("srt_op_latency_ns", "help")\n', None),
    "knob_uncatalogued": ('import os\n'
                          'v = os.environ.get("SPARK_RAPIDS_TPU_NO_SUCH")\n',
                          None),
    "knob_good": ('import os\n'
                  'a = os.environ.get("SPARK_RAPIDS_TPU_METRICS")\n'
                  'b = os.environ["SPARK_RAPIDS_TPU_TRACE"]\n'
                  'c = os.getenv("SPARK_RAPIDS_TPU_JIT_CACHE")\n', None),
    "knob_prefix": ('import os, re\n'
                    'def pin(op):\n'
                    '    env = "SPARK_RAPIDS_TPU_PATH_" + op.upper()\n'
                    '    return os.environ.get(env)\n', None),
    "knob_bad_prefix": ('import os\n'
                        'def pin(op):\n'
                        '    env = "SPARK_RAPIDS_TPU_BOGUS_" + op\n'
                        '    return os.environ.get(env)\n', None),
    "knob_fstring": ('import os\n'
                     'def pin(op):\n'
                     '    return os.environ.get(f"SPARK_RAPIDS_TPU_X_{op}")\n',
                     None),
    "shim_raise": ('def f():\n    raise ValueError("nope")\n',
                   "spark_rapids_tpu/shim/jni_entry.py"),
    "shim_raise_elsewhere": ('def f():\n    raise ValueError("nope")\n',
                             "spark_rapids_tpu/ops/thing.py"),
    "digest_purity": ('import time, random, os\n'
                      'a = time.time()\n'
                      'b = random.random()\n'
                      'c = os.urandom(8)\n'
                      'd = time.monotonic_ns()\n',
                      "spark_rapids_tpu/plan/ir.py"),
    "digest_purity_elsewhere": ('import time\na = time.time()\n',
                                "spark_rapids_tpu/ops/thing.py"),
    "lock_blocking": ('import time, threading\n'
                      'lock = threading.Lock()\n'
                      'def f(sock):\n'
                      '    with lock:\n'
                      '        time.sleep(1)\n'
                      '        sock.sendall(b"x")\n'
                      '    time.sleep(2)\n',
                      "spark_rapids_tpu/server/thing.py"),
    "lock_blocking_elsewhere": ('import time\n'
                                'def f(lock):\n'
                                '    with lock:\n'
                                '        time.sleep(1)\n',
                                "spark_rapids_tpu/ops/thing.py"),
    "lock_nested_def": ('def f(lock):\n'
                        '    with lock:\n'
                        '        def worker():\n'
                        '            import time\n'
                        '            time.sleep(1)\n'
                        '        return worker\n',
                        "spark_rapids_tpu/observability/thing.py"),
    "bare_except": ('try:\n    pass\nexcept:\n    pass\n'
                    'try:\n    pass\nexcept BaseException:\n    x = 1\n'
                    'try:\n    pass\nexcept BaseException:\n    raise\n',
                    None),
    "lockdep_adoption": ('import threading\n'
                         'L = threading.Lock()\n'
                         'R = threading.RLock()\n',
                         "spark_rapids_tpu/server/server.py"),
    "lockdep_elsewhere": ('import threading\nL = threading.Lock()\n',
                          "spark_rapids_tpu/ops/thing.py"),
    "suppressed": ('import time\n'
                   '# srt-lint: disable=SRT005 test fixture reason\n'
                   'a = time.time()\n', "spark_rapids_tpu/plan/ir.py"),
    "reasonless": ('import time\n'
                   '# srt-lint: disable=SRT005\n'
                   'a = time.time()\n', "spark_rapids_tpu/plan/ir.py"),
    "file_wide": ('# srt-lint: disable-file=SRT005 golden fixture\n'
                  'import time\n'
                  'a = time.time()\n'
                  'b = time.time()\n', "spark_rapids_tpu/plan/ir.py"),
    "syntax": ("def broken(:\n", None),
    "json_golden": ('import os\n'
                    'v = os.environ.get("SPARK_RAPIDS_TPU_NOPE_A")\n'
                    'w = os.environ.get("SPARK_RAPIDS_TPU_NOPE_B")\n',
                    "spark_rapids_tpu/x.py"),
}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_lint_fixture_findings_match_reference(name):
    src, path = FIXTURES[name]
    path = path or "spark_rapids_tpu/somefile.py"
    ref = findings(JL, src, path)
    port = findings(TL, src, port_path(path))
    assert port == ref


def test_lint_json_output_matches_reference():
    src, path = FIXTURES["json_golden"]

    def render(lint, p):
        found, _ = lint.lint_source(src, p)
        return lint.LintResult(findings=sorted(
            found, key=lambda f: (f.path, f.line, f.rule, f.message)))

    ref = render(JL, path)
    port = render(TL, port_path(path))
    assert port.to_json() == ref.to_json().replace(path, port_path(path))
    assert port.render_text() == ref.render_text().replace(
        path, port_path(path))


def test_device_dispatch_under_a_lock_is_a_finding():
    """SRT006's blocking roots: the port's rule names torch where the
    JAX package's names jax, jnp and lax."""
    def src(call):
        return ('def f(lock, x):\n'
                '    with lock:\n'
                f'        return {call}\n')
    jax_path = "spark_rapids_tpu/memory/thing.py"
    port = port_path(jax_path)
    assert [f[0] for f in findings(JL, src("jnp.sum(x)"), jax_path)[0]] \
        == ["SRT006"]
    assert [f[0] for f in findings(TL, src("torch.sum(x)"), port)[0]] \
        == ["SRT006"]
    assert findings(TL, src("torch.cuda.synchronize()"), port)[0][0][2] \
        .startswith("torch.cuda.synchronize() inside `with lock:`")
    assert findings(TL, src("jnp.sum(x)"), port)[0] == []
    # the JAX package's paths are outside the port's scoped rules
    assert findings(TL, src("torch.sum(x)"), jax_path)[0] == []


def test_rule_tables_match_reference():
    assert TL.RULE_TABLE == JL.RULE_TABLE
    assert [r.id for r in TL.RULES] == [r.id for r in JL.RULES]
    for jt, tt in ((JL.DIGEST_MODULES, TL.DIGEST_MODULES),
                   (JL.LOCK_ADOPTED_MODULES, TL.LOCK_ADOPTED_MODULES),
                   (JL._LOCK_DIR_PREFIXES, TL._LOCK_DIR_PREFIXES)):
        assert tuple(port_path(p) for p in jt) == tuple(tt)
    for p in TL.DIGEST_MODULES + TL.LOCK_ADOPTED_MODULES:
        assert os.path.isfile(os.path.join(REPO, p)), p


def test_port_tree_is_clean():
    res = TL.lint_paths(REPO)
    assert res.findings == [], res.render_text()
    files = {os.path.relpath(f, REPO) for f in TL.default_files(REPO)}
    assert "chip_smoke.py" in files
    assert all(f == "chip_smoke.py"
               or f.startswith("spark_rapids_tpu_torch" + os.sep)
               for f in files)
    assert res.files == len(files)


def test_port_suppressions_cover_the_references():
    """Every JAX module with suppressed findings has a port twin with at
    least as many (the port's repairs carry the same reasons)."""
    for path in JL.default_files(REPO):
        rel = os.path.relpath(path, REPO)
        if not rel.startswith("spark_rapids_tpu" + os.sep):
            continue
        twin = os.path.join(REPO, port_path(rel))
        if not os.path.isfile(twin):
            continue
        with open(path) as f:
            _found, ref = JL.lint_source(f.read(), rel)
        with open(twin) as f:
            _found, port = TL.lint_source(f.read(), port_path(rel))
        assert port >= ref, rel


@pytest.mark.parametrize("rel,rule", [
    ("spark_rapids_tpu_torch/distributed/service.py", "SRT009"),
    ("spark_rapids_tpu_torch/distributed/transport.py", "SRT009"),
    ("spark_rapids_tpu_torch/distributed/service.py", "SRT007"),
    ("spark_rapids_tpu_torch/perf/calibrate.py", "SRT005")])
def test_the_repaired_findings_are_gone(rel, rule):
    with open(os.path.join(REPO, rel)) as f:
        src = f.read()
    found, suppressed = TL.lint_source(src, rel)
    assert [f for f in found if f.rule == rule] == []
    if rule == "SRT009":
        assert "threading.Lock()" not in src
    else:
        assert suppressed >= 1


# --------------------------------------------------------------- catalog


def test_catalog_names_and_kinds_match_reference():
    assert {k: v[0] for k, v in TCAT.METRICS.items()} == \
        {k: v[0] for k, v in JCAT.METRICS.items()}
    assert set(TCAT.KNOBS) == set(JCAT.KNOBS)
    assert TCAT.KNOB_WILDCARDS == JCAT.KNOB_WILDCARDS
    for name in ("SPARK_RAPIDS_TPU_METRICS", "SPARK_RAPIDS_TPU_PATH_X"):
        assert TCAT.knob_known(name) == JCAT.knob_known(name)


def test_catalog_descriptions_do_not_name_jax():
    for text in list(TCAT.KNOBS.values()) + [
            d for _k, d in TCAT.METRICS.values()]:
        assert "jax" not in text.lower(), text


def test_check_docs_is_clean_and_matches_reference(tmp_path):
    assert TCAT.check_docs(REPO) == JCAT.check_docs(REPO) == []
    # an empty tree: every name is missing, in the same words
    assert TCAT.check_docs(str(tmp_path)) == JCAT.check_docs(str(tmp_path))


def test_registered_families_are_catalogued():
    from spark_rapids_tpu_torch import observability as obs
    names = set(obs.METRICS._families)
    assert names <= set(TCAT.METRICS), sorted(names - set(TCAT.METRICS))


# ----------------------------------------------------------- plan-verify


def verdict(pv, plan, dtypes=None):
    """('ok', digest) or (node, reason) of the verifier."""
    try:
        if hasattr(plan, "stages"):
            pv.verify_pipeline(plan, dtypes)
        else:
            pv.verify_stage(plan, dtypes)
        return ("ok",)
    except pv.PlanVerifyError as e:
        return (e.plan_name, e.node, e.reason, str(e))


CATALOG_PLANS = {
    "q3": lambda c: c.q3_plan(base=1990, years=8, brands=16, manufact=8),
    "q9": lambda c: c.q9_plan(),
    "q67": lambda c: c.q67_plan(ncat=8, ncls=8),
    "cube": lambda c: c.cube_plan(ncat=8, ncls=8),
    "q89": lambda c: c.q89_plan(stores=8, items=16),
    "q5_pipeline": lambda c: c.q5_pipeline(stores=8, join_capacity=4096),
    "q72_pipeline": lambda c: c.q72_pipeline(
        items=64, max_week=16, join_capacity=4096, limit=100),
}


@pytest.mark.parametrize("name", sorted(CATALOG_PLANS))
def test_every_catalog_plan_verifies_like_the_reference(name):
    ref = CATALOG_PLANS[name](JPC)
    port = CATALOG_PLANS[name](TPC)
    assert port.digest == ref.digest
    assert verdict(TPV, port) == verdict(JPV, ref) == ("ok",)


def good_plan(ir):
    return ir.StagePlan(
        name="t_good",
        inputs=(ir.ScanBind("f", (ir.ColSpec("k"), ir.ColSpec("v"))),),
        nodes=(
            ir.Project("keep", ir.Bin("and", ir.Mask("f"),
                                      ir.Bin("gt", ir.Col("v"),
                                             ir.Lit(0)))),
            ir.Project("w", ir.Where(ir.Col("keep"), ir.Col("v"),
                                     ir.Lit(0, "int64"))),
            ir.SegmentSum("sums", ir.Col("w"), ir.Col("k"), 16),
        ),
        outputs=("sums",))


def one(ir, name, nodes, outputs, cols=("x",)):
    return ir.StagePlan(
        name, inputs=(ir.ScanBind("f", tuple(ir.ColSpec(c)
                                             for c in cols)),),
        nodes=nodes, outputs=outputs)


def two_stage(ir, carry, s2_cols=("a", "b"), name="t_pipe"):
    s1 = ir.StagePlan(
        "t_s1", inputs=(ir.ScanBind("f", (ir.ColSpec("x"),)),),
        nodes=(ir.Project("a", ir.Col("x")),
               ir.Project("b", ir.Col("x"))),
        outputs=("a", "b"))
    s2 = ir.StagePlan(
        "t_s2", inputs=(ir.ScanBind("carry", tuple(
            ir.ColSpec(c) for c in s2_cols), bucket=False),),
        nodes=(ir.Project("out", ir.Bin("add", ir.Col("a"),
                                        ir.Col(s2_cols[-1]))),),
        outputs=("out",))
    return ir.Pipeline(name, (s1, s2), (ir.ShuffleBoundary(carry),))


# (plan maker over an ir module, input dtypes or None): the reference
# suite's accepted and malformed plans, and a few more of each check
PLANS = {
    "good": (good_plan, None),
    "good_typed": (good_plan, {"f": ("int32", "int64")}),
    "unbound": (lambda ir: one(ir, "t_unbound",
                               (ir.Project("y", ir.Col("ghost")),),
                               ("y",)), None),
    "duplicate": (lambda ir: one(ir, "t_dup",
                                 (ir.Project("x", ir.Col("x")),),
                                 ("x",)), None),
    "unknown_bin": (lambda ir: one(ir, "t_op", (ir.Project(
        "y", ir.Bin("xor", ir.Col("x"), ir.Lit(1))),), ("y",)), None),
    "unknown_un": (lambda ir: one(ir, "t_un", (ir.Project(
        "y", ir.Un("abs", ir.Col("x"))),), ("y",)), None),
    "sort_keys": (lambda ir: one(ir, "t_sort", (ir.Sort(
        ("sx",), (ir.Col("x"),), num_keys=2),), ("sx",)), None),
    "reduce_kind": (lambda ir: one(ir, "t_red", (ir.Reduce(
        "r", ir.Col("x"), kind="mean"),), ("r",)), None),
    "capacity": (lambda ir: one(ir, "t_cap", (ir.JoinProbe(
        "j", ir.Col("x"), ir.Col("x"), 0),), ("j.total",)), None),
    "segments": (lambda ir: one(ir, "t_seg", (ir.SegmentSum(
        "s", ir.Col("x"), ir.Col("x"), 0),), ("s",)), None),
    "unhashable": (lambda ir: one(ir, "t_hash", (ir.Project(
        "y", ir.Lit([1, 2, 3])),), ("y",)), None),
    "mask": (lambda ir: one(ir, "t_mask", (ir.Project(
        "y", ir.Mask("ghost")),), ("y",)), None),
    "output": (lambda ir: one(ir, "t_out", (), ("ghost",)), None),
    "slice": (lambda ir: one(ir, "t_sl", (ir.Project(
        "y", ir.Sl(ir.Col("x"), 5, 2)),), ("y",)), None),
    "where_untyped": (lambda ir: one(ir, "t_dtype", (ir.Project(
        "y", ir.Where(ir.Col("x"), ir.Col("x"), ir.Lit(0))),), ("y",)),
        None),
    "where_int": (lambda ir: one(ir, "t_dtype", (ir.Project(
        "y", ir.Where(ir.Col("x"), ir.Col("x"), ir.Lit(0))),), ("y",)),
        {"f": ("int64",)}),
    "ids_int": (lambda ir: one(ir, "t_ids", (ir.SegmentSum(
        "s", ir.Col("v"), ir.Col("ids"), 8),), ("s",), ("v", "ids")),
        {"f": ("int64", "int32")}),
    "ids_float": (lambda ir: one(ir, "t_ids", (ir.SegmentSum(
        "s", ir.Col("v"), ir.Col("ids"), 8),), ("s",), ("v", "ids")),
        {"f": ("int64", "float64")}),
    "bitwise_float": (lambda ir: one(ir, "t_bw", (ir.Project(
        "y", ir.Bin("and", ir.Col("x"), ir.Col("x"))),), ("y",)),
        {"f": ("float32",)}),
    "dtype_count": (lambda ir: one(ir, "t_n", (), ("x",)),
                    {"f": ("int64", "int32")}),
    "pipe_good": (lambda ir: two_stage(ir, ("a", "b")), None),
    "pipe_uncarried": (lambda ir: two_stage(ir, ("a",),
                                            name="t_pipe_bad"), None),
    "pipe_ghost": (lambda ir: two_stage(ir, ("a", "b", "ghost"),
                                        name="t_carry_ghost"), None),
    "pipe_dup_carry": (lambda ir: two_stage(ir, ("a", "a")), None),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_verifier_verdict_and_message_match_reference(name):
    build, dtypes = PLANS[name]
    ref = verdict(JPV, build(JIR), dtypes)
    port = verdict(TPV, build(TIR), dtypes)
    assert port == ref
    assert (ref == ("ok",)) == name.startswith(("good", "where_untyped",
                                                "ids_int", "pipe_good"))


IR_DTYPES = ("bool", "int8", "int16", "int32", "int64", "uint8", "uint16",
             "uint32", "uint64", "float16", "bfloat16", "float32",
             "float64")


def test_promotion_table_equals_jnp_promote_types():
    for a in IR_DTYPES:
        for b in IR_DTYPES:
            assert TPV.promote_types(a, b) == str(
                jnp.promote_types(a, b)), (a, b)
    with pytest.raises(TypeError):
        TPV.promote_types("int64", "complex64")


def test_promotion_differs_from_torch_where_it_must():
    """The reason the port keeps a table: torch's lattice answers
    differently for mixed signed/unsigned pairs."""
    assert TPV.promote_types("int8", "uint64") == "float64"
    assert torch.promote_types(torch.int8, torch.uint8) == torch.int16
    assert TPV.promote_types("int8", "uint8") == "int16"
    assert np.dtype(TPV.promote_types("uint32", "int32")) == np.int64


# --------------------------------------------------------- compiler gate


def broken(ir, name):
    return one(ir, name, (ir.Project("y", ir.Col("ghost")),), ("y",))


def test_compile_stage_verifies_a_broken_plan(monkeypatch):
    monkeypatch.delenv("SPARK_RAPIDS_TPU_PLAN_VERIFY", raising=False)
    for comp, ir, pv in ((TCOMP, TIR, TPV), (JCOMP, JIR, JPV)):
        plan = broken(ir, "t_gate")
        comp._STAGE_MEMO.pop(plan.digest, None)
        comp._VERIFIED.pop(plan.digest, None)
        with pytest.raises(pv.PlanVerifyError) as ei:
            comp.compile_stage(plan)
        assert "ghost" in str(ei.value)
        assert plan.digest not in comp._STAGE_MEMO


def test_compile_pipeline_verifies_its_seams(monkeypatch):
    monkeypatch.delenv("SPARK_RAPIDS_TPU_PLAN_VERIFY", raising=False)
    for comp, ir, pv in ((TCOMP, TIR, TPV), (JCOMP, JIR, JPV)):
        bad = two_stage(ir, ("a",), name="t_gate_pipe")
        with pytest.raises(pv.PlanVerifyError) as ei:
            comp.compile_pipeline(bad)
        assert "uncarried" in str(ei.value)


def test_escape_hatch_skips_verification(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_TPU_PLAN_VERIFY", "0")
    plan = broken(TIR, "t_hatch")
    TCOMP._STAGE_MEMO.pop(plan.digest, None)
    TCOMP._VERIFIED.pop(plan.digest, None)
    assert TCOMP.compile_stage(plan) is not None
    assert plan.digest not in TCOMP._VERIFIED
    TCOMP._STAGE_MEMO.pop(plan.digest, None)


def test_verification_memoized_per_digest(monkeypatch):
    monkeypatch.delenv("SPARK_RAPIDS_TPU_PLAN_VERIFY", raising=False)
    plan = one(TIR, "t_memo", (TIR.Project("y", TIR.Col("x")),), ("y",))
    TCOMP._STAGE_MEMO.pop(plan.digest, None)
    TCOMP._VERIFIED.pop(plan.digest, None)
    calls = []
    real = TPV.verify_stage
    monkeypatch.setattr(TPV, "verify_stage",
                        lambda p, *a, **kw: (calls.append(1),
                                             real(p, *a, **kw))[1])
    TCOMP.compile_stage(plan)
    TCOMP._STAGE_MEMO.pop(plan.digest, None)
    TCOMP.compile_stage(plan)
    assert calls == [1]
    assert TCOMP._VERIFIED.get(plan.digest) is True
    TCOMP._STAGE_MEMO.pop(plan.digest, None)


def test_q3_runs_through_the_gate_like_the_reference(monkeypatch):
    monkeypatch.delenv("SPARK_RAPIDS_TPU_PLAN_VERIFY", raising=False)
    base, years, brands = 1990, 2, 4
    n, days = 64, years * 365
    rng = np.random.default_rng(0)
    host = {
        "s": (base + rng.integers(0, days, n), rng.integers(0, 8, n),
              rng.integers(1, 100, n).astype(np.int64)),
        "dims": (1 + (rng.integers(0, days, days) % 12),
                 base + np.arange(days) // 365,
                 rng.integers(0, brands, 8), rng.integers(0, 8, 8)),
    }
    outs = []
    for comp, cat, conv in (
            (TCOMP, TPC, lambda a: torch.from_numpy(np.asarray(a))),
            (JCOMP, JPC, np.asarray)):
        plan = cat.q3_plan(base=base, years=years, brands=brands,
                           manufact=4)
        cs = comp.compile_stage(plan)
        assert comp._VERIFIED.get(plan.digest) is True
        out = cs.run_unfused({k: tuple(conv(a) for a in v)
                              for k, v in host.items()})
        outs.append([np.asarray(o).tolist() for o in out])
    assert outs[0] == outs[1]


# ---------------------------------------------------------------- CLI
# (the reference suite's TestCli over the port's srt-check, each output
# held against the JAX CLI's where both lint the same file)


def cli(pkg, argv, capsys):
    import importlib
    mod = importlib.import_module(f"{pkg}.tools.srt_check")
    rc = mod.main(argv)
    return rc, capsys.readouterr().out


class TestCli:
    def test_list_rules(self, capsys):
        rc, out = cli("spark_rapids_tpu_torch", ["--list-rules"], capsys)
        assert rc == 0
        for rid in ("SRT000", "SRT003", "SRT005", "SRT006", "SRT008",
                    "SRT009"):
            assert rid in out
        assert (rc, out) == cli("spark_rapids_tpu", ["--list-rules"],
                                capsys)

    def test_lint_single_file_json_golden(self, tmp_path, capsys):
        import json
        bad = tmp_path / "spark_rapids_tpu_torch" / "plan"
        bad.mkdir(parents=True)
        (bad / "ir.py").write_text("import time\nt = time.time()\n")
        rc, out = cli("spark_rapids_tpu_torch",
                      ["--root", str(tmp_path), "--no-docs-check",
                       "--json", "spark_rapids_tpu_torch/plan/ir.py"],
                      capsys)
        assert rc == 1
        got = json.loads(out)
        assert got["version"] == 1 and got["files"] == 1
        assert [f["rule"] for f in got["findings"]] == ["SRT005"]
        assert got["findings"][0]["path"] == \
            "spark_rapids_tpu_torch/plan/ir.py"
        assert got["findings"][0]["line"] == 2

    def test_plan_mode_json(self, capsys):
        import json
        rc, out = cli("spark_rapids_tpu_torch", ["--plan", "--json"],
                      capsys)
        assert rc == 0
        got = json.loads(out)
        assert len(got["plans"]) == 7
        assert all(p["ok"] for p in got["plans"])
        names = {p["plan"] for p in got["plans"]}
        assert {"q3", "q9", "q67", "cube", "q89", "q5_pipeline",
                "q72_pipeline"} == names
        # each package builds its own plans: the same digests
        assert (rc, out) == cli("spark_rapids_tpu", ["--plan", "--json"],
                                capsys)

    def test_repo_tree_clean_via_cli(self, capsys):
        rc, out = cli("spark_rapids_tpu_torch", [], capsys)
        assert rc == 0
        assert "0 finding(s)" in out


# ------------------------------------------------------ doctor triage


class TestDoctorLockdep:
    def _bundle(self, tmp_path, trigger, journal_records):
        import json
        b = tmp_path / "incident-1-lockdep_cycle-1"
        b.mkdir()
        (b / "trigger.json").write_text(json.dumps(trigger))
        (b / "journal.jsonl").write_text(
            "\n".join(json.dumps(r) for r in journal_records))
        (b / "MANIFEST.json").write_text(json.dumps({"version": 1}))
        return str(b)

    @staticmethod
    def analyze(path):
        """The port doctor's findings, equal to the JAX doctor's."""
        from spark_rapids_tpu.tools import doctor as JD
        from spark_rapids_tpu_torch.tools import doctor
        findings = doctor.analyze(doctor.Bundle(path))
        assert findings == JD.analyze(JD.Bundle(path))
        return findings

    def test_doctor_ranks_lockdep_cycle_trigger(self, tmp_path):
        path = self._bundle(
            tmp_path,
            {"kind": "lockdep_cycle", "severity": "warn",
             "detail": {
                 "cycle": ["server.query_server", "shim.handles",
                           "server.query_server"],
                 "evidence": {"forward": {
                     "edge": ["shim.handles", "server.query_server"],
                     "stack": ["  File x.py, line 3, in f"]}}}},
            [{"kind": "lockdep", "event": "cycle", "t_ns": 1,
              "cycle": ["server.query_server", "shim.handles",
                        "server.query_server"]}])
        top = self.analyze(path)[0]
        assert top["kind"] == "lockdep_cycle"
        assert "server.query_server -> shim.handles" in top["message"]
        assert "ABBA" in top["message"]

    def test_doctor_surfaces_journal_lockdep_history(self, tmp_path):
        path = self._bundle(
            tmp_path,
            {"kind": "retry_exhausted", "severity": "error",
             "detail": {"name": "s", "errors": []}},
            [{"kind": "lockdep", "event": "blocking", "t_ns": 1,
              "op": "fileio.read_range", "held": ["perf.jit_cache"]},
             {"kind": "lockdep", "event": "cycle", "t_ns": 2,
              "cycle": ["a", "b", "a"]}])
        findings = self.analyze(path)
        kinds = [f["kind"] for f in findings]
        assert "lockdep_cycle" in kinds
        assert "lockdep_blocking" in kinds
        blocking = next(f for f in findings
                        if f["kind"] == "lockdep_blocking")
        assert "fileio.read_range" in blocking["message"]
        assert "perf.jit_cache" in blocking["message"]

    def test_doctor_reads_a_port_lockdep_cycle_bundle(self, tmp_path,
                                                      monkeypatch):
        """A real ABBA cycle in the port's lockdep freezes a
        lockdep_cycle bundle the doctor ranks first."""
        from spark_rapids_tpu_torch import observability as obs
        from spark_rapids_tpu_torch.analysis import lockdep
        monkeypatch.setenv("SPARK_RAPIDS_TPU_LOCKDEP", "1")
        lockdep.reset()
        obs.enable_flight_recorder(out_dir=str(tmp_path / "inc"),
                                   min_interval_s=0.0)
        try:
            a, b = lockdep.make_lock("t.A"), lockdep.make_lock("t.B")
            with a:
                with b:
                    pass
            with b:
                with a:
                    pass
        finally:
            obs.disable_flight_recorder()
            lockdep.reset()
        inc = tmp_path / "inc"
        bundles = sorted(n for n in os.listdir(inc)
                         if n.startswith("incident-"))
        assert bundles
        top = self.analyze(str(inc / bundles[-1]))[0]
        assert top["kind"] == "lockdep_cycle"
        assert "t.A" in top["message"] and "t.B" in top["message"]
