"""PyTorch port: every package of the port binds the public names its
JAX counterpart's ``__init__`` binds, less the ones a later ROADMAP step
brings (``LATER``, each with its step; none is left), and every class
bound in both packages' ``__init__`` has in the port each public
attribute (method, property, static or class method) that the JAX
class defines.

The names a package binds are read from its ``__init__.py`` source
(imports, assignments, definitions, including inside ``try`` blocks), so
a submodule that another import happened to load never counts; then
every name the port must bind is resolved on the imported port package.
"""

import ast
import importlib
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# names of the JAX package's __init__ files that a later step brings
LATER = {}
# JAX packages the port does not have yet
LATER_PACKAGES = {}


def bound_names(path):
    """Public names a module's top level binds."""
    names = set()

    def visit(body):
        for node in body:
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                for a in node.names:
                    names.add((a.asname or a.name).split(".")[0])
            elif isinstance(node, ast.Assign):
                for target in node.targets:
                    if isinstance(target, ast.Name):
                        names.add(target.id)
            elif isinstance(node, ast.AnnAssign) and \
                    isinstance(node.target, ast.Name):
                names.add(node.target.id)
            elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                names.add(node.name)
            elif isinstance(node, ast.Try):
                visit(node.body)
                for h in node.handlers:
                    visit(h.body)
            elif isinstance(node, ast.If):
                visit(node.body)
                visit(node.orelse)

    with open(path) as f:
        visit(ast.parse(f.read()).body)
    return {n for n in names if not n.startswith("_")} - {"annotations"}


def packages():
    out = [""]
    for d in sorted(os.listdir(os.path.join(REPO, "spark_rapids_tpu"))):
        if os.path.exists(os.path.join(REPO, "spark_rapids_tpu", d,
                                       "__init__.py")):
            out.append(d)
    return out


def init_of(root, pkg):
    return os.path.join(REPO, root, pkg, "__init__.py")


@pytest.mark.parametrize("pkg", packages(), ids=lambda p: p or "<root>")
def test_port_package_binds_the_reference_names(pkg):
    if pkg in LATER_PACKAGES:
        assert not os.path.exists(init_of("spark_rapids_tpu_torch", pkg))
        return
    want = bound_names(init_of("spark_rapids_tpu", pkg))
    later = LATER.get(pkg, {})
    missing = sorted(want - bound_names(init_of("spark_rapids_tpu_torch",
                                                pkg)) - set(later))
    assert missing == [], f"{pkg or '<root>'} lacks {missing}"
    mod = importlib.import_module(
        "spark_rapids_tpu_torch" + (f".{pkg}" if pkg else ""))
    unresolved = sorted(n for n in want - set(later)
                        if not hasattr(mod, n))
    assert unresolved == []


@pytest.mark.parametrize("pkg", packages(), ids=lambda p: p or "<root>")
def test_later_names_are_still_missing_from_the_port(pkg):
    """A name listed as coming later is really missing: when its step
    lands, the list shrinks with it."""
    later = set(LATER.get(pkg, {}))
    want = bound_names(init_of("spark_rapids_tpu", pkg))
    have = bound_names(init_of("spark_rapids_tpu_torch", pkg))
    assert later <= want
    assert not later & have


@pytest.mark.parametrize("pkg", packages(), ids=lambda p: p or "<root>")
def test_port_classes_have_the_reference_methods(pkg):
    """For every class both packages' ``__init__`` bind under one name,
    the port's class (with its bases) has every public attribute the
    JAX class defines itself."""
    import inspect
    suffix = f".{pkg}" if pkg else ""
    ref = importlib.import_module("spark_rapids_tpu" + suffix)
    port = importlib.import_module("spark_rapids_tpu_torch" + suffix)
    names = bound_names(init_of("spark_rapids_tpu", pkg)) & bound_names(
        init_of("spark_rapids_tpu_torch", pkg))
    missing = {}
    for name in sorted(names):
        jc, pc = getattr(ref, name, None), getattr(port, name, None)
        if not (inspect.isclass(jc) and inspect.isclass(pc)
                and jc.__module__.startswith("spark_rapids_tpu.")):
            continue
        have = set().union(*(vars(k) for k in pc.__mro__))
        lack = sorted(n for n in vars(jc)
                      if not n.startswith("_") and n not in have)
        if lack:
            missing[name] = lack
    assert missing == {}


def test_the_bindings_named_in_queue_c_resolve():
    import spark_rapids_tpu_torch.ops as ops
    from spark_rapids_tpu_torch.columns import Column, DType, Table
    from spark_rapids_tpu_torch.ops import protobuf
    assert ops.protobuf is protobuf
    assert Column.__module__.endswith("columns.column")
    assert Table.__module__.endswith("columns.table")
    assert DType.__module__.endswith("columns.dtypes")


def test_port_imports_without_jax():
    import subprocess
    import sys
    code = ("import sys, spark_rapids_tpu_torch, "
            "spark_rapids_tpu_torch.observability, "
            "spark_rapids_tpu_torch.analysis, spark_rapids_tpu_torch.ops, "
            "spark_rapids_tpu_torch.utils.telemetry, "
            "spark_rapids_tpu_torch.distributed.runner, "
            "spark_rapids_tpu_torch.server, "
            "spark_rapids_tpu_torch.server.admission, "
            "spark_rapids_tpu_torch.server.scheduler, "
            "spark_rapids_tpu_torch.server.protocol, "
            "spark_rapids_tpu_torch.server.server, "
            "spark_rapids_tpu_torch.robustness.lifeguard, "
            "spark_rapids_tpu_torch.analysis.catalog, "
            "spark_rapids_tpu_torch.analysis.lint, "
            "spark_rapids_tpu_torch.analysis.plan_verify; "
            "assert 'jax' not in sys.modules; "
            "assert not [m for m in sys.modules "
            "if m.split('.')[0] == 'spark_rapids_tpu']")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   env=dict(os.environ, PYTHONPATH=REPO))


def test_analysis_binds_its_modules_on_first_use():
    import spark_rapids_tpu_torch.analysis as A
    from spark_rapids_tpu_torch.analysis import catalog, lint, plan_verify
    assert (A.catalog, A.lint, A.plan_verify) == (catalog, lint,
                                                  plan_verify)
    with pytest.raises(AttributeError):
        A.no_such_module
