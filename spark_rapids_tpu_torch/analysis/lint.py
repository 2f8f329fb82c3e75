"""srt-lint: AST-walking project-invariant rules, the port's copy of
the JAX package's ``analysis/lint.py`` with its path-scoped tables
naming the port's files.

Each rule encodes an invariant the project relies on (the reference
repo enforces its analogs with clang-tidy + sanitizer premerge jobs):

  SRT000  a ``# srt-lint: disable=`` suppression must carry a reason
  SRT001  metric names registered on the MetricsRegistry match srt_*
  SRT002  ...and appear in analysis/catalog.py with the right kind
  SRT003  literal SPARK_RAPIDS_TPU_* env reads appear in the catalog
  SRT004  exceptions raised in shim/jni_entry.py are project-typed
  SRT005  no wall-clock/entropy (time.time, random, os.urandom, uuid)
          in digest-bearing modules (plan/ir, perf/calibrate,
          perf/jit_cache) — one impure key silently forks every cache
  SRT006  no torch dispatch or blocking I/O (socket, subprocess,
          fileio.read_range, time.sleep) lexically inside a
          ``with <lock>:`` body in observability/, server/, memory/
  SRT007  no bare ``except:`` / swallowed ``except BaseException:``
          (a handler with no re-raise) outside documented finalizers
  SRT008  the metrics/knobs catalog cross-checks against docs/
  SRT009  lock-heavy modules create locks via analysis.lockdep
          (make_lock/make_rlock), not bare threading.Lock()

Suppressions: ``# srt-lint: disable=SRT006 <reason>`` on the finding
line or the line above; ``# srt-lint: disable-file=SRT003 <reason>``
anywhere suppresses the rule for the whole file.  A reasonless
suppression is itself a finding (SRT000).

Output is golden-stable: findings sort by (path, line, rule) and the
JSON form is key-sorted, so the same tree always lints identically.
"""

from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from spark_rapids_tpu_torch.analysis import catalog

# ------------------------------------------------------------ findings


@dataclass(frozen=True)
class Finding:
    path: str          # repo-relative, forward slashes
    line: int
    rule: str
    message: str

    def as_dict(self) -> dict:
        return {"path": self.path, "line": self.line,
                "rule": self.rule, "message": self.message}


@dataclass
class LintResult:
    findings: List[Finding] = field(default_factory=list)
    suppressed: int = 0
    files: int = 0

    def to_json(self) -> str:
        return json.dumps(
            {"version": 1,
             "files": self.files,
             "suppressed": self.suppressed,
             "findings": [f.as_dict() for f in self.findings]},
            sort_keys=True, indent=2)

    def render_text(self) -> str:
        out = []
        for f in self.findings:
            out.append(f"{f.path}:{f.line}: {f.rule} {f.message}")
        out.append(f"srt-lint: {len(self.findings)} finding(s), "
                   f"{self.suppressed} suppressed, "
                   f"{self.files} file(s)")
        return "\n".join(out)


# -------------------------------------------------------- suppressions

_SUPPRESS_RE = re.compile(
    r"#\s*srt-lint:\s*(disable|disable-file)=([A-Z0-9,]+)"
    r"(?:\s+(\S.*))?")


class _Suppressions:
    def __init__(self, src: str):
        self.by_line: Dict[int, set] = {}
        self.file_wide: set = set()
        self.bad: List[int] = []          # suppressions with no reason
        for i, text in enumerate(src.splitlines(), 1):
            m = _SUPPRESS_RE.search(text)
            if not m:
                continue
            kind, rules, reason = m.group(1), m.group(2), m.group(3)
            if not reason or not reason.strip():
                self.bad.append(i)
                continue
            ids = {r for r in rules.split(",") if r}
            if kind == "disable-file":
                self.file_wide |= ids
            else:
                self.by_line.setdefault(i, set()).update(ids)

    def covers(self, line: int, rule: str) -> bool:
        if rule in self.file_wide:
            return True
        return (rule in self.by_line.get(line, ())
                or rule in self.by_line.get(line - 1, ()))


# ------------------------------------------------------------- helpers


def _attr_chain(node) -> List[str]:
    """['os', 'environ', 'get'] for os.environ.get — [] when the chain
    roots in a call/subscript (dynamic receiver)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return list(reversed(parts))
    return []


def _const_str(node) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


class _ConstTable:
    """Per-scope ``name = "literal"`` (and ``name = "lit" + dynamic``)
    assignments, so env reads through a local like calibrate's
    ``env = "SPARK_RAPIDS_TPU_PATH_" + op`` still resolve (to a
    wildcard prefix)."""

    def __init__(self, tree: ast.AST):
        # (scope node id, name) -> ("const", value) | ("prefix", value)
        self.table: Dict[Tuple[int, str], Tuple[str, str]] = {}
        self.scope_of: Dict[int, int] = {}   # node id -> scope node id
        for scope in ast.walk(tree):
            if not isinstance(scope, (ast.Module, ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                continue
            sid = id(scope)
            # ast.walk is breadth-first, so deeper scopes assign later
            # and the innermost enclosing scope wins
            for stmt in ast.walk(scope):
                self.scope_of[id(stmt)] = sid
            for stmt in scope.body:
                if isinstance(stmt, ast.Assign) \
                        and len(stmt.targets) == 1 \
                        and isinstance(stmt.targets[0], ast.Name):
                    res = _resolve_str(stmt.value, None)
                    if res is not None:
                        self.table[(sid, stmt.targets[0].id)] = res

    def lookup(self, node: ast.AST, name: str
               ) -> Optional[Tuple[str, str]]:
        sid = self.scope_of.get(id(node))
        if sid is None:
            return None
        return self.table.get((sid, name))


def _resolve_str(node, consts: Optional[Tuple[_ConstTable, ast.AST]]
                 ) -> Optional[Tuple[str, str]]:
    """("const", s) for a fully-literal string expression, ("prefix",
    p) when only a literal left side of a concatenation resolves."""
    s = _const_str(node)
    if s is not None:
        return ("const", s)
    if isinstance(node, ast.Name) and consts is not None:
        table, site = consts
        return table.lookup(site, node.id)
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        left = _resolve_str(node.left, consts)
        if left is None:
            return None
        right = _resolve_str(node.right, consts)
        if left[0] == "const" and right is not None \
                and right[0] == "const":
            return ("const", left[1] + right[1])
        return ("prefix", left[1])
    if isinstance(node, ast.JoinedStr):  # f-string: leading literal
        if node.values and (s := _const_str(node.values[0])) is not None:
            return ("prefix", s)
    return None


# ---------------------------------------------------------------- rules


class Rule:
    id = "SRT999"
    title = ""
    scope = "all files"

    def applies(self, relpath: str) -> bool:
        return True

    def run(self, ctx: "FileContext") -> List[Finding]:
        raise NotImplementedError


class FileContext:
    def __init__(self, relpath: str, src: str, tree: ast.AST):
        self.relpath = relpath
        self.src = src
        self.tree = tree
        self.consts = _ConstTable(tree)


class MetricNameRules(Rule):
    """SRT001 + SRT002 share one walk (same call sites)."""
    id = "SRT001"
    title = "registry metric names match srt_* and are catalogued"

    def run(self, ctx: FileContext) -> List[Finding]:
        out: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("counter", "gauge",
                                           "histogram")
                    and node.args):
                continue
            name = _const_str(node.args[0])
            if name is None or not name.startswith("srt"):
                # non-srt literal receivers (pyarrow schemas etc.) and
                # dynamic names are out of scope for the prefix rule
                continue
            if not name.startswith("srt_"):
                out.append(Finding(
                    ctx.relpath, node.lineno, "SRT001",
                    f"metric {name!r} does not match the srt_* "
                    f"naming contract"))
                continue
            entry = catalog.METRICS.get(name)
            if entry is None:
                out.append(Finding(
                    ctx.relpath, node.lineno, "SRT002",
                    f"metric {name!r} is not in analysis/catalog.py "
                    f"(add it there and to docs/observability.md)"))
            elif entry[0] != node.func.attr:
                out.append(Finding(
                    ctx.relpath, node.lineno, "SRT002",
                    f"metric {name!r} registered as "
                    f"{node.func.attr} but catalogued as {entry[0]}"))
        return out


_ENV_READ_ATTRS = ("get", "setdefault", "pop", "__getitem__")


class KnobCatalogRule(Rule):
    id = "SRT003"
    title = "SPARK_RAPIDS_TPU_* env reads are catalogued"

    def _check_name(self, ctx, node, resolved) -> Optional[Finding]:
        kind, value = resolved
        if not value.startswith("SPARK_RAPIDS_TPU_"):
            return None
        if kind == "const":
            if not catalog.knob_known(value):
                return Finding(
                    ctx.relpath, node.lineno, "SRT003",
                    f"env knob {value!r} is not in "
                    f"analysis/catalog.py")
        else:  # prefix
            if value not in catalog.KNOB_WILDCARDS:
                return Finding(
                    ctx.relpath, node.lineno, "SRT003",
                    f"dynamic env knob family {value!r}* is not a "
                    f"catalogued wildcard")
        return None

    def run(self, ctx: FileContext) -> List[Finding]:
        out: List[Finding] = []
        for node in ast.walk(ctx.tree):
            arg = None
            if isinstance(node, ast.Call):
                chain = _attr_chain(node.func)
                is_env = (chain[-1:] and chain[-1] in _ENV_READ_ATTRS
                          and "environ" in chain) \
                    or chain[-1:] == ["getenv"] \
                    or chain == ["os", "getenv"]
                if is_env and node.args:
                    arg = node.args[0]
            elif isinstance(node, ast.Subscript):
                chain = _attr_chain(node.value)
                if "environ" in chain:
                    arg = node.slice
            if arg is None:
                continue
            resolved = _resolve_str(arg, (ctx.consts, node))
            if resolved is None:
                continue
            f = self._check_name(ctx, node, resolved)
            if f is not None:
                out.append(f)
        return out


_BUILTIN_EXCS = {"Exception", "BaseException", "ValueError",
                 "TypeError", "RuntimeError", "KeyError", "IndexError",
                 "OSError", "IOError", "AttributeError"}


class ShimTypedRaiseRule(Rule):
    id = "SRT004"
    title = "shim entry raises project-typed exceptions"
    scope = "spark_rapids_tpu_torch/shim/jni_entry.py"

    def applies(self, relpath: str) -> bool:
        return relpath.endswith("shim/jni_entry.py")

    def run(self, ctx: FileContext) -> List[Finding]:
        out: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Raise) or node.exc is None:
                continue
            exc = node.exc
            name = None
            if isinstance(exc, ast.Call):
                chain = _attr_chain(exc.func)
                name = chain[-1] if chain else None
            elif isinstance(exc, ast.Name):
                name = exc.id
            if name in _BUILTIN_EXCS:
                out.append(Finding(
                    ctx.relpath, node.lineno, "SRT004",
                    f"raise {name} in the shim entry: use a "
                    f"project-typed exception (shim/errors.py) so the "
                    f"JVM boundary maps it"))
        return out


DIGEST_MODULES = (
    "spark_rapids_tpu_torch/plan/ir.py",
    "spark_rapids_tpu_torch/perf/calibrate.py",
    "spark_rapids_tpu_torch/perf/jit_cache.py",
)

_IMPURE_CALLS = {
    ("time", "time"), ("os", "urandom"),
    ("uuid", "uuid1"), ("uuid", "uuid4"),
    ("datetime", "now"), ("datetime", "utcnow"),
}
_IMPURE_ROOTS = {"random", "secrets"}


class DigestPurityRule(Rule):
    id = "SRT005"
    title = "digest-bearing modules stay wall-clock/entropy free"
    scope = "plan/ir.py, perf/calibrate.py, perf/jit_cache.py"

    def applies(self, relpath: str) -> bool:
        return relpath in DIGEST_MODULES

    def run(self, ctx: FileContext) -> List[Finding]:
        out: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            chain = _attr_chain(node.func)
            if not chain:
                continue
            bad = (tuple(chain[-2:]) in _IMPURE_CALLS
                   or chain[0] in _IMPURE_ROOTS)
            if bad:
                out.append(Finding(
                    ctx.relpath, node.lineno, "SRT005",
                    f"{'.'.join(chain)}() in a digest-bearing module "
                    f"— wall-clock/entropy must never reach a cache "
                    f"key or plan digest"))
        return out


_LOCK_DIR_PREFIXES = (
    "spark_rapids_tpu_torch/observability/",
    "spark_rapids_tpu_torch/server/",
    "spark_rapids_tpu_torch/memory/",
)
# a torch call is a device dispatch (or a sync) on the card: what the
# JAX package's rule forbids for jax/jnp/lax under a held lock
_BLOCKING_ROOTS = {"torch", "socket", "subprocess"}
_BLOCKING_ATTRS = {"read_range", "urlopen", "check_output",
                   "check_call", "sendall", "recv", "recv_into",
                   "accept", "connect", "makefile"}


def _looks_like_lock(expr) -> bool:
    name = None
    if isinstance(expr, ast.Name):
        name = expr.id
    elif isinstance(expr, ast.Attribute):
        name = expr.attr
    return name is not None and "lock" in name.lower()


class LockBlockingRule(Rule):
    id = "SRT006"
    title = "no device dispatch / blocking I/O under a held lock"
    scope = "observability/, server/, memory/"

    def applies(self, relpath: str) -> bool:
        return relpath.startswith(_LOCK_DIR_PREFIXES)

    @staticmethod
    def _walk_pruned(node):
        """Descendants of ``node`` minus any nested def/class/lambda
        subtree (a nested def's body does not run under the lock)."""
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef,
                                  ast.AsyncFunctionDef,
                                  ast.ClassDef, ast.Lambda)):
                continue
            yield child
            yield from LockBlockingRule._walk_pruned(child)

    def _scan_body(self, ctx, body, lockname, out):
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef,
                                 ast.AsyncFunctionDef, ast.ClassDef)):
                continue
            for node in [stmt, *self._walk_pruned(stmt)]:
                if not isinstance(node, ast.Call):
                    continue
                chain = _attr_chain(node.func)
                if not chain:
                    continue
                blocking = None
                if chain[0] in _BLOCKING_ROOTS:
                    blocking = ".".join(chain)
                elif tuple(chain[-2:]) == ("time", "sleep"):
                    blocking = "time.sleep"
                elif chain[-1] in _BLOCKING_ATTRS:
                    blocking = ".".join(chain[-2:])
                if blocking:
                    out.append(Finding(
                        ctx.relpath, node.lineno, "SRT006",
                        f"{blocking}() inside `with {lockname}:` — "
                        f"device dispatch / blocking I/O under a held "
                        f"lock stalls every contending thread"))

    def run(self, ctx: FileContext) -> List[Finding]:
        out: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.With):
                continue
            locknames = [ast.unparse(i.context_expr)
                         for i in node.items
                         if _looks_like_lock(i.context_expr)]
            if not locknames:
                continue
            self._scan_body(ctx, node.body, locknames[0], out)
        return out


class BareExceptRule(Rule):
    id = "SRT007"
    title = "no bare except / swallowed BaseException"

    def run(self, ctx: FileContext) -> List[Finding]:
        out: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            bare = node.type is None
            base = (isinstance(node.type, ast.Name)
                    and node.type.id == "BaseException")
            if not (bare or base):
                continue
            reraises = any(isinstance(n, ast.Raise)
                           for stmt in node.body
                           for n in ast.walk(stmt))
            if reraises:
                continue
            what = "bare except:" if bare else "except BaseException:"
            out.append(Finding(
                ctx.relpath, node.lineno, "SRT007",
                f"{what} swallows KeyboardInterrupt/SystemExit — "
                f"catch Exception, re-raise, or suppress with a "
                f"documented finalizer reason"))
        return out


LOCK_ADOPTED_MODULES = (
    "spark_rapids_tpu_torch/server/server.py",
    "spark_rapids_tpu_torch/server/scheduler.py",
    "spark_rapids_tpu_torch/server/admission.py",
    "spark_rapids_tpu_torch/server/__init__.py",
    "spark_rapids_tpu_torch/robustness/lifeguard.py",
    "spark_rapids_tpu_torch/observability/registry.py",
    "spark_rapids_tpu_torch/perf/jit_cache.py",
    "spark_rapids_tpu_torch/perf/calibrate.py",
    "spark_rapids_tpu_torch/shim/handles.py",
    "spark_rapids_tpu_torch/shim/jni_entry.py",
    "spark_rapids_tpu_torch/distributed/transport.py",
    "spark_rapids_tpu_torch/distributed/service.py",
)


class LockdepAdoptionRule(Rule):
    id = "SRT009"
    title = "lock-heavy modules create locks via analysis.lockdep"
    scope = "server, scheduler, lifeguard, registry, jit_cache, " \
            "calibrate, handles, jni_entry, transport, service"

    def applies(self, relpath: str) -> bool:
        return relpath in LOCK_ADOPTED_MODULES

    def run(self, ctx: FileContext) -> List[Finding]:
        out: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            chain = _attr_chain(node.func)
            if tuple(chain[-2:]) in (("threading", "Lock"),
                                     ("threading", "RLock")):
                out.append(Finding(
                    ctx.relpath, node.lineno, "SRT009",
                    f"{'.'.join(chain)}() in a lockdep-adopted module "
                    f"— use analysis.lockdep.make_lock/make_rlock so "
                    f"the lock participates in order checking"))
        return out


RULES: Sequence[Rule] = (
    MetricNameRules(),
    KnobCatalogRule(),
    ShimTypedRaiseRule(),
    DigestPurityRule(),
    LockBlockingRule(),
    BareExceptRule(),
    LockdepAdoptionRule(),
)

RULE_TABLE: List[Tuple[str, str]] = (
    [("SRT000", "suppression comments must carry a reason")]
    + [(r.id, r.title) for r in RULES]
    + [("SRT002", "metric names appear in the catalog (kind-checked)"),
       ("SRT008", "catalog cross-checks against the docs tree")])


# ---------------------------------------------------------- entry points


def lint_source(src: str, relpath: str) -> Tuple[List[Finding], int]:
    """Lint one file's source.  Returns (unsuppressed findings,
    suppressed count).  Syntax errors surface as a single SRT-SYNTAX
    finding rather than an exception (the CLI must keep walking)."""
    relpath = relpath.replace(os.sep, "/")
    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        return ([Finding(relpath, e.lineno or 0, "SRT-SYNTAX",
                         f"file does not parse: {e.msg}")], 0)
    sup = _Suppressions(src)
    ctx = FileContext(relpath, src, tree)
    raw: List[Finding] = []
    for rule in RULES:
        if rule.applies(relpath):
            raw.extend(rule.run(ctx))
    for line in sup.bad:
        raw.append(Finding(relpath, line, "SRT000",
                           "suppression without a reason string — "
                           "say WHY the invariant does not apply"))
    kept, suppressed = [], 0
    for f in raw:
        if f.rule != "SRT000" and sup.covers(f.line, f.rule):
            suppressed += 1
        else:
            kept.append(f)
    return kept, suppressed


_DEFAULT_DIRS = ("spark_rapids_tpu_torch",)
# repo-root entry points that belong to the port (the JAX package's
# lint keeps covering scripts/ and the other root files)
_DEFAULT_ROOT_FILES = ("chip_smoke.py",)


def default_files(root: str) -> List[str]:
    """The default lint scope: the port's package + its repo-root
    entry point (tests excluded: they exercise invariants by
    violating them)."""
    out: List[str] = []
    for d in _DEFAULT_DIRS:
        base = os.path.join(root, d)
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = sorted(x for x in dirnames
                                 if x != "__pycache__")
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    out.append(os.path.join(dirpath, fn))
    for fn in _DEFAULT_ROOT_FILES:
        if os.path.isfile(os.path.join(root, fn)):
            out.append(os.path.join(root, fn))
    return out


def lint_paths(root: str, paths: Optional[Iterable[str]] = None,
               check_docs: bool = True) -> LintResult:
    """Lint ``paths`` (absolute or root-relative; default: the whole
    default scope) plus, when ``check_docs``, the catalog<->docs
    cross-check (SRT008, attributed to analysis/catalog.py)."""
    res = LintResult()
    files = [p if os.path.isabs(p) else os.path.join(root, p)
             for p in (paths if paths is not None
                       else default_files(root))]
    for path in files:
        rel = os.path.relpath(path, root).replace(os.sep, "/")
        try:
            with open(path, encoding="utf-8") as f:
                src = f.read()
        except OSError:
            continue
        found, sup = lint_source(src, rel)
        res.findings.extend(found)
        res.suppressed += sup
        res.files += 1
    if check_docs:
        for problem in catalog.check_docs(root):
            res.findings.append(Finding(
                "spark_rapids_tpu_torch/analysis/catalog.py", 0, "SRT008",
                problem))
    res.findings.sort(key=lambda f: (f.path, f.line, f.rule,
                                     f.message))
    return res
