"""srt-check: the project static analyzer CLI.

::

    python -m spark_rapids_tpu_torch.tools.srt_check [paths...]   # srt-lint
    python -m spark_rapids_tpu_torch.tools.srt_check --diff BASE  # changed
    python -m spark_rapids_tpu_torch.tools.srt_check --plan       # plan-IR
    python -m spark_rapids_tpu_torch.tools.srt_check --list-rules
    ... --json     machine-readable, key-sorted, golden-stable

Default scope is the port's package and its repo-root entry point,
``chip_smoke.py`` (tests excluded; the JAX package's own CLI covers
its tree and scripts/).  ``--diff BASE`` lints only the .py files
changed vs a git base ref (plus the working tree) — the fast local
loop.  ``--plan`` builds every plan in the port's plan/catalog.py and
runs the plan-verify engine over it (this imports torch; plain linting
does not).  Exit status: 0 clean, 1 findings / verify failures, 2
usage.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import List, Optional


def repo_root() -> str:
    """The repo checkout this module sits in (the CLI lints its own
    tree by default; ``--root`` overrides)."""
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(here))


def _changed_files(root: str, base: str) -> Optional[List[str]]:
    """Repo-relative .py files changed vs ``base`` (committed diff +
    working tree).  None when git itself fails (the caller falls back
    to a full lint rather than passing vacuously)."""
    files = set()
    for args in (["git", "diff", "--name-only", f"{base}...HEAD"],
                 ["git", "diff", "--name-only", "HEAD"],
                 ["git", "diff", "--name-only", "--cached"]):
        try:
            out = subprocess.run(
                args, cwd=root, capture_output=True, text=True,
                timeout=30)
        except (OSError, subprocess.TimeoutExpired):
            return None
        if out.returncode != 0:
            return None
        files.update(ln.strip() for ln in out.stdout.splitlines()
                     if ln.strip())
    return sorted(f for f in files
                  if f.endswith(".py")
                  and not f.startswith("tests/")
                  and os.path.isfile(os.path.join(root, f)))


# ------------------------------------------------------------- plan mode


def _catalog_plans():
    """(name, buildable) pairs over every plan/catalog.py shape — the
    same parameterizations the fusion smoke runs."""
    from spark_rapids_tpu_torch.plan import catalog as pc
    return [
        ("q3", lambda: pc.q3_plan(base=1990, years=8, brands=16,
                                  manufact=8)),
        ("q9", pc.q9_plan),
        ("q67", lambda: pc.q67_plan(ncat=8, ncls=8)),
        ("cube", lambda: pc.cube_plan(ncat=8, ncls=8)),
        ("q89", lambda: pc.q89_plan(stores=8, items=16)),
        ("q5_pipeline", lambda: pc.q5_pipeline(stores=8,
                                               join_capacity=4096)),
        ("q72_pipeline", lambda: pc.q72_pipeline(
            items=64, max_week=16, join_capacity=4096, limit=100)),
    ]


def run_plan_verify(as_json: bool) -> int:
    from spark_rapids_tpu_torch.analysis import plan_verify
    from spark_rapids_tpu_torch.plan import ir
    results = []
    rc = 0
    for name, build in _catalog_plans():
        try:
            plan = build()
            if isinstance(plan, ir.Pipeline):
                plan_verify.verify_pipeline(plan)
            else:
                plan_verify.verify_stage(plan)
            results.append({"plan": name, "ok": True,
                            "digest": plan.digest})
        except plan_verify.PlanVerifyError as e:
            rc = 1
            results.append({"plan": name, "ok": False,
                            "node": e.node, "reason": e.reason})
    if as_json:
        print(json.dumps({"version": 1, "plans": results},
                         sort_keys=True, indent=2))
    else:
        for r in results:
            if r["ok"]:
                print(f"plan-verify: {r['plan']}: ok "
                      f"(digest {r['digest']})")
            else:
                print(f"plan-verify: {r['plan']}: FAIL at {r['node']}:"
                      f" {r['reason']}")
        print(f"plan-verify: {sum(r['ok'] for r in results)}/"
              f"{len(results)} plans verified")
    return rc


# ------------------------------------------------------------------ main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="srt-check",
        description="project-invariant static analyzer "
                    "(srt-lint + plan-verify)")
    ap.add_argument("paths", nargs="*",
                    help="files to lint (default: the whole tree)")
    ap.add_argument("--root", default=None,
                    help="repo root (default: this checkout)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output")
    ap.add_argument("--diff", metavar="BASE", default=None,
                    help="lint only .py files changed vs a git ref")
    ap.add_argument("--plan", action="store_true",
                    help="verify every plan/catalog.py stage plan")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--no-docs-check", action="store_true",
                    help="skip the catalog<->docs cross-check "
                         "(partial-scope runs)")
    args = ap.parse_args(argv)

    from spark_rapids_tpu_torch.analysis import lint

    if args.list_rules:
        for rid, title in lint.RULE_TABLE:
            print(f"{rid}  {title}")
        return 0

    if args.plan:
        return run_plan_verify(args.json)

    root = os.path.abspath(args.root) if args.root else repo_root()
    paths = args.paths or None
    check_docs = not args.no_docs_check
    if args.diff is not None:
        changed = _changed_files(root, args.diff)
        if changed is None:
            print("srt-check: git diff failed, linting full tree",
                  file=sys.stderr)
        else:
            paths = changed
            check_docs = False      # partial scope: per-file rules only
            if not paths:
                print("srt-check: no changed python files")
                return 0
    res = lint.lint_paths(root, paths, check_docs=check_docs)
    print(res.to_json() if args.json else res.render_text())
    return 1 if res.findings else 0


if __name__ == "__main__":
    sys.exit(main())
