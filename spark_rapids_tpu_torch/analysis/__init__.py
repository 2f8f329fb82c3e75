"""Project-invariant static analysis and runtime race detection: the
port of the JAX package's ``analysis``.

  lint.py         srt-lint AST rule framework (SRT000..SRT009) over the
                  port's tree (``spark_rapids_tpu_torch/`` and
                  ``chip_smoke.py``)
  catalog.py      the checked-in srt_* metrics / SPARK_RAPIDS_TPU_*
                  knobs catalog the rules and docs cross-check
  lockdep.py      opt-in instrumented locks: acquisition-order graph,
                  ABBA cycle detection, lock-held-across-blocking
  plan_verify.py  typed verifier over stage plans, run before every
                  compile (PlanVerifyError instead of an error from
                  inside a compiled graph)

Only :mod:`lockdep` is imported eagerly: it is adopted by the metrics
registry and the server at lock-creation time and must stay
stdlib-only.  ``catalog``, ``lint`` and ``plan_verify`` are bound on
first attribute access (plan_verify pulls torch through the plan
package).
"""

import importlib

from spark_rapids_tpu_torch.analysis.lockdep import (  # noqa: F401
    make_lock, make_rlock, note_blocking)

_LAZY = ("catalog", "lint", "plan_verify")


def __getattr__(name):
    if name in _LAZY:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
