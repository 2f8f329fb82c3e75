"""Runtime race detection: the port of the JAX package's ``analysis``.

  lockdep.py      opt-in instrumented locks: acquisition-order graph,
                  ABBA cycle detection, lock-held-across-blocking

ROADMAP A14 step 5(c): ``catalog``, ``lint`` and ``plan_verify``.

Only :mod:`lockdep` is imported here: it is adopted by the metrics
registry at lock-creation time and must stay stdlib-only.
"""

from spark_rapids_tpu_torch.analysis.lockdep import (  # noqa: F401
    make_lock, make_rlock, note_blocking)
