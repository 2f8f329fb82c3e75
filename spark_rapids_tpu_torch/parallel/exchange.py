"""Centralized overflow retry for fixed-capacity programs.

Device joins (`ops/device_join`) and fixed-capacity exchanges work in
budgeted slots and report their TRUE sizes alongside, so overflow is
detectable, never silent.  `with_capacity_retry` wraps a
capacity-parameterized program factory and re-runs it at double the
budget whenever the program reports overflow, under the same
RetryPolicy the task-level retry drivers use (robustness/retry.py).

The fixed-capacity exchange over `torch.distributed` comes with ROADMAP
A10; the retry journal and spans, and the process compile cache's step
memo with A14.
"""

from typing import Callable, Optional

import numpy as np
import torch

from spark_rapids_tpu_torch.robustness.retry import RetryPolicy


class CapacityExceeded(RuntimeError):
    """Raised when a budgeted program still overflows at the retry
    ceiling.

    ``send_counts`` carries the observed overflow indicator from the
    last attempt when the caller opted into a counts indicator: the
    TRUE per-destination sizes, so the caller can see HOW FAR over
    budget the program was, not just that it overflowed."""

    def __init__(self, capacity: int, doublings: int,
                 send_counts=None, reason: str = "overflowed"):
        super().__init__(
            f"exchange capacity {capacity} still {reason} after "
            f"{doublings} doublings"
            + (f" (observed counts {send_counts})"
               if send_counts is not None else ""))
        self.capacity = capacity
        self.doublings = doublings
        self.send_counts = send_counts


def _host(x) -> np.ndarray:
    """An overflow indicator on the host (one device sync)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _observed_counts(indicator: np.ndarray):
    """The true sizes carried into CapacityExceeded (the first 64)."""
    if indicator.size:
        return [int(x) for x in indicator.reshape(-1)[:64]]
    return None


def with_capacity_retry(make_step: Callable[[int], Callable],
                        initial_capacity: int, *,
                        max_doublings: int = 6,
                        overflow_index: int = -1,
                        policy: Optional[RetryPolicy] = None,
                        counts_indicator: bool = False,
                        check: Optional[Callable[[], None]] = None):
    """Overflow retry for a fixed-capacity program.

    make_step(capacity) must return a callable whose output tuple
    carries an overflow indicator at `overflow_index`.  By default it
    is a truthiness flag (any shape; any true/non-zero element means
    rows were dropped).  With ``counts_indicator=True`` it is instead
    the raw true sizes: the retry compares them with the current
    capacity itself, and a terminal CapacityExceeded reports them.  The
    wrapper runs the program, reads the indicator on the host, and
    re-builds at double the capacity until clean.  Each capacity's
    program is built once per wrapper.

    ``policy`` bounds the attempts (default ``max_doublings + 1``, no
    backoff), applies its backoff between rebuilds, and its wall-clock
    deadline: a spent attempt budget raises CapacityExceeded, and so
    does a deadline hit, early, instead of building ever-larger
    programs.

    ``check`` (optional) runs at the top of every capacity attempt, so
    a caller can cancel between attempts by raising from it.

    Returns run(*args) -> (outputs, capacity_used)."""
    steps = {}
    pol = policy or RetryPolicy(max_attempts=max_doublings + 1,
                                base_backoff_s=0.0)

    def _step_for(cap: int):
        # ROADMAP A14: steps live in the process compile cache there
        if cap not in steps:
            steps[cap] = make_step(cap)
        return steps[cap]

    def run(*args):
        # ROADMAP A14: the exchange_capacity_retry span and the retry
        # journal's episodes wrap this loop in the JAX package
        cap = int(initial_capacity)
        t0 = pol.clock()
        attempt = 0
        prev_backoff = 0.0
        while True:
            if check is not None:
                check()
            out = _step_for(cap)(*args)
            indicator = _host(out[overflow_index])
            if counts_indicator:
                overflowed = bool(np.any(indicator > cap))
            else:
                overflowed = bool(np.any(indicator))
            if not overflowed:
                return out, cap
            attempt += 1
            deadline_hit = (pol.deadline_s is not None
                            and pol.clock() - t0 >= pol.deadline_s)
            if attempt >= pol.max_attempts or deadline_hit:
                raise CapacityExceeded(
                    cap, attempt - 1,
                    send_counts=(_observed_counts(indicator)
                                 if counts_indicator else None),
                    reason="over deadline" if deadline_hit
                    else "overflowed")
            # thread the previous pause through so jittered policies
            # get true decorrelated backoff (robustness/retry.py)
            backoff = pol.backoff_for(attempt, prev_backoff)
            prev_backoff = backoff
            if backoff > 0:
                pol.sleep(backoff)
            cap *= 2

    return run
