"""Centralized overflow retry for fixed-capacity programs.

Device joins (`ops/device_join`) and fixed-capacity exchanges work in
budgeted slots and report their TRUE sizes alongside, so overflow is
detectable, never silent.  `with_capacity_retry` wraps a
capacity-parameterized program factory and re-runs it at double the
budget whenever the program reports overflow.

The fixed-capacity exchange over `torch.distributed` comes with ROADMAP
A10; the retry policy's backoff and deadline, the retry journal and
spans, and the process compile cache's step memo with A14.
"""

from typing import Callable, Optional

import numpy as np
import torch


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
    re-builds at double the capacity until clean, raising
    CapacityExceeded after `max_doublings` doublings.  Each capacity's
    program is built once per wrapper.

    ``check`` (optional) runs at the top of every capacity attempt, so
    a caller can cancel between attempts by raising from it.

    Returns run(*args) -> (outputs, capacity_used)."""
    steps = {}
    # ROADMAP A14: the JAX package's RetryPolicy (backoff, wall-clock
    # deadline) bounds these attempts; here it is max_doublings alone
    max_attempts = max_doublings + 1

    def _step_for(cap: int):
        # ROADMAP A14: steps live in the process compile cache there
        if cap not in steps:
            steps[cap] = make_step(cap)
        return steps[cap]

    def run(*args):
        # ROADMAP A14: the exchange_capacity_retry span and the retry
        # journal's episodes wrap this loop in the JAX package
        cap = int(initial_capacity)
        attempt = 0
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
            if attempt >= max_attempts:
                raise CapacityExceeded(
                    cap, attempt - 1,
                    send_counts=(_observed_counts(indicator)
                                 if counts_indicator else None))
            cap *= 2

    return run
