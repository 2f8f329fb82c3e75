"""Op-layer tracing/fault-injection instrumentation.

The reference wraps every native op in an NVTX range at its definition
(nvtx_ranges.hpp NVTX3_FUNC_RANGE in each .cu entry point) and the
fault-injection tool intercepts at the driver boundary, so EVERY caller
— plugin, tests, tools — is covered.  `traced` is applied to the
op-layer entry points themselves (via `instrument` from ops/__init__),
so any call path hits the same maybe_inject + op_range bracket.

With every sidecar off (no injector installed, no profiler, tracing,
metrics, lifeguard heartbeat, ``torch.profiler`` session or NVTX tool
such as Nsight Systems) the wrapper reads those switches and calls the
op directly: the bracket's records, annotations and NVTX ranges would
all be dropped, so it is not opened.
"""

from __future__ import annotations

import functools
import sys
from typing import Iterable, Optional

import torch.autograd.profiler as _torch_prof

from spark_rapids_tpu_torch import observability as _obs
from spark_rapids_tpu_torch.utils import fault_injection as _fi
from spark_rapids_tpu_torch.utils import profiler as _prof
from spark_rapids_tpu_torch.utils.fault_injection import maybe_inject
from spark_rapids_tpu_torch.utils.profiler import bracket_owned_by, op_range

_WRAPPED_FLAG = "__srt_traced__"


def sidecars_off() -> bool:
    """True when no bracket around an op would record or inject
    anything: attribute reads only."""
    return (_fi.installed() is None and _prof.Profiler.get() is None
            and not _obs.TRACER.enabled and _obs.op_hooks_idle()
            and not _prof.NVTX_TOOL
            and not _torch_prof._is_profiler_enabled)


def traced(fn=None, *, name: Optional[str] = None):
    """Decorator: fault-injection point + profiler/NVTX-style range
    around an eager op entry point.  Idempotent (re-wrapping is a
    no-op).  Do NOT apply to functions called inside ``torch.compile``
    regions — the bracket is a host-side, per-eager-call construct
    (``sys._getframe`` and host clocks).

    Double-bracket suppression is keyed by FRAME, not by name: the only
    duplicate to suppress is the shim-over-op shape, where jni_api opens
    ``with op_range("x")`` and calls the traced op from that same frame
    — one logical call, two brackets.  A name-keyed guard would also
    swallow genuinely recursive calls to the same op (e.g. a join entry
    point composing another join), hiding the inner call from injection
    and the profiler entirely."""

    def deco(f):
        if getattr(f, _WRAPPED_FLAG, False):
            return f
        opname = name or f.__name__

        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            if sidecars_off():
                return f(*args, **kwargs)
            if bracket_owned_by(opname, id(sys._getframe(1))):
                # the CALLER's frame opened an op_range for this very
                # op (the shim bracketing the op it is about to call):
                # same logical call — don't inject or record twice
                return f(*args, **kwargs)
            maybe_inject(opname)
            with op_range(opname):
                return f(*args, **kwargs)

        setattr(wrapper, _WRAPPED_FLAG, True)
        wrapper.__wrapped__ = f
        return wrapper

    return deco(fn) if fn is not None else deco


def instrument(module_name: str, names: Iterable[str]) -> None:
    """Wrap the named functions of an already-imported module in
    `traced`, rebinding them on the module so subsequent imports and
    attribute calls are covered."""
    mod = sys.modules[module_name]
    for n in names:
        f = getattr(mod, n)
        if callable(f):
            setattr(mod, n, traced(f, name=n))
