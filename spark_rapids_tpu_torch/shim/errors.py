"""Project-typed exceptions for the JNI shim boundary (srt-lint
SRT004).

The embedded-interpreter entry points (shim/jni_entry.py) used to
raise bare ``ValueError``/``RuntimeError`` — which the JVM side can
only map to a generic RuntimeException, losing the
argument-vs-state distinction the reference's typed Java exceptions
(CudfException, ExceptionWithRowIndex, ...) preserve.  These two
types keep that distinction AND subclass the builtins they replace,
so every existing ``except ValueError`` / test expectation holds.
"""


class ShimArgumentError(ValueError):
    """Caller handed the shim malformed arguments (bad offsets,
    unknown component names, missing handles) — maps to
    IllegalArgumentException on the JVM side."""


class ShimStateError(RuntimeError):
    """The shim was driven in an illegal state (mesh overflow, op on
    a shut-down runtime) — maps to IllegalStateException on the JVM
    side."""
