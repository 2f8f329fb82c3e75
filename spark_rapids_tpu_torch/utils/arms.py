"""Resource-management + precondition helpers (reference Arms.java:31-100,
Preconditions.java:28-70, Pair.java:39).  The Java originals exist
because cudf-java handles are manually closed; the Python counterparts
serve the same role for Column/Table handle registries and file streams
in the shim layer.  Pure Python: the port keeps its own copy of the JAX
package's module."""

from __future__ import annotations

from typing import (Callable, Iterable, NamedTuple, Optional, TypeVar)

R = TypeVar("R")
T = TypeVar("T")
K = TypeVar("K")
V = TypeVar("V")


def close_if_exception(resource: R, fn: Callable[[R], T]) -> T:
    """Run fn(resource); close the resource ONLY if fn raises
    (Arms.java:31 closeIfException)."""
    try:
        return fn(resource)
    except BaseException:
        try:
            if resource is not None:
                resource.close()
        except Exception:
            pass  # suppressed, as the reference adds it as suppressed
        raise


def close_all(resources: Iterable) -> None:
    """Close every resource, remembering the first failure and raising
    it after all closes were attempted (Arms.java:53-90)."""
    first: Optional[BaseException] = None
    for r in resources:
        if r is None:
            continue
        try:
            r.close()
        # srt-lint: disable=SRT007 mirror of Arms.closeAll: the first failure is remembered and raised after every close was attempted
        except BaseException as e:  # noqa: BLE001 - mirror closeAll
            if first is None:
                first = e
    if first is not None:
        raise first


def with_resources(resources, fn):
    """Run fn(resources), closing all of them afterwards
    (Arms.java:93 withResource)."""
    try:
        return fn(resources)
    finally:
        close_all(resources)


# ------------------------------------------------------- preconditions

def ensure(condition: bool, message) -> None:
    """Raise ValueError unless condition (Preconditions.java:28-44;
    message may be a string or a zero-arg callable)."""
    if not condition:
        raise ValueError(message() if callable(message) else message)


def ensure_non_negative(value: int, name: str) -> int:
    """Raise ValueError when value < 0 (Preconditions.java:50-70)."""
    if value < 0:
        raise ValueError(f"{name} must be non-negative, but was {value}")
    return value


class Pair(NamedTuple):
    """Immutable 2-tuple with named accessors (Pair.java:39)."""
    left: object
    right: object

    @staticmethod
    def of(left, right) -> "Pair":
        return Pair(left, right)
