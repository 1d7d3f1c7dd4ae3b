"""Idempotency markers for retried callables.

``RetryPolicy.call`` re-invokes its callable on transient failure; that is
only sound for operations whose replay converges to the same state
(DELETE of a named resource, a catalog GET, an event poll with positions,
a create that replays a committed launch token). ``@idempotent`` is the
explicit declaration of that property: ``MeteredCloudProvider`` retries a
delegate's ``create`` only when the delegate carries it.

The marker is metadata only (``fn.__idempotent__ = True``); it changes no
behavior, so applying it can never regress a passing call path.
"""

from __future__ import annotations

from typing import Callable, TypeVar

F = TypeVar("F", bound=Callable)


def idempotent(fn: F) -> F:
    """Declare that replaying ``fn`` converges to the same end state."""
    fn.__idempotent__ = True  # type: ignore[attr-defined]
    return fn


def is_idempotent(fn: Callable) -> bool:
    return bool(getattr(fn, "__idempotent__", False))
