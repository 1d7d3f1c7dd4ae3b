"""Read-modify-write helpers for list-valued merge-patch fields.

RFC 7386 (JSON merge patch) replaces arrays WHOLESALE: a patch carrying
``{"status": {"conditions": [mine]}}`` erases every condition another
writer owns. A patch that writes a multi-writer list field must therefore
carry the FULL list: the freshest cached copy with one entry upserted or
removed.

The helpers are pure: they return new lists and never mutate their inputs
(the inputs are often live cached objects).
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

Wire = Dict[str, Any]


def upsert_keyed(existing: Sequence[Wire], entry: Wire, *, key: str) -> List[Wire]:
    """The full list with ``entry`` replacing the element sharing its
    ``key`` field (appended when absent). Order of the other elements is
    preserved; the upserted entry lands last — matching the append-on-change
    behavior status writers already exhibit."""
    ident = entry.get(key)
    out = [dict(e) for e in existing if e.get(key) != ident]
    out.append(dict(entry))
    return out


def without_keyed(existing: Sequence[Wire], ident: Any, *, key: str) -> List[Wire]:
    """The full list minus the element whose ``key`` field equals ``ident``."""
    return [dict(e) for e in existing if e.get(key) != ident]


def without_value(existing: Sequence[Any], value: Any) -> List[Any]:
    """Plain-value lists (finalizers): the full list minus ``value``."""
    return [v for v in existing if v != value]


def upsert_condition(existing: Sequence[Wire], condition: Wire) -> List[Wire]:
    """Conditions are keyed by ``type`` (knative/k8s convention)."""
    return upsert_keyed(existing, condition, key="type")


def upsert_taint(existing: Sequence[Wire], taint: Wire) -> List[Wire]:
    """Taints are keyed by ``key`` (one effect per taint key here; the
    callers never stack effects under one key)."""
    return upsert_keyed(existing, taint, key="key")
