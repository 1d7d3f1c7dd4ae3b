"""The disruption-budget grammar: a provisioner-level ``maxUnavailable``-
style budget on voluntary consolidation, a count (``"3"``) or a percent
(``"20%"``) of the provisioner's nodes. ``"0"`` (or ``"0%"``) is the
explicit off switch. ``validate_provisioner`` checks it at admission; the
consolidation controller that spends it is not ported yet."""

from __future__ import annotations

from typing import Optional


def parse_budget(spec: Optional[str]) -> Optional[str]:
    """Validate and normalize one budget spec. Returns the normalized
    string (``"3"`` / ``"20%"``) or None for unset. Raises ValueError on
    anything else — a typo'd budget must fail admission, not silently
    disable the safety layer."""
    if spec is None:
        return None
    s = str(spec).strip()
    if not s:
        return None
    body = s[:-1] if s.endswith("%") else s
    try:
        value = int(body)
    except ValueError:
        raise ValueError(
            f"disruption budget must be a count or percent (got {spec!r})"
        )
    if value < 0:
        raise ValueError(f"disruption budget must be non-negative (got {spec!r})")
    if s.endswith("%") and value > 100:
        raise ValueError(f"disruption budget percent over 100 (got {spec!r})")
    return f"{value}%" if s.endswith("%") else str(value)
