"""Logging setup with live log-level reload.

Mirrors the reference's knative zap wiring: named per-controller loggers and
a watched ``config-logging`` source that re-applies the level without a
restart (reference: cmd/controller/main.go:109-121; validated by its own
webhook, cmd/webhook/main.go:86-94). Here the source is a file — the
deployment mounts the ConfigMap as one (deploy/controller.yaml) — polled on
a short interval.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
}

ROOT_LOGGER = "karpenter"

LOG_FORMAT = "%(asctime)s %(levelname)s %(name)s [%(trace_id)s/%(span_id)s] %(message)s"


class TraceContextFilter(logging.Filter):
    """Stamps ``trace_id``/``span_id`` (or ``-``) on every record passing
    through the handler it is attached to, so a log line from anywhere in
    the ``karpenter`` hierarchy can be grepped straight into its trace at
    ``/debug/traces``. Attached to HANDLERS, not loggers: logger-level
    filters don't apply to child loggers' records, and the point is every
    record, not just ones logged on the root name."""

    def filter(self, record: logging.LogRecord) -> bool:
        try:
            from karpenter_tpu_torch import obs

            span = obs.tracer().current()
        except Exception:
            span = None
        record.trace_id = span.trace_id if span is not None else "-"
        record.span_id = span.span_id if span is not None else "-"
        return True


_trace_filter = TraceContextFilter()


def install_trace_filter() -> None:
    """Attach the trace filter to every root handler; idempotent (live
    level reload and repeated setup_logging calls must not stack copies)."""
    for handler in logging.getLogger().handlers:
        if not any(isinstance(f, TraceContextFilter) for f in handler.filters):
            handler.addFilter(_trace_filter)


def setup_logging(level: str = "info") -> None:
    """Named-logger hierarchy under ``karpenter``; idempotent."""
    logging.basicConfig(format=LOG_FORMAT)
    install_trace_filter()
    apply_log_level(level)


def apply_log_level(level: str) -> bool:
    parsed = LEVELS.get(level.strip().lower())
    if parsed is None:
        logging.getLogger(ROOT_LOGGER).warning("ignoring invalid log level %r", level)
        return False
    logging.getLogger(ROOT_LOGGER).setLevel(parsed)
    return True


def validate_log_config(level: str) -> Optional[str]:
    """The config-validation webhook's check (/config-validation analog)."""
    if level.strip().lower() not in LEVELS:
        return f"log level {level!r} not in {sorted(LEVELS)}"
    return None


class LogLevelWatcher:
    """Polls a level file (the mounted ConfigMap key) and re-applies changes
    live — the config-logging watch analog."""

    def __init__(self, path: str, interval: float = 10.0):
        self.path = path
        self.interval = interval
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last: Optional[str] = None

    def start(self) -> None:
        self._apply_once()
        self._thread = threading.Thread(target=self._run, daemon=True, name="log-config")
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            self._apply_once()

    def _apply_once(self) -> None:
        try:
            with open(self.path) as f:
                level = f.read().strip()
        except OSError:
            return
        if level and level != self._last:
            if apply_log_level(level):
                logging.getLogger(ROOT_LOGGER).info("log level now %s", level)
            self._last = level

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)
