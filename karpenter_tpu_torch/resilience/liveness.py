"""N-consecutive-miss liveness accounting.

``SimCloudAPI.describe_instances`` (like EC2's) silently drops ids it does
not know — indistinguishable, on one response, from "the instance was
terminated out from under us". Declaring a node dead on a single miss
orphans healthy capacity whenever the control plane flakes; this tracker
requires ``threshold`` consecutive misses before a subject is considered
gone, and any sighting (or an errored describe, which callers report as
neither) resets the count.
"""

from __future__ import annotations

import threading
from typing import Dict


class MissTracker:
    # mid-streak subjects whose probes simply stop (node reaped by another
    # path) would otherwise accumulate forever; evict oldest past this
    MAX_SUBJECTS = 4096

    def __init__(self, threshold: int = 3):
        self.threshold = max(int(threshold), 1)
        self._misses: Dict[str, int] = {}
        self._mu = threading.Lock()

    def observe(self, subject: str, present: bool) -> bool:
        """Record one describe outcome; True once ``subject`` has been
        missing from ``threshold`` consecutive responses."""
        with self._mu:
            if present:
                self._misses.pop(subject, None)
                return False
            count = self._misses.pop(subject, 0) + 1
            # re-insert at the back: dict order makes eviction oldest-first
            self._misses[subject] = count
            while len(self._misses) > self.MAX_SUBJECTS:
                self._misses.pop(next(iter(self._misses)))
            return count >= self.threshold

    def misses(self, subject: str) -> int:
        with self._mu:
            return self._misses.get(subject, 0)

    def forget(self, subject: str) -> None:
        """Drop a subject (its node is gone for a confirmed reason)."""
        with self._mu:
            self._misses.pop(subject, None)
