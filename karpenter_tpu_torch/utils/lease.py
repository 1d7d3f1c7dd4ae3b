"""An advisory lease in a shared file, and the flock'd read-modify-write
discipline the launch journal's file backend borrows from it.

A holder acquires (non-blocking), renews on a heartbeat and releases on
shutdown; a holder that stops renewing loses the lease once its duration
has passed. The keyed lease set and the leader elector built on it in the
reference are not ported yet.
"""

from __future__ import annotations

import contextlib
import fcntl
import glob
import json
import os
import time
import uuid
from typing import Callable, Optional

DEFAULT_LEASE_DURATION = 15.0

# a crashed writer can leave its write-to-temp file behind forever; sweep
# anything older than this many lease durations during acquire rounds
STALE_TMP_DURATIONS = 4.0


class FileLease:
    """Advisory lease in a shared file: {holder, expiry}. Atomic via
    write-to-temp + rename; stale leases are taken over after expiry."""

    def __init__(
        self,
        path: str,
        identity: Optional[str] = None,
        duration: float = DEFAULT_LEASE_DURATION,
        clock: Optional[Callable[[], float]] = None,
    ):
        self.path = path
        self.identity = identity or f"{os.getpid()}-{uuid.uuid4().hex[:8]}"
        self.duration = duration
        self.clock = clock or time.time

    def _read(self) -> Optional[dict]:
        try:
            with open(self.path) as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return None

    def _write(self, record: dict) -> None:
        tmp = f"{self.path}.{self.identity}.tmp"
        with open(tmp, "w") as f:
            json.dump(record, f)
        os.replace(tmp, self.path)

    def _sweep_stale_tmp(self) -> None:
        """Remove ``*.tmp`` files left by writers that crashed between the
        temp write and the rename. Caller holds the flock; only files old
        enough that no live writer can still be mid-RMW are removed."""
        horizon = time.time() - self.duration * STALE_TMP_DURATIONS
        for tmp in glob.glob(f"{glob.escape(self.path)}.*.tmp"):
            try:
                if os.path.getmtime(tmp) < horizon:
                    os.remove(tmp)
            except OSError:
                pass  # a racer renamed or removed it first

    @contextlib.contextmanager
    def _locked(self):
        """flock-serialized critical section: acquire/renew are
        read-modify-write, and two racers interleaving around the atomic
        rename could BOTH conclude they hold the lease (split brain)."""
        lock_path = f"{self.path}.flock"
        fd = os.open(lock_path, os.O_CREAT | os.O_RDWR)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            yield
        finally:
            fcntl.flock(fd, fcntl.LOCK_UN)
            os.close(fd)

    def try_acquire(self) -> bool:
        with self._locked():
            self._sweep_stale_tmp()
            now = self.clock()
            current = self._read()
            if current and current["holder"] != self.identity and current["expiry"] > now:
                return False
            self._write({"holder": self.identity, "expiry": now + self.duration})
            return True

    def renew(self) -> bool:
        with self._locked():
            now = self.clock()
            current = self._read()
            if (
                not current
                or current["holder"] != self.identity
                or current["expiry"] <= now  # expired: takeover may have won
            ):
                return False
            self._write({"holder": self.identity, "expiry": now + self.duration})
            return True

    def release(self) -> None:
        with self._locked():
            current = self._read()
            if current and current["holder"] == self.identity:
                try:
                    os.remove(self.path)
                except FileNotFoundError:
                    pass

    def holder(self) -> Optional[str]:
        # under the flock like every other accessor: an observer reading
        # between a racer's acquire check and its rename could report a
        # holder the very next rename overwrites
        with self._locked():
            current = self._read()
        if current and current["expiry"] > self.clock():
            return current["holder"]
        return None
