"""Leader election via a lease — the active/passive single-writer hook
(reference: cmd/controller/main.go:84-85 ``karpenter-leader-election``) —
and the keyed lease SET that generalizes it into the fleet's sharding
primitive (docs/fleet.md). The apiserver-backed leases are
``kube/leader.py``'s; the sharding manager that drives a set
(``fleet/ownership.py``) is not ported yet.

The in-memory deployment has one process, so the default lease is in-process;
multi-process deployments back it with a shared file (one machine) or swap in
a real coordination.k8s.io/Lease client. The contract is small: acquire
(non-blocking), renew on a heartbeat, release on shutdown; holders that stop
renewing lose the lease after the duration elapses.

:class:`FileLeaseSet` extends the same flock-serialized RMW discipline to a
MAP of per-key leases plus a live-member registry in one shared file — each
controller replica heartbeats its membership and holds the leases for the
provisioner shards it owns; a replica that stops renewing loses every shard
within one lease duration and a survivor takes them over
(fleet/ownership.py drives the claim/renew/release cycle).
"""

from __future__ import annotations

import contextlib
import fcntl
import glob
import json
import logging
import os
import threading
import time
import uuid
from typing import Callable, Dict, Iterable, Optional, Set

logger = logging.getLogger("karpenter.lease")

DEFAULT_LEASE_DURATION = 15.0
DEFAULT_RENEW_INTERVAL = 5.0
# how soon a renewal that found the lease's backend unreachable is retried
# (client-go's RetryPeriod): at the renew interval, two transient failures
# in a row (a 429, then a short blackout) outlast a 15 s lease's hold
RETRY_INTERVAL = 2.0

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
        # under the flock like every other accessor: the writer's RMW is
        # temp-write + rename, and an observer reading between a racer's
        # acquire check and its rename could report a holder the very next
        # rename overwrites — a torn view two observers would disagree on
        with self._locked():
            current = self._read()
        if current and current["expiry"] > self.clock():
            return current["holder"]
        return None


class FileLeaseSet:
    """Keyed advisory leases + a live-member registry in one shared file —
    the fleet sharding primitive. One JSON record::

        {"members": {identity: expiry},
         "shards":  {key: {"holder": identity, "expiry": t}}}

    All operations are flock-serialized read-modify-writes (the same
    split-brain argument as :class:`FileLease._locked`); batch operations
    (``renew_many``) amortize the flock over a replica's whole shard set so
    a 100-shard heartbeat is one critical section, not 100."""

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

    # -- record plumbing (same discipline as FileLease) ---------------------
    def _read(self) -> dict:
        try:
            with open(self.path) as f:
                record = json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            record = {}
        record.setdefault("members", {})
        record.setdefault("shards", {})
        return record

    def _write(self, record: dict) -> None:
        tmp = f"{self.path}.{self.identity}.tmp"
        with open(tmp, "w") as f:
            json.dump(record, f)
        os.replace(tmp, self.path)

    _locked = FileLease._locked
    _sweep_stale_tmp = FileLease._sweep_stale_tmp

    @staticmethod
    def _live(entry: Optional[dict], now: float) -> bool:
        return bool(entry) and entry["expiry"] > now

    # -- membership ---------------------------------------------------------
    def heartbeat(self) -> Set[str]:
        """Register/renew this replica's membership; prune expired members.
        Returns the LIVE member identities — the peer set the shard
        manager's rendezvous placement hashes over."""
        with self._locked():
            self._sweep_stale_tmp()
            now = self.clock()
            record = self._read()
            members = {
                m: exp for m, exp in record["members"].items() if exp > now
            }
            members[self.identity] = now + self.duration
            record["members"] = members
            self._write(record)
            return set(members)

    def members(self) -> Set[str]:
        with self._locked():
            record = self._read()
        now = self.clock()
        return {m for m, exp in record["members"].items() if exp > now}

    def resign(self) -> None:
        """Drop this replica from the member registry (clean shutdown)."""
        with self._locked():
            record = self._read()
            if record["members"].pop(self.identity, None) is not None:
                self._write(record)

    # -- per-key leases -----------------------------------------------------
    def try_acquire(self, key: str) -> bool:
        with self._locked():
            now = self.clock()
            record = self._read()
            current = record["shards"].get(key)
            if (
                self._live(current, now)
                and current["holder"] != self.identity
            ):
                return False
            record["shards"][key] = {
                "holder": self.identity, "expiry": now + self.duration,
            }
            self._write(record)
            return True

    def renew_many(self, keys: Iterable[str]) -> Set[str]:
        """Renew every still-held key in ONE critical section; returns the
        keys successfully renewed. A key someone else took over (this
        replica's hold expired) is simply absent from the result — the
        caller treats it as lost."""
        keys = list(keys)
        if not keys:
            return set()
        with self._locked():
            now = self.clock()
            record = self._read()
            renewed: Set[str] = set()
            for key in keys:
                current = record["shards"].get(key)
                if (
                    not current
                    or current["holder"] != self.identity
                    or current["expiry"] <= now  # expired: takeover may have won
                ):
                    continue
                record["shards"][key] = {
                    "holder": self.identity, "expiry": now + self.duration,
                }
                renewed.add(key)
            if renewed:
                self._write(record)
            return renewed

    def release(self, key: str) -> None:
        with self._locked():
            record = self._read()
            current = record["shards"].get(key)
            if current and current["holder"] == self.identity:
                del record["shards"][key]
                self._write(record)

    def release_all(self) -> None:
        with self._locked():
            record = self._read()
            mine = [
                k for k, v in record["shards"].items()
                if v["holder"] == self.identity
            ]
            for k in mine:
                del record["shards"][k]
            if mine:
                self._write(record)

    def holder(self, key: str) -> Optional[str]:
        with self._locked():
            record = self._read()
        current = record["shards"].get(key)
        if self._live(current, self.clock()):
            return current["holder"]
        return None

    def snapshot(self, keys: Optional[Iterable[str]] = None) -> Dict[str, str]:
        """Live key → holder map (expired holds omitted). ``keys`` is a
        hint for backends that cannot enumerate (KubeLeaseSet); the file
        record holds every key, so it is ignored here."""
        with self._locked():
            record = self._read()
        now = self.clock()
        return {
            k: v["holder"]
            for k, v in record["shards"].items()
            if self._live(v, now)
        }


class LeaderElector:
    """Blocks followers until leadership is acquired, then renews on a
    heartbeat (a renewal that held the lease optimistically, its backend
    unreachable, is retried after ``RETRY_INTERVAL`` instead);
    ``is_leader`` flips false if renewal fails (lost lease) and
    the ``on_lost`` callback fires — a second active leader must never keep
    mutating cloud state (the reference exits the process on lost lease)."""

    def __init__(
        self,
        lease: FileLease,
        renew_interval: float = DEFAULT_RENEW_INTERVAL,
        on_lost: Optional[Callable[[], None]] = None,
    ):
        self.lease = lease
        self.renew_interval = renew_interval
        self.on_lost = on_lost
        self._leader = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # at-most-once-per-epoch guard for on_lost: the elector thread's
        # failed-renew branch, its raising-backend branch, and stop() can
        # all observe the same lost leadership — only ONE may fire the
        # callback per acquisition epoch (a double on_lost double-stops
        # the manager / double-exits the process in real deployments)
        self._epoch_lock = threading.Lock()
        self._epoch = 0  # guarded-by: self._epoch_lock
        self._lost_epoch = 0  # epochs whose loss was handled; guarded-by: self._epoch_lock

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True, name="leader-elector")
        self._thread.start()

    def _acquired(self) -> None:
        with self._epoch_lock:
            self._epoch += 1
            self._leader.set()

    def _fire_lost(self, notify: bool = True) -> None:
        """Flip the leader flag and fire ``on_lost`` at most once per
        leadership epoch. ``notify=False`` (clean release via ``stop``)
        consumes the epoch WITHOUT the callback, so a racing elector-thread
        branch cannot fire it after the release."""
        with self._epoch_lock:
            if not self._leader.is_set():
                return
            self._leader.clear()
            if self._lost_epoch >= self._epoch:
                return
            self._lost_epoch = self._epoch
        if notify and self.on_lost is not None:
            self.on_lost()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                if self._leader.is_set():
                    if not self.lease.renew():
                        self._fire_lost()
                elif self.lease.try_acquire():
                    self._acquired()
            except Exception:
                # a lease backend that raises must not kill the elector
                # thread: a dead elector with is_leader stuck True is the
                # split-brain case election exists to prevent
                logger.exception("lease operation failed")
                self._fire_lost()
            wait = self.renew_interval
            if self._leader.is_set() and getattr(self.lease, "unreachable", False):
                # an optimistic hold (kube/leader.py): retry soon, so a
                # short outage is bridged well before the hold's fence
                wait = min(wait, RETRY_INTERVAL)
            self._stop.wait(wait)

    def wait_for_leadership(self, timeout: Optional[float] = None) -> bool:
        return self._leader.wait(timeout)

    @property
    def is_leader(self) -> bool:
        return self._leader.is_set()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)
        if self._leader.is_set():
            self.lease.release()
            # consume the epoch silently: a raising backend whose elector
            # thread outlived the join timeout must not fire on_lost for a
            # leadership we just released on purpose
            self._fire_lost(notify=False)
