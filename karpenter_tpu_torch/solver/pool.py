"""A pool of solver sidecars behind one controller.

``RemoteSolver`` talks to one sidecar; a comma-separated
``solver_service_address`` fronts a pool of them. Routing is a
consistent-hash ring keyed on the catalog session key
(``service.catalog_session_key``): a catalog generation's tensors live on
one member's card, so the steady state solves against a resident session
and the members do not each pin every catalog. The ring and its hash are
the reference package's, so both packages route every key to the same
member.

Each member has its own circuit breaker (window 1, min volume 1: any
failure sidelines it for ``MEMBER_BREAKER_SECONDS``), and a dead or
breaker-open member sends the solve to the next member along the ring,
whose ``RemoteSolver`` re-uploads the catalog through ``NEEDS_CATALOG``.
An ``IntegrityError`` quarantines the member (its breaker tripped, the
``on_quarantine`` hook called). An ``OverloadedError`` (a sidecar's
``STATUS_OVERLOADED``, or an empty stream credit window) is backpressure:
the member sits out its retry-after hint and no breaker moves. Only when
every member refuses does the pool raise — ``PoolExhausted``, or
``OverloadedError`` when every refusal was backpressure — and the
scheduler's outer remote breaker takes it from there.

Each reroute off a failed member counts
``karpenter_solver_pool_failovers_total{address=<failed member>}`` and a
fetch-time failover runs under a ``solver.pool.failover`` span carrying
``from`` and ``to``; member breakers publish ``karpenter_solver_breaker_*``
and the admitting count ``karpenter_solver_pool_members``.
"""

from __future__ import annotations

import hashlib
import logging
import threading
import time
from bisect import bisect_right
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from karpenter_tpu_torch.resilience.integrity import IntegrityError
from karpenter_tpu_torch import metrics, obs
from karpenter_tpu_torch.resilience.overload import DeadlineExceededError, OverloadedError
from karpenter_tpu_torch.solver import integrity
from karpenter_tpu_torch.solver.service import N_POD_ARRAYS, CatalogKeyMemo, RemoteSolver

logger = logging.getLogger("karpenter.solver.pool")

# per-member breaker: any failure sidelines the member (one bounded stall,
# not one per solve); half-open probes re-admit it once it answers again
MEMBER_BREAKER_SECONDS = 15.0

# virtual nodes per member: an 8-member pool's key space splits within a
# few percent of even, and a rebuild on membership change stays cheap
RING_VNODES = 64


class PoolExhausted(RuntimeError):
    """Every pool member was dead or breaker-open for this solve."""


class HashRing:
    """Consistent-hash ring over member addresses. ``ordered(key)`` yields
    every member once, starting from the key's ring successor: the
    failover order."""

    def __init__(self, members: Sequence[str], vnodes: int = RING_VNODES):
        if not members:
            raise ValueError("hash ring needs at least one member")
        self.members = list(dict.fromkeys(members))  # stable order, deduped
        points: List[Tuple[int, str]] = []
        for member in self.members:
            for i in range(vnodes):
                digest = hashlib.blake2b(f"{member}#{i}".encode(), digest_size=8).digest()
                points.append((int.from_bytes(digest, "big"), member))
        points.sort()
        self._points = points
        self._hashes = [h for h, _ in points]

    @staticmethod
    def _key_point(key: bytes) -> int:
        return int.from_bytes(hashlib.blake2b(key, digest_size=8).digest(), "big")

    def route(self, key: bytes) -> str:
        return self.ordered(key)[0]

    def ordered(self, key: bytes) -> List[str]:
        start = bisect_right(self._hashes, self._key_point(key))
        seen: "OrderedDict[str, None]" = OrderedDict()
        n = len(self._points)
        for i in range(n):
            _, member = self._points[(start + i) % n]
            if member not in seen:
                seen[member] = None
                if len(seen) == len(self.members):
                    break
        return list(seen)


class SolverPool:
    """Drop-in for :class:`RemoteSolver` over N sidecar addresses: the same
    ``pack_begin(...) -> wait()`` / ``pack`` / ``health`` / ``close``
    surface, so the scheduler treats a pool and one sidecar alike."""

    KEY_MEMO_MAX = 8

    def __init__(
        self,
        addresses: Sequence[str],
        timeout: float = 30.0,
        cold_timeout: float = 180.0,
        breaker_open_seconds: float = MEMBER_BREAKER_SECONDS,
        client_factory: Optional[Callable[[str], RemoteSolver]] = None,
        clock: Callable[[], float] = time.monotonic,
        checksum: bool = False,
        stream: bool = False,
        shm_dir: str = "",
        delta: bool = False,
    ):
        from karpenter_tpu_torch.resilience import BreakerBoard

        addresses = [a.strip() for a in addresses if a.strip()]
        self._clock = clock
        self.ring = HashRing(addresses)
        self.addresses = self.ring.members
        self._timeout = timeout
        self._cold_timeout = cold_timeout
        self._client_factory = client_factory or (
            lambda addr: RemoteSolver(
                addr, timeout=timeout, cold_timeout=cold_timeout,
                checksum=checksum, stream=stream, shm_dir=shm_dir, delta=delta,
            )
        )
        # one breaker per member on the pool's clock (an injected test
        # clock drives the cool-off too)
        self._breakers = BreakerBoard(
            clock=clock, window=1, min_volume=1, failure_rate=0.5,
            open_seconds=breaker_open_seconds,
        )
        self._mu = threading.Lock()
        self._clients: dict = {}  # guarded-by: self._mu
        self._key_memo = CatalogKeyMemo(self.KEY_MEMO_MAX)
        self.failovers = 0  # guarded-by: self._mu
        # the soft breaker: a member that answered overloaded sits out its
        # retry-after window and is routed around; its real breaker (and
        # the half-open probes a trip brings) is never touched
        self._backoff_until: Dict[str, float] = {}  # guarded-by: self._mu
        self.overload_skips = 0  # guarded-by: self._mu
        # integrity quarantine hook (reason, address, detail): the owning
        # scheduler points it at its cluster-event emitter
        self.on_quarantine: Optional[Callable[[str, str, str], None]] = None

    # -- members ------------------------------------------------------------

    def _client(self, address: str) -> RemoteSolver:
        with self._mu:
            client = self._clients.get(address)
            if client is None:
                client = self._clients[address] = self._client_factory(address)
            return client

    def _breaker(self, address: str):
        return self._breakers.get(f"solver-pool:{address}")

    def _member_failure(self, address: str, exc: Exception) -> None:
        tripped = self._breaker(address).record_failure()
        metrics.SOLVER_BREAKER_OPEN.labels(address=address).set(1)
        if tripped:
            metrics.SOLVER_BREAKER_TRIPS.labels(address=address).inc()
        logger.error("solver pool member %s failed (%s); rerouting", address, exc)
        self._publish_available()

    def _member_success(self, address: str) -> None:
        self._breaker(address).record_success()
        metrics.SOLVER_BREAKER_OPEN.labels(address=address).set(0)
        self._publish_available()

    def quarantine(self, address: str, reason: str, detail: str = "") -> None:
        """The member produced corrupt data (a checksum failure, a canary
        mismatch, a screen failure, a stale-session reply): trip its
        breaker at once. Half-open probes re-admit it after the cool-off,
        and a member still corrupting is quarantined again on its first
        probe-served solve."""
        self._breaker(address).trip()
        metrics.SOLVER_BREAKER_OPEN.labels(address=address).set(1)
        metrics.SOLVER_BREAKER_TRIPS.labels(address=address).inc()
        integrity.record_quarantine(address, reason, detail)
        logger.error("solver pool member %s QUARANTINED (%s): %s", address, reason, detail)
        hook = self.on_quarantine
        if hook is not None:
            try:
                hook(reason, address, detail)
            except Exception:
                logger.debug("quarantine hook failed", exc_info=True)
        self._publish_available()

    def _member_corrupt(self, address: str, exc: IntegrityError) -> None:
        """An integrity verdict from this member: quarantine, and the caller
        reroutes (never a retry on the same member)."""
        self.quarantine(address, exc.kind, str(exc))

    def _member_overloaded(self, address: str, retry_after: float) -> None:
        """The soft breaker: sit the member out for its own hint."""
        with self._mu:
            self._backoff_until[address] = self._clock() + max(retry_after, 0.0)
        logger.info(
            "solver pool member %s overloaded; sitting it out %.2fs",
            address, max(retry_after, 0.0),
        )

    def _soft_backing_off(self, address: str) -> bool:
        with self._mu:
            until = self._backoff_until.get(address)
            if until is None:
                return False
            if self._clock() >= until:
                del self._backoff_until[address]
                return False
            return True

    def _backoff_remaining(self, address: str) -> float:
        with self._mu:
            until = self._backoff_until.get(address)
            return 0.0 if until is None else max(until - self._clock(), 0.0)

    def _count_overload_skip(self, address: str) -> None:
        metrics.SOLVER_POOL_OVERLOAD_SKIPS.labels(address=address).inc()
        with self._mu:
            self.overload_skips += 1

    def _count_failover(self, failed: str) -> None:
        metrics.SOLVER_POOL_FAILOVERS.labels(address=failed).inc()
        with self._mu:
            self.failovers += 1

    def _publish_available(self) -> None:
        metrics.SOLVER_POOL_MEMBERS.set(len(self.available_members()))

    def available_members(self) -> List[str]:
        """Members admitting solves now (breaker closed or probe-ready)."""
        return [a for a in self.addresses if self._breaker(a).available()]

    def health(self, timeout: float = 2.0) -> bool:
        """True when any member reports SERVING."""
        return any(self._client(a).health(timeout=timeout) for a in self.addresses)

    def _catalog_key(self, catalog_side: Tuple) -> bytes:
        """The ring key: the same content key the member pins its session
        under, memoized by the arrays' identity."""
        return self._key_memo.key(catalog_side)

    # -- solves -------------------------------------------------------------

    def pack_begin(
        self, *inputs, n_max: int, prof: Optional[dict] = None, record: bool = True
    ):
        """Route by session affinity, dispatch on the first admitting
        member, and return ``wait()``. A dispatch failure tries the next
        ring member at once; a fetch failure (inside ``wait``) fails over
        synchronously."""
        key = self._catalog_key(inputs[N_POD_ARRAYS:])
        order = self.ring.ordered(key)
        last_exc: Optional[Exception] = None
        hints: List[float] = []
        for i, address in enumerate(order):
            if self._soft_backing_off(address):
                # routed around without an RPC; its real breaker untouched
                self._count_overload_skip(address)
                hints.append(self._backoff_remaining(address))
                continue
            if not self._breaker(address).allow():
                # the solve lands on a non-affine member: a failover
                self._count_failover(address)
                continue
            try:
                pending = self._client(address).pack_begin(
                    *inputs, n_max=n_max, prof=prof, record=record
                )
            except DeadlineExceededError:
                # the work's deadline, not the member's health
                raise
            except OverloadedError as e:
                self._member_overloaded(address, e.retry_after)
                self._count_overload_skip(address)
                hints.append(e.retry_after)
                continue
            except IntegrityError as e:
                last_exc = e
                self._member_corrupt(address, e)
                self._count_failover(address)
                continue
            except Exception as e:
                last_exc = e
                self._member_failure(address, e)
                self._count_failover(address)
                continue
            return self._wrap_wait(pending, address, order[i + 1:], inputs, n_max, prof, record)
        if hints:
            # the pool is full, not broken: typed, so the scheduler's outer
            # remote breaker never trips on pure overload; the soonest
            # member to free sets the hint
            raise OverloadedError(
                f"every solver pool member overloaded (tried {order})",
                retry_after=min(hints),
            )
        raise PoolExhausted(f"no solver pool member available (tried {order}): {last_exc}")

    def _wrap_wait(self, pending, address: str, remaining: List[str],
                   inputs, n_max: int, prof: Optional[dict], record: bool):
        def wait():
            try:
                out = pending()
            except DeadlineExceededError:
                # no surviving member could make the deadline either
                raise
            except OverloadedError as e:
                # shed in flight: sit the member out and fail over (no
                # breaker state touched)
                self._member_overloaded(address, e.retry_after)
                self._count_overload_skip(address)
                return self._failover(address, remaining, inputs, n_max, prof, record, e,
                                      failed_is_overloaded=True)
            except IntegrityError as e:
                self._member_corrupt(address, e)
                return self._failover(address, remaining, inputs, n_max, prof, record, e)
            except Exception as e:
                self._member_failure(address, e)
                return self._failover(address, remaining, inputs, n_max, prof, record, e)
            self._member_success(address)
            return out

        return wait

    def _failover(self, failed: str, remaining: List[str], inputs, n_max: int,
                  prof: Optional[dict], record: bool, cause: Exception,
                  failed_is_overloaded: bool = False):
        last_exc: Exception = cause
        hints: List[float] = [cause.retry_after] if isinstance(cause, OverloadedError) else []
        for address in remaining:
            if self._soft_backing_off(address):
                self._count_overload_skip(address)
                hints.append(self._backoff_remaining(address))
                continue
            if not self._breaker(address).allow():
                continue
            # a reroute off a failed member is a failover; off a full one a
            # soft skip, already counted
            if not failed_is_overloaded:
                self._count_failover(failed)
            logger.info("solver pool failover %s -> %s", failed, address)
            # synchronous on the surviving member (its NEEDS_CATALOG path
            # re-uploads the session), under a span naming the detour. It
            # runs on the caller's thread, inside the round's solve.pack_fetch
            with obs.tracer().span(
                "solver.pool.failover", attrs={"from": failed, "to": address},
            ):
                try:
                    out = self._client(address).pack_begin(
                        *inputs, n_max=n_max, prof=prof, record=record
                    )()
                except DeadlineExceededError:
                    raise  # the work's deadline: no member can outrun it
                except OverloadedError as e:
                    self._member_overloaded(address, e.retry_after)
                    self._count_overload_skip(address)
                    hints.append(e.retry_after)
                    failed, failed_is_overloaded = address, True
                    continue
                except IntegrityError as e:
                    last_exc = e
                    self._member_corrupt(address, e)
                    failed, failed_is_overloaded = address, False
                    continue
                except Exception as e:
                    last_exc = e
                    self._member_failure(address, e)
                    failed, failed_is_overloaded = address, False
                    continue
            self._member_success(address)
            return out
        if isinstance(cause, OverloadedError) and last_exc is cause:
            # nothing failed: the first verdict and every member since were
            # backpressure (a real failure would have replaced last_exc)
            raise OverloadedError(
                "every solver pool member overloaded during failover",
                retry_after=min(hints),
            )
        raise PoolExhausted(f"solver pool exhausted after failover (last member error: {last_exc})")

    def pack(self, *inputs, n_max: int):
        """Synchronous convenience wrapper over ``pack_begin``."""
        return self.pack_begin(*inputs, n_max=n_max)()

    def close(self) -> None:
        with self._mu:
            clients = list(self._clients.values())
        for client in clients:
            try:
                client.close()
            except Exception:
                pass
