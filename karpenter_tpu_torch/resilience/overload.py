"""The overload verdicts of the solver wire.

Two failure classes that are not failures in the breaker sense:

- :class:`OverloadedError`: the sidecar is alive but refusing work (its
  bounded admission queue is full, or its device headroom is under the
  floor). It carries the sidecar's retry-after hint. Tripping a circuit
  breaker on it would turn a brownout into an outage, so the caller serves
  the batch in process instead.
- :class:`DeadlineExceededError`: the work's own deadline (the propagated
  round :class:`~karpenter_tpu_torch.resilience.policy.Budget`) expired.
  Retrying is useless by definition.

Standard library only: the sidecar's codec and client import it.
"""

from __future__ import annotations


class OverloadedError(RuntimeError):
    """The sidecar shed this request under load: it is alive and will
    recover, so retry after the hint or serve elsewhere. ``kind`` names the
    bound that fired (``"admission"``: the sidecar's bounded queue or its
    device-headroom floor; ``"credits"``: the stream's credit window, empty
    at the sender)."""

    def __init__(
        self, message: str, retry_after: float = 1.0, kind: str = "admission"
    ):
        super().__init__(message)
        self.retry_after = max(float(retry_after), 0.0)
        self.kind = kind


class DeadlineExceededError(RuntimeError):
    """The operation's propagated deadline expired before (or while) the
    work ran: not retryable."""
