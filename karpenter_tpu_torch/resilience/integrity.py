"""The typed integrity verdict.

Standard library only, like :mod:`resilience.overload`: the sidecar's
codec and client raise it, and neither may pull anything heavier in.

An :class:`IntegrityError` says a wire frame failed its end-to-end
checksum, a response could not be parsed while checksums were negotiated,
or a Pack echoed the wrong catalog session key even after a forced
re-open. It is not an overload verdict: overload is backpressure (retry
later, or elsewhere); corruption is a correctness failure whose source is
quarantined. It is never retried on the same sidecar, and it always
raises: a checksum mismatch never degrades into a silently wrong array.
"""

from __future__ import annotations


class IntegrityError(RuntimeError):
    """A wire frame or pack result failed an end-to-end integrity check.

    ``address`` names the peer the corrupt data is attributed to (empty
    for the in-process path); ``kind`` says which defense fired:
    ``checksum`` (a frame digest mismatch, either side), ``frame`` (the
    codec could not parse a frame while checksums were negotiated) or
    ``session`` (a Pack echoed the wrong catalog session key even after a
    forced re-open).
    """

    def __init__(self, message: str, address: str = "", kind: str = "checksum"):
        super().__init__(message)
        self.address = address
        self.kind = kind
