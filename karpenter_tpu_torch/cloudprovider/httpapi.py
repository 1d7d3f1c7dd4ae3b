"""HTTP wire protocol for the simulated cloud control plane.

Called in process, the vendor layer and its ``SimCloudAPI`` double could
share a protocol misunderstanding. This module puts a real wire between them,
the way the reference's provider drives an SDK over HTTP against
behavior-programmable fakes (reference: aws/fake/ec2api.go:35-137):

- ``CloudAPIServer`` serves a ``SimCloudAPI`` (or ``SimGkeAPI``-style
  object) over REST: JSON bodies, list pagination with opaque
  next-tokens, structured error bodies ``{"error": {"code", "message"}}``,
  throttling as 429 + Retry-After, injected control-plane failures as
  5xx. Tests keep programming the underlying ``SimCloudAPI`` directly
  (same process) — the *calls* cross HTTP.
- ``HttpCloudAPI`` is the client: same eight-method protocol as
  ``SimCloudAPI`` (drop-in for ``SimulatedCloudProvider(api=...)``),
  implemented over urllib with bounded retries — exponential backoff on
  5xx, Retry-After-honoring retries on 429 — pagination loops, and error
  classification from the wire error code back to the typed exceptions
  the providers already handle (``InsufficientCapacityError``,
  ``CloudAPIError``).
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import asdict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Sequence, Tuple

from karpenter_tpu_torch.cloudprovider.simulated import (
    CloudAPIError,
    InstanceNotFoundError,
    InsufficientCapacityError,
    SimCloudAPI,
    SimInstance,
    SimInstanceTypeInfo,
    SimSecurityGroup,
    SimSubnet,
)
from karpenter_tpu_torch.interruption.types import DisruptionNotice

# wire error codes (the EC2-style error-code vocabulary the reference's
# error classifier switches on — aws/errors.go)
CODE_ICE = "InsufficientInstanceCapacity"
CODE_THROTTLE = "RequestLimitExceeded"
CODE_INTERNAL = "InternalError"
CODE_NOT_FOUND = "NotFound"  # route-level: unknown method+path
CODE_INSTANCE_NOT_FOUND = "InvalidInstanceID.NotFound"  # typed: no such record
CODE_BAD_REQUEST = "InvalidArgument"

DEFAULT_PAGE_SIZE = 3  # small so real catalogs actually paginate in tests


class ThrottlingError(Exception):
    """Injectable control-plane throttle: the server answers 429 with a
    Retry-After header; the HTTP client retries, in-process callers see
    the raised exception directly."""

    def __init__(self, retry_after: float = 0.05):
        super().__init__(f"throttled, retry after {retry_after}s")
        self.retry_after = retry_after


class _BadRequest(Exception):
    """Malformed wire request (missing field, invalid JSON) → 400, which
    the client classifies as a deterministic error and never retries."""


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------


class _JsonApiServer:
    """Shared scaffolding: a localhost ThreadingHTTPServer whose handler
    maps the double's typed exceptions to wire status codes + error
    bodies. Subclasses implement ``_route``."""

    def __init__(self):
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, status: int, body: Dict[str, Any], headers=()):
                data = json.dumps(body).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                for k, v in headers:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(data)

            def _error(self, status: int, code: str, message: str, headers=(),
                       details=None):
                body: Dict[str, Any] = {"error": {"code": code, "message": message}}
                if details:
                    body["error"]["details"] = details
                self._send(status, body, headers)

            def _body(self) -> Dict[str, Any]:
                length = int(self.headers.get("Content-Length", 0))
                try:
                    return json.loads(self.rfile.read(length) or b"{}")
                except json.JSONDecodeError as e:
                    raise _BadRequest(f"invalid JSON body: {e}") from e

            def _dispatch(self, method: str):
                try:
                    # traceparent-style propagation: a traced client call
                    # (the metered provider's cloud.<method> span) parents
                    # this server's request span, so the control plane's
                    # share of a launch is attributable in one trace
                    from karpenter_tpu_torch import obs

                    ctx = obs.from_traceparent(self.headers.get("traceparent"))
                    if ctx is not None:
                        with obs.tracer().span(
                            "cloudapi.request",
                            parent=ctx,
                            attrs={"method": method, "path": self.path},
                        ):
                            outer._route(self, method)
                    else:
                        outer._route(self, method)
                except ThrottlingError as e:
                    self._error(429, CODE_THROTTLE, str(e),
                                headers=[("Retry-After", f"{e.retry_after:.3f}")])
                except InsufficientCapacityError as e:
                    # the all-ICE fleet outcome crosses the wire typed, WITH
                    # its errored overrides, so the client-side ICE cache
                    # marks exactly the pools the server saw exhausted
                    details = None
                    if getattr(e, "overrides", None):
                        details = {"overrides": [
                            {"capacityType": ct, "instanceType": it, "zone": z}
                            for ct, it, z in e.overrides
                        ]}
                    self._error(409, CODE_ICE, str(e), details=details)
                except _BadRequest as e:
                    self._error(400, CODE_BAD_REQUEST, str(e))
                except InstanceNotFoundError as e:
                    # BEFORE the CloudAPIError catch-all (it subclasses it):
                    # a positive "no such record" must cross typed as 404 —
                    # not as a retryable 500, and under its OWN code so a
                    # route-level 404 (client/server skew, bad base_url)
                    # can never read as "instance confirmed gone"
                    self._error(404, CODE_INSTANCE_NOT_FOUND, str(e))
                except CloudAPIError as e:
                    self._error(500, CODE_INTERNAL, str(e))
                except Exception as e:  # a double must never hang the client
                    status, code = outer._classify_exception(e)
                    self._error(status, code, f"{e}")

            def do_GET(self):
                self._dispatch("GET")

            def do_POST(self):
                self._dispatch("POST")

            def do_PUT(self):
                self._dispatch("PUT")

            def do_DELETE(self):
                self._dispatch("DELETE")

        self._server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="cloud-api-double", daemon=True
        )

    def _classify_exception(self, e: Exception):
        return 500, CODE_INTERNAL

    def _route(self, h, method: str) -> None:
        raise NotImplementedError

    # -- lifecycle ----------------------------------------------------------
    @property
    def url(self) -> str:
        host, port = self._server.server_address[:2]
        return f"http://{host}:{port}"

    def start(self):
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


class CloudAPIServer(_JsonApiServer):
    """Serves one ``SimCloudAPI`` over localhost HTTP.

    Routes (all JSON):
      GET    /v1/instance-types?max-results=&next-token=   → paginated
      GET    /v1/subnets?tag:<k>=<v>…                      → {"items": [...]}
      GET    /v1/security-groups?tag:<k>=<v>…              → {"items": [...]}
      PUT    /v1/launch-templates/<name>   body=data       → {"name": ...}
      DELETE /v1/launch-templates/<name>
      POST   /v1/fleet     {"capacityType", "overrides"}   → instances + errors
      POST   /v1/instances/describe  {"ids": [...]}        → {"items": [...]}
      GET    /v1/instances                                 → full inventory with
                                                             launch tokens
      POST   /v1/instances/terminate {"ids": [...]}        → {}
      GET    /v1/events                                    → pending disruption
                                                             notices (drained)
      POST   /v1/events/requeue      body=notice           → re-offer a drained
                                                             notice (fleet routing)
    """

    def __init__(self, api: Optional[SimCloudAPI] = None, page_size: int = DEFAULT_PAGE_SIZE):
        self.api = api or SimCloudAPI()
        self.page_size = page_size
        self._fleet_results: Dict[str, Dict[str, Any]] = {}
        self._fleet_mu = threading.Lock()
        super().__init__()

    # -- routing ------------------------------------------------------------
    def _route(self, h, method: str) -> None:
        parsed = urllib.parse.urlsplit(h.path)
        path = parsed.path.rstrip("/")
        # keep blank values: "tag:Name=" is the key-exists wildcard selector
        query = urllib.parse.parse_qs(parsed.query, keep_blank_values=True)
        api = self.api

        if method == "GET" and path == "/v1/instance-types":
            items = [asdict(i) for i in api.describe_instance_types()]
            start = int(query.get("next-token", ["0"])[0])
            size = int(query.get("max-results", [str(self.page_size)])[0])
            page = items[start : start + size]
            body: Dict[str, Any] = {"items": page}
            if start + size < len(items):
                body["nextToken"] = str(start + size)
            h._send(200, body)
        elif method == "GET" and path == "/v1/subnets":
            selector = _tag_selector(query)
            h._send(200, {"items": [asdict(s) for s in api.describe_subnets(selector)]})
        elif method == "GET" and path == "/v1/security-groups":
            selector = _tag_selector(query)
            h._send(200, {"items": [asdict(g) for g in api.describe_security_groups(selector)]})
        elif method == "PUT" and path.startswith("/v1/launch-templates/"):
            name = urllib.parse.unquote(path.rsplit("/", 1)[1])
            out = api.ensure_launch_template(name, h._body())
            h._send(200, {"name": out})
        elif method == "DELETE" and path.startswith("/v1/launch-templates/"):
            name = urllib.parse.unquote(path.rsplit("/", 1)[1])
            api.delete_launch_template(name)
            h._send(200, {})
        elif method == "POST" and path == "/v1/fleet":
            body = h._body()
            if "capacityType" not in body:
                raise _BadRequest("fleet request missing capacityType")
            try:
                overrides = [
                    (o["launchTemplate"], o["instanceType"], o["zone"])
                    for o in body.get("overrides", [])
                ]
            except KeyError as e:
                raise _BadRequest(f"fleet override missing {e}") from e
            # idempotency: a retried POST (lost response / timeout) with the
            # same client token replays the recorded answer instead of
            # double-launching — the CreateFleet ClientToken contract. The
            # wire-level replay cache catches retries of THIS server; the
            # token also rides down to the control-plane double, whose own
            # ledger dedupes across server restarts and in-process callers.
            token = body.get("clientToken")
            if token is not None:
                with self._fleet_mu:
                    cached = self._fleet_results.get(token)
                if cached is not None:
                    # replay only while the recorded instances are still
                    # live: a delete between the first attempt and this
                    # retry must not resurrect a terminated instance as a
                    # fresh create result — drop the stale record and fall
                    # through (the control-plane ledger launches fresh)
                    ids = [i["id"] for i in cached.get("instances", [])]
                    live = {
                        i.id for i in api.describe_instances(ids)
                        if getattr(i, "state", "") != "terminated"
                    }
                    if all(i in live for i in ids):
                        h._send(200, cached)
                        return
                    with self._fleet_mu:
                        self._fleet_results.pop(token, None)
            instances, errors = api.create_fleet(
                body["capacityType"], overrides, client_token=token or ""
            )
            out = {
                "instances": [asdict(i) for i in instances],
                "errors": [
                    {"code": CODE_ICE, "capacityType": ct, "instanceType": it, "zone": z}
                    for ct, it, z in errors
                ],
            }
            if token is not None:
                with self._fleet_mu:
                    self._fleet_results[token] = out
                    while len(self._fleet_results) > 1024:
                        self._fleet_results.pop(next(iter(self._fleet_results)))
            h._send(200, out)
        elif method == "POST" and path == "/v1/instances/describe":
            ids = h._body().get("ids", [])
            h._send(200, {"items": [asdict(i) for i in api.describe_instances(ids)]})
        elif method == "GET" and path == "/v1/instances":
            # full inventory with launch tokens — the GC/recovery sweep
            h._send(200, {"items": [asdict(i) for i in api.list_instances()]})
        elif method == "POST" and path == "/v1/instances/terminate":
            api.terminate_instances(h._body().get("ids", []))
            h._send(200, {})
        elif method == "GET" and path == "/v1/events":
            # the disruption-event stream: GET drains pending notices (the
            # SQS receive-and-delete analog; the wire consumer is the only
            # reader, matching NoticeQueue's at-most-once contract)
            h._send(200, {"items": [n.to_wire() for n in api.poll_disruptions()]})
        elif method == "POST" and path == "/v1/events/requeue":
            # the re-offer endpoint (the SQS visibility-timeout analog): a
            # sharded replica that drained a notice for a node it does not
            # own hands it BACK so the owner's next poll picks it up
            api.send_disruption_notice(DisruptionNotice.from_wire(h._body()))
            h._send(200, {})
        else:
            h._error(404, CODE_NOT_FOUND, f"{method} {path}")


def _tag_selector(query: Dict[str, List[str]]) -> Dict[str, str]:
    return {
        k[len("tag:"):]: vs[0]
        for k, vs in query.items()
        if k.startswith("tag:")
    }


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------


class _WireTransport:
    """Shared HTTP transport with bounded retries under the resilience
    layer's policy (resilience/policy.py): up to ``max_attempts`` on 429
    (honoring Retry-After) and, for idempotent requests, on 5xx /
    connection errors with DECORRELATED-JITTER backoff from
    ``backoff_base``, all inside a hard per-operation ``deadline`` that the
    active reconcile-round Budget further caps. 4xx is deterministic and
    never retried; ``_typed_error`` maps the wire error code back to the
    vendor's exception vocabulary."""

    def __init__(
        self,
        base_url: str,
        timeout: float = 5.0,
        max_attempts: int = 4,
        backoff_base: float = 0.05,
        deadline: float = 30.0,
    ):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self.max_attempts = max_attempts
        self.backoff_base = backoff_base
        self.deadline = deadline
        self.retries = 0  # observability: total retried requests

    def _typed_error(
        self, code: str, message: str, status: int, details: Optional[Dict] = None
    ) -> Exception:
        if code == CODE_ICE:
            overrides = [
                (o["capacityType"], o["instanceType"], o["zone"])
                for o in (details or {}).get("overrides", [])
            ]
            return InsufficientCapacityError(message, overrides=overrides)
        if code == CODE_INSTANCE_NOT_FOUND:
            # typed NotFound: the control plane positively answered "no such
            # record" — liveness consumers may treat it as confirmed-gone
            # without waiting out the consecutive-miss threshold. A
            # route-level CODE_NOT_FOUND stays a plain CloudAPIError.
            return InstanceNotFoundError(f"{code}: {message}")
        return CloudAPIError(f"{code or status}: {message}")

    def _request(
        self,
        method: str,
        path: str,
        body: Optional[Dict] = None,
        idempotent: bool = True,
    ) -> Dict:
        from karpenter_tpu_torch import metrics
        from karpenter_tpu_torch.resilience import current_budget, decorrelated_jitter

        url = self.base_url + path
        data = json.dumps(body).encode() if body is not None else None
        budget = current_budget.get()
        allowance = self.deadline
        if budget is not None:
            allowance = min(allowance, max(budget.remaining(), 0.0))
        start = time.monotonic()
        backoffs = decorrelated_jitter(self.backoff_base, cap=2.0)

        def pause(seconds: float) -> bool:
            """Sleep toward the next attempt — unless the deadline would
            pass first (the current error is final) or the wire's retry
            budget is dry (an overloaded far side must not receive
            amplified load — resilience/overload.py)."""
            from karpenter_tpu_torch.resilience import default_retry_budget

            if time.monotonic() - start + seconds > allowance:
                metrics.RESILIENCE_DEADLINE_EXCEEDED.labels(dependency="wire").inc()
                return False
            if not default_retry_budget().try_spend("wire"):
                metrics.RESILIENCE_RETRIES.labels(
                    dependency="wire", outcome="budget_exhausted"
                ).inc()
                return False
            self.retries += 1
            metrics.RESILIENCE_RETRIES.labels(
                dependency="wire", outcome="retried"
            ).inc()
            time.sleep(seconds)
            return True

        from karpenter_tpu_torch import obs

        span = obs.tracer().current()
        for attempt in range(self.max_attempts):
            final = attempt + 1 >= self.max_attempts
            req = urllib.request.Request(url, data=data, method=method)
            req.add_header("Content-Type", "application/json")
            if span is not None:
                # traceparent-style header: the far side opens a child span
                # under the caller's trace (see CloudAPIServer._dispatch)
                req.add_header("traceparent", obs.to_traceparent(span))
            try:
                with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                    out = json.loads(resp.read() or b"{}")
                from karpenter_tpu_torch.resilience import default_retry_budget

                default_retry_budget().record_success("wire")
                return out
            except urllib.error.HTTPError as e:
                payload = {}
                try:
                    payload = json.loads(e.read() or b"{}")
                except Exception:
                    pass
                error = payload.get("error") or {}
                code = error.get("code", "")
                message = error.get("message", str(e))
                if e.code == 429 and not final:
                    # a throttle names its own pause; retried regardless of
                    # idempotency (the server rejected it unprocessed)
                    retry_after = float(e.headers.get("Retry-After") or self.backoff_base)
                    if pause(retry_after):
                        continue
                elif e.code >= 500 and not final and idempotent:
                    if pause(next(backoffs)):
                        continue
                raise self._typed_error(code, message, e.code, error.get("details"))
            except (urllib.error.URLError, ConnectionError, TimeoutError) as e:
                if final or not idempotent or not pause(next(backoffs)):
                    raise self._typed_error("", f"transport: {e}", 0) from e
        raise AssertionError("unreachable: every final attempt raises or returns")


class HttpCloudAPI(_WireTransport):
    """The providers' wire client: the ``SimCloudAPI`` method protocol over
    HTTP. 409 ``InsufficientInstanceCapacity`` and per-override fleet
    errors map back to the typed errors the providers classify; fleet
    launches carry a client token so transport-level retries of the
    non-idempotent POST cannot double-launch."""

    def __init__(self, base_url: str, page_size: Optional[int] = None, **kw):
        super().__init__(base_url, **kw)
        self.page_size = page_size

    # -- the SimCloudAPI protocol -------------------------------------------
    def describe_instance_types(self) -> List[SimInstanceTypeInfo]:
        items: List[Dict] = []
        token: Optional[str] = None
        while True:
            qs = []
            if self.page_size:
                qs.append(f"max-results={self.page_size}")
            if token is not None:
                qs.append(f"next-token={urllib.parse.quote(token)}")
            path = "/v1/instance-types" + ("?" + "&".join(qs) if qs else "")
            body = self._request("GET", path)
            items.extend(body.get("items", []))
            token = body.get("nextToken")
            if token is None:
                return [_from_dict(SimInstanceTypeInfo, d) for d in items]

    def describe_subnets(self, selector: Dict[str, str]) -> List[SimSubnet]:
        body = self._request("GET", "/v1/subnets" + _tag_query(selector))
        return [_from_dict(SimSubnet, d) for d in body.get("items", [])]

    def describe_security_groups(self, selector: Dict[str, str]) -> List[SimSecurityGroup]:
        body = self._request("GET", "/v1/security-groups" + _tag_query(selector))
        return [_from_dict(SimSecurityGroup, d) for d in body.get("items", [])]

    def ensure_launch_template(self, name: str, data: Dict[str, Any]) -> str:
        return self._request(
            "PUT", f"/v1/launch-templates/{urllib.parse.quote(name, safe='')}", data
        )["name"]

    def delete_launch_template(self, name: str) -> None:
        self._request(
            "DELETE", f"/v1/launch-templates/{urllib.parse.quote(name, safe='')}"
        )

    def create_fleet(
        self,
        capacity_type: str,
        overrides: Sequence[Tuple[str, str, str]],
        client_token: str = "",
    ) -> Tuple[List[SimInstance], List[Tuple[str, str, str]]]:
        import uuid

        body = self._request("POST", "/v1/fleet", {
            "capacityType": capacity_type,
            "overrides": [
                {"launchTemplate": lt, "instanceType": it, "zone": z}
                for lt, it, z in overrides
            ],
            # one token per LOGICAL launch: the caller's launch token when
            # it carries one (so PROVIDER-level retries of the whole create
            # also replay), else a per-call token — either way transport
            # retries replay the recorded result instead of launching a
            # second instance, which is what makes this POST idempotent for
            # the transport's 5xx retry policy
            "clientToken": client_token or uuid.uuid4().hex,
        }, idempotent=True)
        instances = [_from_dict(SimInstance, d) for d in body.get("instances", [])]
        errors = [
            (e["capacityType"], e["instanceType"], e["zone"])
            for e in body.get("errors", [])
            if e.get("code") == CODE_ICE
        ]
        return instances, errors

    def describe_instances(self, ids: List[str]) -> List[SimInstance]:
        body = self._request("POST", "/v1/instances/describe", {"ids": list(ids)})
        return [_from_dict(SimInstance, d) for d in body.get("items", [])]

    def list_instances(self) -> List[SimInstance]:
        body = self._request("GET", "/v1/instances")
        return [_from_dict(SimInstance, d) for d in body.get("items", [])]

    def terminate_instances(self, ids: List[str]) -> None:
        self._request("POST", "/v1/instances/terminate", {"ids": list(ids)})

    def poll_disruptions(self) -> List[DisruptionNotice]:
        body = self._request("GET", "/v1/events")
        return [DisruptionNotice.from_wire(d) for d in body.get("items", [])]

    def send_disruption_notice(self, notice: DisruptionNotice) -> None:
        """Re-offer a drained notice to the server's event bus (POST
        /v1/events/requeue) — the fleet-routing hook that lets a non-owner
        replica hand a foreign notice back across processes. Present on the
        wire client means ``SimulatedCloudProvider.requeue_disruption`` now
        answers True over HTTP, not only in-process."""
        self._request("POST", "/v1/events/requeue", notice.to_wire())


def _tag_query(selector: Dict[str, str]) -> str:
    if not selector:
        return ""
    return "?" + "&".join(
        f"tag:{urllib.parse.quote(k, safe='')}={urllib.parse.quote(v, safe='')}"
        for k, v in selector.items()
    )


def _from_dict(cls, d: Dict[str, Any]):
    """JSON dict → dataclass, tolerating tuple-typed fields serialized as
    lists (the wire has no tuples)."""
    import dataclasses

    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        if isinstance(v, list) and "Tuple" in str(f.type):
            v = tuple(v)
        kwargs[f.name] = v
    return cls(**kwargs)


# ---------------------------------------------------------------------------
# GKE node-pool surface over the same wire
# ---------------------------------------------------------------------------

CODE_STOCKOUT = "ZONAL_RESOURCE_POOL_EXHAUSTED"


class GkeAPIServer(_JsonApiServer):
    """Serves one ``SimGkeAPI`` over localhost HTTP:
      POST   /gke/v1/node-pools          {machineType, zone, spot, count,
                                          tpuTopology} → the pool (atomic;
                                          a stockout answers 409)
      DELETE /gke/v1/node-pools/<name>
      DELETE /gke/v1/instances/<name>
      GET    /gke/v1/events              → pending disruption notices (drained)
    """

    def __init__(self, api=None):
        from karpenter_tpu_torch.cloudprovider.gke import SimGkeAPI

        self.api = api or SimGkeAPI()
        super().__init__()

    def _classify_exception(self, e: Exception):
        from karpenter_tpu_torch.cloudprovider.gke import GkeApiError, GkeStockoutError

        if isinstance(e, GkeStockoutError):
            return 409, CODE_STOCKOUT
        if isinstance(e, GkeApiError):
            return 400, CODE_BAD_REQUEST
        return 500, CODE_INTERNAL

    def _route(self, h, method: str) -> None:
        from dataclasses import asdict as _asdict

        path = urllib.parse.urlsplit(h.path).path.rstrip("/")
        if method == "POST" and path == "/gke/v1/node-pools":
            b = h._body()
            pool = self.api.create_node_pool(
                b["machineType"], b["zone"], bool(b.get("spot")),
                int(b.get("count", 1)), b.get("tpuTopology", ""),
                launch_token=b.get("launchToken", ""),
            )
            h._send(200, _asdict(pool))
        elif method == "GET" and path == "/gke/v1/instances":
            # full inventory with launch tokens — the GC/recovery sweep
            h._send(
                200, {"items": [_asdict(i) for i in self.api.list_instances()]}
            )
        elif method == "POST" and path.endswith("/claim") and path.startswith(
            "/gke/v1/instances/"
        ):
            name = urllib.parse.unquote(path.rsplit("/", 2)[1])
            self.api.claim_instance(name, h._body().get("launchToken", ""))
            h._send(200, {})
        elif method == "DELETE" and path.startswith("/gke/v1/node-pools/"):
            self.api.delete_node_pool(urllib.parse.unquote(path.rsplit("/", 1)[1]))
            h._send(200, {})
        elif method == "DELETE" and path.startswith("/gke/v1/instances/"):
            self.api.delete_instance(urllib.parse.unquote(path.rsplit("/", 1)[1]))
            h._send(200, {})
        elif method == "GET" and path == "/gke/v1/events":
            h._send(
                200, {"items": [n.to_wire() for n in self.api.poll_disruptions()]}
            )
        elif method == "POST" and path == "/gke/v1/events/requeue":
            # the re-offer endpoint: foreign notices requeue across
            # processes so the shard owner's next poll sees them
            self.api.send_disruption_notice(DisruptionNotice.from_wire(h._body()))
            h._send(200, {})
        else:
            h._error(404, CODE_NOT_FOUND, f"{method} {path}")


class HttpGkeAPI(_WireTransport):
    """``SimGkeAPI``'s method protocol over HTTP — same transport/retry
    machinery as ``HttpCloudAPI`` (via the shared ``_WireTransport``; the
    EC2-style methods are deliberately NOT exposed here), with the GKE
    error vocabulary mapped back to ``GkeStockoutError`` / ``GkeApiError``."""

    def _typed_error(
        self, code: str, message: str, status: int, details: Optional[Dict] = None
    ) -> Exception:
        from karpenter_tpu_torch.cloudprovider.gke import GkeApiError, GkeStockoutError

        if code == CODE_STOCKOUT or CODE_STOCKOUT in message:
            return GkeStockoutError(message)
        if status == 0 or status == 429 or status >= 500:
            # transport failures and exhausted 5xx/429 retries are TRANSIENT:
            # they must surface as a retryable error or the resilience
            # layer would classify a dead control plane as a healthy
            # deterministic answer and never trip its breaker
            return CloudAPIError(f"{code or status}: {message}")
        return GkeApiError(f"{code or status}: {message}")

    def create_node_pool(self, machine_type: str, zone: str, spot: bool,
                         count: int, tpu_topology: str = "",
                         launch_token: str = ""):
        from karpenter_tpu_torch.cloudprovider.gke import GkeInstance, GkeNodePool

        # idempotent ONLY when tokened: with a launch token the server's
        # pool ledger replays a committed create, so transport retries are
        # safe; a token-less create keeps the conservative no-retry policy
        # (a replayed commit would orphan a possibly multi-host TPU pool)
        d = self._request("POST", "/gke/v1/node-pools", {
            "machineType": machine_type, "zone": zone, "spot": spot,
            "count": count, "tpuTopology": tpu_topology,
            "launchToken": launch_token,
        }, idempotent=bool(launch_token))
        instances = [_from_dict(GkeInstance, i) for i in d.pop("instances", [])]
        pool = _from_dict(GkeNodePool, d)
        pool.instances = instances
        return pool

    def claim_instance(self, name: str, launch_token: str) -> None:
        self._request(
            "POST",
            f"/gke/v1/instances/{urllib.parse.quote(name, safe='')}/claim",
            {"launchToken": launch_token},
        )

    def list_instances(self):
        from karpenter_tpu_torch.cloudprovider.gke import GkeInstance

        body = self._request("GET", "/gke/v1/instances")
        return [_from_dict(GkeInstance, d) for d in body.get("items", [])]

    def delete_node_pool(self, name: str) -> None:
        self._request(
            "DELETE", f"/gke/v1/node-pools/{urllib.parse.quote(name, safe='')}"
        )

    def delete_instance(self, name: str) -> None:
        self._request(
            "DELETE", f"/gke/v1/instances/{urllib.parse.quote(name, safe='')}"
        )

    def poll_disruptions(self) -> List[DisruptionNotice]:
        body = self._request("GET", "/gke/v1/events")
        return [DisruptionNotice.from_wire(d) for d in body.get("items", [])]

    def send_disruption_notice(self, notice: DisruptionNotice) -> None:
        """Re-offer a drained notice (POST /gke/v1/events/requeue) — lets
        ``GkeCloudProvider.requeue_disruption`` answer True over the wire."""
        self._request("POST", "/gke/v1/events/requeue", notice.to_wire())
