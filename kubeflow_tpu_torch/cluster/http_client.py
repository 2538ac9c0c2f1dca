"""HTTP(S) Kubernetes API client: the real-cluster transport.

The port's copy of ``kubeflow_tpu/cluster/http_client.py`` (the port
imports nothing of the JAX package). It implements the client protocol
the controllers consume from ``ClusterStore`` (get/get_or_none/list/
create/update/update_status/patch/delete/watch) over the Kubernetes REST
wire, so the reconcilers run unmodified against an apiserver: the port's
own ``cluster/apiserver.py`` ``ApiServerProxy``, or a real one.

Auth, in client-go's loading order:

- ``HttpApiClient.from_kubeconfig(path)``: kubeconfig contexts, bearer
  token, client certificates (inline ``*-data`` or file paths), the
  cluster CA (needs ``yaml``, imported only there);
- ``HttpApiClient.in_cluster()``: the ServiceAccount mount
  (/var/run/secrets/kubernetes.io/serviceaccount) and
  KUBERNETES_SERVICE_HOST;
- the plain constructor, for tests and token-only setups.

Transport: requests ride per-thread persistent HTTP/1.1 connections (a
keep-alive pool). A reused connection the server closed idle is retried
once on a fresh one, only when the failure happened at send time (the
server never read the request, so the retry is safe for every verb);
response-phase failures are ambiguous and belong to the ``RetryPolicy``
layer. Several endpoints may be given: new connections rotate over them
and a connect failure fails over to the next.

Watches are reconnecting daemon threads reading the newline-delimited
JSON stream (``?watch=true``), or length-prefixed codec frames with
``wire_format="binary"``. The loop tracks the resourceVersion of the
last event it delivered (bookmark frames anchor idle streams) and
reconnects with ``?resourceVersion=N``: the apiserver replays the
retained window after N (no LIST), and answers ``410 Gone`` when the
window was evicted, which drops the cursor and falls back to a LIST+diff
resync: changed or new objects re-deliver as MODIFIED/ADDED and objects
that vanished are synthesized as DELETED. ``watch_resumes_total`` counts
which path each reconnect took.

Every logical request is one ``rest.<verb>`` span when tracing records,
and carries the active span's ``traceparent`` header, so the apiserver's
spans and audit lines join the caller's trace.

In-process admission cannot be registered here
(``supports_inprocess_admission = False``): against an apiserver,
admission runs through webhook configurations that call the manager's
``AdmissionServer`` (``cluster/remote_admission.py``). Plain
``threading`` locks stand in for the reference's tracked locks.
"""

from __future__ import annotations

import base64
import http.client
import itertools
import json
import logging
import os
import random
import socket
import ssl
import struct
import tempfile
import threading
import time
import urllib.error
from dataclasses import dataclass
from urllib.parse import quote, urlencode, urlsplit

from ..utils import k8s, tracing
from . import codec, restmapper
from .errors import (AlreadyExistsError, ApiError, ConflictError,
                     ForbiddenError, GoneError, InvalidError, NotFoundError,
                     ServiceUnavailableError, TooManyRequestsError)
from .store import WatchEvent

log = logging.getLogger("kubeflow_tpu_torch.http_client")

_TRACER = tracing.get_tracer("kubeflow_tpu_torch.http_client")

SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


def _resource_from_path(path: str) -> str:
    """Resource plural out of an API path for span attributes —
    ``/apis/g/v1/namespaces/ns/notebooks/name`` → ``notebooks``;
    best-effort (attribute metadata, never load-bearing)."""
    parts = path.split("?", 1)[0].strip("/").split("/")
    try:
        i = parts.index("namespaces")
        return parts[i + 2] if len(parts) > i + 2 else parts[-1]
    except ValueError:
        return parts[3] if parts[:1] == ["apis"] and len(parts) > 3 \
            else parts[-1]

_ERROR_BY_REASON = {
    "NotFound": NotFoundError,
    "AlreadyExists": AlreadyExistsError,
    "Conflict": ConflictError,
    "Invalid": InvalidError,
    "Forbidden": ForbiddenError,
    "TooManyRequests": TooManyRequestsError,
    "ServiceUnavailable": ServiceUnavailableError,
    "Expired": GoneError,
}
_ERROR_BY_CODE = {404: NotFoundError, 409: ConflictError, 410: GoneError,
                  422: InvalidError, 403: ForbiddenError,
                  429: TooManyRequestsError, 503: ServiceUnavailableError}

#: failures that mean "the bytes didn't arrive", not "the server said no":
#: connection refused/reset (URLError/OSError) and a response that
#: truncated mid-wire (IncompleteRead/BadStatusLine are HTTPExceptions,
#: NOT OSErrors — a reset-mid-body previously escaped every handler here)
TRANSPORT_ERRORS = (urllib.error.URLError, OSError, http.client.HTTPException)


class MalformedListError(http.client.HTTPException):
    """A LIST response parsed as JSON but carries no ``items`` array — a
    truncated/foreign body (LB error page, apiserver killed mid-write)
    that must surface as a retryable transport failure. Reading it as an
    empty list would be catastrophic during a watch resync: the RV-diff
    would synthesize DELETED for every live object."""


class MalformedBinaryError(http.client.HTTPException):
    """A binary-negotiated response body that failed to decode — the
    codec's CodecError lifted into the transport-error taxonomy
    (⊂ TRANSPORT_ERRORS), so a truncated or foreign binary body rides the
    same bounded retry + breaker accounting as a JSONDecodeError on a
    truncated JSON body. Never a silent partial decode."""


@dataclass(frozen=True)
class RetryPolicy:
    """client-go-style bounded retries with decorrelated-jitter backoff.

    What retries:

    - ``429`` — every verb: the server rejected the request before
      processing (priority-and-fairness), so retry is always safe;
      ``Retry-After`` overrides the computed backoff when sent.
    - ``503`` — idempotent verbs only (GET/LIST/DELETE).
    - transport errors (refused/reset/truncated) — idempotent verbs, plus
      *named* creates: a reset POST may or may not have applied, and the
      retry disambiguates via 409 AlreadyExists + a live read. generateName
      creates never retry on transport errors (a blind retry could
      materialize two objects).
    - PUT/PATCH — 429 only: resourceVersion preconditions + the
      reconcilers' conflict-retry loops own that ambiguity.
    """

    max_attempts: int = 4
    backoff_base_s: float = 0.05
    backoff_cap_s: float = 2.0

# Watch streams ask the server to close gracefully after this long
# (?timeoutSeconds=, honored by real apiservers); the socket read timeout
# sits just above it so a dead stream is still detected. Our facade sends
# 10s bookmarks, a real apiserver sends nothing on an idle watch — either
# way a reconnect costs one list that delivers nothing when RVs are
# unchanged, so the cadence is cheap.
WATCH_SERVER_TIMEOUT_S = 290
WATCH_READ_TIMEOUT_S = WATCH_SERVER_TIMEOUT_S + 10.0
WATCH_RECONNECT_DELAY_S = 1.0
# consecutive watch reconnect failures back off exponentially from
# WATCH_RECONNECT_DELAY_S up to this cap (an unreachable apiserver must
# not be hammered at 1 Hz per watched kind); a stream that lived this
# long before dropping resets the backoff
WATCH_BACKOFF_MAX_S = 30.0
WATCH_BACKOFF_RESET_AFTER_S = 5.0


def _read_exact(resp, n: int) -> bytes:
    """Read exactly ``n`` bytes from a streaming response, short only at
    EOF (http.client's read(n) may return fewer on a chunk boundary)."""
    out = b""
    while len(out) < n:  # bounded: returns short the moment read() EOFs
        part = resp.read(n - len(out))
        if not part:
            return out
        out += part
    return out


def _require_items(parsed: dict) -> None:
    """LIST-body validator for _json: no ``items`` array → transport
    failure (see MalformedListError)."""
    if not isinstance(parsed, dict) or \
            not isinstance(parsed.get("items"), list):
        raise MalformedListError("LIST body has no items array")


def _serialize_selector(selector: dict) -> str:
    """k8s labelSelector grammar subset: ``key=value`` equality terms plus
    bare ``key`` existence terms (value ``None``)."""
    return ",".join(key if val is None else f"{key}={val}"
                    for key, val in selector.items())


def _error_from_response(code: int, body: bytes,
                         headers=None) -> ApiError:
    reason, message = "", ""
    try:
        status = json.loads(body)
        reason = status.get("reason", "")
        message = status.get("message", "")
    except (ValueError, AttributeError):
        message = body.decode(errors="replace")[:200]
    cls = _ERROR_BY_REASON.get(reason) or _ERROR_BY_CODE.get(code) or ApiError
    err = cls(message or f"HTTP {code}")
    err.code = code  # preserve the wire status (e.g. 401) on generic errors
    if headers is not None:
        err.retry_after = _parse_retry_after(headers.get("Retry-After"))
    return err


def _parse_retry_after(raw: str | None) -> float | None:
    """Delay-seconds form only (integer per RFC 7231; our facade also sends
    sub-second floats). The HTTP-date form is ignored — client-go does the
    same for apiserver flow-control."""
    if not raw:
        return None
    try:
        return max(float(raw), 0.0)
    except ValueError:
        return None


def _data_or_file(data_b64: str | None, path: str | None) -> str | None:
    """Resolve kubeconfig's inline-base64-or-file-path pattern to a path."""
    if data_b64:
        tmp = tempfile.NamedTemporaryFile("wb", delete=False,
                                          prefix="kubeflow-tpu-kc-")
        tmp.write(base64.b64decode(data_b64))
        tmp.close()
        return tmp.name
    return path


class HttpApiClient:
    """Client protocol implementation over HTTP(S)."""

    supports_inprocess_admission = False

    def __init__(self, base_url, token: str | None = None,
                 ca_cert: str | None = None, client_cert: str | None = None,
                 client_key: str | None = None, verify: bool = True,
                 timeout: float = 30.0, metrics=None,
                 retry_policy: RetryPolicy | None = None,
                 list_page_size: int | None = None,
                 user_agent: str = "kubeflow-tpu-manager",
                 rng: random.Random | None = None,
                 wire_format: str = "json") -> None:
        # ``base_url`` accepts one URL, a comma-separated list, or a
        # list/tuple — the replicated-frontend form: every request can be
        # served by any frontend (one shared store behind them), so NEW
        # connections rotate endpoints and a connect failure transparently
        # fails over to the next one (mid-soak frontend kill: in-flight
        # requests on the dead frontend surface through the normal retry
        # machinery; every reconnect lands on a live one)
        if isinstance(base_url, (list, tuple)):
            urls = [u.rstrip("/") for u in base_url if u]
        else:
            urls = [u.strip().rstrip("/")
                    for u in base_url.split(",") if u.strip()]
        if not urls:
            raise ValueError("base_url names no endpoints")
        self.base_url = urls[0]
        self.endpoints = tuple(urls)
        # wire negotiation: "binary" sends/accepts the compact codec media
        # type (error Status bodies stay JSON — decode is driven by the
        # RESPONSE Content-Type, so a mixed fleet or a binary-unaware
        # server degrades to JSON transparently); "json" is the default
        # and the debugging path
        if wire_format not in ("json", "binary"):
            raise ValueError(f"unknown wire_format {wire_format!r}")
        self.wire_format = wire_format
        self._binary = wire_format == "binary"
        self._accept = (codec.BINARY_CONTENT_TYPE + ", application/json"
                        if self._binary else "application/json")
        self.token = token
        self.timeout = timeout
        self.retry_policy = retry_policy or RetryPolicy()
        # flow identity for the apiserver's priority & fairness layer
        # (cluster/apf.py classifies on the User-Agent header): manager
        # replicas keep the kubeflow-tpu prefix; tenant tooling should
        # set its own so a LIST storm lands in its own flow's queues
        self.user_agent = user_agent
        # LIST chunking (?limit=N&continue=…): bounds the memory and tail
        # latency of a fleet-sized LIST — the backfills and post-outage
        # resyncs page through instead of one giant body. None = unpaged.
        self.list_page_size = list_page_size
        # decorrelated jitter source; injectable so fault-injection tests
        # can seed the backoff schedule deterministically
        self._retry_rng = rng or random.Random()
        self._requests_metric = None
        self._retries_metric = None
        self._duration_metric = None
        self._connections_metric = None  # rest_client_connections_opened_total
        self._resumes_metric = None      # watch_resumes_total
        # keep-alive pool: one persistent connection per (thread, client) —
        # http.client connections are not thread-safe, and a thread's
        # requests are serial, so thread affinity IS the pool discipline
        self._addrs = []
        for url in self.endpoints:
            split = urlsplit(url)
            self._addrs.append(
                (split.scheme, split.hostname or "127.0.0.1",
                 split.port or (443 if split.scheme == "https" else 80),
                 split.path.rstrip("/")))
        self._addr = self._addrs[0]
        # round-robin cursor for new connections (itertools.count is
        # GIL-atomic; modulo at the use site)
        self._endpoint_counter = itertools.count()
        self._tl = threading.local()
        self._conns_lock = threading.Lock()
        # every pooled conn, so close() can reap
        self._conns: set = set()
        # optional apiserver health tracker (the manager's circuit
        # breaker): told about every transport-level success/failure —
        # an HTTP error response counts as SUCCESS (the server answered)
        self._health_tracker = None
        if metrics is not None:
            self.attach_metrics(metrics)
        self._ssl: ssl.SSLContext | None = None
        if self.base_url.startswith("https"):
            ctx = ssl.create_default_context(cafile=ca_cert)
            if not verify:
                ctx.check_hostname = False
                ctx.verify_mode = ssl.CERT_NONE
            if client_cert:
                ctx.load_cert_chain(client_cert, client_key)
            self._ssl = ctx
        self._stopped = threading.Event()
        # optional watch stream-health listener pair (on_gap, on_recover):
        # the read cache's degraded-mode hooks (CachingClient.mark_watch_gap)
        # — while any stream for a kind is down, cached reads of it go live
        self._watch_gap_listeners: tuple | None = None
        self._watch_threads: list[threading.Thread] = []
        # live watch responses, so close() can unblock readline() NOW
        # instead of waiting out the server's bookmark interval
        self._live_streams: set = set()
        self._streams_lock = threading.Lock()

    # ------------------------------------------------------------ factories
    @classmethod
    def from_kubeconfig(cls, path: str | None = None,
                        context: str | None = None) -> "HttpApiClient":
        import yaml
        path = path or os.environ.get("KUBECONFIG") or \
            os.path.expanduser("~/.kube/config")
        with open(path) as fh:
            cfg = yaml.safe_load(fh)
        ctx_name = context or cfg.get("current-context")
        ctx = next(c["context"] for c in cfg.get("contexts", [])
                   if c["name"] == ctx_name)
        cluster = next(c["cluster"] for c in cfg.get("clusters", [])
                       if c["name"] == ctx["cluster"])
        user = next((u["user"] for u in cfg.get("users", [])
                     if u["name"] == ctx.get("user")), {})
        return cls(
            cluster["server"],
            token=user.get("token"),
            ca_cert=_data_or_file(cluster.get("certificate-authority-data"),
                                  cluster.get("certificate-authority")),
            client_cert=_data_or_file(user.get("client-certificate-data"),
                                      user.get("client-certificate")),
            client_key=_data_or_file(user.get("client-key-data"),
                                     user.get("client-key")),
            verify=not cluster.get("insecure-skip-tls-verify", False),
        )

    @classmethod
    def in_cluster(cls) -> "HttpApiClient":
        host = os.environ["KUBERNETES_SERVICE_HOST"]
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        with open(f"{SA_DIR}/token") as fh:
            token = fh.read().strip()
        ca = f"{SA_DIR}/ca.crt"
        return cls(f"https://{host}:{port}", token=token,
                   ca_cert=ca if os.path.exists(ca) else None)

    # ------------------------------------------------------------ transport
    def _new_conn(self, timeout: float, stream: bool = False):
        """Open a connection to the next endpoint in rotation, failing
        over across the remaining endpoints on a connect failure (a
        killed frontend disappears from new connections immediately; only
        when EVERY endpoint refuses does the failure surface)."""
        last_err: OSError | None = None
        for _ in range(len(self._addrs)):
            pick = next(self._endpoint_counter) % len(self._addrs)
            scheme, host, port, prefix = self._addrs[pick]
            if scheme == "https":
                conn = http.client.HTTPSConnection(host, port,
                                                   timeout=timeout,
                                                   context=self._ssl)
            else:
                conn = http.client.HTTPConnection(host, port,
                                                  timeout=timeout)
            try:
                conn.connect()
            except OSError as err:
                last_err = err
                continue
            # a persistent connection carries many small request/response
            # pairs: Nagle + delayed ACK turns each into a ~40 ms stall
            # (http.client writes headers and body in separate send()s)
            conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn._kt_prefix = prefix  # per-endpoint path prefix
            if self._connections_metric is not None:
                # pooled vs stream: one watch stream = one connection by
                # design (reconnect chaos churns them legitimately), so the
                # keep-alive reuse bound is computed over pooled conns only
                self._connections_metric.inc(
                    {"type": "stream" if stream else "pooled"})
            return conn
        raise last_err if last_err is not None else OSError("no endpoints")

    def _checkout(self, timeout: float, pooled: bool):
        """This thread's persistent connection (or a dedicated one for
        streams). Returns ``(conn, reused)`` — ``reused`` gates the
        stale-keep-alive retry in _request."""
        if not pooled:
            return self._new_conn(timeout, stream=True), False
        slot = self._tl
        conn = getattr(slot, "conn", None)
        if conn is not None:
            resp = getattr(slot, "resp", None)
            if resp is not None and not getattr(resp, "_kt_drained", False):
                # the previous response never finished (truncated body,
                # abandoned or PARTIAL read): the conn is mid-message —
                # recycle it. isclosed() alone cannot tell: a response
                # closed before EOF (read() raised mid-body, with-block
                # closed it) reports closed while unread bytes still sit
                # on the socket, and the next request would parse them as
                # its status line. Only a read that actually reached EOF
                # (_mark_drained) proves the conn is clean.
                self._discard(conn, pooled=True)
                conn = None
        reused = conn is not None
        if conn is None:
            conn = self._new_conn(timeout)
            slot.conn = conn
            with self._conns_lock:
                self._conns.add(conn)
        slot.resp = None
        if conn.sock is not None:
            conn.sock.settimeout(timeout)
        else:
            conn.timeout = timeout  # applies at connect
        return conn, reused

    @staticmethod
    def _mark_drained(resp) -> None:
        """Record that ``resp`` was read to EOF — the proof _checkout
        needs that the pooled connection carries no leftover body bytes
        and is safe to reuse."""
        resp._kt_drained = True

    def _discard(self, conn, pooled: bool) -> None:
        if pooled:
            slot = self._tl
            if getattr(slot, "conn", None) is conn:
                slot.conn = None
                slot.resp = None
            with self._conns_lock:
                self._conns.discard(conn)
        try:
            conn.close()
        except OSError:
            pass

    def _request(self, method: str, path: str, body: dict | None = None,
                 content_type: str = "application/json",
                 timeout: float | None = None, pooled: bool = True):
        """One wire request over the keep-alive pool. ``pooled=False``
        (watch streams) opens a dedicated connection, attached to the
        response as ``_kt_conn`` so the stream can close it; everything
        else reuses this thread's persistent connection — the response
        must be fully read before the thread's next request (every caller
        does), or the next checkout recycles the connection."""
        data = None
        if body is not None:
            if self._binary:
                data = codec.encode(body)
                content_type = (codec.BINARY_PATCH_CONTENT_TYPE
                                if "merge-patch" in content_type
                                else codec.BINARY_CONTENT_TYPE)
            else:
                data = json.dumps(body).encode()
        headers = {"Accept": self._accept,
                   "User-Agent": self.user_agent}
        if data is not None:
            headers["Content-Type"] = content_type
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        # W3C trace-context propagation: every request carries the active
        # span's identity so the server's spans (APF wait, handler) and the
        # audit trail join the client's trace; None when tracing is off
        ctx = tracing.current_context()
        if ctx is not None:
            headers["traceparent"] = tracing.format_traceparent(ctx)
        timeout = timeout or self.timeout
        for attempt in (0, 1):
            conn, reused = None, False
            try:
                conn, reused = self._checkout(timeout, pooled)
                # path prefix is per-endpoint (a pooled conn remembers
                # which frontend it reached)
                conn.request(method,
                             getattr(conn, "_kt_prefix", self._addr[3])
                             + path,
                             body=data, headers=headers)
            except (http.client.HTTPException, OSError) as err:
                # SEND-phase failure (connect included): the server never
                # read this request. On a REUSED keep-alive connection the
                # overwhelming cause is the server having closed it idle —
                # retry ONCE on a fresh connection, transparently and for
                # EVERY verb (no bytes were processed, so no ambiguity). A
                # fresh connection failing is a real outage: surface it.
                if conn is not None:
                    self._discard(conn, pooled)
                if reused and attempt == 0:
                    continue
                self._count_request(method, "<error>")
                self._health_fail()
                err._kt_health_recorded = True  # _json must not double-count
                raise
            try:
                resp = conn.getresponse()
            except (http.client.HTTPException, OSError) as err:
                # RESPONSE-phase failure: the request MAY have been
                # processed (the ambiguous shape) — owned by the
                # RetryPolicy layer, with ONE exception: a REUSED
                # connection closing with zero response bytes
                # (RemoteDisconnected) on a GET is the idle-close race
                # losing to our send — a GET retry is always safe, so
                # recover transparently (the Go transport's rule).
                # Mutations surface even then: without the policy layer's
                # ambiguous_retry marker, a silently retried create could
                # turn its own first write into a hard AlreadyExists.
                self._discard(conn, pooled)
                if reused and attempt == 0 and method == "GET" and \
                        isinstance(err, http.client.RemoteDisconnected):
                    continue
                self._count_request(method, "<error>")
                self._health_fail()
                err._kt_health_recorded = True
                raise
            break
        if pooled:
            self._tl.resp = resp  # reuse gate for the next checkout
        else:
            resp._kt_conn = conn  # the stream's teardown closes it
        if ctx is not None:
            # the innermost span here is _json's wire span (a noop sink on
            # untraced paths like watch streams)
            tracing.current_span().set_attribute("http.status", resp.status)
        if resp.status >= 400:
            payload = resp.read()  # frees the conn for reuse
            self._mark_drained(resp)
            if not pooled:
                # a dedicated stream connection whose request errored
                # (e.g. watch resume → 410 Gone) never reaches the
                # stream's teardown — close it here, not at GC time
                self._discard(conn, pooled=False)
            self._count_request(method, resp.status)
            self._health_ok()  # an error RESPONSE still means "reachable"
            raise _error_from_response(resp.status, payload,
                                       resp.headers) from None
        self._count_request(method, resp.status)
        self._health_ok()
        return resp

    def _count_request(self, method: str, code) -> None:
        if self._requests_metric is not None:
            self._requests_metric.inc({"method": method, "code": str(code)})

    def _count_retry(self, method: str, reason: str) -> None:
        if self._retries_metric is not None:
            self._retries_metric.inc({"verb": method, "reason": reason})

    def _observe_duration(self, method: str, started: float) -> None:
        if self._duration_metric is not None:
            self._duration_metric.observe(time.monotonic() - started,
                                          {"verb": method},
                                          exemplar=tracing.current_exemplar())

    def _health_ok(self) -> None:
        tracker = self._health_tracker
        if tracker is not None:
            tracker.record_success()

    def _health_fail(self) -> None:
        tracker = self._health_tracker
        if tracker is not None:
            tracker.record_failure()

    def set_watch_gap_listener(self, on_gap, on_recover) -> None:
        """Attach per-kind stream-health callbacks: ``on_gap(kind)`` fires
        when a watch stream for the kind drops (events may be missed until
        reconnect), ``on_recover(kind)`` once the reconnected stream's
        RV-diff resync has been delivered (the consumer's cache is
        converged again). The read cache serves the gap window live."""
        self._watch_gap_listeners = (on_gap, on_recover)

    def _notify_watch_gap(self, kind: str, gapped: bool) -> None:
        listeners = self._watch_gap_listeners
        if listeners is None:
            return
        try:
            (listeners[0] if gapped else listeners[1])(kind)
        except Exception:  # noqa: BLE001 — consumer bug must not kill a watch
            log.exception("watch gap listener failed for %s", kind)

    def set_health_tracker(self, tracker) -> None:
        """Attach an apiserver health tracker (record_success/
        record_failure) — the manager's circuit breaker. Watch reconnects
        report through the same seam, so a full outage trips the breaker
        even while the worker pool is idle."""
        self._health_tracker = tracker

    def ping(self, timeout: float = 2.0) -> bool:
        """Transport-liveness probe (GET /readyz): True when the apiserver
        answered at all — ANY http status counts, only a connection-level
        failure is down. The breaker's half-open probe; never retried."""
        try:
            with self._request("GET", "/readyz", timeout=timeout) as resp:
                resp.read()  # a reset manifests at body-read, not connect
                self._mark_drained(resp)
            return True
        except ApiError:
            return True
        except TRANSPORT_ERRORS:
            return False

    def attach_metrics(self, registry) -> None:
        """Bind a metrics registry — the rest_client_* family (client-go
        exposes these through the controller-runtime registry; the
        managers ship them on the same endpoint as the notebook
        series). ``main.build_manager`` calls this late, since the client
        is constructed before the registry exists."""
        self._requests_metric = registry.counter(
            "rest_client_requests_total",
            "Number of apiserver HTTP requests, by verb and status code.")
        self._retries_metric = registry.counter(
            "rest_client_retries_total",
            "Number of request retries, by verb and reason "
            "(an HTTP status or 'transport').")
        self._duration_metric = registry.histogram(
            "rest_client_request_duration_seconds",
            "Apiserver request latency per attempt, by verb.")
        self._connections_metric = registry.counter(
            "rest_client_connections_opened_total",
            "TCP connections opened to the apiserver. With the keep-alive "
            "pool this grows with threads and outages, not with requests — "
            "the reuse ratio the loadtest smoke bounds.")
        self._resumes_metric = registry.counter(
            "watch_resumes_total",
            "Watch stream reconnects by kind and mode: resume = replayed "
            "from the server watch cache by resourceVersion (no LIST), "
            "relist = full LIST+diff resync fallback (410 Gone or no "
            "resume cursor).")

    def _count_resume(self, kind: str, mode: str) -> None:
        if self._resumes_metric is not None:
            self._resumes_metric.inc({"kind": kind, "mode": mode})

    def _api_retry_wait(self, err: ApiError, method: str,
                        fallback_delay: float) -> float | None:
        """Seconds to wait before retrying an HTTP error, or None when the
        error is not retryable for this verb (see RetryPolicy)."""
        if err.code == 429:
            return err.retry_after if err.retry_after is not None \
                else fallback_delay
        if err.code == 503 and method in ("GET", "DELETE"):
            return err.retry_after if err.retry_after is not None \
                else fallback_delay
        return None

    def _json(self, method: str, path: str, body: dict | None = None,
              content_type: str = "application/json",
              retry_transport: bool | None = None,
              validate=None) -> dict:
        """One logical request with the RetryPolicy applied — see
        ``_json_impl``. When tracing records, each logical request gets one
        wire span (verb/resource/code/retries, retry attempts as events);
        the untraced path calls ``_json_impl`` directly, bypassing span
        setup entirely."""
        if not tracing.is_recording():
            return self._json_impl(method, path, body, content_type,
                                   retry_transport, validate)
        with _TRACER.start_span(
                f"rest.{method.lower()}",
                {"http.method": method, "http.path": path.split("?", 1)[0],
                 "k8s.resource": _resource_from_path(path)}) as span:
            try:
                out = self._json_impl(method, path, body, content_type,
                                      retry_transport, validate)
                span.set_status(tracing.STATUS_OK)
                return out
            except ApiError as err:
                span.set_attribute("http.status", err.code)
                raise

    def _json_impl(self, method: str, path: str, body: dict | None = None,
                   content_type: str = "application/json",
                   retry_transport: bool | None = None,
                   validate=None) -> dict:
        """One logical request with the RetryPolicy applied. Transport
        retries default to the idempotent verbs; create() opts named POSTs
        in explicitly. Errors surfacing on a retry after an ambiguous
        (transport) failure carry ``ambiguous_retry`` so callers can
        disambiguate (AlreadyExists on create, NotFound on delete).
        ``validate(parsed)`` may raise a TRANSPORT_ERRORS member to flag a
        200 body that is semantically truncated (a LIST without ``items``)
        — it rides the same retry/health path as a reset mid-body."""
        policy = self.retry_policy
        if retry_transport is None:
            retry_transport = method in ("GET", "DELETE")
        ambiguous = False
        delay = policy.backoff_base_s
        attempt = 0
        while True:  # bounded: raises once attempt reaches policy.max_attempts
            attempt += 1
            started = time.monotonic()
            try:
                with self._request(method, path, body, content_type) as resp:
                    resp_ctype = resp.headers.get("Content-Type", "")
                    data = resp.read()
                    self._mark_drained(resp)
                self._observe_duration(method, started)
                # decode by the RESPONSE Content-Type, not the negotiated
                # preference: error Status bodies are always JSON, and a
                # binary-unaware server answering JSON degrades cleanly
                if codec.accepts_binary(resp_ctype):
                    try:
                        parsed = codec.decode(data)
                    except codec.CodecError as exc:
                        # truncated/garbled binary body → retryable
                        # transport failure, same as a
                        # JSONDecodeError on a truncated JSON body
                        raise MalformedBinaryError(str(exc)) from None
                else:
                    parsed = json.loads(data)
                if validate is not None:
                    validate(parsed)
                return parsed
            except ApiError as err:
                self._observe_duration(method, started)
                err.ambiguous_retry = ambiguous
                wait = None
                if attempt < policy.max_attempts:
                    wait = self._api_retry_wait(err, method, delay)
                if wait is None:
                    raise
                if err.code == 503 and method != "GET":
                    # a 503 gives no guarantee processing never started
                    # (an LB can emit it after the apiserver applied the
                    # write) — a DELETE retried through one must treat a
                    # subsequent 404 as its own earlier success
                    ambiguous = True
                reason = str(err.code)
                pending = err
            except (*TRANSPORT_ERRORS, json.JSONDecodeError) as err:
                # JSONDecodeError covers a reset that truncated mid-HEADERS:
                # the client parses what arrived, finds no Content-Length,
                # reads to EOF and hands back an empty/partial body — same
                # wire failure as IncompleteRead, different surface
                self._observe_duration(method, started)
                if not getattr(err, "_kt_health_recorded", False):
                    # a body that truncated AFTER a successful connect
                    # (IncompleteRead/JSONDecodeError) was not seen by
                    # _request
                    self._health_fail()
                if method != "GET":
                    # the request may have been applied server-side
                    ambiguous = True
                if not retry_transport or attempt >= policy.max_attempts:
                    raise
                wait = delay
                reason = "transport"
                pending = err
            # decorrelated jitter (AWS's published backoff shape): each
            # delay is uniform(base, prev*3) capped — spreads a thundering
            # herd of retriers without a coordinated clock
            delay = min(policy.backoff_cap_s,
                        self._retry_rng.uniform(policy.backoff_base_s,
                                                delay * 3))
            self._count_retry(method, reason)
            span = tracing.current_span()  # noop sink when untraced
            span.add_event("retry", {"attempt": attempt, "reason": reason})
            span.set_attribute("retries", attempt)
            # the cap applies to COMPUTED backoff only — a server-sent
            # Retry-After is pacing we must honor (bounded for sanity)
            if self._stopped.wait(min(wait, 30.0)):
                raise pending  # close() aborts in-flight retry waits

    @staticmethod
    def _path(kind: str, namespace: str | None = None,
              name: str | None = None, subresource: str | None = None,
              query: dict | None = None) -> str:
        mapping = restmapper.mapping_for(kind)
        path = mapping.path(namespace, quote(name) if name else None,
                            subresource)
        if query:
            path += "?" + urlencode(query)
        return path

    # ---------------------------------------------------------------- verbs
    def get(self, kind: str, namespace: str, name: str,
            resource_version: str | None = None) -> dict:
        """``resource_version="0"`` (or a minimum rv) is the rv-gated form
        the apiserver serves lock-free from its watch cache — 'any state
        at least this fresh is acceptable'; omit for a quorum read."""
        query = {"resourceVersion": resource_version} \
            if resource_version is not None else None
        return self._json("GET", self._path(kind, namespace, name,
                                            query=query))

    def get_or_none(self, kind: str, namespace: str, name: str) -> dict | None:
        try:
            return self.get(kind, namespace, name)
        except NotFoundError:
            return None

    def list(self, kind: str, namespace: str | None = None,
             label_selector: dict[str, str] | None = None) -> list[dict]:
        return self._list(kind, namespace, label_selector)[0]

    def list_cached(self, kind: str, namespace: str | None = None,
                    label_selector: dict[str, str] | None = None,
                    min_resource_version: int | None = None) -> list[dict]:
        """Consistent read from the apiserver's watch cache:
        ``resourceVersion=0`` (or ≥ ``min_resource_version``) LISTs are
        served lock-free from the server-side cache — the form resyncs,
        backfills, and scrapes ride so N managers can re-list
        concurrently without stampeding the store's write-path lock. The
        facade's cache is fed synchronously under the store lock, so
        'cached' here is never stale relative to the store."""
        rv = "0" if min_resource_version is None \
            else str(min_resource_version)
        return self._list(kind, namespace, label_selector,
                          resource_version=rv)[0]

    def _list(self, kind: str, namespace: str | None,
              label_selector: dict[str, str] | None,
              resource_version: str | None = None,
              ) -> tuple[list[dict], int | None]:
        """One logical LIST, paged through ``limit``/``continue`` when
        ``list_page_size`` is set (bounds resync memory + tail latency on
        big fleets). ``resource_version="0"`` is the informer cache-ack
        form the resync path sends. Returns ``(items, list_rv)`` —
        ``list_rv`` is the list metadata's resourceVersion from the FIRST
        page, the reflector's watch-from anchor, or None when the server
        sent none. First page, not last: each page serves live state, so
        a later page's rv covers events (e.g. a deletion of a page-1
        object) whose frames this LIST does not reflect — resuming from
        it would skip them forever. Resuming from the first page's rv
        re-delivers anything that changed between pages instead:
        duplicates are level-safe, skips are not."""
        base_query: dict[str, str] = {}
        if label_selector:
            base_query["labelSelector"] = _serialize_selector(label_selector)
        if resource_version is not None:
            base_query["resourceVersion"] = resource_version
        items: list[dict] = []
        cont: str | None = None
        list_rv: int | None = None
        first_page = True
        while True:  # bounded: returns when continue token absent
            query = dict(base_query)
            if self.list_page_size:
                query["limit"] = str(self.list_page_size)
            if cont:
                query["continue"] = cont
            path = self._path(kind, namespace, query=query or None)
            # a 200 body without an ``items`` array is a WIRE failure
            # (half-written/foreign body — an LB error page), never an
            # empty fleet: _require_items raises MalformedListError
            # (⊂ TRANSPORT_ERRORS) inside _json, so it gets the standard
            # bounded-jitter retry AND counts toward the breaker's
            # consecutive-failure threshold like any truncated response
            body = self._json("GET", path, validate=_require_items)
            items.extend(body["items"])
            meta = body.get("metadata") or {}
            if first_page:
                first_page = False
                try:
                    list_rv = int(meta.get("resourceVersion"))
                except (TypeError, ValueError):
                    list_rv = None
            cont = meta.get("continue")
            if not cont:
                return items, list_rv

    def create(self, obj: dict) -> dict:
        kind = k8s.kind(obj)
        obj.setdefault("apiVersion", restmapper.mapping_for(kind).api_version)
        name = k8s.name(obj)
        try:
            # transport retry only for NAMED creates — a generateName
            # retry could materialize two objects with no way to tell
            return self._json("POST", self._path(kind, k8s.namespace(obj)),
                              obj, retry_transport=bool(name))
        except AlreadyExistsError as err:
            if not err.ambiguous_retry or not name:
                raise
            # an earlier attempt died mid-response (connection reset): the
            # write probably landed and this 409 is our own object. Check
            # against the live resourceVersion: if the object exists,
            # return it as the created state. A racing foreign create is
            # indistinguishable — level-based reconcilers converge on the
            # next loop either way (they re-read and adopt/patch).
            existing = self.get_or_none(kind, k8s.namespace(obj), name)
            if existing is not None:
                log.debug("create %s %s/%s: 409 after ambiguous retry; "
                          "adopting live object rv=%s", kind,
                          k8s.namespace(obj), name,
                          k8s.get_in(existing, "metadata",
                                     "resourceVersion", default="?"))
                return existing
            raise

    def update(self, obj: dict) -> dict:
        kind = k8s.kind(obj)
        obj.setdefault("apiVersion", restmapper.mapping_for(kind).api_version)
        return self._json("PUT", self._path(kind, k8s.namespace(obj),
                                            k8s.name(obj)), obj)

    def update_status(self, obj: dict) -> dict:
        kind = k8s.kind(obj)
        obj.setdefault("apiVersion", restmapper.mapping_for(kind).api_version)
        return self._json("PUT", self._path(kind, k8s.namespace(obj),
                                            k8s.name(obj), "status"), obj)

    def patch(self, kind: str, namespace: str, name: str, patch: dict) -> dict:
        return self._json("PATCH", self._path(kind, namespace, name), patch,
                          content_type="application/merge-patch+json")

    def delete(self, kind: str, namespace: str, name: str) -> None:
        try:
            self._json("DELETE", self._path(kind, namespace, name))
        except NotFoundError as err:
            if err.ambiguous_retry:
                return  # an earlier ambiguous attempt already deleted it
            raise

    def register_admission(self, kind: str, fn) -> None:
        raise RuntimeError(
            "in-process admission is not available over the HTTP client; "
            "serve the webhooks via AdmissionServer and register them with "
            "Mutating/ValidatingWebhookConfiguration objects on the "
            "apiserver (cluster/remote_admission.py)")

    # ---------------------------------------------------------------- watch
    def watch(self, kind: str, callback, namespace: str | None = None,
              label_selector: dict[str, str] | None = None) -> None:
        """Blocks until the first stream is connected (up to 5 s) so that,
        as with ClusterStore.watch, no event after watch() returns can be
        missed — CachingClient's watch-then-list backfill depends on this
        ordering to never go stale — AND until the initial LIST+diff resync
        has delivered (informer cache-sync semantics): an object created
        after watch() returns is delivered exactly once, by the live
        stream, never a second time by a still-in-flight initial list.
        If the stream can't connect in time (transient network failure),
        the eventual first connect resyncs creations/updates from that gap
        as ADDED; one narrow hole remains — an object both
        created-and-deleted (or listed by the consumer and deleted)
        entirely within the pre-connect gap leaves no trace for the diff,
        so a consumer that listed during the gap can hold it until its
        next list. Level-based reconcilers tolerate this; it closes the
        moment the object changes again."""
        connected = threading.Event()
        synced = threading.Event()
        thread = threading.Thread(
            target=self._watch_loop,
            args=(kind, callback, namespace, label_selector, connected,
                  synced),
            daemon=True, name=f"kubeflow-tpu-watch-{kind}")
        self._watch_threads.append(thread)
        thread.start()
        deadline = time.monotonic() + 5.0
        if not connected.wait(timeout=5.0):
            log.warning("watch %s not connected after 5s; resync will run "
                        "on first connect", kind)
        elif not synced.wait(timeout=max(deadline - time.monotonic(), 0.1)):
            log.warning("watch %s connected but initial resync still in "
                        "flight after 5s; racing events may deliver twice",
                        kind)

    @staticmethod
    def _obj_key(obj: dict) -> tuple[str, str]:
        return (k8s.namespace(obj), k8s.name(obj))

    @staticmethod
    def _obj_rv(obj: dict) -> str:
        return str(k8s.get_in(obj, "metadata", "resourceVersion", default=""))

    def _watch_loop(self, kind: str, callback, namespace, label_selector,
                    connected: threading.Event,
                    synced: threading.Event | None = None):
        # (namespace, name) → SLIM record of the last object DELIVERED to
        # the callback (rv + the routing fields, see _slim — pinning every
        # full object forever costs O(fleet × object size) per watch
        # thread): the resync diff compares resourceVersions against it,
        # and an outage-time deletion is synthesized as DELETED carrying
        # this skeleton, so owner-mapped and label-filtered watches still
        # route it
        seen: dict[tuple[str, str], dict] = {}
        # shared reconnect state: ``rv`` is the resume cursor (largest
        # resourceVersion DELIVERED on any stream, bookmark-anchored when
        # idle) — None means the next connect must run the LIST+diff
        # resync; ``connected_once`` separates first-connect informer
        # replay from counted relist fallbacks
        state: dict = {"rv": None, "connected_once": False}
        failures = 0
        in_gap = False

        def on_resynced() -> None:
            # stream live again AND converged (RV replay or LIST+diff
            # delivered): end any degraded window, and release a watch()
            # caller still blocked on initial cache sync
            nonlocal in_gap
            if synced is not None:
                synced.set()
            if in_gap:
                in_gap = False
                self._notify_watch_gap(kind, False)

        while not self._stopped.is_set():
            stream_started = time.monotonic()
            failed = True
            try:
                self._watch_stream(kind, callback, namespace, label_selector,
                                   connected, seen, on_resynced, state)
                failed = False  # server closed the stream cleanly
            except GoneError:
                if self._stopped.is_set():
                    return
                # the resume window was evicted server-side (or the rv
                # belongs to another store incarnation): events WERE
                # missed — drop the cursor so the next connect relists,
                # and reconnect promptly (the 410 is an answer, not an
                # outage)
                log.debug("watch %s resume expired (410 Gone); falling "
                          "back to LIST+diff resync", kind)
                state["rv"] = None
                failed = False
            except json.JSONDecodeError as err:
                if self._stopped.is_set():
                    return  # close() aborted the read mid-body: not an error
                # malformed/truncated LIST body during resync (LB error
                # page, apiserver killed mid-write): reconnect — a dead
                # watch thread would mean a permanently stale informer.
                # WARNING, not debug: a persistently malformed server must
                # stay visible, not loop silently
                log.warning("watch %s resync body unparseable (%s); "
                            "reconnecting", kind, err)
            except (*TRANSPORT_ERRORS, ApiError) as err:
                if self._stopped.is_set():
                    return
                # ApiError covers the resync LIST failing with a Status
                # (429/503 burst, a 401 during token rotation) AFTER the
                # retry budget — the daemon watch thread must reconnect
                # with backoff, never die (a dead thread is a permanently
                # stale informer with no error surface). HTTPException
                # covers a body reset mid-resync (IncompleteRead), which
                # is NOT an OSError and previously escaped this loop.
                log.debug("watch %s dropped (%s: %s); reconnecting", kind,
                          type(err).__name__, err)
            # a dropped stream only opens a DEGRADED window when it cannot
            # resume: with a cursor the missed events are retained in the
            # server's watch cache and replay on reconnect — the informer
            # merely lags, exactly as on a busy healthy stream, so cached
            # reads stay authoritative. Without a cursor (first connect
            # still failing, or a 410 just voided it) events may be
            # missed until the LIST+diff resync lands: serve reads live.
            if not self._stopped.is_set() and not in_gap \
                    and state["rv"] is None:
                in_gap = True
                self._notify_watch_gap(kind, True)
            # a stream that served for a while then dropped is the normal
            # reconnect cadence; only back-to-back connect/resync failures
            # escalate the delay (unreachable or persistently erroring
            # apiserver — don't hammer it at 1 Hz per watched kind)
            if failed and \
                    time.monotonic() - stream_started < \
                    WATCH_BACKOFF_RESET_AFTER_S:
                failures += 1
            else:
                failures = 0
            delay = WATCH_RECONNECT_DELAY_S
            if failures > 1:
                delay = min(WATCH_RECONNECT_DELAY_S * 2 ** min(failures, 8),
                            WATCH_BACKOFF_MAX_S)
                delay *= self._retry_rng.uniform(0.5, 1.0)
            self._stopped.wait(delay)

    #: metadata fields a slim ``seen`` record keeps: the resync diff needs
    #: resourceVersion; a synthesized DELETED must still route through
    #: owner mappers (ownerReferences), label mappers/selectors (labels),
    #: and key extraction (name/namespace/uid)
    _SLIM_METADATA_FIELDS = ("name", "namespace", "uid", "resourceVersion",
                             "labels", "ownerReferences")

    @classmethod
    def _slim(cls, obj: dict) -> dict:
        """Skeleton of a delivered object for the ``seen`` map — rv plus
        only what DELETED synthesis routing needs. Pinning full objects
        pinned O(fleet × object size) per watch thread forever."""
        md = obj.get("metadata") or {}
        return {"kind": obj.get("kind"), "apiVersion": obj.get("apiVersion"),
                "metadata": {k: md[k] for k in cls._SLIM_METADATA_FIELDS
                             if k in md}}

    def _deliver(self, callback, event: WatchEvent, seen: dict) -> bool:
        """Invoke the callback, then record delivery (returns whether it
        was recorded — the watch stream advances its resume cursor only
        past delivered events). A raising callback is logged and NOT
        recorded, so the next resync/replay re-delivers the event instead
        of silently losing it."""
        try:
            callback(event)
        except Exception:  # noqa: BLE001 — consumer bug must not kill the watch
            log.exception("watch callback failed for %s %s",
                          k8s.kind(event.obj), event.type)
            return False
        key = self._obj_key(event.obj)
        if event.type == "DELETED":
            seen.pop(key, None)
        else:
            seen[key] = self._slim(event.obj)
        return True

    def _resync(self, kind, callback, namespace, label_selector,
                seen: dict) -> int | None:
        """After a dropped stream: list and diff against what was delivered.
        Changed objects → MODIFIED, unseen → ADDED, vanished → DELETED with
        the last-delivered skeleton as the final state (a deletion during
        the outage would otherwise never surface and leave ghost objects in
        informer caches). Returns the LIST's resourceVersion — the
        reflector's watch-from anchor: the stream is complete through it
        the moment the diff is delivered — or None when any delivery
        failed (anchoring would let resumes skip the failed event forever;
        a cursorless next reconnect relists and re-delivers it)."""
        current: dict[tuple[str, str], dict] = {}
        # rv=0: the informer list-then-watch form — any stored state is
        # acceptable (the RV-diff below reconciles staleness); pages when
        # list_page_size is set, so a post-outage resync of a big fleet
        # never materializes one giant body
        items, list_rv = self._list(kind, namespace, label_selector,
                                    resource_version="0")
        for obj in items:
            current[self._obj_key(obj)] = obj
        complete = True
        for key, obj in current.items():
            if key not in seen:
                complete &= self._deliver(callback, WatchEvent("ADDED", obj),
                                          seen)
            elif self._obj_rv(seen[key]) != self._obj_rv(obj):
                complete &= self._deliver(callback,
                                          WatchEvent("MODIFIED", obj), seen)
        for key in [key for key in seen if key not in current]:
            final_state = seen[key]
            complete &= self._deliver(callback,
                                      WatchEvent("DELETED", final_state),
                                      seen)
        return list_rv if complete else None

    def _watch_stream(self, kind: str, callback, namespace, label_selector,
                      connected: threading.Event, seen: dict,
                      on_resynced=None, state: dict | None = None):
        state = state if state is not None \
            else {"rv": None, "connected_once": False}
        resume_rv = state.get("rv")
        query = {"watch": "true",
                 "timeoutSeconds": str(WATCH_SERVER_TIMEOUT_S)}
        if resume_rv is not None:
            query["resourceVersion"] = str(resume_rv)
        if label_selector:
            query["labelSelector"] = _serialize_selector(label_selector)
        path = self._path(kind, namespace, query=query)

        def advance(rv_raw) -> None:
            try:
                rv = int(rv_raw)
            except (TypeError, ValueError):
                return
            # rv 0 is a VALID anchor (a from-birth stream on an empty
            # store is complete through 0) — only None means "no cursor,
            # must relist"
            if state["rv"] is None or rv > state["rv"]:
                state["rv"] = rv

        # dedicated (non-pooled) connection: the stream holds it for its
        # whole lifetime and it is never reusable afterwards
        resp = self._request("GET", path, timeout=WATCH_READ_TIMEOUT_S,
                             pooled=False)
        try:
            with self._streams_lock:
                self._live_streams.add(resp)
            try:
                connected.set()  # server has registered the watch relay
                if resume_rv is not None:
                    # RV-resumable reconnect: the server is replaying the
                    # retained window after resume_rv on THIS stream — no
                    # LIST, no missable gap, the consumer cache just
                    # catches up through the replayed frames below
                    self._count_resume(kind, "resume")
                    if on_resynced is not None:
                        on_resynced()
                else:
                    # resync AFTER the stream is live (no missable gap): on
                    # the first connect this is informer semantics —
                    # initial list → ADDED for existing objects, as
                    # controller-runtime delivers at boot — and after a 410
                    # (or a drop that never delivered) it is the diff that
                    # surfaces missed changes and deletions. Events racing
                    # the resync may deliver twice (level-based consumers
                    # tolerate that); with unchanged RVs the diff delivers
                    # nothing.
                    if state["connected_once"]:
                        self._count_resume(kind, "relist")
                    list_rv = self._resync(kind, callback, namespace,
                                           label_selector, seen)
                    # anchor the resume cursor at the LIST's rv NOW: a
                    # stream dropped before the first bookmark is read
                    # must still reconnect in resume mode (the reflector's
                    # list-then-watch-from-rv contract)
                    if list_rv is not None:
                        advance(list_rv)
                    if on_resynced is not None:
                        on_resynced()
                state["connected_once"] = True
                # stream framing follows the RESPONSE Content-Type:
                # length-prefixed codec frames when the server honored a
                # binary Accept, NDJSON otherwise (a binary-unaware or
                # older server degrades the stream to JSON transparently)
                binary_stream = codec.accepts_binary(
                    resp.headers.get("Content-Type"))
                while not self._stopped.is_set():
                    try:
                        if binary_stream:
                            head = _read_exact(resp, 4)
                            if len(head) < 4:
                                return  # server closed the stream
                            (total,) = struct.unpack(">I", head)
                            payload = _read_exact(resp, total)
                            if len(payload) < total:
                                return  # truncated frame: reconnect
                        else:
                            line = resp.readline()
                            if not line:
                                return  # server closed the stream
                    except ValueError:
                        # close()'s fallback path closed the file under us
                        # ("I/O operation on closed file") — shutdown race,
                        # scoped here so resync JSON errors stay loud
                        return
                    try:
                        if binary_stream:
                            event_type, obj = codec.parse_event(payload)
                        else:
                            frame = json.loads(line)
                            event_type = frame["type"]
                            obj = frame["object"]
                    except (ValueError, KeyError, TypeError):
                        # truncated/garbled frame (apiserver killed
                        # mid-write; CodecError ⊂ ValueError): reconnect;
                        # the replay/resync re-covers whatever it carried
                        return
                    if event_type == "BOOKMARK":
                        # idle-stream resume anchor: the server guarantees
                        # this stream is complete through the bookmark rv
                        advance(k8s.get_in(obj, "metadata",
                                           "resourceVersion"))
                        continue
                    if self._deliver(callback, WatchEvent(event_type, obj),
                                     seen):
                        advance(k8s.get_in(obj, "metadata",
                                           "resourceVersion"))
                    else:
                        # failed delivery: the stream is NOT complete past
                        # this event, and a later event or bookmark must
                        # not advance the cursor over it — drop the
                        # stream; the reconnect resumes from the last
                        # DELIVERED rv and replays this event (the
                        # re-delivery _deliver's contract promises)
                        return
            finally:
                with self._streams_lock:
                    self._live_streams.discard(resp)
        finally:
            try:
                resp.close()
            except OSError:
                pass
            conn = getattr(resp, "_kt_conn", None)
            if conn is not None:
                try:
                    conn.close()
                except OSError:
                    pass

    def close(self) -> None:
        """Stop watch threads NOW: set the stop flag and shut down the live
        watch sockets. A blocked recv() wakes on socket shutdown (returns
        0 bytes → readline sees EOF); calling resp.close() instead would
        contend on the BufferedReader lock the reading thread holds and
        block until the read timeout."""
        self._stopped.set()
        # reap the keep-alive pool: worker threads' persistent connections
        # are idle at shutdown (their requests are done) or their in-flight
        # retry waits just aborted via _stopped — closing from here is the
        # only way to reach them across threads
        with self._conns_lock:
            conns = list(self._conns)
            self._conns.clear()
        for conn in conns:
            try:
                conn.close()
            except OSError:
                pass
        with self._streams_lock:
            streams = list(self._live_streams)
        for resp in streams:
            try:
                sock = resp.fp.raw._sock  # noqa: SLF001 — http.client layout
                sock.shutdown(socket.SHUT_RDWR)
            except (OSError, ValueError):
                pass  # already closed: nothing left to unblock
            except AttributeError:
                # different response internals: fall back to close() —
                # may block until the read timeout, but never hangs forever
                try:
                    resp.close()
                except OSError:
                    pass
