"""HTTP(S) apiserver over a ClusterStore.

The port's copy of ``kubeflow_tpu/cluster/apiserver.py``: the real
Kubernetes REST wire protocol (resource paths, list kinds, ``?watch=true``
streams, RFC 7386 merge-patch, the ``/status`` subresource, ``Status``
error objects, JSON or the binary codec by negotiation) served from the
port's store, so another process (a second manager, kubectl-style
tooling) reconciles the same cluster state over HTTP. Admission plugins
and CRD schemas registered on the store run server side, where
kube-apiserver runs its webhook phase: a remote client gets the mutated
object, or the denial as a 4xx Status.

Around the verbs: bearer-token auth, TLS, an audit log of mutating
requests, API priority and fairness (``cluster/apf.py``), the wire-fault
seam (``cluster/faults.py``), resumable watch streams fanned out from
the store's shared frames through bounded per-watcher queues, LISTs and
GETs at a resourceVersion served from a per-kind watch cache, and the
Service ``proxy`` subresource the idle culler's probes take in dev mode.
"""

from __future__ import annotations

import bisect
import itertools
import json
import logging
import queue
import socket
import ssl
import struct
import threading
import time
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from ..utils import k8s, names, tracing
from . import apf as apf_mod
from . import codec, faults, restmapper
from .errors import (ApiError, ConflictError, GoneError, InvalidError,
                     NotFoundError)
from .store import EventFrame, WatchEvent, _decode_continue, _encode_continue

log = logging.getLogger("kubeflow_tpu_torch.apiserver")

_TRACER = tracing.get_tracer("kubeflow_tpu_torch.apiserver")

WATCH_BOOKMARK_INTERVAL_S = 10.0

#: retry budget for the status-subresource merge-PATCH re-merge loop —
#: matches ClusterStore.PATCH_MAX_RETRIES; past it the racing writer wins
#: and the client gets the 409 to reason about
STATUS_PATCH_MAX_RETRIES = 20

#: per-watcher queue depth beyond which MODIFIED frames coalesce per key
#: (latest state wins). Healthy watchers drain far below this; a stalled
#: one converges to at most one pending frame per live object — bounded
#: by fleet size, not by event rate × stall time.
WATCH_QUEUE_SOFT_LIMIT = 128
#: hard depth cap: coalescing bounds MODIFIED churn, but ADDED/DELETED
#: frames always append (edges must not be lost), so create/delete churn
#: against a stalled watcher still grows the queue — past this the
#: watcher is declared too slow and its STREAM is closed (the real
#: apiserver does the same), which is cheap now: the client reconnects
#: and resumes by resourceVersion from the watch-cache ring (sized the
#: same), or relists after 410 if it stalled past the window.
WATCH_QUEUE_HARD_LIMIT = 4096


def _frame_line(etype: str, frame: EventFrame) -> bytes:
    """One NDJSON watch frame from the shared encoding: the object bytes
    are serialized once per EVENT (EventFrame caches them); only the tiny
    type envelope is composed per watcher."""
    return b'{"type":"' + etype.encode() + b'","object":' + \
        frame.obj_bytes() + b"}\n"


def _frame_line_binary(etype: str, frame: EventFrame) -> bytes:
    """The binary-wire twin of _frame_line: a length-prefixed frame
    spliced around the event's cached binary object payload — a mixed
    fleet (JSON + binary watchers on one ring) encodes each event at
    most once per format, never per watcher."""
    return codec.frame_event(etype, frame.obj_bytes_binary())


class _WatcherQueue:
    """Bounded per-watcher frame queue with level-safe coalescing.

    ``put`` is called from the store's dispatch (never blocks the writer);
    ``get`` from the one streaming thread. Under backpressure (depth ≥
    ``soft_limit``) an incoming MODIFIED frame coalesces into the pending
    cell for the same object instead of appending — the delivery TYPE of
    the pending cell is preserved (an undelivered ADDED stays ADDED,
    carrying the newest state: level semantics, exactly what an informer
    needs) and the cell MOVES to the queue tail, keeping delivered rvs
    monotonic: an in-place replace would hand a higher-rv frame out ahead
    of earlier-queued frames of other keys, and a client whose stream
    died in between would resume PAST the undelivered ones — silently
    lost events. ADDED and DELETED frames always append, so no edge is
    lost and a DELETED is never overtaken by a stale MODIFIED (the key
    map is cleared at the delete, isolating incarnations).

    Coalescing bounds MODIFIED churn; ADDED/DELETED churn is bounded by
    the HARD cap instead: past ``hard_limit`` the queue flips
    ``overflowed`` and drops everything — the streaming thread closes the
    stream, and the client's RV-resume (or 410→relist) re-delivers
    level-safely. Memory is therefore bounded by
    max(fleet size + soft_limit, hard_limit) frames per watcher."""

    __slots__ = ("_cv", "_items", "_by_key", "_seq", "soft_limit",
                 "hard_limit", "overflowed", "coalesced", "_on_coalesce")

    def __init__(self, soft_limit: int = WATCH_QUEUE_SOFT_LIMIT,
                 hard_limit: int = WATCH_QUEUE_HARD_LIMIT,
                 on_coalesce=None) -> None:
        self._cv = threading.Condition(threading.Lock())
        # FIFO by insertion seq; coalescing re-inserts at the tail in O(1).
        # cells: [deliver_type, frame, key, seq]
        self._items: OrderedDict = OrderedDict()
        self._by_key: dict = {}
        self._seq = itertools.count()
        self.soft_limit = soft_limit
        self.hard_limit = hard_limit
        self.overflowed = False
        self.coalesced = 0
        self._on_coalesce = on_coalesce

    def __len__(self) -> int:
        with self._cv:
            return len(self._items)

    def put(self, frame: EventFrame) -> None:
        key = (k8s.namespace(frame.obj), k8s.name(frame.obj))
        with self._cv:
            if self.overflowed:
                return  # stream is doomed; stop accumulating now
            if frame.type == "MODIFIED" and \
                    len(self._items) >= self.soft_limit:
                cell = self._by_key.get(key)
                if cell is not None:
                    # latest state wins; type preserved; move to tail
                    del self._items[cell[3]]
                    cell[1] = frame
                    cell[3] = next(self._seq)
                    self._items[cell[3]] = cell
                    self.coalesced += 1
                    if self._on_coalesce is not None:
                        self._on_coalesce()
                    return
            if len(self._items) >= self.hard_limit:
                # non-coalescible frame on a full queue: the watcher is
                # too slow — drop everything and flag; delivering a
                # partial stream would be worse than a clean kill, since
                # the client's reconnect re-covers it exactly once
                self.overflowed = True
                self._items.clear()
                self._by_key.clear()
                self._cv.notify()
                return
            cell = [frame.type, frame, key, next(self._seq)]
            self._items[cell[3]] = cell
            if frame.type == "DELETED":
                self._by_key.pop(key, None)
            else:
                self._by_key[key] = cell
            self._cv.notify()

    def get(self, timeout: float):
        """Next ``(deliver_type, frame)`` or ``(None, None)`` on timeout."""
        with self._cv:
            if not self._items:
                self._cv.wait(timeout)
            if not self._items:
                return None, None
            _, cell = self._items.popitem(last=False)
            if self._by_key.get(cell[2]) is cell:
                del self._by_key[cell[2]]
            return cell[0], cell[1]


#: how long an rv-gated read waits for the serve cache to catch up to the
#: requested resourceVersion before falling back to the store path (with a
#: single in-process store the cache is fed synchronously and never waits;
#: the gate exists for conformance with kube's wait-until-fresh reads)
SERVE_CACHE_FRESH_WAIT_S = 2.0


class _KindServeCache:
    """Server-side watch cache for one kind: the consistent-read-from-cache
    store kube-apiserver serves ``LIST ?resourceVersion=0`` (and rv-gated
    GETs) from, so resyncs and scrapes never touch the store's write-path
    lock.

    Fed through the store's frame relay — registered ATOMICALLY with a
    deepcopied snapshot (``snapshot_with_frames``), and every subsequent
    event applies under the store lock's rv ordering — so the cache is
    never stale relative to the store: a write's frame lands here before
    the write's lock is released. Reads therefore serve FRAME OBJECTS by
    reference (the serialize-once immutability contract) with no deepcopy
    and no store lock: the cost of a cache-served LIST is pure JSON
    encoding, and N managers' resyncs stop stampeding the write path.

    ``wait_for_rv`` is kube's wait-until-fresh gate for
    ``resourceVersion=N`` reads: block (bounded) until the cache has seen
    rv ≥ N. With the in-process store it returns immediately; a timeout
    falls back to the authoritative store path rather than erroring."""

    __slots__ = ("kind", "_cv", "objects", "rv", "_sorted", "_gen",
                 "_ready", "_pending")

    def __init__(self, store, kind: str) -> None:
        self.kind = kind
        self._cv = threading.Condition(threading.Lock())
        self.objects: dict[tuple[str, str], dict] = {}
        self.rv = 0
        self._sorted: list | None = None
        self._gen = 0  # membership generation; bumps invalidate _sorted
        self._ready = False
        self._pending: list[EventFrame] = []
        snapshot, anchor = store.snapshot_with_frames(kind, self._on_frame)
        with self._cv:
            for obj in snapshot:
                self._apply_locked(obj, self._obj_rv(obj), deleted=False)
            # frames that raced the snapshot application queue in _pending;
            # all carry rv > anchor ≥ any snapshot rv, so applying them
            # after the snapshot preserves rv order exactly
            for frame in self._pending:
                self._apply_locked(frame.obj, frame.rv,
                                   deleted=frame.type == "DELETED")
            self._pending = []
            if anchor > self.rv:
                self.rv = anchor
            self._ready = True
            self._cv.notify_all()

    @staticmethod
    def _obj_rv(obj: dict) -> int:
        try:
            return int(k8s.get_in(obj, "metadata", "resourceVersion") or 0)
        except (TypeError, ValueError):
            return 0

    def _on_frame(self, frame: EventFrame) -> None:
        # called under the STORE lock: pure dict work under our own lock,
        # never re-enters the store (the frame-relay contract)
        with self._cv:
            if not self._ready:
                self._pending.append(frame)
                return
            self._apply_locked(frame.obj, frame.rv,
                               deleted=frame.type == "DELETED")
            self._cv.notify_all()

    def _apply_locked(self, obj: dict, rv: int, deleted: bool) -> None:
        key = (k8s.namespace(obj), k8s.name(obj))
        if deleted:
            if self.objects.pop(key, None) is not None:
                self._sorted = None  # membership changed; re-sort lazily
                self._gen += 1
        else:
            cur = self.objects.get(key)
            if cur is None or self._obj_rv(cur) <= rv:
                if cur is None:
                    self._sorted = None
                    self._gen += 1
                self.objects[key] = obj
        if rv > self.rv:
            self.rv = rv

    def wait_for_rv(self, min_rv: int,
                    timeout: float = SERVE_CACHE_FRESH_WAIT_S) -> bool:
        deadline = time.monotonic() + timeout
        with self._cv:
            while self.rv < min_rv:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cv.wait(remaining)
            return True

    def get(self, namespace: str, name: str) -> dict | None:
        with self._cv:
            return self.objects.get((namespace, name))

    def list_page(self, namespace: str | None, selector,
                  limit: int | None = None,
                  continue_token: str | None = None,
                  ) -> tuple[list[dict], str | None, str]:
        """Same chunking semantics (and continue-token encoding) as
        ClusterStore.list_page, served lock-free from the cache: keys in
        deterministic (namespace, name) order, objects handed out by
        reference (immutable frames — the HTTP layer encodes them
        straight to bytes, no deepcopy)."""
        start_after = (_decode_continue(continue_token)
                       if continue_token else None)
        if limit is not None and limit <= 0:
            limit = None
        # sort OUTSIDE the cv: _on_frame runs under the STORE lock and
        # needs this cv — an O(n log n) fleet-key sort held inside it
        # would stall every store write behind a cache LIST during
        # churn. The lock covers only the O(n) key snapshot; the sorted
        # list is published back iff no membership change raced it
        # (stale pairs are fine either way: the chunked-LIST contract
        # already tolerates objects created/deleted mid-walk).
        with self._cv:
            pairs = self._sorted
            list_rv = str(self.rv)
        if pairs is None:
            with self._cv:
                keys = list(self.objects)
                gen = self._gen
            keys.sort()
            pairs = keys
            with self._cv:
                if self._gen == gen:
                    self._sorted = pairs
        start = (bisect.bisect_right(pairs, start_after)
                 if start_after is not None else 0)
        out: list[dict] = []
        last_pair: tuple[str, str] | None = None
        next_token: str | None = None
        for pair in pairs[start:]:
            obj = self.objects.get(pair)  # may have raced a delete: skip
            if obj is None \
                    or (namespace is not None and pair[0] != namespace) \
                    or not k8s.matches_labels(obj, selector):
                continue
            if limit is not None and len(out) >= limit:
                next_token = _encode_continue(*last_pair)
                break
            out.append(obj)
            last_pair = pair
        return out, next_token, list_rv


def _parse_label_selector(raw: str | None) -> dict[str, str | None] | None:
    """``key=value`` equality terms plus bare ``key`` existence terms
    (mapped to value ``None``, matching k8s.matches_labels)."""
    if not raw:
        return None
    out: dict[str, str | None] = {}
    for part in raw.split(","):
        part = part.strip()
        if "=" in part:
            key, _, val = part.partition("=")
            out[key.strip()] = val.strip()
        elif part:
            out[part] = None
    return out or None


def _status_body(code: int, reason: str, message: str) -> bytes:
    return json.dumps({
        "kind": "Status", "apiVersion": "v1", "status": "Failure",
        "message": message, "reason": reason, "code": code,
    }).encode()


class _Route:
    """A parsed request path: which mapping, namespace, name, subresource.
    ``tail`` holds the path segments AFTER the subresource — the proxy
    subresource forwards them to the backend."""

    def __init__(self, mapping: restmapper.RestMapping,
                 namespace: str | None, name: str | None,
                 subresource: str | None,
                 tail: tuple[str, ...] = ()) -> None:
        self.mapping = mapping
        self.namespace = namespace
        self.name = name
        self.subresource = subresource
        self.tail = tail


def _wire_verb(method: str, route: _Route, is_watch: bool) -> str:
    """Map a request to the client-go verb vocabulary a FaultPlan rules on."""
    if method == "GET":
        if is_watch:
            return "watch"
        return "get" if route.name else "list"
    return {"POST": "create", "PUT": "update", "PATCH": "patch",
            "DELETE": "delete"}.get(method, method.lower())


def _parse_path(path: str) -> _Route | None:
    parts = [p for p in path.split("/") if p]
    if not parts:
        return None
    if parts[0] == "api":
        if len(parts) < 3 or parts[1] != "v1":
            return None
        group, version, rest = "", "v1", parts[2:]
    elif parts[0] == "apis":
        if len(parts) < 4:
            return None
        group, version, rest = parts[1], parts[2], parts[3:]
    else:
        return None
    namespace: str | None = None
    if rest[0] == "namespaces" and len(rest) >= 3:
        # /namespaces/{ns}/{plural}... — but /api/v1/namespaces/{name} alone
        # is the Namespace resource itself
        namespace, rest = rest[1], rest[2:]
    elif rest[0] == "namespaces":
        mapping = restmapper.mapping_for_route("", "v1", "namespaces")
        name = rest[1] if len(rest) > 1 else None
        return _Route(mapping, None, name, None) if mapping else None
    plural, rest = rest[0], rest[1:]
    mapping = restmapper.mapping_for_route(group, version, plural)
    if mapping is None:
        return None
    name = rest[0] if rest else None
    subresource = rest[1] if len(rest) > 1 else None
    return _Route(mapping, namespace, name, subresource,
                  tuple(rest[2:]))


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "kubeflow-tpu-torch-apiserver"
    # keep-alive clients reuse one connection for many small requests:
    # without TCP_NODELAY, Nagle holds each response body until the peer
    # ACKs the headers (delayed ACK ≈ 40 ms) — per REQUEST, which dwarfs
    # any real apiserver RTT. Per-request connections masked this via
    # Connection: close flushing the socket.
    disable_nagle_algorithm = True

    # ------------------------------------------------------------- plumbing
    def setup(self):  # noqa: D102 — connection tracking for stop()
        super().setup()
        # register the accepted socket so stop() can shut down keep-alive
        # connections: with client-side pooling a connection outlives its
        # requests, and a "stopped" apiserver that keeps serving pooled
        # peers would be unrealistic (a real restart drops every conn)
        conns = getattr(self.server, "open_connections", None)
        if conns is not None:
            with self.server.conn_lock:  # type: ignore[attr-defined]
                conns.add(self.connection)

    def finish(self):  # noqa: D102
        conns = getattr(self.server, "open_connections", None)
        if conns is not None:
            with self.server.conn_lock:  # type: ignore[attr-defined]
                conns.discard(self.connection)
        super().finish()

    def handle_one_request(self):  # noqa: D102
        try:
            super().handle_one_request()
        except (ConnectionResetError, BrokenPipeError):
            # peer (or stop()) dropped the keep-alive connection between
            # or during requests — normal teardown, not a handler error
            # worth a socketserver stderr traceback
            self.close_connection = True

    def log_message(self, fmt, *args):  # route through logging, not stderr
        log.debug("%s %s", self.address_string(), fmt % args)

    @property
    def store(self):
        return self.server.store  # type: ignore[attr-defined]

    def _authorized(self) -> bool:
        token = self.server.token  # type: ignore[attr-defined]
        if token is None:
            return True
        got = self.headers.get("Authorization", "")
        return got == f"Bearer {token}"

    def _send_json(self, code: int, body: dict) -> None:
        """Send a success body in the NEGOTIATED encoding: binary when the
        request's Accept names the binary media type, JSON (the default
        and the debugging path) otherwise. Error Status bodies always go
        through _send_error_status as JSON — a client that cannot decode
        its error would be debugging blind."""
        if codec.accepts_binary(self.headers.get("Accept")):
            data = codec.encode(body)
            ctype = codec.BINARY_CONTENT_TYPE
        else:
            data = json.dumps(body).encode()
            ctype = "application/json"
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        # audit BEFORE the body reaches the socket: once the client sees
        # the response it may issue its next request, and that request's
        # audit line must not be able to overtake this one (the
        # idempotency checker replays the trail in order)
        self._audit_now()
        self.wfile.write(data)

    def _send_error_status(self, code: int, reason: str, message: str,
                           retry_after_s: float | None = None) -> None:
        data = _status_body(code, reason, message)
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        if retry_after_s is not None:
            # real apiserver priority-and-fairness sends integer seconds;
            # sub-second plans still need pacing, so send the raw float
            # (HttpApiClient parses either)
            self.send_header("Retry-After", f"{retry_after_s:g}")
        self.end_headers()
        self._audit_now()  # same ordering argument as _send_json
        self.wfile.write(data)

    def _send_api_error(self, err: ApiError) -> None:
        self._send_error_status(err.code, err.reason, err.message)

    def _read_body(self) -> dict:
        """Decode the request body by its Content-Type: the binary media
        type routes through the codec (a malformed binary body is a typed
        422 Status — the client treats its own failure to DECODE a binary
        response as a retryable transport error, but a body the server
        cannot parse is the sender's bug, not a wire flake); everything
        else stays on the JSON default."""
        length = int(self.headers.get("Content-Length", 0))
        raw = self.rfile.read(length)
        if codec.accepts_binary(self.headers.get("Content-Type")):
            try:
                return codec.decode(raw)
            except codec.CodecError as exc:
                raise InvalidError(f"malformed binary body: {exc}") from None
        return json.loads(raw or b"{}")

    def send_response(self, code, message=None):  # noqa: D102 — audit tap
        self._last_status = code
        super().send_response(code, message)

    def _audit_now(self) -> None:
        """Write this request's audit line exactly once (first caller
        wins: the response senders call it pre-body, the dispatch finally
        is the catch-all)."""
        method = getattr(self, "_audit_method", None)
        if method is None or getattr(self, "_audited", True):
            return
        self._audited = True
        self._audit(method, self._audit_path)

    def _audit(self, method: str, path: str) -> None:
        """One NDJSON line per mutating request (verb, path, the resource
        NAME — for POST the server-assigned one, so retried creates are
        attributable to one object — peer, the RESPONSE status so
        denied/failed mutations are distinguishable, RFC3339 timestamp) —
        the analog of the reference test suite's optional apiserver audit
        log (odh suite_test.go:127-157). An idempotency check reads this
        trail: two 201s for one (path, name) would mean
        a retried create double-applied. Reads are skipped (GET/watch
        volume would drown the trail) and an audit write failure must
        never break serving."""
        audit = getattr(self.server, "audit_log", None)
        if audit is None or method == "GET":
            return
        line = json.dumps({
            "ts": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "verb": method, "path": path,
            "name": getattr(self, "_audit_name", None),
            "status": getattr(self, "_last_status", None),
            "peer": self.address_string(),
            # the client's W3C trace id (traceparent header) — joins the
            # audit trail against traces; null when tracing is off
            "trace_id": getattr(self, "_trace_id_hex", None),
        }) + "\n"
        try:
            with self.server.audit_lock:  # type: ignore[attr-defined]
                audit.write(line)
                audit.flush()
        except (OSError, ValueError) as exc:
            # disk full, or stop() closed the file under a late handler
            log.warning("audit write failed: %s", exc)

    def _dispatch(self, method: str) -> None:
        # audit bookkeeping for THIS request (handler instances are
        # per-connection, reused across keep-alive requests — reset all
        # of it): the line is written by whichever response sender runs
        # first (_audit_now before the body bytes, so a client's next
        # request can't overtake its own trail), the finally is the
        # catch-all for paths that never send a full response
        parsed = urlparse(self.path)
        qs = parse_qs(parsed.query)  # parsed ONCE for the whole request
        # per-frontend request accounting (replicated frontends over one
        # store): requests_served reads this to show the client-side
        # endpoint spreading actually spread
        req_lock = getattr(self.server, "req_count_lock", None)
        if req_lock is not None:
            with req_lock:
                self.server.requests_total += 1  # type: ignore[attr-defined]
        self._audit_method = method
        self._audit_path = parsed.path
        self._audit_name = None
        self._audited = False
        # incoming W3C trace context: parsed whenever the CLIENT sent the
        # header — the audit trail must correlate even when this server
        # process has no recording provider of its own (the two-process
        # production shape traces the manager, not the apiserver). Untraced
        # clients send no header, so the hot path stays a dict miss;
        # malformed headers restart the trace (None).
        self._trace_id_hex = None
        remote_ctx = None
        traceparent = self.headers.get("traceparent")
        if traceparent is not None:
            remote_ctx = tracing.parse_traceparent(traceparent)
            if remote_ctx is not None:
                self._trace_id_hex = f"{remote_ctx.trace_id:032x}"
        latency = getattr(self.server, "latency_s", 0.0)
        if latency:
            # emulated network+processing round trip (ApiServerProxy
            # latency_s): a real apiserver is a remote process; sleeping
            # here (GIL released) is what lets concurrent clients overlap
            # their in-flight requests like they would over a real wire.
            # Watch streams are exempt below (the stream is long-lived;
            # per-frame latency is not request latency).
            if "watch" not in qs:
                time.sleep(latency)
        if not self._authorized():
            self._send_error_status(401, "Unauthorized", "invalid bearer token")
            return
        if parsed.path in ("/healthz", "/readyz", "/livez"):
            # health endpoints are NOT exempt from wire faults (matched as
            # GET with no kind): a partitioned or dead apiserver cannot
            # answer its own readyz either, so FaultPlan.outage() must
            # fail the breaker's ping probe too, or the breaker would
            # flap closed on a clean 200 one probe interval after opening
            plan = getattr(self.server, "fault_plan", None)
            rule = plan.decide("get", None) if plan is not None else None
            if rule is not None:
                if rule.fault == faults.FAULT_LATENCY:
                    time.sleep(rule.latency_s)
                elif rule.fault == faults.FAULT_RESET:
                    self._inject_reset()
                    return
                elif rule.fault == faults.FAULT_HTTP:
                    self._send_error_status(
                        rule.status, rule.reason,
                        f"injected {rule.status} fault",
                        retry_after_s=rule.retry_after_s)
                    return
            self.send_response(200)
            self.send_header("Content-Type", "text/plain")
            self.send_header("Content-Length", "2")
            self.end_headers()
            self.wfile.write(b"ok")
            return
        route = _parse_path(parsed.path)
        if route is None:
            self._send_error_status(404, "NotFound",
                                    f"unrecognized path {parsed.path}")
            return
        # ------------------------------------------------ fault injection
        # (FaultPlan, cluster/faults.py): decided per request AFTER auth
        # and routing — the plan speaks the verb/kind vocabulary — but
        # BEFORE the handler for unambiguous faults (429/5xx: the real
        # apiserver rejects those before processing). Connection resets
        # instead run the handler and truncate the response: the mutation
        # HAS applied, the client cannot know — the ambiguity retried
        # creates must disambiguate. Health endpoints stay exempt above.
        self._audit_name = route.name  # POST overwrites with the created name
        self._watch_kill_after = None
        reset_rule = None
        is_watch = method == "GET" and \
            qs.get("watch", ["false"])[-1] in ("true", "1")
        verb = _wire_verb(method, route, is_watch)
        # ---------------------------------------- priority & fairness (APF)
        # classify → seat or queue BEFORE any handler work, as the real
        # apiserver's flow control does. Watch streams are exempt (a seat
        # held for a stream's lifetime would permanently leak concurrency;
        # their cost is bounded by the fan-out layer instead), health
        # endpoints returned above. Rejections surface as 429+Retry-After,
        # the standard flow-control path every client verb retries.
        dispatcher = getattr(self.server, "apf", None)
        apf_ticket = None
        rec = tracing.is_recording()
        # server-side root for this request, parented on the client's wire
        # span via traceparent — one trace covers client retries, APF
        # queueing, and the handler (a shared no-op context manager when
        # tracing is off, so nothing is allocated)
        with _TRACER.start_span(
                "apiserver.request",
                {"http.method": method, "k8s.verb": verb,
                 "k8s.kind": route.mapping.kind} if rec else None,
                parent=remote_ctx):
            if dispatcher is not None and not is_watch:
                try:
                    with _TRACER.start_span("apf.wait") as apf_span:
                        apf_ticket, apf_queued = dispatcher.acquire_info(
                            {"user_agent": self.headers.get("User-Agent", ""),
                             "verb": verb, "kind": route.mapping.kind})
                        if rec:
                            apf_span.set_attribute("apf.priority_level",
                                                   apf_ticket)
                            apf_span.set_attribute("apf.queued", apf_queued)
                except apf_mod.RejectedError as err:
                    self._send_error_status(429, "TooManyRequests", str(err),
                                            retry_after_s=err.retry_after_s)
                    return
            try:
                self._dispatch_admitted(method, route, parsed, qs, verb,
                                        is_watch, reset_rule)
            finally:
                if apf_ticket is not None:
                    dispatcher.release(apf_ticket)

    def _dispatch_admitted(self, method: str, route: _Route, parsed,
                           qs: dict, verb: str, is_watch: bool,
                           reset_rule) -> None:
        """The post-APF remainder of _dispatch: fault injection, routing
        guards, and the verb handler (the caller holds the APF seat)."""
        plan = getattr(self.server, "fault_plan", None)
        if plan is not None:
            rule = plan.decide(verb, route.mapping.kind)
            if rule is not None:
                if tracing.is_recording():
                    # fault provenance on the server span: a trace through
                    # an injected 503/reset shows WHY the wire call failed
                    tracing.current_span().add_event(
                        "fault-injected", {"fault": rule.fault,
                                           "verb": verb,
                                           "kind": route.mapping.kind})
                if rule.fault == faults.FAULT_LATENCY:
                    time.sleep(rule.latency_s)
                elif rule.fault == faults.FAULT_WATCH_KILL:
                    self._watch_kill_after = rule.after_s
                elif rule.fault == faults.FAULT_HTTP:
                    self._send_error_status(
                        rule.status, rule.reason,
                        f"injected {rule.status} fault",
                        retry_after_s=rule.retry_after_s)
                    return
                elif rule.fault == faults.FAULT_RESET:
                    if verb == "watch":
                        # a buffered watch stream would never terminate;
                        # reset the connect instead (same client outcome:
                        # reconnect + RV-diff resync)
                        self._inject_reset()
                        return
                    reset_rule = rule
        if route.subresource == "proxy" and method != "GET":
            # the probes this facade serves are GETs; refusing the rest
            # loudly beats misrouting them into the REST verbs. Drain
            # the unread body first: on a keep-alive connection stale
            # body bytes would be parsed as the NEXT request line.
            try:
                length = int(self.headers.get("Content-Length") or 0)
            except ValueError:
                length = 0
            if length > 0:
                self.rfile.read(length)
            self._send_error_status(405, "MethodNotAllowed",
                                    "the service proxy forwards GET only")
            return
        query = {key: vals[-1] for key, vals in qs.items()}
        # the proxy subresource forwards the RAW query string verbatim
        # (parse_qs collapses duplicate keys — fine for list options,
        # wrong for a passthrough)
        self._raw_query = parsed.query
        try:
            with _TRACER.start_span("apiserver.handle"):
                if reset_rule is not None:
                    self._serve_then_reset(method, route, query)
                else:
                    getattr(self, f"_handle_{method}")(route, query)
        except ApiError as err:
            self._send_api_error(err)
        except BrokenPipeError:
            raise
        except Exception as exc:  # noqa: BLE001 — surface as 500 Status
            log.exception("handler error on %s %s", method, self.path)
            self._send_error_status(500, "InternalError", str(exc))
        finally:
            # catch-all for paths that never reached a response sender
            # (broken pipe mid-handler, injected reset); _audited dedups
            self._audit_now()

    do_GET = lambda self: self._dispatch("GET")            # noqa: E731
    do_POST = lambda self: self._dispatch("POST")          # noqa: E731
    do_PUT = lambda self: self._dispatch("PUT")            # noqa: E731
    do_PATCH = lambda self: self._dispatch("PATCH")        # noqa: E731
    do_DELETE = lambda self: self._dispatch("DELETE")      # noqa: E731

    def _inject_reset(self, promised: int = 128) -> None:
        """Promise a body, deliver nothing, then RST the socket (SO_LINGER
        0 makes close() send RST, not FIN) — the LB-killed-connection
        failure mode: the client's read fails with ECONNRESET /
        IncompleteRead instead of a clean status."""
        try:
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(promised))
            self.end_headers()
            self.wfile.flush()
            self.connection.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                                       struct.pack("ii", 1, 0))
        except OSError:
            pass  # peer already gone; nothing left to reset
        self.close_connection = True

    def _serve_then_reset(self, method: str, route: _Route,
                          query: dict) -> None:
        """FAULT_RESET for REST verbs: run the REAL handler with the
        response buffered, then deliver only part of it and RST the
        socket. The side effect (create/update/delete) has been applied
        server-side; the client sees a connection reset and cannot know —
        the ambiguous failure mode a retried create disambiguates via 409
        AlreadyExists + a live read."""
        import io
        real = self.wfile
        buf = io.BytesIO()
        self.wfile = buf
        try:
            getattr(self, f"_handle_{method}")(route, query)
        finally:
            self.wfile = real
        data = buf.getvalue()
        try:
            # deliver roughly half — enough that the status line usually
            # parses and the BODY truncates (IncompleteRead), sometimes
            # cutting mid-headers (BadStatusLine): both shapes occur on a
            # real wire and the client must survive both
            real.write(data[:max(len(data) // 2, 1)])
            real.flush()
            self.connection.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                                       struct.pack("ii", 1, 0))
        except OSError:
            pass
        self.close_connection = True

    def _handle_service_proxy(self, route: _Route) -> None:
        """GET ``/api/v1/namespaces/{ns}/services/{name}:{port}/proxy/…``
        — the apiserver's service-proxy subresource, the path the idle
        culler's probes take in dev mode (reference:
        culling_controller.go:249-254 builds exactly this URL; the
        serving-activity prober does too, controllers/culling.py).

        Backend resolution: in this in-process cluster pods hold no real
        sockets, so the Service carries ``tpu.kubeflow.org/proxy-backend``
        annotations naming the actual listeners' base URLs (set by the
        dev composition root or a test) — the facade's analog of ready
        Endpoints. PER-PORT resolution mirrors real endpoints: the
        suffixed form ``…/proxy-backend-<port-or-name>`` wins over the
        bare key, so one multi-port notebook Service can route its
        Jupyter and model-serving ports to distinct listeners (the
        culler runs BOTH probes against the same Service). No resolvable
        annotation → 503, exactly what a real apiserver answers for a
        Service with no ready endpoints. The requested port must exist
        on the Service spec (by number or name), like the real
        subresource; the query string forwards; 3xx responses relay
        as-is (Location included) instead of being followed."""
        import urllib.error
        import urllib.request
        if route.mapping.kind != "Service":
            self._send_error_status(
                404, "NotFound",
                f"proxy subresource not supported on "
                f"{route.mapping.kind}")
            return
        name, _, port = (route.name or "").partition(":")
        svc = self.store.get("Service", route.namespace or "", name)
        ports = k8s.get_in(svc, "spec", "ports", default=[]) or []
        entry = next((p for p in ports if str(p.get("port")) == port
                      or p.get("name") == port), None) if port else None
        if port and entry is None:
            self._send_error_status(
                503, "ServiceUnavailable",
                f"no port {port!r} on service {name}")
            return
        # per-port annotation first (by the requested spelling, the
        # port's name, and its number), then the bare fallback
        candidates = [port]
        if entry is not None:
            candidates += [entry.get("name"), str(entry.get("port"))]
        keys = [f"{names.PROXY_BACKEND_ANNOTATION}-{c}"
                for c in dict.fromkeys(c for c in candidates if c)]
        keys.append(names.PROXY_BACKEND_ANNOTATION)
        backend = next((v for v in (k8s.get_annotation(svc, k)
                                    for k in keys) if v), None)
        if not backend:
            self._send_error_status(
                503, "ServiceUnavailable",
                f"service {name} has no resolvable endpoints (the "
                f"in-process facade resolves through the "
                f"{names.PROXY_BACKEND_ANNOTATION}[-<port>] annotations)")
            return
        if not backend.startswith(("http://", "https://")):
            # annotations are author-ish input (same stance as
            # k8s.parse_port): a file:// or ftp:// backend must not
            # reach urllib's non-HTTP handlers
            self._send_error_status(
                503, "ServiceUnavailable",
                f"service {name} proxy backend must be http(s), "
                f"got {backend.split(':', 1)[0]!r}")
            return
        url = backend.rstrip("/") + "/" + "/".join(route.tail)
        if self._raw_query:
            url += "?" + self._raw_query

        def relay(status: int, headers, body: bytes) -> None:
            self.send_response(status)
            self.send_header("Content-Type",
                             headers.get("Content-Type",
                                         "application/octet-stream"))
            if headers.get("Location"):  # relayed 3xx keeps its target
                self.send_header("Location", headers["Location"])
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        class _NoRedirect(urllib.request.HTTPRedirectHandler):
            # the real subresource RELAYS 3xx; following it here could
            # also walk off the annotated backend entirely
            def redirect_request(self, *args, **kwargs):
                return None

        opener = urllib.request.build_opener(_NoRedirect)
        try:
            with opener.open(url, timeout=10.0) as resp:
                relay(resp.status, resp.headers, resp.read())
        except urllib.error.HTTPError as err:
            # the backend's OWN status (errors AND unfollowed redirects)
            relay(err.code, err.headers, err.read())
        except (urllib.error.URLError, OSError) as err:
            self._send_error_status(
                502, "BadGateway",
                f"proxy to {name} failed: {err}")

    # ---------------------------------------------------------------- verbs
    def _serve_cache_for(self, kind: str, rv_raw: str | None):
        """The kind's server-side watch cache when the request is rv-gated
        ('any state at least this fresh is acceptable') and the backing
        store supports the frame-relay handshake; None → store path.
        A positive rv waits until the cache is at least that fresh
        (kube's consistent-read-from-cache); a wait timeout falls back to
        the authoritative store rather than erroring."""
        if rv_raw is None or not rv_raw.isdigit():
            return None  # no rv (quorum-read semantics) → store path
        factory = getattr(self.server, "serve_cache", None)
        if factory is None:
            return None
        cache = factory(kind)
        if cache is None:
            return None
        min_rv = int(rv_raw)
        if min_rv > 0 and not cache.wait_for_rv(min_rv):
            return None
        return cache

    def _handle_GET(self, route: _Route, query: dict) -> None:
        kind = route.mapping.kind
        if route.subresource == "proxy":
            self._handle_service_proxy(route)
            return
        if route.name:
            cache = self._serve_cache_for(kind, query.get("resourceVersion"))
            if cache is not None:
                # rv-gated GET: served lock-free from the watch cache —
                # the cache is complete from birth, so a miss is an
                # authoritative NotFound, exactly like the store's
                obj = cache.get(route.namespace or "", route.name)
                if obj is None:
                    raise NotFoundError(
                        f"{kind} {route.namespace or ''}/{route.name}")
                self._send_json(200, obj)
                return
            obj = self.store.get(kind, route.namespace or "", route.name)
            self._send_json(200, obj)
            return
        selector = _parse_label_selector(query.get("labelSelector"))
        if query.get("watch") in ("true", "1"):
            self._stream_watch(route, selector, query)
            return
        # chunked LIST (?limit=&continue=) + resourceVersion passthrough
        # (rv=0 is the informer cache-ack form — see ClusterStore.list_page)
        try:
            limit = int(query["limit"]) if query.get("limit") else None
        except ValueError:
            self._send_error_status(400, "BadRequest",
                                    f"invalid limit {query['limit']!r}")
            return
        cache = self._serve_cache_for(kind, query.get("resourceVersion"))
        if cache is not None:
            # consistent read from the watch cache: rv=0 (and satisfied
            # rv≥N gates) never touch the store's write-path lock — the
            # path N managers' resyncs and the metrics scrapes ride
            items, next_cont, list_rv = cache.list_page(
                route.namespace, selector, limit=limit,
                continue_token=query.get("continue"))
            metric = getattr(self.server, "cache_list_metric", None)
            if metric is not None:
                metric.inc({"kind": kind})
        elif getattr(self.store, "list_page", None) is not None:
            items, next_cont, list_rv = self.store.list_page(
                kind, route.namespace, selector, limit=limit,
                continue_token=query.get("continue"),
                resource_version=query.get("resourceVersion"))
        else:  # wrapped store without pagination: one full page
            items, next_cont, list_rv = \
                self.store.list(kind, route.namespace, selector), None, "0"
        list_meta: dict = {"resourceVersion": list_rv}
        if next_cont:
            list_meta["continue"] = next_cont
        self._send_json(200, {
            "kind": f"{kind}List",
            "apiVersion": route.mapping.api_version,
            "metadata": list_meta,
            "items": items,
        })

    def _handle_POST(self, route: _Route, query: dict) -> None:
        obj = self._read_body()
        obj.setdefault("kind", route.mapping.kind)
        obj.setdefault("apiVersion", route.mapping.api_version)
        if route.namespace and route.mapping.namespaced:
            k8s.meta(obj).setdefault("namespace", route.namespace)
        created = self.store.create(obj)
        # the collection path carries no name; audit the server-assigned
        # one (generateName included) so the idempotency check can group
        # creates per object
        self._audit_name = k8s.name(created)
        self._send_json(201, created)

    def _handle_PUT(self, route: _Route, query: dict) -> None:
        if not route.name:
            raise NotFoundError("PUT requires a resource name")
        obj = self._read_body()
        obj.setdefault("kind", route.mapping.kind)
        obj.setdefault("apiVersion", route.mapping.api_version)
        if route.subresource == "status":
            self._send_json(200, self.store.update_status(obj))
        else:
            self._send_json(200, self.store.update(obj))

    def _handle_PATCH(self, route: _Route, query: dict) -> None:
        if not route.name:
            raise NotFoundError("PATCH requires a resource name")
        ctype = self.headers.get("Content-Type", "")
        if "merge-patch" not in ctype and "strategic-merge-patch" not in ctype:
            self._send_error_status(
                415, "UnsupportedMediaType",
                f"unsupported patch type {ctype!r}; use "
                f"application/merge-patch+json")
            return
        patch = self._read_body()
        if route.subresource == "status":
            # status-subresource semantics: only .status from the patch is
            # applied (a real apiserver ignores spec fields sent here).
            # Merge-patch re-merges on a racing writer — the same loop
            # store.patch runs for the main resource — but BOUNDED: a
            # pathological hot object (a writer livelocking every re-merge)
            # must back off and surface 409, not spin a handler thread
            # forever with the client timing out blind.
            for attempt in range(STATUS_PATCH_MAX_RETRIES):
                old = self.store.get(route.mapping.kind,
                                     route.namespace or "", route.name)
                old["status"] = k8s.json_merge_patch(
                    old.get("status") or {}, patch.get("status") or {})
                try:
                    self._send_json(200, self.store.update_status(old))
                    return
                except ConflictError:
                    time.sleep(min(0.001 * (2 ** attempt), 0.1))
            raise ConflictError(
                f"{route.mapping.kind} {route.namespace}/{route.name}: "
                f"status patch kept conflicting after "
                f"{STATUS_PATCH_MAX_RETRIES} attempts")
        self._send_json(200, self.store.patch(
            route.mapping.kind, route.namespace or "", route.name, patch))

    def _handle_DELETE(self, route: _Route, query: dict) -> None:
        if not route.name:
            raise NotFoundError("DELETE requires a resource name")
        self.store.delete(route.mapping.kind, route.namespace or "", route.name)
        self._send_json(200, {"kind": "Status", "apiVersion": "v1",
                              "status": "Success"})

    # ---------------------------------------------------------------- watch
    def _stream_watch(self, route: _Route, selector, query: dict) -> None:
        """Stream watch events as newline-delimited JSON, the real watch wire
        format. The connection closes when the client goes away (detected on
        the next write — idle bookmarks bound the detection latency) or the
        server shuts down.

        ``?resourceVersion=N`` resumes: the retained event window after N
        replays from the store's watch cache before live streaming — no
        LIST, no gap — and a window already evicted answers ``410 Gone``
        (reason Expired), the client's signal to fall back to the full
        LIST+diff resync. Frames are encoded once per event (EventFrame)
        and fanned out through a bounded, MODIFIED-coalescing per-watcher
        queue, so a slow or stalled watcher costs bounded memory and never
        slows the others. BOOKMARK frames carry the resourceVersion the
        stream is complete through — the resume anchor on an idle watch."""
        kind = route.mapping.kind
        # wire negotiation: a binary-accepting watcher gets length-prefixed
        # codec frames (cached once per event alongside the JSON bytes —
        # serialize-once fan-out holds for a mixed fleet); everyone else
        # gets the NDJSON default
        binary = codec.accepts_binary(self.headers.get("Accept"))
        encoding = "binary" if binary else "json"
        # plain attribute reads (__init__ pre-sets both to None): the
        # observability label-pin scan resolves these aliases to their
        # registered families
        fan_bytes = self.server.watch_fanout_bytes_metric
        fan_frames = self.server.watch_frames_metric

        def account(payload: bytes) -> None:
            # fan-out cost accounting per stream encoding: the bytes/event
            # ratio between the two series is the measured codec win
            if fan_bytes is not None:
                fan_bytes.inc({"encoding": encoding}, by=len(payload))
            if fan_frames is not None:
                fan_frames.inc({"encoding": encoding})

        resume_raw = query.get("resourceVersion")
        since_rv = None
        if resume_raw:
            # rv 0 included: a client whose stream anchored on an empty
            # store (list rv 0 / connect bookmark 0) resumes from 0 —
            # servable iff the kind's ring never evicted, else 410 →
            # relist, exactly like any other evicted cursor
            try:
                since_rv = int(resume_raw)
            except ValueError:
                self._send_error_status(
                    400, "BadRequest",
                    f"invalid resourceVersion {resume_raw!r}")
                return
        register = getattr(self.store, "watch_frames", None)
        legacy_q: queue.Queue | None = None
        if register is not None:

            def count_coalesce(_kind=kind):
                metric = getattr(self.server, "watch_coalesced_metric", None)
                if metric is not None:
                    metric.inc({"kind": _kind})

            frame_q = _WatcherQueue(on_coalesce=count_coalesce)
            relay = frame_q.put
            try:
                replay, stream_rv = register(
                    kind, relay, namespace=route.namespace,
                    label_selector=selector, since_rv=since_rv)
            except GoneError as err:
                self._send_api_error(err)
                return
        elif since_rv is not None:
            # wrapped store without the frame API: nothing retained to
            # replay from — a resume here would silently skip events, so
            # force the client's relist path instead
            self._send_error_status(
                410, "Expired",
                "watch cache unavailable on this store; relist")
            return
        else:
            legacy_q = queue.Queue()
            relay = legacy_q.put
            self.store.watch(kind, relay, namespace=route.namespace,
                             label_selector=selector)
            replay, stream_rv = [], 0
        queues = getattr(self.server, "active_watch_queues", None)

        def bookmark_bytes() -> bytes:
            obj = {"metadata": {"resourceVersion": str(stream_rv)}}
            if binary:
                return codec.frame_event("BOOKMARK", codec.encode(obj))
            return json.dumps({"type": "BOOKMARK", "object": obj},
                              separators=(",", ":")).encode() + b"\n"

        # the relay is registered: EVERYTHING from here on — the header
        # write included (a client that connected and instantly went away
        # raises BrokenPipeError there) — must reach the finally, or the
        # store would relay every future event of this kind into a dead
        # queue forever
        try:
            if queues is not None and legacy_q is None:
                with self.server.watch_queues_lock:  # type: ignore[attr-defined]
                    queues.add(frame_q)
            self.send_response(200)
            self.send_header("Content-Type",
                             codec.BINARY_CONTENT_TYPE if binary
                             else "application/json")
            self.send_header("Connection", "close")
            self.end_headers()
            self.close_connection = True
            # injected watch kill (FaultPlan): close the stream after its
            # armed lifetime — the client sees EOF mid-watch and must
            # reconnect (resuming from its last-delivered resourceVersion)
            kill_at = None
            if getattr(self, "_watch_kill_after", None) is not None:
                kill_at = time.monotonic() + self._watch_kill_after
            for frame in replay:
                line = (_frame_line_binary(frame.type, frame) if binary
                        else _frame_line(frame.type, frame))
                self.wfile.write(line)
                account(line)
                stream_rv = max(stream_rv, frame.rv)
            # connect-time BOOKMARK: hand the client its resume anchor
            # immediately (the real apiserver's initial-events bookmark) —
            # a stream killed while idle, before the periodic bookmark,
            # would otherwise have no cursor and pay a full relist on
            # reconnect. Sent even at rv 0: an empty store is a valid
            # anchor, not a missing one.
            connect_bookmark = bookmark_bytes()
            self.wfile.write(connect_bookmark)
            account(connect_bookmark)
            self.wfile.flush()
            while not self.server.shutting_down:  # type: ignore[attr-defined]
                timeout = WATCH_BOOKMARK_INTERVAL_S
                if kill_at is not None:
                    remaining = kill_at - time.monotonic()
                    if remaining <= 0:
                        return  # injected stream kill (finally unwatches)
                    timeout = min(timeout, remaining)
                payload = None
                if legacy_q is not None:
                    try:
                        event: WatchEvent = legacy_q.get(timeout=timeout)
                        if binary:
                            payload = codec.frame_event(
                                event.type, codec.encode(event.obj))
                        else:
                            payload = json.dumps(
                                {"type": event.type,
                                 "object": event.obj}).encode() + b"\n"
                    except queue.Empty:
                        pass
                else:
                    etype, frame = frame_q.get(timeout)
                    if frame_q.overflowed:
                        # too-slow watcher (hard cap hit on edge churn):
                        # close the stream — the client resumes by rv
                        # from the watch-cache ring, or relists on 410
                        return
                    if frame is not None:
                        payload = (_frame_line_binary(etype, frame)
                                   if binary else _frame_line(etype, frame))
                        stream_rv = max(stream_rv, frame.rv)
                if payload is None:
                    if kill_at is not None and time.monotonic() >= kill_at:
                        return
                    # idle BOOKMARK: the rv through which this stream is
                    # complete — what a client records as its resume
                    # anchor when no events are flowing
                    payload = bookmark_bytes()
                self.wfile.write(payload)
                account(payload)
                self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass
        finally:
            self.store.unwatch(relay)
            if queues is not None and legacy_q is None:
                with self.server.watch_queues_lock:  # type: ignore[attr-defined]
                    queues.discard(frame_q)


class ApiServerProxy:
    """The HTTP front door for a ClusterStore. Optional bearer-token auth and
    TLS (certfile/keyfile) — the same knobs a real apiserver endpoint has."""

    def __init__(self, store, port: int = 0, host: str = "127.0.0.1",
                 token: str | None = None, certfile: str | None = None,
                 keyfile: str | None = None,
                 audit_log: str | None = None,
                 latency_s: float = 0.0,
                 fault_plan: "faults.FaultPlan | None" = None,
                 apf: "apf_mod.APFDispatcher | bool | None" = None) -> None:
        self.store = store
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.store = store  # type: ignore[attr-defined]
        self._httpd.token = token  # type: ignore[attr-defined]
        self._httpd.shutting_down = False  # type: ignore[attr-defined]
        # priority & fairness (cluster/apf.py): on by default with the
        # generous default seat count — it only engages under genuine
        # overload. Pass apf=False to disable, or a configured dispatcher.
        if apf is None:
            apf = apf_mod.APFDispatcher()
        self.apf = apf or None
        self._httpd.apf = self.apf  # type: ignore[attr-defined]
        # server-side watch caches (consistent-read-from-cache): created
        # lazily per kind on the first rv-gated read; requires the
        # frame-relay handshake on the backing store
        self._serve_caches_lock = threading.Lock()
        self._serve_caches: dict[str, _KindServeCache] = {}
        # copy-on-write published snapshot for the lock-free read fast path
        # (the guarded master dict is only ever touched under its lock)
        self._serve_caches_ro: dict[str, _KindServeCache] = {}
        if hasattr(store, "snapshot_with_frames"):
            self._httpd.serve_cache = self._serve_cache  # type: ignore[attr-defined]
        self._httpd.cache_list_metric = None  # type: ignore[attr-defined]
        # programmable wire-fault seam (cluster/faults.py): per-verb/kind
        # 429/5xx/reset/watch-kill/latency, flipped live through
        # set_fault_plan()
        self._httpd.fault_plan = fault_plan  # type: ignore[attr-defined]
        # emulated request round-trip latency (a localhost
        # facade has ~0 RTT while a production apiserver has 1-10 ms; the
        # dispatch worker-pool measurements need the real shape)
        self._httpd.latency_s = latency_s  # type: ignore[attr-defined]
        # serve-side watch fan-out introspection + metrics:
        # watch_queue_coalesced_total lands here via attach_metrics();
        # active_watch_queues lets tests assert a stalled watcher's queue
        # stays bounded while coalescing
        self._httpd.watch_coalesced_metric = None  # type: ignore[attr-defined]
        self._httpd.watch_fanout_bytes_metric = None  # type: ignore[attr-defined]
        self._httpd.watch_frames_metric = None  # type: ignore[attr-defined]
        # per-frontend request counter (leaf lock: taken for a single
        # increment, nothing acquired under it)
        self._httpd.requests_total = 0  # type: ignore[attr-defined]
        self._httpd.req_count_lock = threading.Lock()  # type: ignore[attr-defined]
        self._httpd.watch_queues_lock = threading.Lock()  # type: ignore[attr-defined]
        self._httpd.active_watch_queues = set()  # type: ignore[attr-defined]
        # accepted sockets, so stop() tears down keep-alive connections
        # (pooled clients would otherwise keep talking to a "stopped"
        # apiserver through handler threads that survive shutdown())
        self._httpd.open_connections = set()  # type: ignore[attr-defined]
        self._httpd.conn_lock = threading.Lock()  # type: ignore[attr-defined]
        # optional mutating-request audit trail (suite_test.go:127-157
        # analog); opened append so restarts extend the trail
        self._audit_file = open(audit_log, "a") if audit_log else None
        self._httpd.audit_log = self._audit_file  # type: ignore[attr-defined]
        self._httpd.audit_lock = threading.Lock()  # type: ignore[attr-defined]
        self.scheme = "http"
        if certfile:
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(certfile, keyfile)
            self._httpd.socket = ctx.wrap_socket(self._httpd.socket,
                                                 server_side=True)
            self.scheme = "https"
        self._thread: threading.Thread | None = None

    def _serve_cache(self, kind: str) -> "_KindServeCache | None":
        """Get-or-create the kind's server-side watch cache (the
        consistent-read store for rv-gated reads)."""
        cache = self._serve_caches_ro.get(kind)
        if cache is not None:
            return cache
        # Build the candidate OUTSIDE the registry lock: _KindServeCache's
        # __init__ performs the snapshot_with_frames handshake, which takes
        # the STORE lock — holding the cache-tier registry lock across a
        # store-tier acquisition inverts the declared store→cache order
        # (and serialized every first-read of a new kind behind one store
        # snapshot). Losing a creation race costs one throwaway snapshot.
        candidate = _KindServeCache(self.store, kind)
        with self._serve_caches_lock:
            cache = self._serve_caches.get(kind)
            if cache is None:
                cache = self._serve_caches[kind] = candidate
                self._serve_caches_ro = dict(self._serve_caches)
        if cache is not candidate:
            self.store.unwatch(candidate._on_frame)
        return cache

    def attach_metrics(self, registry) -> None:
        """Register the server-side watch fan-out counter, the APF flow
        control family, the cache-served LIST counter, and pass the
        registry down to the backing store (watch-cache evictions + LIST
        lock-hold), so the whole watch/read path is measured in one
        exposition."""
        self._httpd.watch_coalesced_metric = registry.counter(  # type: ignore[attr-defined]
            "watch_queue_coalesced_total",
            "MODIFIED watch frames coalesced per key in a backpressured "
            "per-watcher queue (latest state wins), by kind.")
        self._httpd.cache_list_metric = registry.counter(  # type: ignore[attr-defined]
            "apiserver_cache_lists_total",
            "LISTs served lock-free from the server-side watch cache "
            "(rv-gated consistent reads), by kind — the store-lock "
            "traffic the consistent-read path removed.")
        self._httpd.watch_fanout_bytes_metric = registry.counter(  # type: ignore[attr-defined]
            "watch_fanout_bytes_total",
            "Watch-stream bytes written, by wire encoding — the "
            "bytes/event ratio between the binary and json series is the "
            "measured codec win the negotiation is judged by.")
        self._httpd.watch_frames_metric = registry.counter(  # type: ignore[attr-defined]
            "watch_frames_sent_total",
            "Watch frames written (events, replays, and bookmarks), by "
            "wire encoding — the denominator for "
            "watch_fanout_bytes_total's bytes/event ratio.")
        if self.apf is not None:
            self.apf.attach_metrics(registry)
        if hasattr(self.store, "attach_metrics"):
            self.store.attach_metrics(registry)

    @property
    def requests_served(self) -> int:
        """Total HTTP requests this frontend dispatched (watch connects
        included): the per-frontend load-spread number."""
        with self._httpd.req_count_lock:  # type: ignore[attr-defined]
            return self._httpd.requests_total  # type: ignore[attr-defined]

    @property
    def active_watch_queues(self) -> list:
        """Snapshot of the live per-watcher frame queues (introspection
        for the bounded-backpressure tests)."""
        with self._httpd.watch_queues_lock:  # type: ignore[attr-defined]
            return list(self._httpd.active_watch_queues)  # type: ignore[attr-defined]

    @property
    def fault_plan(self):
        return self._httpd.fault_plan  # type: ignore[attr-defined]

    def set_fault_plan(self, plan) -> None:
        """Swap the active FaultPlan (None = heal). Takes effect on the
        next request; in-flight watch streams keep any armed kill."""
        self._httpd.fault_plan = plan  # type: ignore[attr-defined]

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"{self.scheme}://127.0.0.1:{self.port}"

    def start(self) -> None:
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True,
                                        name="kubeflow-tpu-torch-apiserver")
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutting_down = True  # type: ignore[attr-defined]
        self._httpd.shutdown()
        self._httpd.server_close()
        # drop every live connection: handler threads unblock on EOF and
        # exit; pooled clients see the close and reconnect (getting ECONNREFUSED
        # until a restart) — real apiserver restart semantics
        with self._httpd.conn_lock:  # type: ignore[attr-defined]
            open_conns = list(self._httpd.open_connections)  # type: ignore[attr-defined]
        for sock in open_conns:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if self._audit_file is not None:
            # under the lock so a late handler's write either lands before
            # the close or hits the guarded ValueError path, never a race
            with self._httpd.audit_lock:  # type: ignore[attr-defined]
                self._httpd.audit_log = None  # type: ignore[attr-defined]
                self._audit_file.close()
                self._audit_file = None
