"""AdmissionReview webhook server.

A copy of ``kubeflow_tpu/webhook/server.py`` (the port imports nothing of
the JAX package), serving the port's webhooks. Production shape of the admission layer: the kube-apiserver POSTs
``admission.k8s.io/v1`` AdmissionReview JSON over HTTPS to
``/mutate-notebook-v1`` and ``/validate-notebook-v1`` (the reference
registers exactly these paths on the manager's webhook server, odh
main.go:306-331), and receives allowed/denied plus a JSONPatch for
mutations. ``failurePolicy=fail`` semantics live in the cluster-side webhook
configuration; this server's contract is: always answer, deny with a reason
on validation errors, 400 on malformed reviews.

stdlib-only (http.server + ssl): TLS when cert/key paths are given (the
serving cert comes from the platform CA in-cluster), plain HTTP for tests."""

from __future__ import annotations

import base64
import json
import logging
import ssl
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

from ..cluster.errors import ApiError
from ..utils import k8s

log = logging.getLogger("kubeflow_tpu_torch.webhook.server")

MUTATE_PATH = "/mutate-notebook-v1"
VALIDATE_PATH = "/validate-notebook-v1"


def json_patch(original: Any, mutated: Any, path: str = "") -> list[dict]:
    """RFC 6902 patch ops transforming ``original`` into ``mutated``."""
    if original == mutated:
        return []
    if isinstance(original, dict) and isinstance(mutated, dict):
        ops: list[dict] = []
        for key in original:
            escaped = _escape(key)
            if key not in mutated:
                ops.append({"op": "remove", "path": f"{path}/{escaped}"})
            else:
                ops.extend(json_patch(original[key], mutated[key],
                                      f"{path}/{escaped}"))
        for key in mutated:
            if key not in original:
                ops.append({"op": "add", "path": f"{path}/{_escape(key)}",
                            "value": mutated[key]})
        return ops
    return [{"op": "replace", "path": path or "", "value": mutated}]


def _escape(key: str) -> str:
    return key.replace("~", "~0").replace("/", "~1")


class AdmissionServer:
    """Serves both webhooks. ``mutating``/``validating`` expose
    handle(operation, obj, old) — the same objects the in-process admission
    plugins use, so cluster deployments and the in-process apiserver share
    one code path."""

    def __init__(self, mutating, validating, host: str = "0.0.0.0",
                 port: int = 8443, certfile: str | None = None,
                 keyfile: str | None = None, tls_profile=None):
        self.mutating = mutating
        self.validating = validating
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # route through logging
                log.debug("webhook http: " + fmt, *args)

            def do_POST(self) -> None:
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                    review = json.loads(self.rfile.read(length))
                    response = outer.review(self.path, review)
                except (ValueError, KeyError) as exc:
                    self.send_error(400, f"malformed AdmissionReview: {exc}")
                    return
                body = json.dumps(response).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._server = ThreadingHTTPServer((host, port), Handler)
        if certfile:
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            if tls_profile is not None:
                # a cluster TLS security profile: anything with
                # apply(ctx) (reference odh main.go:178-234 applies the
                # fetched-or-fallback profile to every listener)
                tls_profile.apply(ctx)
            else:
                ctx.minimum_version = ssl.TLSVersion.TLSv1_2
            ctx.load_cert_chain(certfile, keyfile)
            self._server.socket = ctx.wrap_socket(self._server.socket,
                                                  server_side=True)
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def is_serving(self) -> bool:
        """True while the accept loop is actually running — readiness probes
        must reflect a dead listener, not mere construction."""
        return self._thread is not None and self._thread.is_alive()

    # ------------------------------------------------------------- review
    def review(self, path: str, review: dict) -> dict:
        request = review["request"]
        uid = request["uid"]
        operation = request.get("operation", "CREATE")
        obj = request.get("object")
        old = request.get("oldObject")
        resp: dict = {"uid": uid, "allowed": True}
        try:
            if path == MUTATE_PATH:
                mutated = self.mutating.handle(operation, k8s.deepcopy(obj),
                                               old)
                ops = json_patch(obj, mutated)
                if ops:
                    resp["patchType"] = "JSONPatch"
                    resp["patch"] = base64.b64encode(
                        json.dumps(ops).encode()).decode()
            elif path == VALIDATE_PATH:
                self.validating.handle(operation, obj, old)
            else:
                raise KeyError(f"unknown webhook path {path}")
        except ApiError as exc:
            resp["allowed"] = False
            resp["status"] = {"code": exc.code, "message": exc.message}
        except KeyError:
            raise  # malformed review → caller's 400
        except Exception as exc:  # noqa: BLE001 — always answer: a handler
            # crash (null object, wrong shapes) must become a deny, not a
            # dropped connection the apiserver reads as a webhook outage
            log.exception("webhook handler error")
            resp["allowed"] = False
            resp["status"] = {"code": 500,
                              "message": f"webhook error: {exc}"}
        return {
            "apiVersion": "admission.k8s.io/v1",
            "kind": "AdmissionReview",
            "response": resp,
        }

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True,
                                        name="kubeflow-tpu-torch-webhook")
        self._thread.start()

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
