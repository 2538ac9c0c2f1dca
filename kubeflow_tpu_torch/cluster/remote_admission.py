"""Webhook-configuration-driven remote admission.

The port's copy of ``kubeflow_tpu/cluster/remote_admission.py``.
kube-apiserver's admission phase POSTs ``admission.k8s.io/v1``
AdmissionReview to the webhooks that Mutating/ValidatingWebhookConfiguration
objects register, and applies the JSONPatch each returns. ``ClusterStore``
does the same: configuration objects created in the store are indexed,
and writes of a matching kind call out to the configured endpoints, so
the manager's ``AdmissionServer`` (``webhook/server.py``) runs over the
AdmissionReview wire protocol, not only as an in-process plugin.

Supported clientConfig: ``url`` (``https://`` with an optional
``caBundle``, or plain ``http://``). Service-based clientConfig needs
cluster DNS, which a standalone deployment does not have: such configs
are skipped with a log.

failurePolicy: an unreachable webhook denies the write under ``Fail``
(the default) and is skipped under ``Ignore``.
"""

from __future__ import annotations

import base64
import copy
import json
import logging
import ssl
import urllib.error
import urllib.request

from ..utils import k8s
from . import restmapper
from .errors import ApiError, InvalidError

log = logging.getLogger("kubeflow_tpu_torch.remote_admission")

MUTATING_KIND = "MutatingWebhookConfiguration"
VALIDATING_KIND = "ValidatingWebhookConfiguration"
CONFIG_KINDS = (MUTATING_KIND, VALIDATING_KIND)

DEFAULT_TIMEOUT_S = 10.0


class AdmissionWebhookError(ApiError):
    code = 500
    reason = "InternalError"


def _unescape(token: str) -> str:
    return token.replace("~1", "/").replace("~0", "~")


def apply_json_patch(obj: dict, ops: list[dict]) -> dict:
    """RFC 6902 add/remove/replace (the ops AdmissionServer emits). A
    ``remove`` whose intermediate path is absent is a no-op instead of
    grafting empty maps into the object (can happen when webhook patches
    race each other)."""
    result = copy.deepcopy(obj)
    for op in ops:
        tokens = [_unescape(t) for t in op["path"].split("/")[1:]]
        verb = op["op"]
        parent = result
        missing = False
        for token in tokens[:-1]:
            if isinstance(parent, list):
                parent = parent[int(token)]
            elif token in parent:
                parent = parent[token]
            elif verb == "remove":
                missing = True
                break
            else:
                parent = parent.setdefault(token, {})
        if missing:
            continue
        leaf = tokens[-1] if tokens else ""
        if isinstance(parent, list):
            index = len(parent) if leaf == "-" else int(leaf)
            if verb == "add":
                parent.insert(index, op["value"])
            elif verb == "remove":
                del parent[index]
            else:
                parent[index] = op["value"]
        else:
            if verb == "remove":
                parent.pop(leaf, None)
            else:
                parent[leaf] = op["value"]
    return result


def _rule_matches(rule: dict, kind: str, operation: str,
                  api_version: str = "") -> bool:
    try:
        mapping = restmapper.mapping_for(kind)
    except KeyError:
        return False
    group, _version = mapping.group_version
    groups = rule.get("apiGroups", ["*"])
    if "*" not in groups and group not in groups:
        return False
    resources = rule.get("resources", ["*"])
    if "*" not in resources and mapping.plural not in resources:
        return False
    versions = rule.get("apiVersions", ["*"])
    version = api_version.rpartition("/")[2] if api_version else ""
    if "*" not in versions and version and version not in versions:
        return False
    operations = rule.get("operations", ["*"])
    return "*" in operations or operation in operations


_ssl_cache: dict[str, ssl.SSLContext] = {}


def _ssl_context(ca_bundle_b64: str | None) -> ssl.SSLContext | None:
    """Per-caBundle cached context built from cadata — no temp files, no
    per-call context construction (admission runs on every store write)."""
    if not ca_bundle_b64:
        return None
    ctx = _ssl_cache.get(ca_bundle_b64)
    if ctx is None:
        pem = base64.b64decode(ca_bundle_b64).decode()
        ctx = ssl.create_default_context(cadata=pem)
        _ssl_cache[ca_bundle_b64] = ctx
    return ctx


def _call(url: str, review: dict, ca_bundle_b64: str | None,
          timeout: float) -> dict:
    req = urllib.request.Request(
        url, data=json.dumps(review).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout,
                                context=_ssl_context(ca_bundle_b64)) as resp:
        return json.loads(resp.read())


def run_webhooks(configs: list[dict], operation: str, obj: dict,
                 old: dict | None, *, mutating: bool,
                 timeout: float = DEFAULT_TIMEOUT_S) -> dict:
    """Run every matching webhook of the given phase; returns the (possibly
    mutated) object, raises ApiError on denial/hard failure."""
    kind = k8s.kind(obj)
    api_version = obj.get("apiVersion", "")
    for config in configs:
        for webhook in config.get("webhooks", []) or []:
            if not any(_rule_matches(rule, kind, operation, api_version)
                       for rule in webhook.get("rules", []) or []):
                continue
            client_config = webhook.get("clientConfig", {}) or {}
            url = client_config.get("url")
            fail_open = webhook.get("failurePolicy", "Fail") == "Ignore"
            if not url:
                log.info("webhook %s has service-based clientConfig; the "
                         "standalone facade has no cluster DNS — skipping "
                         "(a real apiserver resolves it)",
                         webhook.get("name"))
                continue
            review = {
                "apiVersion": "admission.k8s.io/v1",
                "kind": "AdmissionReview",
                "request": {
                    "uid": f"{k8s.namespace(obj)}.{k8s.name(obj)}.{operation}",
                    "operation": operation,
                    "object": obj,
                    "oldObject": old,
                },
            }
            try:
                answer = _call(url, review, client_config.get("caBundle"),
                               timeout)
            except (urllib.error.URLError, OSError, ValueError) as exc:
                if fail_open:
                    log.warning("webhook %s unreachable (%s); failurePolicy="
                                "Ignore — admitting", webhook.get("name"), exc)
                    continue
                raise AdmissionWebhookError(
                    f"calling webhook {webhook.get('name')}: {exc}") from exc
            response = (answer or {}).get("response", {}) or {}
            if not response.get("allowed", False):
                status = response.get("status", {}) or {}
                err = InvalidError(status.get(
                    "message", f"denied by webhook {webhook.get('name')}"))
                err.code = status.get("code", 400)
                raise err
            if mutating and response.get("patch"):
                ops = json.loads(base64.b64decode(response["patch"]))
                obj = apply_json_patch(obj, ops)
    return obj
