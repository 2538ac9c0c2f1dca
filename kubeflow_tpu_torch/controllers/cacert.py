"""CA-bundle ConfigMap reconciliation.

The port's copy of ``kubeflow_tpu/controllers/cacert.py`` (the port
imports nothing of the JAX package), with the same names, objects
and writes.

Reference: odh notebook_controller.go:533-733 — merge the cluster trust
sources (``odh-trusted-ca-bundle`` from the controller namespace,
``kube-root-ca.crt`` and ``openshift-service-ca.crt`` from the user
namespace) into a per-namespace ``workbench-trusted-ca-bundle`` ConfigMap,
validating PEM certificate blocks and dropping garbage instead of poisoning
the bundle. The webhook mounts the result (webhook/mutating.py)."""

from __future__ import annotations

import base64
import binascii
import logging

from ..cluster import errors
from ..utils import k8s, names

# API effect contract: what this module reads, watches and writes,
# kept as data as the reference declares it (its ci/effects.py
# checks the reference's copy); update it with the code.
CONTRACT = {
    "role": "helper",
    "reads": ["ConfigMap"],
    "watches": [],
    "writes": {
        "ConfigMap": ["create", "delete", "update"],
    },
    "annotations": ["MANAGED_BY_LABEL"],
}


log = logging.getLogger("kubeflow_tpu_torch.cacert")

TRUSTED_CA_BUNDLE = "odh-trusted-ca-bundle"
KUBE_ROOT_CA = "kube-root-ca.crt"
SERVICE_CA = "openshift-service-ca.crt"
WORKBENCH_BUNDLE = "workbench-trusted-ca-bundle"

_BEGIN = "-----BEGIN CERTIFICATE-----"
_END = "-----END CERTIFICATE-----"


def extract_valid_pem_blocks(data: str) -> list[str]:
    """Return the structurally valid PEM certificate blocks in ``data`` —
    BEGIN/END framing with base64-decodable body (the reference runs
    pem.Decode + x509.ParseCertificate per block)."""
    blocks: list[str] = []
    rest = data or ""
    while True:  # bounded: rest strictly shrinks past each END marker
        start = rest.find(_BEGIN)
        if start < 0:
            break
        end = rest.find(_END, start)
        if end < 0:
            break
        body = rest[start + len(_BEGIN):end]
        rest = rest[end + len(_END):]
        try:
            raw = base64.b64decode("".join(body.split()), validate=True)
        except (binascii.Error, ValueError):
            log.warning("dropping malformed PEM block from CA bundle")
            continue
        if not raw:
            continue
        blocks.append(f"{_BEGIN}{body}{_END}")
    return blocks


def build_workbench_bundle(client, controller_namespace: str,
                           user_namespace: str) -> str | None:
    """Merge the trust sources; None means no valid material exists (the
    per-namespace bundle should then be deleted)."""
    parts: list[str] = []
    sources = (
        ("ConfigMap", controller_namespace, TRUSTED_CA_BUNDLE,
         ("ca-bundle.crt", "odh-ca-bundle.crt")),
        ("ConfigMap", user_namespace, KUBE_ROOT_CA, ("ca.crt",)),
        ("ConfigMap", user_namespace, SERVICE_CA, ("service-ca.crt",)),
    )
    for kind, ns, name, keys in sources:
        cm = client.get_or_none(kind, ns, name)
        if cm is None:
            continue
        for key in keys:
            parts.extend(extract_valid_pem_blocks(
                k8s.get_in(cm, "data", key, default="")))
    if not parts:
        return None
    # de-duplicate preserving order (sources overlap in practice)
    seen: set[str] = set()
    unique = [p for p in parts if not (p in seen or seen.add(p))]
    return "\n".join(unique) + "\n"


def reconcile_ca_bundle(client, controller_namespace: str,
                        user_namespace: str) -> None:
    """Create/update/delete the per-namespace workbench bundle
    (reference CreateNotebookCertConfigMap)."""
    bundle = build_workbench_bundle(client, controller_namespace,
                                    user_namespace)
    existing = client.get_or_none("ConfigMap", user_namespace,
                                  WORKBENCH_BUNDLE)
    if bundle is None:
        if existing is not None:
            try:
                client.delete("ConfigMap", user_namespace, WORKBENCH_BUNDLE)
            except errors.NotFoundError:
                pass  # another worker's reconcile got there first
        return
    desired_data = {"ca-bundle.crt": bundle}
    if existing is None:
        try:
            client.create({
                "apiVersion": "v1",
                "kind": "ConfigMap",
                "metadata": {
                    "name": WORKBENCH_BUNDLE,
                    "namespace": user_namespace,
                    "labels": {names.MANAGED_BY_LABEL: "workbenches"},
                },
                "data": desired_data,
            })
        except errors.AlreadyExistsError:
            pass  # two notebooks of one namespace reconciling in parallel
    elif existing.get("data") != desired_data:
        existing["data"] = desired_data
        try:
            client.update(existing)
        except errors.ConflictError:
            pass  # a parallel worker refreshed the same bundle; converged
