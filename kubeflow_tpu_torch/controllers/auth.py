"""Per-notebook auth-proxy resources.

The port's copy of ``kubeflow_tpu/controllers/auth.py`` (the port
imports nothing of the JAX package), with the same names, objects
and writes.

Reference: odh notebook_kube_rbac_auth.go:34-368 — when a notebook opts into
auth (``inject-auth`` annotation), the extension reconciler provisions, per
notebook: a ServiceAccount, a TLS Service (serving-cert annotation), a
SubjectAccessReview config ConfigMap, and a cluster-scoped
``system:auth-delegator`` ClusterRoleBinding (cleaned up manually via
finalizer — cluster-scoped objects can't be GC'd from a namespaced owner)."""

from __future__ import annotations

from ..utils import k8s, names

# API effect contract: what this module reads, watches and writes,
# kept as data as the reference declares it (its ci/effects.py
# checks the reference's copy); update it with the code.
CONTRACT = {
    "role": "generator",
    "reads": [],
    "watches": [],
    "writes": {},
    "annotations": ["NOTEBOOK_NAME_LABEL", "SERVING_CERT_SECRET_ANNOTATION"],
}


def sa_name(nb_name: str) -> str:
    return f"{nb_name}-auth-sa"[:63]


def tls_service_name(nb_name: str) -> str:
    return f"{nb_name}-tls"[:63]


def rbac_config_name(nb_name: str) -> str:
    return f"{nb_name}-rbac-config"[:63]


def crb_name(namespace: str, nb_name: str) -> str:
    return f"nb-auth-delegator-{namespace}-{nb_name}"[:63]


def new_service_account(notebook: dict) -> dict:
    sa = {
        "apiVersion": "v1",
        "kind": "ServiceAccount",
        "metadata": {
            "name": sa_name(k8s.name(notebook)),
            "namespace": k8s.namespace(notebook),
            "labels": {names.NOTEBOOK_NAME_LABEL: k8s.name(notebook)},
        },
    }
    k8s.set_controller_reference(notebook, sa)
    return sa


def new_tls_service(notebook: dict) -> dict:
    """Service fronting the auth sidecar on 8443; the serving-cert annotation
    asks the platform CA to mint the TLS secret the sidecar mounts
    (reference notebook_kube_rbac_auth.go:104)."""
    nb_name = k8s.name(notebook)
    svc = {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {
            "name": tls_service_name(nb_name),
            "namespace": k8s.namespace(notebook),
            "labels": {names.NOTEBOOK_NAME_LABEL: nb_name},
            "annotations": {
                names.SERVING_CERT_SECRET_ANNOTATION:
                    f"{nb_name}-tls",
            },
        },
        "spec": {
            "type": "ClusterIP",
            "selector": {"statefulset": nb_name},
            "ports": [{"name": "auth-proxy", "port": 443,
                       "targetPort": 8443, "protocol": "TCP"}],
        },
    }
    k8s.set_controller_reference(notebook, svc)
    return svc


def new_rbac_config_map(notebook: dict) -> dict:
    """SubjectAccessReview config: access to the proxy requires ``get`` on
    this notebook CR (reference :181-187)."""
    nb_name = k8s.name(notebook)
    ns = k8s.namespace(notebook)
    sar = (f'{{"authorization":{{"resourceAttributes":{{'
           f'"apiGroup":"kubeflow.org","resource":"notebooks",'
           f'"subresource":"","namespace":"{ns}","name":"{nb_name}",'
           f'"verb":"get"}}}}}}')
    cm = {
        "apiVersion": "v1",
        "kind": "ConfigMap",
        "metadata": {
            "name": rbac_config_name(nb_name),
            "namespace": ns,
            "labels": {names.NOTEBOOK_NAME_LABEL: nb_name},
        },
        "data": {f"{nb_name}-rbac-config.yaml": sar},
    }
    k8s.set_controller_reference(notebook, cm)
    return cm


def new_auth_delegator_crb(notebook: dict) -> dict:
    """Cluster-scoped binding letting the sidecar perform TokenReview/SAR
    (system:auth-delegator). No ownerRef possible across scope — deletion is
    finalizer-driven (reference CleanupKubeRbacProxyClusterRoleBinding,
    :346-368)."""
    nb_name = k8s.name(notebook)
    ns = k8s.namespace(notebook)
    return {
        "apiVersion": "rbac.authorization.k8s.io/v1",
        "kind": "ClusterRoleBinding",
        "metadata": {
            "name": crb_name(ns, nb_name),
            "labels": {
                names.NOTEBOOK_NAME_LABEL: nb_name,
                "notebook-namespace": ns,
            },
        },
        "roleRef": {
            "apiGroup": "rbac.authorization.k8s.io",
            "kind": "ClusterRole",
            "name": "system:auth-delegator",
        },
        "subjects": [{
            "kind": "ServiceAccount",
            "name": sa_name(nb_name),
            "namespace": ns,
        }],
    }
