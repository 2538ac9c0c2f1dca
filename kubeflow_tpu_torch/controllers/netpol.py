"""Per-notebook NetworkPolicies.

The port's copy of ``kubeflow_tpu/controllers/netpol.py`` (the port
imports nothing of the JAX package), with the same names, objects
and writes.

Reference: odh notebook_network.go:42-211 — the notebook policy allows
ingress to Jupyter (8888) only from the controller namespace (traffic must
come through the Gateway/central routes); the auth-proxy policy exposes 8443
to everything (the sidecar itself authenticates)."""

from __future__ import annotations

from ..cluster import errors
from ..utils import k8s, names

# API effect contract: what this module reads, watches and writes,
# kept as data as the reference declares it (its ci/effects.py
# checks the reference's copy); update it with the code.
CONTRACT = {
    "role": "helper",
    "reads": ["NetworkPolicy"],
    "watches": [],
    "writes": {
        "NetworkPolicy": ["create", "delete", "update"],
    },
    "annotations": ["NAMESPACE_NAME_LABEL", "NOTEBOOK_NAME_LABEL"],
}


def notebook_policy_name(nb_name: str) -> str:
    return f"{nb_name}-ctrl-np"[:63]


def auth_policy_name(nb_name: str) -> str:
    return f"{nb_name}-auth-np"[:63]


def new_notebook_network_policy(notebook: dict,
                                controller_namespace: str) -> dict:
    nb_name = k8s.name(notebook)
    np = {
        "apiVersion": "networking.k8s.io/v1",
        "kind": "NetworkPolicy",
        "metadata": {
            "name": notebook_policy_name(nb_name),
            "namespace": k8s.namespace(notebook),
            "labels": {names.NOTEBOOK_NAME_LABEL: nb_name},
        },
        "spec": {
            "podSelector": {"matchLabels": {"statefulset": nb_name}},
            "policyTypes": ["Ingress"],
            "ingress": [{
                "from": [{"namespaceSelector": {"matchLabels": {
                    names.NAMESPACE_NAME_LABEL: controller_namespace,
                }}}],
                "ports": [{"protocol": "TCP", "port": 8888}],
            }],
        },
    }
    k8s.set_controller_reference(notebook, np)
    return np


def new_auth_proxy_network_policy(notebook: dict) -> dict:
    nb_name = k8s.name(notebook)
    np = {
        "apiVersion": "networking.k8s.io/v1",
        "kind": "NetworkPolicy",
        "metadata": {
            "name": auth_policy_name(nb_name),
            "namespace": k8s.namespace(notebook),
            "labels": {names.NOTEBOOK_NAME_LABEL: nb_name},
        },
        "spec": {
            "podSelector": {"matchLabels": {"statefulset": nb_name}},
            "policyTypes": ["Ingress"],
            "ingress": [{
                "ports": [{"protocol": "TCP", "port": 8443}],
            }],
        },
    }
    k8s.set_controller_reference(notebook, np)
    return np


def reconcile_network_policies(client, notebook: dict,
                               controller_namespace: str, *,
                               auth: bool) -> None:
    ns = k8s.namespace(notebook)
    desired = [new_notebook_network_policy(notebook, controller_namespace)]
    if auth:
        desired.append(new_auth_proxy_network_policy(notebook))
    elif client.get_or_none("NetworkPolicy", ns,
                            auth_policy_name(k8s.name(notebook))) is not None:
        # existence-check first: NetworkPolicy is watch-cached, so the
        # check is free — a blind delete is a wire DELETE-404 on every
        # no-auth reconcile
        try:
            client.delete("NetworkPolicy", ns,
                          auth_policy_name(k8s.name(notebook)))
        except errors.NotFoundError:
            pass
    for np in desired:
        existing = client.get_or_none("NetworkPolicy", ns, k8s.name(np))
        if existing is None:
            try:
                client.create(np)
            except errors.AlreadyExistsError:
                pass
        elif existing.get("spec") != np["spec"]:
            existing["spec"] = k8s.deepcopy(np["spec"])
            client.update(existing)
