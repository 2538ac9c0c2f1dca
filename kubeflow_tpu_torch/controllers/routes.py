"""Gateway-API routing for notebooks.

The port's copy of ``kubeflow_tpu/controllers/routes.py`` (the port
imports nothing of the JAX package), with the same names, objects
and writes.

Reference: odh notebook_route.go:51-325 + notebook_referencegrant.go:39-184.
HTTPRoutes live in the CENTRAL (controller) namespace — the Gateway only
trusts routes there — so ownership is by label (no cross-namespace ownerRef)
and cleanup is finalizer-driven. A per-user-namespace ReferenceGrant lets the
central routes target the user-namespace Services; it is shared by all
notebooks in the namespace and deleted with the last one."""

from __future__ import annotations

from ..api import types as api
from ..cluster import errors
from ..utils import k8s, names
from ..utils.config import ControllerConfig
from .auth import tls_service_name

# API effect contract: what this module reads, watches and writes,
# kept as data as the reference declares it (its ci/effects.py
# checks the reference's copy); update it with the code.
CONTRACT = {
    "role": "helper",
    "reads": ["HTTPRoute", "Notebook", "ReferenceGrant"],
    "watches": [],
    "writes": {
        "HTTPRoute": ["create", "delete", "update"],
        "ReferenceGrant": ["create", "delete", "update"],
    },
    "annotations": ["MANAGED_BY_LABEL", "NOTEBOOK_NAME_LABEL"],
}


ROUTE_NAMESPACE_LABEL = "notebook-namespace"
REFERENCE_GRANT_NAME = "notebook-httproute-access"


def new_httproute(notebook: dict, config: ControllerConfig, *,
                  auth: bool) -> dict:
    """Central-namespace HTTPRoute ``nb-<ns>-<name>`` (63-char GenerateName
    fallback, notebook_route.go:51-77) routing
    ``/notebook/<ns>/<name>`` to the user-namespace Service — port 443/8443
    to the auth sidecar in auth mode, port 80 to Jupyter otherwise."""
    nb_name = k8s.name(notebook)
    ns = k8s.namespace(notebook)
    route_name, use_generate = names.route_name_for_notebook(ns, nb_name)
    backend = {
        "kind": "Service",
        "namespace": ns,
        "name": tls_service_name(nb_name) if auth else nb_name,
        "port": 443 if auth else 80,
    }
    route = {
        "apiVersion": "gateway.networking.k8s.io/v1",
        "kind": "HTTPRoute",
        "metadata": {
            "namespace": config.controller_namespace,
            "labels": {
                names.NOTEBOOK_NAME_LABEL: nb_name,
                ROUTE_NAMESPACE_LABEL: ns,
                "notebook-auth": "true" if auth else "false",
            },
        },
        "spec": {
            "parentRefs": [{
                "name": config.gateway_name,
                "namespace": config.gateway_namespace,
            }],
            "rules": [{
                "matches": [{"path": {
                    "type": "PathPrefix",
                    "value": names.nb_prefix(ns, nb_name),
                }}],
                "backendRefs": [backend],
            }],
        },
    }
    if use_generate:
        route["metadata"]["generateName"] = route_name
    else:
        route["metadata"]["name"] = route_name
    return route


def find_routes(client, config: ControllerConfig,
                notebook: dict) -> list[dict]:
    return client.list("HTTPRoute", config.controller_namespace, {
        names.NOTEBOOK_NAME_LABEL: k8s.name(notebook),
        ROUTE_NAMESPACE_LABEL: k8s.namespace(notebook),
    })


def reconcile_httproute(client, config: ControllerConfig, notebook: dict, *,
                        auth: bool) -> None:
    """Create/repair the route; delete a conflicting other-mode route first
    (auth↔plain switches, reference EnsureConflictingHTTPRouteAbsent,
    :268-325)."""
    desired = new_httproute(notebook, config, auth=auth)
    existing = find_routes(client, config, notebook)
    keep = None
    for route in existing:
        mode = k8s.get_label(route, "notebook-auth")
        if mode == ("true" if auth else "false") and keep is None:
            keep = route
        else:
            try:
                client.delete("HTTPRoute", config.controller_namespace,
                              k8s.name(route))
            except errors.NotFoundError:
                pass
    if keep is None:
        try:
            client.create(desired)
        except errors.AlreadyExistsError:
            pass
        return
    changed = False
    if keep.get("spec") != desired["spec"]:
        keep["spec"] = k8s.deepcopy(desired["spec"])
        changed = True
    if k8s.merge_managed_labels(keep, desired["metadata"]["labels"]):
        changed = True
    if changed:
        client.update(keep)


def delete_routes_for_notebook(client, config: ControllerConfig,
                               notebook: dict) -> None:
    """Deletion branch (reference DeleteHTTPRouteForNotebook, :230-266)."""
    for route in find_routes(client, config, notebook):
        try:
            client.delete("HTTPRoute", config.controller_namespace,
                          k8s.name(route))
        except errors.NotFoundError:
            pass


# ----------------------------------------------------------- ReferenceGrant
def new_reference_grant(namespace: str, config: ControllerConfig) -> dict:
    return {
        "apiVersion": "gateway.networking.k8s.io/v1beta1",
        "kind": "ReferenceGrant",
        "metadata": {
            "name": REFERENCE_GRANT_NAME,
            "namespace": namespace,
            "labels": {names.MANAGED_BY_LABEL: "workbenches"},
        },
        "spec": {
            "from": [{
                "group": "gateway.networking.k8s.io",
                "kind": "HTTPRoute",
                "namespace": config.controller_namespace,
            }],
            "to": [{"group": "", "kind": "Service"}],
        },
    }


def reconcile_reference_grant(client, config: ControllerConfig,
                              notebook: dict) -> None:
    ns = k8s.namespace(notebook)
    desired = new_reference_grant(ns, config)
    existing = client.get_or_none("ReferenceGrant", ns, REFERENCE_GRANT_NAME)
    if existing is None:
        try:
            client.create(desired)
        except errors.AlreadyExistsError:
            pass
        return
    # repair spec AND label drift (reference reconciles both,
    # odh notebook_controller_test.go:225-271) without clobbering
    # foreign labels
    labels_changed = k8s.merge_managed_labels(
        existing, desired["metadata"]["labels"])
    if existing.get("spec") != desired["spec"] or labels_changed:
        existing["spec"] = k8s.deepcopy(desired["spec"])
        client.update(existing)


def delete_reference_grant_if_last_notebook(client, config: ControllerConfig,
                                            notebook: dict) -> None:
    """The grant is namespace-shared: only the LAST notebook being deleted
    removes it (reference isLastNotebookInNamespace, :130-184)."""
    ns = k8s.namespace(notebook)
    others = [nb for nb in client.list(api.KIND, ns)
              if k8s.name(nb) != k8s.name(notebook)
              and not k8s.is_deleting(nb)]
    if others:
        return
    try:
        client.delete("ReferenceGrant", ns, REFERENCE_GRANT_NAME)
    except errors.NotFoundError:
        pass
