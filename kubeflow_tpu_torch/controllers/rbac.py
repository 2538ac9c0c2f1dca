"""RBAC integrations: pipelines (Elyra) and MLflow.

The port's copy of ``kubeflow_tpu/controllers/rbac.py`` (the port
imports nothing of the JAX package), with the same names, objects
and writes.

Reference: odh notebook_rbac.go:36-154 (``elyra-pipelines-<name>``
RoleBinding to Role ``ds-pipeline-user-access-dspa``, gated by
SET_PIPELINE_RBAC, with a role-exists precheck) and notebook_mlflow.go:35-330
(annotation-gated RoleBinding to the MLflow integration ClusterRole with a
30 s requeue until the ClusterRole exists)."""

from __future__ import annotations

from ..cluster import errors
from ..utils import k8s, names

# API effect contract: what this module reads, watches and writes,
# kept as data as the reference declares it (its ci/effects.py
# checks the reference's copy); update it with the code.
CONTRACT = {
    "role": "helper",
    "reads": ["ClusterRole", "Role", "RoleBinding"],
    "watches": [],
    "writes": {
        "Event": ["create"],
        "RoleBinding": ["create", "delete", "update"],
    },
    "annotations": ["MLFLOW_INSTANCE_ANNOTATION", "NOTEBOOK_NAME_LABEL"],
}


PIPELINE_ROLE = "ds-pipeline-user-access-dspa"
MLFLOW_CLUSTER_ROLE = "mlflow-operator-mlflow-integration"
MLFLOW_IDENTIFIER = "mlflow"
MLFLOW_TRACKING_AUTH_VALUE = "kubernetes-namespaced"
MLFLOW_REQUEUE_SECONDS = 30.0


def get_mlflow_tracking_uri(client, config, instance: str) -> str | None:
    """Tracking URI for an MLflow instance (reference getMLflowTrackingURI,
    notebook_mlflow.go:100-143): the configured GATEWAY_URL bypasses Gateway
    lookup; otherwise the hostname comes from the Gateway→Route discovery
    chain. Path segment is ``mlflow`` for the default instance, else
    ``mlflow-<instance>``; a hostname without a scheme gets ``https://``
    prepended, an existing http(s) scheme is preserved. Returns None when
    no hostname is determinable (caller skips URI injection)."""
    from . import elyra

    hostname = config.gateway_url
    if not hostname:
        hostname = elyra.discover_public_hostname(client, config)
    if not hostname:
        return None
    segment = MLFLOW_IDENTIFIER
    if instance and instance != MLFLOW_IDENTIFIER:
        segment = f"{MLFLOW_IDENTIFIER}-{instance}"
    if hostname.startswith(("https://", "http://")):
        return f"{hostname}/{segment}"
    return f"https://{hostname}/{segment}"


def pipeline_rb_name(nb_name: str) -> str:
    return f"elyra-pipelines-{nb_name}"[:63]


def mlflow_rb_name(nb_name: str) -> str:
    return f"mlflow-access-{nb_name}"[:63]


def new_pipeline_role_binding(notebook: dict) -> dict:
    nb_name = k8s.name(notebook)
    rb = {
        "apiVersion": "rbac.authorization.k8s.io/v1",
        "kind": "RoleBinding",
        "metadata": {
            "name": pipeline_rb_name(nb_name),
            "namespace": k8s.namespace(notebook),
            "labels": {names.NOTEBOOK_NAME_LABEL: nb_name},
        },
        "roleRef": {
            "apiGroup": "rbac.authorization.k8s.io",
            "kind": "Role",
            "name": PIPELINE_ROLE,
        },
        "subjects": [{
            "kind": "ServiceAccount",
            "name": "default",
            "namespace": k8s.namespace(notebook),
        }],
    }
    k8s.set_controller_reference(notebook, rb)
    return rb


def reconcile_pipeline_rbac(client, notebook: dict) -> None:
    """Create the binding only when the Role exists in the namespace
    (reference checkRoleExists precheck)."""
    ns = k8s.namespace(notebook)
    if client.get_or_none("Role", ns, PIPELINE_ROLE) is None:
        return
    desired = new_pipeline_role_binding(notebook)
    existing = client.get_or_none("RoleBinding", ns, k8s.name(desired))
    if existing is None:
        try:
            client.create(desired)
        except errors.AlreadyExistsError:
            pass


def new_mlflow_role_binding(notebook: dict) -> dict:
    nb_name = k8s.name(notebook)
    rb = {
        "apiVersion": "rbac.authorization.k8s.io/v1",
        "kind": "RoleBinding",
        "metadata": {
            "name": mlflow_rb_name(nb_name),
            "namespace": k8s.namespace(notebook),
            "labels": {names.NOTEBOOK_NAME_LABEL: nb_name},
        },
        "roleRef": {
            "apiGroup": "rbac.authorization.k8s.io",
            "kind": "ClusterRole",
            "name": MLFLOW_CLUSTER_ROLE,
        },
        "subjects": [{
            "kind": "ServiceAccount",
            "name": "default",
            "namespace": k8s.namespace(notebook),
        }],
    }
    k8s.set_controller_reference(notebook, rb)
    return rb


def reconcile_mlflow_integration(client, notebook: dict,
                                 recorder=None) -> float | None:
    """Returns a requeue delay when the ClusterRole is absent (reference
    requeues every 30 s until the MLflow operator installs it, recording a
    Warning event on the CR, notebook_mlflow.go:236-270); None when converged
    or not requested."""
    ns = k8s.namespace(notebook)
    # trimmed, like the webhook (reference getMLflowInstanceAnnotation) —
    # a whitespace-only value must not diverge between the two paths
    instance = (k8s.get_annotation(
        notebook, names.MLFLOW_INSTANCE_ANNOTATION) or "").strip()
    if not instance:
        try:
            client.delete("RoleBinding", ns,
                          mlflow_rb_name(k8s.name(notebook)))
        except errors.NotFoundError:
            pass
        return None
    if client.get_or_none("ClusterRole", "", MLFLOW_CLUSTER_ROLE) is None:
        if recorder is not None:
            recorder.eventf(
                notebook, "Warning", "MLflowClusterRolePending",
                'Waiting for MLflow ClusterRole "%s" to be created'
                % MLFLOW_CLUSTER_ROLE)
        return MLFLOW_REQUEUE_SECONDS
    desired = new_mlflow_role_binding(notebook)
    existing = client.get_or_none("RoleBinding", ns, k8s.name(desired))
    if existing is None:
        try:
            client.create(desired)
        except errors.AlreadyExistsError:
            pass
        return None
    # repair drift in subjects/labels/ownerRefs in place, preserving
    # resourceVersion (reference needsUpdate, notebook_mlflow.go:336-357;
    # roleRef is immutable so it is never touched)
    labels_changed = k8s.merge_managed_labels(
        existing, desired["metadata"]["labels"])
    if existing.get("subjects") != desired["subjects"] or labels_changed \
            or k8s.get_in(existing, "metadata", "ownerReferences") != \
            desired["metadata"]["ownerReferences"]:
        existing["subjects"] = desired["subjects"]
        existing["metadata"]["ownerReferences"] = \
            desired["metadata"]["ownerReferences"]
        client.update(existing)
    return None
