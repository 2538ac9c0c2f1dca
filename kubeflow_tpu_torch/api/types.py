"""Notebook CRD types.

A copy of ``kubeflow_tpu/api/types.py`` (the port imports nothing of the
JAX package). Reference shape: components/notebook-controller/api/v1/
notebook_types.go:27-88, ``Notebook{Spec{Template{Spec: corev1.PodSpec}},
Status{Conditions, ReadyReplicas, ContainerState}}`` with kubeflow.org/v1
as the storage version. The slice request rides the annotations
``tpu.kubeflow.org/accelerator`` / ``tpu.kubeflow.org/topology`` (for the
port an H100 shape such as ``h100-16``), so a Notebook CR applies to
either package unchanged.

``notebook_crd`` is the Notebook CRD (the reference's
``kubeflow_tpu/deploy/manifests.py`` ``notebook_crd``, its one manifest
the port needs): v1 stored, v1beta1 and v1alpha1 served, each with the
structural schema of ``api/schema.py``. ``install_notebook_crd`` creates
it in a store, which then validates every Notebook write against it, and
registers the typed admission: ``validate_notebook``, then
``convert_notebook`` to the storage version.
"""

from __future__ import annotations

from typing import Any

from ..cluster.errors import InvalidError
from ..utils import k8s

GROUP = "kubeflow.org"
VERSION = "v1"
API_VERSION = f"{GROUP}/{VERSION}"
KIND = "Notebook"

# served versions (reference notebook-controller/main.go:48-56); v1 is the
# storage version (api/v1/notebook_types.go:67-68)
SERVED_VERSIONS = ("v1", "v1beta1", "v1alpha1")
STORAGE_VERSION = VERSION

# condition types mirrored into status from the pod (reference
# notebook_controller.go:299-374 mirrors pod conditions verbatim)
CONDITION_RUNNING = "Running"
CONDITION_WAITING = "Waiting"
CONDITION_READY = "Ready"
# aggregate condition: every worker of the slice is ready
CONDITION_SLICE_READY = "SliceReady"
# the slice health & repair state, mirrored into status beside SliceReady:
# "Slice" + the state carried in the tpu.kubeflow.org/slice-health
# annotation
CONDITION_SLICE_DEGRADED = "SliceDegraded"
CONDITION_SLICE_REPAIRING = "SliceRepairing"
CONDITION_SLICE_QUARANTINED = "SliceQuarantined"
SLICE_HEALTH_STATES = ("Degraded", "Repairing", "Quarantined")
# True while a pool-owned warm slice serves the notebook; False with
# reason Migrating while a checkpoint migration re-binds it
CONDITION_POOL_BOUND = "PoolBound"


def new_notebook(name: str, namespace: str, *,
                 image: str = "jupyter-minimal:latest",
                 annotations: dict[str, str] | None = None,
                 labels: dict[str, str] | None = None,
                 containers: list[dict] | None = None,
                 pod_spec_extra: dict | None = None) -> dict:
    """Build a Notebook CR in wire form."""
    if containers is None:
        containers = [{"name": name, "image": image}]
    pod_spec: dict[str, Any] = {"containers": containers}
    if pod_spec_extra:
        pod_spec.update(pod_spec_extra)
    nb = {
        "apiVersion": API_VERSION,
        "kind": KIND,
        "metadata": {"name": name, "namespace": namespace},
        "spec": {"template": {"spec": pod_spec}},
        "status": {},
    }
    if annotations:
        nb["metadata"]["annotations"] = dict(annotations)
    if labels:
        nb["metadata"]["labels"] = dict(labels)
    return nb


def notebook_pod_spec(notebook: dict) -> dict:
    return k8s.get_in(notebook, "spec", "template", "spec", default={}) or {}


# the notebook container convention the webhook and the reconcilers share
pod_spec_notebook_container = k8s.pod_spec_notebook_container
notebook_container = k8s.notebook_container


def parse_version(notebook: dict) -> str:
    """The CR's version ("v1"), validated against the served set."""
    api_version = notebook.get("apiVersion") or ""
    group, _, version = api_version.partition("/")
    if group != GROUP or version not in SERVED_VERSIONS:
        served = ", ".join(f"{GROUP}/{v}" for v in SERVED_VERSIONS)
        raise InvalidError(f"apiVersion must be one of: {served}")
    return version


def convert_notebook(notebook: dict, to_version: str = STORAGE_VERSION) -> dict:
    """Convert a Notebook between served versions. The schemas are
    identical, so this is an apiVersion rewrite (the same object when it
    is already at ``to_version``)."""
    parse_version(notebook)
    if to_version not in SERVED_VERSIONS:
        raise InvalidError(f"unknown version {to_version!r}")
    target = f"{GROUP}/{to_version}"
    if notebook.get("apiVersion") == target:
        return notebook
    converted = k8s.deepcopy(notebook)
    converted["apiVersion"] = target
    return converted


def validate_notebook(notebook: dict) -> None:
    """Structural validation the CRD schema would enforce."""
    if k8s.kind(notebook) != KIND:
        raise InvalidError(f"kind must be {KIND}")
    parse_version(notebook)
    md = k8s.meta(notebook)
    # admission runs before the apiserver expands generateName, so an empty
    # name is valid when generateName is set (as on a real apiserver)
    if not md.get("name") and not md.get("generateName"):
        raise InvalidError("metadata.name required")
    containers = notebook_pod_spec(notebook).get("containers")
    if not isinstance(containers, list) or not containers:
        raise InvalidError("spec.template.spec.containers must be a "
                           "non-empty list")
    for c in containers:
        if not isinstance(c, dict) or not c.get("name") or not c.get("image"):
            raise InvalidError("containers require name and image")


def get_condition(notebook: dict, cond_type: str) -> dict | None:
    for c in k8s.get_in(notebook, "status", "conditions", default=[]) or []:
        if c.get("type") == cond_type:
            return c
    return None


# ----------------------------------------------------------------- CRD
CRD_NAME = f"notebooks.{GROUP}"


def _condition_schema() -> dict:
    return {
        "type": "object",
        "properties": {
            "type": {"type": "string"},
            "status": {"type": "string"},
            "reason": {"type": "string"},
            "message": {"type": "string"},
            "lastProbeTime": {"type": "string", "format": "date-time"},
            "lastTransitionTime": {"type": "string", "format": "date-time"},
        },
        "required": ["type", "status"],
    }


def _notebook_schema() -> dict:
    """The storage schema: spec wraps a PodSpec template, typed by
    ``api/schema.py`` so a malformed container is rejected server-side;
    semantic checks stay in the validating webhook."""
    from . import schema
    return {
        "openAPIV3Schema": {
            "type": "object",
            "properties": {
                "spec": {
                    "type": "object",
                    "required": ["template"],
                    "properties": {
                        "template": {
                            "type": "object",
                            "required": ["spec"],
                            "properties": {
                                "spec": schema.pod_spec_schema(),
                            },
                        },
                    },
                },
                "status": {
                    "type": "object",
                    "properties": {
                        "conditions": {"type": "array",
                                       "items": _condition_schema()},
                        "readyReplicas": {"type": "integer",
                                          "format": "int32"},
                        "containerState": {
                            "type": "object",
                            "x-kubernetes-preserve-unknown-fields": True,
                        },
                    },
                },
            },
        },
    }


def notebook_crd() -> dict:
    """The Notebook CustomResourceDefinition: v1 the storage version,
    v1beta1 and v1alpha1 served with the same schema."""
    versions = []
    for version in SERVED_VERSIONS:
        versions.append({
            "name": version,
            "served": True,
            "storage": version == STORAGE_VERSION,
            "schema": _notebook_schema(),
            "subresources": {"status": {}},
            "additionalPrinterColumns": [
                {"name": "Ready", "type": "string",
                 "jsonPath": ".status.conditions[?(@.type=='SliceReady')].status"},
                {"name": "Age", "type": "date",
                 "jsonPath": ".metadata.creationTimestamp"},
            ],
        })
    return {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {"name": CRD_NAME},
        "spec": {
            "group": GROUP,
            "names": {"kind": KIND, "listKind": "NotebookList",
                      "plural": "notebooks", "singular": "notebook"},
            "scope": "Namespaced",
            "versions": versions,
        },
    }


def install_notebook_crd(store) -> None:
    """Install the Notebook CRD and its typed admission into a store: the
    store validates every Notebook write against the CRD's schema, and
    the admission checks what a schema cannot (``validate_notebook``) and
    persists at the storage version whatever version was written."""
    from ..cluster.errors import AlreadyExistsError
    try:
        store.create(notebook_crd())
    except AlreadyExistsError:
        pass

    def admit(operation, obj, old):
        if operation in ("CREATE", "UPDATE"):
            validate_notebook(obj)
            obj = convert_notebook(obj, STORAGE_VERSION)
        return obj
    store.register_admission(KIND, admit)
