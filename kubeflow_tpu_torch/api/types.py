"""Notebook CRD types.

A copy of ``kubeflow_tpu/api/types.py`` (the port imports nothing of the
JAX package). Reference shape: components/notebook-controller/api/v1/
notebook_types.go:27-88, ``Notebook{Spec{Template{Spec: corev1.PodSpec}},
Status{Conditions, ReadyReplicas, ContainerState}}`` with kubeflow.org/v1
as the storage version. The slice request rides the annotations
``tpu.kubeflow.org/accelerator`` / ``tpu.kubeflow.org/topology`` (for the
port an H100 shape such as ``h100-16``), so a Notebook CR applies to
either package unchanged.

``convert_notebook`` and ``install_notebook_crd`` (the CRD schema and
the admission that converts versions) come with the webhook slice.
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
