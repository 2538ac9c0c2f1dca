"""The GPU workload layer of a notebook's StatefulSet.

The port's counterpart of ``_apply_tpu_spec`` in
``kubeflow_tpu/controllers/notebook.py``: the same slice label, headless
Service and worker env (``TPU_WORKER_HOSTNAMES``, ``TPU_WORKER_ID``,
``TPU_ACCELERATOR_TYPE``, ``TPU_TOPOLOGY``: the names runtime/bootstrap.py
reads), with ``nvidia.com/gpu`` requests and the H100 node selectors of
gpu/topology.py in place of ``google.com/tpu`` and the TPU selectors. It
renders onto a StatefulSet the reference's ``generate_statefulset``
built without a slice; the reference's manager still calls its own.
"""

from __future__ import annotations

from ..gpu.topology import SliceSpec
from ..utils import k8s, names


def headless_service_name(notebook_name: str) -> str:
    return f"{notebook_name}-workers"[: 63]


def worker_env(container: dict, spec: SliceSpec, hostnames: str | None) -> None:
    """The worker identity env of a slice's pod: ``hostnames`` (None
    leaves TPU_WORKER_HOSTNAMES unset), the worker id from the pod-index
    label, the accelerator and its topology."""
    if hostnames is not None:
        k8s.upsert_env(container, "TPU_WORKER_HOSTNAMES", hostnames)
    # worker id = StatefulSet pod ordinal, surfaced by the apps controller
    # as the pod-index label (stable across pod restarts)
    k8s.upsert_env_from(container, "TPU_WORKER_ID", {"fieldRef": {
        "fieldPath": f"metadata.labels['{names.POD_INDEX_LABEL}']"}})
    k8s.upsert_env(container, "TPU_ACCELERATOR_TYPE", spec.short_name)
    k8s.upsert_env(container, "TPU_TOPOLOGY", spec.topology_str)


def gpu_resources(spec: SliceSpec) -> dict:
    qty = str(spec.cards_per_worker)
    return {"requests": {names.GPU_RESOURCE_KEY: qty},
            "limits": {names.GPU_RESOURCE_KEY: qty}}


def apply_gpu_spec(sts: dict, notebook: dict, spec: SliceSpec,
                   sts_name: str | None) -> None:
    """Render an H100 slice onto a notebook's StatefulSet: nodeSelectors,
    card resources, worker identity env, the headless-service subdomain,
    and ``spec.num_workers`` replicas unless the StatefulSet has 0 (a
    stopped notebook, or a repair's scale-down, stays at 0).

    ``sts_name`` is None only on the very first create of a GenerateName
    StatefulSet; the multi-host hostnames are rendered once the apiserver
    has materialized the name, as in the reference."""
    nb_name = k8s.name(notebook)
    pod_spec = sts["spec"]["template"]["spec"]
    pod_spec.setdefault("nodeSelector", {}).update(spec.node_selectors())
    if sts["spec"].get("replicas") != 0:
        sts["spec"]["replicas"] = spec.num_workers

    sts["metadata"].setdefault("labels", {})[names.TPU_SLICE_LABEL] = (
        spec.short_name)
    sts["spec"]["template"]["metadata"]["labels"][names.TPU_SLICE_LABEL] = (
        spec.short_name)

    container = k8s.pod_spec_notebook_container(pod_spec, nb_name)
    if container is None:
        return  # structurally invalid CR; admission validation rejects these
    resources = container.setdefault("resources", {})
    for key, quantities in gpu_resources(spec).items():
        resources.setdefault(key, {}).update(quantities)

    hostnames = "localhost"
    if spec.multi_host:
        headless = headless_service_name(nb_name)
        sts["spec"]["serviceName"] = headless
        hostnames = None if sts_name is None else ",".join(
            spec.worker_hostnames(sts_name, headless, k8s.namespace(notebook)))
    worker_env(container, spec, hostnames)
