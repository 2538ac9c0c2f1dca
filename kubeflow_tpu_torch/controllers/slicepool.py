"""The StatefulSet of a warm H100 pool slice.

The port's counterpart of ``_create_warm_slice`` in
``kubeflow_tpu/controllers/slicepool.py``: the same name, labels, pool
state, ``Parallel`` policy, headless ``serviceName`` and worker env, with
``nvidia.com/gpu`` requests and the H100 node selectors. It only renders
the object; creating it (and the headless Service beside it), and
handling a name that already exists, stay the pool manager's.
"""

from __future__ import annotations

from ..gpu.topology import SliceSpec
from ..utils import k8s, names
from .notebook import gpu_resources, worker_env


def slice_hostnames(spec: SliceSpec, sts_name: str, pool_ns: str) -> str:
    """The identity a slice is born with: its workers' stable DNS names
    through its own headless Service (single-host slices are
    ``localhost``, as the notebook's StatefulSet gets)."""
    if not spec.multi_host:
        return "localhost"
    return ",".join(spec.worker_hostnames(sts_name, sts_name, pool_ns))


def warm_slice_statefulset(pool: dict, spec: SliceSpec, pool_ns: str,
                           name: str, image: str) -> dict:
    """The StatefulSet that pre-rolls slice ``name`` of ``pool`` to full
    replicas with the generic warm ``image``. The name is the caller's
    (the reference picks the lowest free ``<pool>-wN``); its selector,
    pod label and worker env are all right in this one object."""
    if len(name) > names.MAX_STS_NAME_LENGTH:
        raise ValueError(f"slice name {name!r} is longer than "
                         f"{names.MAX_STS_NAME_LENGTH} characters")
    pool_name = k8s.name(pool)
    container = {"name": "warm-slice", "image": image,
                 "resources": gpu_resources(spec)}
    worker_env(container, spec, slice_hostnames(spec, name, pool_ns))
    return {
        "apiVersion": "apps/v1",
        "kind": "StatefulSet",
        "metadata": {
            "name": name,
            "namespace": pool_ns,
            "labels": {names.POOL_LABEL: pool_name,
                       "statefulset": name,
                       names.TPU_SLICE_LABEL: spec.short_name},
            "annotations": {
                names.POOL_STATE_ANNOTATION: names.POOL_STATE_WARMING},
        },
        "spec": {
            "replicas": spec.num_workers,
            "selector": {"matchLabels": {"statefulset": name}},
            "serviceName": name,
            "podManagementPolicy": "Parallel",
            "template": {
                "metadata": {"labels": {names.POOL_LABEL: pool_name,
                                        "statefulset": name}},
                "spec": {
                    "nodeSelector": dict(spec.node_selectors()),
                    "containers": [container],
                },
            },
        },
    }
