"""SlicePool CRD types + the bound-slice helpers the controllers share.

A copy of ``kubeflow_tpu/api/slicepool.py`` (the port imports nothing of
the JAX package), with the accelerator parsed by gpu/topology.py. A
``SlicePool`` (``tpu.kubeflow.org/v1``, cluster-scoped like Node)
declares a target count of warm slices for one accelerator shape:
pre-rolled StatefulSets held at full replicas and Ready in the pool's
namespace. A Notebook of that shape binds a warm slice (annotation flip
+ Service repoint) instead of rolling its own StatefulSet.

Wire shape::

    apiVersion: tpu.kubeflow.org/v1
    kind: SlicePool
    metadata: {name: warm-h100-16}
    spec:
      accelerator: h100-16       # topology key (gpu/topology short name)
      warmReplicas: 2            # slice capacity the pool maintains
      namespace: tpu-slice-pools # where warm slices materialize
      weights: {team-a: 3}       # fair-share weight per notebook namespace
    status: {warm: 1, warming: 1, bound: 3, pending: 0}

The bound edge is annotation-carried on both sides (Notebook's
``bound-slice`` ↔ StatefulSet's ``pool-bound-to``). The core
NotebookReconciler reads only ``bound_slice_ref``, ``bound_slice_pods``,
``pod_notebook_mapper`` and ``KIND``; the pool's reconciler and its CRD
install and validation come with a later slice.
"""

from __future__ import annotations

from ..utils import k8s, names

GROUP = "tpu.kubeflow.org"
VERSION = "v1"
API_VERSION = f"{GROUP}/{VERSION}"
KIND = "SlicePool"


def new_slice_pool(name: str, accelerator: str, warm_replicas: int, *,
                   namespace: str | None = None,
                   weights: dict[str, int] | None = None) -> dict:
    """Build a SlicePool CR in wire form. ``namespace`` is where the warm
    slices materialize; ``weights`` are the per-notebook-namespace
    fair-share admission weights."""
    pool = {
        "apiVersion": API_VERSION,
        "kind": KIND,
        "metadata": {"name": name},
        "spec": {
            "accelerator": accelerator,
            "warmReplicas": int(warm_replicas),
        },
        "status": {},
    }
    if namespace:
        pool["spec"]["namespace"] = namespace
    if weights:
        pool["spec"]["weights"] = dict(weights)
    return pool


# ------------------------------------------------------ bound-slice helpers
def bound_slice_ref(notebook: dict) -> tuple[str, str] | None:
    """The (pool namespace, StatefulSet name) a Notebook is bound to, or
    None: the predicate that flips the core reconciler into bound mode."""
    raw = k8s.get_annotation(notebook, names.BOUND_SLICE_ANNOTATION)
    if not raw or "/" not in raw:
        return None
    ns, _, sts = raw.partition("/")
    return (ns, sts) if ns and sts else None


def bound_slice_pods(client, bound: tuple[str, str]) -> list[dict]:
    """The bound slice's worker pods, listed by the immutable
    ``statefulset`` selector label in the pool namespace."""
    return client.list("Pod", bound[0], {"statefulset": bound[1]})


def pod_notebook_mapper(obj: dict):
    """Watch mapper: a pod carrying the notebook-name label enqueues its
    Notebook. Bound pool pods live in the pool namespace; the
    bound-namespace label carries the notebook's namespace."""
    from ..controllers.manager import Request
    nb = k8s.get_label(obj, names.NOTEBOOK_NAME_LABEL)
    if not nb:
        return []
    ns = k8s.get_label(obj, names.BOUND_NAMESPACE_LABEL) or k8s.namespace(obj)
    return [Request(ns, nb)]
