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
``bound-slice`` ↔ StatefulSet's ``pool-bound-to``) so a controller crash
between the two patches is healed from either side on the next
reconcile. ``install_slicepool_crd`` installs the CRD (``slicepool_crd``,
the port's copy of the one manifest of ``kubeflow_tpu/deploy/
manifests.py`` it needs) and the admission that runs
``validate_slice_pool``.
"""

from __future__ import annotations

from ..cluster.errors import InvalidError
from ..utils import k8s, names

GROUP = "tpu.kubeflow.org"
VERSION = "v1"
API_VERSION = f"{GROUP}/{VERSION}"
KIND = "SlicePool"
PLURAL = "slicepools"


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


def validate_slice_pool(pool: dict) -> None:
    """Structural + semantic validation the CRD schema/admission enforce:
    the accelerator must parse to a real H100 slice shape (a pool of
    unprovisionable slices would warm nothing, silently, forever)."""
    from ..gpu.topology import GpuRequestError, parse_short_name
    if k8s.kind(pool) != KIND:
        raise InvalidError(f"kind must be {KIND}")
    if pool.get("apiVersion") != API_VERSION:
        raise InvalidError(f"apiVersion must be {API_VERSION}")
    if not k8s.name(pool):
        raise InvalidError("metadata.name required")
    spec = pool.get("spec") or {}
    accelerator = spec.get("accelerator")
    if not accelerator:
        raise InvalidError("spec.accelerator required")
    try:
        parse_short_name(accelerator)
    except GpuRequestError as exc:
        raise InvalidError(f"spec.accelerator: {exc}") from exc
    warm = spec.get("warmReplicas")
    if not isinstance(warm, int) or warm < 0:
        raise InvalidError("spec.warmReplicas must be a non-negative int")
    weights = spec.get("weights")
    if weights is not None:
        if not isinstance(weights, dict) or any(
                not isinstance(w, int) or w < 1 for w in weights.values()):
            raise InvalidError("spec.weights values must be ints >= 1")


def slicepool_crd() -> dict:
    """CustomResourceDefinition for the warm slice pool (tpu.kubeflow.org/v1
    SlicePool, cluster-scoped — controllers/slicepool.py). Single served
    version; the reference's ``deploy/manifests.py`` ``slicepool_crd``."""
    schema_doc = {
        "openAPIV3Schema": {
            "type": "object",
            "properties": {
                "spec": {
                    "type": "object",
                    "required": ["accelerator", "warmReplicas"],
                    "properties": {
                        "accelerator": {"type": "string"},
                        "warmReplicas": {"type": "integer",
                                         "format": "int32", "minimum": 0},
                        "namespace": {"type": "string"},
                        "weights": {
                            "type": "object",
                            "additionalProperties": {"type": "integer",
                                                     "minimum": 1},
                        },
                    },
                },
                "status": {
                    "type": "object",
                    "properties": {
                        "warm": {"type": "integer", "format": "int32"},
                        "warming": {"type": "integer", "format": "int32"},
                        "bound": {"type": "integer", "format": "int32"},
                        "pending": {"type": "integer", "format": "int32"},
                    },
                },
            },
        },
    }
    return {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {"name": f"{PLURAL}.{GROUP}"},
        "spec": {
            "group": GROUP,
            "names": {"kind": KIND, "listKind": "SlicePoolList",
                      "plural": PLURAL, "singular": "slicepool"},
            "scope": "Cluster",
            "versions": [{
                "name": VERSION,
                "served": True,
                "storage": True,
                "schema": schema_doc,
                "subresources": {"status": {}},
                "additionalPrinterColumns": [
                    {"name": "Accelerator", "type": "string",
                     "jsonPath": ".spec.accelerator"},
                    {"name": "Target", "type": "integer",
                     "jsonPath": ".spec.warmReplicas"},
                    {"name": "Warm", "type": "integer",
                     "jsonPath": ".status.warm"},
                    {"name": "Bound", "type": "integer",
                     "jsonPath": ".status.bound"},
                ],
            }],
        },
    }


def install_slicepool_crd(store) -> None:
    """Install the SlicePool CRD + admission into an apiserver — the
    sibling of the reference's ``api.types.install_notebook_crd``."""
    from ..cluster.errors import AlreadyExistsError
    try:
        store.create(slicepool_crd())
    except AlreadyExistsError:
        pass

    def admit(operation, obj, old):
        if operation in ("CREATE", "UPDATE"):
            validate_slice_pool(obj)
        return obj
    store.register_admission(KIND, admit)


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
