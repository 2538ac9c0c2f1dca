"""TPUQuota CRD types: per-tenant slice ceilings the fleet scheduler
enforces at gang admission.

A copy of ``kubeflow_tpu/api/tpuquota.py`` (the port imports nothing of
the JAX package), with the same group, version and kind, so the quotas
users apply stay the same. A ``TPUQuota`` (``tpu.kubeflow.org/v1``,
cluster-scoped like SlicePool: quota is fleet policy, not tenant state)
caps the total slices one tenant namespace may hold across every H100
shape of the node table (gpu/topology.py) at once: bound warm slices,
elastic training slices and in-flight gang reservations all count
against it. The scheduler keeps Pending any gang whose admission would
push its tenant past the cap. Quota denial is an admission outcome, not
an error, so a shrunk quota never kills running work: it only gates new
grants.

Wire shape::

    apiVersion: tpu.kubeflow.org/v1
    kind: TPUQuota
    metadata: {name: team-a-quota}
    spec:
      tenant: team-a             # notebook namespace the cap applies to
      maxSlices: 4               # ceiling across ALL shapes; 0 means the
                                 # tenant may hold nothing (explicit
                                 # freeze), absent quota means unlimited

Several quotas for one tenant are legal (different admins, different
manifests); the scheduler takes the MINIMUM, the conservative read that
makes a duplicate-apply race harmless. ``install_tpuquota_crd`` installs
the CRD (``tpuquota_crd``, the port's copy of the reference's
``deploy/manifests.py`` ``tpuquota_crd``) and the admission that runs
``validate_tpu_quota``.
"""

from __future__ import annotations

from ..cluster.errors import InvalidError
from ..utils import k8s

GROUP = "tpu.kubeflow.org"
VERSION = "v1"
API_VERSION = f"{GROUP}/{VERSION}"
KIND = "TPUQuota"
PLURAL = "tpuquotas"


def new_tpu_quota(name: str, tenant: str, max_slices: int) -> dict:
    """Build a TPUQuota CR in wire form: ``tenant`` is the notebook
    namespace the ceiling applies to, ``max_slices`` the total slices it
    may hold fleet-wide."""
    return {
        "apiVersion": API_VERSION,
        "kind": KIND,
        "metadata": {"name": name},
        "spec": {
            "tenant": str(tenant),
            "maxSlices": int(max_slices),
        },
        "status": {},
    }


def validate_tpu_quota(quota: dict) -> None:
    """Structural validation the CRD schema/admission enforce: a quota
    with no tenant binds nothing, and a negative cap has no sane
    reading (0 is the explicit freeze)."""
    if k8s.kind(quota) != KIND:
        raise InvalidError(f"kind must be {KIND}")
    if quota.get("apiVersion") != API_VERSION:
        raise InvalidError(f"apiVersion must be {API_VERSION}")
    if not k8s.name(quota):
        raise InvalidError("metadata.name required")
    spec = quota.get("spec") or {}
    tenant = spec.get("tenant")
    if not tenant or not isinstance(tenant, str):
        raise InvalidError("spec.tenant required")
    max_slices = spec.get("maxSlices")
    if not isinstance(max_slices, int) or isinstance(max_slices, bool) \
            or max_slices < 0:
        raise InvalidError("spec.maxSlices must be a non-negative int")


def tpuquota_crd() -> dict:
    """CustomResourceDefinition for per-tenant slice quota
    (tpu.kubeflow.org/v1 TPUQuota, cluster-scoped: the scheduler's
    admission ceiling, controllers/scheduler.py). Single served version;
    the reference's ``deploy/manifests.py`` ``tpuquota_crd``."""
    schema_doc = {
        "openAPIV3Schema": {
            "type": "object",
            "properties": {
                "spec": {
                    "type": "object",
                    "required": ["tenant", "maxSlices"],
                    "properties": {
                        "tenant": {"type": "string"},
                        "maxSlices": {"type": "integer",
                                      "format": "int32", "minimum": 0},
                    },
                },
                "status": {
                    "type": "object",
                    "properties": {
                        "used": {"type": "integer", "format": "int32"},
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
            "names": {"kind": KIND, "listKind": "TPUQuotaList",
                      "plural": PLURAL, "singular": "tpuquota"},
            "scope": "Cluster",
            "versions": [{
                "name": VERSION,
                "served": True,
                "storage": True,
                "schema": schema_doc,
                "subresources": {"status": {}},
                "additionalPrinterColumns": [
                    {"name": "Tenant", "type": "string",
                     "jsonPath": ".spec.tenant"},
                    {"name": "MaxSlices", "type": "integer",
                     "jsonPath": ".spec.maxSlices"},
                ],
            }],
        },
    }


def install_tpuquota_crd(store) -> None:
    """Install the TPUQuota CRD + admission into an apiserver: the
    sibling of api.slicepool.install_slicepool_crd."""
    from ..cluster.errors import AlreadyExistsError
    try:
        store.create(tpuquota_crd())
    except AlreadyExistsError:
        pass

    def admit(operation, obj, old):
        if operation in ("CREATE", "UPDATE"):
            validate_tpu_quota(obj)
        return obj
    store.register_admission(KIND, admit)


def tenant_quota(client, tenant: str) -> int | None:
    """The effective slice ceiling for ``tenant``: the MINIMUM maxSlices
    over every TPUQuota naming it, or None when no quota applies
    (unlimited). Shared by the scheduler's admission path and any
    read-only tooling so both agree on the duplicate-quota rule."""
    caps = [k8s.get_in(q, "spec", "maxSlices")
            for q in client.list(KIND)
            if k8s.get_in(q, "spec", "tenant") == tenant]
    caps = [c for c in caps if isinstance(c, int)]
    return min(caps) if caps else None
