"""Kubernetes object helpers over plain-dict API objects.

A copy of the helpers of ``kubeflow_tpu/utils/k8s.py`` that the port's
control plane (cluster/, controllers/, webhook/), the accelerator seam and
the runtime's handshake agents use, and of the notebook-container lookup
of ``kubeflow_tpu/api/types.py`` (the port imports nothing of the JAX
package). API objects are plain nested dicts shaped like their
Kubernetes JSON wire form (what ``kubectl get -o json`` shows).
"""

from __future__ import annotations

import copy
import re
import time
from typing import Any, Iterable

Obj = dict  # a Kubernetes API object in JSON form


def now_iso() -> str:
    """RFC3339 second-granularity timestamp, the apiserver's metadata format
    (shared by creationTimestamp, deletionTimestamp, and Event timestamps)."""
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())


def deepcopy(obj: Obj) -> Obj:
    """Equivalent of the reference's generated DeepCopy methods."""
    return copy.deepcopy(obj)


def get_in(obj: Obj, *path: str, default: Any = None) -> Any:
    cur: Any = obj
    for key in path:
        if not isinstance(cur, dict) or key not in cur:
            return default
        cur = cur[key]
    return cur


def meta(obj: Obj) -> dict:
    return obj.setdefault("metadata", {})


def name(obj: Obj) -> str:
    return get_in(obj, "metadata", "name", default="")


def namespace(obj: Obj) -> str:
    return get_in(obj, "metadata", "namespace", default="")


def uid(obj: Obj) -> str:
    return get_in(obj, "metadata", "uid", default="")


def kind(obj: Obj) -> str:
    return obj.get("kind", "")


def labels(obj: Obj) -> dict:
    return meta(obj).setdefault("labels", {})


def annotations(obj: Obj) -> dict:
    return meta(obj).setdefault("annotations", {})


def get_label(obj: Obj, key: str, default: str | None = None) -> str | None:
    return get_in(obj, "metadata", "labels", key, default=default)


def get_annotation(obj: Obj, key: str,
                   default: str | None = None) -> str | None:
    return get_in(obj, "metadata", "annotations", key, default=default)


def set_annotation(obj: Obj, key: str, value: str) -> None:
    annotations(obj)[key] = value


def remove_annotation(obj: Obj, key: str) -> None:
    anns = get_in(obj, "metadata", "annotations")
    if isinstance(anns, dict):
        anns.pop(key, None)


def parse_port(value) -> int | None:
    """A TCP port from an author-controlled annotation value; None for
    anything non-numeric or out of range."""
    try:
        port = int(value)
    except (TypeError, ValueError):
        return None
    return port if 0 < port < 65536 else None


def finalizers(obj: Obj) -> list:
    return meta(obj).setdefault("finalizers", [])


def has_finalizer(obj: Obj, fin: str) -> bool:
    return fin in (get_in(obj, "metadata", "finalizers") or [])


def add_finalizer(obj: Obj, fin: str) -> bool:
    fins = finalizers(obj)
    if fin in fins:
        return False
    fins.append(fin)
    return True


def remove_finalizer(obj: Obj, fin: str) -> bool:
    fins = get_in(obj, "metadata", "finalizers")
    if not fins or fin not in fins:
        return False
    fins.remove(fin)
    return True


def is_deleting(obj: Obj) -> bool:
    return get_in(obj, "metadata", "deletionTimestamp") is not None


def owner_references(obj: Obj) -> list:
    return meta(obj).setdefault("ownerReferences", [])


def new_owner_ref(owner: Obj, *, controller: bool = True,
                  block_owner_deletion: bool = True) -> dict:
    """ctrl.SetControllerReference equivalent."""
    return {
        "apiVersion": owner.get("apiVersion", ""),
        "kind": owner.get("kind", ""),
        "name": name(owner),
        "uid": uid(owner),
        "controller": controller,
        "blockOwnerDeletion": block_owner_deletion,
    }


def set_controller_reference(owner: Obj, controlled: Obj) -> None:
    refs = owner_references(controlled)
    ref = new_owner_ref(owner)
    for existing in refs:
        if existing.get("uid") == ref["uid"]:
            existing.update(ref)
            return
    refs.append(ref)


def condition_true(obj: Obj, cond_type: str) -> bool:
    """``status.conditions`` has ``cond_type`` with status "True": the
    readiness predicate (Pod Ready, Node Ready, Notebook SliceReady)."""
    return any(c.get("type") == cond_type and c.get("status") == "True"
               for c in get_in(obj, "status", "conditions",
                               default=[]) or [])


def is_owned_by(obj: Obj, owner_uid: str) -> bool:
    return any(r.get("uid") == owner_uid
               for r in get_in(obj, "metadata", "ownerReferences",
                               default=[]) or [])


def merge_managed_labels(obj: Obj, managed: dict[str, str]) -> bool:
    """Set every managed label key to its value, keeping the object's
    other labels (a wholesale replace would fight other controllers over
    theirs); True when the object changed."""
    labels = get_in(obj, "metadata", "labels", default=None)
    if labels is None:
        labels = {}
        obj.setdefault("metadata", {})["labels"] = labels
    missing = {k: v for k, v in managed.items() if labels.get(k) != v}
    labels.update(missing)
    return bool(missing)


def matches_labels(obj: Obj, selector: dict[str, str | None] | None) -> bool:
    """Equality selector; a ``None`` value means existence (the ``key``
    form of a k8s label selector)."""
    if not selector:
        return True
    have = get_in(obj, "metadata", "labels", default={}) or {}
    return all(k in have if v is None else have.get(k) == v
               for k, v in selector.items())


def json_merge_patch(target: Obj, patch: Obj) -> Obj:
    """RFC 7386 JSON Merge Patch (client.MergeFrom semantics)."""
    if not isinstance(patch, dict):
        return copy.deepcopy(patch)
    if not isinstance(target, dict):
        target = {}
    result = dict(target)
    for key, value in patch.items():
        if value is None:
            result.pop(key, None)
        else:
            result[key] = json_merge_patch(result.get(key), value)
    return result


# the quantity grammar parse_quantity and the CRD schema
# (api/schema.py) share: a signed number followed by either an exponent
# or one valid suffix (binary Ki..Ei, decimal n/u/m/k/M/G/T/P/E), never
# both; lowercase "ki" and bare "K" are rejected, as on a real apiserver
QUANTITY_PATTERN = (
    r"^[+-]?([0-9]+(\.[0-9]*)?|\.[0-9]+)"
    r"(([eE][+-]?[0-9]+)|Ki|Mi|Gi|Ti|Pi|Ei|[numkMGTPE])?$")
_QUANTITY_RE = re.compile(QUANTITY_PATTERN)
_QUANTITY_SUFFIX = {
    "": 1.0, "n": 1e-9, "u": 1e-6, "m": 1e-3,
    "k": 1e3, "M": 1e6, "G": 1e9, "T": 1e12, "P": 1e15, "E": 1e18,
    "Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40, "Pi": 2**50,
    "Ei": 2**60,
}


def parse_quantity(value: str) -> float:
    """Kubernetes resource.Quantity → float (cores for CPU, bytes for
    memory). Exactly the QUANTITY_PATTERN grammar; raises ValueError on
    anything outside it."""
    text = value.strip()
    m = _QUANTITY_RE.match(text)
    if not m:
        raise ValueError(f"invalid quantity {value!r}")
    number, tail, exponent = m.group(1), m.group(3) or "", m.group(4)
    sign = -1.0 if text.startswith("-") else 1.0
    if exponent:  # scientific notation: the whole thing is the number
        return sign * float(number + exponent)
    return sign * float(number) * _QUANTITY_SUFFIX[tail]


def find_container(pod_spec: dict, container_name: str) -> dict | None:
    for c in pod_spec.get("containers", []) or []:
        if c.get("name") == container_name:
            return c
    return None


def env_list_to_dict(env: Iterable[dict]) -> dict[str, str]:
    return {e["name"]: e.get("value", "") for e in env or []}


def upsert_env(container: dict, name_: str, value: str) -> None:
    env = container.setdefault("env", [])
    for e in env:
        if e.get("name") == name_:
            e.pop("valueFrom", None)
            e["value"] = value
            return
    env.append({"name": name_, "value": value})


def upsert_env_from(container: dict, name_: str, value_from: dict) -> None:
    env = container.setdefault("env", [])
    for e in env:
        if e.get("name") == name_:
            e.pop("value", None)
            e["valueFrom"] = value_from
            return
    env.append({"name": name_, "valueFrom": value_from})


def remove_env(container: dict, name_: str) -> None:
    env = container.get("env")
    if env:
        container["env"] = [e for e in env if e.get("name") != name_]


def upsert_volume(pod_spec: dict, volume: dict) -> None:
    vols = pod_spec.setdefault("volumes", [])
    for i, v in enumerate(vols):
        if v.get("name") == volume["name"]:
            vols[i] = volume
            return
    vols.append(volume)


def remove_volume(pod_spec: dict, name_: str) -> None:
    vols = pod_spec.get("volumes")
    if vols:
        pod_spec["volumes"] = [v for v in vols if v.get("name") != name_]


def upsert_volume_mount(container: dict, mount: dict) -> None:
    mounts = container.setdefault("volumeMounts", [])
    for i, m in enumerate(mounts):
        if m.get("name") == mount["name"] and \
                m.get("mountPath") == mount.get("mountPath"):
            mounts[i] = mount
            return
    mounts.append(mount)


def remove_volume_mount(container: dict, name_: str) -> None:
    mounts = container.get("volumeMounts")
    if mounts:
        container["volumeMounts"] = [m for m in mounts
                                     if m.get("name") != name_]


def pod_spec_notebook_container(pod_spec: dict, nb_name: str) -> dict | None:
    """The notebook container: the one named after the CR, else
    containers[0], else None (the convention the reference's webhook and
    reconcilers share, so they target the same container)."""
    c = find_container(pod_spec, nb_name)
    if c is not None:
        return c
    containers = pod_spec.get("containers") or []
    return containers[0] if containers else None


def notebook_container(notebook: Obj) -> dict | None:
    pod_spec = get_in(notebook, "spec", "template", "spec", default={}) or {}
    return pod_spec_notebook_container(pod_spec, name(notebook))
