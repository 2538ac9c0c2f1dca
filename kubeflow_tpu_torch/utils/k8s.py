"""The Kubernetes object helpers the runtime's handshake agents and the
accelerator seams need.

A copy of the part of ``kubeflow_tpu/utils/k8s.py`` that
runtime/elastic.py, runtime/migrate.py and the accelerator seams
(controllers/, webhook/) use, and of the notebook-container lookup of
``kubeflow_tpu/api/types.py`` (the port imports nothing of the JAX
package). API objects are plain nested dicts shaped like their
Kubernetes JSON wire form.
"""

from __future__ import annotations

from typing import Any

Obj = dict  # a Kubernetes API object in JSON form


def get_in(obj: Obj, *path: str, default: Any = None) -> Any:
    cur: Any = obj
    for key in path:
        if not isinstance(cur, dict) or key not in cur:
            return default
        cur = cur[key]
    return cur


def name(obj: Obj) -> str:
    return get_in(obj, "metadata", "name", default="")


def namespace(obj: Obj) -> str:
    return get_in(obj, "metadata", "namespace", default="")


def kind(obj: Obj) -> str:
    return obj.get("kind", "")


def get_annotation(obj: Obj, key: str,
                   default: str | None = None) -> str | None:
    return get_in(obj, "metadata", "annotations", key, default=default)


def set_annotation(obj: Obj, key: str, value: str) -> None:
    obj.setdefault("metadata", {}).setdefault("annotations", {})[key] = value


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


def pod_spec_notebook_container(pod_spec: dict, nb_name: str) -> dict | None:
    """The notebook container: the one named after the CR, else
    containers[0], else None (the convention the reference's webhook and
    reconcilers share, so they target the same container)."""
    containers = pod_spec.get("containers") or []
    for c in containers:
        if c.get("name") == nb_name:
            return c
    return containers[0] if containers else None


def notebook_container(notebook: Obj) -> dict | None:
    pod_spec = get_in(notebook, "spec", "template", "spec", default={}) or {}
    return pod_spec_notebook_container(pod_spec, name(notebook))
