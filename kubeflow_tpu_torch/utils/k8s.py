"""The Kubernetes object helpers the runtime's handshake agents need.

A copy of the part of ``kubeflow_tpu/utils/k8s.py`` that
runtime/elastic.py and runtime/migrate.py use (the port imports nothing
of the JAX package). API objects are plain nested dicts shaped like their
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
