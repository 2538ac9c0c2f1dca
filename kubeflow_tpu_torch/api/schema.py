"""Structural CRD schema: typed PodSpec subset + OpenAPI v3 validator.

A copy of ``kubeflow_tpu/api/schema.py`` (the port imports nothing of the
JAX package), so both packages hold a Notebook to the same schema and
name its faults in the same words. The reference ships an 11,650-line generated schema expanding the whole
corev1.PodSpec (config/crd/bases/kubeflow.org_notebooks.yaml), so a malformed
pod spec is rejected by the apiserver before any controller sees it. This
module is our equivalent: a hand-maintained *typed* schema for every PodSpec
field the controllers and webhooks actually read or write, with
``x-kubernetes-preserve-unknown-fields`` at the pod-spec and container levels
so user-supplied fields outside the typed subset flow through untouched
(k8s structural-schema semantics: preserve-unknown keeps unknown fields while
declared properties are still validated).

``validate_schema`` implements the subset of OpenAPI v3 structural validation
kube-apiserver applies to CRs: type checks, required, enum, pattern, items,
additionalProperties, minItems/minLength, int-or-string. No pruning — like
validation failures, unknown fields either pass (under preserve-unknown) or
are simply not checked; controllers never depend on pruning.

ClusterStore enforces these schemas generically: creating a
CustomResourceDefinition object registers its per-version schema, and every
subsequent write of that kind is validated server-side (422 Invalid).
"""

from __future__ import annotations

import re
from typing import Any

# k8s resource.Quantity surface syntax — single source of truth shared
# with the webhook's parse_quantity (utils/k8s.py), so CRD validation and
# admission-time validation can never drift apart
from ..utils.k8s import QUANTITY_PATTERN  # noqa: E402,F401

_DNS1123_LABEL = r"^[a-z0-9]([-a-z0-9]*[a-z0-9])?$"

PRESERVE = "x-kubernetes-preserve-unknown-fields"


def _quantity() -> dict:
    return {"type": "string", "pattern": QUANTITY_PATTERN}


def _quantity_map() -> dict:
    return {"type": "object", "additionalProperties": _quantity()}


def env_var_schema() -> dict:
    return {
        "type": "object",
        "required": ["name"],
        "properties": {
            "name": {"type": "string", "minLength": 1},
            "value": {"type": "string"},
            "valueFrom": {"type": "object", PRESERVE: True},
        },
    }


def container_port_schema() -> dict:
    return {
        "type": "object",
        "required": ["containerPort"],
        "properties": {
            "containerPort": {"type": "integer", "minimum": 1,
                              "maximum": 65535},
            "name": {"type": "string"},
            "protocol": {"type": "string",
                         "enum": ["TCP", "UDP", "SCTP"]},
            "hostPort": {"type": "integer"},
            "hostIP": {"type": "string"},
        },
    }


def volume_mount_schema() -> dict:
    return {
        "type": "object",
        "required": ["name", "mountPath"],
        "properties": {
            "name": {"type": "string", "minLength": 1},
            "mountPath": {"type": "string", "minLength": 1},
            "subPath": {"type": "string"},
            "readOnly": {"type": "boolean"},
            "mountPropagation": {"type": "string"},
        },
    }


def resources_schema() -> dict:
    return {
        "type": "object",
        "properties": {
            "limits": _quantity_map(),
            "requests": _quantity_map(),
            "claims": {"type": "array",
                       "items": {"type": "object", PRESERVE: True}},
        },
    }


def container_schema() -> dict:
    """Typed on everything the webhook/reconcilers touch (image swap, env
    injection, sidecar validation, port defaulting — notebook.py:184-295,
    mutating.py), preserve-unknown for the rest (probes, lifecycle, ...)."""
    return {
        "type": "object",
        "required": ["name"],
        PRESERVE: True,
        "properties": {
            "name": {"type": "string", "minLength": 1,
                     "pattern": _DNS1123_LABEL},
            "image": {"type": "string"},
            "command": {"type": "array", "items": {"type": "string"}},
            "args": {"type": "array", "items": {"type": "string"}},
            "workingDir": {"type": "string"},
            "env": {"type": "array", "items": env_var_schema()},
            "envFrom": {"type": "array",
                        "items": {"type": "object", PRESERVE: True}},
            "ports": {"type": "array", "items": container_port_schema()},
            "resources": resources_schema(),
            "volumeMounts": {"type": "array", "items": volume_mount_schema()},
            "imagePullPolicy": {"type": "string",
                                "enum": ["Always", "IfNotPresent", "Never"]},
            "securityContext": {"type": "object", PRESERVE: True},
        },
    }


def volume_schema() -> dict:
    return {
        "type": "object",
        "required": ["name"],
        PRESERVE: True,  # the many volume source types stay untyped
        "properties": {
            "name": {"type": "string", "minLength": 1},
            "configMap": {"type": "object", PRESERVE: True},
            "secret": {"type": "object", PRESERVE: True},
            "emptyDir": {"type": "object", PRESERVE: True},
            "persistentVolumeClaim": {
                "type": "object",
                "required": ["claimName"],
                "properties": {"claimName": {"type": "string"},
                               "readOnly": {"type": "boolean"}},
            },
        },
    }


def pod_spec_subset() -> dict:
    """The hand-typed PodSpec OVERRIDE layer: only the fields where this
    repo's controllers/webhooks need TIGHTER validation than the generated
    expansion (quantity patterns for the sidecar-resource webhook,
    DNS-1123 container names, PVC requireds). Merged on top of the full
    mechanical expansion below."""
    return {
        "type": "object",
        "properties": {
            "containers": {"type": "array", "minItems": 1,
                           "items": container_schema()},
            "initContainers": {"items": container_schema()},
            "volumes": {"items": volume_schema()},
        },
    }


def pod_spec_schema() -> dict:
    """The full PodSpec schema the CRD carries: the mechanically-generated
    core/v1 expansion (api/podspec_gen.py — probes, lifecycle, affinity,
    topology spread, the volume-source zoo, matching the reference's
    11,650-line controller-gen output) with the hand-typed subset merged
    on top as the override layer. A mistyped ``livenessProbe.httpGet.port``
    or malformed ``affinity`` block is rejected server-side; fields beyond
    the expansion still flow through under preserve-unknown at the
    pod-spec level (future k8s fields must not brick existing CRs)."""
    from . import podspec_gen
    full = podspec_gen.pod_spec_schema_full()
    full[PRESERVE] = True
    return podspec_gen.merge_schema(full, pod_spec_subset())


# ------------------------------------------------------------------ validator


def validate_schema(value: Any, schema: dict, path: str = "") -> list[str]:
    """Validate ``value`` against an OpenAPI v3 structural schema; returns
    field-error strings shaped like apiserver field.Error messages."""
    errors: list[str] = []
    where = path or "<root>"
    expected = schema.get("type")

    if expected == "object":
        if not isinstance(value, dict):
            return [f"{where}: expected object, got {type(value).__name__}"]
        for req in schema.get("required", []):
            if req not in value:
                errors.append(f"{where}.{req}: required value")
        props = schema.get("properties", {})
        for key, sub in props.items():
            if key in value:
                errors.extend(validate_schema(value[key], sub,
                                              f"{where}.{key}"))
        extra = schema.get("additionalProperties")
        if isinstance(extra, dict):
            for key, item in value.items():
                if key not in props:
                    errors.extend(validate_schema(item, extra,
                                                  f"{where}.{key}"))
        return errors

    if expected == "array":
        if not isinstance(value, list):
            return [f"{where}: expected array, got {type(value).__name__}"]
        min_items = schema.get("minItems")
        if min_items is not None and len(value) < min_items:
            errors.append(f"{where}: must have at least {min_items} items")
        item_schema = schema.get("items")
        if item_schema:
            for i, item in enumerate(value):
                errors.extend(validate_schema(item, item_schema,
                                              f"{where}[{i}]"))
        return errors

    if expected == "string":
        if schema.get("x-kubernetes-int-or-string") and \
                isinstance(value, int) and not isinstance(value, bool):
            return []
        if not isinstance(value, str):
            return [f"{where}: expected string, got {type(value).__name__}"]
        min_len = schema.get("minLength")
        if min_len is not None and len(value) < min_len:
            errors.append(f"{where}: may not be empty")
        pattern = schema.get("pattern")
        if pattern and not re.match(pattern, value):
            errors.append(f"{where}: {value!r} does not match {pattern!r}")
    elif expected == "integer":
        if isinstance(value, bool) or not isinstance(value, int):
            return [f"{where}: expected integer, got {type(value).__name__}"]
    elif expected == "number":
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            return [f"{where}: expected number, got {type(value).__name__}"]
    elif expected == "boolean":
        if not isinstance(value, bool):
            return [f"{where}: expected boolean, got {type(value).__name__}"]

    enum = schema.get("enum")
    if enum is not None and value not in enum:
        errors.append(f"{where}: unsupported value {value!r}, expected one "
                      f"of {enum}")
    minimum = schema.get("minimum")
    if minimum is not None and isinstance(value, (int, float)) \
            and not isinstance(value, bool) and value < minimum:
        errors.append(f"{where}: must be >= {minimum}")
    maximum = schema.get("maximum")
    if maximum is not None and isinstance(value, (int, float)) \
            and not isinstance(value, bool) and value > maximum:
        errors.append(f"{where}: must be <= {maximum}")
    return errors
