"""Pipeline runtime-images sync.

The port's copy of ``kubeflow_tpu/controllers/runtime_images.py`` (the port
imports nothing of the JAX package), with the same names, objects
and writes.

Reference: odh notebook_runtime.go:40-285 — scrape ImageStreams labeled
``opendatahub.io/runtime-image`` in the controller namespace, extract each
tag's runtime metadata, and materialize a per-user-namespace
``pipeline-runtime-images`` ConfigMap (key = sanitized display name +
``.json``) that the webhook mounts at /opt/app-root/pipeline-runtimes.
"""

from __future__ import annotations

import json
import logging
import re

from ..cluster import errors
from ..utils import k8s, names

# API effect contract: what this module reads, watches and writes,
# kept as data as the reference declares it (its ci/effects.py
# checks the reference's copy); update it with the code.
CONTRACT = {
    "role": "helper",
    "reads": ["ConfigMap", "ImageStream"],
    "watches": [],
    "writes": {
        "ConfigMap": ["create", "update"],
    },
    "annotations": [
        "MANAGED_BY_LABEL", "RUNTIME_IMAGE_LABEL",
        "RUNTIME_IMAGE_METADATA_ANNOTATION",
    ],
}


log = logging.getLogger("kubeflow_tpu_torch.runtime_images")

RUNTIME_IMAGE_LABEL = names.RUNTIME_IMAGE_LABEL
METADATA_ANNOTATION = names.RUNTIME_IMAGE_METADATA_ANNOTATION
CONFIGMAP_NAME = "pipeline-runtime-images"

_invalid_chars = re.compile(r"[^-._a-zA-Z0-9]+")
_multi_dash = re.compile(r"-+")


def format_key_name(display_name: str) -> str:
    """Sanitize a display name into a ConfigMap key (reference
    formatKeyName, notebook_runtime.go:174-182): lowercase, invalid-char
    runs → ``-``, dash runs collapsed, trimmed; returns "" for an
    all-invalid name (caller skips the entry)."""
    s = _invalid_chars.sub("-", display_name.lower())
    s = _multi_dash.sub("-", s).strip("-")
    return f"{s}.json" if s else ""


def parse_runtime_image_metadata(raw: str, image_url: str) -> dict | None:
    """First object of the metadata JSON array with ``metadata.image_name``
    set to the tag's image reference (reference parseRuntimeImageMetadata,
    notebook_runtime.go:185-208); None when unparseable or empty (the
    reference's "{}" sentinel — callers skip the entry)."""
    try:
        meta_list = json.loads(raw)
    except ValueError:
        return None
    if not isinstance(meta_list, list) or not meta_list or \
            not isinstance(meta_list[0], dict):
        return None
    first = meta_list[0]
    if isinstance(first.get("metadata"), dict):
        first["metadata"]["image_name"] = image_url
    return first


def extract_display_name(entry: dict | None) -> str:
    """``display_name`` of a parsed entry, "" when absent/not a string
    (reference extractDisplayName, notebook_runtime.go:154-165)."""
    display = entry.get("display_name") if isinstance(entry, dict) else None
    return display if isinstance(display, str) else ""


def collect_runtime_images(client,
                           controller_namespace: str) -> dict[str, str]:
    """ImageStreams → {key: metadata-json} (reference
    SyncRuntimeImagesConfigMap's scrape loop, notebook_runtime.go:46-92):
    only streams labeled runtime-image=true; a labeled stream without tags
    or a tag without a ``from`` image reference is a logged
    misconfiguration; entries without a display_name are skipped."""
    out: dict[str, str] = {}
    for stream in client.list("ImageStream", controller_namespace,
                              {RUNTIME_IMAGE_LABEL: "true"}):
        tags = k8s.get_in(stream, "spec", "tags", default=[]) or []
        if not tags:
            log.error("ImageStream %s labeled as runtime-image has no tags "
                      "- possible misconfiguration", k8s.name(stream))
            continue
        for tag in tags:
            image_url = k8s.get_in(tag, "from", "name", default="")
            if not image_url:
                log.error("Failed to extract image URL from ImageStream %s "
                          "tag %s", k8s.name(stream), tag.get("name", ""))
                continue
            raw = k8s.get_in(tag, "annotations", METADATA_ANNOTATION) or "[]"
            parsed = parse_runtime_image_metadata(raw, image_url)
            display = extract_display_name(parsed)
            if not display:
                continue
            key = format_key_name(display)
            if not key:
                log.error("Failed to construct ConfigMap key name for "
                          "ImageStream %s tag %s", k8s.name(stream),
                          tag.get("name", ""))
                continue
            out[key] = json.dumps(parsed, sort_keys=True)
    return out


def sync_runtime_images_config_map(client, controller_namespace: str,
                                   user_namespace: str) -> None:
    """Reference SyncRuntimeImagesConfigMap (notebook_runtime.go:95-151):
    per-user-namespace projection of the controller-namespace inventory.
    With no runtime images found, an existing ConfigMap is deliberately
    LEFT AS IS (the reference chose not to delete, :109-117) and no empty
    ConfigMap is created."""
    data = collect_runtime_images(client, controller_namespace)
    existing = client.get_or_none("ConfigMap", user_namespace, CONFIGMAP_NAME)
    if not data:
        if existing is None:
            log.info("No runtime images found. Skipping creation of empty "
                     "ConfigMap.")
        else:
            log.info("Data is empty but the ConfigMap already exists. "
                     "Leaving it as is.")
        return
    if existing is None:
        try:
            client.create({
                "apiVersion": "v1",
                "kind": "ConfigMap",
                "metadata": {
                    "name": CONFIGMAP_NAME,
                    "namespace": user_namespace,
                    "labels": {names.MANAGED_BY_LABEL: "workbenches"},
                },
                "data": data,
            })
        except errors.AlreadyExistsError:
            pass
    elif existing.get("data") != data:
        existing["data"] = data
        client.update(existing)
