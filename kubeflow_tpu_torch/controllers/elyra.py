"""Elyra runtime-config Secret sync from DSPA CRs.

The port's copy of ``kubeflow_tpu/controllers/elyra.py`` (the port
imports nothing of the JAX package), with the same names, objects
and writes.

Reference: odh notebook_dspa_secret.go:49-484 — when a DSPA (Data Science
Pipelines Application) exists in the notebook's namespace and
SET_PIPELINE_SECRET is on, build the Elyra runtime config JSON
(``odh_dsp.json``: pipelines API endpoint + S3 object storage details +
embedded COS credentials) as a Secret owned by the DSPA, and mount it into
the notebook. The public-endpoint hostname is DISCOVERED from cluster
objects: the Gateway CR's first listener, with a Route fallback through the
Gateway's GatewayConfig owner (getHostnameForPublicEndpoint,
notebook_dspa_secret.go:104-147).

An incomplete or misconfigured DSPA is treated the same as a missing one
(log + skip): the Elyra integration is supplemental and must not block
notebook creation (notebook_dspa_secret.go:326-333).
"""

from __future__ import annotations

import base64
import json
import logging

from ..cluster import errors
from ..utils import k8s, names
from ..utils.config import ControllerConfig

# API effect contract: what this module reads, watches and writes,
# kept as data as the reference declares it (its ci/effects.py
# checks the reference's copy); update it with the code.
CONTRACT = {
    "role": "helper",
    "reads": ["DataSciencePipelinesApplication", "Gateway", "Route", "Secret"],
    "watches": [],
    "writes": {
        "Secret": ["create", "delete", "update"],
    },
    "annotations": ["MANAGED_BY_LABEL"],
}


log = logging.getLogger("kubeflow_tpu_torch.elyra")

SECRET_NAME = "ds-pipeline-config"
VOLUME_NAME = "elyra-dsp-config"
MOUNT_PATH = "/opt/app-root/src/.local/share/jupyter/metadata/runtimes"
MANAGED_BY_KEY = names.MANAGED_BY_LABEL
MANAGED_BY_VALUE = "workbenches"


class IncompleteDSPAError(ValueError):
    """The DSPA CR lacks required object-storage wiring (reference
    extractElyraRuntimeConfigInfo error paths,
    notebook_dspa_secret.go:200-262)."""


def _gateway_config_owner(gateway: dict) -> str:
    """Reference getGatewayConfigOwnerName (notebook_dspa_secret.go:90-102)."""
    for ref in k8s.get_in(gateway, "metadata", "ownerReferences",
                          default=[]) or []:
        if ref.get("kind") == "GatewayConfig":
            return ref.get("name", "")
    return ""


def discover_public_hostname(client, config: ControllerConfig) -> str:
    """Hostname for the Elyra public endpoint, by the reference's fallback
    chain (getHostnameForPublicEndpoint, notebook_dspa_secret.go:104-147):

    1. Gateway <gateway_name> in <gateway_namespace>: first listener's
       ``hostname``;
    2. else a Route in the gateway namespace owned by the Gateway's
       GatewayConfig owner, via ``spec.host``;
    3. else the static GATEWAY_URL config (our extension — the reference has
       no static override here and returns ""), else "".
    """
    gateway = client.get_or_none("Gateway", config.gateway_namespace,
                                 config.gateway_name)
    if gateway is not None:
        listeners = k8s.get_in(gateway, "spec", "listeners", default=[]) or []
        hostname = listeners[0].get("hostname", "") if listeners else ""
        if hostname:
            return hostname
        owner = _gateway_config_owner(gateway)
        if owner:
            for route in client.list("Route", config.gateway_namespace):
                for ref in k8s.get_in(route, "metadata", "ownerReferences",
                                      default=[]) or []:
                    if ref.get("kind") == "GatewayConfig" and \
                            ref.get("name") == owner:
                        host = k8s.get_in(route, "spec", "host", default="")
                        if host:
                            return host
                        # route found but host empty: reference stops the
                        # search here (getHostnameFromRoute returns "")
                        log.info("Route %s owned by GatewayConfig %s has "
                                 "empty spec.host", k8s.name(route), owner)
                        return config.gateway_url or ""
        else:
            log.info("Gateway has no GatewayConfig owner - cannot fall back "
                     "to Route")
    return config.gateway_url or ""


def _secret_value(secret: dict, key: str) -> str | None:
    """Decode one key of a Secret: ``data`` values are base64, with a
    ``stringData`` plaintext fallback (apiserver write-path convenience)."""
    data = secret.get("data") or {}
    if key in data:
        try:
            return base64.b64decode(data[key]).decode()
        except (ValueError, UnicodeDecodeError) as e:
            raise IncompleteDSPAError(
                f"unreadable value for key '{key}' in COS secret: {e}")
    string_data = secret.get("stringData") or {}
    if key in string_data:
        return string_data[key]
    return None


def extract_runtime_config(dspa: dict, config: ControllerConfig,
                           namespace: str, client=None) -> dict:
    """DSPA CR → Elyra runtime definition (reference
    extractElyraRuntimeConfigInfo, notebook_dspa_secret.go:189-303).

    Validation matches the reference's error chain: objectStorage →
    externalStorage → host → bucket → s3CredentialsSecret
    {secretName, accessKey, secretKey} must all be present, then the COS
    credentials Secret itself is fetched from the notebook namespace and
    must carry both keys; their VALUES are embedded as
    ``cos_username``/``cos_password``. Raises :class:`IncompleteDSPAError`
    on any gap (callers skip gracefully, per the reference).

    The pipelines ``api_endpoint`` comes from the DSPA's
    ``status.components.apiServer.externalUrl`` (reference :192); when the
    status is not yet populated we fall back to constructing the gateway
    URL shape (our extension — keeps the config usable pre-status).
    ``public_api_endpoint`` is set only when a hostname was discoverable
    (reference omits it otherwise, :281-291).
    """
    storage = k8s.get_in(dspa, "spec", "objectStorage")
    if storage is None:
        raise IncompleteDSPAError(
            "invalid DSPA CR: 'objectStorage' is not configured")
    s3 = storage.get("externalStorage")
    if not s3:
        raise IncompleteDSPAError(
            "invalid DSPA CR: 'objectStorage.externalStorage' is not "
            "configured")
    host = s3.get("host", "")
    if not host:
        raise IncompleteDSPAError(
            "invalid DSPA CR: missing or invalid 'host'")
    scheme = s3.get("scheme") or "https"
    bucket = s3.get("bucket", "")
    if not bucket:
        raise IncompleteDSPAError(
            "invalid DSPA CR: missing or invalid 'bucket'")
    creds = s3.get("s3CredentialsSecret")
    if not creds:
        raise IncompleteDSPAError(
            "invalid DSPA CR: 'objectStorage.externalStorage."
            "s3CredentialsSecret' is not configured")
    cos_secret = creds.get("secretName", "")
    if not cos_secret:
        raise IncompleteDSPAError(
            "invalid DSPA CR: 's3CredentialsSecret.secretName' is empty")
    username_key = creds.get("accessKey", "")
    if not username_key:
        raise IncompleteDSPAError(
            "invalid DSPA CR: 's3CredentialsSecret.accessKey' is empty")
    password_key = creds.get("secretKey", "")
    if not password_key:
        raise IncompleteDSPAError(
            "invalid DSPA CR: 's3CredentialsSecret.secretKey' is empty")

    username = password = None
    if client is not None:
        secret = client.get_or_none("Secret", namespace, cos_secret)
        if secret is None:
            raise IncompleteDSPAError(
                f"failed to get secret '{cos_secret}': not found")
        username = _secret_value(secret, username_key)
        if username is None:
            raise IncompleteDSPAError(
                f"missing key '{username_key}' in secret '{cos_secret}'")
        password = _secret_value(secret, password_key)
        if password is None:
            raise IncompleteDSPAError(
                f"missing key '{password_key}' in secret '{cos_secret}'")

    hostname = discover_public_hostname(client, config) if client is not None \
        else (config.gateway_url or "")
    api_endpoint = k8s.get_in(dspa, "status", "components", "apiServer",
                              "externalUrl", default="")
    if not api_endpoint:
        api_endpoint = (f"https://{hostname or 'gateway.invalid'}/pipelines/"
                        f"{namespace}/{k8s.name(dspa)}")
    metadata = {
        "tags": [],
        "display_name": "Pipeline",
        "engine": "Argo",
        "runtime_type": "KUBEFLOW_PIPELINES",
        "auth_type": "KUBERNETES_SERVICE_ACCOUNT_TOKEN",
        "cos_auth_type": "KUBERNETES_SECRET",
        "api_endpoint": api_endpoint,
        "cos_endpoint": f"{scheme}://{host}",
        "cos_bucket": bucket,
        "cos_secret": cos_secret,
    }
    if username is not None:
        metadata["cos_username"] = username
        metadata["cos_password"] = password
    if hostname:
        metadata["public_api_endpoint"] = \
            f"https://{hostname}/external/elyra/{namespace}"
    return {
        "display_name": "Pipeline",
        "metadata": metadata,
        "schema_name": "kfp",
    }


def sync_elyra_runtime_secret(client, config: ControllerConfig,
                              namespace: str) -> bool:
    """Create/update the runtime Secret from the namespace's DSPA; returns
    True when a secret exists after the call. The Secret is owned by the
    DSPA (controller=true, blockOwnerDeletion=false — reference
    notebook_dspa_secret.go:353-362) so it dies with it. An incomplete DSPA
    logs and skips — never an error (reference :326-333). The update path
    also repairs a stripped managed-by label (requiresUpdate,
    reference :383-397)."""
    dspas = client.list("DataSciencePipelinesApplication", namespace)
    if not dspas:
        existing = client.get_or_none("Secret", namespace, SECRET_NAME)
        if existing is not None and k8s.get_in(
                existing, "metadata", "labels", MANAGED_BY_KEY,
                default=None) == MANAGED_BY_VALUE:
            # only OUR projection dies with the DSPA — a foreign secret
            # that happens to share the name is never touched
            try:
                client.delete("Secret", namespace, SECRET_NAME)
            except errors.NotFoundError:
                pass
        return False
    dspa = sorted(dspas, key=k8s.name)[0]
    try:
        runtime = extract_runtime_config(dspa, config, namespace, client)
    except IncompleteDSPAError as e:
        log.info("DSPA CR is incomplete, skipping Elyra secret creation "
                 "(namespace=%s): %s", namespace, e)
        return False
    payload = base64.b64encode(
        json.dumps(runtime, sort_keys=True).encode()).decode()
    desired_data = {"odh_dsp.json": payload}
    existing = client.get_or_none("Secret", namespace, SECRET_NAME)
    if existing is None:
        secret = {
            "apiVersion": "v1",
            "kind": "Secret",
            "metadata": {
                "name": SECRET_NAME,
                "namespace": namespace,
                "labels": {MANAGED_BY_KEY: MANAGED_BY_VALUE},
            },
            "type": "Opaque",
            "data": desired_data,
        }
        # blockOwnerDeletion=false per the reference (avoids requiring
        # delete permission on the DSPA under ownerref enforcement)
        secret["metadata"]["ownerReferences"] = [
            k8s.new_owner_ref(dspa, block_owner_deletion=False)]
        try:
            client.create(secret)
        except errors.AlreadyExistsError:
            pass
    else:
        labels_changed = k8s.merge_managed_labels(
            existing, {MANAGED_BY_KEY: MANAGED_BY_VALUE})
        if existing.get("data") != desired_data or labels_changed:
            existing["data"] = desired_data
            client.update(existing)
    return True


def mount_elyra_secret(client, notebook: dict) -> None:
    """Mount the runtime Secret into EVERY notebook container (reference
    MountElyraRuntimeConfigSecret, notebook_dspa_secret.go:403-469). Skips
    when the secret is absent, not managed by workbenches, or empty; the
    mount is deduplicated by volume name AND mountPath per container."""
    from ..api import types as api

    secret = client.get_or_none("Secret", k8s.namespace(notebook),
                                SECRET_NAME)
    if secret is None:
        log.info("Secret %s is not available yet", SECRET_NAME)
        return
    labels = k8s.get_in(secret, "metadata", "labels", default={}) or {}
    if labels.get(MANAGED_BY_KEY) != MANAGED_BY_VALUE:
        log.info("Skipping mounting secret not managed by workbenches")
        return
    if not secret.get("data"):
        log.info("Secret %s is empty, skipping volume mount", SECRET_NAME)
        return

    pod_spec = api.notebook_pod_spec(notebook)
    if not any(v.get("name") == VOLUME_NAME
               for v in pod_spec.get("volumes", [])):
        k8s.upsert_volume(pod_spec, {
            "name": VOLUME_NAME,
            "secret": {"secretName": SECRET_NAME, "optional": True},
        })
    for container in pod_spec.get("containers", []):
        if any(m.get("name") == VOLUME_NAME or
               m.get("mountPath") == MOUNT_PATH
               for m in container.get("volumeMounts", [])):
            continue
        k8s.upsert_volume_mount(container, {
            "name": VOLUME_NAME, "mountPath": MOUNT_PATH, "readOnly": True})
