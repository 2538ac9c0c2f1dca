"""Mutating admission webhook for Notebook CRs.

The port's counterpart of ``kubeflow_tpu/webhook/mutating.py``, which
re-implements the admission pipeline of the reference's
NotebookWebhook.Handle (odh notebook_mutating_webhook.go:360-516):

1. CREATE only: the reconciliation lock, the stop annotation set to a
   sentinel so the StatefulSet starts at 0 replicas until the extension
   reconciler confirms the prerequisites (:382-389, :113-122);
2. image resolution, then the image swap: annotation-selected
   ImageStream tags resolve to digest-pinned references
   (SetContainerImageFromRegistry, :861-972), then a CR requesting an
   H100 slice gets an image that can drive NVIDIA cards. This is the one
   stage turned round against the reference, which swaps CUDA and
   generic images for its JAX/libtpu image: here a JAX, libtpu, TPU,
   ROCm or generic ``jupyter``/``notebook``/``workbench`` image with no
   CUDA in it is replaced by the mapped image
   (``config.image_swap_map``), else by ``config.tpu_default_image``
   (the CUDA ``DEFAULT_GPU_IMAGE``), and a CUDA image is kept. The
   replaced image is recorded under ``tpu.kubeflow.org/original-image``;
3. the CA bundle mount when the per-namespace trust ConfigMap exists
   (:699-859);
4. the pipeline runtime-images mount, the Feast config mount
   (label-gated), the Elyra secret mount and the MLflow env
   (:405-462), and the cluster-proxy env;
5. inject-auth: the kube-rbac-proxy sidecar (:183-334) with
   annotation-overridable resources (default cpu 100m / mem 64Mi);
6. restart gating (:518-581): webhook-caused pod-spec changes on a
   RUNNING notebook are parked in the ``update-pending`` annotation
   rather than applied, so admission never silently bounces a live
   slice; user-caused changes pass through.

``swap_image_for_gpu`` is the image stage as a function of one Notebook.
"""

from __future__ import annotations

import json
import logging

from ..api import types as api
from ..cluster.errors import InvalidError
from ..gpu.topology import GpuRequestError, parse_slice_request
from ..utils import k8s, names, tracing
from ..utils.config import DEFAULT_GPU_IMAGE, ControllerConfig
from .diff import first_differences
from .validating import AdmissionDenied

log = logging.getLogger("kubeflow_tpu_torch.webhook")
_tracer = tracing.get_tracer("kubeflow_tpu_torch.webhook")

CA_BUNDLE_CONFIGMAP = "workbench-trusted-ca-bundle"
CA_CERT_PATH = "/etc/pki/tls/custom-certs"
RUNTIME_IMAGES_CONFIGMAP = "pipeline-runtime-images"
RUNTIME_IMAGES_MOUNT = "/opt/app-root/pipeline-runtimes"
FEAST_MOUNT = "/opt/app-root/src/feast-config"
AUTH_PROXY_CONTAINER = "kube-rbac-proxy"
AUTH_PROXY_PORT = 8443


class NotebookMutatingWebhook:
    """Registered as an apiserver admission plugin (ClusterStore) or behind
    the AdmissionReview HTTPS server (webhook.server) — same handle()."""

    def __init__(self, client, config: ControllerConfig | None = None):
        self.client = client
        self.config = config or ControllerConfig()

    def install(self, store) -> None:
        store.register_admission(api.KIND, self.handle)

    # ------------------------------------------------------------ pipeline
    def handle(self, operation: str, notebook: dict, old: dict | None) -> dict:
        """One root span per admission with notebook/namespace/operation
        attributes, like the reference (:366-373)."""
        if operation not in ("CREATE", "UPDATE"):
            return notebook
        if k8s.is_deleting(notebook):
            return notebook
        with _tracer.start_span("notebook-mutating-webhook", {
                "notebook.name": k8s.name(notebook),
                "notebook.namespace": k8s.namespace(notebook),
                "admission.operation": operation}) as span:
            mutated = k8s.deepcopy(notebook)

            if operation == "CREATE":
                self._inject_reconciliation_lock(mutated)

            self._resolve_image_selection(mutated, operation)
            swap_image_for_gpu(mutated, swap_map=self.config.image_swap_map,
                               default_image=self.config.tpu_default_image)
            self._mount_ca_bundle(mutated)
            self._mount_runtime_images(mutated)
            self._mount_feast_config(mutated)
            self._mount_elyra_secret(mutated)
            self._inject_mlflow_env(mutated)
            self._inject_cluster_proxy_env(mutated)
            if k8s.get_annotation(mutated, names.INJECT_AUTH_ANNOTATION) == "true":
                self._inject_auth_proxy(mutated)
            else:
                self._remove_auth_proxy(mutated)

            if operation == "UPDATE" and old is not None:
                mutated = self._maybe_defer_updates(old, notebook, mutated)
            span.set_status(tracing.STATUS_OK)
            return mutated

    # ------------------------------------------------------ lock (stage 1)
    def _inject_reconciliation_lock(self, nb: dict) -> None:
        """Reference InjectReconciliationLock (:106-122): notebooks are born
        stopped under a sentinel value; the extension reconciler removes it
        once prerequisites (pull secrets, routes) exist."""
        anns = k8s.annotations(nb)
        if names.STOP_ANNOTATION not in anns:
            anns[names.STOP_ANNOTATION] = names.RECONCILIATION_LOCK_VALUE

    # ------------------------------------- image resolution (stage 2a)
    INTERNAL_REGISTRY_HOST = "image-registry.openshift-image-registry.svc:5000"

    def _resolve_image_selection(self, nb: dict, operation: str) -> None:
        """Annotation-driven image selection with digest pinning — reference
        SetContainerImageFromRegistry (notebook_mutating_webhook.go:861-972):

        - ``last-image-selection: <imagestream>:<tag>`` names the selection;
        - an image already pointing at the internal registry is left alone;
        - the ImageStream is looked up in the workbench-image-namespace
          annotation's namespace, defaulting to the controller namespace;
        - the newest item of the matching status tag provides the
          digest-pinned dockerImageReference, which becomes the container
          image (stable across reconciles — re-admission resolves to the
          same digest);
        - JUPYTER_IMAGE env (when present) is updated to the selection;
        - misses emit the reference's span events and leave the image as-is,
          except a malformed selection / missing tags, which deny admission.
        """
        selection = k8s.get_annotation(nb, names.IMAGE_SELECTION_ANNOTATION)
        if not selection:
            return
        # shared container convention (api.notebook_container: name-matched
        # else containers[0]) — webhook and reconcilers MUST target the same
        # container (api/types.py)
        container = api.notebook_container(nb)
        if container is None:
            raise InvalidError(
                f"notebook {k8s.name(nb)} has no containers to resolve the "
                f"image selection onto")
        if self.INTERNAL_REGISTRY_HOST in container.get("image", ""):
            return  # digest already pinned by the internal registry
        parts = selection.split(":")
        if len(parts) != 2:
            # strict on CREATE (reference errors on a malformed selection);
            # lenient on UPDATE so a pre-existing object carrying a legacy
            # or hand-written value is never bricked — stop/resume and
            # culling patches must keep flowing
            if operation == "CREATE":
                raise InvalidError(f"invalid image selection format: "
                                   f"{selection!r}")
            tracing.current_span().add_event(
                "image-selection-malformed", {"selection": selection})
            return
        stream_name, tag_name = parts
        stream_ns = (k8s.get_annotation(
            nb, names.WORKBENCH_IMAGE_NAMESPACE_ANNOTATION) or "").strip() \
            or self.config.controller_namespace
        stream = self.client.get_or_none("ImageStream", stream_ns, stream_name)
        if stream is None:
            tracing.current_span().add_event(
                "image-stream-not-found",
                {"imagestream": stream_name, "namespace": stream_ns})
            return
        tags = k8s.get_in(stream, "status", "tags", default=None)
        if not tags:
            tracing.current_span().add_event(
                "image-stream-tag-not-found", {"imagestream": stream_name})
            raise InvalidError(
                f"ImageStream {stream_ns}/{stream_name} has no status or tags")
        for tag in tags:
            if tag.get("tag") != tag_name:
                continue
            items = tag.get("items") or []
            if not items:
                continue
            newest = max(items, key=lambda item: item.get("created", ""))
            image_ref = newest.get("dockerImageReference", "")
            if not image_ref:
                continue
            container["image"] = image_ref
            for env in container.get("env", []) or []:
                if env.get("name") == "JUPYTER_IMAGE":
                    env["value"] = selection
                    break
            tracing.current_span().add_event(
                "image-resolved", {"selection": selection, "image": image_ref})
            return
        tracing.current_span().add_event(
            "image-stream-tag-not-found",
            {"imagestream": stream_name, "tag": tag_name})

    # ------------------------------------------------- CA bundle (stage 3)
    def _mount_ca_bundle(self, nb: dict) -> None:
        """Mount the per-namespace trust bundle when present (reference
        CheckAndMountCACertBundle → InjectCertConfig, :699-859). Unsets the
        mount when the ConfigMap is gone."""
        ns = k8s.namespace(nb)
        cm = self.client.get_or_none("ConfigMap", ns, CA_BUNDLE_CONFIGMAP)
        pod_spec = api.notebook_pod_spec(nb)
        container = api.notebook_container(nb)
        if container is None:
            return
        bundle_file = f"{CA_CERT_PATH}/ca-bundle.crt"
        if cm is None or not k8s.get_in(cm, "data", "ca-bundle.crt"):
            k8s.remove_volume(pod_spec, "trusted-ca")
            k8s.remove_volume_mount(container, "trusted-ca")
            for var in ("PIP_CERT", "REQUESTS_CA_BUNDLE", "SSL_CERT_FILE",
                        "PIPELINES_SSL_SA_CERTS", "GIT_SSL_CAINFO"):
                k8s.remove_env(container, var)
            return
        k8s.upsert_volume(pod_spec, {
            "name": "trusted-ca",
            "configMap": {
                "name": CA_BUNDLE_CONFIGMAP,
                "optional": True,
                "items": [{"key": "ca-bundle.crt", "path": "ca-bundle.crt"}],
            },
        })
        k8s.upsert_volume_mount(container, {
            "name": "trusted-ca", "mountPath": CA_CERT_PATH, "readOnly": True})
        for var in ("PIP_CERT", "REQUESTS_CA_BUNDLE", "SSL_CERT_FILE",
                    "PIPELINES_SSL_SA_CERTS", "GIT_SSL_CAINFO"):
            k8s.upsert_env(container, var, bundle_file)

    # --------------------------------------------- runtime images (stage 4)
    def _mount_runtime_images(self, nb: dict) -> None:
        """Sync then mount the per-namespace pipeline-runtime-images
        ConfigMap (reference Handle runs SyncRuntimeImagesConfigMap before
        MountPipelineRuntimeImages, notebook_mutating_webhook.go:405-418,
        so the FIRST notebook in a namespace already gets the mount)."""
        from ..cluster import errors
        from ..controllers import runtime_images
        ns = k8s.namespace(nb)
        try:
            runtime_images.sync_runtime_images_config_map(
                self.client, self.config.controller_namespace, ns)
        except errors.ApiError as e:
            # supplemental: a conflict with the extension reconciler's
            # concurrent sync must not fail admission
            log.warning("runtime-images sync skipped during admission: %s",
                        e)
        cm = self.client.get_or_none("ConfigMap", ns, RUNTIME_IMAGES_CONFIGMAP)
        pod_spec = api.notebook_pod_spec(nb)
        container = api.notebook_container(nb)
        if container is None:
            return
        if cm is None or not cm.get("data"):
            k8s.remove_volume(pod_spec, "runtime-images")
            k8s.remove_volume_mount(container, "runtime-images")
            return
        k8s.upsert_volume(pod_spec, {
            "name": "runtime-images",
            "configMap": {"name": RUNTIME_IMAGES_CONFIGMAP, "optional": True},
        })
        k8s.upsert_volume_mount(container, {
            "name": "runtime-images", "mountPath": RUNTIME_IMAGES_MOUNT,
            "readOnly": True})

    # ----------------------------------------------------- feast (stage 4)
    def _mount_feast_config(self, nb: dict) -> None:
        """Label-gated Feast config mount (reference
        notebook_feast_config.go:25-158): label on → mount
        <name>-feast-config; label off → unmount."""
        pod_spec = api.notebook_pod_spec(nb)
        container = api.notebook_container(nb)
        if container is None:
            return
        enabled = k8s.get_label(nb, names.FEAST_LABEL) == "true"
        if not enabled:
            k8s.remove_volume(pod_spec, "feast-config")
            k8s.remove_volume_mount(container, "feast-config")
            return
        # deliberately NOT optional: if the Feast ConfigMap is missing the
        # pod must fail to start, surfacing the misconfiguration (reference
        # mounts the CM without optional, notebook_feast_config.go:60-70,
        # asserted in notebook_feast_config_test.go:513-564)
        k8s.upsert_volume(pod_spec, {
            "name": "feast-config",
            "configMap": {"name": f"{k8s.name(nb)}-feast-config"},
        })
        k8s.upsert_volume_mount(container, {
            "name": "feast-config", "mountPath": FEAST_MOUNT, "readOnly": True})

    # ----------------------------------------------------- elyra (stage 4)
    def _mount_elyra_secret(self, nb: dict) -> None:
        """Sync then mount the Elyra runtime Secret when pipeline-secret
        sync is on (reference SyncElyraRuntimeConfigSecret + Mount,
        :421-437). The webhook syncs BEFORE mounting so the first notebook
        in a namespace already gets the mount — the reference's
        RHOAIENG-24545 race fix (notebook_dspa_secret.go:307-312)."""
        from ..cluster import errors
        from ..controllers import elyra
        if not self.config.set_pipeline_secret:
            return
        try:
            elyra.sync_elyra_runtime_secret(self.client, self.config,
                                            k8s.namespace(nb))
        except errors.ApiError as e:
            # supplemental integration: a write conflict with the extension
            # reconciler's concurrent sync must not fail admission — the
            # reconciler converges the secret on its next pass
            log.warning("elyra secret sync skipped during admission: %s", e)
        elyra.mount_elyra_secret(self.client, nb)

    # ---------------------------------------------------- mlflow (stage 4)
    def _inject_mlflow_env(self, nb: dict) -> None:
        """Annotation-gated MLflow env injection (reference
        HandleMLflowEnvVars, notebook_mlflow.go:273-324): a present,
        non-empty (trimmed) instance annotation injects
        MLFLOW_K8S_INTEGRATION=true and
        MLFLOW_TRACKING_AUTH=kubernetes-namespaced unconditionally;
        MLFLOW_TRACKING_URI only when a hostname is determinable (else it
        is removed, never failing admission — integration is optional)."""
        from ..controllers import rbac
        container = api.notebook_container(nb)
        if container is None:
            return
        instance = (k8s.get_annotation(
            nb, names.MLFLOW_INSTANCE_ANNOTATION) or "").strip()
        if not self.config.mlflow_enabled or not instance:
            for var in ("MLFLOW_TRACKING_URI", "MLFLOW_K8S_INTEGRATION",
                        "MLFLOW_TRACKING_AUTH"):
                k8s.remove_env(container, var)
            return
        from ..cluster import errors
        k8s.upsert_env(container, "MLFLOW_K8S_INTEGRATION", "true")
        k8s.upsert_env(container, "MLFLOW_TRACKING_AUTH",
                       rbac.MLFLOW_TRACKING_AUTH_VALUE)
        try:
            uri = rbac.get_mlflow_tracking_uri(self.client, self.config,
                                               instance)
        except errors.ApiError as e:
            # a failed Gateway/Route lookup must never deny admission —
            # integration is optional (reference logs and skips,
            # notebook_mlflow.go:303-310)
            log.warning("MLflow tracking URI lookup failed: %s", e)
            uri = None
        if uri is None:
            log.warning("unable to determine MLflow tracking URI, "
                        "skipping injection")
            k8s.remove_env(container, "MLFLOW_TRACKING_URI")
            return
        k8s.upsert_env(container, "MLFLOW_TRACKING_URI", uri)

    # ---------------------------------------- cluster proxy env (stage 4)
    def _inject_cluster_proxy_env(self, nb: dict) -> None:
        """Inject cluster egress-proxy env vars (reference injects
        HTTP_PROXY/HTTPS_PROXY/NO_PROXY from the cluster Proxy config,
        notebook_mutating_webhook.go:335-354,648-697), gated by
        INJECT_CLUSTER_PROXY_ENV. Injection only happens when ALL THREE
        status fields are populated, and existing env vars are never
        removed — a missing Proxy object (non-OpenShift cluster) or a
        transiently empty status must not strip user-supplied proxy env."""
        if not self.config.inject_cluster_proxy_env:
            return  # feature off: user-supplied proxy env is left alone
        container = api.notebook_container(nb)
        if container is None:
            return
        proxy = self.client.get_or_none("Proxy", "", "cluster")
        status = k8s.get_in(proxy or {}, "status", default={}) or {}
        values = {env_name: status.get(field_, "")
                  for env_name, field_ in (("HTTP_PROXY", "httpProxy"),
                                           ("HTTPS_PROXY", "httpsProxy"),
                                           ("NO_PROXY", "noProxy"))}
        if not all(values.values()):
            return
        for env_name, value in values.items():
            k8s.upsert_env(container, env_name, value)

    # ------------------------------------------------- sidecar (stage 5)
    def _auth_sidecar_resources(self, nb: dict) -> dict:
        """Parse + validate the sidecar resource annotations (reference
        parseAndValidateAuthSidecarResources,
        notebook_mutating_webhook.go:132-181): defaults 100m/64Mi, the
        split request/limit annotations (legacy combined forms set both),
        whitespace trimmed, invalid or negative quantities and
        request > limit DENY admission — the original notebook is
        preserved (fail-early, auth_proxy_resources_test.go:509-566)."""

        explicit = {
            "cpu-request": names.AUTH_SIDECAR_CPU_REQUEST_ANNOTATION,
            "cpu-limit": names.AUTH_SIDECAR_CPU_LIMIT_ANNOTATION,
            "memory-request": names.AUTH_SIDECAR_MEMORY_REQUEST_ANNOTATION,
            "memory-limit": names.AUTH_SIDECAR_MEMORY_LIMIT_ANNOTATION,
        }
        # value + the annotation it came from (for actionable errors)
        values = {"cpu-request": ("100m", None), "cpu-limit": ("100m", None),
                  "memory-request": ("64Mi", None),
                  "memory-limit": ("64Mi", None)}
        legacy = {"cpu": names.AUTH_SIDECAR_CPU_ANNOTATION,
                  "memory": names.AUTH_SIDECAR_MEMORY_ANNOTATION}
        # reference-exact presence rule (notebook_mutating_webhook.go:157):
        # an EMPTY-STRING annotation is treated as absent (defaults apply);
        # any non-empty value — including whitespace-only — is trimmed and
        # validated, so " " denies while "" defaults, matching the Go code
        for res, ann in legacy.items():
            raw = k8s.get_annotation(nb, ann)
            if raw:
                values[f"{res}-request"] = values[f"{res}-limit"] = (raw, ann)
        for key, ann in explicit.items():
            raw = k8s.get_annotation(nb, ann)
            if raw:
                values[key] = (raw, ann)

        parsed = {}
        for key, (raw, source) in values.items():
            raw = raw.strip()
            source = source or explicit[key]
            try:
                parsed[key] = k8s.parse_quantity(raw)
            except ValueError as e:
                raise AdmissionDenied(
                    "invalid kube-rbac-proxy resource configuration: "
                    f"invalid value for annotation '{source}': "
                    f"{raw!r}: {e}")
            if parsed[key] < 0:
                raise AdmissionDenied(
                    "invalid kube-rbac-proxy resource configuration: "
                    f"annotation '{source}' value '{raw}' cannot be "
                    "negative")
            values[key] = (raw, source)
        for res in ("cpu", "memory"):
            if parsed[f"{res}-request"] > parsed[f"{res}-limit"]:
                raise AdmissionDenied(
                    "invalid kube-rbac-proxy resource configuration: "
                    f"{res} request ({values[res + '-request'][0]}) "
                    f"cannot be greater than {res} limit "
                    f"({values[res + '-limit'][0]})")
        return {"requests": {"cpu": values["cpu-request"][0],
                             "memory": values["memory-request"][0]},
                "limits": {"cpu": values["cpu-limit"][0],
                           "memory": values["memory-limit"][0]}}

    def _inject_auth_proxy(self, nb: dict) -> None:
        """kube-rbac-proxy sidecar (reference InjectKubeRbacProxy, :183-334):
        TLS reverse proxy on 8443 doing SubjectAccessReview against the
        SAR ConfigMap; probes mirror the reference's 30s/5s liveness and
        5s/5s readiness (notebook_mutating_webhook.go:227-254)."""
        nb_name = k8s.name(nb)
        pod_spec = api.notebook_pod_spec(nb)
        sidecar = {
            "name": AUTH_PROXY_CONTAINER,
            "image": self.config.auth_proxy_image,
            "args": [
                f"--secure-listen-address=0.0.0.0:{AUTH_PROXY_PORT}",
                "--upstream=http://127.0.0.1:8888/",
                f"--config-file=/etc/kube-rbac-proxy/{nb_name}-rbac-config.yaml",
                "--tls-cert-file=/etc/tls/private/tls.crt",
                "--tls-private-key-file=/etc/tls/private/tls.key",
                "--v=2",
            ],
            "ports": [{"containerPort": AUTH_PROXY_PORT, "name": "auth-proxy",
                       "protocol": "TCP"}],
            "resources": self._auth_sidecar_resources(nb),
            "livenessProbe": {
                "httpGet": {"path": "/healthz", "port": AUTH_PROXY_PORT,
                            "scheme": "HTTPS"},
                "initialDelaySeconds": 30, "periodSeconds": 5,
                "timeoutSeconds": 1, "successThreshold": 1,
                "failureThreshold": 3,
            },
            "readinessProbe": {
                "httpGet": {"path": "/healthz", "port": AUTH_PROXY_PORT,
                            "scheme": "HTTPS"},
                "initialDelaySeconds": 5, "periodSeconds": 5,
                "timeoutSeconds": 1, "successThreshold": 1,
                "failureThreshold": 3,
            },
            "volumeMounts": [
                {"name": "rbac-config",
                 "mountPath": "/etc/kube-rbac-proxy", "readOnly": True},
                {"name": "tls-certificates",
                 "mountPath": "/etc/tls/private", "readOnly": True},
            ],
        }
        containers = pod_spec.setdefault("containers", [])
        for i, c in enumerate(containers):
            if c.get("name") == AUTH_PROXY_CONTAINER:
                containers[i] = sidecar
                break
        else:
            containers.append(sidecar)
        k8s.upsert_volume(pod_spec, {
            "name": "rbac-config",
            "configMap": {"name": f"{nb_name}-rbac-config"},
        })
        k8s.upsert_volume(pod_spec, {
            "name": "tls-certificates",
            "secret": {"secretName": f"{nb_name}-tls",
                       "defaultMode": 420},
        })

    def _remove_auth_proxy(self, nb: dict) -> None:
        pod_spec = api.notebook_pod_spec(nb)
        containers = pod_spec.get("containers")
        if containers:
            pod_spec["containers"] = [
                c for c in containers if c.get("name") != AUTH_PROXY_CONTAINER]
        k8s.remove_volume(pod_spec, "rbac-config")
        k8s.remove_volume(pod_spec, "tls-certificates")

    # ------------------------------------------- restart gating (stage 6)
    def _maybe_defer_updates(self, old: dict, incoming: dict,
                             mutated: dict) -> dict:
        """Reference maybeRestartRunningNotebook (:518-581).

        Three versions are compared:
        - ``old``      what is stored (and what the pods run);
        - ``incoming`` the user's update as submitted;
        - ``mutated``  incoming + this webhook's mutations.

        If the notebook is running and the *webhook's* mutations change the
        pod spec beyond what the user asked for, those mutations are reverted
        and recorded in update-pending — admission must never silently bounce
        a live slice (a template change restarts every worker). User-caused
        changes always pass through. Stopped notebooks take everything."""
        with _tracer.start_span("maybe-restart-running-notebook") as span:
            stopped = k8s.get_annotation(incoming, names.STOP_ANNOTATION) is not None
            if stopped:
                k8s.remove_annotation(mutated, names.UPDATE_PENDING_ANNOTATION)
                return mutated
            incoming_spec = k8s.get_in(incoming, "spec", default={})
            mutated_spec = k8s.get_in(mutated, "spec", default={})
            if mutated_spec == incoming_spec:
                k8s.remove_annotation(mutated, names.UPDATE_PENDING_ANNOTATION)
                return mutated
            diffs = first_differences(incoming_spec, mutated_spec, path="spec")
            log.info("parking webhook mutations on running notebook %s/%s: %s",
                     k8s.namespace(incoming), k8s.name(incoming), diffs)
            span.add_event("updates-parked", {"diffs": json.dumps(diffs)})
            parked = k8s.deepcopy(mutated)
            parked["spec"] = k8s.deepcopy(incoming_spec)
            k8s.set_annotation(parked, names.UPDATE_PENDING_ANNOTATION,
                               json.dumps(diffs))
            return parked


_NOT_FOR_NVIDIA = ("jax", "libtpu", "tpu", "rocm")
_CUDA = ("cuda", "gpu", "nvidia")
_GENERIC = ("jupyter", "notebook", "workbench")


def _cannot_drive_h100(image: str) -> bool:
    lowered = image.lower()
    if any(t in lowered for t in _NOT_FOR_NVIDIA):
        return True
    return any(t in lowered for t in _GENERIC) and \
        not any(t in lowered for t in _CUDA)


def swap_image_for_gpu(nb: dict, *, swap_map: dict | None = None,
                       default_image: str = DEFAULT_GPU_IMAGE) -> bool:
    """Give a Notebook that requests an H100 slice an image that can
    drive the cards: ``swap_map[image]`` when mapped, ``default_image``
    when the image cannot drive an NVIDIA card, else the image as it is.
    Returns whether the image was replaced, and adds the
    ``image-swapped`` or ``image-swap-skipped`` event to the current
    span. A Notebook with no request, or a malformed one (the validating
    webhook denies it), is left untouched."""
    try:
        spec = parse_slice_request(
            k8s.get_in(nb, "metadata", "annotations", default={}))
    except GpuRequestError:
        return False
    if spec is None:
        return False
    container = k8s.notebook_container(nb)
    if container is None:
        return False
    image = container.get("image", "")
    if image in (swap_map or {}):
        new_image = swap_map[image]
    elif _cannot_drive_h100(image):
        new_image = default_image
    else:
        # a CUDA image (or the user knows best): record why no swap
        tracing.current_span().add_event(
            "image-swap-skipped", {"image": image})
        return False
    if not new_image or new_image == image:
        return False
    k8s.set_annotation(nb, names.TPU_ORIGINAL_IMAGE_ANNOTATION, image)
    container["image"] = new_image
    tracing.current_span().add_event(
        "image-swapped", {"from": image, "to": new_image})
    return True
