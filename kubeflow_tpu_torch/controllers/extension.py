"""Extension reconciler — the odh-notebook-controller analog.

The port's copy of ``kubeflow_tpu/controllers/extension.py`` (the port
imports nothing of the JAX package), with the same names, objects
and writes.

Second reconciler watching the SAME Notebook CRD (reference
OpenshiftNotebookReconciler, odh notebook_controller.go:190-526), cooperating
with the core reconciler purely through API-server state (SURVEY §1). Per
notebook it manages: the CA trust bundle, NetworkPolicies, runtime-images
ConfigMap, pipeline/MLflow RBAC, Elyra secret, the shared ReferenceGrant,
auth-proxy resources or a plain HTTPRoute, and finally removes the webhook's
reconciliation lock so the core reconciler scales the slice up.

Cross-namespace/cluster-scoped resources (central-ns HTTPRoutes, the
auth-delegator ClusterRoleBinding, the shared ReferenceGrant) cannot be GC'd
via ownerReferences, so deletion is finalizer-driven with the reference's
partial-progress semantics (:278-330): each cleanup that succeeds strips its
finalizer; failures leave theirs for the next requeue and surface a combined
error.

The port has no admission webhooks yet (ROADMAP.md queue A item 6), so no
webhook puts the lock on a new notebook: a notebook is locked only when
its creator writes the stop annotation with ``RECONCILIATION_LOCK_VALUE``,
and this reconciler removes it as the reference's does."""

from __future__ import annotations

import logging

from ..api import types as api
from ..cluster import errors, events
from ..utils import drift, k8s, names
from ..utils.config import ControllerConfig
from ..utils.metrics import MetricsRegistry
from . import auth, cacert, netpol, oauth, rbac, routes, runtime_images
from .manager import Manager, Request, Result, owner_mapper

# API effect contract: what this module reads, watches and writes,
# kept as data as the reference declares it (its ci/effects.py
# checks the reference's copy); update it with the code.
CONTRACT = {
    "role": "reconciler",
    "primary": "Notebook",
    "reads": [
        "ClusterRole", "ClusterRoleBinding", "ConfigMap", "HTTPRoute",
        "ImageStream", "NetworkPolicy", "Notebook", "ReferenceGrant", "Role",
        "RoleBinding", "Service", "ServiceAccount",
    ],
    "watches": [
        "ConfigMap", "HTTPRoute", "ImageStream", "NetworkPolicy", "Notebook",
        "ReferenceGrant", "RoleBinding", "Service", "ServiceAccount",
    ],
    "writes": {
        "ClusterRoleBinding": ["create", "delete"],
        "ConfigMap": ["create", "delete", "patch", "update"],
        "Event": ["create"],
        "HTTPRoute": ["create", "delete", "update"],
        "NetworkPolicy": ["create", "delete", "update"],
        "Notebook": ["patch", "update"],
        "OAuthClient": ["delete"],
        "ReferenceGrant": ["create", "delete", "update"],
        "RoleBinding": ["create", "delete", "update"],
        "Service": ["create", "delete", "patch"],
        "ServiceAccount": ["create", "delete", "patch"],
    },
    "annotations": [
        "INJECT_AUTH_ANNOTATION", "NOTEBOOK_NAME_LABEL", "STOP_ANNOTATION",
    ],
    "unwatched_writes": {
        "ClusterRoleBinding": "one-shot OAuth proxy RBAC; deleted via "
            "finalizer, no drift to reconcile",
        "OAuthClient": "finalizer-only cleanup of the cluster OAuth "
            "registration",
    },
    "cross_namespace": {
        "ClusterRoleBinding": "cluster-scoped OAuth proxy RBAC",
        "HTTPRoute": "routes live in the gateway controller namespace",
        "OAuthClient": "cluster-scoped OAuth registration",
    },
}


log = logging.getLogger("kubeflow_tpu_torch.extension")

FINALIZER_ROUTES = names.ROUTES_CLEANUP_FINALIZER
FINALIZER_REFGRANT = names.REFGRANT_CLEANUP_FINALIZER
FINALIZER_CRB = names.CRB_CLEANUP_FINALIZER
ALL_FINALIZERS = (FINALIZER_ROUTES, FINALIZER_REFGRANT, FINALIZER_CRB)


def _copy_payload_fields(desired: dict, found: dict) -> bool:
    """Copy*Fields contract for the auth resources: the controller owns
    ``spec`` (Service) / ``data`` (the SAR ConfigMap); everything else —
    clusterIP the server assigned, foreign labels — stays untouched."""
    changed = False
    for payload in ("spec", "data"):
        if desired.get(payload) is not None and \
                found.get(payload) != desired.get(payload):
            found[payload] = k8s.deepcopy(desired[payload])
            changed = True
    return changed


class ExtensionReconciler:
    name = "extension-controller"

    def __init__(self, client, config: ControllerConfig | None = None,
                 metrics: MetricsRegistry | None = None):
        # record write rvs → drop self-echo watch events (cluster/echo.py)
        from ..cluster.echo import EchoTrackingClient
        client = EchoTrackingClient(client)
        self.client = client
        self.config = config or ControllerConfig()
        self.metrics = metrics or MetricsRegistry()
        self.recorder = events.EventRecorder(client, component=self.name)

    def setup(self, mgr: Manager) -> None:
        """Reference SetupWithManager (:736-884): own SA/Service/ConfigMap/
        NetworkPolicy/RoleBinding, watch central-ns HTTPRoutes by label and
        the CA source ConfigMaps."""
        mgr.register(self)
        ne = self.client.not_echo
        mgr.watch(api.KIND, self.name, predicate=ne)
        for kind in ("ServiceAccount", "Service", "ConfigMap",
                     "NetworkPolicy", "RoleBinding"):
            mgr.watch(kind, self.name, mapper=owner_mapper(api.KIND),
                      predicate=ne)
        mgr.watch("HTTPRoute", self.name, mapper=self._route_mapper,
                  predicate=ne)
        mgr.watch("ConfigMap", self.name, mapper=self._ca_source_mapper,
                  predicate=ne)
        mgr.watch("ReferenceGrant", self.name, mapper=self._grant_mapper,
                  predicate=ne)
        # runtime-image inventory: watching it (reference odh manager does)
        # both resyncs every namespace's pipeline-runtime-images ConfigMap
        # on change AND lets the manager cache serve the per-reconcile
        # inventory list — previously a live LIST per reconcile
        mgr.watch("ImageStream", self.name,
                  mapper=self._runtime_image_mapper, predicate=ne)

    def _grant_mapper(self, obj: dict) -> list[Request]:
        """The shared per-namespace grant has no ownerRef (it outlives any
        single notebook) — map its events onto every notebook in the
        namespace so a deleted/drifted grant is restored (reference
        Watches ReferenceGrant, odh notebook_controller.go:736-884)."""
        if k8s.name(obj) != routes.REFERENCE_GRANT_NAME:
            return []
        ns = k8s.namespace(obj)
        return [Request(ns, k8s.name(nb))
                for nb in self.client.list(api.KIND, ns)]

    def _runtime_image_mapper(self, obj: dict) -> list[Request]:
        """A labeled runtime-image ImageStream changed → re-project the
        pipeline-runtime-images ConfigMap everywhere (reference watches
        ImageStreams, odh notebook_runtime.go)."""
        if k8s.get_label(obj, runtime_images.RUNTIME_IMAGE_LABEL) != "true":
            return []
        return [Request(k8s.namespace(nb), k8s.name(nb))
                for nb in self.client.list(api.KIND)]

    def _route_mapper(self, obj: dict) -> list[Request]:
        nb = k8s.get_label(obj, names.NOTEBOOK_NAME_LABEL)
        ns = k8s.get_label(obj, routes.ROUTE_NAMESPACE_LABEL)
        return [Request(ns, nb)] if nb and ns else []

    def _ca_source_mapper(self, obj: dict) -> list[Request]:
        if k8s.name(obj) not in (cacert.TRUSTED_CA_BUNDLE, cacert.KUBE_ROOT_CA,
                                 cacert.SERVICE_CA):
            return []
        # trust changed → re-reconcile every notebook (reference watches CA
        # ConfigMaps cluster-wide)
        return [Request(k8s.namespace(nb), k8s.name(nb))
                for nb in self.client.list(api.KIND)]

    # ------------------------------------------------------------ reconcile
    def reconcile(self, req: Request) -> Result | None:
        notebook = self.client.get_or_none(api.KIND, req.namespace, req.name)
        if notebook is None:
            return None
        if k8s.is_deleting(notebook):
            return self._reconcile_deletion(notebook)

        auth_mode = k8s.get_annotation(
            notebook, names.INJECT_AUTH_ANNOTATION) == "true"

        if self._ensure_finalizers(notebook, auth_mode):
            # explicit immediate requeue: our own update's watch echo is
            # suppressed (echo.py contract), so resuming must not depend
            # on it coming back
            return Result(requeue_after=0.0)

        cacert.reconcile_ca_bundle(self.client,
                                   self.config.controller_namespace,
                                   req.namespace)
        netpol.reconcile_network_policies(self.client, notebook,
                                          self.config.controller_namespace,
                                          auth=auth_mode)
        runtime_images.sync_runtime_images_config_map(
            self.client, self.config.controller_namespace, req.namespace)
        if self.config.set_pipeline_rbac:
            rbac.reconcile_pipeline_rbac(self.client, notebook)
        if self.config.set_pipeline_secret:
            from . import elyra
            elyra.sync_elyra_runtime_secret(self.client, self.config,
                                            req.namespace)
        routes.reconcile_reference_grant(self.client, self.config, notebook)

        if auth_mode:
            self._reconcile_auth_resources(notebook)
        elif k8s.has_finalizer(notebook, FINALIZER_CRB):
            # auth switched OFF: per-notebook auth resources exist only if a
            # previous auth-mode pass provisioned them, and that pass always
            # added FINALIZER_CRB first — so the finalizer is the marker.
            # Without this gate every no-auth reconcile issued 4 blind
            # DELETE-404s + a live CRB GET (measured: ~40% of all wire
            # requests in the 300-notebook fan-out were these 404s).
            self._cleanup_auth_resources(notebook)
            self._drop_crb_finalizer(notebook)
        routes.reconcile_httproute(self.client, self.config, notebook,
                                   auth=auth_mode)

        requeue = None
        if self.config.mlflow_enabled:
            requeue = rbac.reconcile_mlflow_integration(self.client, notebook,
                                                        recorder=self.recorder)

        self._remove_reconciliation_lock(notebook)
        return Result(requeue_after=requeue) if requeue else None

    # ----------------------------------------------------------- finalizers
    def _ensure_finalizers(self, notebook: dict, auth_mode: bool) -> bool:
        """Add the cleanup finalizers before creating anything they guard
        (reference :335-381 adds + requeues). Returns True if an update was
        written (caller should yield)."""
        wanted = [FINALIZER_ROUTES, FINALIZER_REFGRANT]
        if auth_mode:
            wanted.append(FINALIZER_CRB)
        added = False
        for fin in wanted:
            added |= k8s.add_finalizer(notebook, fin)
        if added:
            try:
                self.client.update(notebook)
            except errors.ConflictError:
                pass  # watch re-enqueues with fresh version
            return True
        return False

    def _reconcile_deletion(self, notebook: dict) -> Result | None:
        """Deletion branch (reference :207-333): run each finalizer's
        cleanup; strip exactly the finalizers whose cleanup succeeded;
        combined error → requeue for the rest."""
        cleanups = {
            # legacy OAuthClient first, as in the reference (:214-229) —
            # never added by this controller, only inherited from pre-auth-
            # proxy versions (oauth.py)
            oauth.LEGACY_OAUTH_FINALIZER: lambda:
                oauth.delete_oauth_client(self.client, notebook),
            FINALIZER_ROUTES: lambda: routes.delete_routes_for_notebook(
                self.client, self.config, notebook),
            FINALIZER_REFGRANT: lambda:
                routes.delete_reference_grant_if_last_notebook(
                    self.client, self.config, notebook),
            FINALIZER_CRB: lambda: self._cleanup_crb(notebook),
        }
        failures: list[str] = []
        succeeded: list[str] = []
        for fin, cleanup in cleanups.items():
            if not k8s.has_finalizer(notebook, fin):
                continue
            try:
                cleanup()
                succeeded.append(fin)
            except Exception as exc:  # noqa: BLE001 — collect, finish others
                failures.append(f"{fin}: {exc}")
        if succeeded:
            from ..cluster.cache import live_reader
            live = live_reader(self.client)

            def strip(cur: dict) -> bool:
                changed = False
                for fin in succeeded:
                    changed |= k8s.remove_finalizer(cur, fin)
                return changed
            errors.update_with_conflict_retry(
                self.client,
                lambda: live.get_or_none(api.KIND, k8s.namespace(notebook),
                                         k8s.name(notebook)),
                strip, attempts=5)
        if failures:
            raise RuntimeError("finalization incomplete: " +
                               "; ".join(failures))
        return None

    def _cleanup_crb(self, notebook: dict) -> None:
        try:
            self.client.delete(
                "ClusterRoleBinding", "",
                auth.crb_name(k8s.namespace(notebook), k8s.name(notebook)))
        except errors.NotFoundError:
            pass

    # ----------------------------------------------------------- auth mode
    def _reconcile_auth_resources(self, notebook: dict) -> None:
        ns = k8s.namespace(notebook)
        for desired in (auth.new_service_account(notebook),
                        auth.new_rbac_config_map(notebook),
                        auth.new_tls_service(notebook)):
            existing = self.client.get_or_none(desired["kind"], ns,
                                               k8s.name(desired))
            if existing is None:
                try:
                    self.client.create(desired)
                except errors.AlreadyExistsError:
                    pass
                continue
            # repair drift on whichever payload the resource carries: spec
            # (Service) or data (the SAR ConfigMap — tampering with it would
            # change what the auth proxy authorizes). Drift-aware minimal
            # patch: no drift → no write; drift → only the changed paths,
            # no resourceVersion to conflict on.
            patch = drift.minimal_update_patch(desired, existing,
                                               _copy_payload_fields)
            if patch is not None:
                self.client.patch(desired["kind"], ns, k8s.name(desired),
                                  patch)
        crb = auth.new_auth_delegator_crb(notebook)
        if self.client.get_or_none("ClusterRoleBinding", "",
                                   k8s.name(crb)) is None:
            try:
                self.client.create(crb)
            except errors.AlreadyExistsError:
                pass

    def _drop_crb_finalizer(self, notebook: dict) -> None:
        """Cleanup succeeded with auth off: the CRB finalizer no longer
        guards anything — strip it so subsequent reconciles skip the
        cleanup path entirely (and deletion doesn't run it again)."""
        from ..cluster.cache import live_reader
        live = live_reader(self.client)
        errors.update_with_conflict_retry(
            self.client,
            lambda: live.get_or_none(api.KIND, k8s.namespace(notebook),
                                     k8s.name(notebook)),
            lambda cur: k8s.remove_finalizer(cur, FINALIZER_CRB))

    def _cleanup_auth_resources(self, notebook: dict) -> None:
        """Auth switched off: remove per-notebook auth resources (the
        reference's mode switch also deletes the conflicting route, handled
        in routes.reconcile_httproute)."""
        ns, nb_name = k8s.namespace(notebook), k8s.name(notebook)
        for kind, name in (("ServiceAccount", auth.sa_name(nb_name)),
                           ("ConfigMap", auth.rbac_config_name(nb_name)),
                           ("Service", auth.tls_service_name(nb_name))):
            try:
                self.client.delete(kind, ns, name)
            except errors.NotFoundError:
                pass
        self._cleanup_crb(notebook)

    # ------------------------------------------------------- lock removal
    def _remove_reconciliation_lock(self, notebook: dict) -> None:
        """Reference RemoveReconciliationLock (:516-523 via :155-180): once
        prerequisites exist, drop the sentinel stop annotation via merge
        patch so the core reconciler scales the slice 0→N. Only the
        LOCK value is removed — a user/culler stop stays."""
        if k8s.get_annotation(notebook, names.STOP_ANNOTATION) != \
                names.RECONCILIATION_LOCK_VALUE:
            return
        if not self._prerequisites_ready(notebook):
            return
        self.client.patch(api.KIND, k8s.namespace(notebook),
                          k8s.name(notebook), {
            "metadata": {"annotations": {names.STOP_ANNOTATION: None}}})

    def _prerequisites_ready(self, notebook: dict) -> bool:
        """The reference waits (3 retries, backoff) for the SA image-pull
        secret before unlocking. Our store has no SA-token controller, so
        the check is gated: strict mode verifies the default SA exists with
        an imagePullSecret; lenient mode (default) unlocks immediately."""
        if not getattr(self.config, "lock_requires_pull_secret", False):
            return True
        sa = self.client.get_or_none("ServiceAccount",
                                     k8s.namespace(notebook), "default")
        return bool(sa and sa.get("imagePullSecrets"))
