"""The port's composition root: a manager with the core Notebook
reconciler, the idle culler, the slice repair reconciler, the warm
slice pool reconciler, the fleet scheduler and the extension
reconciler over the in-process apiserver, or over an apiserver the
port's ``HttpApiClient`` reaches.

The counterpart of ``kubeflow_tpu/main.py`` ``build_manager``
(``setup_controllers``, ``kubeflow_tpu/controllers/__init__.py``) with
its ``components`` selection: ``"core"`` (the default) the core binary's
reconcilers, ``"extension"`` the extension binary's reconciler alone,
``"all"`` both, the extension reconciler registered after the
scheduler, as the reference's order has it. One watch-fed
``CachingClient`` the reconcilers read through (Secrets, ConfigMaps and
Events read live), the Notebook, SlicePool and TPUQuota CRDs and their
admission (the store then validates each of those kinds against its
CRD's schema), with ``webhooks=True`` the mutating and then the
validating admission webhook on the store, the core reconciler, the
culler when ``config.enable_culling`` is set, the slice
repair reconciler when ``config.enable_slice_repair`` is, the SlicePool
reconciler when ``config.enable_slice_pool`` is and the fleet scheduler
when ``config.enable_scheduler`` is (the last three the default), and
with ``simulate_kubelet`` the StatefulSet/kubelet simulator on the same
cache, so a standalone run is a working control plane on one machine::

    mgr = build_manager(simulate_kubelet=True)
    mgr.start()
    mgr.client.create(new_notebook("demo", "ns", annotations={
        "tpu.kubeflow.org/accelerator": "h100-32"}))
    # → 4 replicas, a headless Service, TPU_WORKER_* env, SliceReady
    mgr.client.create(new_tpu_quota("team-a-cap", "team-a", 2))
    mgr.client.create(new_notebook("job", "team-a", annotations={
        "tpu.kubeflow.org/accelerator": "h100-8",
        "tpu.kubeflow.org/gang-slices": "2"}))
    # → Pending → Reserving → Admitted (GangAdmitted), then the roll
    mgr.stop()

    mgr = build_manager(simulate_kubelet=True, components="all",
                        webhooks=True)
    mgr.client.create(new_notebook(
        "wb", "ns", image="jupyter/jax-notebook", annotations={
            "tpu.kubeflow.org/accelerator": "h100-1",
            "notebooks.opendatahub.io/inject-auth": "true"}))
    # → admitted locked, with the CUDA image and the kube-rbac-proxy
    #   sidecar (the webhooks)
    mgr.run_until_idle()
    # → finalizers, auth SA/TLS Service/SAR ConfigMap/CRB, NetworkPolicies,
    #   the HTTPRoute in the controller namespace, the ReferenceGrant;
    #   the lock removed, then 0 → 1 replicas

Over the wire ``store`` is a ``cluster/http_client.py``
``HttpApiClient``: its ``rest_client_*`` and ``watch_resumes_total``
families go to the manager's registry, the read cache hears each
watch stream's gaps (``set_watch_gap_listener``: a kind whose stream is
down and cannot resume is read live until its resync lands), and
nothing is installed in process (``supports_inprocess_admission`` is
False): the apiserver's side holds the CRDs and the webhook
configurations, whose ``AdmissionServer`` its store calls over
AdmissionReview (``cluster/remote_admission.py``)::

    server = ClusterStore()
    install_notebook_crd(server)            # ... and the other CRDs
    proxy = ApiServerProxy(server); proxy.start()
    mgr = build_manager(HttpApiClient(proxy.url), components="all")
    mgr.start()

The defaults stay ``components="core"`` with no webhooks; the
reference's ``setup_controllers`` defaults to both binaries with the
webhooks, which the port's ``build_manager`` takes with its flags
(ROADMAP.md queue A item 9). Not yet in the port, each an item of that
queue: flags, TLS profiles, health endpoints, leader election and the
apiserver circuit breaker (no health tracker is attached to the
client: ``set_health_tracker`` waits for ``CircuitBreaker``).
"""

from __future__ import annotations

from .api.slicepool import install_slicepool_crd
from .api.tpuquota import install_tpuquota_crd
from .api.types import install_notebook_crd
from .cluster.cache import CachingClient
from .cluster.store import ClusterStore
from .controllers import (CullingReconciler, ExtensionReconciler, Manager,
                          NotebookReconciler, SchedulerReconciler,
                          SlicePoolReconciler, SliceRepairReconciler)
from .utils.config import ControllerConfig
from .utils.metrics import MetricsRegistry

# which binaries each selection runs: (core, extension)
_COMPONENTS = {"core": (True, False), "extension": (False, True),
               "all": (True, True)}


def build_manager(store=None, config: ControllerConfig | None = None, *,
                  simulate_kubelet: bool = False,
                  max_concurrent_reconciles: int | None = None,
                  components: str = "core", webhooks: bool = False,
                  ready_hook=None, prober=None):
    """Compose the control plane ``components`` selects; returns the
    manager.

    ``store`` defaults to a fresh in-process ``ClusterStore``, or is an
    ``HttpApiClient`` (see the module's docstring); ``config``
    to ``ControllerConfig.from_env()``; ``max_concurrent_reconciles`` to
    the config's (4). ``mgr.client`` and ``mgr.read_cache`` are the
    ``CachingClient`` over ``store`` (reads from the cache, writes to the
    store); read ``store`` itself for what the cache does not show, its
    resourceVersion counter for one. The manager carries a
    ``MetricsRegistry`` (``mgr.metrics``) with the workqueue family, the
    reconcile-phase histograms, the cache's index counters and the
    notebook series. With ``config.enable_culling`` the culler runs,
    probing Jupyter through ``prober(notebook)`` when one is given (else
    over HTTP, as the reference's). With ``config.enable_slice_repair``
    the slice repair reconciler watches Pods and Nodes and rolls a slice
    whose node or worker fails. With ``config.enable_slice_pool`` the
    SlicePool reconciler pre-rolls each pool's warm slices and binds a
    matching notebook to one in one reconcile. With
    ``config.enable_scheduler`` the fleet scheduler admits each
    gang-annotated notebook whole (``gang-slices``) under its tenant's
    TPUQuota before the core reconciler rolls it. ``store`` gets the
    Notebook CRD and its typed admission first, then the SlicePool and
    TPUQuota CRDs and their admission, in either case, as the
    reference's ``setup_controllers`` installs them. ``webhooks``
    installs the mutating webhook, then the validating one, on ``store``
    itself (admission never reads the cache): a created Notebook is
    locked, its image swapped for a CUDA one, its mounts and auth
    sidecar added, and a running one's webhook changes parked in
    ``update-pending``. ``ready_hook(pod) -> bool`` gates
    the simulator's readiness flip of a pod (chip_smoke.py forms and
    verifies the pod's NCCL world there). ``components`` is ``"core"``
    (the reconcilers above), ``"extension"`` (the extension reconciler
    alone: route, network policies, auth resources, CA bundle, runtime
    images, RBAC, the Elyra secret and the lock) or ``"all"`` (both).
    Not started: call ``mgr.start()`` or drive it with
    ``mgr.run_until_idle()``."""
    if components not in _COMPONENTS:
        raise ValueError(f"unknown components selection: {components!r}")
    core, extension = _COMPONENTS[components]
    store = store if store is not None else ClusterStore()
    config = config or ControllerConfig.from_env()
    metrics = MetricsRegistry()
    if hasattr(store, "attach_metrics"):
        store.attach_metrics(metrics)  # rest_client_* over the wire
    # a remote client cannot register in-process admission: there the
    # apiserver's side holds the CRDs and the webhook configurations
    if getattr(store, "supports_inprocess_admission", True):
        install_notebook_crd(store)
        install_slicepool_crd(store)
        install_tpuquota_crd(store)
        if webhooks:
            # mutating before validating, the apiserver's phase order
            from .webhook import (NotebookMutatingWebhook,
                                  NotebookValidatingWebhook)
            NotebookMutatingWebhook(store, config).install(store)
            NotebookValidatingWebhook(config).install(store)
    if max_concurrent_reconciles is None:
        max_concurrent_reconciles = config.max_concurrent_reconciles
    # the manager cache: watch-fed, payload kinds and Events read live
    read_client = CachingClient(store, auto_informer=False,
                                disable_for=("Secret", "ConfigMap", "Event"))
    read_client.attach_metrics(metrics)
    if hasattr(store, "set_watch_gap_listener"):
        # a dropped stream that cannot resume: its kind reads live until
        # the resync converges the cache
        store.set_watch_gap_listener(read_client.mark_watch_gap,
                                     read_client.mark_watch_recovered)
    mgr = Manager(read_client, read_cache=read_client,
                  max_concurrent_reconciles=max_concurrent_reconciles)
    mgr.attach_metrics(metrics)
    if core:
        NotebookReconciler(read_client, config, metrics).setup(mgr)
        if config.enable_culling:
            kwargs = {"prober": prober} if prober is not None else {}
            CullingReconciler(read_client, config, metrics,
                              **kwargs).setup(mgr)
        if config.enable_slice_repair:
            SliceRepairReconciler(read_client, config, metrics).setup(mgr)
        if config.enable_slice_pool:
            SlicePoolReconciler(read_client, config, metrics).setup(mgr)
        if config.enable_scheduler:
            SchedulerReconciler(read_client, config, metrics).setup(mgr)
    if extension:
        ExtensionReconciler(read_client, config, metrics).setup(mgr)
    if simulate_kubelet:
        from .cluster.kubelet import StatefulSetSimulator
        StatefulSetSimulator(mgr.read_cache,
                             ready_hook=ready_hook).setup(mgr)
    return mgr
