"""The port's composition root: a manager with the core Notebook
reconciler, the idle culler, the slice repair reconciler, the warm
slice pool reconciler and the fleet scheduler over the in-process
apiserver.

The counterpart of the ``components="core"`` path of
``kubeflow_tpu/main.py`` ``build_manager`` (``setup_controllers``,
``kubeflow_tpu/controllers/__init__.py``): one watch-fed ``CachingClient``
the reconcilers read through (Secrets, ConfigMaps and Events read live),
the SlicePool and TPUQuota CRDs and their admission, the core
reconciler, the culler when ``config.enable_culling`` is set, the slice
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

Not yet in the port, each an item of ROADMAP.md's queue A: the
extension manager and the admission webhooks (``components="extension"``
or ``"all"``), flags, TLS, the webhook server, health endpoints and
leader election.
"""

from __future__ import annotations

from .api.slicepool import install_slicepool_crd
from .api.tpuquota import install_tpuquota_crd
from .cluster.cache import CachingClient
from .cluster.store import ClusterStore
from .controllers import (CullingReconciler, Manager, NotebookReconciler,
                          SchedulerReconciler, SlicePoolReconciler,
                          SliceRepairReconciler)
from .utils.config import ControllerConfig
from .utils.metrics import MetricsRegistry

# what each other selection of the reference needs, by ROADMAP.md item
_NOT_PORTED = {
    "extension": "queue A item 5 (the extension reconciler and its "
                 "satellites) and item 6 (the webhooks)",
    "all": "queue A items 5 and 6 (the extension reconciler and the "
           "webhooks)",
}


def build_manager(store=None, config: ControllerConfig | None = None, *,
                  simulate_kubelet: bool = False,
                  max_concurrent_reconciles: int | None = None,
                  components: str = "core", ready_hook=None, prober=None):
    """Compose the core control plane; returns the manager.

    ``store`` defaults to a fresh in-process ``ClusterStore``; ``config``
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
    SlicePool and TPUQuota CRDs and their admission in either case, as
    the reference's ``setup_controllers`` installs them. ``ready_hook(pod) -> bool`` gates
    the simulator's readiness flip of a pod (chip_smoke.py forms and
    verifies the pod's NCCL world there). Not started: call
    ``mgr.start()`` or drive it with ``mgr.run_until_idle()``."""
    if components != "core":
        reason = _NOT_PORTED.get(components)
        if reason is None:
            raise ValueError(f"unknown components selection: {components!r}")
        raise ValueError(f"components={components!r} is not ported yet: "
                         f"ROADMAP.md {reason}")
    store = store if store is not None else ClusterStore()
    config = config or ControllerConfig.from_env()
    install_slicepool_crd(store)
    install_tpuquota_crd(store)
    if max_concurrent_reconciles is None:
        max_concurrent_reconciles = config.max_concurrent_reconciles
    metrics = MetricsRegistry()
    # the manager cache: watch-fed, payload kinds and Events read live
    read_client = CachingClient(store, auto_informer=False,
                                disable_for=("Secret", "ConfigMap", "Event"))
    read_client.attach_metrics(metrics)
    mgr = Manager(read_client, read_cache=read_client,
                  max_concurrent_reconciles=max_concurrent_reconciles)
    mgr.attach_metrics(metrics)
    NotebookReconciler(read_client, config, metrics).setup(mgr)
    if config.enable_culling:
        kwargs = {"prober": prober} if prober is not None else {}
        CullingReconciler(read_client, config, metrics, **kwargs).setup(mgr)
    if config.enable_slice_repair:
        SliceRepairReconciler(read_client, config, metrics).setup(mgr)
    if config.enable_slice_pool:
        SlicePoolReconciler(read_client, config, metrics).setup(mgr)
    if config.enable_scheduler:
        SchedulerReconciler(read_client, config, metrics).setup(mgr)
    if simulate_kubelet:
        from .cluster.kubelet import StatefulSetSimulator
        StatefulSetSimulator(mgr.read_cache,
                             ready_hook=ready_hook).setup(mgr)
    return mgr
