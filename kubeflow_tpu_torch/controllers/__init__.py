"""The port's control plane: the controller manager, the core Notebook
reconciler, the slice-atomic idle culler, the slice repair and quarantine
reconciler, the warm slice pool reconciler, the fleet scheduler (gang
admission under a tenant's TPUQuota), the extension reconciler (route,
network policies, auth resources, CA bundle, runtime images, pipeline
and MLflow RBAC, the Elyra secret and the reconciliation lock), the
accelerator seams for an H100 slice (the pod spec of a notebook's
StatefulSet and of a warm pool slice), leader election, sharded
ownership and the apiserver circuit breaker, composed by
``setup_controllers``."""

from .culling import CullingReconciler
from .extension import ExtensionReconciler
from .manager import Manager, Request, Result
from .notebook import NotebookReconciler
from .scheduler import SchedulerReconciler
from .slicepool import SlicePoolReconciler
from .slicerepair import SliceRepairReconciler

__all__ = ["Manager", "Request", "Result", "NotebookReconciler",
           "CullingReconciler", "SliceRepairReconciler",
           "SlicePoolReconciler", "SchedulerReconciler",
           "ExtensionReconciler", "setup_controllers"]


def setup_controllers(client, config=None, metrics=None, prober=None, *,
                      core=True, extension=True, webhooks=True,
                      leader_elect=False, health_port=None,
                      max_concurrent_reconciles=None):
    """Wire a manager the way the reference's two manager binaries do
    (``kubeflow_tpu/controllers/__init__.py`` ``setup_controllers``;
    notebook-controller/main.go:58-148 and odh main.go:141-374); returns
    the manager, not started.

    In order: the ``rest_client_*`` families on a transport client; on a
    client that takes in-process admission (the store; not an
    ``HttpApiClient``, whose apiserver holds the CRDs and webhook
    configurations) the Notebook, SlicePool and TPUQuota CRDs, then with
    ``webhooks`` the mutating and the validating admission webhook on the
    live client; the one read cache (a watch-fed ``CachingClient``,
    Secrets, ConfigMaps and Events read live, told of each watch
    stream's gaps over the wire); the manager with its
    workqueue families; on a transport client the apiserver
    ``CircuitBreaker`` (its probe the client's ``ping``, its close
    ``mgr.resync_all``); with ``config.shard_count`` the
    ``ShardCoordinator`` on the transport client (lease state never read
    from a cache); with ``core`` the core reconciler, the culler
    (``config.enable_culling``; ``prober(notebook)`` fakes Jupyter), the
    slice repair, SlicePool and scheduler reconcilers (each on by
    default); with ``extension`` the extension reconciler; with
    ``leader_elect`` a ``LeaderElector`` on each binary's own Lease
    (``kubeflow-tpu-notebook-controller-leader``, or
    ``kubeflow-tpu-extension-controller-leader`` for an extension-only
    manager); with ``health_port`` the ``HealthServer``, its ``manager``
    healthz check the worker pool's liveness and, with a breaker, its
    ``apiserver`` readyz check the breaker's state (readiness never
    gates on leadership: a standby stays Ready)."""
    from ..api.slicepool import install_slicepool_crd
    from ..api.tpuquota import install_tpuquota_crd
    from ..api.types import install_notebook_crd
    from ..cluster.cache import CachingClient
    from ..utils.config import ControllerConfig
    from ..utils.health import HealthServer
    from ..utils.metrics import MetricsRegistry
    from ..webhook import NotebookMutatingWebhook, NotebookValidatingWebhook
    from .election import LeaderElector

    config = config or ControllerConfig.from_env()
    metrics = metrics or MetricsRegistry()
    transport_client = client  # before the cache wraps it: the breaker's
    if hasattr(client, "attach_metrics"):
        client.attach_metrics(metrics)  # rest_client_* over the wire
    inprocess_admission = getattr(client, "supports_inprocess_admission", True)
    if inprocess_admission:
        install_notebook_crd(client)
        install_slicepool_crd(client)
        install_tpuquota_crd(client)
    if webhooks and inprocess_admission:
        # mutating before validating, the apiserver's phase order;
        # admission reads and writes the live client, never the cache
        NotebookMutatingWebhook(client, config).install(client)
        NotebookValidatingWebhook(config).install(client)
    if max_concurrent_reconciles is None:
        max_concurrent_reconciles = config.max_concurrent_reconciles
    read_client = CachingClient(
        client, auto_informer=False,
        disable_for=("Secret", "ConfigMap", "Event"))
    read_client.attach_metrics(metrics)
    if hasattr(transport_client, "set_watch_gap_listener"):
        # a dropped stream that cannot resume: its kind reads live until
        # the resync converges the cache
        transport_client.set_watch_gap_listener(
            read_client.mark_watch_gap, read_client.mark_watch_recovered)
    mgr = Manager(read_client, read_cache=read_client,
                  max_concurrent_reconciles=max_concurrent_reconciles)
    client = read_client  # the reconcilers read cached, write through
    mgr.attach_metrics(metrics)
    if hasattr(transport_client, "set_health_tracker"):
        # the in-process store cannot fail at the transport, so only a
        # transport client gets the breaker
        from .resilience import CircuitBreaker
        breaker = CircuitBreaker(
            probe=getattr(transport_client, "ping", None),
            on_resume=mgr.resync_all)
        breaker.attach_metrics(metrics)
        transport_client.set_health_tracker(breaker)
        mgr.breaker = breaker
    if config.shard_count:
        from .sharding import ShardCoordinator, ShardMap
        coordinator = ShardCoordinator(
            transport_client, config.controller_namespace,
            ShardMap(config.shard_count),
            identity=config.shard_identity or None,
            lease_duration=config.shard_lease_duration_s,
            renew_period=config.shard_renew_period_s)
        coordinator.attach_metrics(metrics)
        mgr.set_sharding(coordinator)
    # ``core``/``extension``: the reference's two manager binaries,
    # cooperating only through API state when run split
    if core:
        NotebookReconciler(client, config, metrics).setup(mgr)
        if config.enable_culling:
            kwargs = {"prober": prober} if prober is not None else {}
            CullingReconciler(client, config, metrics, **kwargs).setup(mgr)
        if config.enable_slice_repair:
            SliceRepairReconciler(client, config, metrics).setup(mgr)
        if config.enable_slice_pool:
            SlicePoolReconciler(client, config, metrics).setup(mgr)
        if config.enable_scheduler:
            SchedulerReconciler(client, config, metrics).setup(mgr)
    if extension:
        ExtensionReconciler(client, config, metrics).setup(mgr)
    if leader_elect:
        # each binary elects on its own Lease: an extension-only manager
        # never contends with a core manager's
        lease_name = ("kubeflow-tpu-extension-controller-leader"
                      if extension and not core
                      else "kubeflow-tpu-notebook-controller-leader")
        mgr.leader_elector = LeaderElector(
            client, config.controller_namespace, lease_name,
            lease_duration=config.leader_lease_duration_s,
            renew_period=config.leader_renew_period_s)
    if health_port is not None:
        mgr.health_server = HealthServer(metrics_registry=metrics,
                                         port=health_port)
        mgr.health_server.add_healthz_check("manager", mgr.is_alive)
        if mgr.breaker is not None:
            # readiness, not liveness: a restart would not bring the
            # apiserver back
            mgr.health_server.add_readyz_check(
                "apiserver", lambda: mgr.breaker.available)
    return mgr
