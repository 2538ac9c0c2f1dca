"""Controller configuration.

A copy of ``kubeflow_tpu/utils/config.py`` (the port imports nothing of
the JAX package): the same ``ControllerConfig`` fields, defaults and
environment variables, so one configuration means the same thing to
both packages, except one default: ``tpu_default_image`` (the default
image of an accelerator pod, which the SlicePool reconciler pre-rolls
its warm slices with) is a CUDA PyTorch notebook image, since a JAX or
libtpu image cannot drive an NVIDIA card. The reference configures through env vars + kustomize
params.env (SURVEY §5): ENABLE_CULLING, CULL_IDLE_TIME,
IDLENESS_CHECK_PERIOD, CLUSTER_DOMAIN, DEV, ADD_FSGROUP, USE_ISTIO,
SET_PIPELINE_RBAC, SET_PIPELINE_SECRET, MLFLOW_ENABLED, GATEWAY_URL,
NOTEBOOK_GATEWAY_NAME/NAMESPACE, K8S_NAMESPACE. Fields the port does not
read yet (culling, the extension, sharding, repair, the scheduler) are
kept so a configuration round-trips unchanged."""

from __future__ import annotations

import os
from dataclasses import dataclass, field


def _env_bool(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() in ("1", "true", "yes", "on")


# the default image of an H100 pod (the counterpart of the reference's
# JAX notebook image): Kubeflow's CUDA PyTorch notebook
DEFAULT_GPU_IMAGE = "kubeflownotebookswg/jupyter-pytorch-cuda-full:v1.9.0"


@dataclass
class ControllerConfig:
    # core controller (reference notebook-controller/main.go:65-77 + env)
    cluster_domain: str = "cluster.local"
    add_fsgroup: bool = True
    # Istio routing (reference USE_ISTIO/ISTIO_GATEWAY/ISTIO_HOST env,
    # notebook_controller.go:558-658; kubeflow overlay turns it on)
    use_istio: bool = False
    istio_gateway: str = "kubeflow/kubeflow-gateway"
    istio_host: str = "*"
    # culling (reference culling_controller.go:32-36; minutes)
    enable_culling: bool = False
    cull_idle_time_min: int = 1440
    idleness_check_period_min: int = 1
    dev_mode: bool = False
    # kubectl-proxy endpoint the DEV-mode culler probes through (reference
    # culling_controller.go:249-254)
    dev_proxy_url: str = "http://localhost:8001"
    jupyter_probe_timeout_s: float = 10.0
    # odh-analog extension (odh main.go / params.env)
    controller_namespace: str = "kubeflow-tpu-system"
    gateway_name: str = "data-science-gateway"
    gateway_namespace: str = "openshift-ingress"
    gateway_url: str = ""
    mlflow_enabled: bool = False
    set_pipeline_rbac: bool = False
    set_pipeline_secret: bool = False
    inject_cluster_proxy_env: bool = False
    auth_proxy_image: str = "kube-rbac-proxy:latest"
    # strict mode: hold the reconciliation lock until the default SA has an
    # image-pull secret (reference waits 3 retries × backoff, odh
    # notebook_controller.go:155-180); lenient default suits clusters without
    # an SA-secret controller
    lock_requires_pull_secret: bool = False
    # leader-election timing (controller-runtime's LeaseDuration/RenewDeadline
    # analog; env-overridable so multi-process failover tests can shrink it)
    leader_lease_duration_s: float = 15.0
    leader_renew_period_s: float = 2.0
    # dispatch worker-pool size (controller-runtime MaxConcurrentReconciles;
    # 1 = the classic single dispatch thread)
    max_concurrent_reconciles: int = 4
    # sharded multi-manager control plane (controllers/sharding.py):
    # shard_count > 0 partitions reconcile ownership by namespace hash
    # into that many shards; each manager replica elects per-shard Leases
    # and reconciles only its shards' keys. 0 = sharding off (the single
    # manager owns everything). Every replica MUST run the same count —
    # the shard map is computed locally from it.
    shard_count: int = 0
    # per-shard lease timings (the crash-failover bound, like the leader
    # lease); env-overridable so failover tests/smokes can shrink them
    shard_lease_duration_s: float = 15.0
    shard_renew_period_s: float = 2.0
    # stable manager identity for shard leases/metrics (empty = random
    # per process, the usual pod-name-injected shape in a deployment)
    shard_identity: str = ""
    # slice health & repair controller (controllers/slicerepair.py):
    # node-preemption-aware slice-atomic recovery with poison-pill quarantine
    enable_slice_repair: bool = True
    # decorrelated-jitter backoff between repair attempts of one slice
    slice_repair_backoff_base_s: float = 0.5
    slice_repair_backoff_max_s: float = 30.0
    # a repair not completing (all workers Ready again) within this bound
    # counts as a FAILED repair
    slice_repair_timeout_s: float = 300.0
    # poison pill: this many FAILED repairs inside the sliding window →
    # Quarantined (stop repairing until an operator clears the annotation)
    slice_repair_max_failures: int = 3
    slice_repair_window_s: float = 900.0
    # safety-net requeue while a repair phase waits on pod churn (the state
    # machine is otherwise event-driven off the Pod/Node watches)
    slice_repair_poll_s: float = 0.25
    # elastic resize: bound on the Draining/Resharding handshake with the
    # trainer-side agent; past it the resize aborts (dead-agent latch) and
    # the notebook falls back to the plain repair roll
    elastic_resize_timeout_s: float = 30.0
    # warm slice pools (controllers/slicepool.py): pre-rolled slices a
    # notebook BINDS instead of cold-rolling a StatefulSet
    enable_slice_pool: bool = True
    # default namespace pool slices materialize in (SlicePool.spec.namespace
    # overrides per pool)
    pool_namespace: str = "tpu-slice-pools"
    # how long the core reconciler holds off its cold roll waiting for the
    # pool controller to bind a warm slice; past this it stamps a
    # BindTimeout miss and cold-rolls (the pool being down must never
    # strand notebook creation)
    pool_bind_grace_s: float = 5.0
    # checkpoint migration: bound on the unbind→rebind→resume window; past
    # it the migration falls back to a cold roll (the repair roll)
    pool_migration_timeout_s: float = 60.0
    # safety-net requeue while the pool warms slices / waits on binds
    pool_poll_s: float = 0.25
    # fleet scheduler (controllers/scheduler.py): gang admission + tenant
    # quota + tier preemption for gang-annotated notebooks
    enable_scheduler: bool = True
    # fleet slice capacity assumed when no SlicePool declares any (the
    # pools' warmReplicas sum is the live capacity signal otherwise)
    sched_default_capacity: int = 4
    # safety-net requeue while a gang waits on capacity / a preemption
    # handshake (the scheduler is otherwise event-driven)
    sched_poll_s: float = 0.25
    # how long the core reconciler holds a gang-annotated notebook's roll
    # waiting for the scheduler's Admitted verdict; past it the notebook
    # proceeds anyway (a down scheduler must never strand creation — the
    # same degrade rule as pool_bind_grace_s)
    sched_admission_grace_s: float = 5.0
    # the accelerator image (the reference's name and env var)
    tpu_default_image: str = DEFAULT_GPU_IMAGE
    image_swap_map: dict = field(default_factory=dict)  # image → CUDA image

    @classmethod
    def from_env(cls) -> "ControllerConfig":
        env = os.environ
        return cls(
            cluster_domain=env.get("CLUSTER_DOMAIN", "cluster.local"),
            add_fsgroup=_env_bool("ADD_FSGROUP", True),
            use_istio=_env_bool("USE_ISTIO", False),
            istio_gateway=env.get("ISTIO_GATEWAY", "kubeflow/kubeflow-gateway"),
            istio_host=env.get("ISTIO_HOST", "*"),
            enable_culling=_env_bool("ENABLE_CULLING", False),
            cull_idle_time_min=int(env.get("CULL_IDLE_TIME", "1440")),
            idleness_check_period_min=int(env.get("IDLENESS_CHECK_PERIOD", "1")),
            dev_mode=_env_bool("DEV", False),
            dev_proxy_url=env.get("DEV_PROXY_URL", "http://localhost:8001"),
            controller_namespace=env.get("K8S_NAMESPACE", "kubeflow-tpu-system"),
            gateway_name=env.get("NOTEBOOK_GATEWAY_NAME", "data-science-gateway"),
            gateway_namespace=env.get("NOTEBOOK_GATEWAY_NAMESPACE", "openshift-ingress"),
            gateway_url=env.get("GATEWAY_URL", ""),
            mlflow_enabled=_env_bool("MLFLOW_ENABLED", False),
            set_pipeline_rbac=_env_bool("SET_PIPELINE_RBAC", False),
            set_pipeline_secret=_env_bool("SET_PIPELINE_SECRET", False),
            inject_cluster_proxy_env=_env_bool("INJECT_CLUSTER_PROXY_ENV", False),
            leader_lease_duration_s=float(env.get("LEADER_LEASE_DURATION", "15")),
            leader_renew_period_s=float(env.get("LEADER_RENEW_PERIOD", "2")),
            max_concurrent_reconciles=int(
                env.get("MAX_CONCURRENT_RECONCILES", "4")),
            shard_count=int(env.get("SHARD_COUNT", "0")),
            shard_lease_duration_s=float(
                env.get("SHARD_LEASE_DURATION", "15")),
            shard_renew_period_s=float(env.get("SHARD_RENEW_PERIOD", "2")),
            shard_identity=env.get("SHARD_IDENTITY", ""),
            enable_slice_repair=_env_bool("ENABLE_SLICE_REPAIR", True),
            slice_repair_backoff_base_s=float(
                env.get("SLICE_REPAIR_BACKOFF_BASE", "0.5")),
            slice_repair_backoff_max_s=float(
                env.get("SLICE_REPAIR_BACKOFF_MAX", "30")),
            slice_repair_timeout_s=float(
                env.get("SLICE_REPAIR_TIMEOUT", "300")),
            slice_repair_max_failures=int(
                env.get("SLICE_REPAIR_MAX_FAILURES", "3")),
            slice_repair_window_s=float(
                env.get("SLICE_REPAIR_WINDOW", "900")),
            slice_repair_poll_s=float(
                env.get("SLICE_REPAIR_POLL", "0.25")),
            elastic_resize_timeout_s=float(
                env.get("ELASTIC_RESIZE_TIMEOUT", "30")),
            enable_slice_pool=_env_bool("ENABLE_SLICE_POOL", True),
            pool_namespace=env.get("SLICE_POOL_NAMESPACE",
                                   "tpu-slice-pools"),
            pool_bind_grace_s=float(env.get("POOL_BIND_GRACE", "5")),
            pool_migration_timeout_s=float(
                env.get("POOL_MIGRATION_TIMEOUT", "60")),
            pool_poll_s=float(env.get("POOL_POLL", "0.25")),
            enable_scheduler=_env_bool("ENABLE_SCHEDULER", True),
            sched_default_capacity=int(
                env.get("SCHED_DEFAULT_CAPACITY", "4")),
            sched_poll_s=float(env.get("SCHED_POLL", "0.25")),
            sched_admission_grace_s=float(
                env.get("SCHED_ADMISSION_GRACE", "5")),
            tpu_default_image=env.get("TPU_NOTEBOOK_IMAGE",
                                      DEFAULT_GPU_IMAGE),
        )
