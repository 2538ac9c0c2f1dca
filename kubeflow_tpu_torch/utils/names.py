"""Naming rules and the keys of the port's handshakes with the control
plane.

A copy of the keys and name rules of ``kubeflow_tpu/utils/names.py`` that
the port's control plane (controllers/, cluster/, webhook/), the
accelerator seam (gpu/topology.py) and the runtime's handshake agents
(runtime/elastic.py, runtime/migrate.py) read and write; the port imports
nothing of the JAX package. The strings are the reference's, which
tests/test_torch_elastic.py, tests/test_torch_podspec.py and the parity
harness (tests/test_torch_notebook_controller.py) hold them to. The GPU
keys at the end are the port's own.
"""

from __future__ import annotations

import hashlib

# --- annotation / label keys of the core reconciler (reference
# notebook_controller.go:53-67, culling_controller.go:40-55) ---
STOP_ANNOTATION = "kubeflow-resource-stopped"
CREATOR_ANNOTATION = "notebooks.kubeflow.org/creator"
LAST_ACTIVITY_ANNOTATION = "notebooks.kubeflow.org/last-activity"
LAST_ACTIVITY_CHECK_TIMESTAMP_ANNOTATION = (
    "notebooks.kubeflow.org/last_activity_check_timestamp")
RESTART_ANNOTATION = "notebooks.opendatahub.io/notebook-restart"
NOTEBOOK_NAME_LABEL = "notebook-name"

# --- the extension reconciler's keys (reference odh
# notebook_controller.go:53-67, notebook_mutating_webhook.go:86-111) ---
INJECT_AUTH_ANNOTATION = "notebooks.opendatahub.io/inject-auth"
MLFLOW_INSTANCE_ANNOTATION = "opendatahub.io/mlflow-instance"
# the stop annotation's value while the notebook waits for the extension
# reconciler to provision its prerequisites (the reconciliation lock)
RECONCILIATION_LOCK_VALUE = "odh-notebook-controller-lock"
# immutable namespace-name label (NamespaceDefaultLabelName)
NAMESPACE_NAME_LABEL = "kubernetes.io/metadata.name"
SERVING_CERT_SECRET_ANNOTATION = (
    "service.beta.openshift.io/serving-cert-secret-name")
# the extension's finalizers: cleanup of the cross-namespace and
# cluster-scoped objects no ownerReference reaches
ROUTES_CLEANUP_FINALIZER = "kubeflow-tpu.org/route-cleanup"
REFGRANT_CLEANUP_FINALIZER = "kubeflow-tpu.org/referencegrant-cleanup"
CRB_CLEANUP_FINALIZER = "kubeflow-tpu.org/crb-cleanup"
# the finalizer controllers before the auth proxy stamped on Notebooks
LEGACY_OAUTH_FINALIZER = "notebooks.kubeflow-tpu.org/oauth-client"

# --- the admission webhooks' keys (reference odh
# notebook_mutating_webhook.go:86-111, notebook_controller.go:59-66) ---
# the webhook changes the restart gating parked on a running notebook
UPDATE_PENDING_ANNOTATION = "notebooks.opendatahub.io/update-pending"
# the auth sidecar's resources: the legacy combined forms set request and
# limit together; the split forms win over them
AUTH_SIDECAR_CPU_ANNOTATION = "notebooks.opendatahub.io/auth-sidecar-cpu"
AUTH_SIDECAR_MEMORY_ANNOTATION = "notebooks.opendatahub.io/auth-sidecar-memory"
AUTH_SIDECAR_CPU_REQUEST_ANNOTATION = \
    "notebooks.opendatahub.io/auth-sidecar-cpu-request"
AUTH_SIDECAR_CPU_LIMIT_ANNOTATION = \
    "notebooks.opendatahub.io/auth-sidecar-cpu-limit"
AUTH_SIDECAR_MEMORY_REQUEST_ANNOTATION = \
    "notebooks.opendatahub.io/auth-sidecar-memory-request"
AUTH_SIDECAR_MEMORY_LIMIT_ANNOTATION = \
    "notebooks.opendatahub.io/auth-sidecar-memory-limit"
FEAST_LABEL = "opendatahub.io/feast-integration"
IMAGE_SELECTION_ANNOTATION = "notebooks.opendatahub.io/last-image-selection"
# the ImageStream lookup namespace of the image selection (empty or
# missing: the controller namespace)
WORKBENCH_IMAGE_NAMESPACE_ANNOTATION = \
    "opendatahub.io/workbench-image-namespace"

# --- the slice request and its pods (gpu/topology.py, controllers/) ---
# the request on the Notebook: a shorthand ("h100-16"), or a generation
# plus a topology ("h100" + "2x8"); the keys are the unchanged
# controller's contract, so they keep their tpu.kubeflow.org names
TPU_ACCELERATOR_ANNOTATION = "tpu.kubeflow.org/accelerator"
TPU_TOPOLOGY_ANNOTATION = "tpu.kubeflow.org/topology"
TPU_SLICE_LABEL = "tpu.kubeflow.org/slice"
# records what the image was before the webhook's image swap replaced it
TPU_ORIGINAL_IMAGE_ANNOTATION = "tpu.kubeflow.org/original-image"
# serving-aware culling: the port of an in-pod model-serving endpoint
# (runtime/server.py) whose request traffic counts as notebook activity,
# and the request count observed at the previous culling probe
SERVING_PORT_ANNOTATION = "tpu.kubeflow.org/serving-port"
SERVING_REQUESTS_OBSERVED_ANNOTATION = \
    "tpu.kubeflow.org/serving-requests-observed"
# the apiserver's service proxy (cluster/apiserver.py): in-process pods
# hold no sockets, so a Service names its listener's base URL here, the
# analog of its ready endpoints; ``<key>-<port-or-port-name>`` maps one
# port of a multi-port Service, the bare key is the fallback
PROXY_BACKEND_ANNOTATION = "tpu.kubeflow.org/proxy-backend"

# --- slice health & repair ---
# current slice health state: "Degraded" | "Repairing" | "Quarantined";
# absent = healthy. The repair controller owns these; the core reconciler
# renders them into Slice* status conditions.
SLICE_HEALTH_ANNOTATION = "tpu.kubeflow.org/slice-health"
SLICE_HEALTH_REASON_ANNOTATION = "tpu.kubeflow.org/slice-health-reason"
# present while a slice-atomic repair holds the StatefulSet at replicas=0;
# the core reconciler's desired_replicas honors it (one writer of replicas,
# so the slice is only ever observed at 0 or full, never partial)
REPAIR_SCALE_DOWN_ANNOTATION = "tpu.kubeflow.org/repair-scale-down"
# epoch timestamps of failed repairs (comma-joined): the sliding window
# the quarantine threshold counts
REPAIR_FAILURES_ANNOTATION = "tpu.kubeflow.org/repair-failures"
REPAIR_STARTED_AT_ANNOTATION = "tpu.kubeflow.org/repair-started-at"
# poison-pill marker, cleared only by an operator
QUARANTINE_ANNOTATION = "tpu.kubeflow.org/quarantined"
# repair bookkeeping never propagates to the StatefulSet/pod template
# (it would churn the template and defeat drift gating)
SLICE_REPAIR_ANNOTATIONS = frozenset({
    SLICE_HEALTH_ANNOTATION, SLICE_HEALTH_REASON_ANNOTATION,
    REPAIR_SCALE_DOWN_ANNOTATION, REPAIR_FAILURES_ANNOTATION,
    REPAIR_STARTED_AT_ANNOTATION, QUARANTINE_ANNOTATION,
})

# --- warm slice pools ---
# label on pool-owned StatefulSets/Services/pods naming their SlicePool
POOL_LABEL = "tpu.kubeflow.org/pool"
# lifecycle of a pool slice, on the pool StatefulSet
POOL_STATE_ANNOTATION = "tpu.kubeflow.org/pool-state"
POOL_STATE_WARMING = "Warming"
POOL_STATE_WARM = "Warm"
POOL_STATE_BOUND = "Bound"
POOL_STATE_DRAINING = "Draining"
# "<namespace>/<notebook>" on a Bound pool StatefulSet: the reverse edge
# of the Notebook's BOUND_SLICE_ANNOTATION
POOL_BOUND_TO_ANNOTATION = "tpu.kubeflow.org/pool-bound-to"
# on the Notebook: "<pool-namespace>/<statefulset>" of the bound warm
# slice, and the SlicePool it came from. Presence of BOUND_SLICE is what
# flips the core reconciler into bound mode (no owned StatefulSet).
BOUND_SLICE_ANNOTATION = "tpu.kubeflow.org/bound-slice"
BOUND_POOL_ANNOTATION = "tpu.kubeflow.org/bound-pool"
# on bound pool pods: the notebook's namespace, so the pod→notebook watch
# mapping routes to the notebook's namespace, not the pool's
BOUND_NAMESPACE_LABEL = "tpu.kubeflow.org/bound-namespace"
# comma-joined worker hostnames, stamped on the Notebook at first bind
# and never rewritten: the slice identity the runtime formed its mesh on
SLICE_IDENTITY_ANNOTATION = "tpu.kubeflow.org/slice-identity"
# this notebook cold-rolls its own StatefulSet instead of waiting for a
# warm slice. Value = reason.
POOL_BIND_MISS_ANNOTATION = "tpu.kubeflow.org/pool-bind-miss"
# heartbeat (epoch seconds) of a pool controller that has admitted but
# not yet bound this notebook: suspends the core's bind-grace timeout
POOL_BIND_PENDING_ANNOTATION = "tpu.kubeflow.org/pool-bind-pending"
# checkpoint-based migration sub-state on the Notebook, owned by the
# repair controller: "Checkpointing" → "Binding" → "Resuming"
MIGRATION_STATE_ANNOTATION = "tpu.kubeflow.org/migration-state"
MIGRATION_STARTED_AT_ANNOTATION = "tpu.kubeflow.org/migration-started-at"
# migration driver bookkeeping (runtime/migrate.py): the checkpoint token
# taken before unbinding, the step the trainer had reached, and the step
# the runtime resumed at on the new slice
CHECKPOINT_TOKEN_ANNOTATION = "tpu.kubeflow.org/checkpoint-token"
RUNTIME_STEP_ANNOTATION = "tpu.kubeflow.org/runtime-step"
RESUMED_STEP_ANNOTATION = "tpu.kubeflow.org/resumed-step"
# pool/migration bookkeeping never propagates into a cold-rolled
# StatefulSet's template
POOL_ANNOTATIONS = frozenset({
    BOUND_SLICE_ANNOTATION, BOUND_POOL_ANNOTATION,
    SLICE_IDENTITY_ANNOTATION, POOL_BIND_MISS_ANNOTATION,
    POOL_BIND_PENDING_ANNOTATION,
    MIGRATION_STATE_ANNOTATION, MIGRATION_STARTED_AT_ANNOTATION,
    CHECKPOINT_TOKEN_ANNOTATION, RUNTIME_STEP_ANNOTATION,
    RESUMED_STEP_ANNOTATION,
})

# --- elastic training (the repair controller + runtime/elastic.py) ---
# opt-in marker: the notebook runs an ElasticTrainer
ELASTIC_ANNOTATION = "tpu.kubeflow.org/elastic"
# requested slice count (user intent) and the slice count the runtime
# currently holds (controller-written when a resize cycle completes)
ELASTIC_SLICES_ANNOTATION = "tpu.kubeflow.org/elastic-slices"
ELASTIC_CURRENT_SLICES_ANNOTATION = "tpu.kubeflow.org/elastic-current-slices"
# the resize state machine's carrier, owned by the controller:
# "Draining" → "Resharding"; absent = Stable
ELASTIC_RESIZE_ANNOTATION = "tpu.kubeflow.org/elastic-resize"
# the slice count a resize is heading to
ELASTIC_TARGET_ANNOTATION = "tpu.kubeflow.org/elastic-target"
# the runtime agent's acknowledgement of the carrier state ("Draining" /
# "Resharding"); "Aborted" is the controller's dead-agent latch, which
# only a live agent clears
ELASTIC_ACK_ANNOTATION = "tpu.kubeflow.org/elastic-ack"
# resize timeout clock (epoch seconds)
ELASTIC_RESIZE_STARTED_AT_ANNOTATION = \
    "tpu.kubeflow.org/elastic-resize-started-at"
# elastic bookkeeping churns on every resize handshake step: it never
# reaches the StatefulSet template
ELASTIC_ANNOTATIONS = frozenset({
    ELASTIC_ANNOTATION, ELASTIC_SLICES_ANNOTATION,
    ELASTIC_CURRENT_SLICES_ANNOTATION, ELASTIC_RESIZE_ANNOTATION,
    ELASTIC_TARGET_ANNOTATION, ELASTIC_ACK_ANNOTATION,
    ELASTIC_RESIZE_STARTED_AT_ANNOTATION,
})

# --- fleet scheduler ---
# opt-in gang request: the number of slices this notebook's job needs,
# all acquired atomically or none held. Notebooks without it bypass the
# scheduler entirely.
SCHED_GANG_ANNOTATION = "tpu.kubeflow.org/gang-slices"
# priority tier ("interactive" > "serving" > "training")
SCHED_TIER_ANNOTATION = "tpu.kubeflow.org/tier"
# sched-admission state machine carrier, owned by the scheduler:
# "Pending" → "Reserving" → "Admitted"; absent = Idle
SCHED_STATE_ANNOTATION = "tpu.kubeflow.org/sched-state"
# slice count reserved/held for this gang
SCHED_RESERVED_ANNOTATION = "tpu.kubeflow.org/sched-reserved"
# gang wait clock (epoch seconds), stamped with Pending
SCHED_ENQUEUED_AT_ANNOTATION = "tpu.kubeflow.org/sched-enqueued-at"
# the scheduler's preemption hold on a training victim
SCHED_PREEMPTED_ANNOTATION = "tpu.kubeflow.org/sched-preempted"
# scheduler bookkeeping never reaches the StatefulSet template
SCHED_ANNOTATIONS = frozenset({
    SCHED_GANG_ANNOTATION, SCHED_TIER_ANNOTATION, SCHED_STATE_ANNOTATION,
    SCHED_RESERVED_ANNOTATION, SCHED_ENQUEUED_AT_ANNOTATION,
    SCHED_PREEMPTED_ANNOTATION,
})

# W3C traceparent of the notebook's lifecycle trace (stamped by the
# reference's reconciler while a tracing provider records; the port has
# no tracing yet). Never propagated into the StatefulSet template.
TRACE_CONTEXT_ANNOTATION = "tpu.kubeflow.org/trace-context"

# --- well-known upstream/platform keys ---
RUNTIME_IMAGE_LABEL = "opendatahub.io/runtime-image"
RUNTIME_IMAGE_METADATA_ANNOTATION = "opendatahub.io/runtime-image-metadata"
MANAGED_BY_LABEL = "opendatahub.io/managed-by"
PART_OF_LABEL = "app.kubernetes.io/part-of"
LAST_APPLIED_ANNOTATION = "kubectl.kubernetes.io/last-applied-configuration"
# StatefulSet pod ordinal label (stable since k8s 1.28): the worker id
POD_INDEX_LABEL = "apps.kubernetes.io/pod-index"
# node minted by the kubelet simulator (cluster/kubelet.py)
SIM_NODE_LABEL = "kubeflow-tpu.org/sim-node"
# taint the node-lifecycle manager applies to an unreachable node
NODE_UNREACHABLE_TAINT_KEY = "node.kubernetes.io/unreachable"
# GKE's impending-node-termination notice taint (maintenance/preemption)
PREEMPTION_TAINT_KEY = "cloud.google.com/impending-node-termination"

# the reference caps StatefulSet names at 52 characters so that the
# "-<ordinal>" pod names stay valid DNS labels (notebook_controller.go:59,
# 144-149); longer notebook names fall back to GenerateName "nb-"
MAX_STS_NAME_LENGTH = 52
STS_GENERATE_PREFIX = "nb-"
# HTTPRoute names are capped at 63 characters (odh notebook_route.go:51-77)
MAX_ROUTE_NAME_LENGTH = 63

# --- the GPU counterparts of the reference's TPU resource and selectors ---
# extended-resource key the NVIDIA device plugin exposes cards under
GPU_RESOURCE_KEY = "nvidia.com/gpu"
# GKE's node labels for the card type and the machine type
GKE_GPU_ACCELERATOR_LABEL = "cloud.google.com/gke-accelerator"
NODE_INSTANCE_TYPE_LABEL = "node.kubernetes.io/instance-type"


def sts_name_for_notebook(notebook_name: str) -> tuple[str, bool]:
    """Return (name, use_generate_name): names longer than 52 characters
    fall back to ``GenerateName: "nb-"`` (notebook_controller.go:444-449)."""
    if len(notebook_name) > MAX_STS_NAME_LENGTH:
        return STS_GENERATE_PREFIX, True
    return notebook_name, False


def route_name_for_notebook(namespace: str,
                            notebook_name: str) -> tuple[str, bool]:
    """The central-namespace HTTPRoute's name ``nb-<ns>-<name>``, and
    whether it is a generateName: past 63 characters the truncated
    ``nb-<ns>-`` prefix, which the store completes with its suffix
    (odh notebook_route.go:51-77)."""
    candidate = f"nb-{namespace}-{notebook_name}"
    if len(candidate) > MAX_ROUTE_NAME_LENGTH:
        return f"nb-{namespace}-"[: MAX_ROUTE_NAME_LENGTH - 9] + "-", True
    return candidate, False


def generate_suffix(seed: str, n: int = 8) -> str:
    """The store's GenerateName suffix: a hash of ``seed``, so a run's
    names repeat (the apiserver draws 5 random characters)."""
    return hashlib.sha1(seed.encode()).hexdigest()[:n]


def nb_prefix(namespace: str, notebook_name: str) -> str:
    """The URL prefix a notebook is served under, also injected as
    NB_PREFIX (reference notebook_controller.go:417-431)."""
    return f"/notebook/{namespace}/{notebook_name}"
