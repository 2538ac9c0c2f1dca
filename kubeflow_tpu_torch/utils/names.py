"""The keys of the port's handshakes with the control plane.

A copy of the keys of ``kubeflow_tpu/utils/names.py`` that
runtime/elastic.py, runtime/migrate.py and the accelerator seams
(gpu/topology.py, controllers/, webhook/) read and write (the port
imports nothing of the JAX package); the strings are the reference's,
which tests/test_torch_elastic.py and tests/test_torch_podspec.py hold
them to. The GPU keys at the end are the port's own.
"""

from __future__ import annotations

# migration driver bookkeeping (runtime/migrate.py): the step the trainer
# had reached, and the step the runtime resumed at on the new slice
RUNTIME_STEP_ANNOTATION = "tpu.kubeflow.org/runtime-step"
RESUMED_STEP_ANNOTATION = "tpu.kubeflow.org/resumed-step"

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

# --- the slice request and its pods (gpu/topology.py, controllers/) ---
# the request on the Notebook: a shorthand ("h100-16"), or a generation
# plus a topology ("h100" + "2x8"); the keys are the unchanged
# controller's contract, so they keep their tpu.kubeflow.org names
TPU_ACCELERATOR_ANNOTATION = "tpu.kubeflow.org/accelerator"
TPU_TOPOLOGY_ANNOTATION = "tpu.kubeflow.org/topology"
TPU_SLICE_LABEL = "tpu.kubeflow.org/slice"
# records what the image was before the webhook's image swap replaced it
TPU_ORIGINAL_IMAGE_ANNOTATION = "tpu.kubeflow.org/original-image"
# StatefulSet pod ordinal label (stable since k8s 1.28): the worker id
POD_INDEX_LABEL = "apps.kubernetes.io/pod-index"
# the reference caps StatefulSet names at 52 characters so that the
# "-<ordinal>" pod names stay valid DNS labels
MAX_STS_NAME_LENGTH = 52

# --- warm slice pools (controllers/slicepool.py) ---
POOL_LABEL = "tpu.kubeflow.org/pool"
POOL_STATE_ANNOTATION = "tpu.kubeflow.org/pool-state"
POOL_STATE_WARMING = "Warming"

# --- the GPU counterparts of the reference's TPU resource and selectors ---
# extended-resource key the NVIDIA device plugin exposes cards under
GPU_RESOURCE_KEY = "nvidia.com/gpu"
# GKE's node labels for the card type and the machine type
GKE_GPU_ACCELERATOR_LABEL = "cloud.google.com/gke-accelerator"
NODE_INSTANCE_TYPE_LABEL = "node.kubernetes.io/instance-type"
