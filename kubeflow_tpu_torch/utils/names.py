"""The annotation keys of the runtime's handshakes with the control plane.

A copy of the keys of ``kubeflow_tpu/utils/names.py`` that
runtime/elastic.py and runtime/migrate.py read and write (the port
imports nothing of the JAX package); the strings are the reference's,
which tests/test_torch_elastic.py holds them to.
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
