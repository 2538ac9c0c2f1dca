"""Validating admission webhook for Notebook CRs.

The port's counterpart of ``kubeflow_tpu/webhook/validating.py``
(reference odh notebook_validating_webhook.go:41-100): it denies the
removal of the MLflow annotation from a running notebook (the injected
env would outlive the RoleBinding that authorizes it). Two rules of the
accelerator: a malformed slice request is denied at admission with the
``GpuRequestError``'s message (instead of crash-looping a reconciler),
and the slice shape of a running notebook is immutable (a resize bounces
every worker; stop first). The request is an H100 shape (``h100-N``)
under the reference's ``tpu.kubeflow.org`` annotation keys.
"""

from __future__ import annotations

from ..api import types as api
from ..cluster.errors import ApiError
from ..gpu.topology import GpuRequestError, parse_slice_request
from ..utils import k8s, names
from ..utils.config import ControllerConfig


class AdmissionDenied(ApiError):
    code = 403
    reason = "AdmissionDenied"


class NotebookValidatingWebhook:
    def __init__(self, config: ControllerConfig | None = None):
        self.config = config or ControllerConfig()

    def install(self, store) -> None:
        store.register_admission(api.KIND, self.handle)

    def handle(self, operation: str, notebook: dict, old: dict | None) -> dict:
        if operation not in ("CREATE", "UPDATE") or k8s.is_deleting(notebook):
            return notebook
        self._validate_gpu_request(notebook)
        if operation == "UPDATE" and old is not None:
            self._deny_mlflow_annotation_removal(notebook, old)
            self._deny_running_slice_resize(notebook, old)
        return notebook

    def _validate_gpu_request(self, nb: dict) -> None:
        try:
            parse_slice_request(
                k8s.get_in(nb, "metadata", "annotations", default={}))
        except GpuRequestError as exc:
            raise AdmissionDenied(f"invalid GPU request: {exc.message}") from exc

    def _deny_mlflow_annotation_removal(self, nb: dict, old: dict) -> None:
        """Reference validateMLflowAnnotationRemoval (:60-100): removing
        the annotation while running would leave MLFLOW_* env pointing at
        an instance the pod is no longer authorized for."""
        had = k8s.get_annotation(old, names.MLFLOW_INSTANCE_ANNOTATION)
        has = k8s.get_annotation(nb, names.MLFLOW_INSTANCE_ANNOTATION)
        running = k8s.get_annotation(old, names.STOP_ANNOTATION) is None
        if had and not has and running:
            raise AdmissionDenied(
                "cannot remove the MLflow annotation from a running notebook; "
                "stop it first")

    def _deny_running_slice_resize(self, nb: dict, old: dict) -> None:
        """The slice is immutable while running: a resize rewrites the pod
        template and the workers' env, bouncing every worker mid-session.
        Stopping first makes the resize an explicit restart."""
        old_spec = parse_slice_request(
            k8s.get_in(old, "metadata", "annotations", default={}))
        new_spec = parse_slice_request(
            k8s.get_in(nb, "metadata", "annotations", default={}))
        running = k8s.get_annotation(old, names.STOP_ANNOTATION) is None
        if running and old_spec != new_spec:
            raise AdmissionDenied(
                f"cannot change GPU slice of a running notebook "
                f"({old_spec and old_spec.short_name} → "
                f"{new_spec and new_spec.short_name}); stop it first")
