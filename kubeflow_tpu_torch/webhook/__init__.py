"""The admission webhooks for Notebook CRs: the mutating webhook (the
reconciliation lock, the image choice for an H100 slice, the mounts, the
auth sidecar and restart gating), the validating webhook and the
AdmissionReview server (``webhook.server``)."""
from .mutating import NotebookMutatingWebhook, swap_image_for_gpu
from .validating import AdmissionDenied, NotebookValidatingWebhook

__all__ = ["AdmissionDenied", "NotebookMutatingWebhook",
           "NotebookValidatingWebhook", "swap_image_for_gpu"]
