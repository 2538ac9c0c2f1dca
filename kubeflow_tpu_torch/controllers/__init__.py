"""The port's control plane: the controller manager, the core Notebook
reconciler, the slice-atomic idle culler, the slice repair and quarantine
reconciler, the warm slice pool reconciler, the fleet scheduler (gang
admission under a tenant's TPUQuota), the extension reconciler (route,
network policies, auth resources, CA bundle, runtime images, pipeline
and MLflow RBAC, the Elyra secret and the reconciliation lock) and the
accelerator seams for an H100 slice (the pod spec of a notebook's
StatefulSet and of a warm pool slice)."""

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
           "ExtensionReconciler"]
