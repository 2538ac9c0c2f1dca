"""The port's control plane: the controller manager, the core Notebook
reconciler, the slice-atomic idle culler, the slice repair and quarantine
reconciler, the warm slice pool reconciler, the fleet scheduler (gang
admission under a tenant's TPUQuota) and the accelerator seams for an
H100 slice (the pod spec of a notebook's StatefulSet and of a warm pool
slice)."""

from .culling import CullingReconciler
from .manager import Manager, Request, Result
from .notebook import NotebookReconciler
from .scheduler import SchedulerReconciler
from .slicepool import SlicePoolReconciler
from .slicerepair import SliceRepairReconciler

__all__ = ["Manager", "Request", "Result", "NotebookReconciler",
           "CullingReconciler", "SliceRepairReconciler",
           "SlicePoolReconciler", "SchedulerReconciler"]
