"""The port's control plane: the controller manager, the core Notebook
reconciler, the slice-atomic idle culler, the slice repair and quarantine
reconciler and the accelerator seams for an H100 slice (the pod spec of a
notebook's StatefulSet and of a warm pool slice)."""

from .culling import CullingReconciler
from .manager import Manager, Request, Result
from .notebook import NotebookReconciler
from .slicerepair import SliceRepairReconciler

__all__ = ["Manager", "Request", "Result", "NotebookReconciler",
           "CullingReconciler", "SliceRepairReconciler"]
