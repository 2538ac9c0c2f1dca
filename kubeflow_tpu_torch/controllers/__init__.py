"""The port's control plane: the controller manager, the core Notebook
reconciler, the slice-atomic idle culler and the accelerator seams for
an H100 slice (the pod spec of a notebook's StatefulSet and of a warm
pool slice)."""

from .culling import CullingReconciler
from .manager import Manager, Request, Result
from .notebook import NotebookReconciler

__all__ = ["Manager", "Request", "Result", "NotebookReconciler",
           "CullingReconciler"]
