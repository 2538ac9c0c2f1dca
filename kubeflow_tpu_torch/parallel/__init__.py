"""Multi-device layer of the port: meshes, partition rules, collectives,
ring and Ulysses attention (``kubeflow_tpu/parallel``'s counterpart)."""

from .mesh import AXES, MeshConfig, build_mesh
from .sharding import PartitionRules, batch_sharding, param_shardings

__all__ = ["MeshConfig", "build_mesh", "AXES", "batch_sharding",
           "param_shardings", "PartitionRules"]
