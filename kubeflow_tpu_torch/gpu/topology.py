"""The H100 node table: a slice request on the Notebook CR → the
provisioning facts of an NVIDIA H100 slice.

The port's counterpart of ``kubeflow_tpu/tpu/topology.py``, with the same
names and the same annotation keys (``tpu.kubeflow.org/accelerator`` and
``tpu.kubeflow.org/topology``, the unchanged controller's contract). A
request maps to:

- ``num_workers``      → StatefulSet replicas (one pod per node)
- ``cards_per_worker`` → the ``nvidia.com/gpu`` quantity of each pod
- GKE nodeSelectors    → ``cloud.google.com/gke-accelerator`` and
                         ``node.kubernetes.io/instance-type``
- worker env           → ``TPU_WORKER_ID`` and ``TPU_WORKER_HOSTNAMES``,
                         as for a TPU slice (runtime/bootstrap.py reads them)

The shapes are GKE's A3 machine types: ``h100-1``, ``-2``, ``-4`` and
``-8`` are one ``a3-highgpu-{1,2,4,8}g`` node with that many cards; a
larger slice is a multiple of 8 cards over ``a3-highgpu-8g`` nodes, so
``h100-16`` is 2 workers × 8. A topology is ``<workers>x<cards per
worker>`` and must be the shape its card count takes (``2x8``, ``1x4``).
"""

from __future__ import annotations

import re
from dataclasses import dataclass

from ..cluster.errors import InvalidError
from ..utils import names


class GpuRequestError(InvalidError):
    """A malformed slice request: an API error with code 422 and a
    ``.message``, as the reference's ``TpuRequestError``."""
    reason = "InvalidGPURequest"


@dataclass(frozen=True)
class Generation:
    name: str                  # "h100"
    gke_accelerator: str       # nodeSelector value
    machine_family: str        # "a3-highgpu" → "a3-highgpu-<n>g"
    single_node_cards: tuple[int, ...]  # the one-node shapes
    cards_per_node: int        # cards of each node of a multi-node slice


GENERATIONS: dict[str, Generation] = {
    "h100": Generation("h100", "nvidia-h100-80gb", "a3-highgpu",
                       (1, 2, 4, 8), 8),
}

_slice_short_re = re.compile(r"^([a-z][a-z0-9]*)-([0-9]+)$")
_topology_re = re.compile(r"^[0-9]+x[0-9]+$")


@dataclass(frozen=True)
class SliceSpec:
    """Everything the provisioner needs to emit a slice-shaped StatefulSet."""
    generation: str            # "h100"
    topology: tuple[int, int]  # (workers, cards per worker): (2, 8)
    cards: int                 # 16
    num_workers: int           # 2  → STS replicas
    cards_per_worker: int      # 8  → nvidia.com/gpu quantity
    gke_accelerator: str       # "nvidia-h100-80gb"
    machine_type: str          # "a3-highgpu-8g"

    @property
    def topology_str(self) -> str:
        return "x".join(str(d) for d in self.topology)

    @property
    def multi_host(self) -> bool:
        return self.num_workers > 1

    @property
    def short_name(self) -> str:
        return f"{self.generation}-{self.cards}"

    def node_selectors(self) -> dict[str, str]:
        return {
            names.GKE_GPU_ACCELERATOR_LABEL: self.gke_accelerator,
            names.NODE_INSTANCE_TYPE_LABEL: self.machine_type,
        }

    def worker_hostnames(self, sts_name: str, headless_svc: str,
                         namespace: str) -> list[str]:
        """Stable DNS names of all workers through the headless Service —
        the value of TPU_WORKER_HOSTNAMES, as for a TPU slice."""
        return [f"{sts_name}-{i}.{headless_svc}.{namespace}.svc"
                for i in range(self.num_workers)]


def _generation(name: str) -> Generation:
    gen = GENERATIONS.get(name)
    if gen is None:
        raise GpuRequestError(
            f"unknown GPU generation {name!r}; known: {sorted(GENERATIONS)}")
    return gen


def _spec_for_cards(gen: Generation, cards: int) -> SliceSpec:
    if cards in gen.single_node_cards:
        workers, per = 1, cards
    elif cards > 0 and cards % gen.cards_per_node == 0:
        workers, per = cards // gen.cards_per_node, gen.cards_per_node
    else:
        raise GpuRequestError(
            f"{gen.name}-{cards}: unsupported card count; one node holds "
            f"{list(gen.single_node_cards)} cards, more nodes multiples of "
            f"{gen.cards_per_node}")
    return SliceSpec(gen.name, (workers, per), cards, workers, per,
                     gen.gke_accelerator, f"{gen.machine_family}-{per}g")


def parse_topology(generation: str, topology: str) -> SliceSpec:
    """Parse a generation plus ``<workers>x<cards per worker>``."""
    gen = _generation(generation)
    if not _topology_re.match(topology):
        raise GpuRequestError(
            f"malformed topology {topology!r} (want <workers>x<cards per "
            f"worker>, e.g. 2x8)")
    workers, per = (int(d) for d in topology.split("x"))
    spec = _spec_for_cards(gen, workers * per)
    if spec.topology != (workers, per):
        raise GpuRequestError(
            f"{gen.name} topology {topology!r}: {spec.cards} cards are "
            f"{spec.topology_str} (workers x cards per worker)")
    return spec


def parse_short_name(short: str) -> SliceSpec:
    """Parse shorthand like ``h100-16`` (generation + total cards)."""
    m = _slice_short_re.match(short)
    if not m:
        raise GpuRequestError(
            f"malformed slice name {short!r} (want e.g. h100-16)")
    return _spec_for_cards(_generation(m.group(1)), int(m.group(2)))


def parse_slice_request(annotations: dict[str, str] | None) -> SliceSpec | None:
    """Extract a slice request from Notebook CR annotations. Returns None for
    CPU notebooks (no accelerator annotations present).

    Accepted forms:
    - ``tpu.kubeflow.org/accelerator: h100-16``           (shorthand)
    - ``tpu.kubeflow.org/accelerator: h100`` +
      ``tpu.kubeflow.org/topology: 2x8``                  (explicit topology)
    - ``tpu.kubeflow.org/accelerator: h100``              (one card)
    """
    if not annotations:
        return None
    acc = annotations.get(names.TPU_ACCELERATOR_ANNOTATION)
    topo = annotations.get(names.TPU_TOPOLOGY_ANNOTATION)
    if acc is None and topo is None:
        return None
    if acc is None:
        raise GpuRequestError(
            f"{names.TPU_TOPOLOGY_ANNOTATION} requires "
            f"{names.TPU_ACCELERATOR_ANNOTATION}")
    if topo is not None:
        return parse_topology(acc, topo)
    if _slice_short_re.match(acc):
        return parse_short_name(acc)
    # bare generation without topology → smallest slice
    return _spec_for_cards(_generation(acc), 1)
