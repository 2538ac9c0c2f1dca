"""The mutating webhook's image choice for a Notebook that requests an
H100 slice.

The port's counterpart of ``_swap_image_for_tpu`` in
``kubeflow_tpu/webhook/mutating.py``, turned round: the reference
replaces CUDA and generic images with its JAX/libtpu image, so the pod
can drive TPU chips; here an image that cannot drive an NVIDIA card (a
JAX, libtpu or TPU image, a ROCm image, or a generic
``jupyter``/``notebook``/``workbench`` image with no CUDA in it) is
replaced by a CUDA PyTorch notebook image, and a CUDA image is kept. A
mapped image takes its mapping first. The replaced image is recorded
under the reference's ``tpu.kubeflow.org/original-image`` annotation.
"""

from __future__ import annotations

from ..gpu.topology import GpuRequestError, parse_slice_request
from ..utils import k8s, names

# the default image of an H100 notebook (the counterpart of the
# reference's ``tpu_default_image``): Kubeflow's CUDA PyTorch notebook
DEFAULT_GPU_IMAGE = "kubeflownotebookswg/jupyter-pytorch-cuda-full:v1.9.0"

_NOT_FOR_NVIDIA = ("jax", "libtpu", "tpu", "rocm")
_CUDA = ("cuda", "gpu", "nvidia")
_GENERIC = ("jupyter", "notebook", "workbench")


def _cannot_drive_h100(image: str) -> bool:
    lowered = image.lower()
    if any(t in lowered for t in _NOT_FOR_NVIDIA):
        return True
    return any(t in lowered for t in _GENERIC) and \
        not any(t in lowered for t in _CUDA)


def swap_image_for_gpu(nb: dict, *, swap_map: dict | None = None,
                       default_image: str = DEFAULT_GPU_IMAGE) -> bool:
    """Give a Notebook that requests an H100 slice an image that can
    drive the cards: ``swap_map[image]`` when mapped, ``default_image``
    when the image cannot drive an NVIDIA card, else the image as it is.
    Returns whether the image was replaced. A Notebook with no request,
    or a malformed one (the validating webhook denies it), is left
    untouched."""
    try:
        spec = parse_slice_request(
            k8s.get_in(nb, "metadata", "annotations", default={}))
    except GpuRequestError:
        return False
    if spec is None:
        return False
    container = k8s.notebook_container(nb)
    if container is None:
        return False
    image = container.get("image", "")
    if image in (swap_map or {}):
        new_image = swap_map[image]
    elif _cannot_drive_h100(image):
        new_image = default_image
    else:
        return False  # a CUDA image (or the user knows best)
    if not new_image or new_image == image:
        return False
    k8s.set_annotation(nb, names.TPU_ORIGINAL_IMAGE_ANNOTATION, image)
    container["image"] = new_image
    return True
