"""Run the ``cuda``-marked tests of tests/test_torch_ops.py on a machine
with an NVIDIA GPU and no JAX:

    python3 tests/run_cuda_tests.py

Those tests touch only the port and torch; the module's JAX-side imports
serve its CPU tests, so they are stood in for here, and the repository's
conftest (which sets JAX up) is skipped. Not collected by pytest.
"""

import os
import sys
from unittest import mock

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    for name in ("jax", "jax.numpy", "kubeflow_tpu", "kubeflow_tpu.models",
                 "kubeflow_tpu.models.decode", "kubeflow_tpu.ops",
                 "kubeflow_tpu.ops.attention",
                 "kubeflow_tpu.ops.decode_attention"):
        sys.modules[name] = mock.MagicMock()
    import pytest
    here = os.path.dirname(os.path.abspath(__file__))
    sys.exit(pytest.main([os.path.join(here, "test_torch_ops.py"), "-m",
                          "cuda", "--noconftest", "-q", "-p",
                          "no:cacheprovider", "-rf"]))
