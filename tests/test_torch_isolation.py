"""The PyTorch port stands alone: no module of ``kubeflow_tpu_torch``,
not ``chip_smoke.py`` and not the rank entry points the multi-rank tests
spawn (``tests/torch_dist_ranks.py``) imports JAX or anything of the JAX
package, and the package imports on a machine with neither ``triton``,
``nvcc`` nor a card.
"""

from __future__ import annotations

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted(
    p.relative_to(REPO).as_posix()
    for p in (REPO / "kubeflow_tpu_torch").rglob("*.py")) + [
        "chip_smoke.py", "tests/torch_dist_ranks.py"]
FORBIDDEN = ("jax", "jaxlib", "kubeflow_tpu")


def _imported_modules(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("rel", PORT_FILES)
def test_port_module_imports_no_jax(rel):
    tree = ast.parse((REPO / rel).read_text(), filename=rel)
    bad = [m for m in _imported_modules(tree)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{rel} imports {bad}"


@pytest.mark.parametrize("rel", PORT_FILES)
def test_port_module_reads_no_sanitizer_switch(rel):
    """The port keeps plain locks: no module names the JAX package's
    ``KFTPU_SANITIZE`` switch as a value or imports a sanitizer."""
    tree = ast.parse((REPO / rel).read_text(), filename=rel)
    assert not any(isinstance(node, ast.Constant) and
                   node.value == "KFTPU_SANITIZE" for node in ast.walk(tree))
    assert not [m for m in _imported_modules(tree)
                if m.split(".")[-1] == "sanitizer"]
    assert not any(isinstance(node, ast.ImportFrom) and
                   any(a.name == "sanitizer" for a in node.names)
                   for node in ast.walk(tree))


def test_port_file_list_covers_the_package():
    for rel in ("kubeflow_tpu_torch/runtime/server.py",
                "kubeflow_tpu_torch/parallel/mesh.py",
                "kubeflow_tpu_torch/parallel/comm.py",
                "kubeflow_tpu_torch/parallel/ring.py",
                "kubeflow_tpu_torch/parallel/ulysses.py",
                "kubeflow_tpu_torch/parallel/pipeline.py",
                "kubeflow_tpu_torch/runtime/sharded_decode.py",
                "kubeflow_tpu_torch/runtime/elastic.py",
                "kubeflow_tpu_torch/runtime/migrate.py",
                "kubeflow_tpu_torch/utils/k8s.py",
                "kubeflow_tpu_torch/utils/names.py",
                "kubeflow_tpu_torch/tools/dryrun_multidevice.py",
                "kubeflow_tpu_torch/runtime/bootstrap.py",
                "kubeflow_tpu_torch/gpu/topology.py",
                "kubeflow_tpu_torch/controllers/notebook.py",
                "kubeflow_tpu_torch/controllers/slicepool.py",
                "kubeflow_tpu_torch/webhook/mutating.py",
                "kubeflow_tpu_torch/cluster/errors.py",
                "kubeflow_tpu_torch/cluster/store.py",
                "kubeflow_tpu_torch/cluster/events.py",
                "kubeflow_tpu_torch/cluster/kubelet.py",
                "kubeflow_tpu_torch/api/types.py",
                "kubeflow_tpu_torch/api/slicepool.py",
                "kubeflow_tpu_torch/utils/config.py",
                "kubeflow_tpu_torch/utils/drift.py",
                "kubeflow_tpu_torch/utils/metrics.py",
                "kubeflow_tpu_torch/controllers/manager.py",
                "kubeflow_tpu_torch/main.py",
                "kubeflow_tpu_torch/cluster/echo.py",
                "kubeflow_tpu_torch/cluster/cache.py",
                "kubeflow_tpu_torch/controllers/culling.py",
                "kubeflow_tpu_torch/utils/tracing.py",
                "kubeflow_tpu_torch/controllers/slicerepair.py",
                "kubeflow_tpu_torch/utils/fairness.py",
                "kubeflow_tpu_torch/controllers/scheduler.py",
                "kubeflow_tpu_torch/api/tpuquota.py"):
        assert rel in PORT_FILES
    assert len(PORT_FILES) >= 69


def _references(tree: ast.AST) -> set[str]:
    """What ci/lint.py's dead-code pass counts as a reference: names,
    attributes, imported names and identifier-shaped string constants."""
    refs: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            refs.add(node.id)
        elif isinstance(node, ast.Attribute):
            refs.add(node.attr)
        elif isinstance(node, ast.ImportFrom):
            refs.update(a.name for a in node.names)
        elif isinstance(node, ast.Constant) and \
                isinstance(node.value, str) and node.value.isidentifier():
            refs.add(node.value)
    return refs


@pytest.mark.parametrize("rel", sorted(
    p.relative_to(REPO).as_posix()
    for p in (REPO / "tests").glob("test_torch_*.py")) + [
        "tests/torch_parity.py"])
def test_port_tests_name_no_deadcode_allowlist_entry(rel):
    """ci/lint.py counts every reference under tests/: a port test naming
    a deliberately unreferenced definition of the JAX package would make
    its DEADCODE_ALLOWLIST entry stale and fail the lint gate."""
    from ci.lint import DEADCODE_ALLOWLIST
    allowlisted = {name for _, name in DEADCODE_ALLOWLIST}
    tree = ast.parse((REPO / rel).read_text(), filename=rel)
    assert not _references(tree) & allowlisted


_PROBE = r"""
import importlib.abc, sys

class _NoTriton(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] == "triton":
            raise ImportError("triton is absent here")
        return None

sys.meta_path.insert(0, _NoTriton())
import kubeflow_tpu_torch
import kubeflow_tpu_torch.convert
import kubeflow_tpu_torch.ops
import kubeflow_tpu_torch.models.decode
import kubeflow_tpu_torch.models.train
import kubeflow_tpu_torch.runtime.data
import kubeflow_tpu_torch.runtime.trainer
import kubeflow_tpu_torch.runtime.server
import kubeflow_tpu_torch.runtime.serving
import kubeflow_tpu_torch.runtime.sharded_decode
import kubeflow_tpu_torch.runtime.elastic
import kubeflow_tpu_torch.runtime.migrate
import kubeflow_tpu_torch.parallel.partition_rules
import kubeflow_tpu_torch.parallel.ring
import kubeflow_tpu_torch.parallel.ulysses
import kubeflow_tpu_torch.parallel.pipeline
import kubeflow_tpu_torch.models.moe
import kubeflow_tpu_torch.models.lora
import kubeflow_tpu_torch.tools.dryrun_multidevice
import kubeflow_tpu_torch.runtime.bootstrap
import kubeflow_tpu_torch.gpu.topology
import kubeflow_tpu_torch.controllers.notebook
import kubeflow_tpu_torch.controllers.slicepool
import kubeflow_tpu_torch.webhook.mutating
import kubeflow_tpu_torch.cluster.store
import kubeflow_tpu_torch.cluster.events
import kubeflow_tpu_torch.cluster.kubelet
import kubeflow_tpu_torch.api.slicepool
import kubeflow_tpu_torch.utils.config
import kubeflow_tpu_torch.utils.drift
import kubeflow_tpu_torch.controllers.manager
import kubeflow_tpu_torch.cluster.echo
import kubeflow_tpu_torch.cluster.cache
import kubeflow_tpu_torch.controllers.culling
import kubeflow_tpu_torch.utils.tracing
import kubeflow_tpu_torch.controllers.slicerepair
import kubeflow_tpu_torch.utils.fairness
import kubeflow_tpu_torch.controllers.scheduler
import kubeflow_tpu_torch.api.tpuquota
import kubeflow_tpu_torch.main
sys.path.insert(0, "tests")
import torch_dist_ranks
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "kubeflow_tpu"))
print("LEAKED", leaked)
"""


def test_package_imports_without_jax_triton_or_nvcc():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PATH"] = os.path.dirname(sys.executable)   # no nvcc on the PATH
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "LEAKED []" in out.stdout


def _run_chip_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_card_or_the_package(where, tmp_path):
    """No result line and a non-zero exit without CUDA, and in a
    directory that holds chip_smoke.py and nothing else of the repo."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    cwd = REPO
    if where == "alone":
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    out = _run_chip_smoke(cwd)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
