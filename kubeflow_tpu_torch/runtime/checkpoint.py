"""Train-state checkpoint/resume, on one device or a mesh.

Port of ``kubeflow_tpu/runtime/checkpoint.py``'s ``TrainCheckpointer``:
the same save/restore API, retention (``max_to_keep``), cadence
(``save_interval_steps``, ``force``) and asynchronous saves. The JAX
package writes orbax directories, which the port cannot read (it never
imports JAX), so the format is the port's own and needs only torch and
the standard library:

- one directory per step, named by the step, written under a temporary
  name and renamed when complete (files and directory fsynced first), so
  a half-written step is never listed;
- ``params.pt`` and ``opt_state.pt``: each a ``torch.save`` dict of the
  tree's tensors keyed by their path in the tree, loaded with
  ``weights_only=True`` (``restore_params`` opens only ``params.pt``);
- ``manifest.json``: the step, each tree's structure (dict keys, the
  NamedTuple types of the optimizer state), each tensor's dtype and
  shape, and the host ints of the state (``FusedAdamWState.count``).

A restore fills the tensors of the trees it is given (``like_*``), in
place: their dtypes and device decide what the restored state is, the
one-device form of the reference's abstract restore targets.

The port's optimizer updates params, masters and moments in place, so an
asynchronous save cannot write from those tensors after ``save`` returns:
``save`` copies every leaf to host memory (pinned, for a CUDA tensor)
and waits for the copy before it returns; only the file write runs on
the background thread. A failed background write is raised by the next
``save``, ``wait`` or ``close``.

On a mesh (``mesh=``, with ``param_specs``: the params' spec tree the
train step shards by, ``models.transformer.param_specs`` — an MoE's
under an ``MoEConfig``, the layer axis over pp under
``pipeline_rules()`` — or ``models.lora.lora_specs`` for adapters; the
optimizer state's follows from it by ``opt_state_shardings``) the trees
are each rank's shards. ``save`` gathers every leaf to its full tensor (a
collective: every rank calls it) and the mesh's first rank writes them,
so a sharded checkpoint is the same files as an unsharded one. ``restore``
reads the full tensors on every rank and keeps each leaf's slice under
those specs on the mesh it is given, whatever mesh wrote it: a tp = 2
checkpoint restores onto tp = 4, dp = 4 onto dp = 3 or 5, pp = 2 onto
pp = 1 and back, ep = 2 onto ep = 4, bit for bit.
Which steps are saved is decided from what this checkpointer saved, the
same on every rank; ``wait`` ends with a barrier, so after it every rank
sees the files the writer wrote.
"""

from __future__ import annotations

import json
import os
import shutil
import uuid
from concurrent.futures import Future, ThreadPoolExecutor

import torch

from ..models.train import opt_state_shardings
from ..parallel import comm
from ..parallel.partition_rules import gather_tree
from ..parallel.sharding import shard_tensor

FORMAT = "kubeflow_tpu_torch.checkpoint/1"
_TREES = ("params", "opt_state")


# ------------------------------------------------------------------ trees
def _flatten(tree, path: str, tensors: dict):
    """The manifest node of ``tree``; its tensors go to ``tensors`` under
    their path."""
    if isinstance(tree, torch.Tensor):
        tensors[path] = tree
        return {"tensor": path, "dtype": str(tree.dtype)[len("torch."):],
                "shape": list(tree.shape)}
    if isinstance(tree, dict):
        return {"dict": {k: _flatten(v, f"{path}/{k}", tensors)
                         for k, v in sorted(tree.items())}}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {"tuple": type(tree).__name__,
                "fields": {f: _flatten(getattr(tree, f), f"{path}/{f}",
                                       tensors) for f in tree._fields}}
    if tree is None or isinstance(tree, (bool, int, float)):
        return {"value": tree}
    raise TypeError(f"{path}: cannot checkpoint a {type(tree).__name__}")


def _fill(like, node: dict, tensors: dict, path: str, specs=None,
          mesh=None):
    """``like`` with its tensors overwritten in place from ``tensors`` and
    its host values from ``node``; a structure or shape that differs
    from the checkpoint's raises ValueError. With ``specs`` (a spec tree
    shaped like ``like``) each tensor takes this rank's slice on
    ``mesh``."""
    if isinstance(like, torch.Tensor):
        if "tensor" not in node:
            raise ValueError(f"{path}: the checkpoint holds no tensor here")
        src = tensors[node["tensor"]]
        if specs is not None:
            src = shard_tensor(src, specs, mesh)
        if tuple(src.shape) != tuple(like.shape):
            raise ValueError(f"{path}: checkpoint shape {tuple(src.shape)}, "
                             f"target shape {tuple(like.shape)}")
        with torch.no_grad():
            like.copy_(src)
        return like
    if isinstance(like, dict):
        saved = node.get("dict")
        if saved is None or set(saved) != set(like):
            raise ValueError(f"{path}: keys {sorted(like)} against the "
                             f"checkpoint's {sorted(saved or ())}")
        return {k: _fill(v, saved[k], tensors, f"{path}/{k}",
                         None if specs is None else specs[k], mesh)
                for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        if node.get("tuple") != type(like).__name__:
            raise ValueError(f"{path}: a {type(like).__name__} against the "
                             f"checkpoint's {node.get('tuple')}")
        return type(like)(**{
            f: _fill(getattr(like, f), node["fields"][f], tensors,
                     f"{path}/{f}",
                     None if specs is None else getattr(specs, f), mesh)
            for f in like._fields})
    if "value" not in node:
        raise ValueError(f"{path}: the checkpoint holds a tensor here")
    return node["value"]


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t`` that later in-place updates of ``t`` cannot
    reach; a CUDA tensor lands in pinned memory (the caller waits for
    the copy)."""
    t = t.detach()
    if t.device.type == "cpu":
        return t.clone()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    return out


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class TrainCheckpointer:
    """Checkpoint manager for (params, opt_state) train state.

    Keeps the newest ``max_to_keep`` checkpoints, counted after each
    completed write; persists every ``save_interval_steps`` steps
    (off-cadence saves and steps not newer than the last save are no-ops
    unless forced). With ``mesh``, the trees are each rank's shards under
    ``param_specs`` (and the optimizer state's specs that follow from
    them), and every rank of the mesh makes the same calls."""

    def __init__(self, directory, *, max_to_keep: int = 3,
                 save_interval_steps: int = 1, async_save: bool = True,
                 mesh=None, param_specs=None):
        if max_to_keep < 1 or save_interval_steps < 1:
            raise ValueError("max_to_keep and save_interval_steps must be "
                             ">= 1")
        if (mesh is None) != (param_specs is None):
            raise ValueError("mesh and param_specs go together: the specs "
                             "say how the mesh shards each leaf")
        self.directory = os.fspath(directory)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        os.makedirs(self.directory, exist_ok=True)
        self._executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="kubeflow-tpu-torch-ckpt") \
            if async_save else None
        self._writes: list[tuple[int, Future]] = []
        self.mesh = mesh
        self.param_specs = param_specs
        # on a mesh: the steps saved, known alike on every rank (only the
        # writer's directory listing is current while it writes)
        self._saved = self.all_steps() if mesh is not None else None
        self._writer = comm.is_mesh_root(mesh)

    # ------------------------------------------------------------------ save
    def save(self, step: int, params, opt_state, *,
             force: bool = False) -> bool:
        """Persist train state at ``step``; returns False when skipped by
        the save-interval policy. The leaves are copied to the host before
        this returns; the write may still be running (``wait``)."""
        self._raise_failed()
        saved = self._saved if self.mesh is not None else \
            self.all_steps() + [s for s, _ in self._writes]
        if not force and (step % self.save_interval_steps != 0
                          or any(step <= s for s in saved)):
            return False
        if step in saved:
            raise ValueError(f"step {step} is already saved in "
                             f"{self.directory}")
        if self.mesh is not None:
            params, opt_state = (
                gather_tree(t, self._specs(name, t), self.mesh)
                for name, t in zip(_TREES, (params, opt_state)))
            self._saved.append(step)
            if not self._writer:
                return True
        tensors: dict = {}
        manifest = {"format": FORMAT, "step": int(step), "trees": {
            name: _flatten(tree, name, tensors)
            for name, tree in zip(_TREES, (params, opt_state))}}
        host = {path: _host_copy(t) for path, t in tensors.items()}
        if any(t.device.type == "cuda" for t in tensors.values()):
            torch.cuda.synchronize()
        if self._executor is None:
            self._write(step, manifest, host)
        else:
            self._writes.append((step, self._executor.submit(
                self._write, step, manifest, host)))
        return True

    def _write(self, step: int, manifest: dict, host: dict) -> None:
        final = os.path.join(self.directory, str(step))
        tmp = os.path.join(self.directory,
                           f".tmp-{step}-{uuid.uuid4().hex[:8]}")
        os.makedirs(tmp)
        try:
            for name in _TREES:
                part = {p: t for p, t in host.items()
                        if p.split("/", 1)[0] == name}
                with open(os.path.join(tmp, f"{name}.pt"), "wb") as fh:
                    torch.save(part, fh)
                    fh.flush()
                    os.fsync(fh.fileno())
            with open(os.path.join(tmp, "manifest.json"), "w") as fh:
                json.dump(manifest, fh)
                fh.flush()
                os.fsync(fh.fileno())
            _fsync_dir(tmp)
            os.rename(tmp, final)
            _fsync_dir(self.directory)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    # --------------------------------------------------------------- restore
    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _load(self, step: int | None, names: tuple):
        """(step, manifest, tensors of ``names``), or None when there is
        no checkpoint at ``step`` (or at all)."""
        if step is None:
            step = self.latest_step()
        if step is None or step not in self.all_steps():
            return None
        path = os.path.join(self.directory, str(step))
        with open(os.path.join(path, "manifest.json")) as fh:
            manifest = json.load(fh)
        if manifest.get("format") != FORMAT:
            raise ValueError(f"{path}: not a {FORMAT} checkpoint")
        tensors = {}
        for name in names:
            tensors.update(torch.load(os.path.join(path, f"{name}.pt"),
                                      map_location="cpu", weights_only=True,
                                      mmap=True))
        return step, manifest, tensors

    def restore(self, like_params, like_opt_state, step: int | None = None):
        """(step, params, opt_state) at ``step`` (default: the latest),
        written into the tensors of ``like_params``/``like_opt_state``,
        whose dtypes and device it takes. None when no checkpoint exists
        at ``step`` (or at all), e.g. when retention evicted it."""
        loaded = self._load(step, _TREES)
        if loaded is None:
            return None
        step, manifest, tensors = loaded
        trees = manifest["trees"]
        return (step,) + tuple(
            _fill(like, trees[name], tensors, name, self._specs(name, like),
                  self.mesh)
            for name, like in zip(_TREES, (like_params, like_opt_state)))

    def _specs(self, name: str, like):
        """The spec tree of the ``name`` tree (None off a mesh)."""
        if self.mesh is None:
            return None
        if name == "params":
            return self.param_specs
        return opt_state_shardings(like, self.param_specs)

    def restore_params(self, like_params, step: int | None = None):
        """Params only (serving carries no optimizer state): (step,
        params) or None; reads nothing of the optimizer state."""
        loaded = self._load(step, ("params",))
        if loaded is None:
            return None
        step, manifest, tensors = loaded
        return step, _fill(like_params, manifest["trees"]["params"],
                           tensors, "params",
                           self._specs("params", like_params), self.mesh)

    # -------------------------------------------------------------- lifecycle
    def all_steps(self) -> list[int]:
        """The completed steps on disk, oldest first."""
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit())

    def _raise_failed(self) -> None:
        """Raise the first failed background write, once."""
        for i, (_, fut) in enumerate(self._writes):
            if fut.done() and fut.exception() is not None:
                del self._writes[i]
                raise fut.exception()
        self._writes = [(s, f) for s, f in self._writes if not f.done()]

    def wait(self) -> None:
        """Block until every pending save is durable; raise the first that
        failed."""
        writes, self._writes = self._writes, []
        errors = [f.exception() for _, f in writes]
        comm.barrier(self.mesh)
        for exc in errors:
            if exc is not None:
                raise exc

    def close(self) -> None:
        try:
            self.wait()
        finally:
            if self._executor is not None:
                self._executor.shutdown(wait=True)

    def __enter__(self) -> "TrainCheckpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
