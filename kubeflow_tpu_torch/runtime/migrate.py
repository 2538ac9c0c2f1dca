"""Checkpoint-based notebook migration drivers.

Port of ``kubeflow_tpu/runtime/migrate.py``. The control-plane side of a
migration is a three-step annotation machine (Checkpointing → Binding →
Resuming); this module supplies the step that touches runtime state:
checkpoint the train state on the dying slice, resume it on the freshly
bound one. Two drivers share one seam:

- ``SimulatedMigrationDriver``: annotation-carried step bookkeeping for
  the in-process cluster, where pods hold no real training processes.
  ``checkpoint`` snapshots the runtime-step annotation into a token;
  ``resume`` writes it back as the resumed step.
- ``CheckpointMigrationDriver``: backed by runtime/checkpoint.py's
  ``TrainCheckpointer``. The save taken at ``checkpoint`` restores into
  the trees the provider gives at ``resume``, on whatever mesh they live
  (a sharded checkpoint is the full tensors), so a migration needs no
  same-layout guarantee. On a mesh every rank calls both methods (the
  save and the restore are collective) and only the mesh's first rank
  patches the Notebook.

The tokens are the reference's JSON, byte for byte.
"""

from __future__ import annotations

import json
import logging

from ..parallel import comm
from ..utils import k8s, names

log = logging.getLogger("kubeflow_tpu_torch.migrate")


class MigrationError(RuntimeError):
    """A checkpoint or resume step failed; the caller falls back to the
    cold-roll path instead of retrying blindly."""


# Token schema version, embedded as "v" by both drivers: a version this
# process does not know means fields it cannot half-read, so the
# migration fails (MigrationError → cold-roll fallback) instead of
# resuming on a guess.
TOKEN_VERSION = 1


def _check_token_version(meta: dict, token: str) -> None:
    v = meta.get("v", TOKEN_VERSION)  # pre-versioning tokens are v1 shaped
    if v != TOKEN_VERSION:
        raise MigrationError(
            f"checkpoint token version {v!r} not supported "
            f"(this manager speaks v{TOKEN_VERSION}): {token!r}")


def _patch_resumed(client, notebook: dict, step: int) -> None:
    client.patch(k8s.kind(notebook), k8s.namespace(notebook),
                 k8s.name(notebook), {"metadata": {"annotations": {
                     names.RESUMED_STEP_ANNOTATION: str(step)}}})


class SimulatedMigrationDriver:
    """Annotation-carried checkpoint/resume for the in-process cluster.

    The token is self-contained JSON (not controller memory), so a manager
    restart between Checkpointing and Resuming still resumes the right
    step."""

    def checkpoint(self, client, notebook: dict) -> str:
        step_raw = k8s.get_annotation(notebook,
                                      names.RUNTIME_STEP_ANNOTATION)
        try:
            step = int(step_raw) if step_raw is not None else 0
        except ValueError as exc:
            raise MigrationError(
                f"unparseable runtime step {step_raw!r}") from exc
        return json.dumps({"v": TOKEN_VERSION, "step": step})

    def resume(self, client, notebook: dict, token: str) -> None:
        try:
            meta = json.loads(token)
            _check_token_version(meta, token)
            step = int(meta["step"])
        except (ValueError, KeyError, TypeError, AttributeError) as exc:
            raise MigrationError(f"bad checkpoint token {token!r}") from exc
        _patch_resumed(client, notebook, step)


class CheckpointMigrationDriver:
    """Force-save the live train state before the slice dies, restore it
    once the bound slice is up.

    ``state_provider(notebook) -> (step, params, opt_state)`` gives the
    live state and ``abstract_provider(notebook) -> (params, opt_state)``
    the trees to restore into (their dtypes, device and, on a mesh, this
    rank's shards decide the result: the port's counterpart of the
    reference's abstract targets); ``directory_for(notebook)`` maps a
    notebook to its checkpoint location. With ``mesh`` and
    ``param_specs`` (the spec tree the step shards by) the trees are each
    rank's shards on ``mesh``, as in ``TrainCheckpointer``."""

    def __init__(self, directory_for, state_provider, abstract_provider, *,
                 mesh=None, param_specs=None):
        self.directory_for = directory_for
        self.state_provider = state_provider
        self.abstract_provider = abstract_provider
        self.mesh = mesh
        self.param_specs = param_specs

    def _checkpointer(self, directory, **kw):
        from .checkpoint import TrainCheckpointer
        return TrainCheckpointer(directory, mesh=self.mesh,
                                 param_specs=self.param_specs, **kw)

    def checkpoint(self, client, notebook: dict) -> str:
        directory = self.directory_for(notebook)
        step, params, opt_state = self.state_provider(notebook)
        with self._checkpointer(directory, async_save=False) as ckpt:
            if not ckpt.save(step, params, opt_state, force=True):
                raise MigrationError(f"save at step {step} was skipped")
        return json.dumps({"v": TOKEN_VERSION, "step": int(step),
                           "directory": str(directory)})

    def resume(self, client, notebook: dict, token: str):
        """(step, params, opt_state) restored at the token's step; the
        mesh's first rank stamps the resumed step on the Notebook."""
        try:
            meta = json.loads(token)
            _check_token_version(meta, token)
            step, directory = int(meta["step"]), meta["directory"]
        except (ValueError, KeyError, TypeError, AttributeError) as exc:
            raise MigrationError(f"bad checkpoint token {token!r}") from exc
        like_params, like_opt = self.abstract_provider(notebook)
        with self._checkpointer(directory) as ckpt:
            restored = ckpt.restore(like_params, like_opt, step=step)
        if restored is None:
            raise MigrationError(f"no checkpoint at step {step} "
                                 f"in {directory}")
        if comm.is_mesh_root(self.mesh):
            _patch_resumed(client, notebook, restored[0])
        return restored
