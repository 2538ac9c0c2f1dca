"""Drift detection + minimal JSON-merge-patch construction.

The port's copy of ``kubeflow_tpu/utils/drift.py`` (the reconciler's
``_apply_drift`` runs on it).

The reference's reconcilehelper Copy*Fields functions (CopyStatefulSetFields,
util.go:107-143 and siblings) encode per-kind field ownership: which fields
the controller asserts, which the server (or another controller) owns. This
module generalizes the second half of that contract to the WIRE:

- ``diff_merge_patch(before, after)`` — the minimal RFC 7386 merge patch
  that turns ``before`` into ``after`` (None when nothing changed);
- ``minimal_update_patch(desired, found, copy_fields)`` — run a Copy*Fields
  mutator against a scratch copy of the live object and return only the
  drifted paths as a merge patch.

Steady-state reconciles then skip the write entirely (no drift → no
request), and a real drift ships as a PATCH carrying ONLY the changed
paths. Merge patches carry no resourceVersion precondition, so the
409-conflict-retry loops (and their live re-GETs) disappear from the
steady-state wire — the reason the reference prefers client.MergeFrom
patches for cooperative fields (odh notebook_controller.go:516-523).

Semantics and limits (RFC 7386):

- dict values diff recursively; only changed keys appear in the patch;
- lists replace wholesale (merge patch cannot splice) — a drifted
  ``ports`` list ships whole, which is still minimal at the PATH level;
- a key present in ``before`` but absent in ``after`` patches to ``null``
  (merge-patch deletion). An EXPLICIT ``None`` value in ``after`` is
  therefore indistinguishable from deletion — desired objects built by the
  generators never carry explicit ``None`` values;
- server-populated fields never enter the patch because the Copy*Fields
  mutators never touch them: ``SERVER_OWNED_METADATA`` documents the set
  and backs ``semantic_equal`` for generalized no-op detection.
"""

from __future__ import annotations

import copy

from . import k8s

#: metadata fields the apiserver owns: populated/bumped server-side, never
#: asserted by a controller's desired state, never part of a drift patch.
#: (``deletionTimestamp``/``finalizers``/``ownerReferences`` are
#: cooperative fields with their own dedicated paths — finalizer updates
#: stay on the conflict-retried PUT path, see errors.update_with_conflict_retry.)
SERVER_OWNED_METADATA = frozenset((
    "uid", "resourceVersion", "generation", "creationTimestamp",
    "managedFields", "selfLink",
))

_ABSENT = object()  # sentinel: "no difference" (None is a legal patch value)


def _diff(before, after):
    if isinstance(before, dict) and isinstance(after, dict):
        patch = {}
        for key, val in after.items():
            if key not in before:
                patch[key] = copy.deepcopy(val)
            else:
                sub = _diff(before[key], val)
                if sub is not _ABSENT:
                    patch[key] = sub
        for key in before:
            if key not in after:
                patch[key] = None  # merge-patch deletion
        return patch if patch else _ABSENT
    if before == after:
        return _ABSENT
    return copy.deepcopy(after)


def diff_merge_patch(before: dict, after: dict) -> dict | None:
    """The minimal RFC 7386 merge patch transforming ``before`` into
    ``after``; ``None`` when they are equal. Invariant (pinned by the
    property tests): ``k8s.json_merge_patch(before, patch) == after`` for
    any pair of JSON objects without explicit ``None`` values."""
    patch = _diff(before, after)
    return None if patch is _ABSENT else patch


def minimal_update_patch(desired: dict, found: dict,
                         copy_fields) -> dict | None:
    """Drift detector over the Copy*Fields contract: apply ``copy_fields
    (desired, scratch)`` to a scratch copy of the live object and diff.
    Returns the minimal merge patch repairing the drift, or ``None`` when
    the live object already satisfies the desired state (including the
    absent-vs-empty-map equivalences the copy helpers encode — a
    server-defaulted object with no SEMANTIC drift produces no write).

    ``found`` is left unmodified (unlike the raw copy_fields helpers,
    which mutate in place for the legacy PUT path)."""
    scratch = k8s.deepcopy(found)
    if not copy_fields(desired, scratch):
        return None
    return diff_merge_patch(found, scratch)


def strip_server_fields(obj: dict) -> dict:
    """A deepcopy of ``obj`` without the server-owned metadata fields and
    ``status`` — the canonical form ``semantic_equal`` compares."""
    out = k8s.deepcopy(obj)
    md = out.get("metadata")
    if isinstance(md, dict):
        for field in SERVER_OWNED_METADATA:
            md.pop(field, None)
        # absent and empty maps are the same state (the Service-PUT lesson
        # in notebook._copy_meta_maps): normalize both away
        for field in ("labels", "annotations"):
            if not md.get(field):
                md.pop(field, None)
    out.pop("status", None)
    return out


def semantic_equal(a: dict, b: dict) -> bool:
    """Deep equality ignoring server-populated fields/defaults: the
    generalized no-op detector (two renders of the same desired state, or
    a desired object vs its server-defaulted stored form with no real
    drift, compare equal)."""
    return strip_server_fields(a) == strip_server_fields(b)
