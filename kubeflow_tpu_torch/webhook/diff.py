"""Structural diff reporter for admission decisions.

A copy of ``kubeflow_tpu/webhook/diff.py`` (the port imports nothing of
the JAX package). The analog of the reference's go-cmp first-difference Reporter
(odh notebook_mutating_webhook.go:601-646): produces human-readable
"path: old → new" lines describing where two API objects diverge, used to
populate the ``update-pending`` annotation when webhook mutations are parked
on a running notebook."""

from __future__ import annotations

from typing import Any


def first_differences(old: Any, new: Any, path: str = "",
                      limit: int = 5) -> list[str]:
    out: list[str] = []
    _walk(old, new, path, out, limit)
    return out


def _fmt(v: Any) -> str:
    s = repr(v)
    return s if len(s) <= 120 else s[:117] + "..."


def _walk(old: Any, new: Any, path: str, out: list[str], limit: int) -> None:
    if len(out) >= limit:
        return
    if isinstance(old, dict) and isinstance(new, dict):
        for key in sorted(set(old) | set(new)):
            sub = f"{path}.{key}" if path else str(key)
            if key not in old:
                out.append(f"{sub}: <absent> → {_fmt(new[key])}")
            elif key not in new:
                out.append(f"{sub}: {_fmt(old[key])} → <removed>")
            else:
                _walk(old[key], new[key], sub, out, limit)
            if len(out) >= limit:
                return
    elif isinstance(old, list) and isinstance(new, list):
        if len(old) != len(new):
            out.append(f"{path}: len {len(old)} → {len(new)}")
            return
        for i, (a, b) in enumerate(zip(old, new)):
            _walk(a, b, f"{path}[{i}]", out, limit)
            if len(out) >= limit:
                return
    elif old != new:
        out.append(f"{path}: {_fmt(old)} → {_fmt(new)}")
