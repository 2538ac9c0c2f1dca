"""Legacy per-notebook OAuthClient cleanup (migration path).

The port's copy of ``kubeflow_tpu/controllers/oauth.py`` (the port
imports nothing of the JAX package), with the same names, objects
and writes.

Reference: odh notebook_oauth.go:29-96, invoked from the deletion branch at
notebook_controller.go:207-229. Before the kube-rbac-proxy era the controller
provisioned one cluster-scoped ``OAuthClient`` CR per notebook and guarded it
with a finalizer on the Notebook. Current versions never create these, but
notebooks born under an old controller still carry the finalizer — so
deletion must (a) best-effort delete the orphaned OAuthClient and (b) strip
the legacy finalizer, or the Notebook hangs in Terminating forever.

The OAuthClient is cluster-scoped and named ``<name>-<namespace>-oauth-client``
(matching the reference's naming), so a namespaced owner reference could never
GC it — hence the explicit finalizer protocol.
"""

from __future__ import annotations

import logging

from ..cluster import errors
from ..utils import k8s, names

# API effect contract: what this module reads, watches and writes,
# kept as data as the reference declares it (its ci/effects.py
# checks the reference's copy); update it with the code.
CONTRACT = {
    "role": "helper",
    "reads": [],
    "watches": [],
    "writes": {
        "OAuthClient": ["delete"],
    },
    "annotations": [],
}


log = logging.getLogger("kubeflow_tpu_torch.oauth")

OAUTH_CLIENT_KIND = "OAuthClient"
# the legacy finalizer old controllers stamped on Notebooks
LEGACY_OAUTH_FINALIZER = names.LEGACY_OAUTH_FINALIZER


def oauth_client_name(namespace: str, name: str) -> str:
    # NOT truncated: legacy controllers created the full name (OAuthClient
    # names may be up to 253 chars) — truncating here would delete the wrong
    # (nonexistent) object and leak the real one while stripping the
    # finalizer
    return f"{name}-{namespace}-oauth-client"



def delete_oauth_client(client, notebook: dict) -> None:
    """Delete the orphaned cluster-scoped OAuthClient; absent is success
    (reference deleteOAuthClient ignores IsNotFound,
    notebook_oauth.go:67-96)."""
    try:
        client.delete(OAUTH_CLIENT_KIND, "",
                      oauth_client_name(k8s.namespace(notebook),
                                        k8s.name(notebook)))
        log.info("deleted legacy OAuthClient for %s/%s",
                 k8s.namespace(notebook), k8s.name(notebook))
    except errors.NotFoundError:
        pass
