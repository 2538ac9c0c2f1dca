"""The port's remote admission held against the reference's: a store
with no in-process webhooks, the manager's AdmissionServer over TLS on
an openssl-minted certificate, and Mutating/ValidatingWebhookConfiguration
objects whose ``url`` points at it, so every matching write of the
store goes out as an AdmissionReview and comes back as a JSONPatch.

All 10 cases of tests/test_remote_admission.py run through each package
(``torch_parity.Stack``), each with the case's own steps and assertions
on its side's store, webhooks, server and ``remote_admission``; what
each case returns and each store holds afterwards must be equal after
``normalise``. The accelerator seam is held exactly on each side, as in
tests/test_torch_webhook_server.py: the reference's webhook swaps a
CUDA image on a ``v5e-4`` request for its JAX default, the port's a JAX
image on an ``h100-4`` request for its CUDA default, and a malformed
request is denied with each side's own message.

Then ``apply_json_patch`` of both packages on 500 seeded documents and
patches (``~0``/``~1`` escapes, list inserts and appends, removes of
absent paths), and ``_rule_matches`` on 500 seeded rules and kinds.
Every server started stops in a ``finally``.
"""

from __future__ import annotations

import base64
import contextlib
import copy
import json
import re
import shutil
import subprocess

import numpy as np
import pytest

from kubeflow_tpu.cluster import remote_admission as ref_ra
from kubeflow_tpu_torch.cluster import remote_admission as port_ra
from torch_parity import Stack, normalise_result

SEED = 23
RA = {"ref": ref_ra, "port": port_ra}

needs_openssl = pytest.mark.skipif(shutil.which("openssl") is None,
                                   reason="openssl is not installed")


@pytest.fixture(scope="module")
def tls(tmp_path_factory):
    """One certificate for the module's servers, minted as the
    reference's fixture mints it."""
    if shutil.which("openssl") is None:
        pytest.skip("openssl is not installed")
    d = tmp_path_factory.mktemp("tls")
    cert, key = d / "tls.crt", d / "tls.key"
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", str(key), "-out", str(cert), "-days", "1",
         "-subj", "/CN=127.0.0.1",
         "-addext", "subjectAltName=IP:127.0.0.1"],
        check=True, capture_output=True, timeout=60)
    return cert, key


@contextlib.contextmanager
def world(s, tls):
    """The reference's ``world`` fixture on side ``s``: its store with no
    in-process plugins, its AdmissionServer over TLS, and the two
    webhook configurations pointing at it."""
    cert, key = tls
    s.config = s.Config(tpu_default_image=s.image("default"))
    server = s.wh.server.AdmissionServer(
        s.wh.Mutating(s.store, s.config), s.wh.Validating(s.config),
        host="127.0.0.1", port=0, certfile=str(cert), keyfile=str(key))
    server.start()
    ca_bundle = base64.b64encode(cert.read_bytes()).decode()

    def webhook_config(kind, name, path):
        return {
            "kind": kind,
            "apiVersion": "admissionregistration.k8s.io/v1",
            "metadata": {"name": name},
            "webhooks": [{
                "name": "notebooks.kubeflow.org",
                "failurePolicy": "Fail",
                "clientConfig": {
                    "url": f"https://127.0.0.1:{server.port}{path}",
                    "caBundle": ca_bundle,
                },
                "rules": [{
                    "apiGroups": ["kubeflow.org"],
                    "apiVersions": ["v1"],
                    "operations": ["CREATE", "UPDATE"],
                    "resources": ["notebooks"],
                }],
            }],
        }
    try:
        s.store.create(webhook_config("MutatingWebhookConfiguration",
                                      "nb-mutating", s.wh.server.MUTATE_PATH))
        s.store.create(webhook_config("ValidatingWebhookConfiguration",
                                      "nb-validating",
                                      s.wh.server.VALIDATE_PATH))
        yield s.store, server
    finally:
        server.stop()


def _raised(s, fn, match: str) -> list:
    """Call ``fn``; it must raise the side's ApiError with ``match`` in
    its message. Returns the class name, code and message."""
    with pytest.raises(s.errors.ApiError, match=match) as err:
        fn()
    return [type(err.value).__name__, err.value.code]


def _masked(value):
    """``value`` with each AdmissionServer's port (which differs between
    the two servers) as a token."""
    return json.loads(re.sub(r"127\.0\.0\.1:(?!1/)\d+", "<server>",
                             json.dumps(value)))


def _configs(s) -> list:
    return sorted((o["kind"], o["metadata"]["name"])
                  for o in s.store.all_objects()
                  if o["kind"].endswith("WebhookConfiguration"))


# ------------------------------------- tests/test_remote_admission.py
def ra_mutations_arrive_via_https_admission_review(s, server):
    created = s.store.create(s.api.new_notebook(
        "nb", "ns", image=s.image("foreign"),
        annotations={s.names.TPU_ACCELERATOR_ANNOTATION:
                     s.accelerator("v5e-4")}))
    assert s.k8s.get_annotation(created, s.names.STOP_ANNOTATION) == \
        s.names.RECONCILIATION_LOCK_VALUE
    assert s.api.notebook_container(created)["image"] == s.image("default")
    return created


def ra_denial_arrives_via_https_admission_review(s, server):
    out = _raised(s, lambda: s.store.create(s.api.new_notebook(
        "bad", "ns",
        annotations={s.names.TPU_TOPOLOGY_ANNOTATION: "4x4"})),
        {"ref": "invalid TPU request", "port": "invalid GPU request"}[s.side])
    assert s.store.get_or_none(s.api.KIND, "ns", "bad") is None
    return out


def ra_failure_policy_fail_blocks_when_webhook_down(s, server):
    server.stop()
    return _raised(s, lambda: s.store.create(s.api.new_notebook("nb2", "ns")),
                   "calling webhook")


def ra_failure_policy_ignore_admits_when_webhook_down(s, server):
    server.stop()
    for kind in ("MutatingWebhookConfiguration",
                 "ValidatingWebhookConfiguration"):
        cfg = s.store.get(kind, "", "nb-mutating" if "Mut" in kind
                          else "nb-validating")
        cfg["webhooks"][0]["failurePolicy"] = "Ignore"
        s.store.update(cfg)
    created = s.store.create(s.api.new_notebook("nb3", "ns"))
    assert s.k8s.get_annotation(created, s.names.STOP_ANNOTATION) is None
    return created


def ra_non_matching_kinds_skip_webhooks(s, server):
    server.stop()
    return s.store.create({"kind": "ConfigMap", "apiVersion": "v1",
                           "metadata": {"name": "cm", "namespace": "ns"}})


def ra_deleting_configuration_disables_remote_admission(s, server):
    s.store.delete("MutatingWebhookConfiguration", "", "nb-mutating")
    s.store.delete("ValidatingWebhookConfiguration", "", "nb-validating")
    assert _configs(s) == []
    created = s.store.create(s.api.new_notebook("nb4", "ns"))
    assert s.k8s.get_annotation(created, s.names.STOP_ANNOTATION) is None
    return created


def ra_delete_gating_webhook_fires(s, server):
    s.store.create(s.api.new_notebook("protected", "ns"))
    cfg = s.store.get("ValidatingWebhookConfiguration", "", "nb-validating")
    cfg["webhooks"][0]["rules"][0]["operations"] = ["DELETE"]
    cfg["webhooks"][0]["clientConfig"]["url"] = \
        "https://127.0.0.1:1/validate"
    s.store.update(cfg)
    out = _raised(s, lambda: s.store.delete("Notebook", "ns", "protected"),
                  "calling webhook")
    assert s.store.get("Notebook", "ns", "protected")
    return out


def ra_no_rv_update_keeps_last_write_wins(s, server):
    s.store.create(s.api.new_notebook("nb-lww", "ns"))
    replacement = s.api.new_notebook("nb-lww", "ns", image="img:other")
    replacement["metadata"].pop("resourceVersion", None)
    out = s.store.update(replacement)
    assert s.api.notebook_container(out)["image"] in ("img:other",
                                                      s.image("default"))
    return out


WORLD_CASES = [ra_mutations_arrive_via_https_admission_review,
               ra_denial_arrives_via_https_admission_review,
               ra_failure_policy_fail_blocks_when_webhook_down,
               ra_failure_policy_ignore_admits_when_webhook_down,
               ra_non_matching_kinds_skip_webhooks,
               ra_deleting_configuration_disables_remote_admission,
               ra_delete_gating_webhook_fires,
               ra_no_rv_update_keeps_last_write_wins]


@needs_openssl
@pytest.mark.parametrize("case", WORLD_CASES, ids=lambda f: f.__name__[3:])
def test_world_case(case, tls):
    out = {}
    for side in ("ref", "port"):
        s = Stack(side)
        with world(s, tls) as (_, server):
            result = case(s, server)
        out[side] = _masked([normalise_result(result, side),
                             sorted(s.snapshot().items())])
    assert out["port"] == out["ref"]


def ra_json_patch_roundtrip_unit(s):
    original = {"a": {"b": [1, 2]}, "keep": "x", "drop": True}
    mutated = {"a": {"b": [1, 2, 3], "c": "new"}, "keep": "x"}
    ops = s.wh.server.json_patch(original, mutated)
    assert RA[s.side].apply_json_patch(original, ops) == mutated
    return ops


def ra_json_patch_escaped_keys(s):
    original = {"metadata": {"annotations": {}}}
    mutated = {"metadata": {"annotations": {
        "tpu.kubeflow.org/accelerator": "v5e-4", "a~b": "1"}}}
    ops = s.wh.server.json_patch(original, mutated)
    assert RA[s.side].apply_json_patch(original, ops) == mutated
    return ops


@pytest.mark.parametrize("case", [ra_json_patch_roundtrip_unit,
                                  ra_json_patch_escaped_keys],
                         ids=lambda f: f.__name__[3:])
def test_unit_case(case):
    assert case(Stack("port")) == case(Stack("ref"))


# ------------------------------------------------------ seeded inputs
_KEYS = ["a", "b", "x/y", "m~n", "~1", "spec", "0", "-", "c~0d"]


def _doc(rng, depth=0):
    if depth > 2 or rng.random() < 0.25:
        return copy.deepcopy([1, "s", None, True, [1, 2], {}][
            int(rng.integers(0, 6))])
    if rng.random() < 0.3:
        return [_doc(rng, depth + 1) for _ in range(int(rng.integers(0, 4)))]
    return {str(rng.choice(_KEYS)): _doc(rng, depth + 1)
            for _ in range(int(rng.integers(0, 4)))}


def _escape(token: str) -> str:
    return token.replace("~", "~0").replace("/", "~1")


def _path_in(rng, doc) -> list[str] | None:
    """Tokens of a path valid for an op on ``doc``: an existing
    container's member, or a new key/index beside them."""
    tokens: list[str] = []
    cur = doc
    while True:
        if isinstance(cur, dict):
            if cur and rng.random() < 0.6:
                key = str(rng.choice(sorted(cur)))
                tokens.append(key)
                if isinstance(cur[key], (dict, list)) and rng.random() < 0.6:
                    cur = cur[key]
                    continue
                return tokens
            tokens.append(str(rng.choice(_KEYS)))
            return tokens
        if isinstance(cur, list):
            if not cur:
                tokens.append(str(rng.choice(["0", "-"])))
                return tokens
            idx = int(rng.integers(0, len(cur)))
            tokens.append(str(idx) if rng.random() < 0.8 else "-")
            if tokens[-1] != "-" and isinstance(cur[idx], (dict, list)) \
                    and rng.random() < 0.5:
                cur = cur[idx]
                continue
            return tokens
        return None


def _ops(rng, doc) -> list[dict]:
    ops = []
    for _ in range(int(rng.integers(1, 5))):
        tokens = _path_in(rng, doc)
        if not tokens:
            tokens = [str(rng.choice(_KEYS))] if isinstance(doc, dict) \
                else None
        if tokens is None:
            continue
        if rng.random() < 0.15:
            tokens = ["absent", "deeper"] + tokens   # remove: a no-op
        verb = str(rng.choice(["add", "remove", "replace"]))
        if tokens[-1] == "-" and verb != "add":
            verb = "add"
        op = {"op": verb, "path": "/" + "/".join(_escape(t) for t in tokens)}
        if verb != "remove":
            op["value"] = _doc(rng, 2)
        ops.append(op)
    return ops


def _apply(ra, doc, ops):
    try:
        return ["ok", ra.apply_json_patch(doc, ops)]
    except (KeyError, IndexError, ValueError, TypeError,
            AttributeError) as exc:
        return [type(exc).__name__]


def test_apply_json_patch_on_seeded_documents():
    rng = np.random.default_rng(SEED)
    cases = []
    for _ in range(500):
        doc = {"metadata": _doc(rng), "spec": _doc(rng)}
        cases.append((doc, _ops(rng, doc)))
    outs = {side: [_apply(ra, copy.deepcopy(d), o) for d, o in cases]
            for side, ra in RA.items()}
    assert json.dumps(outs["port"]) == json.dumps(outs["ref"])
    assert sum(o[0] == "ok" for o in outs["port"]) > 300
    for doc, _ in cases:  # the input is never mutated
        assert port_ra.apply_json_patch(doc, []) == doc


_KINDS = ["Notebook", "Pod", "ConfigMap", "StatefulSet", "SlicePool",
          "TPUQuota", "Service", "NotAKind"]
_GROUPS = ["kubeflow.org", "", "apps", "tpu.kubeflow.org", "*", "other"]
_RESOURCES = ["notebooks", "pods", "configmaps", "statefulsets",
              "slicepools", "*", "services"]


def test_rule_matches_on_seeded_rules():
    rng = np.random.default_rng(SEED + 1)
    cases = []
    for _ in range(500):
        rule = {}
        for key, pool in (("apiGroups", _GROUPS), ("resources", _RESOURCES),
                          ("apiVersions", ["v1", "v1beta1", "*"]),
                          ("operations", ["CREATE", "UPDATE", "DELETE",
                                          "*"])):
            if rng.random() < 0.8:
                rule[key] = [str(x) for x in rng.choice(
                    pool, size=int(rng.integers(1, 3)), replace=False)]
        cases.append((rule, str(rng.choice(_KINDS)),
                      str(rng.choice(["CREATE", "UPDATE", "DELETE"])),
                      str(rng.choice(["", "v1", "kubeflow.org/v1",
                                      "apps/v1beta1"]))))
    outs = {side: [ra._rule_matches(*c) for c in cases]
            for side, ra in RA.items()}
    assert outs["port"] == outs["ref"]
    assert 50 < sum(outs["port"]) < 450


def test_webhook_error_and_constants_match():
    assert port_ra.CONFIG_KINDS == ref_ra.CONFIG_KINDS
    assert port_ra.DEFAULT_TIMEOUT_S == ref_ra.DEFAULT_TIMEOUT_S
    assert (port_ra.AdmissionWebhookError.code,
            port_ra.AdmissionWebhookError.reason) == \
        (ref_ra.AdmissionWebhookError.code,
         ref_ra.AdmissionWebhookError.reason)
    from kubeflow_tpu_torch.cluster.errors import ApiError
    assert issubclass(port_ra.AdmissionWebhookError, ApiError)
