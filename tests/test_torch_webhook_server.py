"""The port's AdmissionReview server, JSONPatch and diff reporter held
against the reference's.

Every case of tests/test_webhook_server.py and tests/test_webhook_diff.py
runs through each package (``torch_parity.Stack``), each side with the
case's own assertions, and what the case returns is compared after
``normalise``. The accelerator seam is held exactly on each side: the
reference's server swaps a CUDA image on a ``v5e-N`` request for its JAX
one, the port's a JAX image on an ``h100-N`` request for its CUDA one,
and a malformed request is denied with each side's own message.

Then ``json_patch`` and ``first_differences`` of both packages on 300
pairs of objects drawn with numpy from one seed (the same ops, and the
ops applied turn the first object into the second), and the same
AdmissionReviews through each package's server on 127.0.0.1: the same
answers (allowed, code, message), the same JSONPatch ops, the same
patched objects after ``normalise``. Every server started stops in a
``finally``, and every request has a timeout.
"""

from __future__ import annotations

import base64
import contextlib
import copy
import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from chip_smoke import _apply_json_patch as apply_patch
from torch_parity import Stack, normalise, normalise_result

SEED = 20
TIMEOUT = 5


@contextlib.contextmanager
def serving(s, **config):
    """The side's AdmissionServer on 127.0.0.1, port 0, plain HTTP, over
    its webhooks on its store; stopped on the way out."""
    s.config = s.Config(**config)
    srv = s.wh.server.AdmissionServer(
        s.wh.Mutating(s.store, s.config), s.wh.Validating(s.config),
        host="127.0.0.1", port=0)
    srv.start()
    try:
        yield srv
    finally:
        srv.stop()


def post(srv, path, request) -> dict:
    review = {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
              "request": request}
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}{path}",
        data=json.dumps(review).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
        return json.loads(resp.read())["response"]


def post_raw(srv, path, body: bytes) -> int:
    """The HTTP status of POSTing ``body`` as it is."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}{path}", data=body,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
            return resp.status
    except urllib.error.HTTPError as exc:
        return exc.code


# -------------------------------------- tests/test_webhook_server.py
def ws_mutate_returns_jsonpatch(s):
    with serving(s, tpu_default_image=s.image("default")) as srv:
        nb = s.api.new_notebook("nb", "ns", image=s.image("foreign"),
                                annotations={
                                    s.names.TPU_ACCELERATOR_ANNOTATION:
                                        s.accelerator("v5e-4")})
        resp = post(srv, s.wh.server.MUTATE_PATH, {
            "uid": "u1", "operation": "CREATE", "object": nb})
    assert resp["allowed"] and resp["uid"] == "u1"
    assert resp["patchType"] == "JSONPatch"
    ops = json.loads(base64.b64decode(resp["patch"]))
    assert any("annotations" in op["path"] for op in ops)
    patched = apply_patch(nb, ops)
    assert s.api.notebook_container(patched)["image"] == s.image("default")
    return [(op["op"], op["path"]) for op in ops], patched


def ws_validate_denies_bad_tpu_request(s):
    with serving(s) as srv:
        nb = s.api.new_notebook("nb", "ns", annotations={
            s.names.TPU_ACCELERATOR_ANNOTATION:
                {"ref": "v5e-3", "port": "h100-3"}[s.side]})
        resp = post(srv, s.wh.server.VALIDATE_PATH, {
            "uid": "u2", "operation": "CREATE", "object": nb})
    assert resp["allowed"] is False
    assert {"ref": "invalid TPU request",
            "port": "invalid GPU request"}[s.side] in \
        resp["status"]["message"]
    return resp["uid"], resp["allowed"], resp["status"]["code"]


def ws_malformed_review_is_400(s):
    with serving(s) as srv:
        code = post_raw(srv, s.wh.server.MUTATE_PATH, b"{}")
    assert code == 400
    return code


def ws_json_patch_roundtrip(s):
    original = {"a": {"b": 1}, "keep": [1, 2], "drop": "x", "esc/key": 1}
    mutated = {"a": {"b": 2, "c": 3}, "keep": [1, 2], "esc/key": 2}
    ops = s.wh.server.json_patch(original, mutated)
    assert apply_patch(original, ops) == mutated
    return ops


# ---------------------------------------- tests/test_webhook_diff.py
def fd(s, *a, **kw):
    return s.wh.diff.first_differences(*a, **kw)


def df_equal_objects_no_diff(s):
    obj = {"a": 1, "b": [1, 2], "c": {"d": "x"}}
    assert fd(s, obj, obj) == []
    return fd(s, obj, obj)


def df_scalar_change_reports_path(s):
    out = fd(s, {"spec": {"image": "a"}}, {"spec": {"image": "b"}})
    assert out == ["spec.image: 'a' → 'b'"]
    return out


def df_added_and_removed_keys(s):
    out = fd(s, {"keep": 1, "gone": 2}, {"keep": 1, "new": 3})
    assert "gone: 2 → <removed>" in out and "new: <absent> → 3" in out
    return out


def df_list_length_change_reported_at_list_path(s):
    out = fd(s, {"containers": [1]}, {"containers": [1, 2]})
    assert out == ["containers: len 1 → 2"]
    return out


def df_nested_list_element_change(s):
    out = fd(s, {"spec": {"containers": [{"image": "a"}]}},
             {"spec": {"containers": [{"image": "b"}]}})
    assert out == ["spec.containers[0].image: 'a' → 'b'"]
    return out


def df_limit_caps_output(s):
    out = fd(s, {str(i): i for i in range(20)},
             {str(i): i + 1 for i in range(20)}, limit=5)
    assert len(out) == 5
    return out


def df_long_values_truncated(s):
    (line,) = fd(s, {"k": "x" * 500}, {"k": "y"})
    assert len(line) < 200 and "..." in line
    return line


def df_type_change_reported(s):
    out = fd(s, {"v": 1}, {"v": "1"})
    assert out == ["v: 1 → '1'"]
    return out


def allow_world(s):
    s.config = s.Config(mlflow_enabled=True, gateway_url="gw.example.com")
    s.wh.Mutating(s.store, s.config).install(s.store)
    s.wh.Validating(s.config).install(s.store)


def running_nb(s, annotations=None):
    s.store.create(s.api.new_notebook("nb", "ns", annotations=annotations))
    return s.store.patch(s.api.KIND, "ns", "nb", {"metadata": {
        "annotations": {s.names.STOP_ANNOTATION: None}}})


def va_allows_adding_mlflow_annotation_to_running(s):
    allow_world(s)
    running_nb(s)
    ann = s.names.MLFLOW_INSTANCE_ANNOTATION
    out = s.store.patch(s.api.KIND, "ns", "nb", {"metadata": {
        "annotations": {ann: "mlflow"}}})
    assert s.k8s.get_annotation(out, ann) == "mlflow"
    return out


def va_allows_update_without_touching_annotation(s):
    allow_world(s)
    ann = s.names.MLFLOW_INSTANCE_ANNOTATION
    running_nb(s, annotations={ann: "mlflow"})
    out = s.store.patch(s.api.KIND, "ns", "nb", {"metadata": {
        "labels": {"team": "ds"}}})
    assert s.k8s.get_annotation(out, ann) == "mlflow"
    return out


def va_denies_emptying_annotation_on_running(s):
    allow_world(s)
    ann = s.names.MLFLOW_INSTANCE_ANNOTATION
    running_nb(s, annotations={ann: "mlflow"})
    with pytest.raises(s.wh.AdmissionDenied) as exc:
        s.store.patch(s.api.KIND, "ns", "nb", {"metadata": {
            "annotations": {ann: ""}}})
    return exc.value.code, exc.value.message


def va_allows_removal_when_stopped(s):
    allow_world(s)
    ann = s.names.MLFLOW_INSTANCE_ANNOTATION
    running_nb(s, annotations={ann: "mlflow"})
    s.store.patch(s.api.KIND, "ns", "nb", {"metadata": {"annotations": {
        s.names.STOP_ANNOTATION: "2026-01-01T00:00:00Z"}}})
    out = s.store.patch(s.api.KIND, "ns", "nb", {"metadata": {
        "annotations": {ann: None}}})
    assert s.k8s.get_annotation(out, ann) is None
    return out


def _cases(prefix: str, fns) -> dict:
    return {f"{prefix}.{fn.__name__.split('_', 1)[1]}": fn for fn in fns}


CASES = {}
CASES.update(_cases("test_webhook_server", (
    ws_mutate_returns_jsonpatch, ws_validate_denies_bad_tpu_request,
    ws_malformed_review_is_400, ws_json_patch_roundtrip)))
CASES.update(_cases("test_webhook_diff.TestFirstDifferences", (
    df_equal_objects_no_diff, df_scalar_change_reports_path,
    df_added_and_removed_keys, df_list_length_change_reported_at_list_path,
    df_nested_list_element_change, df_limit_caps_output,
    df_long_values_truncated, df_type_change_reported)))
CASES.update(_cases("test_webhook_diff.TestValidatingAllowPaths", (
    va_allows_adding_mlflow_annotation_to_running,
    va_allows_update_without_touching_annotation,
    va_denies_emptying_annotation_on_running,
    va_allows_removal_when_stopped)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_server_and_diff_case_through_both_packages(case):
    got, stores, writes = {}, {}, {}
    for s in (Stack("ref"), Stack("port")):
        got[s.side] = normalise_result(CASES[case](s), s.side)
        stores[s.side] = {(o["kind"], s.k8s.namespace(o), s.k8s.name(o)):
                          normalise(o, s.side)
                          for o in s.store.all_objects()}
        writes[s.side] = s.store._last_rv
    assert got["port"] == got["ref"]
    assert stores["port"] == stores["ref"]
    assert writes["port"] == writes["ref"]


# ----------------------------------------------------- seeded objects
_KEYS = ["a", "b", "c", "spec", "image", "env", "x/y", "t~1", "name"]


def _value(rng, depth: int):
    kind = rng.random()
    if depth > 0 and kind < 0.35:
        return {str(rng.choice(_KEYS)): _value(rng, depth - 1)
                for _ in range(int(rng.integers(0, 4)))}
    if depth > 0 and kind < 0.5:
        return [_value(rng, depth - 1) for _ in range(int(rng.integers(0, 3)))]
    if kind < 0.7:
        return str(rng.choice(["", "v", "w" * 130, "jax", "1"]))
    if kind < 0.85:
        return int(rng.integers(-3, 4))
    return [None, True, False, 0.5][int(rng.integers(0, 4))]


def _mutated(rng, value, depth: int):
    """``value`` with keys dropped, added or rewritten at random."""
    if isinstance(value, dict):
        out = {}
        for k, v in value.items():
            r = rng.random()
            if r < 0.15:
                continue
            out[k] = _mutated(rng, v, depth - 1) if r < 0.8 \
                else _value(rng, depth - 1)
        if rng.random() < 0.3:
            out[str(rng.choice(_KEYS))] = _value(rng, depth - 1)
        return out
    if isinstance(value, list) and rng.random() < 0.7:
        return [_mutated(rng, v, depth - 1) for v in value]
    return value if rng.random() < 0.6 else _value(rng, max(depth - 1, 0))


def test_json_patch_and_diffs_match_the_reference_on_seeded_pairs():
    """``json_patch`` and ``first_differences`` of both packages on 300
    pairs drawn from one seed: the same ops, which applied to the first
    object give the second, and the same diff lines (the default limit
    and a limit of 2)."""
    from kubeflow_tpu.webhook import diff as ref_diff
    from kubeflow_tpu.webhook import server as ref_server
    from kubeflow_tpu_torch.webhook import diff, server
    rng = np.random.default_rng(SEED)
    kinds = set()
    for i in range(300):
        a = {str(rng.choice(_KEYS)): _value(rng, 3)
             for _ in range(int(rng.integers(1, 5)))}
        b = _mutated(rng, a, 3)
        ops = server.json_patch(a, b)
        assert ops == ref_server.json_patch(a, b), i
        assert apply_patch(a, ops) == b, i
        kinds.update(op["op"] for op in ops)
        for limit in (5, 2):
            assert diff.first_differences(a, b, path="spec", limit=limit) \
                == ref_diff.first_differences(a, b, path="spec",
                                              limit=limit), i
    assert kinds == {"add", "remove", "replace"}


# --------------------------------------------- reviews over the wire
def _reviews(s) -> list:
    """The side's AdmissionReviews, in order: (path, request), the
    request None for a body that is not JSON."""
    acc = s.names.TPU_ACCELERATOR_ANNOTATION
    created = s.api.new_notebook("nb", "ns", image=s.image("foreign"),
                                 annotations={
                                     acc: s.accelerator("v5e-4"),
                                     s.names.INJECT_AUTH_ANNOTATION: "true"})
    running = s.api.new_notebook("run", "ns", image=s.image("native"),
                                 annotations={
                                     acc: s.accelerator("v5e-4"),
                                     s.names.MLFLOW_INSTANCE_ANNOTATION:
                                         "mlflow"})
    resized = copy.deepcopy(running)
    resized["metadata"]["annotations"][acc] = s.accelerator("v5e-16")
    touched = copy.deepcopy(running)
    touched["metadata"]["labels"] = {"touch": "1"}
    unmlflowed = copy.deepcopy(running)
    del unmlflowed["metadata"]["annotations"][
        s.names.MLFLOW_INSTANCE_ANNOTATION]
    bad_sidecar = copy.deepcopy(created)
    bad_sidecar["metadata"]["annotations"][
        s.names.AUTH_SIDECAR_CPU_REQUEST_ANNOTATION] = "2"
    mutate, validate = s.wh.server.MUTATE_PATH, s.wh.server.VALIDATE_PATH
    return [
        (mutate, {"uid": "c", "operation": "CREATE", "object": created}),
        (validate, {"uid": "cv", "operation": "CREATE", "object": created}),
        (mutate, {"uid": "t", "operation": "UPDATE", "object": touched,
                  "oldObject": running}),
        (validate, {"uid": "r", "operation": "UPDATE", "object": resized,
                    "oldObject": running}),
        (validate, {"uid": "m", "operation": "UPDATE", "object": unmlflowed,
                    "oldObject": running}),
        (mutate, {"uid": "s", "operation": "CREATE", "object": bad_sidecar}),
        (mutate, {"uid": "d", "operation": "DELETE", "object": running}),
        (mutate, {"uid": "n", "operation": "CREATE", "object": None}),
        (mutate, {"operation": "CREATE", "object": created}),
        ("/elsewhere", {"uid": "e", "operation": "CREATE",
                        "object": created}),
        (mutate, None),
    ]


def test_reviews_over_the_wire_match_the_reference():
    """The same AdmissionReviews through each package's server (a trust
    bundle in the namespace, MLflow on): a CREATE with the lock, the
    image swap, the CA mount and the auth sidecar; a running notebook's
    touch with the CA mount parked in ``update-pending``; a resize and an
    MLflow removal denied on a running notebook (403, each side's resize
    message); a sidecar request over its limit denied by the mutating
    webhook (403); a DELETE passed through; a null object answered with
    a 500 deny; a review without a uid, an unknown path and a body that
    is not JSON answered 400. The answers, the ops and the patched
    objects are equal after ``normalise``."""
    seen = {}
    for s in (Stack("ref"), Stack("port")):
        s.store.create({"apiVersion": "v1", "kind": "ConfigMap",
                        "metadata": {"name": "workbench-trusted-ca-bundle",
                                     "namespace": "ns"},
                        "data": {"ca-bundle.crt": "CERT"}})
        answers = []
        with serving(s, tpu_default_image=s.image("default"),
                     mlflow_enabled=True, gateway_url="gw.example.com") \
                as srv:
            for path, request in _reviews(s):
                if request is None:
                    answers.append(post_raw(srv, path, b"not json"))
                    continue
                try:
                    resp = post(srv, path, request)
                except urllib.error.HTTPError as exc:
                    answers.append(exc.code)
                    continue
                raw = resp.pop("patch", None)
                ops = json.loads(base64.b64decode(raw)) if raw else []
                status = resp.get("status") or {}
                if "cannot change" in status.get("message", ""):
                    assert status["message"] == {
                        "ref": "cannot change TPU slice of a running "
                               "notebook (v5e-4 → v5e-16); stop it first",
                        "port": "cannot change GPU slice of a running "
                                "notebook (h100-4 → h100-32); stop it "
                                "first"}[s.side]
                    resp["status"] = {"code": status["code"]}
                patched = apply_patch(request["object"], ops) \
                    if ops else None
                answers.append(normalise_result(
                    [resp, [(op["op"], op["path"]) for op in ops],
                     patched], s.side))
        seen[s.side] = answers
    assert seen["port"] == seen["ref"]
    got = seen["port"]
    assert got[8:] == [400, 400, 400]
    created = got[0][2]
    assert created["metadata"]["annotations"]["kubeflow-resource-stopped"] \
        == "odh-notebook-controller-lock"
    assert [c["name"] for c in created["spec"]["template"]["spec"][
        "containers"]] == ["nb", "kube-rbac-proxy"]
    assert json.loads(got[2][2]["metadata"]["annotations"][
        "notebooks.opendatahub.io/update-pending"])
    assert [a[0]["status"]["code"] for a in got[3:6]] == [403, 403, 403]
    assert got[6][0]["allowed"] and got[7][0]["status"]["code"] == 500


def test_server_stops_and_answers_only_while_serving():
    """``is_serving`` on both packages: false before ``start``, true
    while the accept loop runs, false after ``stop``; a stopped server
    refuses connections."""
    for s in (Stack("ref"), Stack("port")):
        srv = s.wh.server.AdmissionServer(
            s.wh.Mutating(s.store, s.Config()), s.wh.Validating(s.Config()),
            host="127.0.0.1", port=0)
        assert not srv.is_serving()
        srv.start()
        try:
            assert srv.is_serving()
            port = srv.port
        finally:
            srv.stop()
        assert not srv.is_serving()
        with pytest.raises(OSError):
            urllib.request.urlopen(f"http://127.0.0.1:{port}/",
                                   timeout=TIMEOUT)
