"""The two apiservers the port's wire parity tests drive side by side, a
tap that records what each one answered, and the normaliser that
compares the answers (a helper module: pytest collects no tests from it).

A wire case runs twice with the reference's ``HttpApiClient`` (or plain
``http.client``): once against ``kubeflow_tpu``'s ``ApiServerProxy`` over
its ``ClusterStore``, once against the port's. Each run is a reference
test's own body: ``side_globals`` swaps, for the port's run, every name
the test module took from the reference's server half (store, apiserver,
codec, faults, APF, REST mapper, names, the API types) for the port's
object of the same name, so the test's assertions hold on both runs.
In-process cases (``errors=True``) swap the error classes and the
metrics registry too; wire cases keep the reference's, which the
reference's client raises and counts into. Client cases (``client=True``)
swap the client half as well: ``HttpApiClient`` and its module,
``remote_admission``, ``utils.k8s``, the manager, the notebook
reconciler and the tracing module, with the error classes and the
registry, so the case runs reference client against reference server,
then port client against port server. Binaries cases (``binaries=True``)
swap the binaries' modules as well (``main``, ``cli``, the controllers
package with ``setup_controllers``, election, the breaker, sharding, the
TLS profile, the cache, the config); ``SeamApi`` maps a case's
accelerator request to the H100 shape with the same workers.

``Tap`` records every response a side's handler writes: status, the
``Content-Type`` and ``Retry-After`` headers, the body (JSON, or decoded
through the codec when binary) and a watch stream's frames in order.
``normalise_record`` drops ``uid``, timestamps and the ``Date``/``Server``
headers and maps each side's images through ``torch_parity``'s
``normalise``; resourceVersions and continue tokens are kept, since a
single writer makes both stores issue the same sequence. Every server a
helper starts stops in a ``finally``.
"""

from __future__ import annotations

import contextlib
import inspect
import json
import struct
import sys
import types
from types import SimpleNamespace

import pytest

from kubeflow_tpu.api import types as ref_api
from kubeflow_tpu.cluster import apf as ref_apf
from kubeflow_tpu.cluster import apiserver as ref_apiserver
from kubeflow_tpu.cluster import codec as ref_codec
from kubeflow_tpu.cluster import errors as ref_errors
from kubeflow_tpu.cluster import faults as ref_faults
from kubeflow_tpu.cluster import http_client as ref_http_client
from kubeflow_tpu.cluster import remote_admission as ref_remote_admission
from kubeflow_tpu.cluster import restmapper as ref_restmapper
from kubeflow_tpu.cluster import store as ref_store
from kubeflow_tpu.cluster.http_client import HttpApiClient
import kubeflow_tpu.controllers as ref_controllers
from kubeflow_tpu import cli as ref_cli
from kubeflow_tpu import main as ref_main
from kubeflow_tpu.cluster import cache as ref_cache
from kubeflow_tpu.controllers import election as ref_election
from kubeflow_tpu.controllers import manager as ref_manager
from kubeflow_tpu.controllers import netpol as ref_netpol
from kubeflow_tpu.controllers import notebook as ref_notebook
from kubeflow_tpu.controllers import oauth as ref_oauth
from kubeflow_tpu.controllers import rbac as ref_rbac
from kubeflow_tpu.controllers import resilience as ref_resilience
from kubeflow_tpu.controllers import runtime_images as ref_runtime_images
from kubeflow_tpu.controllers import sharding as ref_sharding
from kubeflow_tpu.utils import config as ref_config
from kubeflow_tpu.utils import k8s as ref_k8s
from kubeflow_tpu.utils import logging as ref_logging
from kubeflow_tpu.utils import metrics as ref_metrics
from kubeflow_tpu.utils import names as ref_names
from kubeflow_tpu.utils import tls_profile as ref_tls_profile
from kubeflow_tpu.utils import tracing as ref_tracing
import kubeflow_tpu_torch.controllers as controllers
from kubeflow_tpu_torch import cli, main
from kubeflow_tpu_torch.api import types as api
from kubeflow_tpu_torch.cluster import (apf, apiserver, cache, codec,
                                        errors, faults, http_client,
                                        remote_admission, restmapper, store)
from kubeflow_tpu_torch.controllers import (election, manager, netpol,
                                            notebook, oauth, rbac,
                                            resilience, runtime_images,
                                            sharding)
from kubeflow_tpu_torch.utils import config, k8s
from kubeflow_tpu_torch.utils import logging as port_logging
from kubeflow_tpu_torch.utils import metrics, names, tls_profile, tracing
from torch_parity import SHAPES, normalise_result

TIMEOUT = 10

SIDES = {
    "ref": SimpleNamespace(
        side="ref", store=ref_store, apiserver=ref_apiserver,
        codec=ref_codec, faults=ref_faults, apf=ref_apf,
        restmapper=ref_restmapper, names=ref_names, api=ref_api,
        errors=ref_errors, metrics=ref_metrics,
        http_client=ref_http_client, remote_admission=ref_remote_admission,
        k8s=ref_k8s, manager=ref_manager, notebook=ref_notebook,
        tracing=ref_tracing, ClusterStore=ref_store.ClusterStore,
        ApiServerProxy=ref_apiserver.ApiServerProxy,
        HttpApiClient=ref_http_client.HttpApiClient,
        main=ref_main, cli=ref_cli, controllers=ref_controllers,
        resilience=ref_resilience, election=ref_election,
        sharding=ref_sharding, tls_profile=ref_tls_profile,
        cache=ref_cache, config=ref_config, logging=ref_logging,
        oauth=ref_oauth, netpol=ref_netpol, rbac=ref_rbac,
        runtime_images=ref_runtime_images),
    "port": SimpleNamespace(
        side="port", store=store, apiserver=apiserver, codec=codec,
        faults=faults, apf=apf, restmapper=restmapper, names=names,
        api=api, errors=errors, metrics=metrics,
        http_client=http_client, remote_admission=remote_admission,
        k8s=k8s, manager=manager, notebook=notebook, tracing=tracing,
        ClusterStore=store.ClusterStore,
        ApiServerProxy=apiserver.ApiServerProxy,
        HttpApiClient=http_client.HttpApiClient,
        main=main, cli=cli, controllers=controllers,
        resilience=resilience, election=election, sharding=sharding,
        tls_profile=tls_profile, cache=cache, config=config,
        logging=port_logging, oauth=oauth, netpol=netpol, rbac=rbac,
        runtime_images=runtime_images)}

# the modules of the server half whose names a reference test may hold:
# (attribute of a side, swapped for every case)
_SERVER_HALF = ("store", "apiserver", "codec", "faults", "apf",
                "restmapper", "names", "api")
# the client half, swapped for a client case with the errors and metrics
_CLIENT_HALF = ("http_client", "remote_admission", "k8s", "manager",
                "notebook", "tracing", "errors", "metrics")
# the binaries and what their cases name, swapped with the client half
# for a binaries case
_BINARIES = ("main", "cli", "controllers", "resilience", "election",
             "sharding", "tls_profile", "cache", "config", "logging",
             "oauth", "netpol", "rbac", "runtime_images")


def _twin(name: str, value, flags: tuple[str, ...]):
    """The port's object standing where ``value`` (bound to ``name``)
    stands in the reference's server half, or None: one of its modules,
    a class or function it defines, or a constant of the same name."""
    ref, port = SIDES["ref"], SIDES["port"]
    for attr in _SERVER_HALF + flags:
        ref_mod, port_mod = getattr(ref, attr), getattr(port, attr)
        if value is ref_mod:
            return port_mod
        if isinstance(value, types.ModuleType):
            continue
        owner = getattr(value, "__module__", None)
        if isinstance(value, (type, types.FunctionType)):
            if owner != ref_mod.__name__:
                continue
            twin = getattr(port_mod, value.__name__, None)
        elif getattr(ref_mod, name, None) is value:
            twin = getattr(port_mod, name, None)
        else:
            continue
        if twin is not None:
            return twin
    return None


@contextlib.contextmanager
def side_globals(mp: pytest.MonkeyPatch, module, side: str, *,
                 errors: bool = False, client: bool = False,
                 binaries: bool = False):
    """For the port's run, swap the reference's server-half names in
    ``module``'s globals for the port's (restored on the way out); with
    ``client`` the client half's too, with ``binaries`` the client half's
    and the binaries' (``main``, ``cli``, ``setup_controllers``, the
    election, breaker, sharding and TLS-profile modules, the cache, the
    config and the extension modules their cases name)."""
    if side == "port":
        flags = _CLIENT_HALF + _BINARIES if binaries else \
            _CLIENT_HALF if client else \
            ("errors", "metrics") if errors else ()
        for name, value in list(vars(module).items()):
            if name.startswith("__"):
                continue
            twin = _twin(name, value, flags)
            if twin is not None and twin is not value:
                mp.setattr(module, name, twin)
    yield


class SeamApi:
    """The port's ``api.types`` for a reference case's body: the same
    module, except that ``new_notebook`` maps a reference accelerator
    annotation (``v5e-4``) to the port's request with the same workers
    (``torch_parity.SHAPES``), so a case that names the TPU shape runs
    the H100 one."""

    def __init__(self, mod) -> None:
        self._mod = mod

    def __getattr__(self, name):
        return getattr(self._mod, name)

    def new_notebook(self, *args, annotations=None, **kw):
        if annotations:
            annotations = {k: SHAPES.get(v, v) if isinstance(v, str) else v
                           for k, v in annotations.items()}
        return self._mod.new_notebook(*args, annotations=annotations, **kw)


def seam_api(mp: pytest.MonkeyPatch, module, side: str) -> None:
    """For the port's run, ``module.api`` (already the port's, after
    ``side_globals``) maps the accelerator seam (``SeamApi``)."""
    if side == "port" and hasattr(module, "api"):
        mp.setattr(module, "api", SeamApi(SIDES["port"].api))


def fixture_body(fixture):
    """The function under a module's ``@pytest.fixture``, to build the
    fixture by hand on either side."""
    return fixture.__wrapped__


def inline_modules(mp: pytest.MonkeyPatch, side: str,
                   attrs: tuple[str, ...]) -> None:
    """For the port's run, make an import of each named reference module
    inside a case's body (``from kubeflow_tpu.utils.metrics import
    MetricsRegistry`` in a function) find the port's module: its
    ``sys.modules`` entry is swapped until the case's MonkeyPatch
    undoes it."""
    if side != "port":
        return
    for attr in attrs:
        ref_mod = getattr(SIDES["ref"], attr)
        mp.setitem(sys.modules, ref_mod.__name__, getattr(SIDES["port"], attr))


# ------------------------------------------------------------------ tap
class _TeeWriter:
    """The handler's wfile, with every byte also kept for the tap."""

    def __init__(self, inner, sink: bytearray) -> None:
        self._inner = inner
        self._sink = sink

    def write(self, data) -> int:
        self._sink += data
        return self._inner.write(data)

    def flush(self) -> None:
        self._inner.flush()

    def __getattr__(self, name):
        return getattr(self._inner, name)


class Tap:
    """Every response one side's apiserver writes while the tap is on,
    as ``(method, path, raw bytes)`` in order of arrival; a stream's bytes
    grow as it is written."""

    def __init__(self, s, mp: pytest.MonkeyPatch) -> None:
        self.records: list[tuple[str, str, bytearray]] = []
        handler = s.apiserver._Handler
        orig = handler._dispatch
        records = self.records

        def dispatch(h, method):
            sink = bytearray()
            records.append((method, h.path, sink))
            inner = h.wfile
            h.wfile = _TeeWriter(inner, sink)
            try:
                orig(h, method)
            finally:
                h.wfile = inner
        mp.setattr(handler, "_dispatch", dispatch)

    def normalised(self, s, *, streams: bool = True,
                   ordered: bool = False) -> list:
        """The records so far (a watch stream as far as it was written),
        normalised; in order of arrival when ``ordered``, else sorted."""
        out = [normalise_record(s.side, m, p, bytes(raw), streams=streams)
               for m, p, raw in list(self.records)]
        return out if ordered else sorted(out, key=json.dumps)


def _drop_volatile(value):
    """uid and timestamps out, resourceVersion kept (renamed through
    ``normalise_result``, which drops it)."""
    if isinstance(value, list):
        return [_drop_volatile(v) for v in value]
    if not isinstance(value, dict):
        return value
    return {("rv!" if k == "resourceVersion" else k): _drop_volatile(v)
            for k, v in value.items() if k not in ("uid", "ts", "peer")}


def _restore_rv(value):
    if isinstance(value, list):
        return [_restore_rv(v) for v in value]
    if not isinstance(value, dict):
        return value
    return {("resourceVersion" if k == "rv!" else k): _restore_rv(v)
            for k, v in value.items()}


def normalise_object(value, side: str):
    """An object or body as compared across the apiservers."""
    return _restore_rv(normalise_result(_drop_volatile(value), side))


def _frames(body: bytes, binary: bool) -> list:
    out = []
    if binary:
        pos = 0
        while pos + 4 <= len(body):
            (total,) = struct.unpack(">I", body[pos:pos + 4])
            payload = body[pos + 4:pos + 4 + total]
            if len(payload) < total:
                out.append(["<truncated>"])
                break
            etype, obj = ref_codec.parse_event(payload)
            out.append([etype, obj])
            pos += 4 + total
        return out
    for line in body.split(b"\n"):
        if line:
            frame = json.loads(line)
            out.append([frame["type"], frame["object"]])
    return out


def normalise_record(side: str, method: str, path: str, raw: bytes, *,
                     streams: bool = True) -> dict:
    head, sep, body = raw.partition(b"\r\n\r\n")
    if not sep:
        # a reset cut the headers (where depends on the Server header)
        return {"method": method, "path": path, "body": "<reset>"}
    lines = head.decode("latin-1").split("\r\n")
    status = lines[0].split(" ")[1] if lines and " " in lines[0] else None
    headers = {}
    for line in lines[1:]:
        key, _, val = line.partition(":")
        headers[key.strip().lower()] = val.strip()
    ctype = headers.get("content-type")
    rec = {"method": method, "path": path, "status": status,
           "content-type": ctype,
           "retry-after": headers.get("retry-after")}
    binary = ctype is not None and ref_codec.accepts_binary(ctype)
    if "content-length" not in headers and status == "200" \
            and "watch=" in path:
        frames = _frames(body, binary) if streams else "<stream>"
        if streams:
            frames = [[t, normalise_object(o, side)] for t, o in frames]
        rec["frames"] = frames
        return rec
    declared = int(headers.get("content-length") or 0)
    if len(body) < declared:
        return {"method": method, "path": path, "body": "<reset>"}
    elif binary:
        rec["body"] = normalise_object(ref_codec.decode(body), side)
    elif ctype and "json" in ctype and body:
        rec["body"] = normalise_object(json.loads(body), side)
    else:
        rec["body"] = body.decode("latin-1")
    return rec


# ------------------------------------------------------------- fixtures
@contextlib.contextmanager
def served(s, st=None, **kw):
    """(store, started ApiServerProxy) of side ``s``."""
    st = st if st is not None else s.ClusterStore()
    proxy = s.ApiServerProxy(st, **kw)
    proxy.start()
    try:
        yield st, proxy
    finally:
        proxy.stop()


@contextlib.contextmanager
def client_of(proxy, s=None, **kw):
    """The reference's client on ``proxy``, or side ``s``'s; closed on
    the way out."""
    cls = HttpApiClient if s is None else s.HttpApiClient
    cl = cls(proxy.url, **kw)
    try:
        yield cl
    finally:
        cl.close()


def call_case(fn, values: dict):
    """Call a reference test function with the fixtures it names."""
    params = inspect.signature(fn).parameters
    return fn(**{n: values[n] for n in params if n in values})


def main_thread(records: list) -> list:
    """Records without a client watch thread's requests (its streams and
    its ``resourceVersion=0`` resync LISTs), which race the test's own."""
    return [r for r in records if "watch=" not in r["path"]
            and not (r["method"] == "GET"
                     and "resourceVersion=0" in r["path"])]


def normalise_audit(text: str) -> list:
    out = []
    for line in text.splitlines():
        entry = json.loads(line)
        entry.pop("ts", None)
        entry.pop("peer", None)
        out.append(entry)
    return out


def normalise_exposition(text: str) -> list[str]:
    """Exposition lines with the timing-valued samples of the ``_seconds``
    histograms dropped (their ``_count`` kept)."""
    out = []
    for line in text.splitlines():
        name = line.split("{")[0].split(" ")[0]
        if "_seconds" in name and not line.startswith("#") \
                and not name.endswith("_count"):
            continue
        out.append(line)
    return out


# ----------------------------------------------------- in-process cases
def recorded_instances(mp: pytest.MonkeyPatch, module, name: str,
                       sink: list) -> None:
    """Make ``module.<name>`` (a class) a subclass that keeps every
    instance the case builds in ``sink``."""
    cls = getattr(module, name)

    def init(self, *a, **kw):
        cls.__init__(self, *a, **kw)
        sink.append(self)
    mp.setattr(module, name, type(cls.__name__, (cls,), {"__init__": init}))


def store_state(st, side: str, *, rvs: bool = True) -> dict:
    """A store's objects, its last issued rv and its resume rings (each
    frame's type, rv and object), as compared across the packages."""
    def obj(o):
        o = normalise_object(o, side)
        if not rvs:
            o.get("metadata", {}).pop("resourceVersion", None)
        return o
    objects = sorted((obj(o) for o in st.all_objects()), key=json.dumps)
    rings = {kind: [[f.type, f.rv if rvs else None, obj(f.obj)]
                    for f in ring.frames]
             for kind, ring in sorted(st._watch_rings.items())}
    if not rvs:
        rings = {k: sorted(v, key=json.dumps) for k, v in rings.items()}
    return {"objects": objects, "rings": rings,
            "last_rv": st._last_rv,
            "evicted": {k: r.evicted_rv if rvs else None
                        for k, r in sorted(st._watch_rings.items())}}


def run_both(run) -> dict:
    """``run(s, mp)`` for each side under its own MonkeyPatch; {side:
    result}."""
    out = {}
    for side, s in SIDES.items():
        with pytest.MonkeyPatch.context() as mp:
            out[side] = run(s, mp)
    return out


def wire_case(module, name: str, s, mp: pytest.MonkeyPatch, *,
              tmp_path=None, client_kw: dict | None = None,
              errors: bool = False, client: bool = False,
              inline: tuple[str, ...] = (), **extra) -> tuple:
    """Run reference test ``module.name`` against side ``s``'s server,
    with the fixtures it names built on that side (``store``, ``server``,
    ``client``, ``json_client``, ``bin_client``, ``proxy`` as the
    reference's fixtures build them, ``monkeypatch``, ``tmp_path``), with
    the reference's client, or with ``client`` the side's own (and the
    ``inline`` modules the body imports swapped, ``inline_modules``);
    returns the side's tap and the ``store`` fixture."""
    fn = getattr(module, name)
    params = inspect.signature(fn).parameters
    tap = Tap(s, mp)
    cs = s if client else None
    with contextlib.ExitStack() as stack:
        stack.enter_context(side_globals(mp, module, s.side, errors=errors,
                                         client=client))
        inline_modules(mp, s.side, inline)
        values = {"monkeypatch": mp, "tmp_path": tmp_path, **extra}
        st = s.ClusterStore()
        values["store"] = st
        if params.keys() & {"server", "client", "json_client",
                            "bin_client", "proxy"}:
            _, proxy = stack.enter_context(served(s, st))
            values["server"] = proxy
            values["proxy"] = (st, proxy)
            values["client"] = stack.enter_context(
                client_of(proxy, cs, **(client_kw or {})))
            values["json_client"] = values["client"]
            values["bin_client"] = stack.enter_context(
                client_of(proxy, cs, wire_format="binary",
                          **(client_kw or {})))
        call_case(fn, values)
    return tap, st


def _is_fixture(value) -> bool:
    return type(value).__name__ == "FixtureFunctionDefinition"


def binaries_case(module, name: str, s, mp: pytest.MonkeyPatch, *,
                  fixtures: dict | None = None,
                  inline: tuple[str, ...] = (),
                  keep: tuple[str, ...] = ("ClusterStore",)) -> dict:
    """Run reference test ``module.name`` on side ``s``: the binaries'
    names swapped (``side_globals(..., binaries=True)``), the
    accelerator seam mapped (``seam_api``), the ``inline`` modules its
    body imports swapped. The fixtures it names are built on the side:
    ``store``, ``config``, ``metrics``, ``monkeypatch``, ``fixtures``'
    own, and the module's own fixtures by hand (a generator's teardown
    runs after the case). Returns {class name: instances the case built}
    for each ``keep`` class the module names (a ``store`` fixture counts
    as a ClusterStore the case built)."""
    made: dict = {cls: [] for cls in keep}
    fn = getattr(module, name)
    with contextlib.ExitStack() as stack:
        stack.enter_context(side_globals(mp, module, s.side, binaries=True))
        seam_api(mp, module, s.side)
        inline_modules(mp, s.side, inline)
        for cls in keep:
            if hasattr(module, cls):
                recorded_instances(mp, module, cls, made[cls])
        values = {"monkeypatch": mp, **(fixtures or {})}

        def resolve(param: str):
            if param in values:
                return values[param]
            if param == "store":
                value = getattr(module, "ClusterStore", s.ClusterStore)()
                if "ClusterStore" in made and \
                        not hasattr(module, "ClusterStore"):
                    made["ClusterStore"].append(value)
            elif param == "config":
                value = s.config.ControllerConfig()
            elif param == "metrics":
                value = s.metrics.MetricsRegistry()
            elif _is_fixture(getattr(module, param, None)):
                body = getattr(module, param).__wrapped__
                value = body(**{p: resolve(p) for p in
                                inspect.signature(body).parameters})
                if inspect.isgenerator(value):
                    gen = value
                    value = next(gen)
                    stack.callback(next, gen, None)
            else:
                raise KeyError(f"{name} needs fixture {param!r}")
            values[param] = value
            return value
        fn(**{p: resolve(p) for p in inspect.signature(fn).parameters})
    return made


def store_views(made: dict, side: str, threaded: bool) -> list:
    """What each store a ``binaries_case`` built holds, as compared across
    the packages: with ``threaded`` (managers under ``start()``, whose
    pods, Events and write order ride wall-clock timing) each object's
    key but the pods' and Events', and the Notebooks' and StatefulSets'
    specs; else every object after ``normalise_object`` and the last
    resourceVersion."""
    out = []
    for st in made["ClusterStore"]:
        assert isinstance(st, SIDES[side].ClusterStore)
        objs = list(st.all_objects())
        if threaded:
            keys = sorted((o["kind"], o["metadata"].get("namespace", ""),
                           o["metadata"]["name"]) for o in objs
                          if o["kind"] not in ("Event", "Pod"))
            specs = sorted((normalise_object(o, side)["spec"] for o in objs
                            if o["kind"] in ("Notebook", "StatefulSet")),
                           key=json.dumps)
            out.append((keys, specs))
        else:
            out.append((sorted((normalise_object(o, side) for o in objs),
                               key=json.dumps), st._last_rv))
    return out

