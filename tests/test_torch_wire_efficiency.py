"""The hot paths' wire efficiency, the port's held against the
reference's: existence selectors over the wire, the metrics scrape's
selective LIST, the Event predicate answered from the watch-fed cache,
the manager's read cache and the request bound of a fleet.

Eleven of tests/test_wire_efficiency.py's twelve cases run through each
package. Nine are the reference's own bodies, run twice
(``torch_wire.side_globals`` with ``client=True``: the reference's
client, reconciler and manager against its apiserver, then the port's
against the port's); their ``http_stack`` fixture is built on each
side. What each server answered to the test's own thread (``Tap``; a
watch thread's streams and resync LISTs race it and are left out) and
the store each case wrote must be equal. Two import
``setup_controllers`` inside their bodies, which the port has not yet
(its composition is ``build_manager``): they run as the reference's
steps on each side's entry point. One of them,
``test_manager_read_cache_eliminates_reconcile_get_storm``, waits on a
``Created`` condition that neither package writes, so the reference's
case waits out its whole 60 s deadline before it measures; here both
sides wait for the reconcile's StatefulSet and for the client's requests
to settle, then hold the same bound on a one-second window.

The twelfth drives the reference's load test (``loadtest/
start_notebooks.py``); its counterpart here is an 8-notebook fleet on
the port's client and apiserver (``chip_smoke._http_fleet``) under the
same bound of 60 controller requests a notebook, once JSON and once
binary. Every client, manager and server stops in a ``finally``.
"""

from __future__ import annotations

import time

import pytest

import test_wire_efficiency as ref_cases
from kubeflow_tpu.cluster import cache as ref_cache
from kubeflow_tpu.controllers import setup_controllers
from kubeflow_tpu_torch.cluster import cache as port_cache
from torch_wire import (Tap, main_thread, recorded_instances, run_both,
                        side_globals, store_state)

PLAIN = ["test_matches_labels_existence_term",
         "test_selector_serialization_and_parse_roundtrip",
         "test_store_list_with_existence_selector"]
WIRED = ["test_existence_selector_filters_server_side",
         "test_scrape_running_uses_selective_list",
         "test_event_predicate_is_wire_free_once_warm",
         "test_event_predicate_wire_free_for_deleted_objects",
         "test_read_cache_shares_manager_watch_streams",
         "test_event_predicate_cache_tracks_new_notebooks"]
CACHE = {"ref": ref_cache, "port": port_cache}


def _http_stack(s):
    """The reference's ``http_stack`` fixture on side ``s``: a store with
    the Notebook CRD behind a started apiserver, and a client; returns
    (store, client, proxy)."""
    store = s.ClusterStore()
    s.api.install_notebook_crd(store)
    proxy = s.ApiServerProxy(store)
    proxy.start()
    return store, s.HttpApiClient(proxy.url), proxy


@pytest.mark.parametrize("name", PLAIN)
def test_plain_case(name):
    def run(s, mp):
        stores = []
        with side_globals(mp, ref_cases, s.side, client=True):
            recorded_instances(mp, ref_cases, "ClusterStore", stores)
            getattr(ref_cases, name)()
        return [store_state(st, s.side) for st in stores]
    out = run_both(run)
    assert out["port"] == out["ref"]


@pytest.mark.parametrize("name", WIRED)
def test_wired_case(name):
    def run(s, mp):
        registries = []
        with side_globals(mp, ref_cases, s.side, client=True):
            recorded_instances(mp, ref_cases, "MetricsRegistry", registries)
            tap = Tap(s, mp)
            store, client, proxy = _http_stack(s)
            try:
                getattr(ref_cases, name)((store, client))
            finally:
                client.close()
                proxy.stop()
        return main_thread(tap.normalised(s)), store_state(store, s.side), \
            len(registries)
    out = run_both(run)
    assert out["port"] == out["ref"]


def _entry_point(s, client):
    """The side's composition over ``client``: the reference's
    ``setup_controllers(client, metrics=)``, the port's
    ``build_manager(client, components="all")``; returns (manager, its
    registry)."""
    if s.side == "ref":
        metrics = s.metrics.MetricsRegistry()
        return setup_controllers(client, metrics=metrics), metrics
    from kubeflow_tpu_torch.main import build_manager
    mgr, _ = build_manager(client, components="all")
    return mgr, mgr.metrics


def _settle(requests, still_s=0.3, limit=30.0):
    last = [requests.total(), time.monotonic()]
    deadline = time.monotonic() + limit
    while time.monotonic() < deadline:
        now = requests.total()
        if now != last[0]:
            last[:] = [now, time.monotonic()]
        elif time.monotonic() - last[1] > still_s:
            return
        time.sleep(0.02)
    raise AssertionError("the client's requests never settled")


def test_manager_read_cache_eliminates_reconcile_get_storm():
    def run(s, mp):
        store, client, proxy = _http_stack(s)
        mgr = None
        try:
            mgr, metrics = _entry_point(s, client)
            assert mgr.read_cache is not None
            assert {"Secret", "ConfigMap", "Event"} <= set(
                mgr.read_cache.disable_for)
            mgr.start()
            requests = metrics.counter("rest_client_requests_total", "")
            store.create(s.api.new_notebook("cached", "default"))
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                if store.get_or_none("StatefulSet", "default", "cached"):
                    break
                time.sleep(0.05)
            _settle(requests)
            settled = requests.total()
            time.sleep(1.0)  # steady state: no reconcile-driven GET churn
            assert requests.total() - settled <= 2
        finally:
            if mgr is not None:
                mgr.stop()
            client.close()
            proxy.stop()
        sts = store.get("StatefulSet", "default", "cached")
        return sorted(mgr.read_cache.disable_for), \
            s.k8s.get_in(sts, "spec", "replicas")
    out = run_both(run)
    assert out["port"] == out["ref"]


def test_backfill_failure_degrades_to_live_reads():
    def run(s, mp):
        cache_cls = CACHE[s.side].CachingClient
        calls = {"n": 0}
        orig_backfill = cache_cls.backfill

        def flaky(self, kind):
            calls["n"] += 1
            if calls["n"] <= 2:  # the first backfills blow up
                raise OSError("boot-time blip")
            return orig_backfill(self, kind)
        mp.setattr(cache_cls, "backfill", flaky)
        store, client, proxy = _http_stack(s)
        mgr = None
        try:
            mgr, _ = _entry_point(s, client)  # must not raise
            assert calls["n"] >= 2
            mgr.start()
            store.create(s.api.new_notebook("survivor", "default"))
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                if store.get_or_none("StatefulSet", "default", "survivor"):
                    break
                time.sleep(0.05)
            assert store.get_or_none("StatefulSet", "default", "survivor"), \
                "reconciliation never happened after backfill failure"
        finally:
            if mgr is not None:
                mgr.stop()
            client.close()
            proxy.stop()
        sts = store.get("StatefulSet", "default", "survivor")
        return s.k8s.get_in(sts, "spec", "replicas"), calls["n"] >= 2
    out = run_both(run)
    assert out["port"] == out["ref"]


@pytest.mark.parametrize("wire_format", ["json", "binary"])
def test_wire_requests_per_notebook_bounded(wire_format):
    """The port's counterpart of ``test_loadtest_wire_requests_per_notebook_
    bounded``: 8 h100-4 notebooks (the reference's 8 v5e-4) created on
    the store, every one SliceReady through a manager that reaches it
    only over the port's client, under 60 controller requests a
    notebook."""
    from chip_smoke import _http_fleet
    fleet = _http_fleet({"h100-4": 8}, wire_format=wire_format,
                        namespaces=1, components="all", timeout=60.0)
    assert fleet["notebooks"] == 8
    assert 0 < fleet["requests_per_notebook"] < 60.0, fleet
    assert fleet["connections"]["pooled"] >= 1
