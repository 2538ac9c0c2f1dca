"""The port's resumable watch path held against the reference's: the
store's resume ring, the apiserver's per-watcher queue and its watch
streams.

The store and queue cases of tests/test_watch_resume.py run through both
packages (the case's own body on each side's store, ``EventFrame`` and
``_WatcherQueue``); the stores and queues a case builds are kept, and
what they hold after it (objects, last rv, every ring frame in order; a
queue's depth, coalesced count and overflow flag) must be equal.

Its stream cases run twice with the reference's ``HttpApiClient``,
against each side's ``ApiServerProxy``: stalled watcher, bookmarks,
stream drop → resume, idle drop → resume off the bookmark, eviction →
410 → relist, the randomised resume-vs-relist equivalence, the two
status-patch cases and the synthesized DELETED. Both runs pass the
case's assertions; the store each wrote must be equal, and so must the
answers the test's own thread got (a watch thread's reconnects race the
test's writes, so its requests are left out of the comparison).

Left for the client slice: the keep-alive pool cases (``test_pool_*``)
and ``test_slim_seen_keeps_routing_fields_only``, which test the client.
"""

from __future__ import annotations

import pytest

import test_watch_resume as ref_cases
from kubeflow_tpu.cluster import errors as ref_errors
from torch_wire import (Tap, client_of, main_thread, recorded_instances,
                        run_both, served, side_globals, store_state,
                        wire_case)

IN_PROCESS = ["test_store_ring_replays_and_evicts",
              "test_deleted_frame_carries_fresh_rv"]
QUEUES = ["test_watcher_queue_coalesces_modified_under_backpressure",
          "test_watcher_queue_preserves_added_type_and_delete_edges",
          "test_watcher_queue_hard_cap_flags_overflow"]


@pytest.mark.parametrize("name", IN_PROCESS)
def test_store_case(name):
    def run(s, mp):
        st = s.ClusterStore()
        with side_globals(mp, ref_cases, s.side, errors=True):
            getattr(ref_cases, name)(st)
        return store_state(st, s.side)
    out = run_both(run)
    assert out["port"] == out["ref"]


@pytest.mark.parametrize("name", QUEUES)
def test_queue_case(name):
    def run(s, mp):
        queues = []
        with side_globals(mp, ref_cases, s.side, errors=True):
            assert ref_cases._WatcherQueue is s.apiserver._WatcherQueue
            recorded_instances(mp, ref_cases, "_WatcherQueue", queues)
            getattr(ref_cases, name)()
        return [(len(q), q.coalesced, q.overflowed, q.soft_limit,
                 q.hard_limit) for q in queues]
    out = run_both(run)
    assert out["port"] == out["ref"]


STREAMS = {
    "test_stalled_watcher_bounded_other_watchers_unaffected": True,
    "test_bookmark_frames_carry_resource_version": False,
    "test_stream_drop_resumes_without_relist": True,
    "test_idle_stream_drop_resumes_off_bookmark": True,
    "test_eviction_410_falls_back_to_relist": True,
    "test_status_patch_merges_against_racing_writer": False,
    "test_synthesized_deleted_routes_through_mappers": True,
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_stream_case(name):
    def run(s, mp):
        tap, st = wire_case(ref_cases, name, s, mp)
        records = tap.normalised(s)
        if STREAMS[name]:
            records = main_thread(records)
        return records, store_state(st, s.side)
    out = run_both(run)
    assert out["port"] == out["ref"]


@pytest.mark.parametrize("capacity,expect_relist", [(4096, False), (1, True)])
def test_resume_vs_relist_equivalence_randomized(capacity, expect_relist):
    def run(s, mp):
        tap, st = wire_case(ref_cases,
                            "test_resume_vs_relist_equivalence_randomized",
                            s, mp, capacity=capacity,
                            expect_relist=expect_relist)
        return main_thread(tap.normalised(s)), store_state(st, s.side)
    out = run_both(run)
    assert out["port"] == out["ref"]


def test_status_patch_conflict_is_bounded_409():
    """tests/test_watch_resume.py's case, the store raising the serving
    side's own ConflictError on every status write: the bounded re-merge
    loop answers 409, which the reference's client raises as its own."""
    def run(s, mp):
        with served(s) as (st, proxy), \
                client_of(proxy, retry_policy=ref_cases.FAST) as client:
            tap = Tap(s, mp)
            client.create({"kind": "Notebook",
                           "metadata": {"name": "hot", "namespace": "ns"},
                           "spec": {"template": {"spec": {"containers": [
                               {"name": "hot", "image": "img"}]}}}})

            def always_conflict(obj):
                raise s.errors.ConflictError("hot object")
            mp.setattr(st, "update_status", always_conflict)
            with pytest.raises(ref_errors.ConflictError):
                client._json(
                    "PATCH",
                    "/apis/kubeflow.org/v1/namespaces/ns/notebooks/hot/status",
                    {"status": {"x": 1}},
                    content_type="application/merge-patch+json")
            return tap.normalised(s), store_state(st, s.side)
    out = run_both(run)
    assert out["port"] == out["ref"]
    assert [r["status"] for r in out["port"][0]
            if r["method"] == "PATCH"] == ["409"]
