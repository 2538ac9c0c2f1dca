"""The injected clock and RNG seams held against the reference's: each
one honoured, so state ages without sleeping.

All 6 cases of tests/test_clock_seams.py run through both packages, each
case's own body and assertions on each side's ``EventRecorder``,
``HttpApiClient``, ``StatefulSetSimulator``, ``SlicePoolReconciler`` and
``NotebookReconciler`` (``torch_wire.binaries_case``). The bind-gate
case's v4-8 slice (one host of four chips) is the port's h100-4 (one
worker of four cards), in its SlicePool and its parsed request alike.
Every store a case builds must end with the same objects and the same
last resourceVersion (``torch_wire.store_views``), the SlicePool's
request aside.
"""

from __future__ import annotations

import pytest

import test_clock_seams as ref_cases
from kubeflow_tpu_torch.api import slicepool as pool_api
from kubeflow_tpu_torch.cluster import events, kubelet
from kubeflow_tpu_torch.controllers import notebook, slicepool
from kubeflow_tpu_torch.gpu import topology
from torch_wire import SIDES, binaries_case, store_views

CASES = sorted(n for n in vars(ref_cases) if n.startswith("test_"))
# the reference's slice and the port's with the same shape of host
SLICE = {"v4-8": "h100-4"}


class _PoolApi:
    """The port's ``api.slicepool`` with the case's request mapped."""

    def __getattr__(self, name):
        return getattr(pool_api, name)

    @staticmethod
    def new_slice_pool(name, accelerator, *a, **kw):
        return pool_api.new_slice_pool(name, SLICE.get(accelerator,
                                                       accelerator), *a, **kw)


def _port_names(mp) -> None:
    mp.setattr(ref_cases, "pool_api", _PoolApi())
    mp.setattr(ref_cases, "events", events)
    mp.setattr(ref_cases, "StatefulSetSimulator",
               kubelet.StatefulSetSimulator)
    mp.setattr(ref_cases, "NotebookReconciler", notebook.NotebookReconciler)
    mp.setattr(ref_cases, "SlicePoolReconciler",
               slicepool.SlicePoolReconciler)
    mp.setattr(ref_cases, "parse_short_name",
               lambda short: topology.parse_short_name(SLICE.get(short,
                                                                 short)))


def test_every_reference_case_is_run():
    assert len(CASES) == 6


@pytest.mark.parametrize("name", CASES)
def test_reference_case(name):
    got = {}
    for side, s in SIDES.items():
        with pytest.MonkeyPatch.context() as mp:
            if side == "port":
                _port_names(mp)
            made = binaries_case(ref_cases, name, s, mp)
        views = store_views(made, side, False)
        got[side] = [([o for o in objs if o["kind"] != "SlicePool"], rv)
                     for objs, rv in views]
    assert got["port"] == got["ref"]
