"""The extension binary's platform features held against the
reference's, on ``setup_controllers`` with its defaults (both binaries'
reconcilers, the webhooks in process, the read cache).

All 13 cases of tests/test_platform_features.py run through both
packages, each case's own body and assertions with the binaries' names
swapped (``torch_wire.binaries_case``): runtime images collected,
sanitised, skipped when malformed or unlabelled, kept when the streams
go, mounted and unmounted on a stopped notebook; the Feast mount and its
label cycle; the network policies' contents, removal and drift repair;
the pipeline RBAC's role precheck and env gate. Every store a case
builds must end with the same objects and the same last resourceVersion
(``torch_wire.store_views``: the manager is drained with
``run_until_idle``, so writes line up).
"""

from __future__ import annotations

import pytest

import test_platform_features as ref_cases
from torch_wire import SIDES, binaries_case, store_views

CASES = sorted(n for n in vars(ref_cases) if n.startswith("test_"))


def test_every_reference_case_is_run():
    assert len(CASES) == 13


@pytest.mark.parametrize("name", CASES)
def test_reference_case(name):
    got = {}
    for side, s in SIDES.items():
        with pytest.MonkeyPatch.context() as mp:
            made = binaries_case(ref_cases, name, s, mp)
        got[side] = store_views(made, side, False)
    assert got["port"] == got["ref"]
