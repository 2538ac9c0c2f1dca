"""The two-binary split held against the reference's: the core and the
extension manager (``build_manager(components="core"|"extension")``)
over one store, cooperating only through its state.

All 4 cases of tests/test_split_managers.py run through both packages,
each case's own body and assertions with the binaries' names swapped
(``torch_wire.binaries_case``; the case's v5e-16 notebook is the port's
h100-32, the same 4 workers): the lock → provision → unlock → scale-up
handshake across the two managers, a core-only manager provisioning no
extension resource, the two binaries' own leader Leases under distinct
holders, and an unknown selection refused. Every store a case builds
must end with the same objects (``torch_wire.store_views``; the managers
run under ``start()``). Every manager stops in the fixture's teardown or
the case's ``finally``.
"""

from __future__ import annotations

import pytest

import test_split_managers as ref_cases
from torch_wire import SIDES, binaries_case, store_views

CASES = {"test_lock_handshake_crosses_the_process_boundary": True,
         "test_core_only_process_runs_no_extension_resources": True,
         "test_split_managers_hold_independent_leader_leases": True,
         "test_unknown_components_rejected": False}


def test_every_reference_case_is_run():
    assert sorted(CASES) == sorted(n for n in vars(ref_cases)
                                   if n.startswith("test_"))


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_case(name):
    got = {}
    for side, s in SIDES.items():
        with pytest.MonkeyPatch.context() as mp:
            made = binaries_case(ref_cases, name, s, mp)
        got[side] = store_views(made, side, CASES[name])
    assert got["port"] == got["ref"]
