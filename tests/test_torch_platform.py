"""Platform integration held against the reference's: the legacy OAuth
cleanup on ``setup_controllers``, the cluster TLS profile
(``utils/tls_profile.py``: fetch, fallback, presets, the SSL context,
the watcher) and the manager cache's payload transforms.

All 9 cases of tests/test_platform.py run through both packages, each
case's own body and assertions with the binaries' names swapped
(``torch_wire.binaries_case``). Every store a case builds must end with
the same objects and the same last resourceVersion
(``torch_wire.store_views``). Then the TLS profile's parse on 300 seeded
profiles (every preset, custom ones with seeded cipher lists and
versions, unknown types) and its SSL context: equal fields, equal
minimum versions.
"""

from __future__ import annotations

import ssl

import numpy as np
import pytest

import test_platform as ref_cases
from kubeflow_tpu.utils import tls_profile as ref_tls
from kubeflow_tpu_torch.utils import tls_profile
from torch_wire import SIDES, binaries_case, store_views

SEED = 24
CASES = sorted(n for n in vars(ref_cases) if n.startswith("test_"))


def test_every_reference_case_is_run():
    assert len(CASES) == 9


@pytest.mark.parametrize("name", CASES)
def test_reference_case(name):
    got = {}
    for side, s in SIDES.items():
        with pytest.MonkeyPatch.context() as mp:
            made = binaries_case(ref_cases, name, s, mp)
        got[side] = store_views(made, side, False)
    assert got["port"] == got["ref"]


def test_seeded_profiles_parse_and_apply_as_the_reference():
    rng = np.random.default_rng(SEED)
    versions = ["VersionTLS10", "VersionTLS11", "VersionTLS12",
                "VersionTLS13", "VersionTLS99"]
    suites = ["ECDHE-RSA-AES128-GCM-SHA256", "ECDHE-RSA-AES256-GCM-SHA384",
              "TLS_AES_256_GCM_SHA384", "ECDHE-ECDSA-CHACHA20-POLY1305"]
    for _ in range(300):
        kind = ["Old", "Intermediate", "Modern", "Custom", "Bogus",
                None][rng.integers(6)]
        profile = {} if kind is None else {"type": kind}
        if kind == "Custom" and rng.integers(4):
            custom = {}
            if rng.integers(2):
                custom["minTLSVersion"] = versions[rng.integers(5)]
            if rng.integers(2):
                custom["ciphers"] = [suites[i] for i in rng.choice(
                    4, size=int(rng.integers(4)), replace=False)]
            profile["custom"] = custom
        mine, theirs = tls_profile.parse_profile(profile), \
            ref_tls.parse_profile(profile)
        assert vars(mine) == vars(theirs), profile
        if mine.min_version in ("VersionTLS12", "VersionTLS13"):
            a = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            b = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            mine.apply(a)
            theirs.apply(b)
            assert a.minimum_version == b.minimum_version
            assert [c["name"] for c in a.get_ciphers()] == \
                [c["name"] for c in b.get_ciphers()]
    assert vars(tls_profile.hardened_fallback()) == \
        vars(ref_tls.hardened_fallback())
