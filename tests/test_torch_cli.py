"""The port's kubectl-style CLI held against the reference's.

All 11 cases of tests/test_cli.py run through both packages, each case's
own body and assertions: the reference's ``cli.main`` against the
reference's apiserver, then the port's ``cli.main`` (over the port's
``HttpApiClient``) against the port's apiserver, each store with its
side's Notebook CRD. What each side printed (stdout and stderr, every
read of the capture and what was left, with timestamps and uids masked)
and the objects each store holds at the end, with its last
resourceVersion (``torch_wire.store_state``), must be equal. The
manifests name the reference's accelerator on both sides; the CLI does
not read it. A JSON manifest with ``---`` lines between its documents
(chip_smoke.py phase 24 writes one) reads the same through both CLIs.
Every server stops in a ``finally``.
"""

from __future__ import annotations

import re

import pytest

import test_cli as ref_cases
from torch_wire import SIDES, fixture_body, side_globals, store_state

CASES = sorted(n for n in vars(ref_cases) if n.startswith("test_"))
_TIME = re.compile(r"\d{4}-\d\d-\d\dT\d\d:\d\d:\d\d(\.\d+)?Z")
_UID = re.compile(r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-"
                  r"[0-9a-f]{12}")


class _Capture:
    """``capsys`` for one side's run: every ``readouterr`` the case makes
    is kept."""

    def __init__(self, capsys) -> None:
        self._capsys = capsys
        self.reads: list = []

    def readouterr(self):
        out = self._capsys.readouterr()
        self.reads.append((out.out, out.err))
        return out


def _mask(text: str) -> str:
    return _UID.sub("<uid>", _TIME.sub("<time>", text))


def test_every_reference_case_is_run():
    assert len(CASES) == 11


@pytest.mark.parametrize("name", CASES)
def test_reference_case(name, tmp_path, capsys):
    got = {}
    for side, s in SIDES.items():
        capsys.readouterr()
        cap = _Capture(capsys)
        with pytest.MonkeyPatch.context() as mp:
            with side_globals(mp, ref_cases, side, binaries=True):
                store = s.ClusterStore()
                server = fixture_body(ref_cases.server)(store)
                proxy = next(server)
                try:
                    values = {"server": proxy, "store": store,
                              "tmp_path": tmp_path / side, "capsys": cap}
                    values["tmp_path"].mkdir()
                    fn = getattr(ref_cases, name)
                    params = fn.__code__.co_varnames[:fn.__code__.co_argcount]
                    fn(**{p: values[p] for p in params})
                finally:
                    next(server, None)
        cap.readouterr()
        reads = [(_mask(o), _mask(e)) for o, e in cap.reads]
        if name == "test_watch_streams_initial_state_and_changes":
            # a stream's rows: which were printed, not how often a
            # reconnect repeated one
            reads = sorted({ln for o, e in reads
                            for ln in (o + e).splitlines()})
        # the manifests name the reference's shape on both sides (the CLI
        # does not read it): no seam to map
        state = store_state(store, "port", rvs=True)
        got[side] = (reads, state["objects"], state["last_rv"])
    assert got["port"] == got["ref"]


def test_json_manifest_reads_through_both_clis(tmp_path):
    """``apply -f`` on JSON documents with ``---`` lines between them:
    both packages' ``load_documents`` read the same objects, empty
    documents dropped, and a single JSON object reads alone."""
    import json

    from kubeflow_tpu import cli as ref_cli
    from kubeflow_tpu_torch import cli
    docs = [{"kind": "ConfigMap", "metadata": {"name": "a",
                                               "namespace": "ns"}},
            {"kind": "ConfigMap", "metadata": {"name": "b",
                                               "namespace": "ns"}}]
    path = tmp_path / "m.json"
    path.write_text(json.dumps(docs[0]) + "\n---\n" + json.dumps(docs[1])
                    + "\n---\n")
    many = list(cli.load_documents(str(path)))
    assert many == list(ref_cli.load_documents(str(path))) == docs
    path.write_text(json.dumps(docs[0]))
    assert list(cli.load_documents(str(path))) == docs[:1]
