"""The port's service-proxy subresource held against the reference's.

``/api/v1/namespaces/{ns}/services/{name}:{port}/proxy/...`` is the
path the idle culler's probes take in dev mode. Five cases of
tests/test_service_proxy.py run twice, their own bodies and assertions
against each side's ``ApiServerProxy``, and what each server answered
(status, ``Content-Type``, the relayed or Status body) is compared after
``torch_wire``'s normalisation. The end-to-end case runs each side's own
chain: its culler's serving prober → its apiserver's proxy → its
``ServingServer`` over its continuous engine (the port's on the CPU),
and the counts each probe read must be equal.
"""

from __future__ import annotations

import json
import urllib.request

import pytest
import torch

import test_service_proxy as ref_cases
from torch_wire import run_both, served, store_state, wire_case

CASES = [
    "test_proxy_forwards_to_annotated_backend",
    "test_proxy_failure_modes",
    "test_proxy_per_port_routing_query_and_redirects",
    "test_proxy_rejects_non_http_backend_scheme",
    "test_405_drains_body_keeping_the_connection_usable",
]


@pytest.mark.parametrize("name", CASES)
def test_reference_case(name):
    def run(s, mp):
        tap, _ = wire_case(ref_cases, name, s, mp)
        # the proxy fixture's store is the case's
        return tap.normalised(s)
    out = run_both(run)
    assert out["port"] == out["ref"]
    assert out["port"]


def _engine(side: str):
    """A one-layer model's continuous engine on each side (the port's on
    the CPU)."""
    if side == "ref":
        import jax

        from kubeflow_tpu.models.transformer import (TransformerConfig,
                                                     init_params)
        from kubeflow_tpu.runtime.serving import ContinuousBatchedGenerator
        cfg = TransformerConfig(vocab_size=96, d_model=32, n_layers=1,
                                n_heads=4, n_kv_heads=2, d_ff=48,
                                dtype="float32", max_seq_len=48)
        params = init_params(jax.random.key(0), cfg)
        return cfg, ContinuousBatchedGenerator(params, cfg, n_slots=2,
                                               max_new_cap=8)
    from kubeflow_tpu_torch.models.transformer import (TransformerConfig,
                                                       init_params)
    from kubeflow_tpu_torch.runtime.serving import ContinuousBatchedGenerator
    cfg = TransformerConfig(vocab_size=96, d_model=32, n_layers=1,
                            n_heads=4, n_kv_heads=2, d_ff=48,
                            dtype="float32", max_seq_len=48)
    params = init_params(torch.Generator().manual_seed(0), cfg,
                         device="cpu")
    return cfg, ContinuousBatchedGenerator(params, cfg, n_slots=2,
                                           max_new_cap=8, device="cpu")


def test_culler_serving_prober_through_proxy_end_to_end():
    def run(s, mp):
        if s.side == "ref":
            from kubeflow_tpu.controllers.culling import \
                serving_requests_prober
            from kubeflow_tpu.runtime.server import ServingServer
            from kubeflow_tpu.utils.config import ControllerConfig
        else:
            from kubeflow_tpu_torch.controllers.culling import \
                serving_requests_prober
            from kubeflow_tpu_torch.runtime.server import ServingServer
            from kubeflow_tpu_torch.utils.config import ControllerConfig
        cfg, gen = _engine(s.side)
        counts = []
        with served(s) as (st, server), \
                ServingServer(gen, cfg, port=0) as srv:
            svc = ref_cases._service(name="nb", backend=srv.url)
            st.create(svc)
            probe = serving_requests_prober(ControllerConfig(
                dev_mode=True, dev_proxy_url=server.url))
            nb = {"metadata": {"name": "nb", "namespace": "ns"}}
            counts.append(probe(nb, "8890"))
            req = urllib.request.Request(
                srv.url + "/v1/generate",
                data=json.dumps({"prompt": [1, 2],
                                 "max_new_tokens": 2}).encode(),
                headers={"Content-Type": "application/json"},
                method="POST")
            with urllib.request.urlopen(req, timeout=60):
                pass
            counts.append(probe(nb, "8890"))
            served_requests = server.requests_served
            state = json.loads(json.dumps(store_state(st, s.side))
                               .replace(srv.url, "<serving url>"))
        return counts, served_requests, state
    out = run_both(run)
    assert out["port"] == out["ref"]
    assert out["port"][0] == [0, 1] and out["port"][1] == 2
