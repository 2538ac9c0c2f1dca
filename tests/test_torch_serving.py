"""The port's serving path (kubeflow_tpu_torch/runtime) on the CPU: the
batched engine against the port's ``generate`` and the JAX package's
``BatchedGenerator`` (speculative batches included), the HTTP endpoint
(per-token streaming and cancel on disconnect through the continuous
engine; the bucketed engine's refusal of a stream as the JAX server's),
and the entry point: checkpoints, draft models, defaults and refusals.

Config: the tiny flagship in float32 (see tests/test_torch_model.py); the
JAX params are carried across with convert.py. Greedy ids must be equal,
token for token.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from kubeflow_tpu.models.transformer import TransformerConfig as JaxConfig
from kubeflow_tpu.models.transformer import init_params as jax_init_params
from kubeflow_tpu.runtime.server import ServingServer as JaxServer
from kubeflow_tpu.runtime.serving import BatchedGenerator as JaxGenerator
from kubeflow_tpu_torch import convert
from kubeflow_tpu_torch.models import train as ttr
from kubeflow_tpu_torch.models.decode import generate
from kubeflow_tpu_torch.models.transformer import TransformerConfig
from kubeflow_tpu_torch.runtime import server as torch_server
from kubeflow_tpu_torch.runtime.checkpoint import TrainCheckpointer
from kubeflow_tpu_torch.runtime.server import ServingServer
from kubeflow_tpu_torch.runtime.serving import (BatchedGenerator,
                                               ContinuousBatchedGenerator)

TINY = dict(vocab_size=512, d_model=64, n_layers=4, n_heads=4, n_kv_heads=2,
            d_ff=128, max_seq_len=128, dtype="float32")
DRAFT = dict(TINY, d_model=32, n_layers=1, d_ff=64)
PROMPTS = [[5, 17, 300, 42, 9, 77], [1, 2, 3, 4, 5, 6], [400, 0, 12, 9, 9, 3]]


def _converted(fields, seed):
    jc = JaxConfig(**fields)
    jp = jax.jit(jax_init_params, static_argnums=1)(jax.random.key(seed), jc)
    tp = convert.to_torch(jax.tree.map(np.asarray, jp))
    return jp, tp, jc, TransformerConfig(**dataclasses.asdict(jc))


@pytest.fixture(scope="module")
def model():
    return _converted(TINY, 0)


@pytest.fixture(scope="module")
def draft():
    return _converted(DRAFT, 7)


def _submit_all(gen, prompts, max_new, **kw):
    futures = [gen.submit(p, max_new, **kw) for p in prompts]
    return [[int(t) for t in f.result(timeout=120)] for f in futures]


@pytest.fixture
def server(model):
    _, tp, _, tc = model
    gen = BatchedGenerator(tp, tc, max_batch=4, max_wait_s=0.2,
                           device="cpu")
    srv = ServingServer(gen, tc, port=0).start()
    try:
        yield srv, tp, tc
    finally:
        srv.stop()


def _post(url, payload, path="/v1/generate"):
    req = urllib.request.Request(
        url + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, resp.headers.get("Content-Type"), resp.read()


# ---------------------------------------------------------------- engine
def test_batched_generator_matches_generate_and_jax_engine(model):
    """Three same-shape requests batch together (padded to 4 rows); each
    row's greedy ids equal the port's ``generate`` on that prompt alone
    and the JAX package's engine on the same params."""
    jp, tp, jc, tc = model
    with BatchedGenerator(tp, tc, max_batch=4, max_wait_s=0.2,
                          device="cpu") as gen:
        got = _submit_all(gen, PROMPTS, 6)
        assert list(gen.batch_sizes) == [3]
    with JaxGenerator(jp, jc, max_batch=4, max_wait_s=0.2) as jgen:
        want = _submit_all(jgen, PROMPTS, 6)
    assert got == want
    for p, ids in zip(PROMPTS, got):
        alone = generate(tp, torch.tensor([p]), tc, 6)
        assert ids == alone[0].tolist()


def test_batched_generator_mixes_greedy_and_sampled_rows(model):
    _, tp, _, tc = model
    with BatchedGenerator(tp, tc, max_batch=4, max_wait_s=0.2,
                          device="cpu") as gen:
        greedy = gen.submit(PROMPTS[0], 5)
        sampled = gen.submit(PROMPTS[1], 5, temperature=0.8, top_k=50,
                             top_p=0.9)
        g_ids = greedy.result(timeout=120)
        s_ids = sampled.result(timeout=120)
        assert list(gen.batch_sizes) == [2]
    want = generate(tp, torch.tensor([PROMPTS[0]]), tc, 5)[0]
    assert g_ids.tolist() == want.tolist()
    assert s_ids.shape == (5,) and ((0 <= s_ids) & (s_ids < 512)).all()


def test_batched_generator_submit_takes_no_on_token(model):
    """The bucketed engine does not stream, as the JAX package's does not:
    neither ``submit`` takes ``on_token``, neither class claims
    streaming."""
    jp, tp, jc, tc = model
    with BatchedGenerator(tp, tc, device="cpu") as gen, \
            JaxGenerator(jp, jc) as jgen:
        for engine in (gen, jgen):
            with pytest.raises(TypeError, match="on_token"):
                engine.submit(PROMPTS[2], 4, on_token=print)
            assert not getattr(engine, "supports_streaming", False)
        assert gen.generate_sync(PROMPTS[2], 4).tolist() == generate(
            tp, torch.tensor([PROMPTS[2]]), tc, 4)[0].tolist()


def test_batched_generator_speculates_like_the_jax_engine(model, draft):
    """A draft model behind the bucketed engine: one speculative batch of
    the three prompts (padded to 4 rows), greedy ids equal to the plain
    engine's and to the JAX engine's with the same draft, and the
    acceptance counters equal the JAX engine's (real rows only)."""
    jp, tp, jc, tc = model
    jdp, tdp, jdc, tdc = draft
    with BatchedGenerator(tp, tc, max_batch=4, max_wait_s=0.2,
                          draft_params=tdp, draft_config=tdc, spec_k=3,
                          device="cpu") as gen:
        got = _submit_all(gen, PROMPTS, 10)
        counters = (gen.batches_total, gen.spec_batches, gen.spec_drafted,
                    gen.spec_accepted)
        assert gen.spec_blocks >= -(-10 // 4)
    with JaxGenerator(jp, jc, max_batch=4, max_wait_s=0.2,
                      draft_params=jdp, draft_config=jdc, spec_k=3) as jgen:
        want = _submit_all(jgen, PROMPTS, 10)
        want_counters = (jgen.batches_total, jgen.spec_batches,
                         jgen.spec_drafted, jgen.spec_accepted)
    assert got == want
    assert counters == want_counters and counters[:2] == (1, 1)
    assert counters[2] % 3 == 0 and counters[2] > 0
    with BatchedGenerator(tp, tc, max_batch=4, max_wait_s=0.2,
                          device="cpu") as plain:
        assert _submit_all(plain, PROMPTS, 10) == got


@pytest.mark.parametrize("request_kw,prompt_len", [
    ({"temperature": 0.8, "top_k": 50}, 6),     # a warped row
    ({"temperature": 0.8, "top_p": 0.9}, 6),
    ({}, 128 - 10 - 2)])                       # P + max_new + k > 128
def test_batched_generator_falls_back_to_generate(model, draft, request_kw,
                                                  prompt_len):
    _, tp, _, tc = model
    _, tdp, _, tdc = draft
    prompt = list(range(1, prompt_len + 1))
    with BatchedGenerator(tp, tc, draft_params=tdp, draft_config=tdc,
                          spec_k=3, device="cpu") as gen:
        ids = gen.generate_sync(prompt, 10, **request_kw)
        assert (gen.batches_total, gen.spec_batches) == (1, 0)
    if not request_kw:
        assert ids.tolist() == generate(tp, torch.tensor([prompt]), tc,
                                        10)[0].tolist()
    assert ((ids >= 0) & (ids < 512)).all()


@pytest.mark.parametrize("exact_only,spec_batches", [(True, 0), (False, 1)])
def test_batched_engine_gate_on_the_flash_decode_path(model, draft,
                                                      exact_only,
                                                      spec_batches):
    """decode_attention="flash" is where plain decode takes the
    flash-decode kernel (on the CPU its plain version) while the verify
    window is the einsum: by default the engine falls back to generate;
    spec_exact_only=False speculates. Greedy ids equal generate's."""
    _, tp, _, tc = model
    _, tdp, _, tdc = draft
    fc = tc.replace(decode_attention="flash")
    with BatchedGenerator(tp, fc, draft_params=tdp, draft_config=tdc,
                          spec_exact_only=exact_only, device="cpu") as gen:
        ids = gen.generate_sync(PROMPTS[0], 8)
        assert gen.spec_batches == spec_batches
    assert ids.tolist() == generate(tp, torch.tensor([PROMPTS[0]]), fc,
                                    8)[0].tolist()


def test_draft_arguments_are_validated(model):
    _, tp, _, tc = model
    with pytest.raises(ValueError, match="together"):
        BatchedGenerator(tp, tc, draft_params=tp, device="cpu")
    with pytest.raises(ValueError, match="spec_k"):
        BatchedGenerator(tp, tc, draft_params=tp, draft_config=tc,
                         spec_k=0, device="cpu")


def test_quantized_engine_matches_quantized_generate(model):
    from kubeflow_tpu_torch.models.quant import quantize_params
    _, tp, _, tc = model
    with BatchedGenerator(tp, tc, quantize=True, device="cpu") as gen:
        got = gen.generate_sync(PROMPTS[0], 5)
    want = generate(quantize_params(tp), torch.tensor([PROMPTS[0]]), tc, 5)
    assert got.tolist() == want[0].tolist()


# ------------------------------------------------------------------ HTTP
def test_http_generate_matches_direct_generate(server):
    srv, tp, tc = server
    status, ctype, body = _post(srv.url, {"prompt": PROMPTS[0],
                                          "max_new_tokens": 6})
    assert status == 200 and ctype == "application/json"
    out = json.loads(body)
    want = generate(tp, torch.tensor([PROMPTS[0]]), tc, 6)[0].tolist()
    assert out["ids"] == want
    assert out["usage"] == {"prompt_tokens": 6, "completion_tokens": 6}


def _refusal(url, payload):
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(url, payload)
    return err.value.code, err.value.headers.get("Content-Type"), \
        json.loads(err.value.read())


def test_http_bucketed_stream_is_refused_as_by_the_jax_server(server,
                                                             model):
    """A streamed request to the bucketed engine: 400 and the JAX server's
    body, word for word; the engine never sees it."""
    srv, _, _ = server
    jp, _, jc, _ = model
    payload = {"prompt": [1, 2, 3], "max_new_tokens": 4, "stream": True}
    got = _refusal(srv.url, payload)
    with JaxServer(JaxGenerator(jp, jc), jc, port=0) as jsrv:
        want = _refusal(jsrv.url, payload)
    assert got == want
    assert got == (400, "application/json", {
        "error": "engine BatchedGenerator does not support streaming; use "
                 "the continuous engine"})
    assert srv.generator.requests_total == 0


def test_http_concurrent_requests_share_the_engine(server):
    srv, tp, tc = server
    results = {}

    def worker(i):
        results[i] = json.loads(_post(srv.url, {
            "prompt": PROMPTS[i], "max_new_tokens": 4})[2])["ids"]

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for i, p in enumerate(PROMPTS):
        assert results[i] == generate(tp, torch.tensor([p]), tc,
                                      4)[0].tolist()
    assert srv.generator.requests_total == 3


def test_http_health_models_and_metrics(server):
    srv, _, tc = server
    _post(srv.url, {"prompt": [1, 2], "max_new_tokens": 2})
    with urllib.request.urlopen(srv.url + "/healthz", timeout=30) as r:
        health = json.loads(r.read())
    assert health["status"] == "ok"
    assert health["engine"] == "BatchedGenerator"
    assert health["requests_total"] == 1
    with urllib.request.urlopen(srv.url + "/v1/models", timeout=30) as r:
        info = json.loads(r.read())
    assert info["model"]["vocab_size"] == tc.vocab_size
    assert info["data"][0]["object"] == "model"
    # the server counts a request after writing its reply (as the JAX
    # server does), so the POST's line may lag the reply: poll for it,
    # a few seconds at most
    line = ('serving_http_requests_total{code="200",method="POST",'
            'route="/v1/generate"} 1')
    deadline = time.monotonic() + 5.0
    while True:
        with urllib.request.urlopen(srv.url + "/metrics", timeout=30) as r:
            assert r.headers.get("Content-Type") == \
                "text/plain; version=0.0.4"
            text = r.read().decode()
        if line in text or time.monotonic() > deadline:
            break
        time.sleep(0.01)
    assert ('serving_http_requests_total{code="200",method="POST",'
            'route="/v1/generate"} 1') in text
    assert "serving_engine_batches_total 1" in text


class _LetterTokenizer:
    """Stand-in for a tokenizer: one id per character and back."""

    def encode(self, text, add_special_tokens=False):
        return [ord(ch) % 512 for ch in text]

    def decode(self, ids):
        return "".join(chr(97 + int(t) % 26) for t in ids)


@pytest.mark.parametrize("route,body", [
    ("/v1/completions", {"prompt": "hello", "max_tokens": 3,
                         "temperature": 0.0}),
    ("/v1/chat/completions", {"messages": [{"role": "user",
                                            "content": "hi"}],
                              "max_tokens": 3, "temperature": 0.0})])
def test_openai_routes_with_a_tokenizer(model, route, body):
    _, tp, _, tc = model
    tok = _LetterTokenizer()
    gen = BatchedGenerator(tp, tc, device="cpu")
    with ServingServer(gen, tc, port=0, tokenizer=tok) as srv:
        status, _, raw = _post(srv.url, body, path=route)
    out = json.loads(raw)
    assert status == 200 and out["usage"]["completion_tokens"] == 3
    choice = out["choices"][0]
    text = choice["text"] if route == "/v1/completions" else \
        choice["message"]["content"]
    prompt = tok.encode(body["prompt"]) if "prompt" in body else \
        tok.encode(srv.chat_template.render(body["messages"]))
    want = generate(tp, torch.tensor([prompt]), tc, 3)[0].tolist()
    assert text == tok.decode(want)


@pytest.mark.parametrize("bad", [{}, {"prompt": []}, {"prompt": [1, 512]},
                                 {"prompt": [1], "max_new_tokens": 0}])
def test_http_bad_requests_are_400(server, bad):
    srv, _, _ = server
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(srv.url, bad)
    assert err.value.code == 400


class _HoldAtFirstToken:
    """Wraps an engine's ``submit`` so the engine thread stops after
    handing a request's first token to its stream, until ``release()``."""

    def __init__(self, gen):
        self.held, self.go = threading.Event(), threading.Event()
        submit = gen.submit

        def held_submit(*args, on_token=None, **kw):
            def hook(tok):
                on_token(tok)
                if not self.held.is_set():
                    self.held.set()
                    self.go.wait(timeout=120)
            return submit(*args, on_token=hook if on_token else None, **kw)
        gen.submit = held_submit

    def release(self):
        self.go.set()


def _stream_request(url, payload):
    host, port = url.rsplit("/", 1)[-1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=120)
    conn.request("POST", "/v1/generate",
                 body=json.dumps({**payload, "stream": True}),
                 headers={"Content-Type": "application/json"})
    return conn, conn.getresponse()


def _next_event(resp):
    while True:  # bounded: the socket's timeout ends a silent stream
        line = resp.fp.readline()
        assert line, "stream ended"
        if line.startswith(b"data: "):
            return json.loads(line[len(b"data: "):])


def test_http_stream_sends_each_token_before_the_request_completes(model):
    _, tp, _, tc = model
    gen = ContinuousBatchedGenerator(tp, tc, n_slots=2, device="cpu")
    hold = _HoldAtFirstToken(gen)
    with ServingServer(gen, tc, port=0) as srv:
        conn, resp = _stream_request(srv.url, {"prompt": PROMPTS[1],
                                               "max_new_tokens": 12})
        try:
            assert resp.getheader("Content-Type") == "text/event-stream"
            first = _next_event(resp)
            # the engine is held right after the first token: one step run
            assert "token" in first and gen.steps_total == 1
            hold.release()
            events = [first]
            while "done" not in events[-1]:
                events.append(_next_event(resp))
        finally:
            conn.close()
    want = generate(tp, torch.tensor([PROMPTS[1]]), tc, 12)[0].tolist()
    assert [e["token"] for e in events[:-1]] == want
    assert events[-1]["ids"] == want and events[-1]["n_tokens"] == 12


def test_http_client_disconnect_cancels_the_request(model):
    _, tp, _, tc = model
    gen = ContinuousBatchedGenerator(tp, tc, n_slots=1, device="cpu")
    hold = _HoldAtFirstToken(gen)
    with ServingServer(gen, tc, port=0) as srv:
        conn, resp = _stream_request(srv.url, {"prompt": [7, 8, 9],
                                               "max_new_tokens": 120})
        assert "token" in _next_event(resp)
        resp.close()
        conn.close()                 # the client goes away mid-stream
        hold.release()
        deadline = time.monotonic() + 60
        while gen.cancelled_total == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert gen.cancelled_total == 1
        assert gen.steps_total < 120
        # the one slot serves the next request
        status, _, body = _post(srv.url, {"prompt": PROMPTS[0],
                                          "max_new_tokens": 4})
        assert status == 200
        assert json.loads(body)["ids"] == generate(
            tp, torch.tensor([PROMPTS[0]]), tc, 4)[0].tolist()


# ----------------------------------------------------------- entry point
@pytest.fixture
def config_file(tmp_path):
    path = tmp_path / "model.json"
    path.write_text(json.dumps(TINY))
    return str(path)


def test_main_without_device_cpu_raises_when_cuda_is_absent(config_file):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable")
    with pytest.raises(RuntimeError, match="--device cpu"):
        torch_server.main(["--config", config_file, "--port", "0"])


@pytest.mark.parametrize("flags", [
    ["--lora-config", "l.json"], ["--lora-checkpoint", "/nowhere"]])
def test_unported_flags_exit_naming_the_roadmap(config_file, flags):
    """The LoRA flags are ported; either one alone exits with the JAX
    server's pairing message."""
    with pytest.raises(SystemExit, match="--lora-config and "
                                         "--lora-checkpoint must be "
                                         "provided together"):
        torch_server.main(["--config", config_file, "--device", "cpu",
                           *flags])


def _save_params(directory, params, step=3):
    """A TrainCheckpointer step holding ``params`` and a fresh AdamW
    state (what a Trainer writes)."""
    params, opt = ttr.init_train_state(params, ttr.TrainConfig())
    with TrainCheckpointer(directory) as ckpt:
        ckpt.save(step, params, opt)


def _serve(argv):
    srv = torch_server.build_server(["--device", "cpu", "--port", "0",
                                     *argv])
    return srv.start()


@pytest.mark.parametrize("engine", ["bucketed", "continuous"])
def test_checkpoint_flag_serves_the_saved_params(config_file, model,
                                                 tmp_path, engine):
    """--checkpoint restores the latest step's params over the seed-0
    random ones: the served ids equal an engine's on the params held in
    memory."""
    _, tp, _, tc = model
    _save_params(tmp_path / "ckpt", tp)
    srv = _serve(["--config", config_file, "--checkpoint",
                  str(tmp_path / "ckpt"), "--engine", engine])
    try:
        _, _, body = _post(srv.url, {"prompt": PROMPTS[0],
                                     "max_new_tokens": 6})
    finally:
        srv.stop()
    with BatchedGenerator(tp, tc, device="cpu") as gen:
        want = gen.generate_sync(PROMPTS[0], 6).tolist()
    assert json.loads(body)["ids"] == want


def test_checkpoint_flag_exits_on_an_empty_directory(config_file, tmp_path):
    with pytest.raises(SystemExit, match="no checkpoint found in"):
        torch_server.build_server(["--config", config_file, "--device",
                                   "cpu", "--checkpoint", str(tmp_path)])


@pytest.mark.parametrize("engine,counter", [("bucketed", "spec_batches"),
                                            ("continuous", "spec_ticks")])
def test_draft_config_flag_serves_speculatively(config_file, model, draft,
                                                tmp_path, engine, counter):
    """--draft-config/--draft-checkpoint/--spec-k beside --checkpoint: the
    engine speculates with the restored draft, its greedy ids are the
    restored target's, and /healthz reports the acceptance counters."""
    _, tp, _, tc = model
    _, tdp, _, _ = draft
    draft_file = tmp_path / "draft.json"
    draft_file.write_text(json.dumps(DRAFT))
    _save_params(tmp_path / "ckpt", tp)
    _save_params(tmp_path / "dckpt", tdp)
    srv = _serve(["--config", config_file, "--engine", engine,
                  "--checkpoint", str(tmp_path / "ckpt"),
                  "--draft-config", str(draft_file), "--draft-checkpoint",
                  str(tmp_path / "dckpt"), "--spec-k", "3"])
    try:
        gen = srv.generator
        assert gen.spec_k == 3 and gen.draft is not None
        for got, want in zip(ttr.tree_leaves(gen.draft[0]),
                             ttr.tree_leaves(tdp)):
            assert torch.equal(got, want)
        _, _, body = _post(srv.url, {"prompt": PROMPTS[1],
                                     "max_new_tokens": 6})
        with urllib.request.urlopen(srv.url + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
    finally:
        srv.stop()
    assert json.loads(body)["ids"] == generate(
        tp, torch.tensor([PROMPTS[1]]), tc, 6)[0].tolist()
    assert health[counter] >= 1 and health["spec_drafted"] > 0


def test_draft_checkpoint_requires_draft_config(config_file, tmp_path):
    with pytest.raises(SystemExit, match="requires --draft-config"):
        torch_server.build_server(["--config", config_file, "--device",
                                   "cpu", "--draft-checkpoint",
                                   str(tmp_path)])


class _Args:
    engine = "continuous"
    slots = 2
    quantize = False
    kv_quant = False
    eos_id = -1
    steps_per_sync = 1
    spec_k = 2
    spec_inexact = False
    device = "cpu"


@pytest.mark.parametrize("engine", ["continuous", "bucketed"])
def test_spec_inexact_flag_controls_the_flash_decode_gate(model, engine):
    """decode_attention="flash" puts plain decode on the flash-decode
    path while the verify window is the einsum: without --spec-inexact
    the continuous engine refuses the draft and the bucketed engine keeps
    it but never speculates; with it both speculate (the reference's
    tests/test_serving_server.py gate test)."""
    _, tp, _, tc = model
    fc = tc.replace(decode_attention="flash")
    args = type("Args", (_Args,), {"engine": engine})
    if engine == "continuous":
        with pytest.raises(ValueError, match="spec_exact_only"):
            torch_server.build_generator(tp, fc, args, draft=(tp, fc))
    else:
        with torch_server.build_generator(tp, fc, args,
                                          draft=(tp, fc)) as gen:
            gen.generate_sync(PROMPTS[0], 4)
            assert gen.spec_exact_only and gen.spec_batches == 0
    args.spec_inexact = True
    with torch_server.build_generator(tp, fc, args, draft=(tp, fc)) as gen:
        assert gen.draft is not None
        gen.generate_sync(PROMPTS[0], 4)
        assert gen.spec_drafted == gen.spec_accepted > 0


@pytest.mark.parametrize("flag", [["--kv-quant"], ["--eos-id", "2"],
                                  ["--steps-per-sync", "2"]])
def test_bucketed_engine_refuses_continuous_only_flags(config_file, flag):
    with pytest.raises(SystemExit, match="--engine continuous"):
        torch_server.build_server(["--config", config_file, "--device",
                                   "cpu", "--engine", "bucketed", *flag])


def test_default_engine_is_continuous_and_serves(config_file):
    srv = torch_server.build_server([
        "--config", config_file, "--device", "cpu", "--port", "0",
        "--slots", "2", "--kv-quant", "--eos-id", "3",
        "--steps-per-sync", "2"])
    srv.start()
    try:
        gen = srv.generator
        assert isinstance(gen, ContinuousBatchedGenerator)
        assert (gen.n_slots, gen.kv_quant, gen.eos_id,
                gen.steps_per_sync) == (2, True, 3, 2)
        status, _, body = _post(srv.url, {"prompt": [7, 8, 9],
                                          "max_new_tokens": 3})
        assert status == 200 and len(json.loads(body)["ids"]) == 3
        events = _post(srv.url, {"prompt": [7, 8, 9], "max_new_tokens": 3,
                                 "stream": True})[2].decode().splitlines()
        assert sum(e.startswith("data: ") for e in events) >= 2
    finally:
        srv.stop()


def test_build_server_on_cpu_serves(config_file):
    srv = torch_server.build_server(["--config", config_file, "--device",
                                     "cpu", "--port", "0", "--slots", "2",
                                     "--engine", "bucketed"])
    srv.start()
    try:
        status, _, body = _post(srv.url, {"prompt": [7, 8, 9],
                                          "max_new_tokens": 3})
        assert status == 200 and len(json.loads(body)["ids"]) == 3
        assert srv.generator.max_batch == 2
    finally:
        srv.stop()
