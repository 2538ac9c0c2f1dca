"""HTTP serving endpoint for the generation engines.

The last mile of the serving story: a provisioned notebook that serves
its model needs a wire protocol, not just a Python API. This is a
stdlib-only JSON-over-HTTP server in the shape such endpoints take:

    POST /v1/generate   {"prompt": [ids...] | "text": "...",
                         "max_new_tokens": N,
                         "temperature": t, "top_k": k, "top_p": p}
                      → {"ids": [ids...], "usage": {prompt_tokens,
                         completion_tokens}, "text": "..." (text mode)}
                        with "stream": true → text/event-stream, one
                        data: {"token": id, "text": delta?} event per
                        token as generated, then
                        data: {"done": true, "ids": [...], "text"?}
                        ("text" requires --tokenizer; stream deltas use
                        incremental detokenization)
    POST /v1/completions  OpenAI-compatible completions (requires
                        --tokenizer): {"prompt": str|[ids], "max_tokens",
                        "temperature", "top_p", "stream"} → the standard
                        text_completion object / SSE chunk stream ending
                        in data: [DONE]
    POST /v1/chat/completions  OpenAI-compatible chat (requires
                        --tokenizer): {"messages": [{role, content}...],
                        "max_tokens"|"max_completion_tokens",
                        "temperature", "top_p", "stream"} → the standard
                        chat.completion object; streaming emits
                        chat.completion.chunk deltas (role on the first,
                        finish_reason on the last) ending in data: [DONE].
                        Messages render through a configurable chat
                        template (--chat-template: role-tags | chatml |
                        tokenizer | a JSON file; runtime/chat_template.py)
    GET  /metrics       Prometheus text exposition (engine counters +
                        HTTP request/latency series)
    GET  /healthz       liveness + engine stats (what the culler's
                        activity probe and the auth sidecar front)
    GET  /v1/models     the serving configuration (model shape, engine,
                        quantization), for client capability discovery

Port of ``kubeflow_tpu/runtime/server.py``: the wire protocol, request
validation, streaming and the OpenAI routes are the same code. The
engine behind it is the port's ``ContinuousBatchedGenerator`` by default
(per-token streaming; a client that disconnects or times out cancels its
request at the next token boundary) or, with ``--engine bucketed``,
``BatchedGenerator``, which does not stream (a streamed request gets 400,
as from the JAX server). Requests block on the engine future, so the
HTTP layer is a ThreadingHTTPServer: one thread per in-flight request,
all batching intelligence stays in the engine.

Run standalone (on the card; ``--device cpu`` for a dev box):

    python -m kubeflow_tpu_torch.runtime.server --config model.json \
        --checkpoint ckpt/ --draft-config draft.json \
        --draft-checkpoint draft_ckpt/ --spec-inexact --port 8890

``--checkpoint`` serves the latest params of a ``TrainCheckpointer``
directory (runtime/checkpoint.py). On the card ``--spec-inexact`` is what
lets a draft speculate: plain decode takes the flash-decode kernel there
and the verify window is the einsum path, which may round a greedy
near-tie apart. The LoRA flags are not ported yet: they exit naming the
ROADMAP item that will port them.
"""

from __future__ import annotations

import argparse
import json
import logging
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

log = logging.getLogger("kubeflow_tpu_torch.serving_server")

MAX_BODY_BYTES = 8 << 20  # an 8 MB prompt is a client error, not an OOM


class IncrementalDetokenizer:
    """Streaming detokenization in the standard (HF TextStreamer / vLLM)
    form: decode a trailing id window, withhold output while it ends in
    U+FFFD (a multi-byte character still split across tokens), advance
    the window offsets once the text stabilizes. O(total ids) — the
    window stays small because the prefix offset advances — and correct
    for byte-level BPE, where decode() can REWRITE the tail rather than
    extend it. Genuinely invalid byte sequences (a model emitting bytes,
    not text) surface as U+FFFD once a following token forces the window
    to stabilize — held forever would stall the stream."""

    # ids held back while the window tail is U+FFFD: a real split UTF-8
    # character completes within 3 follow-up bytes, so a window still
    # unstable after this many ids is invalid bytes, not a character —
    # force stabilization (bounds the re-decoded window, keeping feed()
    # O(total ids) even for a model emitting pure garbage)
    MAX_HOLD = 8

    def __init__(self, tokenizer):
        self.tokenizer = tokenizer
        self._ids: list[int] = []
        self._prefix = 0
        self._read = 0

    def feed(self, tok: int) -> str:
        """One generated id in → the text delta now safe to emit."""
        self._ids.append(tok)
        window = self.tokenizer.decode(self._ids[self._prefix:])
        forced = False
        if window.endswith("�"):
            if len(self._ids) - self._read < self.MAX_HOLD:
                return ""                 # held back until complete
            forced = True                 # invalid bytes: stabilize
        prev = self.tokenizer.decode(self._ids[self._prefix:self._read])
        if forced:
            # the emitted tail is replacement chars for invalid bytes,
            # not a character prefix — the NEXT window must not re-decode
            # across it (a later completing byte would re-interpret the
            # boundary and the length-diff would drop text)
            self._prefix = self._read = len(self._ids)
        else:
            self._prefix = self._read
            self._read = len(self._ids)
        return window[len(prev):]

    def flush(self) -> str:
        """Text still held back when the stream ends (generation stopped
        mid-character): emit it so concatenated deltas equal the full
        decode, replacement chars and all."""
        if self._read == len(self._ids):
            return ""
        window = self.tokenizer.decode(self._ids[self._prefix:])
        prev = self.tokenizer.decode(self._ids[self._prefix:self._read])
        self._prefix = self._read = len(self._ids)
        return window[len(prev):]


class ServingServer:
    """HTTP front for a generation engine. ``generator`` is either
    engine class (both expose submit/generate_sync/close)."""

    ENGINE_COUNTERS = (
        "requests_total", "batches_total", "admitted_total",
        "admitted_while_running", "steps_total", "prefill_chunks_total",
        "prefix_cache_hits_total", "cancelled_total", "spec_batches",
        "spec_ticks", "spec_accepted", "spec_drafted")

    def __init__(self, generator, config, *, host: str = "127.0.0.1",
                 port: int = 8890, request_timeout_s: float = 300.0,
                 tokenizer=None, model_name: str | None = None,
                 chat_template=None):
        from ..utils.metrics import MetricsRegistry
        from .chat_template import BUILTIN
        self.generator = generator
        self.config = config
        self.request_timeout_s = request_timeout_s
        # duck-typed: anything with encode(text, add_special_tokens=False)
        # -> ids and decode(ids) -> text (a transformers tokenizer works).
        # With one configured, requests may pass "text" instead of
        # "prompt" ids and responses/stream events carry decoded text.
        self.tokenizer = tokenizer
        self.model_name = model_name or self.MODEL_NAME
        # messages → prompt rendering for /v1/chat/completions; anything
        # with render(messages, add_generation_prompt=) works
        # (runtime/chat_template.py load_template resolves CLI specs)
        self.chat_template = chat_template or BUILTIN["role-tags"]
        self._started_at = int(time.time())
        # Prometheus exposition (GET /metrics): engine counters mirrored at
        # scrape time, plus the HTTP layer's own request/latency series —
        # the serving analog of the controller's metrics endpoint
        self.metrics = MetricsRegistry(include_notebook_metrics=False)
        self._m_http = self.metrics.counter(
            "serving_http_requests_total",
            "HTTP requests by route and status code")
        self._m_lat_sum = self.metrics.counter(
            "serving_generate_seconds_sum",
            "Cumulative wall seconds spent in /v1/generate requests")
        self._m_lat_count = self.metrics.counter(
            "serving_generate_seconds_count",
            "Completed /v1/generate requests")
        engine_metrics = {
            name: self.metrics.gauge(
                f"serving_engine_{name}",
                f"Engine counter {name} (mirrored at scrape)")
            for name in self.ENGINE_COUNTERS if hasattr(generator, name)}

        def mirror_engine() -> None:
            for name, metric in engine_metrics.items():
                metric.set(float(getattr(self.generator, name)))
        self.metrics.on_scrape(mirror_engine)
        server = self

        KNOWN_ROUTES = frozenset(
            {"/healthz", "/v1/models", "/metrics", "/v1/generate",
             "/v1/completions", "/v1/chat/completions"})

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                log.debug("http: " + fmt, *args)

            def _count(self, code: int) -> None:
                # unknown paths collapse to one label bucket: the route
                # label must not be attacker-controlled cardinality (a
                # crawler probing thousands of paths would otherwise leak
                # one permanent series per path)
                route = self.path.split("?")[0]
                if route not in KNOWN_ROUTES:
                    route = "other"
                server._m_http.inc({"route": route, "method": self.command,
                                    "code": str(code)})

            def _json(self, code: int, payload: dict) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                self._count(code)

            def do_GET(self):
                if self.path == "/healthz":
                    self._json(200, server.health())
                elif self.path == "/v1/models":
                    self._json(200, server.model_info())
                elif self.path == "/metrics":
                    body = server.metrics.expose().encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    self._count(200)
                else:
                    self._json(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                if self.path not in ("/v1/generate", "/v1/completions",
                                     "/v1/chat/completions"):
                    self._json(404, {"error": f"no route {self.path}"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    if length < 0 or length > MAX_BODY_BYTES:
                        # a negative (lying) Content-Length must not reach
                        # rfile.read(-1) — that reads until EOF, unbounded
                        self._json(413, {"error": "invalid request size"})
                        return
                    req = json.loads(self.rfile.read(length))
                    if not isinstance(req, dict):
                        # valid JSON of the wrong shape ([1,2], "x") is a
                        # client error, not an AttributeError 500
                        raise ValueError(
                            "request body must be a JSON object")
                    # oai_mode: None (internal shape) | "completions" |
                    # "chat" — picks the translator, response object, and
                    # stream chunk framing
                    oai_mode = {"/v1/completions": "completions",
                                "/v1/chat/completions": "chat"}.get(
                                    self.path)
                    if oai_mode == "completions":
                        req = server.translate_completions(req)
                    elif oai_mode == "chat":
                        req = server.translate_chat(req)
                    stream = req.get("stream", False)
                    if not isinstance(stream, bool):
                        # '"stream": "false"' is a client bug; guessing a
                        # truthiness here silently switches content types
                        raise ValueError("'stream' must be a boolean")
                    if stream:
                        t0 = time.monotonic()
                        server.stream_generate(req, self,
                                               oai_mode=oai_mode)
                        server._m_lat_sum.inc(by=time.monotonic() - t0)
                        server._m_lat_count.inc()
                        self._count(200)
                        return
                    t0 = time.monotonic()
                    out = server.generate(req)
                    server._m_lat_sum.inc(by=time.monotonic() - t0)
                    server._m_lat_count.inc()
                    if oai_mode == "completions":
                        out = server.to_completions_response(out)
                    elif oai_mode == "chat":
                        out = server.to_chat_response(out)
                    self._json(200, out)
                except (ValueError, KeyError, TypeError) as e:
                    self._json(400, {"error": str(e)})
                except TimeoutError:
                    self._json(504, {"error": "generation timed out"})
                except RuntimeError as e:  # engine closed mid-request
                    self._json(503, {"error": str(e)})
                except Exception as e:  # noqa: BLE001 — an engine error
                    # must surface as a JSON 500, not a
                    # dropped connection with a server-side traceback
                    log.exception("generate failed")
                    self._json(500, {"error":
                                     f"{type(e).__name__}: {e}"})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._started = False
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True,
                                        name="kubeflow-tpu-torch-http")

    # ------------------------------------------------------------ lifecycle
    @property
    def port(self) -> int:
        return self._httpd.server_port

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "ServingServer":
        self._started = True
        self._thread.start()
        log.info("serving endpoint on %s", self.url)
        return self

    def stop(self) -> None:
        if self._started:
            # shutdown() waits on an event only serve_forever() sets —
            # calling it on a never-started server would block forever
            self._httpd.shutdown()
        self._httpd.server_close()
        self.generator.close()

    def __enter__(self) -> "ServingServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------- handlers
    def _cancel(self, future) -> None:
        """Cooperative cancel for abandoned requests (disconnect/timeout)
        — a no-op on engines without cancellation support."""
        cancel = getattr(self.generator, "cancel", None)
        if cancel is not None:
            cancel(future)

    def _validate(self, req: dict):
        prompt = req.get("prompt")
        text = req.get("text")
        if (prompt is None) == (text is None):
            raise ValueError("provide exactly one of 'prompt' (token ids)"
                             " or 'text'")
        if text is not None:
            if self.tokenizer is None:
                raise ValueError("'text' requires the server to be "
                                 "started with a tokenizer "
                                 "(--tokenizer DIR)")
            if not isinstance(text, str) or not text:
                raise ValueError("'text' must be a non-empty string")
            prompt = list(self.tokenizer.encode(
                text, add_special_tokens=False))
            if not prompt:
                raise ValueError("'text' tokenized to an empty prompt")
            if max(prompt) >= self.config.vocab_size:
                raise ValueError(
                    f"tokenizer produced id {max(prompt)} outside the "
                    f"model vocab ({self.config.vocab_size}) — wrong "
                    f"tokenizer for this model")
        elif not isinstance(prompt, list) or not prompt or \
                not all(isinstance(t, int) for t in prompt):
            raise ValueError("'prompt' must be a non-empty list of "
                             "token ids")
        if not all(0 <= t < self.config.vocab_size for t in prompt):
            # an out-of-range id would trip a device-side assert in the
            # embedding gather, which poisons the CUDA context
            raise ValueError(f"prompt ids must be in [0, "
                             f"{self.config.vocab_size})")
        max_new = req.get("max_new_tokens", 64)
        if not isinstance(max_new, int) or max_new < 1:
            raise ValueError("'max_new_tokens' must be a positive integer")
        return (np.asarray(prompt, np.int32), max_new,
                float(req.get("temperature", 0.0)),
                int(req.get("top_k", 0)), float(req.get("top_p", 1.0)),
                text is not None)

    def _live_ids(self, ids) -> list[int]:
        """The generated ids up to (and excluding) the engine's EOS —
        the pad filler after it AND the EOS token's own surface form do
        not belong in client-facing text."""
        ids = [int(t) for t in ids]
        eos = getattr(self.generator, "eos_id", None)
        if eos is not None and eos in ids:
            ids = ids[:ids.index(eos)]
        return ids

    MODEL_NAME = "kubeflow-tpu"

    def _check_openai_common(self, req: dict, route: str,
                             unsupported: tuple) -> None:
        """The checks both OpenAI routes share: tokenizer present (the
        response format is text), model-name match, and loud failure on
        any knob that would CHANGE semantics if silently ignored
        (0/None/empty are the no-op values)."""
        if self.tokenizer is None:
            raise ValueError(f"{route} requires the server to run with "
                             f"--tokenizer (responses are text)")
        # SDKs always send 'model': a mismatch means the client thinks
        # it is talking to a different deployment — refuse rather than
        # silently serve the wrong weights
        want_model = req.get("model")
        if want_model is not None and want_model != self.model_name:
            raise ValueError(f"model {want_model!r} is not served here "
                             f"(this endpoint serves "
                             f"{self.model_name!r})")
        if req.get("n", 1) != 1 or req.get("best_of", 1) != 1:
            raise ValueError("'n'/'best_of' > 1 not supported")
        for knob in unsupported:
            if req.get(knob):
                raise ValueError(f"'{knob}' is not supported")

    def _openai_sampling(self, req: dict, max_default: int = 16) -> dict:
        return {"max_new_tokens": req.get("max_tokens", max_default),
                # OpenAI defaults temperature to 1.0 (ours is greedy 0.0)
                "temperature": float(req.get("temperature", 1.0)),
                "top_p": float(req.get("top_p", 1.0)),
                "stream": req.get("stream", False)}

    def translate_completions(self, req: dict) -> dict:
        """OpenAI `/v1/completions` body → the internal request shape.
        The legacy-but-ubiquitous surface: a completions client switching
        from any OpenAI-compatible server points its base_url here.
        Unsupported knobs fail loudly rather than silently changing
        semantics."""
        self._check_openai_common(
            req, "/v1/completions",
            ("logprobs", "echo", "stop", "suffix", "logit_bias",
             "frequency_penalty", "presence_penalty", "seed",
             # chat-only knob: a confused client mixing surfaces should
             # hear about it, not get silently truncated output
             "max_completion_tokens"))
        prompt = req.get("prompt")
        out = self._openai_sampling(req)
        if isinstance(prompt, str) and prompt:
            out["text"] = prompt
        elif isinstance(prompt, list):
            out["prompt"] = prompt
        else:
            raise ValueError("'prompt' must be a non-empty string or a "
                             "token id list")
        return out

    def translate_chat(self, req: dict) -> dict:
        """OpenAI `/v1/chat/completions` body → the internal request
        shape: ``messages`` render to ONE prompt string through the
        configured chat template (runtime/chat_template.py) with the
        assistant generation cue appended — the default surface modern
        OpenAI SDK clients call (VERDICT r4 ask #4)."""
        self._check_openai_common(
            req, "/v1/chat/completions",
            ("logprobs", "top_logprobs", "stop", "logit_bias",
             "frequency_penalty", "presence_penalty", "seed", "tools",
             "tool_choice", "functions", "function_call",
             "response_format"))
        out = self._openai_sampling(req)
        out["text"] = self.chat_template.render(req.get("messages"),
                                                add_generation_prompt=True)
        if "max_completion_tokens" in req:
            # the chat surface's newer name wins over legacy max_tokens
            out["max_new_tokens"] = req["max_completion_tokens"]
        elif "max_tokens" not in req:
            # chat clients routinely omit the budget (OpenAI's chat
            # surface generates to the limit by default) — the legacy
            # completions default of 16 would silently truncate, and a
            # fixed large default would 400 on short-context models; do
            # what OpenAI does: generate to the context limit (capped at
            # 256 so an omitted budget can't monopolize engine slots)
            n_prompt = len(self.tokenizer.encode(
                out["text"], add_special_tokens=False))
            out["max_new_tokens"] = max(
                1, min(256, self.config.max_seq_len - n_prompt))
        return out

    def _envelope(self, prefix: str, obj: str) -> dict:
        import uuid
        return {"id": prefix + uuid.uuid4().hex[:24], "object": obj,
                "created": int(time.time()), "model": self.model_name}

    def _completions_envelope(self) -> dict:
        return self._envelope("cmpl-", "text_completion")

    def _finish_and_usage(self, usage: dict, ids: list) -> tuple:
        """(finish_reason, OpenAI usage) — ONE definition for the
        streaming and non-streaming completions responses. "stop" means
        the engine's EOS appeared among the generated ids (including on
        the very last slot, where a budget-based check would mislabel it
        "length")."""
        eos = getattr(self.generator, "eos_id", None)
        finish = "stop" if eos is not None and eos in ids else "length"
        return finish, {**usage,
                        "total_tokens": usage["prompt_tokens"]
                        + usage["completion_tokens"]}

    def to_completions_response(self, out: dict) -> dict:
        """Internal generate() result → OpenAI text_completion shape."""
        finish, usage = self._finish_and_usage(out["usage"], out["ids"])
        text = out.get("text")
        if text is None:
            text = self.tokenizer.decode(self._live_ids(out["ids"]))
        return {**self._completions_envelope(),
                "choices": [{"text": text, "index": 0, "logprobs": None,
                             "finish_reason": finish}],
                "usage": usage}

    def to_chat_response(self, out: dict) -> dict:
        """Internal generate() result → OpenAI chat.completion shape."""
        finish, usage = self._finish_and_usage(out["usage"], out["ids"])
        text = out.get("text")
        if text is None:
            text = self.tokenizer.decode(self._live_ids(out["ids"]))
        return {**self._envelope("chatcmpl-", "chat.completion"),
                "choices": [{"index": 0,
                             "message": {"role": "assistant",
                                         "content": text},
                             "logprobs": None,
                             "finish_reason": finish}],
                "usage": usage}

    def _usage(self, prompt, ids) -> dict:
        """Accounting for the response: completion_tokens counts every
        GENERATED token including a terminating EOS (matching the stream's
        n_tokens), not the pad filler after it."""
        ids = [int(t) for t in ids]
        eos = getattr(self.generator, "eos_id", None)
        n = ids.index(eos) + 1 if eos is not None and eos in ids \
            else len(ids)
        return {"prompt_tokens": int(prompt.shape[0]),
                "completion_tokens": n}

    def generate(self, req: dict) -> dict:
        prompt, max_new, temp, top_k, top_p, was_text = self._validate(req)
        future = self.generator.submit(prompt, max_new, temp, top_k=top_k,
                                       top_p=top_p)
        try:
            ids = future.result(timeout=self.request_timeout_s)
        except TimeoutError:
            # the 504 goes to the client; the engine must not keep the
            # slot decoding for a response nobody will read
            self._cancel(future)
            raise
        out = {"ids": [int(t) for t in ids],
               "usage": self._usage(prompt, ids)}
        if was_text:
            out["text"] = self.tokenizer.decode(self._live_ids(ids))
        return out

    def stream_generate(self, req: dict, handler,
                        oai_mode: str | None = None) -> None:
        """``"stream": true``: per-token SSE emission. The engine already
        works at token boundaries (ContinuousBatchedGenerator admits and
        samples per step); this hands each sampled id straight to the wire
        instead of parking it until completion — time-to-first-token
        becomes prefill + one step, not the full generation.

        Wire format: ``Content-Type: text/event-stream``, one
        ``data: {"token": id}`` event per token actually SAMPLED — when
        the engine stops at an EOS id, the token events end there — then a
        final ``data: {"done": true, "n_tokens": n, "ids": [...],
        "usage": {...}}`` event
        whose ``ids`` is the engine's result exactly as the non-streaming
        response would return it (padded to max_new_tokens after an early
        EOS) and ``n_tokens`` counts the token events that preceded it.
        In text mode, a multi-byte character still split across tokens at
        the end of generation is flushed as ONE extra token-less
        ``data: {"text": ...}`` event between the last token event and the
        done event — clients keying on ``"token"`` must treat a frame
        without it as text-only continuation, not a protocol error.
        The response is delimited by connection close (no
        Content-Length).

        ``oai_mode`` swaps the frame shapes: ``"completions"`` emits
        text_completion SSE chunks, ``"chat"`` emits chat.completion.chunk
        deltas (``role`` on the first content chunk, ``finish_reason`` +
        ``usage`` on the final empty-delta chunk), both ending with the
        literal ``data: [DONE]`` sentinel."""
        prompt, max_new, temp, top_k, top_p, was_text = self._validate(req)
        if not getattr(self.generator, "supports_streaming", False):
            raise ValueError(
                f"engine {type(self.generator).__name__} does not "
                f"support streaming; use the continuous engine")
        q: queue.Queue = queue.Queue()
        future = self.generator.submit(prompt, max_new, temp, top_k=top_k,
                                       top_p=top_p, on_token=q.put)

        # text mode: each token event carries the incremental decoded
        # suffix (IncrementalDetokenizer — held back while a multi-byte
        # character is still split across tokens). The OpenAI routes
        # always stream text (their translators guarantee the
        # tokenizer), even for token-array prompts.
        detok = IncrementalDetokenizer(self.tokenizer) \
            if (was_text or oai_mode) else None
        eos = getattr(self.generator, "eos_id", None)

        def token_payload(tok: int) -> dict:
            payload = {"token": tok}
            if detok is not None:
                # the EOS token itself contributes no text (the done
                # event's text excludes its surface form)
                payload["text"] = "" if (eos is not None and tok == eos) \
                    else detok.feed(tok)
            return payload

        handler.send_response(200)
        handler.send_header("Content-Type", "text/event-stream")
        handler.send_header("Cache-Control", "no-cache")
        handler.send_header("Connection", "close")
        handler.end_headers()

        def event(payload: dict) -> bool:
            try:
                handler.wfile.write(
                    b"data: " + json.dumps(payload).encode() + b"\n\n")
                handler.wfile.flush()
                return True
            except OSError:
                # client went away: cancel cooperatively so the engine
                # frees the slot at the next token boundary instead of
                # finishing a generation nobody will read
                self._cancel(future)
                return False

        if oai_mode == "chat":
            envelope = self._envelope("chatcmpl-", "chat.completion.chunk")
        elif oai_mode == "completions":
            envelope = self._completions_envelope()
        else:
            envelope = None
        first_chunk = [True]  # chat: "role" rides the first delta only

        def _sentinel() -> bool:
            try:
                handler.wfile.write(b"data: [DONE]\n\n")
                handler.wfile.flush()
                return True
            except OSError:
                return False

        def _content_chunk(text: str) -> dict:
            if oai_mode == "chat":
                delta = {"content": text}
                if first_chunk[0]:
                    delta["role"] = "assistant"
                    first_chunk[0] = False
                choice = {"index": 0, "delta": delta,
                          "logprobs": None, "finish_reason": None}
            else:
                choice = {"text": text, "index": 0, "logprobs": None,
                          "finish_reason": None}
            return {**envelope, "choices": [choice]}

        def _final_chunk(finish: str, usage: dict) -> dict:
            if oai_mode == "chat":
                choice = {"index": 0, "delta": {}, "logprobs": None,
                          "finish_reason": finish}
            else:
                choice = {"text": "", "index": 0, "logprobs": None,
                          "finish_reason": finish}
            return {**envelope, "choices": [choice], "usage": usage}

        def send(payload: dict) -> bool:
            """Wire emission: internal event shape, or the OpenAI chunk
            framing (content deltas; finish_reason on the final chunk;
            the literal [DONE] sentinel) on the /v1/*completions routes."""
            if not oai_mode:
                return event(payload)
            if "error" in payload:
                # OpenAI-SDK-parseable error frame, then the sentinel so
                # stream consumers terminate cleanly
                return event({"error": {"message": str(payload["error"]),
                                        "type": "server_error"}}) \
                    and _sentinel()
            if payload.get("done"):
                finish, usage = self._finish_and_usage(payload["usage"],
                                                       payload["ids"])
                return event(_final_chunk(finish, usage)) and _sentinel()
            return event(_content_chunk(payload.get("text", "")))

        t_end = time.monotonic() + self.request_timeout_s
        n_tokens = 0
        while True:  # bounded: t_end deadline raises/returns within request_timeout_s
            try:
                tok = q.get(timeout=min(0.25, max(0.0, t_end -
                                                  time.monotonic())))
                if not send(token_payload(tok)):
                    return
                n_tokens += 1
                continue
            except queue.Empty:
                pass
            if future.done():
                # drain ids emitted between the last get and completion
                while True:  # bounded: drains queue until Empty
                    try:
                        tok = q.get_nowait()
                    except queue.Empty:
                        break
                    if not send(token_payload(tok)):
                        return
                    n_tokens += 1
                break
            if time.monotonic() >= t_end:
                # free the slot: nobody will read the rest of this
                # generation (same cooperative cancel as a disconnect)
                self._cancel(future)
                send({"error": "generation timed out"})
                return
        try:
            ids = [int(t) for t in future.result(timeout=0)]
            if detok is not None:
                held = detok.flush()
                if held and not send({"text": held}):
                    return   # token-less flush event: mid-character tail
            done = {"done": True, "n_tokens": n_tokens, "ids": ids,
                    "usage": self._usage(prompt, ids)}
            if was_text:
                done["text"] = self.tokenizer.decode(self._live_ids(ids))
            send(done)
        except Exception as e:  # noqa: BLE001 — surface as a final event
            send({"error": f"{type(e).__name__}: {e}"})

    def health(self) -> dict:
        gen = self.generator
        out = {"status": "ok", "engine": type(gen).__name__}
        for attr in self.ENGINE_COUNTERS:
            if hasattr(gen, attr):
                out[attr] = getattr(gen, attr)
        return out

    def model_info(self) -> dict:
        c = self.config
        return {
            # OpenAI list-shape alongside the native fields, so SDK
            # clients pointed at this base_url can enumerate models
            "object": "list",
            "data": [{"id": self.model_name, "object": "model",
                      "created": self._started_at,
                      "owned_by": self.model_name}],
            "engine": type(self.generator).__name__,
            "tokenizer": self.tokenizer is not None,
            "model": {
                "d_model": c.d_model, "n_layers": c.n_layers,
                "n_heads": c.n_heads, "n_kv_heads": c.n_kv_heads,
                "vocab_size": c.vocab_size, "max_seq_len": c.max_seq_len,
            },
        }


# -------------------------------------------------------------- entrypoint
def build_generator(params, config, args, draft=None):
    """The engine ``args`` asks for; ``draft`` is (params, config) of a
    speculative draft model or None."""
    from .serving import BatchedGenerator, ContinuousBatchedGenerator
    kw = {}
    if draft is not None:
        kw = dict(draft_params=draft[0], draft_config=draft[1],
                  spec_k=args.spec_k, spec_exact_only=not args.spec_inexact)
    if args.engine == "bucketed":
        if args.kv_quant or args.eos_id >= 0 or args.steps_per_sync > 1:
            # refuse rather than silently ignore: the operator asked for
            # behavior this engine does not implement
            raise SystemExit("--kv-quant/--eos-id/--steps-per-sync "
                             "require --engine continuous")
        return BatchedGenerator(params, config, max_batch=args.slots,
                                quantize=args.quantize, device=args.device,
                                **kw)
    return ContinuousBatchedGenerator(
        params, config, n_slots=args.slots, quantize=args.quantize,
        kv_quant=args.kv_quant, steps_per_sync=args.steps_per_sync,
        eos_id=args.eos_id if args.eos_id >= 0 else None,
        device=args.device, **kw)


def _load_params(config, seed: int, device, directory: str | None):
    """``config``'s params drawn from ``seed`` on ``device`` and, with a
    checkpoint ``directory``, overwritten by its latest params; SystemExit
    when it holds none."""
    from ..models.transformer import init_params
    from .checkpoint import TrainCheckpointer
    params = init_params(torch.Generator(device=device).manual_seed(seed),
                         config, device=device)
    if directory is None:
        return params
    with TrainCheckpointer(directory) as ckpt:
        restored = ckpt.restore_params(params)
    if restored is None:
        raise SystemExit(f"no checkpoint found in {directory}")
    step, params = restored
    log.info("restored params from step %d of %s", step, directory)
    return params


def _merge_adapters(params, config, device, config_path: str,
                    directory: str):
    """Serve a finetune: restore the adapters of a lora-mode Trainer's
    checkpoint in ``directory`` and merge them into ``params`` once;
    downstream is a plain model. SystemExit when it holds none."""
    from ..models.lora import LoRAConfig, init_lora_params, merge_lora
    from .checkpoint import TrainCheckpointer
    with open(config_path) as fh:
        lora = LoRAConfig(**json.load(fh))
    like = init_lora_params(torch.Generator(device=device), config, lora,
                            device=device)
    with TrainCheckpointer(directory) as ckpt:
        restored = ckpt.restore_params(like)
    if restored is None:
        raise SystemExit(f"no adapter checkpoint found in {directory}")
    step, adapters = restored
    log.info("merged LoRA adapters from step %d (rank %d, %s)", step,
             lora.rank, ",".join(lora.targets))
    with torch.no_grad():
        return merge_lora(params, adapters, lora)


def build_server(argv=None) -> ServingServer:
    """Parse the command line and return the (not yet started) server."""
    from .. import resolve_device
    from ..models.transformer import TransformerConfig

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True,
                    help="JSON file of TransformerConfig fields")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; 'cpu' "
                         "for a dev box — never chosen silently)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8890)
    ap.add_argument("--engine", choices=("continuous", "bucketed"),
                    default="continuous")
    ap.add_argument("--slots", type=int, default=8,
                    help="engine slots / max batch")
    ap.add_argument("--quantize", action="store_true",
                    help="int8 weight-only serving")
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8 KV cache (continuous engine)")
    ap.add_argument("--steps-per-sync", type=int, default=1,
                    help="decode steps per host round-trip (continuous "
                         "engine): >1 amortizes scheduler latency at the "
                         "cost of token-burst streaming; admissions "
                         "always drop back to single-step")
    ap.add_argument("--eos-id", type=int, default=-1)
    ap.add_argument("--model-name", default=None,
                    help="model id reported on /v1/models and in "
                         "completions responses (default: kubeflow-tpu)")
    ap.add_argument("--tokenizer", default=None,
                    help="local tokenizer directory (transformers "
                         "AutoTokenizer, local_files_only): enables "
                         "'text' requests and decoded responses")
    ap.add_argument("--chat-template", default=None,
                    help="messages->prompt template for /v1/chat/"
                         "completions: a builtin name (role-tags "
                         "[default], chatml), 'tokenizer', or a path to a "
                         "JSON file with 'turn' + 'generation_prompt'")
    ap.add_argument("--checkpoint", default=None,
                    help="TrainCheckpointer directory (runtime/"
                         "checkpoint.py layout; the latest step's params "
                         "are restored); absent: randomly initialized "
                         "params (dev only)")
    ap.add_argument("--draft-config", default=None,
                    help="JSON TransformerConfig of a speculative draft "
                         "model: un-warped requests run draft-propose/"
                         "verify-once with identical outputs")
    ap.add_argument("--draft-checkpoint", default=None,
                    help="TrainCheckpointer directory of the draft's "
                         "params; absent with --draft-config: a random "
                         "draft (dev only)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="draft tokens proposed per speculative block")
    ap.add_argument("--spec-inexact", action="store_true",
                    help="allow speculation where plain decode would use "
                         "the flash kernel (on the card, always): the "
                         "einsum verify window can differ in last-bit "
                         "rounding, so a greedy near-tie may flip "
                         "(sampled requests' distribution is unaffected)")
    ap.add_argument("--lora-config", default=None,
                    help="JSON of LoRAConfig fields (rank/alpha/targets):"
                         " merge a finetuned adapter into the base "
                         "weights at startup")
    ap.add_argument("--lora-checkpoint", default=None,
                    help="TrainCheckpointer dir holding the adapters "
                         "(Trainer lora-mode checkpoints); required with "
                         "--lora-config")
    args = ap.parse_args(argv)

    if (args.lora_config is None) != (args.lora_checkpoint is None):
        raise SystemExit("--lora-config and --lora-checkpoint must be "
                         "provided together")
    if args.draft_checkpoint and not args.draft_config:
        raise SystemExit("--draft-checkpoint requires --draft-config")
    device = resolve_device(args.device)
    with open(args.config) as fh:
        config = TransformerConfig(**json.load(fh))
    if not args.checkpoint:
        log.warning("no --checkpoint: serving randomly initialized params")
    params = _load_params(config, 0, device, args.checkpoint)
    if args.lora_config:
        params = _merge_adapters(params, config, device, args.lora_config,
                                 args.lora_checkpoint)

    draft = None
    if args.draft_config:
        with open(args.draft_config) as fh:
            draft_config = TransformerConfig(**json.load(fh))
        if not args.draft_checkpoint:
            log.warning("no --draft-checkpoint: random draft (dev only)")
        draft = (_load_params(draft_config, 1, device,
                              args.draft_checkpoint), draft_config)

    tokenizer = None
    if args.tokenizer:
        from transformers import AutoTokenizer
        tokenizer = AutoTokenizer.from_pretrained(args.tokenizer,
                                                  local_files_only=True)

    from .chat_template import load_template
    try:
        chat_template = load_template(args.chat_template, tokenizer)
    except ValueError as e:
        raise SystemExit(f"--chat-template: {e}")

    return ServingServer(build_generator(params, config, args, draft),
                         config, host=args.host, port=args.port,
                         tokenizer=tokenizer, model_name=args.model_name,
                         chat_template=chat_template)


def main(argv=None) -> int:
    server = build_server(argv).start()
    log.info("ready on %s", server.url)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        server.stop()
    return 0


if __name__ == "__main__":
    import sys
    logging.basicConfig(level=logging.INFO)
    sys.exit(main())
