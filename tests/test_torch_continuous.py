"""The port's continuous-batching engine and window decode
(kubeflow_tpu_torch/runtime/serving.py ``ContinuousBatchedGenerator``,
models/decode.py ``decode_window``) against the JAX package on the CPU.

Config: the tiny flagship in float32 with ``decode_attention="flash"``, so
the JAX side runs its Pallas kernel in interpret mode and the port the
kernel's plain version; JAX params carried across with convert.py. Greedy
ids must be token-identical to the JAX ``ContinuousBatchedGenerator`` (one
JAX engine per output-changing setting, shared by the whole module) and to
JAX ``generate``; decode_window logits to 3e-5 (the decode pin), int8
cache values within 1 and their scales to 1e-5 relative. Sampled ids come
from another RNG than JAX's, so they are checked by range and by the
per-row knobs only. Where a test needs the engine at a given point
(mid-generation, mid-admission), a gate holds the engine thread there
instead of racing it. Every wait has a timeout and every engine is closed.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import CancelledError, Future

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import decode as jd
from kubeflow_tpu.models import transformer as jt
from kubeflow_tpu.runtime.serving import \
    ContinuousBatchedGenerator as JaxEngine
from kubeflow_tpu_torch import convert
from kubeflow_tpu_torch.models import decode as td
from kubeflow_tpu_torch.models import transformer as tt
from kubeflow_tpu_torch.runtime.serving import ContinuousBatchedGenerator

LOGITS_TOL = 3e-5
WAIT = 60
TINY = dict(vocab_size=512, d_model=64, n_layers=4, n_heads=4, n_kv_heads=2,
            d_ff=128, max_seq_len=128, dtype="float32",
            decode_attention="flash")
S = TINY["max_seq_len"]


@pytest.fixture(scope="module")
def model():
    jc = jt.TransformerConfig(**TINY)
    jp = jax.jit(jt.init_params, static_argnums=1)(jax.random.key(0), jc)
    tp = convert.to_torch(jax.tree.map(np.asarray, jp))
    return jp, tp, jc, tt.TransformerConfig(**dataclasses.asdict(jc))


@pytest.fixture(scope="module")
def jax_ids(model):
    """ids(prompt, n, **engine_kw): the JAX engine's greedy ids, one engine
    per setting (its compiled steps shared across the module)."""
    jp, _, jc, _ = model
    engines, memo = {}, {}

    def ids(prompt, n, **kw):
        setting = tuple(sorted(kw.items()))
        key = (np.asarray(prompt, np.int32).tobytes(), n, setting)
        if key not in memo:
            if setting not in engines:
                engines[setting] = JaxEngine(jp, jc, n_slots=2, **kw)
            memo[key] = [int(t) for t in engines[setting].generate_sync(
                prompt, n, timeout=WAIT)]
        return memo[key]
    yield ids
    for engine in engines.values():
        engine.close()


def _prompts(n, length, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, TINY["vocab_size"], (length,)).astype(np.int32)
            for _ in range(n)]


def _engine(model, **kw):
    _, tp, _, tc = model
    return ContinuousBatchedGenerator(tp, tc, device="cpu", **kw)


def _ids(future):
    return [int(t) for t in future.result(timeout=WAIT)]


class _Gate:
    """An ``on_token`` that records ids and, at token ``at``, holds the
    engine thread until ``release()`` (a test's fixed point in the
    generation)."""

    def __init__(self, at: int):
        self.at, self.seen = at, []
        self.reached, self.go = threading.Event(), threading.Event()

    def __call__(self, tok):
        self.seen.append(int(tok))
        if len(self.seen) == self.at:
            self.reached.set()
            self.go.wait(timeout=WAIT)

    def hold(self):
        assert self.reached.wait(timeout=WAIT), "engine never got there"

    def release(self):
        self.go.set()


# ------------------------------------------------------------ decode_window
def _random_cache(kv_quant: bool, batch: int, seed: int):
    rng = np.random.default_rng(seed)
    shape = (TINY["n_layers"], batch, S, TINY["n_kv_heads"], 16)
    if not kv_quant:
        return {"k": rng.standard_normal(shape, dtype=np.float32),
                "v": rng.standard_normal(shape, dtype=np.float32)}
    return {"k": rng.integers(-127, 128, shape).astype(np.int8),
            "v": rng.integers(-127, 128, shape).astype(np.int8),
            "k_scale": rng.uniform(0.001, 0.02, shape[:-1]).astype(np.float32),
            "v_scale": rng.uniform(0.001, 0.02, shape[:-1]).astype(np.float32)}


def _assert_caches_match(got: dict, want: dict) -> None:
    """f32 K/V written by the same arithmetic agree to the logits pin,
    int8 values within one rounding step, scales to 1e-5 relative (the
    cells not written hold the same input on both sides)."""
    assert set(got) == set(want)
    for name in want:
        g = got[name].numpy()
        w = np.asarray(want[name])
        if g.dtype == np.int8:
            assert np.abs(g.astype(np.int32) - w.astype(np.int32)).max() <= 1
        elif name.endswith("scale"):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=0)
        else:
            np.testing.assert_allclose(g, w, rtol=LOGITS_TOL,
                                       atol=LOGITS_TOL)


@pytest.mark.parametrize("kv_quant,pos", [
    (False, [12, 7]),               # per-row depths
    (False, [S - 3, 5]),            # row 0's window overhangs the cache
    (False, 4),                     # one depth for every row
    (True, [12, 7]),
    (True, [S - 3, S])])            # row 1 wholly past the end
def test_decode_window_matches_jax(model, kv_quant, pos):
    jp, tp, jc, tc = model
    cache = _random_cache(kv_quant, 2, seed=3)
    tokens = np.random.default_rng(4).integers(0, 512, (2, 6)).astype(
        np.int32)
    jpos = jnp.asarray(pos, jnp.int32)
    jl, jcache = jax.jit(jd.decode_window, static_argnums=4)(
        jp, {k: jnp.asarray(v) for k, v in cache.items()},
        jnp.asarray(tokens), jpos, jc)
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    tpos = torch.tensor(pos, dtype=torch.int32) if isinstance(pos, list) \
        else pos
    tl, tcache = td.decode_window(tp, tcache, torch.from_numpy(tokens),
                                  tpos, tc)
    assert tl.dtype == torch.float32 and tl.shape == (2, 6, 512)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOGITS_TOL,
                               atol=LOGITS_TOL)
    _assert_caches_match(tcache, jcache)


def test_decode_window_of_one_token_is_decode_step(model):
    _, tp, _, tc = model
    cache = _random_cache(False, 2, seed=5)
    token = torch.tensor([[3], [300]])
    pos = torch.tensor([9, 40], dtype=torch.int32)
    a = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    b = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    wl, a = td.decode_window(tp, a, token, pos, tc)
    sl, b = td.decode_step(tp, b, token[:, 0], pos, tc)
    np.testing.assert_allclose(wl[:, 0].numpy(), sl.numpy(),
                               rtol=LOGITS_TOL, atol=LOGITS_TOL)
    for name in a:
        np.testing.assert_allclose(a[name].numpy(), b[name].numpy(),
                                   rtol=LOGITS_TOL, atol=LOGITS_TOL)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_row_write_past_the_end_is_dropped_as_in_jax(kv_quant):
    """The write that raised IndexError before: row 0 at pos ==
    max_seq_len. Pure data movement, so bit-equal to JAX's scatter, which
    drops it."""
    cache = _random_cache(kv_quant, 2, seed=6)
    rng = np.random.default_rng(7)
    k = rng.standard_normal((2, 1, 2, 16), dtype=np.float32)
    v = rng.standard_normal((2, 1, 2, 16), dtype=np.float32)
    pos = np.asarray([S, 2], np.int32)
    want = jd._write_cache_rows({n: jnp.asarray(x) for n, x in cache.items()},
                                jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(pos), layer=1)
    got = td._write_cache_window_rows(
        {n: torch.from_numpy(x.copy()) for n, x in cache.items()},
        torch.from_numpy(k), torch.from_numpy(v),
        td._row_index(torch.from_numpy(pos), 1, S), layer=1)
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))


def test_decode_step_with_a_row_past_the_end(model):
    """A finished row frozen at pos == max_seq_len steps on with the rest:
    nothing raises, and the other row's logits and cache are JAX's."""
    jp, tp, jc, tc = model
    cache = _random_cache(False, 2, seed=8)
    tok = np.asarray([5, 77], np.int32)
    pos = np.asarray([S, 30], np.int32)
    jl, jcache = jax.jit(jd.decode_step, static_argnums=4)(
        jp, {k: jnp.asarray(v) for k, v in cache.items()},
        jnp.asarray(tok), jnp.asarray(pos), jc)
    tl, tcache = td.decode_step(
        tp, {k: torch.from_numpy(v.copy()) for k, v in cache.items()},
        torch.from_numpy(tok), torch.from_numpy(pos), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOGITS_TOL,
                               atol=LOGITS_TOL)
    _assert_caches_match(tcache, jcache)
    np.testing.assert_array_equal(tcache["k"][:, 0].numpy(),
                                  cache["k"][:, 0])   # row 0 untouched


# ----------------------------------------------------------------- engine
def test_engine_matches_jax_generate_and_jax_engine(model, jax_ids):
    """Interleaved depths through fewer slots than requests: every row
    equals JAX generate on its prompt alone and the JAX engine."""
    jp, _, jc, _ = model
    ps = _prompts(5, 6, seed=7)
    lens = [12, 5, 9, 3, 7]
    with _engine(model, n_slots=3) as gen:
        got = [_ids(f) for f in [gen.submit(p, n) for p, n in zip(ps, lens)]]
        assert gen.admitted_while_running >= 2
    want = np.asarray(jd.generate(jp, jnp.asarray(np.stack(ps)), jc, 12))
    for p, n, ids, row in zip(ps, lens, got, want):
        assert ids == row[:n].tolist()
        assert ids == jax_ids(p, n)


def test_late_request_joins_the_running_batch(model, jax_ids):
    p_long, p_late = _prompts(2, 5, seed=3)
    gate = _Gate(at=3)
    with _engine(model, n_slots=4) as gen:
        f_long = gen.submit(p_long, 36, on_token=gate)
        gate.hold()                      # f_long is mid-generation
        f_late = gen.submit(p_late, 6)
        gate.release()
        late, long_ = _ids(f_late), _ids(f_long)
        assert gen.admitted_while_running >= 1
    assert late == jax_ids(p_late, 6)
    assert long_ == jax_ids(p_long, 36)


def test_eos_pads_the_tail_and_frees_the_slot(model, jax_ids):
    p, p2 = _prompts(2, 6, seed=11)
    eos = jax_ids(p, 8)[2]               # stop at the 3rd generated token
    with _engine(model, n_slots=2, eos_id=eos, pad_id=0) as gen:
        got = gen.generate_sync(p, 8, timeout=WAIT)
        got2 = gen.generate_sync(p2, 4, timeout=WAIT)
    want = jax_ids(p, 8, eos_id=eos)
    live = want.index(eos) + 1
    assert got.tolist() == want and live <= 3
    assert want[live:] == [0] * (8 - live)
    assert got2.tolist() == jax_ids(p2, 4, eos_id=eos)


def test_kv_quant_engine_matches_jax(model, jax_ids):
    ps = _prompts(2, 7, seed=21)
    with _engine(model, n_slots=2, kv_quant=True) as gen:
        got = [_ids(f) for f in [gen.submit(p, 8) for p in ps]]
    for p, ids in zip(ps, got):
        assert ids == jax_ids(p, 8, kv_quant=True)


@pytest.mark.parametrize("steps_per_sync", [4, 8])
def test_steps_per_sync_mixed_budgets_and_eos_mid_scan(model, jax_ids,
                                                       steps_per_sync):
    """Rows that fill their budget or hit EOS inside a multi-step sync
    freeze on the device: results and streams equal single-step's."""
    ps = _prompts(3, 6, seed=22)
    eos = jax_ids(ps[2], 8)[2]
    streams = [[], [], []]
    with _engine(model, n_slots=3, steps_per_sync=steps_per_sync,
                 eos_id=eos) as gen:
        futures = [gen.submit(p, n, on_token=s.append)
                   for p, n, s in zip(ps, (2, 13, 8), streams)]
        got = [_ids(f) for f in futures]
    for p, n, ids, stream in zip(ps, (2, 13, 8), got, streams):
        want = jax_ids(p, n, eos_id=eos)
        assert ids == want
        live = want.index(eos) + 1 if eos in want else n
        assert stream == want[:live]     # no pad filler reaches a stream


def test_stream_delivers_every_id_before_the_future_resolves(model):
    seen = []
    holder = {}
    with _engine(model, n_slots=2, steps_per_sync=4) as gen:
        holder["f"] = fut = gen.submit(
            [3, 1, 4], 10, on_token=lambda t: seen.append(
                (t, "f" in holder and holder["f"].done())))
        ids = _ids(fut)
    assert [t for t, _ in seen] == ids
    assert not any(done for _, done in seen)


def test_raising_callback_loses_its_stream_not_the_engine(model, jax_ids):
    def bomb(tok):
        raise RuntimeError("consumer bug")
    with _engine(model, n_slots=2) as gen:
        ids = gen.submit([3, 1, 4], 8, on_token=bomb).result(timeout=WAIT)
        assert len(ids) == 8
        assert gen.generate_sync([5, 6], 4, timeout=WAIT).tolist() == \
            jax_ids([5, 6], 4)


def test_multi_chunk_prompts_interleave_with_decode(model, jax_ids):
    """prefill_chunk=4: a 19-token prompt takes 5 chunks, consumed while
    the running request keeps decoding; both equal the JAX engine at the
    same chunk size."""
    p_run = np.arange(4, dtype=np.int32)
    p_long = np.arange(19, dtype=np.int32) * 7 % 512
    seen = []
    with _engine(model, n_slots=2, prefill_chunk=4) as gen:
        gate = _Gate(at=2)

        def on_token(tok):
            seen.append(gen.prefill_chunks_total)
            gate(tok)
        f_run = gen.submit(p_run, 20, on_token=on_token)
        gate.hold()
        f_long = gen.submit(p_long, 6)
        gate.release()
        assert _ids(f_long) == jax_ids(p_long, 6, prefill_chunk=4)
        assert _ids(f_run) == jax_ids(p_run, 20, prefill_chunk=4)
        assert gen.prefill_chunks_total == 1 + 5
    # tokens of the running request arrived between the long prompt's
    # chunks (counts strictly inside 1 + 1 .. 1 + 5)
    assert [c for c in seen if 1 < c < 6], seen


def test_prefix_cache_counters_equal_the_jax_engine(model):
    """The same sequential submissions through both engines: a prompt,
    one sharing its two leading chunks, one diverging in the second
    chunk, the first again. Chunk and hit counters agree after each, and
    so do the ids."""
    jp, _, jc, _ = model
    shared = np.arange(16, dtype=np.int32) * 5 % 512    # 2 chunks at C=8
    a = np.concatenate([shared, np.asarray([1, 2, 3], np.int32)])
    b = np.concatenate([shared, np.asarray([7, 8, 9, 10], np.int32)])
    c = a.copy()
    c[10] += 1                                          # inside chunk 2
    with _engine(model, n_slots=2, prefill_chunk=8) as gen, \
            JaxEngine(jp, jc, n_slots=2, prefill_chunk=8) as jgen:
        for p in (a, b, c, a):
            got = gen.generate_sync(p, 5, timeout=WAIT)
            want = jgen.generate_sync(p, 5, timeout=WAIT)
            assert got.tolist() == np.asarray(want).tolist()
            assert (gen.prefill_chunks_total,
                    gen.prefix_cache_hits_total) == \
                (jgen.prefill_chunks_total, jgen.prefix_cache_hits_total)
        assert (gen.prefill_chunks_total, gen.prefix_cache_hits_total) == \
            (3 + 1 + 2 + 1, 0 + 2 + 1 + 2)


def test_prefix_cache_lru_bound_and_disabling(model):
    with _engine(model, n_slots=2, prefill_chunk=4,
                 prefix_cache_chunks=2) as gen:
        for seed in range(4):     # 4 distinct 3-chunk prompts: 8 cacheable
            gen.generate_sync(_prompts(1, 12, seed)[0], 2, timeout=WAIT)
        assert len(gen._prefix_cache) == 2
        # an entry is a copy of its chunk's rows, not a view of the row
        # cache it came from
        rows = next(iter(gen._prefix_cache.values()))["k"]
        assert rows.shape[2] == 4 and rows._base is None
    with _engine(model, n_slots=2, prefill_chunk=4,
                 prefix_cache_chunks=0) as gen:
        p = np.arange(12, dtype=np.int32)
        gen.generate_sync(p, 2, timeout=WAIT)
        gen.generate_sync(p, 2, timeout=WAIT)
        assert gen.prefix_cache_hits_total == 0
        assert len(gen._prefix_cache) == 0


def test_failed_prefix_store_does_not_fail_the_request(model, jax_ids):
    p = np.arange(12, dtype=np.int32)

    def full(*_):
        raise torch.cuda.OutOfMemoryError("no room for the entry")
    with _engine(model, n_slots=2, prefill_chunk=4) as gen:
        gen._store_prefix = full
        assert gen.generate_sync(p, 3, timeout=WAIT).tolist() == \
            jax_ids(p, 3, prefill_chunk=4)
        assert len(gen._prefix_cache) == 0


def test_cancel_mid_generation_frees_the_slot(model, jax_ids):
    p = np.arange(4, dtype=np.int32)
    gate = _Gate(at=2)
    with _engine(model, n_slots=1, prefill_chunk=8) as gen:
        f_long = gen.submit(p, 24, on_token=gate)
        gate.hold()
        assert gen.cancel(f_long) is True
        gate.release()
        with pytest.raises(CancelledError):
            f_long.result(timeout=WAIT)
        assert len(gate.seen) < 24
        assert gen.cancelled_total == 1
        # the single slot serves again, and a resolved future refuses
        assert gen.generate_sync(p, 4, timeout=WAIT).tolist() == \
            jax_ids(p, 4, prefill_chunk=8)
        assert gen.cancel(f_long) is False


def test_cancel_while_queued(model):
    p = np.arange(4, dtype=np.int32)
    gate = _Gate(at=1)
    with _engine(model, n_slots=1) as gen:
        f_busy = gen.submit(p, 20, on_token=gate)
        gate.hold()                      # the one slot is busy
        f_queued = gen.submit(p, 4)
        assert gen.cancel(f_queued) is True
        gate.release()
        with pytest.raises(CancelledError):
            f_queued.result(timeout=WAIT)
        assert len(_ids(f_busy)) == 20
    assert gen.cancelled_total == 1


def test_cancel_mid_admission(model, jax_ids):
    """Cancelled between two chunks of a 6-chunk admission: the admission
    is dropped before its remaining chunks, and the slot serves again."""
    p = np.arange(4, dtype=np.int32)
    p_long = np.arange(24, dtype=np.int32)
    with _engine(model, n_slots=2, prefill_chunk=4) as gen:
        chunk, entered, go = gen._chunk, threading.Event(), \
            threading.Event()

        def gated_chunk(adm, start, draft=False):
            if adm.real_len == 24 and start == 8:
                entered.set()
                go.wait(timeout=WAIT)
            return chunk(adm, start, draft)
        gen._chunk = gated_chunk
        f_b = gen.submit(p_long, 2)
        assert entered.wait(timeout=WAIT)
        assert gen.cancel(f_b) is True
        go.set()
        with pytest.raises(CancelledError):
            f_b.result(timeout=WAIT)
        assert gen.prefill_chunks_total == 3
        assert gen.cancelled_total == 1
        assert gen.generate_sync(p, 3, timeout=WAIT).tolist() == \
            jax_ids(p, 3, prefill_chunk=4)


def test_cancel_refuses_a_foreign_future(model):
    with _engine(model, n_slots=1) as gen:
        assert gen.cancel(Future()) is False


def test_close_drains_accepted_requests_then_refuses_submits(model,
                                                             jax_ids):
    """close() finishes what is running and what was queued before it
    (both were accepted), then unblocks; later submits raise."""
    p = np.arange(5, dtype=np.int32)
    gate = _Gate(at=2)
    gen = _engine(model, n_slots=1, max_new_cap=32)
    f_run = gen.submit(p, 20, on_token=gate)
    gate.hold()
    f_queued = gen.submit(p, 4)
    closer = threading.Thread(target=gen.close)
    closer.start()
    time.sleep(0.05)                     # close() is waiting on the drain
    gate.release()
    closer.join(timeout=WAIT)
    assert not closer.is_alive()
    assert f_run.done() and f_queued.done()
    assert _ids(f_run) == jax_ids(p, 20)
    assert _ids(f_queued) == jax_ids(p, 4)
    with pytest.raises(RuntimeError, match="closed"):
        gen.submit(p, 4)


def test_many_concurrent_submitters(model, jax_ids):
    ps = _prompts(12, 6, seed=41)
    outs = {}
    with _engine(model, n_slots=4, max_new_cap=8) as gen:
        def worker(i):
            outs[i] = gen.generate_sync(ps[i], 6, timeout=WAIT).tolist()
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
        assert not any(t.is_alive() for t in threads)
    assert gen.requests_total == 12
    for i, p in enumerate(ps):
        assert outs[i] == jax_ids(p, 6)


def test_request_filling_max_seq_len_then_more_ticks(model, jax_ids):
    """A 121-token prompt + 7 new fills the cache exactly (its first chunk
    of the default 256 overhangs it); under steps_per_sync=4 the finished
    row steps on at pos == max_seq_len beside a longer request, whose ids
    stay exact, and the slot serves again."""
    p_full = _prompts(1, S - 7, seed=51)[0]
    p_run = _prompts(1, 5, seed=52)[0]
    with _engine(model, n_slots=2, steps_per_sync=4) as gen:
        f_full = gen.submit(p_full, 7)
        f_run = gen.submit(p_run, 30)
        assert _ids(f_full) == jax_ids(p_full, 7)
        assert _ids(f_run) == jax_ids(p_run, 30)
        assert gen.generate_sync(p_full, 7, timeout=WAIT).tolist() == \
            jax_ids(p_full, 7)


def test_sampled_rows_use_their_own_knobs(model, jax_ids):
    """A greedy row is unchanged by sampled neighbours; a top_k=1 row at a
    high temperature is greedy; sampled ids lie in the vocabulary, also
    under multi-step sync."""
    p = _prompts(1, 6, seed=31)[0]
    for steps in (1, 4):
        with _engine(model, n_slots=4, seed=5, steps_per_sync=steps) as gen:
            f_greedy = gen.submit(p, 8)
            f_hot = gen.submit(p, 8, temperature=5.0, top_k=50)
            f_k1 = gen.submit(p, 8, temperature=5.0, top_k=1)
            f_nucleus = gen.submit(p, 8, temperature=0.8, top_p=0.9)
            greedy, hot = _ids(f_greedy), _ids(f_hot)
            k1, nucleus = _ids(f_k1), _ids(f_nucleus)
        assert greedy == k1 == jax_ids(p, 8)
        assert hot != greedy
        assert all(0 <= t < 512 for t in hot + nucleus)


def test_a_failed_tick_fails_in_flight_requests_and_the_engine_serves_on(
        model, jax_ids):
    p = np.arange(6, dtype=np.int32)
    with _engine(model, n_slots=2) as gen:
        tick, failed = gen._tick, []

        def flaky(*args):
            if not failed:
                failed.append(1)
                raise RuntimeError("injected tick failure")
            return tick(*args)
        gen._tick = flaky
        with pytest.raises(RuntimeError, match="injected"):
            gen.submit(p, 5).result(timeout=WAIT)
        assert gen.generate_sync(p, 5, timeout=WAIT).tolist() == \
            jax_ids(p, 5)
        assert not any(gen._state["active"].tolist())


def test_submit_validation_and_the_draft_refusal(model):
    """Submit validation, and the exactness gate: TINY's
    decode_attention="flash" puts plain decode on the flash-decode path
    (its plain version here) while the verify window is the einsum, so a
    draft is refused with the reference's message unless
    spec_exact_only=False, which speculates."""
    _, tp, _, tc = model
    with _engine(model, n_slots=1) as gen:
        with pytest.raises(ValueError, match="non-empty"):
            gen.submit(np.zeros((0,), np.int32), 4)
        with pytest.raises(ValueError, match="max_seq_len"):
            gen.submit(np.arange(S - 2), 4)
    for kw in ({"steps_per_sync": 0}, {"prefill_chunk": 0},
               {"prefix_cache_chunks": -1}):
        with pytest.raises(ValueError, match=next(iter(kw))):
            ContinuousBatchedGenerator(tp, tc, device="cpu", **kw)
    with pytest.raises(ValueError, match="spec_exact_only=False"):
        ContinuousBatchedGenerator(tp, tc, draft_params=tp, draft_config=tc,
                                   device="cpu")
    with _engine(model, n_slots=1, draft_params=tp, draft_config=tc,
                 spec_exact_only=False) as gen:
        ids = _ids(gen.submit(np.arange(5), 6))
        assert gen.spec_ticks >= 1 and gen.spec_drafted > 0
    assert all(0 <= t < TINY["vocab_size"] for t in ids)


def test_engine_defaults_to_the_card(model):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable")
    _, tp, _, tc = model
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ContinuousBatchedGenerator(tp, tc)


# ------------------------------------------------------------- speculative
# the exact regime: decode_attention "auto" is the einsum path on the CPU in
# both packages, for plain decode and the verify window alike
SPEC = dict(TINY, decode_attention="auto")
SPEC_DRAFT = dict(SPEC, d_model=32, n_layers=1, d_ff=64)
SPEC_K = 3


@pytest.fixture(scope="module")
def spec_models():
    """(target, draft, perturbed draft), each (jax params, port params,
    jax config, port config); the target's weights are the module's."""
    jc = jt.TransformerConfig(**SPEC)
    jp = jax.jit(jt.init_params, static_argnums=1)(jax.random.key(0), jc)
    jdc = jt.TransformerConfig(**SPEC_DRAFT)
    jdp = jax.jit(jt.init_params, static_argnums=1)(jax.random.key(7), jdc)
    rng = np.random.default_rng(3)
    jnp_ = jax.tree.map(lambda p: p + jnp.asarray(
        0.02 * rng.standard_normal(p.shape), p.dtype), jp)

    def pair(params, cfg):
        return (params, convert.to_torch(jax.tree.map(np.asarray, params)),
                cfg, tt.TransformerConfig(**dataclasses.asdict(cfg)))
    return pair(jp, jc), pair(jdp, jdc), pair(jnp_, jc)


@pytest.fixture(scope="module")
def jax_spec_ids(spec_models):
    """ids(prompt, n, **engine_kw): the JAX speculative engine's greedy ids
    (the small draft, k=3), one engine per setting."""
    (jp, _, jc, _), (jdp, _, jdc, _), _ = spec_models
    engines, memo = {}, {}

    def ids(prompt, n, **kw):
        setting = tuple(sorted(kw.items()))
        key = (np.asarray(prompt, np.int32).tobytes(), n, setting)
        if key not in memo:
            if setting not in engines:
                engines[setting] = JaxEngine(
                    jp, jc, n_slots=2, draft_params=jdp, draft_config=jdc,
                    spec_k=SPEC_K, **kw)
            memo[key] = [int(t) for t in engines[setting].generate_sync(
                prompt, n, timeout=WAIT)]
        return memo[key]
    yield ids
    for engine in engines.values():
        engine.close()


def _spec_engine(spec_models, draft="small", **kw):
    target, small, perturbed = spec_models
    d = {"small": small, "perturbed": perturbed, "self": target}[draft]
    return ContinuousBatchedGenerator(
        target[1], target[3], draft_params=d[1], draft_config=d[3],
        spec_k=SPEC_K, device="cpu", **kw)


def _spec_generate(spec_models, prompt, n, **kw):
    (jp, _, jc, _), _, _ = spec_models
    return np.asarray(jd.generate(jp, jnp.asarray(prompt)[None], jc, n,
                                  **kw))[0].tolist()


def test_spec_engine_matches_plain_engine_jax_spec_engine_and_generate(
        spec_models, jax_spec_ids):
    """Interleaved depths through fewer slots than requests: every row's
    greedy ids equal the port's plain engine, the JAX speculative engine
    and JAX generate, and each stream equals its ids."""
    (_, tp, _, tc), _, _ = spec_models
    ps = _prompts(4, 6, seed=61)
    lens = [12, 5, 17, 9]
    streams = [[] for _ in ps]
    with _spec_engine(spec_models, n_slots=2) as gen:
        got = [_ids(f) for f in [gen.submit(p, n, on_token=st.append)
                                 for p, n, st in zip(ps, lens, streams)]]
        assert gen.spec_ticks >= 1 and gen.admitted_while_running >= 1
        assert gen.spec_drafted == SPEC_K * (gen.spec_drafted // SPEC_K)
    with ContinuousBatchedGenerator(tp, tc, n_slots=2, device="cpu") as plain:
        want = [_ids(f) for f in [plain.submit(p, n)
                                  for p, n in zip(ps, lens)]]
    assert got == want
    for p, n, ids, stream in zip(ps, lens, got, streams):
        assert ids == jax_spec_ids(p, n)
        assert ids == _spec_generate(spec_models, p, n)
        assert stream == ids


def test_spec_engine_counters_equal_the_jax_engine(spec_models):
    """One request at a time through both speculative engines: ticks,
    drafted and accepted agree after each."""
    (jp, _, jc, _), (jdp, _, jdc, _), _ = spec_models
    ps = _prompts(3, 7, seed=62)
    with _spec_engine(spec_models, n_slots=2) as gen, \
            JaxEngine(jp, jc, n_slots=2, draft_params=jdp, draft_config=jdc,
                      spec_k=SPEC_K) as jgen:
        for p, n in zip(ps, (10, 4, 15)):
            assert gen.generate_sync(p, n, timeout=WAIT).tolist() == \
                np.asarray(jgen.generate_sync(p, n, timeout=WAIT)).tolist()
            assert (gen.spec_ticks, gen.spec_drafted, gen.spec_accepted,
                    gen.prefill_chunks_total) == \
                (jgen.spec_ticks, jgen.spec_drafted, jgen.spec_accepted,
                 jgen.prefill_chunks_total)


def test_perturbed_draft_is_exact_under_concurrency(spec_models):
    """A draft that agrees on most argmaxes, not all (blocks end
    mid-window), twelve submitter threads through four slots: every row
    equals JAX generate."""
    ps = _prompts(12, 6, seed=63)
    outs = {}
    with _spec_engine(spec_models, draft="perturbed", n_slots=4,
                      max_new_cap=16) as gen:
        def worker(i):
            outs[i] = gen.generate_sync(ps[i], 10, timeout=WAIT).tolist()
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
        assert not any(t.is_alive() for t in threads)
        assert 0 < gen.spec_accepted < gen.spec_drafted
    for i, p in enumerate(ps):
        assert outs[i] == _spec_generate(spec_models, p, 10)


def test_spec_stream_bursts_arrive_in_order(spec_models):
    """A self-draft accepts every proposal, so a tick streams k+1 tokens:
    the stream is the ids in order, the first token (drawn at the splice)
    arrives with the first tick's readback ahead of that tick's burst,
    later ones in bursts, all before the future resolves."""
    p = _prompts(1, 6, seed=64)[0]
    seen, holder = [], {}
    with _spec_engine(spec_models, draft="self", n_slots=2) as gen:
        holder["f"] = fut = gen.submit(p, 13, on_token=lambda t: seen.append(
            (int(t), gen.spec_ticks, holder["f"].done())))
        ids = _ids(fut)
        assert gen.spec_accepted == gen.spec_drafted > 0
    assert [t for t, _, _ in seen] == ids
    assert not any(done for _, _, done in seen)
    ticks = [tick for _, tick, _ in seen]
    assert ticks[0] == 1                          # with the first tick
    bursts = [ticks.count(t) for t in sorted(set(ticks))]
    assert bursts == [1 + SPEC_K + 1] + [SPEC_K + 1] * 2   # 1 + 3 x 4
    assert ids == _spec_generate(spec_models, p, 13)


def test_spec_eos_cuts_the_block_and_pads(spec_models, jax_spec_ids):
    p, p2 = _prompts(2, 6, seed=65)
    eos = _spec_generate(spec_models, p, 12)[5]
    stream = []
    with _spec_engine(spec_models, n_slots=2, eos_id=eos, pad_id=0) as gen:
        got = _ids(gen.submit(p, 12, on_token=stream.append))
        got2 = gen.generate_sync(p2, 6, timeout=WAIT).tolist()
    want = jax_spec_ids(p, 12, eos_id=eos)
    assert got == want == _spec_generate(spec_models, p, 12, eos_id=eos)
    live = want.index(eos) + 1
    assert stream == want[:live] and want[live:] == [0] * (12 - live)
    assert got2 == jax_spec_ids(p2, 6, eos_id=eos)


def test_spec_submit_validation(spec_models):
    target, small, _ = spec_models
    with _spec_engine(spec_models, n_slots=1) as gen:
        for kw in ({"top_k": 5}, {"top_p": 0.9}):
            with pytest.raises(ValueError, match="top-k/top-p"):
                gen.submit([1, 2, 3], 4, temperature=0.8, **kw)
        with pytest.raises(ValueError, match="spec_k exceeds max_seq_len"):
            gen.submit(np.arange(S - 10), 8)        # 118 + 8 + 3 > 128
        assert len(gen.submit(np.arange(S - 11), 8).result(
            timeout=WAIT)) == 8                     # 117 + 8 + 3 = 128
    with pytest.raises(ValueError, match="steps_per_sync"):
        _spec_engine(spec_models, steps_per_sync=2)
    with pytest.raises(ValueError, match="together"):
        ContinuousBatchedGenerator(target[1], target[3], draft_params=small[1],
                                   device="cpu")
    with pytest.raises(ValueError, match="spec_k"):
        ContinuousBatchedGenerator(target[1], target[3],
                                   draft_params=small[1],
                                   draft_config=small[3], spec_k=0,
                                   device="cpu")


def test_spec_kv_quant_engine_matches_jax(spec_models, jax_spec_ids):
    ps = _prompts(2, 7, seed=66)
    with _spec_engine(spec_models, n_slots=2, kv_quant=True) as gen:
        got = [_ids(f) for f in [gen.submit(p, 8) for p in ps]]
    for p, ids in zip(ps, got):
        assert ids == jax_spec_ids(p, 8, kv_quant=True)
        assert ids == _spec_generate(spec_models, p, 8, kv_quant=True)


def test_spec_sampled_row_beside_greedy_rows(spec_models):
    p = _prompts(1, 6, seed=67)[0]
    with _spec_engine(spec_models, n_slots=3, seed=5) as gen:
        f_greedy = gen.submit(p, 10)
        f_hot = gen.submit(p, 10, temperature=5.0)
        f_warm = gen.submit(p, 10, temperature=0.8)
        greedy, hot, warm = _ids(f_greedy), _ids(f_hot), _ids(f_warm)
    assert greedy == _spec_generate(spec_models, p, 10)
    assert hot != greedy
    assert all(0 <= t < TINY["vocab_size"] for t in hot + warm)


def test_a_failed_spec_tick_rebuilds_both_states(spec_models):
    p = np.arange(6, dtype=np.int32)
    with _spec_engine(spec_models, n_slots=2) as gen:
        tick, failed = gen._spec_tick, []
        old = (gen._state, gen._dstate)

        def flaky(*args):
            if not failed:
                failed.append(1)
                raise RuntimeError("injected tick failure")
            return tick(*args)
        gen._spec_tick = flaky
        with pytest.raises(RuntimeError, match="injected"):
            gen.submit(p, 5).result(timeout=WAIT)
        assert gen.generate_sync(p, 5, timeout=WAIT).tolist() == \
            _spec_generate(spec_models, p, 5)
        assert gen._state is not old[0] and gen._dstate is not old[1]
        assert not any(gen._state["active"].tolist())
