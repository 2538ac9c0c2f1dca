"""The port's attention kernels (kubeflow_tpu_torch/ops) against the JAX
package's Pallas kernels, run in interpret mode on the CPU.

On the CPU the port's wrappers take their plain PyTorch versions; these
are held to the reference's own pin, 2e-5 (tests/test_ops.py,
tests/test_decode_attention.py). The CUDA kernels themselves run only on
the card: their kernel-vs-plain tests are marked ``cuda`` and skip here
(chip_smoke.py holds them against the plain versions on every chip run).
On the card the bf16 tensor-core kernels are held by chip_smoke's two
measures: the elementwise bound and the per-tile relative error.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import BF16_TOL, BWD_BF16_ATOL, BWD_BF16_RTOL, check_tiles
from kubeflow_tpu.models.decode import _quantize_kv as jax_quantize_kv
from kubeflow_tpu.ops.attention import _flash_backward, _flash_forward
from kubeflow_tpu.ops.attention import flash_attention as jax_flash
from kubeflow_tpu.ops.decode_attention import \
    flash_decode_attention as jax_flash_decode
from kubeflow_tpu_torch.ops import _build, launch_counts
from kubeflow_tpu_torch.ops import decode_attention
from kubeflow_tpu_torch.ops.attention import (_kernel_ready, flash_attention,
                                              flash_attention_bwd_cuda,
                                              flash_attention_bwd_dq_cuda,
                                              flash_attention_bwd_plain,
                                              flash_attention_cuda,
                                              flash_attention_plain,
                                              prepare_bwd_inputs)
from kubeflow_tpu_torch.ops.decode_attention import (
    _cache_ready, flash_decode_attention, flash_decode_attention_cuda,
    flash_decode_attention_plain)

TOL = 2e-5  # the reference kernels' own pin


def _qkv(s, b=2, h=4, d=32, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d), dtype=np.float32)
            for _ in range(3)]


def _decode_inputs(B=2, S=256, G=2, rep=2, D=64, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, G, rep, D), dtype=np.float32),
            rng.standard_normal((B, S, G, D), dtype=np.float32),
            rng.standard_normal((B, S, G, D), dtype=np.float32))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


# ------------------------------------------------------- flash attention
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [128, 384, 100])
def test_flash_plain_matches_jax_flash(s, causal):
    """s=128/384: the Pallas kernel over 64-blocks (several kv steps of
    the online softmax); s=100: no block divides it, so the JAX side
    takes its XLA fall-back — the port has none and must agree anyway."""
    q, k, v = _qkv(s)
    want = jax_flash(*map(jnp.asarray, (q, k, v)), causal=causal,
                     block_q=64, block_k=64)
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_lse_matches_jax_residual(causal):
    """The (b, h, s) log-sum-exp equals lane 0 of the Pallas kernel's
    lane-replicated (b, h, s, 128) residual."""
    q, k, v = _qkv(128)
    _, lse = _flash_forward(*map(jnp.asarray, (q, k, v)), causal, 64, 64,
                            interpret=True, save_residuals=True)
    _, got = flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                   causal, return_lse=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(lse)[..., 0],
                               rtol=TOL, atol=TOL)


def test_flash_plain_bf16_rounds_p_like_the_kernel():
    """bf16 inputs: the probabilities are cast to v's dtype before the PV
    product, as the Pallas kernel does; the result is bf16. Against the
    f32 computation the error is bf16-grade (2e-2), not exact."""
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in _qkv(64))
    got = flash_attention_plain(q, k, v)
    ref = flash_attention_plain(q.float(), k.float(), v.float())
    assert got.dtype == torch.bfloat16
    assert (got.float() - ref).abs().max().item() < 2e-2


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    q, k, v = map(torch.from_numpy, _qkv(64))
    before = launch_counts()
    out = flash_attention(q, k, v)
    assert torch.equal(out, flash_attention_plain(q, k, v))
    qd, kd, vd = map(torch.from_numpy, _decode_inputs())
    pos = torch.tensor([3, 200], dtype=torch.int32)
    flash_decode_attention(qd, kd, vd, pos)
    assert launch_counts() == before


@pytest.mark.parametrize("bad", ["shape", "dtype", "d_head", "d_head_16",
                                 "mixed_dtypes", "rank"])
def test_flash_cuda_wrapper_rejects_what_the_kernel_cannot_take(bad):
    """Checked before the kernel is built or launched, so it runs here."""
    q, k, v = map(torch.from_numpy, _qkv(64))
    if bad == "shape":
        k = k[:, :32]
    elif bad == "dtype":
        q = q.double()
    elif bad == "d_head":
        q, k, v = (torch.zeros(2, 64, 4, 48) for _ in range(3))
    elif bad == "d_head_16":
        q, k, v = (torch.zeros(2, 64, 4, 16, dtype=torch.bfloat16)
                   for _ in range(3))
    elif bad == "mixed_dtypes":
        k = k.to(torch.bfloat16)
    else:
        q, k, v = (x[0] for x in (q, k, v))
    with pytest.raises(ValueError):
        flash_attention_cuda(q, k, v)


@pytest.mark.parametrize("case,copied", [
    ("bf16_contiguous", False), ("bf16_fused_view", False),
    ("bf16_offset_base", True), ("bf16_odd_stride", True),
    ("bf16_d_strided", True), ("f32_offset_base", False),
    ("f32_d_strided", True)])
def test_kernel_ready_copies_only_what_the_kernels_cannot_read(case,
                                                               copied):
    """bf16 goes through TMA: a base or (b, s, h) stride that is not a
    multiple of 16 bytes gets a fresh, aligned, contiguous copy (the values
    unchanged); f32 needs only a unit last stride."""
    dt = torch.bfloat16 if case.startswith("bf16") else torch.float32
    base = torch.from_numpy(_qkv(16, b=2, h=4, d=64)[0]).to(dt)
    if case.endswith("fused_view"):
        x = torch.stack([base, base, base], dim=2)[:, :, 1]
    elif case.endswith("offset_base"):
        x = torch.empty(base.numel() + 1, dtype=dt)[1:].view(base.shape)
        x.copy_(base)
    elif case.endswith("odd_stride"):
        x = torch.zeros(2, 16, 4, 68, dtype=dt)[..., :64]
        x.copy_(base)
    elif case.endswith("d_strided"):
        x = base.transpose(2, 3).contiguous().transpose(2, 3)
    else:
        x = base
    got = _kernel_ready(x)
    assert torch.equal(got, base)
    assert (got.data_ptr() != x.data_ptr()) == copied
    if copied:
        assert got.is_contiguous() and got.data_ptr() % 16 == 0


# ------------------------------------------------ flash attention backward
def _jax_backward(q, k, v, do, causal, dtype=jnp.float32):
    """The reference's residuals and backward (Pallas, interpret mode)
    over 64-blocks: (o, lse (b, h, s), (dq, dk, dv)) as numpy."""
    q, k, v, do = (jnp.asarray(x, dtype) for x in (q, k, v, do))
    o, lse = _flash_forward(q, k, v, causal, 64, 64, interpret=True,
                            save_residuals=True)
    grads = _flash_backward(q, k, v, o, lse, do, causal, 64, 64,
                            interpret=True)
    return o, lse[..., 0], grads


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_plain_matches_jax_flash_backward(causal):
    """s=128 over 64-blocks: both backward kernels loop over two blocks,
    and the causal one skips the block above the diagonal. The port's
    (b, h, s) lse is lane 0 of the reference's lane-replicated one."""
    q, k, v, do = _qkv(128) + _qkv(128, seed=1)[:1]
    o, lse, want = _jax_backward(q, k, v, do, causal)
    got = flash_attention_bwd_plain(
        *map(torch.from_numpy, (q, k, v, np.array(o), np.array(lse),
                                do)), causal)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL, err_msg=f"d{name}")


def test_flash_bwd_plain_bf16_inputs():
    """bf16 q/k/v/dO: grads come back in bf16, within the 0.1 the
    reference pins its own bf16 backward to (tests/test_ops.py)."""
    q, k, v, do = _qkv(64) + _qkv(64, seed=1)[:1]
    o, lse, want = _jax_backward(q, k, v, do, True, jnp.bfloat16)
    bf = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, do)]
    o_t = torch.from_numpy(np.asarray(o, np.float32)).to(torch.bfloat16)
    got = flash_attention_bwd_plain(*bf[:3], o_t,
                                    torch.from_numpy(np.array(lse)),
                                    bf[3], True)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32),
                                   rtol=0.1, atol=0.1)


@pytest.mark.parametrize("causal", [True, False])
def test_autograd_flash_on_cpu_is_the_plain_backward(causal):
    """The autograd Function saves (q, k, v, out, lse) and its CPU
    backward is flash_attention_bwd_plain on them, exactly; a strided dO
    (as grads out of an einsum are) gives the same grads."""
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _qkv(100))
    do = torch.from_numpy(_qkv(100, seed=1)[0])
    before = launch_counts()
    out = flash_attention(q, k, v, causal=causal)
    got = torch.autograd.grad(out, (q, k, v), do.transpose(1, 2)
                              .contiguous().transpose(1, 2))
    o, lse = flash_attention_plain(q.detach(), k.detach(), v.detach(),
                                   causal, return_lse=True)
    assert torch.equal(out.detach(), o)
    want = flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(), o,
                                     lse, do, causal)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert launch_counts() == before


def test_bwd_launch_counters_are_reported():
    counts = launch_counts()
    for name in ("flash_attention", "flash_attention_bwd_dkv",
                 "flash_attention_bwd_dq"):
        assert name in counts


@pytest.mark.parametrize("bad", ["lse_shape", "lse_dtype", "do_dtype",
                                 "d_head", "kv_dtype", "o_shape"])
def test_flash_bwd_cuda_wrapper_rejects_what_the_kernels_cannot_take(bad):
    """Checked before the kernels are built or launched, so it runs here."""
    q, k, v = map(torch.from_numpy, _qkv(64))
    o, do = q.clone(), k.clone()
    lse = torch.zeros(2, 4, 64)
    if bad == "lse_shape":
        lse = torch.zeros(2, 64, 4)
    elif bad == "lse_dtype":
        lse = lse.double()
    elif bad == "do_dtype":
        do = do.to(torch.bfloat16)
    elif bad == "d_head":
        q, k, v, o, do = (torch.zeros(2, 64, 4, 48) for _ in range(5))
    elif bad == "kv_dtype":
        v = v.to(torch.bfloat16)
    else:
        o = o[:, :32]
    with pytest.raises(ValueError):
        flash_attention_bwd_cuda(q, k, v, o, lse, do)


# ---------------------------------------------------------- flash decode
@pytest.mark.parametrize("pos,S", [([0, 5], 256), ([100, 255], 256),
                                   ([17, 200], 256), ([70, 130], 192)])
def test_decode_plain_matches_jax_at_positions(pos, S):
    """pos at 0, mid-block and last, and a partial final block (the
    reference cases of tests/test_decode_attention.py)."""
    q, k, v = _decode_inputs(S=S)
    p = np.asarray(pos, np.int32)
    want = jax_flash_decode(*map(jnp.asarray, (q, k, v, p)), block_k=64,
                            interpret=True)
    got = flash_decode_attention(*map(torch.from_numpy, (q, k, v, p)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("rep", [1, 4])
def test_decode_plain_matches_jax_gqa_rep(rep):
    q, k, v = _decode_inputs(S=128, rep=rep, seed=3)
    p = np.asarray([50, 100], np.int32)
    want = jax_flash_decode(*map(jnp.asarray, (q, k, v, p)), block_k=64,
                            interpret=True)
    got = flash_decode_attention(*map(torch.from_numpy, (q, k, v, p)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)


def test_decode_plain_matches_jax_int8_scales():
    """int8 cache: the K scale folds onto the logits, the V scale onto P
    after the denominator sum — the same quantized inputs both sides."""
    q, k, v = _decode_inputs(S=128, seed=2)
    qk, ks = (np.array(a) for a in jax_quantize_kv(jnp.asarray(k)))
    qv, vs = (np.array(a) for a in jax_quantize_kv(jnp.asarray(v)))
    p = np.asarray([60, 127], np.int32)
    want = jax_flash_decode(jnp.asarray(q), jnp.asarray(qk),
                            jnp.asarray(qv), jnp.asarray(p),
                            k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
                            block_k=64, interpret=True)
    got = flash_decode_attention(
        *map(torch.from_numpy, (q, qk, qv, p)),
        k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("bad", ["pos_dtype", "cache_dtype", "rep"])
def test_decode_cuda_wrapper_rejects_what_the_kernel_cannot_take(bad):
    q, k, v = map(torch.from_numpy, _decode_inputs())
    pos = torch.tensor([3, 9], dtype=torch.int32)
    if bad == "pos_dtype":
        pos = pos.long()
    elif bad == "cache_dtype":
        k = k.to(torch.bfloat16)
    else:
        q = torch.zeros(2, 2, 3, 64)
    with pytest.raises(ValueError):
        flash_decode_attention_cuda(q, k, v, pos)


@pytest.mark.parametrize("case,copied", [
    ("bf16_contiguous", False), ("int8_contiguous", False),
    ("f32_contiguous", False), ("bf16_layer_slice", False),
    ("int8_layer_slice", False), ("bf16_offset_base", True),
    ("int8_offset_base", True), ("bf16_odd_seq_stride", True),
    ("int8_odd_head_stride", True), ("bf16_d_strided", True)])
def test_cache_ready_copies_only_what_the_vector_loads_cannot_read(case,
                                                                   copied):
    """The decode kernel copies K/V rows 16 bytes at a time: a base or
    (b, s, g) stride that is not a multiple of 16 bytes, or a d axis that
    is not contiguous, gets a fresh aligned contiguous copy (the values
    unchanged); a layer of the stacked (L, B, S, G, D) cache, as
    decode_step passes it, goes in as it is."""
    from kubeflow_tpu_torch.models.decode import init_kv_cache
    from kubeflow_tpu_torch.models.transformer import TransformerConfig
    dt = {"bf16": torch.bfloat16, "int8": torch.int8,
          "f32": torch.float32}[case.split("_")[0]]
    B, S, G, D = 2, 16, 2, 32
    base = (torch.from_numpy(_decode_inputs(B=B, S=S, G=G, D=D)[1]) * 40
            ).clamp(-127, 127).to(dt)
    if case.endswith("layer_slice"):
        cfg = TransformerConfig(vocab_size=64, d_model=4 * D, n_layers=3,
                                n_heads=4, n_kv_heads=G, d_ff=64,
                                max_seq_len=S, dtype="bfloat16")
        cache = init_kv_cache(cfg, B, kv_quant=dt == torch.int8,
                              device="cpu")
        x = cache["k"][1]
        x.copy_(base)
    elif case.endswith("offset_base"):
        x = torch.zeros(base.numel() + 1, dtype=dt)[1:].view(base.shape)
        x.copy_(base)
    elif case.endswith("odd_seq_stride"):
        row = G * D + 1  # one element between consecutive positions
        x = torch.zeros(B * S * row, dtype=dt).as_strided(
            (B, S, G, D), (S * row, row, D, 1))
        x.copy_(base)
    elif case.endswith("odd_head_stride"):
        x = torch.zeros(B, S, G, D + 8, dtype=dt)[..., :D]
        x.copy_(base)
    elif case.endswith("d_strided"):
        x = base.transpose(2, 3).contiguous().transpose(2, 3)
    else:
        x = base
    got = _cache_ready(x)
    assert torch.equal(got, base)
    assert (got.data_ptr() != x.data_ptr()) == copied
    if copied:
        assert got.is_contiguous() and got.data_ptr() % 16 == 0


# ------------------------------------------------------------- the build
def test_kernel_build_key_follows_the_source(tmp_path, monkeypatch):
    """The library is keyed by a hash of its source: an edited kernel
    rebuilds, an unchanged one is found on disk."""
    (tmp_path / "k.cu").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build._target("k")
    assert first == _build._target("k")
    (tmp_path / "k.cu").write_text("// v2\n")
    assert _build._target("k") != first
    assert first.parent == _build.BUILD_DIR


def test_kernel_error_code_raises():
    _build.check(0, "ok")
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        _build.check(9, "flash_attention")


# ------------------------------------------------- kernels, on the card
def _on_card(arrays, device, dtype, layout):
    """numpy (b, s, h, d) arrays on the card as a caller may hand them:
    contiguous, strided views into a fused (b, s, n, h, d) tensor, or views
    whose base is one element past an aligned one (the bf16 wrapper copies
    those for TMA)."""
    xs = [torch.from_numpy(x).to(device, dtype) for x in arrays]
    if layout == "strided":
        fused = torch.stack(xs, dim=2)
        return [fused[:, :, i] for i in range(len(xs))]
    if layout == "offset":
        out = []
        for x in xs:
            view = torch.empty(x.numel() + 1, dtype=dtype,
                               device=device)[1:].view(x.shape)
            view.copy_(x)
            out.append(view)
        return out
    return xs


_CARD_CASES = pytest.mark.parametrize(
    "dtype,d,s,causal,layout",
    [(dt, d, s, causal, "contig") for dt in ("bfloat16", "float32")
     for d in (32, 64, 128) for s in (1, 63, 64, 65, 77, 1024)
     for causal in (True, False)] +
    [(dt, d, 77, True, layout) for dt in ("bfloat16", "float32")
     for d in (32, 128) for layout in ("strided", "offset")])


@pytest.mark.cuda
@_CARD_CASES
def test_flash_kernel_matches_plain_on_card(cuda, dtype, d, s, causal,
                                            layout):
    """f32 to the reference pin; bf16 elementwise to BF16_TOL and per
    64-row tile of queries to chip_smoke's tile measure."""
    dt = getattr(torch, dtype)
    q, k, v = _on_card(_qkv(s, b=2, h=4, d=d), cuda, dt, layout)
    out, lse = flash_attention_cuda(q, k, v, causal, return_lse=True)
    ref, ref_lse = flash_attention_plain(q, k, v, causal, return_lse=True)
    tol = BF16_TOL if dt == torch.bfloat16 else TOL
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert check_tiles(out, ref)[0]
    assert (lse - ref_lse).abs().max().item() <= 1e-4


def _decode_on_card(device, qdt, quant, rep, d, B, S, G=2, seed=0,
                    layers=None):
    """(q, k, v, scales) on the card: q in ``qdt``, the cache in q's dtype
    or int8 with (B, S, G) scales; with ``layers``, k/v (and the scales)
    are layer 1 of a stacked (layers, B, S, G, D) cache, strided views as
    decode_step passes them."""
    from kubeflow_tpu_torch.models.decode import _quantize_kv
    dt = getattr(torch, qdt)
    q, k, v = (torch.from_numpy(x).to(device, dt) for x in _decode_inputs(
        B=B, S=S, G=G, rep=rep, D=d, seed=seed))
    kw = {}
    if quant:
        (k, kw["k_scale"]), (v, kw["v_scale"]) = (_quantize_kv(k),
                                                  _quantize_kv(v))
    if layers:
        def stacked(x):
            st = torch.zeros((layers, *x.shape), dtype=x.dtype,
                             device=device)
            st[1] = x
            return st[1]
        k, v = stacked(k), stacked(v)
        kw = {name: stacked(x) for name, x in kw.items()}
    return q, k, v, kw


_DECODE_CARD_CASES = pytest.mark.parametrize(
    "qdt,quant,rep,d", [(qdt, quant, rep, d)
                        for qdt in ("bfloat16", "float32")
                        for quant in (False, True) for rep in (1, 2, 4, 8)
                        for d in (32, 64, 128)])


@pytest.mark.cuda
@_DECODE_CARD_CASES
def test_decode_kernel_matches_plain_on_card(cuda, qdt, quant, rep, d):
    """Every dtype pair (q bf16/f32, cache in q's dtype or int8), rep and
    d_head, with a row at each edge of the split: pos 0, CHUNK - 1,
    CHUNK, CHUNK + 1, S - 1, past the end (the whole cache) and -1
    (zeros). f32 q to the reference pin, bf16 q to BF16_TOL."""
    chunk = decode_attention._lib().kft_flash_decode_chunk()
    S = 5 * chunk - 3                     # a ragged last chunk
    pos = [0, chunk - 1, chunk, chunk + 1, S - 1, S + 5, -1]
    q, k, v, kw = _decode_on_card(cuda, qdt, quant, rep, d, len(pos), S)
    pos = torch.tensor(pos, dtype=torch.int32, device=cuda)
    got = flash_decode_attention_cuda(q, k, v, pos, **kw)
    want = flash_decode_attention_plain(q, k, v, pos, **kw)
    tol = BF16_TOL if qdt == "bfloat16" else TOL
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert not got[-1].float().any()


@pytest.mark.cuda
@pytest.mark.parametrize("qdt,quant", [("bfloat16", False),
                                       ("bfloat16", True),
                                       ("float32", False)])
def test_decode_kernel_reads_a_layer_of_the_stacked_cache(cuda, qdt, quant):
    """Layer 1 of a (3, B, S, G, D) cache, as decode_step passes it: read
    in place (no copy), same result as the plain version."""
    q, k, v, kw = _decode_on_card(cuda, qdt, quant, 2, 128, 4, 1024, G=4,
                                  layers=3)
    assert _cache_ready(k) is k and _cache_ready(v) is v
    pos = torch.tensor([0, 159, 700, 1023], dtype=torch.int32, device=cuda)
    got = flash_decode_attention_cuda(q, k, v, pos, **kw)
    want = flash_decode_attention_plain(q, k, v, pos, **kw)
    tol = BF16_TOL if qdt == "bfloat16" else TOL
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True])
def test_decode_kernel_gives_the_same_bits_every_launch(cuda, quant):
    """Every split and the combine sum in a fixed order."""
    q, k, v, kw = _decode_on_card(cuda, "bfloat16", quant, 2, 128, 8, 1024,
                                  G=4)
    pos = torch.tensor([0, 1, 127, 128, 500, 777, 1022, 1023],
                       dtype=torch.int32, device=cuda)
    first = flash_decode_attention_cuda(q, k, v, pos, **kw)
    for _ in range(3):
        assert torch.equal(flash_decode_attention_cuda(q, k, v, pos, **kw),
                           first)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_dq_kernel_gives_the_same_bits_every_launch(cuda, dtype):
    """One owner block per dQ tile, no atomics."""
    arrays = _qkv(1024, b=2, h=4, d=128) + _qkv(1024, b=2, h=4, d=128,
                                                seed=1)[:1]
    q, k, v, do = _on_card(arrays, cuda, getattr(torch, dtype), "contig")
    o, lse = flash_attention_cuda(q, k, v, True, return_lse=True)
    args = prepare_bwd_inputs(q, k, v, o, lse, do)
    first = flash_attention_bwd_dq_cuda(*args)
    for _ in range(3):
        assert torch.equal(flash_attention_bwd_dq_cuda(*args), first)


@pytest.mark.cuda
@_CARD_CASES
def test_flash_bwd_kernels_match_plain_on_card(cuda, dtype, d, s, causal,
                                               layout):
    """f32 to the reference pin; bf16 elementwise to chip_smoke's
    BWD_BF16_RTOL * |plain| + BWD_BF16_ATOL (the bf16 kernels round P
    and dS to bf16 for their products, the plain version does not) and per
    64-row tile (queries for dQ, keys for dK and dV)."""
    dt = getattr(torch, dtype)
    arrays = _qkv(s, b=2, h=4, d=d) + _qkv(s, b=2, h=4, d=d, seed=1)[:1]
    q, k, v, do = _on_card(arrays, cuda, dt, layout)
    o, lse = flash_attention_cuda(q, k, v, causal, return_lse=True)
    got = flash_attention_bwd_cuda(q, k, v, o, lse, do, causal)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    rtol, atol = ((0.0, TOL) if dt == torch.float32 else
                  (BWD_BF16_RTOL, BWD_BF16_ATOL))
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), rtol=rtol,
                                   atol=atol)
        assert check_tiles(g, w)[0]
