"""The legacy contiguous KV layout on the port, on the CPU at the tiny
geometry, against the JAX package on the same numpy-seeded inputs and
weights (``params_from_jax``) and cache state (``kv_cache_from_jax``):

- the chunked decode twin against JAX ``chunked_gqa_decode_attention``
  (f32 / bf16 queries; native, bf16, e4m3 and e5m2 caches; the dequant and
  the in-dot read; ragged positions on and beside chunk boundaries, an
  inactive row, a window), the tolerances of tests/test_longctx_decode.py;
  bit-equal to the paged twin when the pages hold the cache's chunks (the
  contract of tests/test_kv_paging.py:229-283);
- ``decode_step`` (``kv_chunk`` None and 64, ``attn_fp8``), ``insert_sequences``
  with a pad row that aliases a slot, ``prefill_chunk``, ``prefill_suffix``,
  ``insert_prefix`` / ``extract_prefix``, ``verify_tree_step`` +
  ``commit_tree_path``: logits within 1e-4 of JAX's, caches bit-equal but
  for values written one format step apart;
- the engine with ``kv_layout="legacy"``: greedy ids equal to the JAX legacy
  engine's (f32, bf16 and fp8 caches, int8 weights) over a trace with a
  prefix hit and piggybacked chunks, and to the port's paged engine (greedy
  and sampled ids; chunked prefill; a speculative engine); the JAX knob
  contracts (the fallback to legacy, ``decode_kv_chunk``, ``attn_fp8``);
- the stats keys of ROADMAP Queue 3 fault 10 with the JAX assertions of
  tests/test_streaming.py:166-178, tests/test_longctx_decode.py:179 / :196,
  tests/test_kv_paging.py:692-693, tests/test_speculative.py:423-424 and
  tests/test_decode_fused.py:196 / :265.
"""

import asyncio
import importlib
import logging
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from django_assistant_bot_tpu.models import DecoderConfig as JaxDecoderConfig
from django_assistant_bot_tpu.models import llama as jllama
from django_assistant_bot_tpu.ops.quant import quantize_decoder_params
from django_assistant_bot_tpu.serving import ByteTokenizer as JaxByteTokenizer
from django_assistant_bot_tpu.serving import GenerationEngine as JaxGenerationEngine
from django_assistant_bot_tpu_torch.convert import (
    kv_cache_from_jax,
    kv_cache_to_numpy,
    params_from_jax,
)
from django_assistant_bot_tpu_torch.models import DecoderConfig, llama
from django_assistant_bot_tpu_torch.ops import speculative as tspec
from django_assistant_bot_tpu_torch.ops.attention import (
    chunked_bf16_bound,
    chunked_gqa_decode_attention,
    chunked_gqa_decode_attention_plain,
    paged_fp8_dot_probe,
    paged_gqa_decode_attention,
)
from django_assistant_bot_tpu_torch.ops.quant import to_kv_dtype
from django_assistant_bot_tpu_torch.serving import (
    ByteTokenizer,
    GenerationEngine,
    ModelRegistry,
    ModelSpec,
)
from django_assistant_bot_tpu_torch.serving.obs import parse_prometheus_text, render_prometheus

jattn = importlib.import_module("django_assistant_bot_tpu.ops.attention")

# cache format -> (torch dtype, jax dtype); None: the queries' own
FMT = {
    "e4m3": (torch.float8_e4m3fn, jnp.float8_e4m3fn),
    "e5m2": (torch.float8_e5m2, jnp.float8_e5m2),
    "bf16": (torch.bfloat16, jnp.bfloat16),
}
OP_ATOL = 2e-6  # tests/test_longctx_decode.py: the chunked read vs the full one, f32
F32_ATOL = 1e-5  # f32 summation order
LOGITS_ATOL = 1e-4  # tests/test_longctx_decode.py: decode_step logits, chunked vs full


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().contiguous()
        return x.view(torch.uint8 if x.element_size() == 1 else
                      torch.int16 if x.element_size() == 2 else torch.int32).numpy()
    x = np.asarray(x)
    return x.view({1: np.uint8, 2: np.int16, 4: np.int32}[x.dtype.itemsize])


def _both(a: np.ndarray, fmt):
    """``a`` as a JAX array and a port tensor holding the same bits, cast to
    ``fmt`` (None: f32)."""
    if fmt is None:
        return jnp.asarray(a), _t(a)
    tdt, jdt = FMT[fmt]
    j = jnp.asarray(a).astype(jdt)
    t = _t(np.asarray(j.astype(jnp.float32))).to(tdt)
    assert np.array_equal(_bits(t), _bits(j))
    return j, t


# ------------------------------------------------------------------ the op
B, H, KH, S, D, CHUNK = 5, 8, 2, 64, 16, 16
POSITIONS = np.asarray([0, 15, 16, 41, 63], np.int32)  # on and beside chunk boundaries
ACTIVE = np.asarray([True, True, True, False, True])


def _op_case(seed, qdt, fmt):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, 1, D)).astype(np.float32)
    jk, tk = _both(rng.normal(size=(B, KH, S, D)).astype(np.float32), fmt)
    jv, tv = _both(rng.normal(size=(B, KH, S, D)).astype(np.float32), fmt)
    jq = jnp.asarray(q).astype(jnp.bfloat16 if qdt == "bf16" else jnp.float32)
    tq = _t(q).to(torch.bfloat16 if qdt == "bf16" else torch.float32)
    if fmt is None and qdt == "bf16":  # the native read of a bf16 cache
        jk, jv = jk.astype(jnp.bfloat16), jv.astype(jnp.bfloat16)
        tk, tv = (_t(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16) for x in (jk, jv))
    return (jq, jk, jv), (tq, tk, tv)


_OP_CASES = [("f32", None, False), ("bf16", None, False), ("f32", "bf16", False),
             ("f32", "e4m3", False), ("bf16", "e4m3", False), ("f32", "e5m2", False),
             ("bf16", "e5m2", False), ("f32", "e4m3", True), ("bf16", "e4m3", True),
             ("f32", "e5m2", True)]


@pytest.mark.parametrize("window", [None, 11])
@pytest.mark.parametrize("qdt,fmt,fp8_dot", _OP_CASES)
def test_chunked_twin_matches_jax(qdt, fmt, fp8_dot, window):
    """Ragged rows, one inactive: f32 queries agree with the JAX loop to f32
    summation order (the in-dot read too: both round P against the same
    chunk max); bf16 outputs of both lie within ``chunked_bf16_bound`` of
    the f32 twin on the same (exactly widened) cache."""
    (jq, jk, jv), (tq, tk, tv) = _op_case(3, qdt, fmt)
    jact, tact = jnp.asarray(ACTIVE), _t(ACTIVE)
    want = np.asarray(jattn.chunked_gqa_decode_attention(
        jq, jk, jv, jnp.asarray(POSITIONS), chunk=CHUNK, active=jact, window=window,
        fp8_dot=fp8_dot).astype(jnp.float32))
    got = chunked_gqa_decode_attention(tq, tk, tv, _t(POSITIONS), chunk=CHUNK, active=tact,
                                       window=window, fp8_dot=fp8_dot)
    assert got.dtype == tq.dtype and got.shape == (B, H, 1, D)
    live = ACTIVE  # an inactive row's output is never used
    if qdt == "f32":
        np.testing.assert_allclose(got.numpy()[live], want[live],
                                   atol=F32_ATOL if fp8_dot or fmt else OP_ATOL, rtol=0)
        return
    ref = chunked_gqa_decode_attention_plain(tq.float(), tk, tv, _t(POSITIONS), chunk=CHUNK,
                                             active=tact, window=window, fp8_dot=fp8_dot)
    bound = chunked_bf16_bound(tq.float(), tk, tv, _t(POSITIONS), ref, chunk=CHUNK,
                               active=tact, window=window).numpy()
    assert (np.abs(want - ref.numpy()) <= bound)[live].all()
    assert (np.abs(got.float().numpy() - ref.numpy()) <= bound)[live].all()


def _pages_of(k, chunk, perm):
    """The contiguous cache's chunks as pages of a pool (shuffled by
    ``perm``, two garbage pages past them) and the block table that maps
    them back."""
    Bk, KHk, Sk, Dk = k.shape
    NB = Sk // chunk
    P = Bk * NB + 2
    pool = torch.randn((P, KHk, chunk, Dk)).to(k.dtype)
    bt = torch.zeros((Bk, NB), dtype=torch.int32)
    for b in range(Bk):
        for j in range(NB):
            phys = int(perm[b * NB + j])
            pool[phys] = k[b, :, j * chunk:(j + 1) * chunk]
            bt[b, j] = phys
    return pool, bt


@pytest.mark.parametrize("window", [None, 11])
@pytest.mark.parametrize("qdt,fmt,fp8_dot", [("f32", None, False), ("bf16", None, False),
                                             ("f32", "e4m3", False), ("bf16", "e5m2", True)])
def test_chunked_twin_bit_equal_to_paged_twin(qdt, fmt, fp8_dot, window):
    """Pages holding the cache's chunks (shuffled placement, garbage pages
    beside them) read through the block table give the chunked read's
    bytes: the page is the chunk."""
    _, (tq, tk, tv) = _op_case(4, qdt, fmt)
    perm = np.random.default_rng(5).permutation(B * (S // CHUNK))
    torch.manual_seed(0)
    kp, bt = _pages_of(tk, CHUNK, perm)
    vp, _ = _pages_of(tv, CHUNK, perm)
    kw = dict(active=_t(ACTIVE), window=window, fp8_dot=fp8_dot)
    contiguous = chunked_gqa_decode_attention(tq, tk, tv, _t(POSITIONS), chunk=CHUNK, **kw)
    paged = paged_gqa_decode_attention(tq, kp, vp, bt, _t(POSITIONS), **kw)
    assert torch.equal(_t(_bits(contiguous)), _t(_bits(paged)))


def test_chunked_twin_skips_tail_chunks():
    """NaN planted past every active row's chunk is never read (the JAX
    test_op_skips_tail_chunks): the output is unchanged and finite; a chunk
    width that does not divide the row raises, naming the chunk."""
    (_, _, _), (tq, tk, tv) = _op_case(6, "f32", None)
    pos = _t(np.asarray([10, 20, 31, 5, 17], np.int32))
    clean = chunked_gqa_decode_attention(tq, tk, tv, pos, chunk=CHUNK)
    k2, v2 = tk.clone(), tv.clone()
    k2[:, :, 32:] = float("nan")
    v2[:, :, 32:] = float("nan")
    poisoned = chunked_gqa_decode_attention(tq, k2, v2, pos, chunk=CHUNK)
    assert torch.isfinite(poisoned).all()
    assert torch.equal(clean, poisoned)
    with pytest.raises(ValueError, match="chunk=24"):
        chunked_gqa_decode_attention(tq, tk, tv, pos, chunk=24)


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
def test_chunked_indot_probe_sees_p_rounding(fmt):
    """On ``paged_fp8_dot_probe``'s inputs laid out as a contiguous cache the
    JAX in-dot loop agrees with the twin to f32 summation order (f32
    queries), and the dequant read of
    the same scores misses ``chunked_bf16_bound``: the check the card's
    chunked in-dot read is held to."""
    tdt, jdt = FMT[fmt]
    NB = S // CHUNK
    q, kp, vp = paged_fp8_dot_probe(B, H, KH, D, B * NB, CHUNK, tdt, torch.float32,
                                    torch.Generator().manual_seed(2))

    def cache(pool):  # page b * NB + j -> chunk j of row b
        return pool.view(torch.uint8).reshape(B, NB, KH, CHUNK, D).transpose(1, 2) \
            .reshape(B, KH, S, D).contiguous().view(tdt)

    k, v = cache(kp), cache(vp)
    act = _t(ACTIVE)
    ref = chunked_gqa_decode_attention_plain(q, k, v, _t(POSITIONS), chunk=CHUNK, active=act,
                                             fp8_dot=True)
    jk, jv = (jnp.asarray(t.view(torch.uint8).numpy()).view(jdt) for t in (k, v))
    want = np.asarray(jattn.chunked_gqa_decode_attention(
        jnp.asarray(q.numpy()), jk, jv, jnp.asarray(POSITIONS), chunk=CHUNK,
        active=jnp.asarray(ACTIVE), fp8_dot=True))
    np.testing.assert_allclose(want[ACTIVE], ref.numpy()[ACTIVE], atol=F32_ATOL, rtol=0)
    bound = chunked_bf16_bound(q, k, v, _t(POSITIONS), ref, chunk=CHUNK, active=act)
    control = chunked_gqa_decode_attention(q, k, v, _t(POSITIONS), chunk=CHUNK, active=act)
    assert not bool(((control - ref).abs() <= bound)[_t(ACTIVE)].all())


# ------------------------------------------------------------ the model
@pytest.fixture(scope="module")
def models():
    jcfg = JaxDecoderConfig.tiny()
    jparams = jllama.init(jcfg, jax.random.key(0))
    cfg = DecoderConfig.tiny()
    return jcfg, jparams, cfg, params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")


L, MKH, MD, MS = 2, 2, 16, 256  # the tiny geometry, max_seq_len 256


def _caches(seed, Bc, lengths, fmt=None):
    """One random slot cache as the JAX ``KVCache`` and, through
    ``kv_cache_from_jax``, as the port's."""
    rng = np.random.default_rng(seed)
    jk, _ = _both(rng.normal(size=(L, Bc, MKH, MS, MD)).astype(np.float32), fmt)
    jv, _ = _both(rng.normal(size=(L, Bc, MKH, MS, MD)).astype(np.float32), fmt)
    jc = jllama.KVCache(k=jk, v=jv, lengths=jnp.asarray(lengths, jnp.int32))
    return jc, kv_cache_from_jax(jax.tree.map(np.asarray, jc), "cpu")


def _assert_caches_match(jc, tc, strict=False):
    """Every byte equal to JAX's, but for values the two sides wrote one step
    apart in the cache's format (the K/V a forward writes differ by f32
    summation order before the cast): at most 1 in 1,000, one step each."""
    for jx, tx in ((jc.k, tc.k), (jc.v, tc.v)):
        got, want = _bits(tx).astype(np.int64), _bits(jx).astype(np.int64)
        off = got != want
        if tx.dtype == torch.float32:  # f32: the same order of sums or a last-bit difference
            close = np.abs(tx.numpy() - np.asarray(jx)) <= F32_ATOL
            assert close.all()
            continue
        assert (np.abs(got - want)[off] <= 1).all()
        assert off.mean() <= (0.0 if strict else 1e-3), off.mean()
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))


@pytest.mark.parametrize("fmt", [None, "bf16", "e4m3", "e5m2"])
def test_kv_cache_bridge_round_trip(fmt):
    """``kv_cache_from_jax`` keeps every byte; ``kv_cache_to_numpy`` gives
    arrays JAX takes back bit for bit."""
    jc, tc = _caches(1, 3, [0, 5, 256], fmt)
    assert tc.k.dtype == (FMT[fmt][0] if fmt else torch.float32) and tc.max_len == MS
    np.testing.assert_array_equal(_bits(tc.k), _bits(jc.k))
    back = kv_cache_to_numpy(tc)
    for name in ("k", "v"):
        np.testing.assert_array_equal(_bits(jnp.asarray(back[name])), _bits(getattr(jc, name)))
    np.testing.assert_array_equal(back["lengths"], np.asarray(jc.lengths))


_STEP_CASES = [(None, None, False), (64, None, False), (None, "e4m3", False),
               (64, "e4m3", False), (64, "bf16", False), (64, "e4m3", True),
               (64, "e5m2", True)]


@pytest.mark.parametrize("kv_chunk,fmt,attn_fp8", _STEP_CASES)
def test_decode_step_matches_jax(models, kv_chunk, fmt, attn_fp8):
    """Ragged rows (one on a chunk boundary), one inactive, one full (its
    row frozen; its write lands on the last position, as JAX's clamped
    write): logits within 1e-4 of JAX's, the caches after the step's writes
    equal (inactive rows' garbage writes included)."""
    jcfg, jparams, cfg, params = models
    lengths = np.asarray([3, 64, 200, 17, 256], np.int32)
    active = np.asarray([True, True, True, False, True])
    tokens = np.asarray([7, 11, 13, 17, 19], np.int32)
    jc, tc = _caches(6, 5, lengths, fmt)
    lj, jc = jllama.decode_step(jparams, jcfg, jnp.asarray(tokens), jc,
                                active=jnp.asarray(active), kv_chunk=kv_chunk, attn_fp8=attn_fp8)
    lt, tc = llama.decode_step(params, cfg, _t(tokens), tc, active=_t(active),
                               kv_chunk=kv_chunk, attn_fp8=attn_fp8)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=LOGITS_ATOL, rtol=0)
    _assert_caches_match(jc, tc)
    np.testing.assert_array_equal(tc.lengths.numpy(), [4, 65, 201, 17, 256])


def test_decode_step_chunked_matches_full_read_on_fp8(models):
    """The JAX contract of tests/test_longctx_decode.py:100-116 on the port:
    the chunked read's per-chunk widening equals the full read's
    whole-cache widening of an fp8 cache to 1e-4; ``attn_fp8`` without the
    chunked read raises, as does a chunk that does not divide the row."""
    _, _, cfg, params = models
    toks = _t(np.asarray([3, 4, 5], np.int32))
    _, ca = _caches(4, 3, [5, 64, 100], "e4m3")
    _, cb = _caches(4, 3, [5, 64, 100], "e4m3")
    lg_full, _ = llama.decode_step(params, cfg, toks, ca)
    lg_chunk, _ = llama.decode_step(params, cfg, toks, cb, kv_chunk=32)
    np.testing.assert_allclose(lg_full.numpy(), lg_chunk.numpy(), atol=LOGITS_ATOL, rtol=1e-4)
    with pytest.raises(ValueError, match="attn_fp8 requires the chunked"):
        llama.decode_step(params, cfg, toks, ca, attn_fp8=True)
    with pytest.raises(ValueError, match="kv_chunk=100"):
        llama.decode_step(params, cfg, toks, ca, kv_chunk=100)


def test_insert_sequences_pad_row_aliasing_a_slot(models):
    """A prefill wave's pad row aliases the first real slot and comes
    before it, carrying other K/V and length 0: the real row wins, as in
    the JAX scan, and the cache equals JAX's byte for byte."""
    jcfg, jparams, cfg, params = models
    rng = np.random.default_rng(11)
    jc, tc = _caches(2, 4, [9, 0, 30, 0])
    ks = rng.normal(size=(L, 3, MKH, 32, MD)).astype(np.float32)
    vs = rng.normal(size=(L, 3, MKH, 32, MD)).astype(np.float32)
    lengths = np.asarray([0, 20, 31], np.int32)
    slots = np.asarray([1, 1, 3], np.int32)  # row 0: the pad, aliasing slot 1
    jc = jllama.insert_sequences(jc, jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(lengths),
                                 jnp.asarray(slots))
    llama.insert_sequences(tc, _t(ks), _t(vs), _t(lengths), _t(slots))
    _assert_caches_match(jc, tc, strict=True)
    assert torch.equal(tc.k[:, 1, :, :32], _t(ks[:, 1]))
    assert tc.lengths.tolist() == [9, 20, 30, 31]


def test_prefill_chunk_matches_jax(models):
    """Two chunks of one prompt into slot 2 (the second sliding into the
    first's positions, as the engine's final chunk does): logits within
    1e-4, the cache equal."""
    jcfg, jparams, cfg, params = models
    jc, tc = _caches(3, 4, [0, 12, 0, 7])
    ids = np.random.default_rng(12).integers(1, 255, (2, 32)).astype(np.int32)
    for start, row in ((0, 0), (20, 1)):
        lj, jc = jllama.prefill_chunk(jparams, jcfg, jnp.asarray(ids[row:row + 1]), jc,
                                      jnp.asarray(2, jnp.int32), jnp.asarray(start, jnp.int32),
                                      jnp.asarray(32, jnp.int32))
        lt, tc = llama.prefill_chunk(params, cfg, _t(ids[row:row + 1]), tc, 2, start, 32)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=LOGITS_ATOL, rtol=0)
    _assert_caches_match(jc, tc)
    assert tc.lengths.tolist() == [0, 12, 52, 7]


@pytest.mark.parametrize("fmt", [None, "e4m3", "bf16"])
def test_prefill_suffix_matches_jax(models, fmt):
    """Rows continue from prefixes of 40, 64 and 100 tokens (one near the
    row's end, its write window clamped inside the row), a pad row aliasing
    the first slot: logits within 1e-4, the cache equal."""
    jcfg, jparams, cfg, params = models
    jc, tc = _caches(5, 4, [0, 0, 0, 0], fmt)
    slots = np.asarray([0, 0, 2, 3], np.int32)  # row 0: the pad
    starts = np.asarray([0, 40, 64, 240], np.int32)
    valids = np.asarray([0, 20, 32, 9], np.int32)
    ids = np.random.default_rng(13).integers(1, 255, (4, 32)).astype(np.int32)
    lj, jc = jllama.prefill_suffix(jparams, jcfg, jnp.asarray(ids), jc, jnp.asarray(slots),
                                   jnp.asarray(starts), jnp.asarray(valids))
    lt, tc = llama.prefill_suffix(params, cfg, _t(ids), tc, _t(slots), _t(starts), _t(valids))
    np.testing.assert_allclose(lt[1:].numpy(), np.asarray(lj)[1:], atol=LOGITS_ATOL, rtol=0)
    _assert_caches_match(jc, tc)
    assert tc.lengths.tolist() == [60, 0, 96, 249]


@pytest.mark.parametrize("fmt", [None, "e4m3"])
def test_insert_and_extract_prefix_match_jax(models, fmt):
    """A prefix extracted from one slot's row and inserted into another's
    (pb past the prefix: the tail comes along): both caches and the
    extracted tensors bit-equal to JAX's."""
    jc, tc = _caches(7, 3, [50, 0, 9], fmt)
    jpk, jpv = jllama.extract_prefix(jc, jnp.asarray(0, jnp.int32), 64)
    tpk, tpv = llama.extract_prefix(tc, 0, 64)
    assert tpk.shape == (L, MKH, 64, MD)
    np.testing.assert_array_equal(_bits(tpk), _bits(jpk))
    np.testing.assert_array_equal(_bits(tpv), _bits(jpv))
    jc = jllama.insert_prefix(jc, jpk, jpv, jnp.asarray(2, jnp.int32))
    llama.insert_prefix(tc, tpk, tpv, 2)
    _assert_caches_match(jc, tc, strict=True)
    tc.k[0, 0, 0, 0, 0] = 99.0  # the extracted prefix is a copy
    assert float(tpk[0, 0, 0, 0]) != 99.0


@pytest.mark.parametrize("fmt", [None, "e4m3"])
def test_verify_and_commit_match_jax(models, fmt):
    """The tree-verify forward over the slot cache (plain attention over the
    row and the tree, as JAX): logits within 1e-4, the tree's K/V within
    1e-5, the cache untouched; committing the port's tree K/V (one row
    whose path would cross the row's end, its start clamped) leaves the
    cache equal to JAX committing the same K/V."""
    jcfg, jparams, cfg, params = models
    lengths = np.asarray([5, 30, 47, 250], np.int32)
    jc, tc = _caches(8, 4, lengths, fmt)
    before = _bits(tc.k).copy()
    spec = tspec.make_tree_spec(2, 3)
    tree = np.random.default_rng(10).integers(1, 255, (4, spec.size)).astype(np.int32)
    jl, jks, jvs = jllama.verify_tree_step(jparams, jcfg, jnp.asarray(tree), jc,
                                           jnp.asarray(spec.depths), jnp.asarray(spec.anc_mask))
    tl, tks, tvs = llama.verify_tree_step(params, cfg, _t(tree), tc, _t(spec.depths),
                                          _t(spec.anc_mask))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGITS_ATOL, rtol=0)
    np.testing.assert_allclose(tks.numpy(), np.asarray(jks), atol=F32_ATOL, rtol=0)
    np.testing.assert_array_equal(_bits(tc.k), before)  # read-only
    path = np.stack([np.r_[0, spec.branch_nodes[b % 2]] for b in range(4)]).astype(np.int32)
    jc = jllama.commit_tree_path(jc, jnp.asarray(tks.numpy()), jnp.asarray(tvs.numpy()),
                                 jnp.asarray(path))
    llama.commit_tree_path(tc, tks, tvs, _t(path))
    _assert_caches_match(jc, tc, strict=True)
    assert not np.array_equal(_bits(tc.k), before)


# ------------------------------------------------------------ the engine
def _crank(eng, futs, limit=3000):
    for _ in range(limit):
        if all(f.done() for f in futs):
            return
        eng._loop_iteration()
    raise AssertionError("requests did not finish within the crank budget")


def _mixed_trace(eng, temperature=0.0):
    """A prefix registered by a first request; a wave of a prefix hit and a
    plain request and, two iterations later, a prompt of three chunks that
    piggyback on the live wave's ticks."""
    rng = np.random.default_rng(9)
    prefix = rng.integers(1, 255, 70).tolist()
    eng._running = True
    first = eng.submit(prefix + rng.integers(1, 255, 20).tolist(), max_tokens=8,
                       temperature=0.0, prefix_len=70)
    _crank(eng, [first])
    futs = [eng.submit(prefix + rng.integers(1, 255, 30).tolist(), max_tokens=12,
                       temperature=temperature, prefix_len=70),
            eng.submit(rng.integers(1, 255, 40).tolist(), max_tokens=24, temperature=0.0)]
    for _ in range(2):
        eng._loop_iteration()
    futs.append(eng.submit(rng.integers(1, 255, 150).tolist(), max_tokens=10,
                           temperature=temperature))
    _crank(eng, futs)
    eng._running = False
    return [f.result(timeout=0).token_ids for f in [first] + futs]


_ENGINE_KW = dict(max_slots=4, max_seq_len=256, decode_kv_chunk=64, chunk_size=64,
                  decode_steps=4, prefix_cache_size=8, prefix_min_tokens=16)


def _legacy_pair(models, quantize=False, **kw):
    jcfg, jparams, cfg, params = models
    if quantize:
        jparams = quantize_decoder_params(jparams)
        params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    kw = {**_ENGINE_KW, **kw}
    jeng = JaxGenerationEngine(jcfg, jparams, JaxByteTokenizer(), kv_layout="legacy",
                               scheduler=None, **kw)
    teng = GenerationEngine(cfg, params, ByteTokenizer(), device="cpu", kv_layout="legacy", **kw)
    return jeng, teng, params


@pytest.mark.parametrize("kv,quantize,attn_fp8", [(None, False, False), ("bf16", False, False),
                                                  ("fp8", False, False), ("fp8", False, True),
                                                  (None, True, False)],
                         ids=["f32", "bf16", "fp8", "fp8-attn_fp8", "int8"])
def test_legacy_engine_greedy_ids_equal_jax_engine(models, kv, quantize, attn_fp8):
    """The default loop (fused 4-step ticks, piggybacked chunks, the pinned
    prefix LRU) on the slot cache: the JAX legacy engine's ids, prefix hit
    and pinned entries."""
    jeng, teng, _ = _legacy_pair(models, quantize, kv_cache_dtype=kv, attn_fp8=attn_fp8)
    assert not teng.paged and teng.decode_kv_chunk == jeng.decode_kv_chunk == 64
    want = _mixed_trace(jeng)
    got = _mixed_trace(teng)
    assert got == want
    assert teng.prefix_hits == jeng.prefix_hits == 1
    tk, jk = teng.kv_stats(), jeng.kv_stats()
    for key in ("kv_layout", "kv_layout_requested", "kv_layout_effective", "prefix_entries",
                "prefix_bytes", "prefix_hits", "prefix_misses"):
        assert tk[key] == jk[key], key
    assert tk["kv_layout_effective"] == "legacy" and tk["prefix_entries"] == 1
    st = teng.tick_stats()
    assert st["prefill_chunks_piggybacked"] > 0
    assert 0 < st["kv_read_frac"] <= 1


def _sampled(eng, prompts):
    eng._running = True
    futs = [eng.submit(p, max_tokens=12, temperature=(0.9 if i % 2 else 0.0), top_p=0.9)
            for i, p in enumerate(prompts)]
    _crank(eng, futs)
    eng._running = False
    return [f.result(timeout=0).token_ids for f in futs]


@pytest.mark.parametrize("kv,quantize,chunk_size", [(None, False, 512), ("fp8", False, 512),
                                                    (None, True, 512), (None, False, 64)],
                         ids=["f32", "fp8", "int8", "chunked-prefill"])
def test_legacy_engine_byte_identical_to_paged(models, kv, quantize, chunk_size):
    """tests/test_kv_paging.py:357 / :373 on the port: greedy and sampled
    traffic over ragged prompts gives the same ids on the slot cache
    (decode_kv_chunk = the page) as on the page pool, with int8 weights, an
    fp8 cache and chunked prefill."""
    jcfg, jparams, cfg, params = models
    if quantize:
        params = params_from_jax(jax.tree.map(np.asarray, quantize_decoder_params(jparams)),
                                 cfg, "cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 255, n).tolist() for n in ((200,) if chunk_size == 64
                                                         else (9, 33, 65, 100))]
    out = {}
    for layout in ("legacy", "paged"):
        eng = GenerationEngine(cfg, params, ByteTokenizer(), device="cpu", max_slots=4,
                               max_seq_len=256, chunk_size=chunk_size, decode_kv_chunk=64,
                               prefix_cache_size=0, kv_layout=layout, kv_cache_dtype=kv)
        assert eng.paged == (layout == "paged")
        out[layout] = _sampled(eng, prompts)
    assert out["legacy"] == out["paged"]


def test_legacy_prefix_hit_equals_uncached(models):
    """Shared-prefix traffic on the slot cache: pinned-prefix hits give the
    ids of the same requests with the cache off, and the LRU evicts to its
    entry bound."""
    _, _, cfg, params = models
    rng = np.random.default_rng(9)
    prefixes = [rng.integers(1, 255, 40).tolist() for _ in range(3)]
    prompts = [p + rng.integers(1, 255, 12).tolist() for p in prefixes for _ in range(2)]

    def run(size):
        eng = GenerationEngine(cfg, params, ByteTokenizer(), device="cpu", kv_layout="legacy",
                               max_slots=2, max_seq_len=256, prefix_cache_size=size,
                               prefix_min_tokens=16)
        eng._running = True
        out = []
        for p in prompts:  # serial: the first of each pair registers, the second hits
            f = eng.submit(p, max_tokens=6, temperature=0.0, prefix_len=40)
            _crank(eng, [f])
            out.append(f.result(timeout=0).token_ids)
        return out, eng.kv_stats()

    ref, _ = run(0)
    got, kv = run(2)
    assert got == ref
    assert kv["prefix_hits"] == 3 and kv["prefix_misses"] == 3
    assert kv["prefix_entries"] == 2  # the LRU bound evicted the oldest
    assert kv["prefix_bytes"] == 2 * 2 * L * MKH * 64 * MD * 4  # pb = 64, f32 K and V


def test_legacy_piggyback_identical_to_sequential(models):
    """tests/test_contbatch.py:94-125's legacy case: greedy and sampled ids
    with the chunk folded into the tick equal the sequential path's, and
    the gauges show which path ran."""
    _, _, cfg, params = models

    def run(piggyback):
        eng = GenerationEngine(cfg, params, ByteTokenizer(), device="cpu", kv_layout="legacy",
                               max_slots=4, max_seq_len=96, prefix_cache_size=0, chunk_size=16,
                               lookahead=1, decode_steps=2, prefill_piggyback=piggyback)
        eng._running = True
        futs = [eng.submit(list(range(3, 12)), max_tokens=20, temperature=0.0),
                eng.submit(list(range(5, 10)), max_tokens=18, temperature=0.8)]
        for _ in range(3):
            eng._loop_iteration()
        futs.append(eng.submit(list(range(1, 41)), max_tokens=6, temperature=0.7))
        _crank(eng, futs)
        return [f.result(timeout=0).token_ids for f in futs], eng.decode_path_stats()

    on, dec_on = run(True)
    off, dec_off = run(False)
    assert on == off
    assert dec_on["prefill_chunks_piggybacked"] >= 2 and dec_off["prefill_chunks_piggybacked"] == 0
    assert dec_off["prefill_displacement_frac"] > dec_on["prefill_displacement_frac"]


def test_spec_engine_legacy_equals_paged_and_jax(models):
    """tests/test_speculative.py:393 on the port: a speculative engine on the
    slot cache gives the paged spec engine's greedy ids and the JAX legacy
    spec engine's, with drafts proposed."""
    jcfg, jparams, cfg, params = models
    tok = ByteTokenizer()
    jobs = [tok.encode("ab ab ab ab ab ab ab"), tok.encode("context: x y z. context: x y")]
    kw = dict(max_slots=2, max_seq_len=128, decode_kv_chunk=32, speculative=3, spec_width=2,
              spec_probe_every=1, prefix_cache_size=0, lookahead=1)
    out = {}
    for name, eng in (
        ("jax", JaxGenerationEngine(jcfg, jparams, JaxByteTokenizer(), kv_layout="legacy",
                                    scheduler=None, **kw)),
        ("legacy", GenerationEngine(cfg, params, tok, device="cpu", kv_layout="legacy", **kw)),
        ("paged", GenerationEngine(cfg, params, tok, device="cpu", kv_layout="paged", **kw)),
    ):
        eng._running = True
        futs = [eng.submit(ids, max_tokens=12, temperature=0.0) for ids in jobs]
        _crank(eng, futs)
        out[name] = [f.result(timeout=0).token_ids for f in futs]
        if name == "legacy":
            st = eng.tick_stats()
    assert out["legacy"] == out["paged"] == out["jax"]
    assert st["spec_drafted"] > 0 and st["kv"]["kv_layout_effective"] == "legacy"


def test_legacy_restart_rebuilds_a_clean_cache(models):
    """A crash-only restart on the legacy layout zeroes the slot cache and
    drops the pinned prefixes (cut from the failed lineage), then serves
    the resubmitted request to the ids of a fresh engine."""
    _, _, cfg, params = models
    prompt = np.random.default_rng(3).integers(1, 255, 40).tolist()

    def engine():
        return GenerationEngine(cfg, params, ByteTokenizer(), device="cpu", kv_layout="legacy",
                                max_slots=2, max_seq_len=128, prefix_min_tokens=16)

    ref = engine()
    ref._running = True
    f = ref.submit(prompt, max_tokens=6, temperature=0.0)
    _crank(ref, [f])
    eng = engine()
    eng._running = True
    first = eng.submit(prompt, max_tokens=6, temperature=0.0, prefix_len=30)
    _crank(eng, [first])
    assert eng.kv_stats()["prefix_entries"] == 1
    assert bool(eng._cache.k.abs().sum() > 0)
    eng._restart(RuntimeError("injected"))
    assert eng.kv_stats()["prefix_entries"] == 0 and eng.kv_stats()["prefix_bytes"] == 0
    assert bool((eng._cache.k == 0).all()) and bool((eng._cache.lengths == 0).all())
    again = eng.submit(prompt, max_tokens=6, temperature=0.0)
    _crank(eng, [again])
    assert again.result(timeout=0).token_ids == f.result(timeout=0).token_ids


# ------------------------------------------------------------ knobs
def test_engine_kv_knob_validation_and_fallback(models, caplog):
    """tests/test_kv_paging.py:667 and tests/test_longctx_decode.py:184 on
    the port: an unknown layout raises; a context no page divides falls
    back to legacy with a warning, requested "paged" and effective
    "legacy"; decode_kv_chunk 0 is auto, None the full read (kv_read_frac
    1.0), a non-dividing one raises; attn_fp8 on legacy needs the chunked
    read."""
    _, _, cfg, params = models
    tok = ByteTokenizer()
    with pytest.raises(ValueError, match="kv_layout"):
        GenerationEngine(cfg, params, tok, device="cpu", max_slots=1, kv_layout="huh")
    with caplog.at_level(logging.WARNING):
        eng = GenerationEngine(cfg, params, tok, device="cpu", max_slots=1, max_seq_len=100)
    assert not eng.paged and "falling back to the legacy slot cache" in caplog.text
    ks = eng.kv_stats()
    assert ks["kv_layout_requested"] == "paged" and ks["kv_layout_effective"] == "legacy"
    assert eng._cache.k.shape[3] == 100 and eng.decode_kv_chunk is None
    eng = GenerationEngine(cfg, params, tok, device="cpu", max_slots=1, max_seq_len=256,
                           kv_layout="legacy")
    assert eng.decode_kv_chunk == 128 and not eng.paged
    eng = GenerationEngine(cfg, params, tok, device="cpu", max_slots=1, max_seq_len=256,
                           kv_layout="legacy", decode_kv_chunk=None)
    assert eng.decode_kv_chunk is None and eng.tick_stats()["kv_read_frac"] == 1.0
    with pytest.raises(ValueError, match="decode_kv_chunk"):
        GenerationEngine(cfg, params, tok, device="cpu", max_slots=1, max_seq_len=256,
                         kv_layout="legacy", decode_kv_chunk=100)
    with pytest.raises(ValueError, match="chunked decode read"):
        GenerationEngine(cfg, params, tok, device="cpu", max_slots=1, max_seq_len=256,
                         kv_layout="legacy", decode_kv_chunk=None, kv_cache_dtype="fp8",
                         attn_fp8=True)
    eng = GenerationEngine(cfg, params, tok, device="cpu", max_slots=2, max_seq_len=256,
                           speculative=2)
    assert eng.paged and eng.kv_stats()["kv_layout_effective"] == "paged"


def test_registry_and_cli_config_serve_legacy(models, tmp_path):
    """``kv_layout`` is a spec key the registry passes through (the config
    file ``cli serve`` reads), and ``/dialog/`` answers from a legacy
    engine."""
    from django_assistant_bot_tpu_torch.serving.server import load_config_file

    path = tmp_path / "models.toml"
    path.write_text('[models.chat]\ntiny = true\ndevice = "cpu"\nkv_layout = "legacy"\n'
                    'max_seq_len = 256\ndecode_kv_chunk = 64\n')
    conf = load_config_file(str(path))
    spec = ModelSpec.from_dict("chat", conf["chat"])
    assert spec.kv_layout == "legacy" and spec.engine_kwargs()["kv_layout"] == "legacy"
    reg = ModelRegistry({"chat": spec})
    try:
        eng = reg.get_generator("chat")
        assert not eng.paged and eng.kv_stats()["kv_layout"] == "legacy"
        result = asyncio.run(eng.generate([{"role": "user", "content": "hello"}], max_tokens=5,
                                          temperature=0.0))
        assert 1 <= result.completion_tokens <= 5
    finally:
        reg.stop()


# ------------------------------------------------------------ fault 10: the stats keys
def _stats_engine(models, **kw):
    _, _, cfg, params = models
    return GenerationEngine(cfg, params, ByteTokenizer(), device="cpu", max_slots=2,
                            max_seq_len=256, decode_kv_chunk=64, prefix_cache_size=0, **kw)


@pytest.mark.parametrize("layout", ["paged", "legacy"])
def test_tick_stats_carry_the_jax_keys(models, layout):
    """The JAX assertions on the port's stats: tests/test_streaming.py
    :172-178 (TTFT / ITL at the top level), tests/test_longctx_decode.py
    :179 (kv_read_frac inside (0, 1) for a short batch), tests/test_kv_paging
    .py:692-693 / tests/test_speculative.py:423-424 (requested and
    effective layout), tests/test_decode_fused.py:196 (upload_overlap_frac
    in [0, 1]) and :265 (``dabt_upload_overlap_frac`` in /metrics)."""
    eng = _stats_engine(models, kv_layout=layout)
    eng._running = True
    futs = [eng.submit(list(range(1, 16)), max_tokens=5, temperature=0.0),
            eng.submit(list(range(3, 9)), max_tokens=8, temperature=0.7)]
    _crank(eng, futs)
    st = eng.tick_stats()
    assert st["ttft_n"] >= 1 and st["ttft_p50_ms"] > 0
    assert st["itl_n"] >= 1
    assert st["itl_p95_ms"] >= st["itl_p50_ms"] >= 0
    assert st["ticks"] >= 1
    assert 0 < st["kv_read_frac"] < 1  # ~25 of 256 positions: 1 of 4 chunks
    assert 0.0 <= st["upload_overlap_frac"] <= 1.0
    assert st["cancelled_slots"] == 0 and st["reclaimed_slots"] >= st["cancelled_slots"]
    assert st["kv"]["kv_layout_requested"] == layout
    assert st["kv"]["kv_layout_effective"] == layout
    assert eng.decode_kv_chunk == 64
    reg = SimpleNamespace(generators={"m": eng}, embedders={})
    fams = parse_prometheus_text(render_prometheus(reg))
    assert fams["dabt_upload_overlap_frac"]["samples"][0][2] == 0.0


def test_tick_stats_count_cancelled_slots(models):
    """tests/test_streaming.py:166-169: a slot whose client cancelled is
    reclaimed and counted under ``cancelled_slots``, at the top level."""
    eng = _stats_engine(models, kv_layout="legacy")
    eng._running = True
    fut = eng.submit(list(range(1, 12)), max_tokens=200, temperature=0.0)
    for _ in range(3):
        eng._loop_iteration()
    assert eng.num_active == 1
    fut.cancel()
    for _ in range(3):
        eng._loop_iteration()
    st = eng.tick_stats()
    assert eng.num_active == 0
    assert st["cancelled_slots"] == 1 and st["reclaimed_slots"] >= st["cancelled_slots"]


def test_kv_read_frac_is_one_without_the_chunked_read(models):
    """decode_kv_chunk=None: the full read, ``kv_read_frac`` 1.0 before and
    after traffic (tests/test_longctx_decode.py:196)."""
    _, _, cfg, params = models
    eng = GenerationEngine(cfg, params, ByteTokenizer(), device="cpu", max_slots=1,
                           max_seq_len=256, kv_layout="legacy", decode_kv_chunk=None)
    assert eng.tick_stats()["kv_read_frac"] == 1.0
    eng._running = True
    f = eng.submit(list(range(1, 9)), max_tokens=4, temperature=0.0)
    _crank(eng, [f])
    assert eng.tick_stats()["kv_read_frac"] == 1.0


def test_to_kv_dtype_is_the_legacy_cache_cast(models):
    """The legacy writes cast through ``to_kv_dtype`` (JAX's ``astype``
    bits): a value past e4m3's range becomes NaN in the slot cache, as in
    the JAX cache, where torch's own cast would saturate."""
    jc, tc = _caches(9, 1, [0], "e4m3")
    new = np.full((1, MKH, 1, MD), 500.0, np.float32)
    llama._write_cache(tc.k[0], _t(new), _t(np.asarray([3], np.int32)))
    assert bool(torch.isnan(tc.k[0, 0, :, 3].float()).all())
    assert bool(torch.isnan(to_kv_dtype(_t(new), torch.float8_e4m3fn).float()).all())
