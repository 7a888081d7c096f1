"""fp8 (and bf16-under-f32) KV pools on the port's paged plane, on the CPU at
the tiny geometry, against the JAX package on identical numpy inputs.

- the pool cast (``ops.quant.to_kv_dtype``) and ``quantize_fp8``: bits
  equal to JAX's ``astype`` / ``quantize_fp8`` (NaN as NaN);
- the paged decode twin over e4m3, e5m2 and bf16-under-f32 pools, dequant
  and in-dot (``fp8_dot``), ragged positions, a window, an inactive row:
  the JAX function within f32 summation order (f32 queries, dequant and
  in-dot), both bf16 outputs within ``paged_bf16_bound`` of the f32 twin
  (bf16 queries); on ``paged_fp8_dot_probe``'s inputs the in-dot read to
  that bound, which the dequant read of the same scores misses; the JAX
  contract of tests/test_contbatch.py:238-292;
- the tree twin over fp8 prefix pages: the JAX function within 1e-5;
- ``decode_step_paged`` (dequant and ``attn_fp8``), ``prefill_suffix_paged``
  and ``verify_tree_step_paged`` / ``commit_tree_path_paged`` on narrow
  pools: logits within 1e-4 of JAX's, pools after the writes bit-equal
  but for values the forwards wrote one format step apart (f32 summation
  order before the cast), the commit of the same K/V bit-equal;
- the engine with ``kv_cache_dtype`` "fp8", "fp8_e5m2", "bf16" and fp8 with
  ``attn_fp8``: greedy ids token-identical to the JAX engine over one trace
  with a prefix hit, a piggybacked chunk and JSON rows, and on a spec
  engine; the JAX engine contracts of tests/test_contbatch.py:294-338 and
  tests/test_serving.py:903-990.
"""

import asyncio

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from django_assistant_bot_tpu.models import DecoderConfig as JaxDecoderConfig
from django_assistant_bot_tpu.models import llama as jllama
from django_assistant_bot_tpu.ops import attention as jattn
from django_assistant_bot_tpu.ops.quant import quantize_fp8 as jax_quantize_fp8
from django_assistant_bot_tpu.serving import ByteTokenizer as JaxByteTokenizer
from django_assistant_bot_tpu.serving import GenerationEngine as JaxGenerationEngine
from django_assistant_bot_tpu_torch.convert import params_from_jax
from django_assistant_bot_tpu_torch.models import DecoderConfig, llama
from django_assistant_bot_tpu_torch.ops import speculative as tspec
from django_assistant_bot_tpu_torch.ops.attention import (
    paged_bf16_bound,
    paged_fp8_dot_probe,
    paged_gqa_decode_attention,
    paged_gqa_decode_attention_plain,
    paged_tree_attention,
)
from django_assistant_bot_tpu_torch.ops.quant import quantize_fp8, to_kv_dtype
from django_assistant_bot_tpu_torch.serving import (
    ByteTokenizer,
    GenerationEngine,
    ModelRegistry,
    ModelSpec,
)

# pool format -> (torch dtype, jax dtype)
FMT = {
    "e4m3": (torch.float8_e4m3fn, jnp.float8_e4m3fn),
    "e5m2": (torch.float8_e5m2, jnp.float8_e5m2),
    "bf16": (torch.bfloat16, jnp.bfloat16),
}
F32_ATOL = 1e-5  # f32 summation order
LOGITS_ATOL = 1e-4  # the tiny model's logits, f32 summation order through two layers


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bits(x):
    """A tensor's or array's raw bytes, as uint8 (fp8) or uint16 (bf16)."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.uint8 if x.element_size() == 1 else torch.int16).numpy()
    x = np.asarray(x)
    return x.view(np.uint8 if x.dtype.itemsize == 1 else np.int16)


def _narrow(a: np.ndarray, fmt: str):
    """The same values as a JAX array and a port tensor in ``fmt`` (JAX
    casts; the port's tensor holds the same bits)."""
    tdt, jdt = FMT[fmt]
    j = jnp.asarray(a).astype(jdt)
    t = _t(np.asarray(j.astype(jnp.float32))).to(tdt)
    assert np.array_equal(_bits(t), _bits(j))
    return j, t


# ------------------------------------------------------------------ casts
CAST_GRID = np.concatenate([
    np.linspace(-500, 500, 200_001),
    [464, -464, 464.0001, 463.999, 448, 61440, -61440, 61439.99, 57344, 65536, 1e6,
     np.inf, -np.inf, np.nan, 0.0, -0.0],
    2.0 ** -np.arange(6, 20), -(2.0 ** -np.arange(6, 20)) * 1.37,
    np.random.default_rng(0).normal(size=50_000) * 1e-3,
]).astype(np.float32)


@pytest.mark.parametrize("src", ["f32", "bf16"])
@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
def test_kv_cast_bit_equal_to_jax(fmt, src):
    """``to_kv_dtype`` gives ``jnp.astype``'s bits over +-500 (past e4m3's
    464, where torch's own cast saturates to 448 and JAX gives NaN), the
    e5m2 overflow edge, subnormals, inf and NaN; NaN as NaN."""
    tdt, jdt = FMT[fmt]
    x = jnp.asarray(CAST_GRID)
    xt = _t(CAST_GRID)
    if src == "bf16":
        x, xt = x.astype(jnp.bfloat16), xt.to(torch.bfloat16)
    want = x.astype(jdt)
    got = to_kv_dtype(xt, tdt)
    nan = np.isnan(np.asarray(want.astype(jnp.float32)))
    np.testing.assert_array_equal(torch.isnan(got.float()).numpy(), nan)
    np.testing.assert_array_equal(_bits(got)[~nan], _bits(want)[~nan])
    if fmt == "e4m3":
        # the divergence the helper repairs: torch's own cast saturates
        past = torch.isfinite(xt.float()) & (xt.float().abs() > 464)
        assert bool(past.any()) and bool((xt.to(tdt).float()[past].abs() == 448).all())


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
@pytest.mark.parametrize("shape,axis,scale", [((2, 4, 16), -1, 1.0), ((3, 8, 64), -1, 1000.0),
                                              ((4, 5, 16), 1, 1e-3), ((2, 2, 1, 128), -1, 3.0)])
def test_quantize_fp8_bit_equal_to_jax(fmt, shape, axis, scale):
    tdt, jdt = FMT[fmt]
    x = (np.random.default_rng(1).normal(size=shape) * scale).astype(np.float32)
    x[0, 0] = 0.0  # an all-zero vector: the 1e-12 floor
    jq, js = jax_quantize_fp8(jnp.asarray(x), axis=axis, dtype=jdt)
    tq, ts = quantize_fp8(_t(x), axis=axis, dtype=tdt)
    np.testing.assert_array_equal(_bits(tq), _bits(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts.dtype == torch.float32 and ts.shape[axis] == 1


# ------------------------------------------------------------ paged decode
def _paged_case(seed, qdt, fmt, B=4, H=8, KH=2, D=16, page=8, NB=5):
    """Pools in ``fmt`` (the same bits on both sides), queries in ``qdt``,
    ragged positions, a sentinel past each row's allocation, row 2
    inactive."""
    rng = np.random.default_rng(seed)
    P = B * NB
    q = rng.normal(size=(B, H, 1, D)).astype(np.float32)
    k = rng.normal(size=(P, KH, page, D)).astype(np.float32)
    v = rng.normal(size=(P, KH, page, D)).astype(np.float32)
    positions = np.asarray([3, 17, 38, 9], np.int32)
    bt = rng.permutation(P).reshape(B, NB).astype(np.int32)
    for b, pos in enumerate(positions):
        bt[b, pos // page + 1:] = P
    active = np.asarray([True, True, False, True])
    jk, tk = _narrow(k, fmt)
    jv, tv = _narrow(v, fmt)
    jq = jnp.asarray(q).astype(jnp.bfloat16 if qdt == "bf16" else jnp.float32)
    tq = _t(q).to(torch.bfloat16 if qdt == "bf16" else torch.float32)
    jargs = (jq, jk, jv, jnp.asarray(bt), jnp.asarray(positions))
    targs = (tq, tk, tv, _t(bt), _t(positions))
    return jargs, targs, jnp.asarray(active), _t(active)


_DECODE_CASES = [(q, f, dot) for q in ("f32", "bf16") for f in ("e4m3", "e5m2", "bf16")
                 for dot in (False, True) if not (f == "bf16" and (q == "bf16" or dot))]


@pytest.mark.parametrize("window", [None, 11])
@pytest.mark.parametrize("qdt,fmt,fp8_dot", _DECODE_CASES)
def test_paged_decode_twin_matches_jax_on_narrow_pools(qdt, fmt, fp8_dot, window):
    jargs, targs, jact, tact = _paged_case(7, qdt, fmt)
    want = np.asarray(jattn.paged_gqa_decode_attention(
        *jargs, active=jact, window=window, fp8_dot=fp8_dot).astype(jnp.float32))
    got = paged_gqa_decode_attention(*targs, active=tact, window=window, fp8_dot=fp8_dot)
    assert got.dtype == targs[0].dtype
    if qdt == "f32":
        # the JAX loop and the twin round P against the same page max: the
        # in-dot read too agrees to f32 summation order
        np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=0)
    else:
        # bf16 queries: both bf16 outputs within paged_bf16_bound of the f32
        # twin on the (exactly widened) pools
        q, k, v, bt, pos = targs
        fargs = (q.float(), k.float(), v.float(), bt, pos)
        ref = paged_gqa_decode_attention_plain(q.float(), k, v, bt, pos, active=tact,
                                               window=window, fp8_dot=fp8_dot)
        bound = paged_bf16_bound(*fargs, ref, active=tact, window=window).numpy()
        assert (np.abs(want - ref.numpy()) <= bound).all()
        assert (np.abs(got.float().numpy() - ref.numpy()) <= bound).all()


@pytest.mark.parametrize("qdt", ["f32", "bf16"])
@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
def test_fp8_indot_probe_sees_p_rounding(fmt, qdt):
    """On ``paged_fp8_dot_probe``'s inputs (every side rounds P at the same
    scale, no p near a rounding boundary) the JAX in-dot function meets
    ``paged_bf16_bound`` (2^-8 (|ref| + A) + 1e-4) against the twin, and
    the f32 outputs are equal; the control, the dequant read of the same
    scores (P unrounded, or rounded to bf16), misses that bound, as does
    the in-dot read with one page's keys pushed out of the softmax: so the
    card's K2 check on these inputs sees a kernel that skips P's rounding
    or a page."""
    tdt, jdt = FMT[fmt]
    B, H, KH, D, page, NB = 4, 8, 2, 16, 8, 5
    P = B * NB
    gen = torch.Generator().manual_seed(5)
    q, k, v = paged_fp8_dot_probe(B, H, KH, D, P, page, tdt, torch.bfloat16 if qdt == "bf16"
                                  else torch.float32, gen)
    bt = torch.randperm(P, generator=gen).reshape(B, NB).to(torch.int32)
    pos = torch.tensor([3, 17, 38, 9], dtype=torch.int32)
    for b, n in enumerate(pos.tolist()):
        bt[b, n // page + 1:] = P
    act = torch.tensor([True, True, False, True])
    jq = jnp.asarray(q.float().numpy()).astype(jnp.bfloat16 if qdt == "bf16" else jnp.float32)
    jk, jv = (jnp.asarray(t.view(torch.uint8).numpy()).view(jdt) for t in (k, v))
    want = np.asarray(jattn.paged_gqa_decode_attention(
        jq, jk, jv, jnp.asarray(bt.numpy()), jnp.asarray(pos.numpy()),
        active=jnp.asarray(act.numpy()), fp8_dot=True).astype(jnp.float32))
    ref = paged_gqa_decode_attention_plain(q.float(), k, v, bt, pos, active=act, fp8_dot=True)
    bound = paged_bf16_bound(q.float(), k, v, bt, pos, ref, active=act)
    assert (np.abs(want - ref.numpy()) <= bound.numpy()).all()
    if qdt == "f32":
        np.testing.assert_array_equal(want, ref.numpy())
    control = paged_gqa_decode_attention(q, k, v, bt, pos, active=act).float()
    assert not bool(((control - ref).abs() <= bound).all())
    dropped = k.float()
    dropped[int(bt[1, 1]), :, :, :2 * (H // KH)] = -float(torch.finfo(tdt).max)
    lost = paged_gqa_decode_attention(q, dropped.to(tdt), v, bt, pos, active=act,
                                      fp8_dot=True).float()
    assert not bool(((lost - ref).abs() <= bound).all())


FP8_INDOT_MAX_ABS_ERR = 0.15  # the JAX contract (tests/test_contbatch.py)


def test_fp8_indot_paged_within_the_jax_contract():
    """tests/test_contbatch.py:238-292 on the port's twin: the in-dot read
    differs from the dequant read, by less than 0.15, on the JAX test's
    operands (bf16 queries, e4m3 pools mirroring a contiguous cache); a
    pool that is not fp8 with ``fp8_dot`` raises naming fp8."""
    rng = np.random.default_rng(0)
    B, H, KH, S, D, page = 2, 4, 2, 64, 16, 16
    q = _t(np.asarray(jnp.asarray(rng.standard_normal((B, H, 1, D)), jnp.bfloat16)
                      .astype(jnp.float32))).to(torch.bfloat16)
    nb = S // page

    def pool(a):
        a = (a * 0.5).astype(np.float32).reshape(B, KH, nb, page, D).transpose(0, 2, 1, 3, 4)
        return _narrow(a.reshape(B * nb, KH, page, D), "e4m3")[1]

    k_pool = pool(rng.standard_normal((B, KH, S, D)))
    v_pool = pool(rng.standard_normal((B, KH, S, D)))
    bt = _t(np.asarray([[b * nb + j for j in range(nb)] for b in range(B)], np.int32))
    positions = _t(np.asarray([S - 1, S // 3], np.int32))
    ref = paged_gqa_decode_attention(q, k_pool, v_pool, bt, positions)
    got = paged_gqa_decode_attention(q, k_pool, v_pool, bt, positions, fp8_dot=True)
    err = float((got.float() - ref.float()).abs().max())
    assert 0.0 < err < FP8_INDOT_MAX_ABS_ERR, err
    with pytest.raises(ValueError, match="fp8"):
        paged_gqa_decode_attention(q, k_pool.to(torch.bfloat16), v_pool.to(torch.bfloat16), bt,
                                   positions, fp8_dot=True)


# ------------------------------------------------------------ paged tree
@pytest.mark.parametrize("window", [None, 9])
@pytest.mark.parametrize("fmt", ["e4m3", "e5m2", "bf16"])
def test_paged_tree_twin_matches_jax_on_narrow_pools(fmt, window):
    """f32 tree queries over e4m3 / e5m2 / bf16 prefix pages (the tree's
    own K/V in f32): the JAX function within f32 summation order."""
    rng = np.random.default_rng(21)
    B, H, KH, D, page, NB = 4, 8, 2, 16, 8, 6
    spec = tspec.make_tree_spec(2, 3)
    T, P = spec.size, B * NB
    q, tk, tv = (rng.normal(size=s).astype(np.float32)
                 for s in ((B, H, T, D), (B, KH, T, D), (B, KH, T, D)))
    jk, k = _narrow(rng.normal(size=(P, KH, page, D)).astype(np.float32), fmt)
    jv, v = _narrow(rng.normal(size=(P, KH, page, D)).astype(np.float32), fmt)
    lengths = np.asarray([0, 9, 30, 47], np.int32)
    bt = rng.permutation(P).reshape(B, NB).astype(np.int32)
    for b, n in enumerate(lengths):
        bt[b, -(-int(n) // page):] = P
    want = np.asarray(jattn.paged_tree_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(bt), jnp.asarray(lengths), jnp.asarray(tk),
        jnp.asarray(tv), jnp.asarray(spec.anc_mask), jnp.asarray(spec.depths), window=window))
    got = paged_tree_attention(_t(q), k, v, _t(bt), _t(lengths), _t(tk), _t(tv),
                               _t(spec.anc_mask), _t(spec.depths), window=window)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=0)


# ------------------------------------------------------------ the model
@pytest.fixture(scope="module")
def models():
    jcfg = JaxDecoderConfig.tiny()
    jparams = jllama.init(jcfg, jax.random.key(0))
    cfg = DecoderConfig.tiny()
    return jcfg, jparams, cfg, params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")


L, KH, D = 2, 2, 16  # the tiny geometry
PAGE, NB = 32, 8  # S = 256 = the tiny max_seq_len


def _caches(seed, P, lengths, fmt):
    """The same narrow pool as a JAX PagedKVCache and as the port's (one
    extra dump page)."""
    rng = np.random.default_rng(seed)
    jk, tk = _narrow(rng.normal(size=(L, P, KH, PAGE, D)).astype(np.float32), fmt)
    jv, tv = _narrow(rng.normal(size=(L, P, KH, PAGE, D)).astype(np.float32), fmt)
    dump = torch.zeros((L, 1, KH, PAGE, D), dtype=FMT[fmt][0])
    jc = jllama.PagedKVCache(k=jk, v=jv, lengths=jnp.asarray(lengths))
    tc = llama.PagedKVCache(k=torch.cat([tk, dump], 1), v=torch.cat([tv, dump], 1),
                            lengths=_t(lengths))
    return jc, tc


def _assert_pools_match(jc, tc, strict=False):
    """Every pool byte equal to JAX's, but for values the two sides wrote
    one step apart in the pool's format: the K/V a forward writes differ by
    f32 summation order before the cast, and a value that close to a
    rounding boundary of the format lands on either side of it.  Such
    values are rare (at most 1 in 1,000 here), and never more than one
    step apart."""
    P = jc.k.shape[1]
    for jp, tp in ((jc.k, tc.k), (jc.v, tc.v)):
        got = _bits(tp[:, :P].contiguous()).astype(np.int32)
        want = _bits(jp).astype(np.int32)
        off = got != want
        assert (np.abs(got - want)[off] <= 1).all()
        assert off.mean() <= (0.0 if strict else 1e-3), off.mean()
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))


@pytest.mark.parametrize("fmt,attn_fp8", [("e4m3", False), ("e5m2", False), ("bf16", False),
                                          ("e4m3", True), ("e5m2", True)])
def test_decode_step_paged_on_narrow_pools_matches_jax(models, fmt, attn_fp8):
    """Ragged rows, one past its allocation, one inactive: logits within
    1e-4 of JAX's, and the pools equal after the step's writes
    (:func:`_assert_pools_match`)."""
    jcfg, jparams, cfg, params = models
    P = 24
    lengths = np.asarray([5, 40, 64, 200], np.int32)
    bt = np.full((4, NB), P, np.int32)
    bt[0, :1] = [3]
    bt[1, :2] = [8, 1]
    bt[2, :2] = [12, 13]  # position 64 -> block 2: unallocated, the write drops
    bt[3, :7] = [0, 2, 4, 6, 10, 14, 16]
    tokens = np.asarray([7, 11, 13, 17], np.int32)
    active = np.asarray([True, True, True, False])
    jc, tc = _caches(6, P, lengths, fmt)
    lj, jc = jllama.decode_step_paged(jparams, jcfg, jnp.asarray(tokens), jc, jnp.asarray(bt),
                                      active=jnp.asarray(active), attn_fp8=attn_fp8)
    lt, tc = llama.decode_step_paged(params, cfg, _t(tokens), tc, _t(bt), active=_t(active),
                                     attn_fp8=attn_fp8)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=LOGITS_ATOL, rtol=0)
    _assert_pools_match(jc, tc)


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2", "bf16"])
def test_prefill_suffix_paged_on_narrow_pools_matches_jax(models, fmt):
    """Rows continue from prefixes of 40, 64 and 100 tokens over shared
    narrow pages, one batch-pad row: logits within 1e-4, pools equal
    (:func:`_assert_pools_match`)."""
    jcfg, jparams, cfg, params = models
    P = 24
    jc, tc = _caches(3, P, np.zeros((4,), np.int32), fmt)
    bt = np.full((4, NB), P, np.int32)
    bt[1, :3] = [4, 10, 11]
    bt[2, :3] = [2, 3, 12]
    bt[3, :5] = [4, 1, 6, 13, 14]
    slots = np.asarray([4, 0, 1, 3], np.int32)  # row 0: batch pad
    starts = np.asarray([0, 40, 64, 100], np.int32)
    valids = np.asarray([0, 20, 32, 9], np.int32)
    ids = np.random.default_rng(4).integers(1, 255, (4, 32)).astype(np.int32)
    lj, jc = jllama.prefill_suffix_paged(jparams, jcfg, jnp.asarray(ids), jc, jnp.asarray(bt),
                                         jnp.asarray(slots), jnp.asarray(starts),
                                         jnp.asarray(valids))
    lt, tc = llama.prefill_suffix_paged(params, cfg, _t(ids), tc, _t(bt), _t(slots),
                                        _t(starts), _t(valids))
    np.testing.assert_allclose(lt[1:].numpy(), np.asarray(lj)[1:], atol=LOGITS_ATOL, rtol=0)
    _assert_pools_match(jc, tc)


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
def test_verify_and_commit_on_fp8_pools_match_jax(models, fmt):
    """The verify forward over fp8 prefix pages: logits within 1e-4 and the
    tree's K/V within 1e-5 of JAX's, the pool untouched; the commit of the
    port's tree K/V with drops (an inactive row, a row past its allocation)
    leaves every pool byte equal to JAX committing the same K/V (the same
    values cast: bit-equal)."""
    jcfg, jparams, cfg, params = models
    P = 30
    lengths = np.asarray([5, 30, 47, 93], np.int32)
    jc, tc = _caches(8, P, lengths, fmt)
    before = _bits(tc.k[:, :P].contiguous()).copy()
    bt = np.full((4, NB), P, np.int32)
    perm = np.random.default_rng(9).permutation(P)
    for b, n in enumerate(lengths):
        need = -(-(int(n) + 8) // PAGE)
        bt[b, :need] = perm[b * 7: b * 7 + need]
    bt[2, 1:] = P  # row 2 owns one page (32 positions): its writes past 31 drop
    spec = tspec.make_tree_spec(2, 3)
    tree = np.random.default_rng(10).integers(1, 255, (4, spec.size)).astype(np.int32)
    jl, jks, jvs = jllama.verify_tree_step_paged(
        jparams, jcfg, jnp.asarray(tree), jc, jnp.asarray(bt), jnp.asarray(spec.depths),
        jnp.asarray(spec.anc_mask))
    tl, tks, tvs = llama.verify_tree_step_paged(params, cfg, _t(tree), tc, _t(bt),
                                                _t(spec.depths), _t(spec.anc_mask))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGITS_ATOL, rtol=0)
    np.testing.assert_allclose(tks.numpy(), np.asarray(jks), atol=F32_ATOL, rtol=0)
    np.testing.assert_array_equal(_bits(tc.k[:, :P].contiguous()), before)  # read-only
    path = np.stack([np.r_[0, spec.branch_nodes[b % 2]] for b in range(4)]).astype(np.int32)
    n_commit = np.asarray([4, 2, 3, 4], np.int32)
    active = np.asarray([True, False, True, True])
    jc = jllama.commit_tree_path_paged(jc, jnp.asarray(tks.numpy()), jnp.asarray(tvs.numpy()),
                                       jnp.asarray(path), jnp.asarray(bt), jnp.asarray(n_commit),
                                       jnp.asarray(active))
    llama.commit_tree_path_paged(tc, tks, tvs, _t(path), _t(bt), _t(n_commit), _t(active))
    _assert_pools_match(jc, tc, strict=True)
    assert not np.array_equal(_bits(tc.k[:, :P].contiguous()), before)


# ------------------------------------------------------------ the engine
def _crank(eng, futs, limit=3000):
    for _ in range(limit):
        if all(f.done() for f in futs):
            return
        eng._loop_iteration()
    raise AssertionError("requests did not finish within the crank budget")


_KNOBS = [("fp8", False), ("fp8_e5m2", False), ("bf16", False), ("fp8", True)]
_KNOB_IDS = ["fp8", "fp8_e5m2", "bf16", "fp8-attn_fp8"]


def _engines(models, kv, attn_fp8, **kw):
    jcfg, jparams, cfg, params = models
    kw = dict(max_slots=4, max_seq_len=256, decode_kv_chunk=64, kv_cache_dtype=kv,
              attn_fp8=attn_fp8, **kw)
    jeng = JaxGenerationEngine(jcfg, jparams, JaxByteTokenizer(), kv_layout="paged",
                               scheduler=None, **kw)
    teng = GenerationEngine(cfg, params, ByteTokenizer(), device="cpu", **kw)
    return jeng, teng


def _mixed_trace(eng):
    """A prefix registered by a first request; a wave of a prefix hit and a
    plain request and, two iterations later, a prompt of three chunks that
    piggyback on the live wave's ticks; then a JSON request beside a plain
    one (single-step ticks while the JSON row lives)."""
    rng = np.random.default_rng(9)
    prefix = rng.integers(1, 255, 70).tolist()
    eng._running = True
    first = eng.submit(prefix + rng.integers(1, 255, 20).tolist(), max_tokens=8,
                       temperature=0.0, prefix_len=70)
    _crank(eng, [first])
    futs = [eng.submit(prefix + rng.integers(1, 255, 30).tolist(), max_tokens=12,
                       temperature=0.0, prefix_len=70),
            eng.submit(rng.integers(1, 255, 40).tolist(), max_tokens=24, temperature=0.0)]
    for _ in range(2):
        eng._loop_iteration()
    futs.append(eng.submit(rng.integers(1, 255, 150).tolist(), max_tokens=10,
                           temperature=0.0))
    _crank(eng, futs)
    late = [eng.submit(rng.integers(1, 255, 9).tolist(), max_tokens=20, temperature=0.0,
                       json_format=True),
            eng.submit(rng.integers(1, 255, 12).tolist(), max_tokens=16, temperature=0.0)]
    _crank(eng, late)
    eng._running = False
    return [f.result(timeout=0).token_ids for f in [first] + futs + late]


@pytest.mark.parametrize("kv,attn_fp8", _KNOBS, ids=_KNOB_IDS)
def test_engine_greedy_ids_equal_jax_engine(models, kv, attn_fp8):
    """The default loop (fused 4-step ticks, piggybacked chunks) with a
    prefix hit and a JSON row, on a narrow pool: the JAX engine's ids."""
    jeng, teng = _engines(models, kv, attn_fp8, chunk_size=64, decode_steps=4,
                          prefix_cache_size=8, prefix_min_tokens=16)
    want = _mixed_trace(jeng)
    got = _mixed_trace(teng)
    assert got == want
    st = teng.tick_stats()
    assert teng.prefix_hits == jeng.prefix_hits == 1
    assert st["prefill_chunks_piggybacked"] > 0 and st["json_downgraded_ticks"] > 0
    assert teng._cache.k.dtype == {"fp8": torch.float8_e4m3fn, "fp8_e5m2": torch.float8_e5m2,
                                   "bf16": torch.bfloat16}[kv]
    assert teng.decode_path_stats()["attn_fp8"] is attn_fp8
    assert teng._kv_pool.pages_free + teng._kv_pool.stats()["kv_shared_pages"] == \
        teng._kv_pool.n_pages


@pytest.mark.parametrize("kv,attn_fp8", _KNOBS, ids=_KNOB_IDS)
def test_spec_engine_greedy_ids_equal_jax_engine(models, kv, attn_fp8):
    """A speculative engine (K 3, N 2) on a narrow pool: the verify read
    and the commit of the accepted path through it give the JAX spec
    engine's ids and draft counters."""
    tok = ByteTokenizer()
    jobs = [tok.encode("ab ab ab ab ab ab"), tok.encode("the cat sat on the cat sat on"),
            tok.encode("xyz")]
    jeng, teng = _engines(models, kv, attn_fp8, chunk_size=64, speculative=3, spec_width=2,
                          spec_probe_every=1, prefix_cache_size=0, lookahead=1)
    out = []
    for eng in (jeng, teng):
        eng._running = True
        futs = [eng.submit(ids, max_tokens=16, temperature=0.0) for ids in jobs]
        _crank(eng, futs)
        out.append([f.result(timeout=0).token_ids for f in futs])
    assert out[1] == out[0]
    assert teng.spec_drafted == jeng.tick_stats()["spec_drafted"] > 0


# the JAX engine contracts (tests/test_contbatch.py:294-338)
def test_attn_fp8_engine_knob_validation(models):
    _, _, cfg, params = models
    with pytest.raises(ValueError, match="fp8"):
        GenerationEngine(cfg, params, ByteTokenizer(), device="cpu", attn_fp8=True)
    with pytest.raises(ValueError, match="fp8"):
        GenerationEngine(cfg, params, ByteTokenizer(), device="cpu", kv_cache_dtype="bf16",
                         attn_fp8=True)
    with pytest.raises(ValueError, match="attn_fp8"):
        ModelRegistry(specs={"m": ModelSpec(name="m", kind="decoder", tiny=True, device="cpu",
                                            attn_fp8=True)})
    with pytest.raises(ValueError, match="attn_fp8 requires an fp8 KV cache"):
        ModelSpec.from_dict("m", {"tiny": True, "attn_fp8": True, "kv_cache_dtype": "bf16"})


def test_attn_fp8_engine_end_to_end(models):
    """An fp8 in-dot engine serves a mixed batch (a greedy and a sampled
    row) and reports the knob; the lossy path is deterministic with itself
    (same seed, same crank, same ids)."""
    _, _, cfg, params = models

    def run():
        eng = GenerationEngine(cfg, params, ByteTokenizer(), device="cpu", max_slots=4,
                               max_seq_len=256, chunk_size=64, kv_cache_dtype="fp8",
                               attn_fp8=True)
        eng._running = True
        futs = [eng.submit(list(range(2, 14)), max_tokens=12, temperature=0.0),
                eng.submit(list(range(30, 130)), max_tokens=6, temperature=0.9)]
        _crank(eng, futs)
        return [f.result(timeout=0).token_ids for f in futs], eng.decode_path_stats()

    a, dec = run()
    b, _ = run()
    assert a == b
    assert dec["attn_fp8"] is True
    assert all(len(ids) >= 1 for ids in a)


# the JAX serving contracts (tests/test_serving.py:903-990)
def test_engine_fp8_kv_cache_serves(models):
    """An fp8 pool halves the KV bytes, serves a prefix hit, keeps the first
    greedy token of the model-dtype pool, and one decode step's logits from
    identical prefills track the model-dtype pool's (cosine > 0.98)."""
    _, _, cfg, params = models
    tok = ByteTokenizer()
    msgs = [{"role": "system", "content": "shared system preamble for the cache"},
            {"role": "user", "content": "tell me about tpus"}]

    def run(kv):
        eng = GenerationEngine(cfg, params, tok, device="cpu", max_slots=2, max_seq_len=128,
                               prefix_cache_size=4, prefix_min_tokens=8,
                               kv_cache_dtype=kv).start()
        try:
            outs = [asyncio.run(eng.generate(msgs, max_tokens=6, temperature=0.0)).token_ids
                    for _ in range(2)]  # the second request hits the fp8 prefix
            return outs, eng._cache.k.dtype, eng.prefix_hits, eng._kv_pool.page_bytes
        finally:
            eng.stop()

    base, dt_b, _, bytes_b = run(None)
    got, dt_q, hits, bytes_q = run("fp8")
    assert dt_b == cfg.dtype and dt_q == torch.float8_e4m3fn
    assert bytes_q * 4 == bytes_b  # f32 model: 4 bytes a value -> 1
    assert hits >= 1
    assert all(len(o) == 6 for o in got)
    assert [o[0] for o in got] == [b[0] for b in base]

    ids = torch.tensor([tok.encode("check fp8 kv cache closeness")], dtype=torch.int32)
    n = ids.shape[1]
    _, ks, vs = llama.prefill(params, cfg, ids, torch.tensor([n], dtype=torch.int32))
    outs = {}
    for dt in (None, torch.float8_e4m3fn):
        cache = llama.init_paged_cache(cfg, 1, 4, 16, dtype=dt)
        bt = torch.tensor([[0, 1, 2, 3]], dtype=torch.int32)
        llama.insert_sequences_paged(cache, ks, vs, torch.tensor([n], dtype=torch.int32),
                                     torch.tensor([0], dtype=torch.int32), bt)
        step, _ = llama.decode_step_paged(params, cfg, torch.tensor([5], dtype=torch.int32),
                                          cache, bt)
        outs[dt] = step[0].numpy()
    a, b = outs[None], outs[torch.float8_e4m3fn]
    cos = float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)))
    assert cos > 0.98, cos


def test_kv_cache_dtype_validation(models):
    """A bad kv_cache_dtype fails before any weight load, an encoder's is
    refused as decoder-only, and "bf16" is bfloat16 even on the f32 tiny
    model (not an alias of the model dtype)."""
    reg = ModelRegistry()
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        reg.load(ModelSpec(name="bad", kind="decoder", tiny=True, device="cpu",
                           kv_cache_dtype="fp16"))
    with pytest.raises(ValueError, match="decoder-only"):
        reg.load(ModelSpec(name="enc", kind="encoder", tiny=True, device="cpu",
                           kv_cache_dtype="fp8"))
    _, _, cfg, params = models
    eng = GenerationEngine(cfg, params, ByteTokenizer(), device="cpu", max_slots=2,
                           max_seq_len=64, kv_cache_dtype="bf16")
    assert eng._cache.k.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        GenerationEngine(cfg, params, ByteTokenizer(), device="cpu", max_slots=2,
                         max_seq_len=64, kv_cache_dtype="fp16")


def test_registry_serves_an_fp8_spec():
    """``ModelSpec(kv_cache_dtype="fp8", attn_fp8=True)`` through the
    registry: the engine's pool is e4m3 and its decode reads in-dot."""
    spec = ModelSpec.from_dict("m", {"tiny": True, "device": "cpu", "kv_cache_dtype": "fp8",
                                     "attn_fp8": True, "max_seq_len": 128})
    reg = ModelRegistry({"m": spec})
    try:
        eng = reg.get_generator("m")
        assert eng._cache.k.dtype == torch.float8_e4m3fn
        assert eng.decode_path_stats()["attn_fp8"] is True
        r = asyncio.run(eng.generate([{"role": "user", "content": "hi"}], max_tokens=4,
                                     temperature=0.0))
        assert 1 <= len(r.token_ids) <= 4
    finally:
        reg.stop()
