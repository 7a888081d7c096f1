"""Prefix sharing with copy-on-write pages: the port against the JAX package
(CPU, tiny geometry, f32, weights bridged through ``convert.params_from_jax``).

- Allocator: the scenarios of tests/test_kv_paging.py (alloc/free, refcounts,
  LRU eviction under the byte budget, on-demand eviction, pinned pages
  spared, atomic failure, longest match) and its property fuzz, each run as
  one operation sequence against the JAX ``PageAllocator`` and the port's:
  equal pages, hits and stats at every step.
- Model: ``copy_pages`` and ``prefill_suffix_paged`` against the JAX
  functions on the same pools (logits within 1e-4, written blocks within
  1e-5, shared prefix pages bitwise untouched).
- Engine: greedy ids equal to the JAX engine's and to the port's own
  ``prefix_cache_size=0`` run for a hit with a COW boundary, a page-aligned
  hit, a chunked remainder after a hit and a multi-turn longest match, with
  the hit / COW / shared-page counters equal to the JAX engine's; a sharer
  survives another's free; the pool returns to the registry's pages; a hit
  that blocks allocation falls back to a full prefill; shared pages are
  byte-identical across a suffix wave, a chunked continuation and decode
  ticks; a restart clears the registry; the kv gauges reach ``/healthz``.
"""

import asyncio
import os
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from django_assistant_bot_tpu.models import DecoderConfig as JaxDecoderConfig
from django_assistant_bot_tpu.models import llama as jllama
from django_assistant_bot_tpu.serving import ByteTokenizer as JaxByteTokenizer
from django_assistant_bot_tpu.serving import GenerationEngine as JaxGenerationEngine
from django_assistant_bot_tpu.serving.kv_pool import PageAllocator as JaxPageAllocator
from django_assistant_bot_tpu_torch.convert import params_from_jax
from django_assistant_bot_tpu_torch.models import DecoderConfig, llama
from django_assistant_bot_tpu_torch.serving import ByteTokenizer, GenerationEngine, ModelSpec
from django_assistant_bot_tpu_torch.serving.kv_pool import PageAllocator


@pytest.fixture(autouse=True)
def flight_dir(tmp_path, monkeypatch):
    """Flight-recorder dumps of the restart case go to the test's own
    directory."""
    monkeypatch.setenv("DABT_FLIGHT_DIR", str(tmp_path))


# --------------------------------------------------------------- allocator
def _stats(al):
    st = al.stats()
    return {k: v for k, v in st.items() if k.startswith("kv_")}


def _alloc_roundtrip(A):
    al = A(8, 64)
    a, b = al.alloc(3), al.alloc(5)
    assert sorted(a + b) == list(range(8))
    trace = [a, b, al.alloc(1)]  # exhausted: None, nothing allocated
    al.decref(a)
    c = al.alloc(3)
    assert sorted(c) == sorted(a)
    return trace + [c, al.pages_free, _stats(al)]


def _refcounts_survive_owner(A):
    al = A(8, 64, max_shared_entries=4)
    pages = al.alloc(2)
    trace = [pages, al.register([1] * 100, 100, pages)]
    al.decref(pages)  # the owner frees; the registry keeps its refs
    hit = al.lookup([1] * 120, 100)
    assert hit.length == 100 and hit.full_pages == 1 and al.pages_free == 6
    trace += [al.pages_free, hit.pages, hit.length, hit.full_pages, _stats(al)]
    al.reset()
    return trace + [al.pages_free, _stats(al)]


def _lru_byte_budget(A):
    al = A(8, 64, page_bytes=10, max_shared_bytes=25, max_shared_entries=8,
           min_prefix_tokens=1)
    trace = []
    for i in range(3):
        p = al.alloc(1)
        trace += [p, al.register([i] * 40, 40, p)]
    assert al.evictions == 1
    assert al.lookup([0] * 50, 40) is None and al.lookup([2] * 50, 40) is not None
    return trace + [al.lookup([1] * 50, 40).pages, _stats(al)]


def _on_demand_eviction(A):
    al = A(4, 64, max_shared_entries=8, min_prefix_tokens=1)
    p = al.alloc(2)
    trace = [p, al.register([9] * 80, 80, p)]
    al.decref(p)
    assert al.pages_free == 2 and al.available() == 4
    got = al.alloc(4)  # forces the entry out
    assert got is not None and al.evictions == 1 and al.lookup([9] * 90, 80) is None
    return trace + [got, al.available(), _stats(al)]


def _pinned_pages_spared(A):
    al = A(6, 64, max_shared_entries=4, min_prefix_tokens=1)
    p = al.alloc(2)
    al.register([7] * 80, 80, p)
    al.decref(p)
    held = al.alloc(3)
    hit = al.lookup([7] * 100, 80)
    al.incref(hit.pages)  # the pin taken before alloc
    assert al.alloc(2) is None and al.evictions == 1  # evicted, but pinned pages stay
    with al._lock:
        assert all(page in al._refs for page in hit.pages)
    trace = [held, hit.pages, _stats(al)]
    al.decref(list(hit.pages))
    got = al.alloc(2)
    assert set(got) >= set(hit.pages) - set(held)
    al.decref(got)
    al.decref(held)
    return trace + [got, al.pages_free, _stats(al)]


def _out_of_pages_atomic(A):
    al = A(4, 64)
    held = al.alloc(3)
    assert al.alloc(2) is None and al.pages_free == 1
    al.decref(held)
    return [held, al.pages_free, _stats(al)]


def _longest_match(A):
    al = A(16, 4, max_shared_entries=8, min_prefix_tokens=1)
    short, long_pages = al.alloc(1), al.alloc(2)
    al.register([1, 2, 3], 3, short)
    al.register([1, 2, 3, 4, 5], 5, long_pages)
    a = al.lookup([1, 2, 3, 4, 5, 6, 7], 5)
    b = al.lookup([1, 2, 3, 9, 9], 3)
    assert (a.length, b.length) == (5, 3)
    return [a.pages, b.pages, al.shared_keys(), _stats(al)]


def _fuzz(A):
    """The pinned-seed fuzz of tests/test_kv_paging.py (seed overridable by
    DABT_KV_FUZZ_SEED): random alloc / decref / register / lookup traffic
    keeps the invariants; every result goes into the trace."""
    rng = random.Random(int(os.environ.get("DABT_KV_FUZZ_SEED", "0")))
    al = A(32, 16, page_bytes=7, max_shared_bytes=70, max_shared_entries=5,
           min_prefix_tokens=1)
    held, trace = [], []
    for _ in range(2000):
        op = rng.random()
        if op < 0.4:
            n = rng.randint(1, 6)
            got = al.alloc(n)
            if got is None:
                assert al.pages_free < n
            else:
                held.append(got)
            trace.append(got)
        elif op < 0.7 and held:
            al.decref(held.pop(rng.randrange(len(held))))
        elif op < 0.85 and held:
            pages = held[rng.randrange(len(held))]
            toks = rng.randrange(1 << 20)
            length = len(pages) * al.page_size - rng.randint(0, al.page_size - 1)
            trace.append(al.register([toks] * length, length, pages))
        else:
            hit = al.lookup([rng.randrange(4)] * rng.randint(1, 40), 8)
            trace.append(None if hit is None else hit.pages)
        free = al.pages_free
        with al._lock:
            refd, free_set = set(al._refs), set(al._free)
        assert not (refd & free_set) and len(free_set) == free
        assert len(refd) + free == al.n_pages
        assert all(p in refd for pages in held for p in pages)
        trace.append((free, al.available(), al.evictions))
    for pages in held:
        al.decref(pages)
    return trace + [_stats(al)]


@pytest.mark.parametrize("scenario", [
    _alloc_roundtrip, _refcounts_survive_owner, _lru_byte_budget, _on_demand_eviction,
    _pinned_pages_spared, _out_of_pages_atomic, _longest_match, _fuzz,
], ids=lambda f: f.__name__.strip("_"))
def test_allocator_matches_jax_allocator(scenario):
    assert scenario(PageAllocator) == scenario(JaxPageAllocator)


# ------------------------------------------------------------------- model
def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def models():
    jcfg = JaxDecoderConfig.tiny()
    jparams = jllama.init(jcfg, jax.random.key(2))
    cfg = DecoderConfig.tiny()
    return jcfg, jparams, cfg, params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")


L, KH, D, PAGE, NB = 2, 2, 16, 32, 8  # tiny geometry, S = 256


def _caches(seed, P, lengths):
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(L, P, KH, PAGE, D)).astype(np.float32)
    v = rng.normal(size=(L, P, KH, PAGE, D)).astype(np.float32)
    jc = jllama.PagedKVCache(k=jnp.asarray(k), v=jnp.asarray(v), lengths=jnp.asarray(lengths))
    dump = np.full((L, 1, KH, PAGE, D), np.nan, np.float32)
    tc = llama.PagedKVCache(k=_t(np.concatenate([k, dump], 1)),
                            v=_t(np.concatenate([v, dump], 1)), lengths=_t(lengths))
    return k, jc, tc


def test_copy_pages_matches_jax():
    P = 12
    k, jc, tc = _caches(1, P, np.zeros((4,), np.int32))
    src, dst = np.asarray([3, 7, 0], np.int32), np.asarray([5, P, 9], np.int32)  # P drops
    jc = jllama.copy_pages(jc, jnp.asarray(src), jnp.asarray(dst))
    llama.copy_pages(tc, _t(src), _t(dst))
    np.testing.assert_array_equal(tc.k[:, :P].numpy(), np.asarray(jc.k))
    np.testing.assert_array_equal(tc.v[:, :P].numpy(), np.asarray(jc.v))
    np.testing.assert_array_equal(tc.k[:, 5].numpy(), k[:, 3])


def test_prefill_suffix_paged_matches_jax(models):
    """Three rows continue from prefixes of 40, 64 and 100 tokens (row 0 and
    row 2 share pages 4 and 1; the boundary pages are private clones), one
    batch-pad row; a 32-token bucket with ragged valids.  Logits within
    1e-4, written blocks within 1e-5, the shared pages and every page
    outside the write windows bitwise untouched."""
    jcfg, jparams, cfg, params = models
    P = 24
    lengths = np.zeros((4,), np.int32)
    k, jc, tc = _caches(3, P, lengths)
    bt = np.full((4, NB), P, np.int32)
    bt[1, :3] = [4, 10, 11]  # prefix 40: page 4 shared, 10 the boundary clone
    bt[2, :3] = [2, 3, 12]  # prefix 64: page-aligned, both pages its own
    bt[3, :5] = [4, 1, 6, 13, 14]  # prefix 100: pages 4, 1, 6 full, 13 the boundary
    slots = np.asarray([4, 0, 1, 3], np.int32)  # row 0: batch pad
    starts = np.asarray([0, 40, 64, 100], np.int32)
    valids = np.asarray([0, 20, 32, 9], np.int32)
    ids = np.random.default_rng(4).integers(1, 255, (4, 32)).astype(np.int32)
    lj, jc = jllama.prefill_suffix_paged(
        jparams, jcfg, jnp.asarray(ids), jc, jnp.asarray(bt), jnp.asarray(slots),
        jnp.asarray(starts), jnp.asarray(valids),
    )
    lt, tc = llama.prefill_suffix_paged(params, cfg, _t(ids), tc, _t(bt), _t(slots),
                                        _t(starts), _t(valids))
    np.testing.assert_allclose(lt[1:].numpy(), np.asarray(lj)[1:], atol=1e-4)
    for jp, tp in ((jc.k, tc.k), (jc.v, tc.v)):
        np.testing.assert_allclose(tp[:, :P].numpy(), np.asarray(jp), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
    assert tc.lengths.tolist() == [60, 96, 0, 109]
    written = {10, 11, 3, 12, 13}  # blocks overlapping [start, start + valid)
    untouched = sorted(set(range(P)) - written)
    np.testing.assert_array_equal(tc.k[:, untouched].numpy(), k[:, untouched])
    np.testing.assert_array_equal(tc.k[:, [4, 1, 6, 2]].numpy(), k[:, [4, 1, 6, 2]])


# ------------------------------------------------------------------ engine
def _crank(eng, futs, limit=3000):
    for _ in range(limit):
        if all(f.done() for f in futs):
            return
        eng._loop_iteration()
    raise AssertionError("requests did not finish within the crank budget")


def _engine(kind, models, prefix_cache, **kw):
    jcfg, jparams, cfg, params = models
    kw = dict(max_slots=4, max_seq_len=256, decode_kv_chunk=64, prefix_cache_size=prefix_cache,
              prefix_min_tokens=16, **kw)
    if kind == "jax":
        eng = JaxGenerationEngine(jcfg, jparams, JaxByteTokenizer(), kv_layout="paged",
                                  scheduler=None, **kw)
    else:
        eng = GenerationEngine(cfg, params, ByteTokenizer(), device="cpu", **kw)
    eng._running = True
    return eng


def _serial(eng, requests, max_tokens=8):
    """Each (prompt, prefix_len) run to completion before the next is
    submitted (so the first registers and later ones hit)."""
    out = []
    for prompt, plen in requests:
        f = eng.submit(prompt, max_tokens=max_tokens, temperature=0.0, prefix_len=plen)
        _crank(eng, [f])
        out.append(f.result(timeout=0).token_ids)
    return out


_COUNTERS = ("prefix_hits", "prefix_misses", "kv_cow_copies", "kv_shared_pages",
             "kv_shared_entries", "kv_pages_used", "kv_evictions")


def _traffic(case):
    rng = np.random.default_rng(9)
    if case == "multi_turn":
        # turn N's prompt extends turn N-1's [system, history] block: the
        # longest registered prefix wins, and the longer split registers
        system = rng.integers(1, 255, 40).tolist()
        turns, hist = [], list(system)
        for _ in range(3):
            user, answer = rng.integers(1, 255, 12).tolist(), rng.integers(1, 255, 15).tolist()
            turns.append((hist + user, len(hist)))
            hist = hist + user + answer
        return dict(chunk_size=512), turns
    n_prefix, chunk, suffixes = {
        "cow_boundary": (70, 512, (20, 30, 9)),
        "page_aligned": (128, 512, (20, 33)),
        "chunked_after_hit": (70, 64, (20, 100, 90)),
    }[case]
    prefix = rng.integers(1, 255, n_prefix).tolist()
    return dict(chunk_size=chunk), [(prefix + rng.integers(1, 255, n).tolist(), n_prefix)
                                    for n in suffixes]


@pytest.mark.parametrize("case", ["cow_boundary", "page_aligned", "chunked_after_hit",
                                  "multi_turn"])
def test_prefix_sharing_ids_equal_jax_and_uncached(models, case):
    kw, requests = _traffic(case)
    jeng, teng = _engine("jax", models, 8, **kw), _engine("torch", models, 8, **kw)
    want = _serial(jeng, requests)
    got = _serial(teng, requests)
    cold = _serial(_engine("torch", models, 0, **kw), requests)
    assert got == want == cold
    jst, tst = jeng.kv_stats(), teng.kv_stats()
    assert {k: tst[k] for k in _COUNTERS} == {k: jst[k] for k in _COUNTERS}
    hits = len(requests) - 1
    assert tst["prefix_hits"] == hits
    cow = {"cow_boundary": hits, "page_aligned": 0, "chunked_after_hit": hits,
           "multi_turn": hits}[case]
    assert tst["kv_cow_copies"] == cow
    if case == "chunked_after_hit":
        assert teng.decode_path_stats()["prefill_chunks_piggybacked"] == 0  # serial traffic
    if case == "multi_turn":
        assert tst["kv_shared_entries"] == len(requests)  # every turn's split registered


def test_sharer_survives_another_freeing(models):
    """One sharer finishes and frees its pages while another keeps decoding
    over the same shared pages: its ids stay those of the uncached run."""
    rng = np.random.default_rng(10)
    prefix = rng.integers(1, 255, 70).tolist()
    p_long = prefix + rng.integers(1, 255, 20).tolist()
    p_short = prefix + rng.integers(1, 255, 20).tolist()
    (ref,) = _serial(_engine("torch", models, 0), [(p_long, 70)], max_tokens=24)
    eng = _engine("torch", models, 8)
    _serial(eng, [(p_long[:71], 70)], max_tokens=2)  # registers the prefix
    f_long = eng.submit(p_long, max_tokens=24, temperature=0.0, prefix_len=70)
    f_short = eng.submit(p_short, max_tokens=2, temperature=0.0, prefix_len=70)
    _crank(eng, [f_short])
    assert not f_long.done()
    _crank(eng, [f_long])
    assert f_long.result(timeout=0).token_ids == ref
    assert eng.kv_stats()["prefix_hits"] == 2 and eng.kv_stats()["kv_pages_free"] > 0


def test_pool_accounting_returns_to_registry_pages(models):
    """After every request finishes only registry-held pages stay out of the
    free list (none with the cache off): no leak from admit, finish or reap."""
    rng = np.random.default_rng(11)
    prefix = rng.integers(1, 255, 70).tolist()
    prompts = [prefix + rng.integers(1, 255, n).tolist() for n in (5, 30, 12, 60, 7, 40)]
    for cache in (8, 0):
        eng = _engine("torch", models, cache, chunk_size=64)
        _serial(eng, [(prompts[0], 70)])
        futs = [eng.submit(p, max_tokens=5, temperature=0.0, prefix_len=70) for p in prompts[1:]]
        _crank(eng, futs)
        st = eng.kv_stats()
        assert st["kv_pages_used"] == st["kv_shared_pages"] == (2 if cache else 0)
        assert st["prefix_hits"] == (5 if cache else 0)


def test_hit_that_blocks_alloc_falls_back_to_full_prefill(models):
    """The hit's pinned pages are exactly what eviction would need (4 pages
    in all): admission drops the hit, evicts the entry and prefills in full;
    ids equal the uncached run's and the JAX engine's."""
    rng = np.random.default_rng(14)
    prefix = rng.integers(1, 255, 150).tolist()  # 2 full pages of 64 + 1 partial
    requests = [(prefix + rng.integers(1, 255, 20).tolist(), 150),  # demand 3 pages
                (prefix + rng.integers(1, 255, 60).tolist(), 150)]  # demand 4 pages
    jeng = _engine("jax", models, 8, kv_pages=4)
    teng = _engine("torch", models, 8, kv_pages=4)
    cold = _serial(_engine("torch", models, 0, kv_pages=4), requests)
    assert _serial(teng, requests) == _serial(jeng, requests) == cold
    assert teng.kv_stats()["kv_evictions"] >= 1
    assert {k: teng.kv_stats()[k] for k in _COUNTERS} == {k: jeng.kv_stats()[k] for k in _COUNTERS}


def _pages_of_registry(eng):
    pages = sorted({p for _, ent in eng._kv_pool.shared_entries() for p in ent.pages})
    return pages, eng._cache.k[:, pages].clone(), eng._cache.v[:, pages].clone()


def test_shared_pages_byte_identical_across_sharing(models):
    """Once the head is registered, its pages (the boundary page included)
    are never written again: a suffix wave of three hits, a chunked
    continuation after a hit and the decode ticks that follow leave them
    byte-identical."""
    rng = np.random.default_rng(12)
    prefix = rng.integers(1, 255, 90).tolist()  # page 64: one full page + a boundary
    eng = _engine("torch", models, 8, chunk_size=64)
    _serial(eng, [(prefix + [5, 6, 7], 90)])
    pages, k0, v0 = _pages_of_registry(eng)
    assert len(pages) == 2
    wave = [prefix + rng.integers(1, 255, n).tolist() for n in (10, 25, 40)]
    futs = [eng.submit(p, max_tokens=20, temperature=0.0, prefix_len=90) for p in wave]
    futs.append(eng.submit(prefix + rng.integers(1, 255, 150).tolist(), max_tokens=20,
                           temperature=0.0, prefix_len=90))  # chunks from 90
    _crank(eng, futs)
    st = eng.kv_stats()
    assert st["prefix_hits"] == 4 and st["kv_cow_copies"] == 4
    assert eng.decode_path_stats()["prefill_chunks_piggybacked"] > 0
    _, k1, v1 = _pages_of_registry(eng)
    assert torch.equal(k0, k1) and torch.equal(v0, v1)


@pytest.mark.parametrize("kind", ["jax", "torch"])
def test_restart_clears_registry(models, kind):
    """Crash-only restart: every page free, registry empty, block tables
    unallocated, and the engine still serves (tests/test_kv_paging.py's
    contract, on both engines)."""
    rng = np.random.default_rng(12)
    prefix = rng.integers(1, 255, 70).tolist()
    eng = _engine(kind, models, 8)
    _serial(eng, [(prefix + [5, 6, 7], 70)], max_tokens=3)
    assert eng.kv_stats()["kv_shared_pages"] > 0
    with eng._iter_lock:
        eng._restart(RuntimeError("injected"))
    st = eng.kv_stats()
    assert st["kv_pages_used"] == 0 and st["kv_shared_pages"] == 0
    assert np.all(eng._block_tables == eng._kv_sentinel)
    assert eng.engine_restarts == 1
    assert len(_serial(eng, [([1, 2, 3], 0)], max_tokens=3)[0]) == 3


def test_reset_rebuilds_an_idle_engine(models):
    """``reset`` (the rebuild a restart runs) on an idle engine: the pool
    and registry empty, block tables and the KV cache cleared, no restart
    counted, and the same request gives the same greedy ids again (a miss
    that registers its head anew).  With a request on a slot it refuses."""
    rng = np.random.default_rng(13)
    req = (rng.integers(1, 255, 70).tolist() + [5, 6, 7], 70)
    eng = _engine("torch", models, 8)
    first = _serial(eng, [req], max_tokens=4)
    assert eng.kv_stats()["kv_shared_pages"] > 0
    eng.reset()
    st = eng.kv_stats()
    assert st["kv_pages_used"] == 0 and st["kv_shared_pages"] == 0
    assert np.all(eng._block_tables == eng._kv_sentinel)
    assert not eng._cache.k.any() and not eng._cache.lengths.any()
    assert eng.engine_restarts == 0
    hits = st["prefix_hits"]
    assert _serial(eng, [req], max_tokens=4) == first
    assert eng.kv_stats()["prefix_hits"] == hits and eng.kv_stats()["kv_shared_pages"] > 0
    eng._slots[0] = object()
    with pytest.raises(RuntimeError, match="no request"):
        eng.reset()


def test_spec_prefix_knobs_and_kv_gauges_on_healthz():
    """``prefix_cache`` / ``prefix_min_tokens`` / ``prefix_cache_max_bytes``
    take the JAX defaults, the deprecated ``prefix_cache_size`` maps onto
    ``prefix_cache``, and ``/healthz`` and ``tick_stats`` carry the kv
    gauges (tests/test_kv_paging.py:701-750)."""
    from aiohttp.test_utils import TestClient, TestServer

    from django_assistant_bot_tpu.serving.registry import ModelSpec as JaxModelSpec
    from django_assistant_bot_tpu_torch.serving import ModelRegistry
    from django_assistant_bot_tpu_torch.serving.server import create_app

    jspec = JaxModelSpec(name="m", kind="decoder")
    keys = ("prefix_cache", "prefix_min_tokens", "prefix_cache_max_bytes")
    assert {k: getattr(ModelSpec(name="m"), k) for k in keys} == {k: getattr(jspec, k) for k in keys}
    assert ModelSpec.from_dict("m", {"tiny": True, "prefix_cache_size": 3}).prefix_cache == 3
    assert ModelSpec.from_dict(
        "m", {"tiny": True, "prefix_cache_size": 3, "prefix_cache": 5}).prefix_cache == 5
    registry = ModelRegistry.from_config(
        {"tiny-chat": {"tiny": True, "max_slots": 2, "max_seq_len": 256}}, device="cpu")

    async def drive():
        client = TestClient(TestServer(create_app(registry)))
        await client.start_server()
        try:
            body = await (await client.get("/healthz")).json()
            return body["generators"]["tiny-chat"]["kv"]
        finally:
            await client.close()

    try:
        kv = asyncio.new_event_loop().run_until_complete(drive())
        assert kv["kv_layout"] == "paged"
        for key in ("kv_pages_used", "kv_pages_free", "kv_shared_page_frac", "kv_evictions",
                    "kv_cow_copies", "prefix_hits", "prefix_misses"):
            assert key in kv
        eng = registry.get_generator("tiny-chat")
        assert eng.prefix_cache_size == 8 and eng.tick_stats()["kv"]["kv_layout"] == "paged"
    finally:
        registry.stop()
