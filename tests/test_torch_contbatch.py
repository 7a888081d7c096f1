"""The port's default decode loop on the CPU, tiny geometry: fused
``decode_steps``-step ticks and chunked prefill piggybacked into them.

- Greedy ids equal the JAX ``GenerationEngine``'s at ``decode_steps`` 1 and
  4, piggyback off and on, with prompts past ``chunk_size`` (the contracts
  of tests/test_decode_fused.py and tests/test_contbatch.py), same weights
  through ``params_from_jax``; both engines are cranked by
  ``_loop_iteration`` alone, so their waves and ticks line up.
- Sampled ids do not depend on ``decode_steps`` (each step's noise is one
  generator draw, in step order, as at ``decode_steps=1``).
- A request whose ``max_tokens`` ends mid-tick leaves every other slot's
  output unchanged, returns all its pages, and its writes past its
  reservation land in the dump page.
- ``prefill_displacement_frac`` is 0 with piggyback on and above 0 with it
  off, on the same trace, with the same ids.
"""

import numpy as np
import pytest
import torch

import jax

from django_assistant_bot_tpu.models import DecoderConfig as JaxDecoderConfig
from django_assistant_bot_tpu.models import llama as jllama
from django_assistant_bot_tpu.serving import ByteTokenizer as JaxByteTokenizer
from django_assistant_bot_tpu.serving import GenerationEngine as JaxGenerationEngine
from django_assistant_bot_tpu_torch.convert import params_from_jax
from django_assistant_bot_tpu_torch.models import DecoderConfig
from django_assistant_bot_tpu_torch.serving import ByteTokenizer, GenerationEngine


@pytest.fixture(scope="module")
def tiny_models():
    jcfg = JaxDecoderConfig.tiny()
    jparams = jllama.init(jcfg, jax.random.key(0))
    cfg = DecoderConfig.tiny()
    return jcfg, jparams, cfg, params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")


def _crank(eng, futs, limit=2000):
    """Run the engine loop body single-threaded until ``futs`` resolve."""
    for _ in range(limit):
        if all(f.done() for f in futs):
            return
        eng._loop_iteration()
    raise AssertionError("requests did not finish within the crank budget")


def _trace(eng, early, late, *, temperature=0.0, max_tokens=10, cranks=2):
    """``early`` prompts queued up front, ``late`` ones after ``cranks``
    iterations (so a long prompt chunks while a batch is live); returns every
    request's ids and the engine's decode-path gauges."""
    eng._running = True
    futs = [eng.submit(p, max_tokens=max_tokens, temperature=temperature) for p in early]
    for _ in range(cranks):
        eng._loop_iteration()
    futs += [eng.submit(p, max_tokens=max_tokens, temperature=temperature) for p in late]
    _crank(eng, futs)
    eng._running = False
    return [f.result(timeout=0).token_ids for f in futs], eng.decode_path_stats()


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 255, n).tolist() for n in lengths]


@pytest.mark.parametrize("piggyback", [False, True], ids=["sequential", "piggyback"])
@pytest.mark.parametrize("decode_steps", [1, 4])
def test_default_loop_token_identical_to_jax_engine(tiny_models, decode_steps, piggyback):
    jcfg, jparams, cfg, params = tiny_models
    early = _prompts(3, (9, 40, 20))
    late = _prompts(4, (150, 70))  # three and two chunks of 64
    kw = dict(max_slots=4, max_seq_len=256, chunk_size=64, decode_steps=decode_steps,
              prefill_piggyback=piggyback)
    jeng = JaxGenerationEngine(
        jcfg, jparams, JaxByteTokenizer(), kv_layout="paged", scheduler=None,
        prefix_cache_size=0, **kw,
    )
    teng = GenerationEngine(cfg, params, ByteTokenizer(), device="cpu", **kw)
    want, jdec = _trace(jeng, early, late)
    got, tdec = _trace(teng, early, late)
    assert got == want
    for key in ("prefill_chunks_piggybacked", "prefill_displacement_frac"):
        assert tdec[key] == jdec[key], key
    assert (tdec["prefill_chunks_piggybacked"] > 0) == piggyback
    assert tdec["decode_steps_effective"] == decode_steps
    assert teng._kv_pool.pages_free == teng._kv_pool.n_pages


def test_sampled_ids_identical_across_decode_steps(tiny_models):
    """The port's form of tests/test_decode_fused.py's "same split chain,
    same ids": one wave, sampled and greedy rows, decode_steps 1 and 4."""
    _, _, cfg, params = tiny_models
    prompts = _prompts(9, (3, 17, 40, 9))
    temps = [0.8, 0.0, 0.7, 1.0]

    def run(decode_steps):
        eng = GenerationEngine(cfg, params, ByteTokenizer(), device="cpu", max_slots=4,
                               max_seq_len=256, decode_steps=decode_steps)
        eng._running = True
        futs = [eng.submit(p, max_tokens=12, temperature=t, top_p=0.9)
                for p, t in zip(prompts, temps)]
        _crank(eng, futs)
        return [f.result(timeout=0).token_ids for f in futs]

    one, four = run(1), run(4)
    assert one == four
    assert all(len(ids) == 12 for ids in one)


def test_max_tokens_ending_mid_tick_leaves_other_slots_unchanged(tiny_models):
    """Request A's ``max_tokens`` ends inside a fused tick (8 steps, page 16,
    a reservation of one page): its later steps, and the ticks issued before
    its finish was seen, write past its reservation into the dump page; B
    and C decode exactly as without A, and every page comes back."""
    _, _, cfg, params = tiny_models
    a, b, c = _prompts(11, (10, 30, 21))

    def run(prompts, max_tokens):
        eng = GenerationEngine(cfg, params, ByteTokenizer(), device="cpu", max_slots=3,
                               max_seq_len=128, kv_page_size=16, decode_steps=8)
        eng._running = True
        futs = [eng.submit(p, max_tokens=m, temperature=0.0) for p, m in zip(prompts, max_tokens)]
        _crank(eng, futs)
        return [f.result(timeout=0).token_ids for f in futs], eng

    (ids_a, ids_b, ids_c), eng = run([a, b, c], [6, 40, 33])
    (alone_b, alone_c), _ = run([b, c], [40, 33])
    (long_a,), _ = run([a], [40])
    assert (ids_b, ids_c) == (alone_b, alone_c)
    assert ids_a == long_a[:6]
    assert eng._kv_pool.pages_free == eng._kv_pool.n_pages
    dump = eng._kv_pool.n_pages
    assert eng._cache.k[:, dump].abs().sum() > 0  # A's writes past its page


def test_prefill_displacement_zero_with_piggyback_on(tiny_models):
    """One short request decodes while a five-chunk prompt prefills: with
    piggyback on every chunk that meets a live batch rides its tick (the
    final chunk meets none), with it off those chunks displace ticks; the
    ids are the same."""
    _, _, cfg, params = tiny_models
    short, long_ = _prompts(5, (12, 300))

    def run(piggyback):
        eng = GenerationEngine(cfg, params, ByteTokenizer(), device="cpu", max_slots=2,
                               max_seq_len=512, chunk_size=64, decode_steps=4,
                               prefill_piggyback=piggyback)
        eng._running = True
        futs = [eng.submit(short, max_tokens=2, temperature=0.0),
                eng.submit(long_, max_tokens=4, temperature=0.0)]
        _crank(eng, futs)
        return [f.result(timeout=0).token_ids for f in futs], eng.decode_path_stats()

    on_ids, on = run(True)
    off_ids, off = run(False)
    assert on_ids == off_ids
    assert on["prefill_chunks_piggybacked"] > 0 and off["prefill_chunks_piggybacked"] == 0
    assert on["prefill_displacement_frac"] == 0.0
    assert off["prefill_displacement_frac"] > 0.0


def test_tick_writes_only_in_place(tiny_models):
    """Every tensor the tick reads keeps its address across admission, a
    tick and a reset (a CUDA graph captured them): cache, tokens, active,
    block tables, sampling arrays, noise and the tick's output."""
    _, _, cfg, params = tiny_models
    eng = GenerationEngine(cfg, params, ByteTokenizer(), device="cpu", max_slots=2,
                           max_seq_len=128, decode_steps=2)
    names = ("_tokens_dev", "_active_dev", "_bt_dev", "_temps_dev", "_top_ps_dev",
             "_noise", "_toks_dev")

    def addresses():
        c = eng._cache
        return [getattr(eng, n).data_ptr() for n in names] + [
            c.k.data_ptr(), c.v.data_ptr(), c.lengths.data_ptr()]

    before = addresses()
    eng._running = True
    fut = eng.submit([1, 2, 3], max_tokens=5, temperature=0.7)
    _crank(eng, [fut])
    assert addresses() == before
    eng._reset_device_state()
    assert addresses() == before
    assert int(eng._cache.lengths.sum()) == 0 and not bool(eng._active_dev.any())
    assert torch.equal(eng._bt_dev, torch.full_like(eng._bt_dev, eng._kv_sentinel))
