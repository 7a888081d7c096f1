"""The port's tree-verified prompt-lookup speculative decoding against the JAX
package's (CPU, ``DecoderConfig.tiny()`` in f32; inputs from numpy seeds,
weights through ``convert.params_from_jax``):

- ``make_tree_spec`` layouts equal to JAX for several (N, K), and the JAX
  layout contract (tests/test_speculative.py:83);
- ``build_tree_draft`` ints bit-equal to JAX on random, repetitive,
  no-match and tied histories (and the JAX drafter contracts :102, :128);
- ``accept_tree`` equal to JAX on the same logits for greedy rows (an
  oracle branch planted at any position, garbage trees, ties between
  branches), sampled rows taking the position-0 draw (:141, :166, :199);
- ``paged_tree_attention_plain`` within 1e-5 of the JAX
  ``paged_tree_attention`` in f32 (ragged lengths including 0, sentinel
  block-table entries, a window, trees of 65 and 129 nodes), and its bf16
  bound met by the JAX
  function itself in bf16;
- ``verify_tree_step_paged`` logits and tree K/V against JAX's, read-only
  with respect to the pool (:220); ``commit_tree_path_paged`` pool bytes
  equal to JAX's after the commit, with dropped writes;
- the controller and breakeven cases (:238-330) on the port's copy;
- the engine: greedy ids with speculation equal to the plain engine and to
  the JAX spec engine (also at ``decode_steps`` 2 and 4, and on a tiny MoE
  model), the ``burst`` default and the ``max_seq_len`` bound, restart
  mid-verify and NaN quarantine leaving the pool clean, the prefix cache,
  mixed temperatures and the ``json_format`` refusal, ``probe_spec``, the
  ``/healthz`` gauges and the registry's refusals with the JAX messages.
"""

import asyncio
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from django_assistant_bot_tpu.models import DecoderConfig as JaxDecoderConfig
from django_assistant_bot_tpu.models import llama as jllama
from django_assistant_bot_tpu.ops.attention import paged_tree_attention as jax_paged_tree_attention
from django_assistant_bot_tpu.ops import speculative as jspec
from django_assistant_bot_tpu.serving import ByteTokenizer as JaxByteTokenizer
from django_assistant_bot_tpu.serving import GenerationEngine as JaxGenerationEngine
from django_assistant_bot_tpu_torch.convert import params_from_jax
from django_assistant_bot_tpu_torch.models import DecoderConfig, llama
from django_assistant_bot_tpu_torch.ops.attention import (paged_tree_attention,
                                                          paged_tree_attention_plain,
                                                          paged_tree_bf16_bound)
from django_assistant_bot_tpu_torch.ops import speculative as tspec
from django_assistant_bot_tpu_torch.serving import ByteTokenizer, GenerationEngine, ModelRegistry
from django_assistant_bot_tpu_torch.serving.faults import FaultInjector
from django_assistant_bot_tpu_torch.serving.registry import ModelSpec, _check_speculative


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def tiny():
    jcfg = JaxDecoderConfig.tiny()
    jparams = jllama.init(jcfg, jax.random.key(7))
    cfg = DecoderConfig.tiny()
    return jcfg, jparams, cfg, params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")


# ------------------------------------------------------------------ tree spec
@pytest.mark.parametrize("width,depth", [(1, 1), (1, 4), (2, 3), (3, 4), (4, 4), (4, 6)])
def test_make_tree_spec_equals_jax(width, depth):
    a, b = jspec.make_tree_spec(width, depth), tspec.make_tree_spec(width, depth)
    assert (a.width, a.depth, a.size) == (b.width, b.depth, b.size)
    for name in ("depths", "parent", "anc_mask", "branch_nodes"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


def test_make_tree_spec_layout():
    spec = tspec.make_tree_spec(3, 4)
    assert spec.size == 1 + 3 * 4
    assert spec.depths[0] == 0 and spec.parent[0] == 0
    for n in range(3):
        nodes = spec.branch_nodes[n]
        assert spec.parent[nodes[0]] == 0
        for d in range(1, 4):
            assert spec.parent[nodes[d]] == nodes[d - 1]
            assert spec.depths[nodes[d]] == d + 1
        for d in range(4):
            anc = set(np.nonzero(spec.anc_mask[nodes[d]])[0].tolist())
            assert anc == {0, *nodes[: d + 1].tolist()}


# ------------------------------------------------------------------- drafter
def _draft_pair(hist, lengths, tokens, width, depth):
    want = np.asarray(jspec.build_tree_draft(jnp.asarray(hist), jnp.asarray(lengths),
                                             jnp.asarray(tokens), width, depth))
    got = tspec.build_tree_draft(_t(hist), _t(lengths), _t(tokens), width, depth).numpy()
    return want, got


def _histories(kind, seed):
    rng = np.random.default_rng(seed)
    B, S = 4, 96
    if kind == "random":
        hist = rng.integers(0, 512, (B, S))
    elif kind == "repetitive":  # a few short motifs repeated: many bigram hits
        motifs = [rng.integers(0, 6, int(rng.integers(2, 6))) for _ in range(B)]
        hist = np.stack([np.resize(m, S) for m in motifs])
    elif kind == "tied":  # a tiny alphabet: equal first tokens everywhere
        hist = rng.integers(0, 3, (B, S))
    else:  # "no_match": distinct tokens, the tail's bigram never occurs
        hist = np.stack([rng.permutation(512)[:S] for _ in range(B)])
    hist = hist.astype(np.int32)
    lengths = rng.integers(0, S - 1, (B,)).astype(np.int32)
    lengths[0] = S - 2
    tokens = rng.integers(0, 6 if kind in ("repetitive", "tied") else 512, (B,)).astype(np.int32)
    if kind == "no_match":
        tokens[:] = 600  # never in the history: no bigram, no unigram
    return hist, lengths, tokens


@pytest.mark.parametrize("kind", ["random", "repetitive", "tied", "no_match"])
@pytest.mark.parametrize("width,depth", [(1, 3), (2, 4), (4, 4), (3, 6)])
def test_build_tree_draft_bit_equal_to_jax(kind, width, depth):
    for seed in range(6):
        hist, lengths, tokens = _histories(kind, seed)
        want, got = _draft_pair(hist, lengths, tokens, width, depth)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want, err_msg=f"{kind} seed {seed}")


def test_build_tree_draft_adversarial_histories_bit_equal_to_jax():
    """Short rows, lengths 0 and 1, the tail at the last position, every
    position one token, and widths past the distinct candidates."""
    S = 24
    hists = [np.zeros(S), np.full(S, 7), np.arange(S) % 2, np.arange(S) % 3,
             np.r_[np.arange(12), np.arange(12)]]
    for hist in hists:
        for length in (0, 1, 2, 5, S - 2, S - 1):
            for tok in (0, 1, 7, 11):
                h = np.stack([hist, hist[::-1]]).astype(np.int32)
                lengths = np.asarray([length, max(0, length - 1)], np.int32)
                tokens = np.asarray([tok, tok], np.int32)
                for width, depth in ((1, 2), (4, 4), (6, 3)):
                    want, got = _draft_pair(h, lengths, tokens, width, depth)
                    np.testing.assert_array_equal(got, want)


def test_build_tree_draft_branches_dedup_and_fallbacks():
    hist0 = [9, 7, 8, 50, 7, 8, 40, 9, 7, 8, 50, 61, 2, 9, 7, 8, 0, 0, 0, 0]
    hist1 = [4, 5, 9, 70, 71, 72, 6, 5, 9, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0]
    hist = _t(np.asarray([hist0, hist1], np.int32))
    draft = tspec.build_tree_draft(hist, _t(np.asarray([15, 8], np.int32)),
                                   _t(np.asarray([8, 9], np.int32)), 3, 3).numpy()
    assert draft[0, 0].tolist() == [50, 61, 2]
    assert draft[0, 1].tolist() == [40, 9, 7]
    assert draft[0, 2].tolist() == [50, 61, 2] or draft[0, 2][0] == hist0[10]
    assert draft[1, 0].tolist() == [70, 71, 72]


def test_width1_tree_matches_linear_prompt_lookup():
    hist = _t(np.asarray([[1, 7, 8, 50, 60, 61, 2, 3, 7, 8, 0, 0, 0, 0, 0, 0]], np.int32))
    lengths, tokens = _t(np.asarray([9], np.int32)), _t(np.asarray([8], np.int32))
    lin = tspec.build_prompt_lookup_draft(hist, lengths, tokens, 3).numpy()
    tre = tspec.build_tree_draft(hist, lengths, tokens, 1, 3)[:, 0].numpy()
    assert lin.tolist() == tre.tolist() == [[50, 60, 61]]


# ------------------------------------------------------------------ acceptance
def _accept_pair(logits, tree, spec_args, temps, gumbel=None):
    jspec_ = jspec.make_tree_spec(*spec_args)
    tspec_ = tspec.make_tree_spec(*spec_args)
    B = logits.shape[0]
    want = jspec.accept_tree(jnp.asarray(logits), jnp.asarray(tree), jspec_, jax.random.key(0),
                             temperature=jnp.asarray(temps), top_k=10,
                             top_p=jnp.ones((B,)))[:4]
    got = tspec.accept_tree(_t(logits), _t(tree), tspec_, temperature=_t(temps), top_k=10,
                            top_p=torch.ones(B), gumbel=gumbel)
    return [np.asarray(w) for w in want], [g.numpy() for g in got], tspec_


@pytest.mark.parametrize("width,depth", [(1, 3), (3, 3), (4, 4)])
def test_accept_tree_greedy_rows_equal_jax(width, depth):
    """Random trees whose tokens often match the argmax at their parent
    (a planted oracle branch per row, partial matches, ties between branches
    of equal runs, all-garbage rows): every output equal to JAX's."""
    rng = np.random.default_rng(width * 10 + depth)
    spec = tspec.make_tree_spec(width, depth)
    B, V, T = 8, 32, spec.size
    for trial in range(8):
        logits = rng.normal(size=(B, T, V)).astype(np.float32)
        am = logits.argmax(-1)
        tree = rng.integers(0, V, (B, T)).astype(np.int32)
        for b in range(B):
            n = int(rng.integers(0, width))
            nodes = spec.branch_nodes[n]
            run = int(rng.integers(0, depth + 1))  # oracle run length
            parent = 0
            for d in range(run):
                tree[b, nodes[d]] = am[b, parent]
                parent = nodes[d]
            if b % 3 == 0 and width > 1:  # a second branch with the same run: a tie
                other = spec.branch_nodes[(n + 1) % width]
                parent = 0
                for d in range(run):
                    tree[b, other[d]] = am[b, parent]
                    parent = other[d]
        want, got, _ = _accept_pair(logits, tree, (width, depth), np.zeros(B, np.float32))
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)


def test_accept_tree_sampled_rows_take_position_zero():
    V = 32
    spec = tspec.make_tree_spec(2, 3)
    logits = torch.full((1, spec.size, V), -30.0)
    logits[0, 0, 5] = 10.0
    tree = torch.full((1, spec.size), 5, dtype=torch.int32)
    out, n_new, bonus, _ = tspec.accept_tree(
        logits, tree, spec, temperature=torch.tensor([0.7]), top_k=10,
        top_p=torch.tensor([0.9]), generator=torch.Generator().manual_seed(2))
    assert int(n_new[0]) == 1
    assert int(out[0, 0]) == 5 and int(bonus[0]) == 5


def test_accept_tree_mixed_rows_sampled_draw_is_the_samplers():
    """A sampled row's token is the sampler's draw on position 0 with the
    same noise; the greedy rows beside it equal JAX's."""
    from django_assistant_bot_tpu_torch.ops.sampling import sample_logits_plain

    rng = np.random.default_rng(5)
    spec = tspec.make_tree_spec(2, 2)
    B, V = 4, 64
    logits = rng.normal(size=(B, spec.size, V)).astype(np.float32)
    tree = rng.integers(0, V, (B, spec.size)).astype(np.int32)
    temps = np.asarray([0.0, 0.9, 0.0, 1.3], np.float32)
    gumbel = torch.from_numpy(rng.gumbel(size=(B, 10)).astype(np.float32))
    want, got, _ = _accept_pair(logits, tree, (2, 2), temps, gumbel)
    draw = sample_logits_plain(_t(logits[:, 0]), temperature=_t(temps), top_k=10,
                               top_p=torch.ones(B), gumbel=gumbel).numpy()
    for b in range(B):
        if temps[b] > 0:
            assert got[1][b] == 1 and got[0][b, 0] == draw[b] == got[2][b]
        else:
            for w, g in zip(want, got):
                np.testing.assert_array_equal(g[b], w[b])


# ------------------------------------------------------------- tree attention
def _tree_case(seed, lengths, *, B=4, H=4, KH=2, D=16, page=8, NB=6, width=2, depth=3,
               sentinel_rows=(), dtype=np.float32):
    """Random pools, queries and tree K/V; each row's pages a random chain,
    sentinel entries (P) past each row's allocation, rows in
    ``sentinel_rows`` all sentinels past their first block."""
    rng = np.random.default_rng(seed)
    spec = tspec.make_tree_spec(width, depth)
    T = spec.size
    P = B * NB
    k_pool = rng.normal(size=(P, KH, page, D)).astype(dtype)
    v_pool = rng.normal(size=(P, KH, page, D)).astype(dtype)
    q = rng.normal(size=(B, H, T, D)).astype(dtype)
    tk = rng.normal(size=(B, KH, T, D)).astype(dtype)
    tv = rng.normal(size=(B, KH, T, D)).astype(dtype)
    bt = rng.permutation(P).reshape(B, NB).astype(np.int32)
    lengths = np.asarray(lengths, np.int32)
    for b in range(B):
        used = -(-int(lengths[b]) // page)
        bt[b, used:] = P
        if b in sentinel_rows:
            bt[b, 1:] = P + 3  # past P: clamped like P
    return dict(q=q, k_pool=k_pool, v_pool=v_pool, bt=bt, lengths=lengths, tk=tk, tv=tv,
                anc=spec.anc_mask, depths=spec.depths)


def _tree_jax(c, window=None):
    return np.asarray(jax_paged_tree_attention(
        jnp.asarray(c["q"]), jnp.asarray(c["k_pool"]), jnp.asarray(c["v_pool"]),
        jnp.asarray(c["bt"]), jnp.asarray(c["lengths"]), jnp.asarray(c["tk"]),
        jnp.asarray(c["tv"]), jnp.asarray(c["anc"]), jnp.asarray(c["depths"]), window=window))


def _tree_args(c):
    return (_t(c["q"]), _t(c["k_pool"]), _t(c["v_pool"]), _t(c["bt"]), _t(c["lengths"]),
            _t(c["tk"]), _t(c["tv"]), _t(c["anc"]), _t(c["depths"]))


@pytest.mark.parametrize("window", [None, 5, 13])
@pytest.mark.parametrize("lengths", [[0, 9, 30, 47], [13, 0, 0, 40], [1, 8, 16, 45]],
                         ids=["ragged", "zeros", "page_edges"])
def test_paged_tree_plain_matches_jax(lengths, window):
    c = _tree_case(11, lengths)
    want = _tree_jax(c, window)
    got = paged_tree_attention_plain(*_tree_args(c), window=window).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # the wrapper takes the twin for a CPU tensor
    again = paged_tree_attention(*_tree_args(c), window=window).numpy()
    np.testing.assert_array_equal(again, got)


@pytest.mark.parametrize("window", [None, 11])
@pytest.mark.parametrize("width,depth", [(8, 8), (16, 8)], ids=["T65", "T129"])
def test_paged_tree_plain_matches_jax_past_one_tile(width, depth, window):
    """Trees of 65 and 129 nodes (past one 64-key tile: the card's kernel
    walks them in two and three tiles) at tiny widths: the twin within 1e-5
    of the JAX function, with and without a window."""
    c = _tree_case(15, [0, 9, 30, 47], width=width, depth=depth)
    assert c["q"].shape[2] == 1 + width * depth
    want = _tree_jax(c, window)
    got = paged_tree_attention_plain(*_tree_args(c), window=window).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_paged_tree_plain_matches_jax_with_sentinels_and_stale_rows():
    """Sentinel entries inside a stale (inactive) row's length clamp to page
    P - 1 and are read, as the JAX loop reads them; other rows unaffected."""
    c = _tree_case(12, [20, 33, 0, 7], sentinel_rows=(1,), width=4, depth=4, H=8, KH=2)
    want = _tree_jax(c)
    got = paged_tree_attention_plain(*_tree_args(c)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_paged_tree_bf16_bound_holds_for_the_jax_function():
    """The JAX function in bf16 (its P rounded to bf16 before P.V) lies
    within ``paged_tree_bf16_bound`` of the f32 twin, and a wrong mask (a
    sibling branch's key let in) is caught by it."""
    c = _tree_case(13, [30, 3, 47, 0], width=4, depth=4, H=8, KH=2, D=32)
    # the same inputs: the bf16 values, the twin and the bound in f32 on them
    c = {k: (np.asarray(jnp.asarray(v, jnp.bfloat16), np.float32) if v.dtype == np.float32
             else v) for k, v in c.items()}
    ref = paged_tree_attention_plain(*_tree_args(c))
    bound = paged_tree_bf16_bound(*_tree_args(c), ref)
    bf = {k: (v.astype(jnp.bfloat16) if v.dtype == np.float32 else v) for k, v in c.items()}
    got = np.asarray(jax_paged_tree_attention(
        jnp.asarray(bf["q"]), jnp.asarray(bf["k_pool"]), jnp.asarray(bf["v_pool"]),
        jnp.asarray(c["bt"]), jnp.asarray(c["lengths"]), jnp.asarray(bf["tk"]),
        jnp.asarray(bf["tv"]), jnp.asarray(c["anc"]), jnp.asarray(c["depths"]))
    ).astype(np.float32)
    assert (np.abs(got - ref.numpy()) / bound.numpy()).max() <= 1.0
    wrong = dict(c, anc=np.ones_like(c["anc"]))
    bad = paged_tree_attention_plain(*_tree_args(wrong))
    assert (torch.abs(bad - ref) / bound).max() > 1.0


def test_paged_tree_wrapper_refuses_fp8_pools():
    """fp8 prefix pools are served now: the wrapper reads them as the JAX
    function does (each page widened to q's dtype, the tree's own K/V in
    q's dtype), equal to it within f32 summation order, in both formats."""
    c = _tree_case(14, [3, 4, 5, 6])
    for jdt, tdt in ((jnp.float8_e4m3fn, torch.float8_e4m3fn),
                     (jnp.float8_e5m2, torch.float8_e5m2)):
        jk, jv = (jnp.asarray(c[n]).astype(jdt) for n in ("k_pool", "v_pool"))
        want = np.asarray(jax_paged_tree_attention(
            jnp.asarray(c["q"]), jk, jv, jnp.asarray(c["bt"]), jnp.asarray(c["lengths"]),
            jnp.asarray(c["tk"]), jnp.asarray(c["tv"]), jnp.asarray(c["anc"]),
            jnp.asarray(c["depths"])))
        args = list(_tree_args(c))
        args[1], args[2] = (_t(np.asarray(a.astype(jnp.float32))).to(tdt) for a in (jk, jv))
        got = paged_tree_attention(*args).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# ------------------------------------------------------------ verify / commit
PAGE, NB_, P_ = 16, 6, 30  # tiny paged geometry: S = 96


def _pools(seed, cfg, lengths):
    rng = np.random.default_rng(seed)
    L, KH, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    k = rng.normal(size=(L, P_, KH, PAGE, D)).astype(np.float32)
    v = rng.normal(size=(L, P_, KH, PAGE, D)).astype(np.float32)
    lengths = np.asarray(lengths, np.int32)
    jc = jllama.PagedKVCache(k=jnp.asarray(k), v=jnp.asarray(v), lengths=jnp.asarray(lengths))
    dump = np.zeros((L, 1, KH, PAGE, D), np.float32)
    tc = llama.PagedKVCache(k=_t(np.concatenate([k, dump], 1)),
                            v=_t(np.concatenate([v, dump], 1)), lengths=_t(lengths))
    bt = np.full((len(lengths), NB_), P_, np.int32)
    perm = rng.permutation(P_)
    for b, n in enumerate(lengths):
        need = min(NB_, -(-(int(n) + 8) // PAGE))
        bt[b, :need] = perm[b * NB_: b * NB_ + need]
    return k, v, jc, tc, bt


def _verify_pair(tiny, lengths, width, depth, seed=0):
    jcfg, jparams, cfg, params = tiny
    k, v, jc, tc, bt = _pools(seed, cfg, lengths)
    spec = tspec.make_tree_spec(width, depth)
    tree = np.random.default_rng(seed + 1).integers(1, 255, (len(lengths), spec.size))
    tree = tree.astype(np.int32)
    jl, jks, jvs = jllama.verify_tree_step_paged(
        jparams, jcfg, jnp.asarray(tree), jc, jnp.asarray(bt), jnp.asarray(spec.depths),
        jnp.asarray(spec.anc_mask))
    tl, tks, tvs = llama.verify_tree_step_paged(
        params, cfg, _t(tree), tc, _t(bt), _t(spec.depths), _t(spec.anc_mask))
    return (k, v, jc, tc, bt, spec), (np.asarray(jl), np.asarray(jks), np.asarray(jvs)), (tl, tks, tvs)


@pytest.mark.parametrize("lengths,width,depth", [([5, 0, 40, 77], 2, 3), ([17, 60, 3, 33], 4, 4)])
def test_verify_tree_step_paged_matches_jax_and_is_read_only(tiny, lengths, width, depth):
    (k, v, _, tc, _, _), (jl, jks, jvs), (tl, tks, tvs) = _verify_pair(tiny, lengths, width, depth)
    np.testing.assert_allclose(tl.numpy(), jl, atol=1e-4, rtol=0)
    np.testing.assert_allclose(tks.numpy(), jks, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tvs.numpy(), jvs, atol=1e-5, rtol=0)
    assert tl.dtype == torch.float32
    np.testing.assert_array_equal(tc.k[:, :P_].numpy(), k)  # read-only
    np.testing.assert_array_equal(tc.v[:, :P_].numpy(), v)


def test_commit_tree_path_paged_matches_jax_with_drops(tiny):
    """Rows commit 1..K+1 tokens; an inactive row, a row whose commit runs
    past its allocation (sentinel block) and a row at the end of the
    logical row drop those writes; every pool byte equals JAX's after."""
    jcfg, jparams, cfg, params = tiny
    lengths = [5, 30, 47, 93]
    (k, v, jc, tc, bt, spec), (jl, jks, jvs), (tl, tks, tvs) = _verify_pair(tiny, lengths, 2, 3, 4)
    bt[2, 3:] = P_  # row 2 owns 3 pages (48 positions): writes past 47 drop
    C = spec.depth + 1
    path = np.stack([np.r_[0, spec.branch_nodes[b % 2]] for b in range(4)]).astype(np.int32)
    n_commit = np.asarray([4, 2, 3, 4], np.int32)
    active = np.asarray([True, False, True, True])
    jc2 = jllama.commit_tree_path_paged(jc, jks, jvs, jnp.asarray(path), jnp.asarray(bt),
                                        jnp.asarray(n_commit), jnp.asarray(active))
    # the port commits its own tree K/V (within 1e-5 of JAX's): compare
    # against JAX committing the port's
    jc3 = jllama.commit_tree_path_paged(jc, jnp.asarray(tks.numpy()), jnp.asarray(tvs.numpy()),
                                        jnp.asarray(path), jnp.asarray(bt),
                                        jnp.asarray(n_commit), jnp.asarray(active))
    llama.commit_tree_path_paged(tc, tks, tvs, _t(path), _t(bt), _t(n_commit), _t(active))
    np.testing.assert_array_equal(tc.k[:, :P_].numpy(), np.asarray(jc3.k))
    np.testing.assert_array_equal(tc.v[:, :P_].numpy(), np.asarray(jc3.v))
    np.testing.assert_allclose(tc.k[:, :P_].numpy(), np.asarray(jc2.k), atol=1e-5, rtol=0)
    assert not np.array_equal(np.asarray(jc2.k), k)  # something was written
    assert C == 4 and tc.lengths.tolist() == lengths  # lengths not advanced


def test_tree_accepts_oracle_branch_and_cache_stays_sound(tiny):
    """The greedy continuation planted in a non-first branch is accepted in
    full with the right bonus; after the commit, plain paged decode from the
    committed cache tracks the non-speculative greedy reference."""
    jcfg, jparams, cfg, params = tiny
    prompt = np.asarray([[1, 5, 9, 17, 3, 44, 2]], np.int32)
    n = prompt.shape[1]
    K, N = 3, 3
    B, S = 2, NB_ * PAGE

    def fresh():
        cache = llama.init_paged_cache(cfg, B, P_, PAGE)
        bt = torch.full((B, NB_), P_, dtype=torch.int32)
        bt[0, :] = torch.arange(NB_, dtype=torch.int32)
        logits, ks, vs = llama.prefill(params, cfg, _t(prompt), _t(np.asarray([n], np.int32)))
        llama.insert_sequences_paged(cache, ks, vs, _t(np.asarray([n], np.int32)),
                                     _t(np.asarray([0], np.int32)), bt[:1])
        return int(logits[0].argmax()), cache, bt

    tok, cache, bt = fresh()
    ref = [tok]
    active = torch.tensor([True, False])
    for _ in range(K + 2):
        logits, cache = llama.decode_step_paged(
            params, cfg, torch.tensor([ref[-1], 0], dtype=torch.int32), cache, bt, active=active)
        ref.append(int(logits[0].argmax()))
    tok, cache, bt = fresh()
    spec = tspec.make_tree_spec(N, K)
    tree = torch.zeros((B, spec.size), dtype=torch.int32)
    tree[0, 0] = ref[0]
    tree[0, spec.branch_nodes[0]] = torch.tensor([499, 498, 497], dtype=torch.int32)
    tree[0, spec.branch_nodes[1]] = torch.tensor(ref[1:K + 1], dtype=torch.int32)
    tree[0, spec.branch_nodes[2]] = torch.tensor([3, 499, 3], dtype=torch.int32)
    logits, tks, tvs = llama.verify_tree_step_paged(params, cfg, tree, cache, bt,
                                                    _t(spec.depths), _t(spec.anc_mask))
    out, n_new, bonus, path_idx = tspec.accept_tree(
        logits, tree, spec, temperature=torch.zeros(B), top_k=50, top_p=torch.ones(B),
        gumbel=torch.zeros((B, 50)))
    assert int(n_new[0]) == K + 1
    assert out[0, : K + 1].tolist() == ref[1: K + 2]
    assert int(bonus[0]) == ref[K + 1]
    assert path_idx[0].tolist() == [0, *spec.branch_nodes[1].tolist()]
    llama.commit_tree_path_paged(cache, tks, tvs, path_idx, bt, n_new * active, active)
    cache.lengths[0] += int(n_new[0])
    logits, cache = llama.decode_step_paged(
        params, cfg, torch.tensor([int(bonus[0]), 0], dtype=torch.int32), cache, bt, active=active)
    assert int(logits[0].argmax()) == ref[K + 2]
    assert S == 96


# ---------------------------------------------------------------- controller
def test_controller_upshift_downshift_under_forced_accept_rates():
    ctl = tspec.SpecController(rungs=tspec.default_rungs(4, 6), probe_every=8,
                               explore_every=1000)
    ctl.note_cost((4, 6), 3.0)
    ctl.note_cost((2, 6), 2.0)
    ctl.note_cost((1, 6), 1.5)
    ctl.note_cost((1, 3), 1.2)
    for _ in range(50):
        ctl.note_tick(accepted=6, depth=6, rung=(4, 6))
        ctl.note_tick(accepted=3, depth=6, rung=(2, 6))
        ctl.note_tick(accepted=3, depth=6, rung=(1, 6))
        ctl.note_tick(accepted=2, depth=3, rung=(1, 3))
    assert ctl.rung() == (4, 6)
    assert not ctl.disabled
    for _ in range(50):
        ctl.note_tick(accepted=0, depth=6, rung=(4, 6))
    rung = ctl.rung()
    assert rung is not None and rung != (4, 6)
    for r in [(2, 6), (1, 6)]:
        for _ in range(80):
            ctl.note_tick(accepted=0, depth=6, rung=r)
    for _ in range(80):
        ctl.note_tick(accepted=0, depth=3, rung=(1, 3))
    assert ctl.rung() is None
    assert ctl.disabled
    assert ctl.stats()["spec_auto_disabled"] is True


def test_controller_explores_wider_rung_periodically():
    ctl = tspec.SpecController(rungs=[(4, 4), (1, 4)], explore_every=5)
    ctl.note_cost((4, 4), 2.0)
    ctl.note_cost((1, 4), 1.2)
    for _ in range(60):
        ctl.note_tick(accepted=0, depth=4, rung=(4, 4))
        ctl.note_tick(accepted=3, depth=4, rung=(1, 4))
    picks = [ctl.rung() for _ in range(10)]
    assert picks.count((4, 4)) == 2
    assert all(p in ((1, 4), (4, 4)) for p in picks)


def test_controller_probes_while_disabled_and_reenables():
    ctl = tspec.SpecController(rungs=[(1, 4)], probe_every=5)
    ctl.note_cost((1, 4), 2.0)
    for _ in range(100):
        ctl.note_tick(accepted=0, depth=4)
    assert ctl.rung() is None and ctl.disabled
    fired = [ctl.rung() for _ in range(5)]
    assert fired[:4] == [None] * 4
    assert fired[4] == (1, 4)
    for _ in range(60):
        ctl.note_tick(accepted=4, depth=4)
    assert ctl.rung() == (1, 4)
    assert not ctl.disabled


def test_controller_trace_equals_jax():
    """The same notes and costs through both controllers: the same rungs
    issued and the same stats, tick for tick."""
    rng = np.random.default_rng(9)
    a = jspec.SpecController(rungs=jspec.default_rungs(4, 4), probe_every=3, explore_every=4)
    b = tspec.SpecController(rungs=tspec.default_rungs(4, 4), probe_every=3, explore_every=4)
    for rung in a.rungs:
        ratio = float(rng.uniform(1.0, 4.0))
        a.note_cost(rung, ratio)
        b.note_cost(rung, ratio)
    for _ in range(300):
        ra, rb = a.rung(), b.rung()
        assert ra == rb
        if ra is not None:
            acc, rows = int(rng.integers(0, 5)), int(rng.integers(0, 4))
            a.note_tick(acc * max(rows, 1), ra[1], rows, rung=ra)
            b.note_tick(acc * max(rows, 1), rb[1], rows, rung=rb)
        assert a.stats() == b.stats()


def test_breakeven_accept_rate_math():
    assert tspec.breakeven_accept_rate(1.0, 6) == 0.0
    assert tspec.breakeven_accept_rate(0.5, 6) == 0.0
    assert tspec.breakeven_accept_rate(8.0, 6) == 1.0
    p = tspec.breakeven_accept_rate(2.0, 6)
    assert 0.0 < p < 1.0
    assert abs((1 - p ** 7) / (1 - p) - 2.0) < 1e-6
    assert tspec.breakeven_accept_rate(2.0, 12) < p
    for r, k in ((1.3, 4), (2.5, 4), (3.7, 2)):
        assert tspec.breakeven_accept_rate(r, k) == jspec.breakeven_accept_rate(r, k)


def test_default_rungs_ladder():
    assert tspec.default_rungs(4, 6) == [(4, 6), (2, 6), (1, 6), (1, 3)]
    assert tspec.default_rungs(1, 1) == [(1, 1)]
    for w, k in ((4, 4), (3, 5), (2, 1)):
        assert tspec.default_rungs(w, k) == jspec.default_rungs(w, k)


# ------------------------------------------------------------- the engine
PROMPTS = [
    "abc abc abc abc abc abc",
    "the cat sat on the mat the cat sat on the",
    "xyz",
    "quote me: pay invoices in the portal. pay invoices in the",
]


def _models(seed, num_experts=0):
    jcfg = JaxDecoderConfig.tiny(num_experts=num_experts)
    jparams = jllama.init(jcfg, jax.random.PRNGKey(seed))
    cfg = DecoderConfig.tiny(num_experts=num_experts)
    return jcfg, jparams, cfg, params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")


@pytest.fixture(scope="module")
def tiny0():
    return _models(0)


def _crank(eng, futs, limit=4000):
    """The loop body single-threaded: an iteration, and on an error the
    crash-only restart the loop would run."""
    for _ in range(limit):
        if all(f.done() for f in futs):
            return
        try:
            eng._loop_iteration()
        except Exception as e:
            with eng._iter_lock:
                eng._restart(e)
    raise AssertionError("requests did not finish within the crank budget")


def _run(eng, jobs):
    eng._running = True
    futs = [eng.submit(ids, max_tokens=mt, temperature=t) for ids, mt, t in jobs]
    _crank(eng, futs)
    eng._running = False
    return [f.result(timeout=0).token_ids for f in futs], eng.tick_stats()


def _port(cfg, params, **kw):
    kw.setdefault("max_slots", 4)
    kw.setdefault("max_seq_len", 96)
    kw.setdefault("prefix_cache_size", 0)
    kw.setdefault("lookahead", 1)
    if kw.get("speculative"):
        # probe_every 1: a disabled controller re-probes every tick, so the
        # speculative path keeps running for the whole comparison
        kw.setdefault("spec_probe_every", 1)
    return GenerationEngine(cfg, params, ByteTokenizer(), device="cpu", **kw)


def _jax(jcfg, jparams, **kw):
    kw.setdefault("max_slots", 4)
    kw.setdefault("max_seq_len", 96)
    kw.setdefault("prefix_cache_size", 0)
    kw.setdefault("lookahead", 1)
    if kw.get("speculative"):
        kw.setdefault("spec_probe_every", 1)
    return JaxGenerationEngine(jcfg, jparams, JaxByteTokenizer(), scheduler=None, **kw)


def _jobs(tok, sampled=(2,), max_tokens=16):
    return [(tok.encode(p), max_tokens, 0.9 if i in sampled else 0.0)
            for i, p in enumerate(PROMPTS)]


# ----------------------------------------------------------- equivalence
def test_spec_greedy_ids_equal_plain_and_jax_spec_engine(tiny0):
    jcfg, jparams, cfg, params = tiny0
    jobs = _jobs(ByteTokenizer())
    plain, _ = _run(_port(cfg, params, burst=4), jobs)
    spec, st = _run(_port(cfg, params, speculative=4, spec_width=2), jobs)
    jspec, jst = _run(_jax(jcfg, jparams, speculative=4, spec_width=2), jobs)
    for i, (_, mt, t) in enumerate(jobs):
        if t == 0.0:
            assert spec[i] == plain[i] == jspec[i], i
        else:
            assert 1 <= len(spec[i]) <= mt
    assert st["spec_drafted"] == jst["spec_drafted"] > 0
    assert st["spec_accepted"] == jst["spec_accepted"]
    assert st["kv"]["kv_layout"] == "paged"
    assert st["prefill_piggyback"] is False and st["decode_steps"] == 1


def test_spec_greedy_equivalence_property_second_seed():
    """Another model and a spec engine at (3, 3): greedy rows equal the
    plain engine's, draft counters nonzero."""
    _, _, cfg, params = _models(3)
    jobs = _jobs(ByteTokenizer(), sampled=(1,), max_tokens=20)
    plain, _ = _run(_port(cfg, params, burst=8), jobs)
    spec, st = _run(_port(cfg, params, speculative=3, spec_width=3), jobs)
    for i, (_, _, t) in enumerate(jobs):
        if t == 0.0:
            assert spec[i] == plain[i], i
    assert st["spec_drafted"] > 0 and st["spec_ticks"] > 0


@pytest.mark.parametrize("steps", [2, 4])
def test_spec_fused_greedy_identity_with_jax(tiny0, steps):
    """``decode_steps`` verify passes a tick: ids equal the plain engine at
    the same depth and the JAX spec engine."""
    jcfg, jparams, cfg, params = tiny0
    tok = ByteTokenizer()
    jobs = [(tok.encode("ab ab ab ab ab ab"), 20, 0.0),
            (tok.encode("the cat sat on the cat sat on"), 16, 0.0),
            (tok.encode("xyz"), 8, 0.0)]
    kw = dict(chunk_size=64, decode_steps=steps, max_seq_len=256)
    plain, _ = _run(_port(cfg, params, **kw), jobs)
    spec, st = _run(_port(cfg, params, speculative=3, spec_width=2, **kw), jobs)
    jspec, jst = _run(_jax(jcfg, jparams, speculative=3, spec_width=2, **kw), jobs)
    assert spec == plain == jspec
    assert st["spec_drafted"] == jst["spec_drafted"] > 0
    assert st["decode_steps"] == steps


def test_spec_default_verify_depth_and_bounds(tiny0):
    _, _, cfg, params = tiny0
    assert _port(cfg, params, burst=8, speculative=3, spec_width=2).decode_steps == 1
    assert _port(cfg, params, decode_steps=2, speculative=3, spec_width=2).decode_steps == 2
    assert _port(cfg, params, burst=8).decode_steps == 8
    with pytest.raises(ValueError, match="speculative=40 .*too large"):
        GenerationEngine(cfg, params, ByteTokenizer(), device="cpu", max_slots=2,
                         max_seq_len=64, speculative=40)
    with pytest.raises(ValueError, match="speculative=40 .*too large"):
        JaxGenerationEngine(JaxDecoderConfig.tiny(), jllama.init(JaxDecoderConfig.tiny(),
                            jax.random.PRNGKey(5)), JaxByteTokenizer(), max_slots=2,
                            max_seq_len=64, speculative=40)


# ------------------------------------------------------------------ chaos
def test_tick_raise_mid_verify_restart_leaves_page_pool_clean():
    _, _, cfg, params = _models(9)
    tok = ByteTokenizer()
    inj = FaultInjector({})
    eng = _port(cfg, params, max_slots=2, speculative=3, spec_width=2, faults=inj)
    eng._running = True
    f0 = eng.submit(tok.encode("ab ab ab ab"), max_tokens=6, temperature=0.0)
    _crank(eng, [f0])
    inj.arm("tick_raise")
    futs = [eng.submit(tok.encode("cd cd cd cd"), max_tokens=6, temperature=0.0)
            for _ in range(2)]
    _crank(eng, futs)
    eng._running = False
    done = sum(1 for f in futs if f.exception() is None)
    assert done >= 1
    assert eng.engine_restarts == 1 and eng.spec_ticks_issued > 0
    kv = eng.kv_stats()
    assert kv["kv_pages_used"] == 0
    assert kv["kv_pages_free"] == eng._kv_pool.n_pages
    assert all(not pages for pages in eng._slot_pages)
    assert int(eng._history_dev.abs().sum()) >= 0  # rebuilt in place


def test_nan_logits_quarantine_frees_spec_slot_pages():
    _, _, cfg, params = _models(10)
    tok = ByteTokenizer()
    inj = FaultInjector({})
    eng = _port(cfg, params, max_slots=2, speculative=3, spec_width=2, faults=inj, lookahead=0)
    eng._running = True
    f0 = eng.submit(tok.encode("ab ab ab ab"), max_tokens=8, temperature=0.0)
    _crank(eng, [f0])
    inj.arm("nan_logits")
    futs = [eng.submit(tok.encode("ef ef ef ef"), max_tokens=8, temperature=0.0)
            for _ in range(2)]
    _crank(eng, futs)
    eng._running = False
    outcomes = [type(f.exception()).__name__ if f.exception() else "ok" for f in futs]
    assert "RequestPoisoned" in outcomes and "ok" in outcomes
    assert eng.poisoned_requests == 1 and eng.engine_restarts == 0
    assert eng.kv_stats()["kv_pages_used"] == 0


# ------------------------------------------------------- composition
def test_spec_with_prefix_cache_matches_plain(tiny0):
    _, _, cfg, params = _models(6)
    tok = ByteTokenizer()
    shared = "context: pay invoices in the portal. " * 2
    prompts = [shared + "q1?", shared + "q2 about invoices?"]
    plen = len(tok.encode(shared))

    def run(spec):
        eng = _port(cfg, params, max_slots=2, max_seq_len=160, prefix_cache_size=4,
                    prefix_min_tokens=8, speculative=spec, spec_width=2)
        eng._running = True
        outs = []
        for p in prompts:  # sequential: turn 2 hits turn 1's prefix
            f = eng.submit(tok.encode(p), max_tokens=16, temperature=0.0, prefix_len=plen)
            _crank(eng, [f])
            outs.append(f.result(timeout=0).token_ids)
        eng._running = False
        return outs, eng.prefix_hits, eng.tick_stats()

    plain, _, _ = run(0)
    spec, hits, st = run(5)
    assert spec == plain
    assert hits >= 1 and st["spec_drafted"] > 0


def test_mixed_temperatures_and_json_refused(tiny0):
    _, _, cfg, params = tiny0
    tok = ByteTokenizer()
    eng = _port(cfg, params, speculative=4, spec_width=2, max_seq_len=64)
    with pytest.raises(ValueError, match="speculative decoding and json_format are mutually"):
        eng.submit(tok.encode("x"), max_tokens=4, json_format=True)
    jobs = [(tok.encode("ab ab ab ab"), 10, t) for t in (0.0, 0.9, 0.0)]
    out, st = _run(eng, jobs)
    assert all(1 <= len(ids) <= 10 for ids in out)
    assert out[0] == out[2]  # the two greedy rows of one prompt agree
    assert eng.kv_stats()["kv_pages_used"] == 0


def test_probe_spec_and_warmup_feed_measured_costs(tiny0):
    _, _, cfg, params = tiny0
    eng = _port(cfg, params, speculative=4, spec_width=4)
    assert eng._spec_ctl.cost_ratio == {}
    eng.warmup(seq_buckets=(32,))
    assert set(eng._spec_ctl.cost_ratio) == set(eng._spec_ctl.rungs)
    probe = eng.probe_spec(iters=2)
    assert set(probe["rungs"]) == {"4x4", "2x4", "1x4", "1x2"}
    for r in probe["rungs"].values():
        assert r["tick_s"] > 0 and 0.0 <= r["breakeven_accept_rate"] <= 1.0
    assert eng._cache.lengths.sum() == 0 and not eng._active_dev.any()
    with pytest.raises(RuntimeError, match="requires a speculative engine"):
        _port(cfg, params).probe_spec()


def test_tiny_moe_spec_engine_equals_jax():
    jcfg, jparams, cfg, params = _models(1, num_experts=4)
    jobs = _jobs(ByteTokenizer(), sampled=(), max_tokens=12)[:3]
    plain, _ = _run(_port(cfg, params, burst=4), jobs)
    spec, st = _run(_port(cfg, params, speculative=3, spec_width=2), jobs)
    jspec, jst = _run(_jax(jcfg, jparams, speculative=3, spec_width=2), jobs)
    assert spec == jspec == plain
    assert st["spec_drafted"] == jst["spec_drafted"] > 0


# -------------------------------------------------------- serving surface
def test_healthz_and_metrics_carry_spec_gauges():
    from aiohttp.test_utils import TestClient, TestServer

    from django_assistant_bot_tpu_torch.serving.obs import parse_prometheus_text
    from django_assistant_bot_tpu_torch.serving.server import create_app

    registry = ModelRegistry.from_config(
        {"tiny-spec": {"tiny": True, "max_slots": 2, "max_seq_len": 256, "speculative": 3,
                       "spec_width": 2}}, device="cpu")

    async def drive():
        client = TestClient(TestServer(create_app(registry)))
        await client.start_server()
        try:
            r = await client.post("/dialog/", json={
                "model": "tiny-spec", "messages": [{"role": "user", "content": "ab ab ab ab"}],
                "max_tokens": 8, "temperature": 0.0})
            assert r.status == 200
            body = await (await client.get("/healthz")).json()
            metrics = await (await client.get("/metrics")).text()
            return body, metrics
        finally:
            await client.close()

    try:
        body, metrics = asyncio.new_event_loop().run_until_complete(drive())
        g = body["generators"]["tiny-spec"]
        for key in ("spec_accept_rate", "spec_accept_ema", "spec_rung_accept_emas",
                    "spec_tree_width", "spec_tree_depth", "spec_auto_disabled",
                    "spec_load_disabled", "spec_skipped_load", "spec_skipped_accept"):
            assert key in g["spec"], key
        assert g["kv"]["kv_layout"] == "paged"
        assert "spec_disabled" in g["sched"]
        assert g["spec"]["spec_ticks"] > 0
        fams = parse_prometheus_text(metrics)
        for fam in ("dabt_spec_drafted_total", "dabt_spec_accepted_total",
                    "dabt_spec_accept_rate", "dabt_spec_tree_width", "dabt_spec_tree_depth",
                    "dabt_spec_verify_steps", "dabt_spec_tick_accept_ratio"):
            assert any(k.startswith(fam) for k in fams), fam
    finally:
        registry.stop()


def test_registry_serves_speculative_and_refuses_as_jax():
    from django_assistant_bot_tpu.serving.registry import ModelRegistry as JaxModelRegistry
    from django_assistant_bot_tpu.serving.registry import ModelSpec as JaxModelSpec

    spec = ModelSpec.from_dict("m", {"tiny": True, "speculative": 4, "spec_width": 4})
    kw = spec.engine_kwargs()
    assert (kw["speculative"], kw["spec_width"]) == (4, 4)
    jspec = JaxModelSpec(name="m", kind="decoder")
    assert (ModelSpec(name="m").speculative, ModelSpec(name="m").spec_width) == (
        jspec.speculative, jspec.spec_width)
    cases = [
        dict(kind="encoder", tiny=True, speculative=2),
        dict(kind="decoder", tiny=True, speculative=2, warmup_json=True),
    ]
    for case in cases:
        with pytest.raises(ValueError) as want:
            JaxModelRegistry({"m": JaxModelSpec(name="m", **case)})
        with pytest.raises(ValueError) as got:
            ModelRegistry({"m": ModelSpec(name="m", device="cpu", **case)})
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="speculative is decoder-only"):
        ModelSpec.from_dict("e", {"kind": "encoder", "tiny": True, "speculative": 2})
    with pytest.raises(ValueError, match="speculative excludes JSON-constrained"):
        ModelSpec.from_dict("m", {"tiny": True, "speculative": 2, "warmup_json": True})
    assert dataclasses.asdict(spec)["speculative"] == 4


@pytest.mark.parametrize("depth,width,fits", [(4, 4, True), (9, 7, True), (16, 4, False),
                                              (8, 8, False)])
def test_card_spec_refuses_a_tree_past_the_kernel_tile(depth, width, fits):
    """No tree is refused any more: the card's tree kernel walks the tree in
    tiles, so a spec of any size is taken on the card as on the CPU, when
    the spec is read and by the registry's checks, on either side of the
    first kernel's one 64-node tile (``fits``)."""
    assert (1 + width * depth <= 64) == fits
    conf = {"tiny": True, "speculative": depth, "spec_width": width}
    assert ModelSpec.from_dict("m", dict(conf, device="cpu")).speculative == depth
    spec = ModelSpec.from_dict("m", conf)
    assert torch.device(spec.device).type == "cuda" and spec.speculative == depth
    assert spec.spec_width == width
    # the registry's checks, which it runs before it builds the engine
    assert _check_speculative(ModelSpec(name="m", device="cuda", **conf)) is None


def test_cpu_spec_engine_serves_a_tree_past_the_kernel_tile(tiny0):
    """The CPU twin takes a 65-node tree: greedy ids equal the plain
    engine's."""
    _, _, cfg, params = tiny0
    tok = ByteTokenizer()
    prompt = tok.encode("ab cd ab cd ab cd ab cd")

    def run(**kw):
        eng = _port(cfg, params, max_slots=2, max_seq_len=128, **kw)
        eng._running = True
        futs = [eng.submit(prompt, max_tokens=12, temperature=0.0)]
        _crank(eng, futs)
        return futs[0].result(timeout=0).token_ids, eng

    spec, eng = run(speculative=16, spec_width=4)
    plain, _ = run()
    assert spec == plain
    assert eng.spec_stats()["spec_ticks"] > 0
