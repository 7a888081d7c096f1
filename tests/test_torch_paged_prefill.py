"""The paged prefill plane (``ops.attention.paged_prefill_attention`` and the
chunk's token write in ``models.llama``) on the CPU at a tiny geometry,
against the JAX package on identical numpy inputs.

- ``paged_prefill_attention_plain`` against the JAX composition it stands
  for (``_gather_paged_rows``, ``_write_cache``, ``gqa_dot_product_attention``
  under the causal mask and the window), f32 queries, within 1e-5: start 0,
  mid-page, page-aligned, ``S - C``, a start past ``S - C`` (the clamped
  write window), a window, a pad row, sentinel blocks, e4m3 and e5m2 pools;
- the token write (``_chunk_write_targets`` + ``_write_chunk_tokens``)
  bitwise equal, on every page but the dump page, to the JAX scatter of the
  whole written blocks it replaces, on the same cases (a copy-on-write
  boundary page written, the shared pages untouched);
- the kernel's key-tile range (``paged_prefill_key_tiles``, mirrored by the
  CUDA code) against the mask's live keys for every query tile;
- ``prefill_suffix_paged`` bit for bit what the gather + whole-row
  attention + whole-block scatter it replaced gives on the CPU, with one
  ``paged_prefill_attention`` call a layer; the legacy ``prefill_suffix``
  likewise against its row copy + write-back, through
  ``chunked_prefill_attention``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from django_assistant_bot_tpu.models import llama as jllama
from django_assistant_bot_tpu.ops import attention as jattn
from django_assistant_bot_tpu_torch.models import DecoderConfig, llama
from django_assistant_bot_tpu_torch.ops.attention import (
    gather_paged_rows,
    gqa_dot_product_attention,
    paged_prefill_attention,
    paged_prefill_attention_plain,
    paged_prefill_key_tiles,
)
from django_assistant_bot_tpu_torch.ops.quant import to_kv_dtype

B, H, KH, D, PAGE, NB, C, P = 3, 4, 2, 16, 16, 8, 32, 28
S = NB * PAGE  # 128
FMTS = {"f32": torch.float32, "e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2}
JFMTS = {"f32": jnp.float32, "e4m3": jnp.float8_e4m3fn, "e5m2": jnp.float8_e5m2}

# name -> (starts, window, pool format, pad row)
CASES = {
    "start0": ([0, 0, 0], None, "f32", False),
    "mid_page": ([5, 21, 40], None, "f32", False),
    "page_aligned": ([16, 32, 64], None, "f32", False),
    "shared_page": ([21, 40, 0], None, "f32", False),
    "s_minus_c": ([S - C, S - C - 1, 50], None, "f32", False),
    "clamped": ([S - C + 7, S - 1, 3], None, "f32", False),
    "window": ([5, 40, 96], 20, "f32", False),
    "pad_row": ([0, 21, 40], None, "f32", True),
    "e4m3": ([5, 21, 64], None, "e4m3", False),
    "e5m2": ([5, 21, 64], 24, "e5m2", False),
}


def _inputs(name):
    """Pools (numpy f32, then cast to the case's format), a chunk, block
    tables whose rows share prefix pages, sentinels past each row's chain,
    and one pad row of sentinels where the case asks for it."""
    starts, window, fmt, pad = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    scale = 4.0 if fmt != "f32" else 1.0
    k_pool = (rng.normal(size=(P, KH, PAGE, D)) * scale).astype(np.float32)
    v_pool = (rng.normal(size=(P, KH, PAGE, D)) * scale).astype(np.float32)
    q = rng.normal(size=(B, H, C, D)).astype(np.float32)
    k_new = (rng.normal(size=(B, KH, C, D)) * scale).astype(np.float32)
    v_new = (rng.normal(size=(B, KH, C, D)) * scale).astype(np.float32)
    bt = np.full((B, NB), P, np.int32)  # P: the unallocated sentinel
    st = np.asarray(starts, np.int64)
    free = list(rng.permutation(P))
    for b in range(B):
        used = -(-(min(st[b], S - C) + C) // PAGE)
        bt[b, :used] = [free.pop() for _ in range(used)]
    if min(st[0], st[1]) >= PAGE:
        bt[1, 0] = bt[0, 0]  # a shared prefix page, below both rows' writes
    if pad:
        bt[0] = P
    return q, k_pool, v_pool, k_new, v_new, bt, st, window, fmt


def _torch_pools(k_pool, v_pool, fmt):
    """The port's pools: the case's format and the dump page (NaN in f32)."""
    dump = np.full((1, KH, PAGE, D), np.nan, np.float32)
    return tuple(to_kv_dtype(torch.from_numpy(np.concatenate([p, dump])), FMTS[fmt])
                 for p in (k_pool, v_pool))


def _jax_rows(k_pool, v_pool, k_new, v_new, bt, st, fmt):
    """The JAX composition's logical rows: the gathered pages with the chunk
    written in (``astype`` to the pool's format)."""
    jf = JFMTS[fmt]
    cache = jllama.PagedKVCache(k=jnp.asarray(k_pool[None]).astype(jf),
                                v=jnp.asarray(v_pool[None]).astype(jf),
                                lengths=jnp.zeros((B,), jnp.int32))
    k_rows, v_rows = jllama._gather_paged_rows(cache, jnp.asarray(bt))
    sj = jnp.asarray(st.astype(np.int32))
    return (cache, jllama._write_cache(k_rows[0], jnp.asarray(k_new), sj),
            jllama._write_cache(v_rows[0], jnp.asarray(v_new), sj))


@pytest.mark.parametrize("name", list(CASES))
def test_plain_twin_matches_jax_composition(name):
    """The twin against gather + ``_write_cache`` + masked
    ``gqa_dot_product_attention`` in JAX: f32 queries, within 1e-5 (f32
    summation order)."""
    q, k_pool, v_pool, k_new, v_new, bt, st, window, fmt = _inputs(name)
    _, k_row, v_row = _jax_rows(k_pool, v_pool, k_new, v_new, bt, st, fmt)
    pos = st[:, None] + np.arange(C)[None, :]
    kpos = np.arange(S)[None, None, None, :]
    mask = kpos <= pos[:, None, :, None]
    if window is not None:
        mask &= kpos > pos[:, None, :, None] - window
    ref = np.asarray(jattn.gqa_dot_product_attention(jnp.asarray(q), k_row, v_row,
                                                     mask=jnp.asarray(mask)))
    kp, vp = _torch_pools(k_pool, v_pool, fmt)
    kc, vc = (to_kv_dtype(torch.from_numpy(x), FMTS[fmt]) for x in (k_new, v_new))
    out = paged_prefill_attention_plain(torch.from_numpy(q), kc, vc, kp, vp,
                                        torch.from_numpy(bt), torch.from_numpy(st), window=window)
    assert out.shape == (B, H, C, D) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)
    # the dispatch runs the twin on a CPU tensor
    same = paged_prefill_attention(torch.from_numpy(q), kc, vc, kp, vp, torch.from_numpy(bt),
                                   torch.from_numpy(st), window=window)
    assert torch.equal(same, out)


@pytest.mark.parametrize("name", list(CASES))
def test_token_write_matches_whole_block_scatter(name):
    """The chunk's C tokens written to their pages land, on every page but
    the dump page, the bytes of the JAX scatter of the whole written blocks
    (``_scatter_paged_rows`` under the ``[start, start + valid)`` block mask):
    a written block's other positions keep the page's values, the shared
    prefix pages and every unwritten page stay untouched."""
    q, k_pool, v_pool, k_new, v_new, bt, st, window, fmt = _inputs(name)
    valids = np.minimum(np.asarray([C, C - 7, 1]), S - st)
    if CASES[name][3]:
        valids[0] = 0  # the pad row writes nothing
    cache, k_row, v_row = _jax_rows(k_pool, v_pool, k_new, v_new, bt, st, fmt)
    blk = np.arange(NB)[None, :]
    written = ((blk + 1) * PAGE > st[:, None]) & (blk * PAGE < (st + valids)[:, None])
    jk = jllama._scatter_paged_rows(cache.k, k_row[None], jnp.asarray(bt), written)
    jv = jllama._scatter_paged_rows(cache.v, v_row[None], jnp.asarray(bt), written)

    kp, vp = _torch_pools(k_pool, v_pool, fmt)
    before = kp.clone()
    kc, vc = (to_kv_dtype(torch.from_numpy(x), FMTS[fmt]) for x in (k_new, v_new))
    pages, offsets = llama._chunk_write_targets(torch.from_numpy(bt), torch.from_numpy(st),
                                                torch.from_numpy(valids), C, PAGE, P)
    llama._write_chunk_tokens(kp, kc, pages, offsets)
    llama._write_chunk_tokens(vp, vc, pages, offsets)
    for got, want in ((kp, jk), (vp, jv)):
        np.testing.assert_array_equal(got[:P].view(torch.uint8).numpy(),
                                      np.asarray(want[0]).view(np.uint8))
    untouched = sorted(set(range(P)) - {int(bt[b, j]) for b, j in zip(*np.nonzero(written))
                                         if bt[b, j] < P})
    assert torch.equal(kp[untouched].view(torch.uint8), before[untouched].view(torch.uint8))


@pytest.mark.parametrize("C_", [32, 48, 64, 100, 512])
def test_key_tiles_cover_the_live_keys(C_):
    """For every query tile of a ``C_``-token chunk at every start that
    keeps it inside the row (and past it, clamped), with and without a
    window, the kernel's key tiles ``[lo, hi)`` hold every key the twin
    weighs for the tile's rows (the mask's, or every key of the row for a
    row that keeps none), and their first and last tiles hold one."""
    S_, T = 1024, 64
    for start in sorted({0, 1, 63, 64, 65, 300, 511, 512, S_ - C_, S_ - C_ + 5}):
        for window in (None, 1, 20, 100, 700):
            for q0 in range(0, C_, T):
                lo, hi = paged_prefill_key_tiles(start, C_, S_, q0, window)
                pos = start + np.arange(q0, min(q0 + T, C_))
                kpos = np.arange(S_)
                keep = kpos[None, :] <= pos[:, None]
                if window is not None:
                    keep &= kpos[None, :] > pos[:, None] - window
                keep[~keep.any(axis=1)] = True  # a uniform softmax over the row
                live = np.nonzero(keep.any(axis=0))[0]
                assert 0 <= lo <= hi <= S_ // T
                assert lo * T <= live.min() and live.max() < hi * T, (start, window, q0)
                assert live.min() // T == lo and live.max() // T == hi - 1, (start, window, q0)


def _old_prefill_suffix_paged(params, cfg, input_ids, cache, block_tables, slots, starts,
                              valids):
    """What ``prefill_suffix_paged`` computed before the paged prefill
    plane: the gathered logical rows, the chunk written into them, plain
    attention over the whole row, the whole written blocks scattered
    back."""
    Bq, Cq = input_ids.shape
    page = cache.page_size
    NBq = block_tables.shape[1]
    Sq = NBq * page
    Pq = cache.n_pages
    ar = torch.arange(Cq)
    starts = starts.long()
    pos = starts[:, None] + ar[None, :]
    wpos = starts.clamp(max=Sq - Cq)[:, None] + ar[None, :]
    cos_t, sin_t = llama._rope_tables(cfg, Sq, input_ids.device)
    rope_pos = pos.clamp(max=Sq - 1)
    cos, sin = cos_t[rope_pos], sin_t[rope_pos]
    x = llama._embed(params, cfg, input_ids)
    kpos = torch.arange(Sq)[None, None, None, :]
    causal_keep = kpos <= pos[:, None, :, None]
    rows = torch.arange(Bq)[:, None]
    blk = torch.arange(NBq)[None, :]
    ends = (starts + valids.long())[:, None]
    write = ((blk + 1) * page > starts[:, None]) & (blk * page < ends)
    tgt = torch.where(write, block_tables.long().clamp(max=Pq), Pq).reshape(-1)
    for l, window in enumerate(llama._layer_windows(cfg)):
        attn_mask = causal_keep
        if window is not None:
            attn_mask = attn_mask & (kpos > pos[:, None, :, None] - window)
        p = llama._layer(params, l)
        h = llama.rms_norm(x, p["attn_norm"], cfg.rms_norm_eps)
        q, k, v = llama._attn_proj(cfg, p, h, cos, sin)
        k_row = gather_paged_rows(cache.k[l], block_tables)
        v_row = gather_paged_rows(cache.v[l], block_tables)
        k_row[rows, :, wpos, :] = to_kv_dtype(k.transpose(1, 2), k_row.dtype)
        v_row[rows, :, wpos, :] = to_kv_dtype(v.transpose(1, 2), v_row.dtype)
        o = gqa_dot_product_attention(q, k_row, v_row, mask=attn_mask)
        o = o.transpose(1, 2).reshape(Bq, Cq, -1)
        x = x + llama.qeinsum("bso,oe->bse", o, p["wo"], cfg.dtype)
        h = llama.rms_norm(x, p["mlp_norm"], cfg.rms_norm_eps)
        x = x + llama._mlp(cfg, p, h)
        for pool, row in ((cache.k[l], k_row), (cache.v[l], v_row)):
            KHq, Dq = pool.shape[1], pool.shape[3]
            pool[tgt] = row.reshape(Bq, KHq, NBq, page, Dq).transpose(1, 2).reshape(-1, KHq, page, Dq)
    llama._set_lengths(cache.lengths, slots, ends[:, 0])
    x = llama.rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    last = x[torch.arange(Bq), (valids.long() - 1).clamp(min=0)]
    return llama._head_logits(params, cfg, last).float(), cache


@pytest.mark.parametrize("kv", ["f32", "e4m3"])
@pytest.mark.parametrize("window", [None, 24])
def test_prefill_suffix_paged_is_bitwise_the_gathered_row_path(monkeypatch, kv, window):
    """On the CPU ``prefill_suffix_paged`` gives the logits, pages and
    lengths of the path it replaced, bit for bit (a COW boundary page, a
    page-aligned start, a pad row), and its attention goes through
    ``paged_prefill_attention`` once a layer."""
    import dataclasses

    cfg = dataclasses.replace(DecoderConfig.tiny(), sliding_window=window, window_layer_start=1)
    params = llama.init(cfg, torch.Generator().manual_seed(5), "cpu")
    Pn = 24
    rng = np.random.default_rng(6)
    shape = (cfg.num_layers, Pn + 1, cfg.num_kv_heads, 32, cfg.head_dim)
    k = to_kv_dtype(torch.from_numpy(rng.normal(size=shape).astype(np.float32)), FMTS[kv])
    v = to_kv_dtype(torch.from_numpy(rng.normal(size=shape).astype(np.float32)), FMTS[kv])
    bt = np.full((4, 8), Pn, np.int32)
    bt[1, :3] = [4, 10, 11]
    bt[2, :3] = [2, 3, 12]
    bt[3, :5] = [4, 1, 6, 13, 14]
    args = [torch.from_numpy(a) for a in (
        np.random.default_rng(7).integers(1, 255, (4, 32)).astype(np.int32), bt,
        np.asarray([4, 0, 1, 3], np.int32), np.asarray([0, 40, 64, 100], np.int32),
        np.asarray([0, 20, 32, 9], np.int32))]
    ids, bt_t, slots, starts, valids = args

    def cache():
        return llama.PagedKVCache(k=k.clone(), v=v.clone(),
                                  lengths=torch.zeros((4,), dtype=torch.int32))

    calls = []
    real = llama.paged_prefill_attention
    monkeypatch.setattr(llama, "paged_prefill_attention",
                        lambda *a, **kw: calls.append(kw["window"]) or real(*a, **kw))
    with torch.no_grad():
        lt, tc = llama.prefill_suffix_paged(params, cfg, ids, cache(), bt_t, slots, starts, valids)
        lo, oc = _old_prefill_suffix_paged(params, cfg, ids, cache(), bt_t, slots, starts, valids)
    assert calls == [None, window]
    assert torch.equal(lt, lo)
    for new, old in ((tc.k, oc.k), (tc.v, oc.v)):
        assert torch.equal(new[:, :Pn].view(torch.uint8), old[:, :Pn].view(torch.uint8))
    assert torch.equal(tc.lengths, oc.lengths)


def _old_prefill_suffix(params, cfg, input_ids, cache, slots, starts, valids):
    """What the legacy ``prefill_suffix`` computed before it read its rows
    through ``chunked_prefill_attention``: each slot row copied, the
    suffix written in, plain attention over the row, the rows written back
    whole in row order (the last writer's)."""
    Bq, Cq = input_ids.shape
    Sq = cache.max_len
    starts = starts.long()
    pos = starts[:, None] + torch.arange(Cq)[None, :]
    cos_t, sin_t = llama._rope_tables(cfg, Sq, input_ids.device)
    rope_pos = pos.clamp(max=Sq - 1)
    cos, sin = cos_t[rope_pos], sin_t[rope_pos]
    x = llama._embed(params, cfg, input_ids)
    kpos = torch.arange(Sq)[None, None, None, :]
    causal_keep = kpos <= pos[:, None, :, None]
    sl = slots.long()
    last = llama._last_writer(sl)
    for l, window in enumerate(llama._layer_windows(cfg)):
        attn_mask = causal_keep
        if window is not None:
            attn_mask = attn_mask & (kpos > pos[:, None, :, None] - window)
        p = llama._layer(params, l)
        h = llama.rms_norm(x, p["attn_norm"], cfg.rms_norm_eps)
        q, k, v = llama._attn_proj(cfg, p, h, cos, sin)
        k_row, v_row = cache.k[l][sl], cache.v[l][sl]
        llama._write_cache(k_row, k, starts)
        llama._write_cache(v_row, v, starts)
        o = gqa_dot_product_attention(q, k_row, v_row, mask=attn_mask)
        o = o.transpose(1, 2).reshape(Bq, Cq, -1)
        x = x + llama.qeinsum("bso,oe->bse", o, p["wo"], cfg.dtype)
        h = llama.rms_norm(x, p["mlp_norm"], cfg.rms_norm_eps)
        x = x + llama._mlp(cfg, p, h)
        cache.k[l][sl] = k_row[last]
        cache.v[l][sl] = v_row[last]
    cache.lengths[sl] = (starts + valids.long()).to(cache.lengths.dtype)[last]
    x = llama.rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    last_tok = x[torch.arange(Bq), (valids.long() - 1).clamp(min=0)]
    return llama._head_logits(params, cfg, last_tok).float(), cache


@pytest.mark.parametrize("kv", ["f32", "e5m2"])
@pytest.mark.parametrize("window", [None, 24])
def test_legacy_prefill_suffix_is_bitwise_the_row_copy_path(monkeypatch, kv, window):
    """The legacy plane's ``prefill_suffix`` on the CPU gives the logits,
    slot cache and lengths of the path it replaced, bit for bit: rows
    continuing from 40 / 64 / 100 and a suffix at the row's end (the write
    window clamped), two batch-pad rows aliasing slot 1 ahead of it, and one
    ``chunked_prefill_attention`` call a layer."""
    import dataclasses

    cfg = dataclasses.replace(DecoderConfig.tiny(), sliding_window=window, window_layer_start=1)
    params = llama.init(cfg, torch.Generator().manual_seed(8), "cpu")
    rng = np.random.default_rng(9)
    shape = (cfg.num_layers, 4, cfg.num_kv_heads, cfg.max_seq_len, cfg.head_dim)
    k = to_kv_dtype(torch.from_numpy(rng.normal(size=shape).astype(np.float32)), FMTS[kv])
    v = to_kv_dtype(torch.from_numpy(rng.normal(size=shape).astype(np.float32)), FMTS[kv])
    ids, slots, starts, valids = (torch.from_numpy(a) for a in (
        np.random.default_rng(10).integers(1, 255, (6, 32)).astype(np.int32),
        np.asarray([1, 1, 1, 0, 2, 3], np.int64), np.asarray([0, 0, 40, 64, 100, 250], np.int64),
        np.asarray([0, 0, 20, 32, 9, 6], np.int64)))

    def cache():
        return llama.KVCache(k=k.clone(), v=v.clone(), lengths=torch.zeros((4,), dtype=torch.int32))

    calls = []
    real = llama.chunked_prefill_attention
    monkeypatch.setattr(llama, "chunked_prefill_attention",
                        lambda *a, **kw: calls.append(kw["window"]) or real(*a, **kw))
    with torch.no_grad():
        lt, tc = llama.prefill_suffix(params, cfg, ids, cache(), slots, starts, valids)
        lo, oc = _old_prefill_suffix(params, cfg, ids, cache(), slots, starts, valids)
    assert calls == [None, window]
    assert torch.equal(lt, lo)
    for new, old in ((tc.k, oc.k), (tc.v, oc.v), (tc.lengths, oc.lengths)):
        assert torch.equal(new.view(torch.uint8) if new.is_floating_point() else new,
                           old.view(torch.uint8) if old.is_floating_point() else old)


def test_dispatch_refuses_a_device_it_has_no_kernel_for():
    """Only CPU tensors run the twin: any other device goes to the kernel,
    or raises (here, the meta device)."""
    q = torch.empty((1, H, C, D), device="meta")
    kc = torch.empty((1, KH, C, D), device="meta")
    pool = torch.empty((P + 1, KH, PAGE, D), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        paged_prefill_attention(q, kc, kc, pool, pool, torch.zeros((1, NB), dtype=torch.int32),
                                torch.zeros((1,), dtype=torch.int64))


def test_cpu_engine_reports_no_piggyback_graph_launches():
    """``decode_path_stats`` names the chunk + tick graph's launches (the
    card's); a CPU engine captures no graph, so both are empty."""
    from django_assistant_bot_tpu_torch.serving import ByteTokenizer, GenerationEngine

    cfg = DecoderConfig.tiny()
    eng = GenerationEngine(cfg, llama.init(cfg, torch.Generator().manual_seed(1), "cpu"),
                           ByteTokenizer(), device="cpu", max_slots=2, max_seq_len=256)
    dec = eng.decode_path_stats()
    assert dec["piggyback_launches"] == {} and dec["piggyback_paged_prefill_forms"] == {}
