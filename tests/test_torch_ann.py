"""The port's IVF-PQ index against the JAX package's (CPU):

- the ADC scan and shortlist: a JAX index bridged into the port
  (``convert.ann_from_jax``, the same quantizers and codes), the port's
  ``_adc_shortlist`` (``adc_shortlist_plain`` on CPU tensors) against JAX
  ``_adc_shortlist``: scores within 1e-5 (the centroid scores and the LUT
  are f32 products whose summation order differs between the frameworks;
  the m-term LUT sum itself runs in the JAX loop's order), positions equal
  but where two neighbouring scores lie within 1e-5 (a boundary tie);
  planted duplicate rows (bit-equal scores) and an all-invalid list in the
  twin, lower flat index first as ``lax.top_k``;
- the rerank: ``rerank_plain`` against JAX ``_rerank`` at
  ``knn_check.topk_score_bound`` (the same exact bf16 products summed in
  other orders);
- whole ``search_batch`` results on bridged indexes, also after tombstones:
  ids equal, scores within the bound;
- the JAX tests' contracts (``tests/test_ann.py``) on the port's own
  training: k-means, PQ, spill caps, recall@10 >= 0.9 at the default
  nprobe, the exact tier untrained and under an allow-list, appends without
  retrain and under concurrent queries, tombstones and compaction,
  overwrite, clear; and the ``_scatter_codes`` padding, which must leave the
  last list's slots intact.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from django_assistant_bot_tpu.storage import ann as jann
from django_assistant_bot_tpu_torch import kernels
from django_assistant_bot_tpu_torch.convert import ann_from_jax
from django_assistant_bot_tpu_torch.storage import ann as pann
from django_assistant_bot_tpu_torch.storage import knn as pknn
from django_assistant_bot_tpu_torch.storage.knn_check import topk_score_bound

ADC_TOL = 1e-5


def jax_arrays(ix) -> dict:
    """A JAX ``ANNIndex``'s state as numpy arrays, for ``ann_from_jax``."""
    out = dict(dim=ix.dim, nlist=ix.nlist, m=ix.m, nprobe=ix.nprobe,
               rerank_depth=ix.rerank_depth, seed=ix.seed, ids=np.asarray(ix._ids, np.int64),
               mat=ix._mat[: ix._n], dead=np.asarray(sorted(ix._dead), np.int64))
    if ix._rerank is not None:
        out.update(rerank_bits=np.asarray(ix._rerank).view(np.uint16),
                   rvalid=np.asarray(ix._rvalid), rerank_count=ix._rerank_count)
    if ix._trained:
        out.update(centroids=np.asarray(ix._centroids), codebooks=np.asarray(ix._codebooks),
                   codes=np.asarray(ix._codes), lvalid=np.asarray(ix._lvalid),
                   rowpos=np.asarray(ix._rowpos), row_list=ix._row_list, row_slot=ix._row_slot,
                   list_counts=ix._list_counts, list_sums=ix._list_sums)
    return out


_JAX_INDEXES: dict = {}


def jax_index(n, dim, seed, **kw):
    """A trained JAX index over ``make_clustered(n, dim, seed)`` (built once
    per shape: the JAX side compiles per shape)."""
    key = (n, dim, seed, tuple(sorted(kw.items())))
    if key not in _JAX_INDEXES:
        rows = jann.make_clustered(n, dim, seed=seed)
        ix = jann.ANNIndex(dim, seed=seed, **kw)
        ix.add(range(n), rows)
        ix.train()
        _JAX_INDEXES[key] = (ix, rows)
    return _JAX_INDEXES[key]


def _padded_queries(rows, dim, n_q=4):
    q = jann._normalize(rows[:: max(1, rows.shape[0] // n_q)][:n_q] + 0.01)
    return np.concatenate([q, np.zeros((8 - q.shape[0], dim), np.float32)]).astype(np.float32)


def _positions_agree(s_ref, p_ref, p_got, tol):
    """Positions equal at every rank whose score is further than ``tol``
    from both neighbours (the rank after the cut counts as a neighbour)."""
    s = np.concatenate([np.full((s_ref.shape[0], 1), np.inf), s_ref,
                        np.full((s_ref.shape[0], 1), -np.inf)], axis=1)
    with np.errstate(invalid="ignore"):
        gap = np.minimum(s[:, :-2] - s[:, 1:-1], s[:, 1:-1] - s[:, 2:])
    sep = np.isfinite(s_ref) & (gap > tol)
    return bool((p_ref[sep] == p_got[sep]).all()), int(sep.sum())


def _same_rows_but_at_the_cut(s_ref, p_ref, s_got, p_got, tol):
    """Per query: every row in both shortlists scored within ``tol`` alike,
    and a row in only one of them within ``tol`` of that shortlist's last
    finite score (a boundary tie)."""
    for q in range(s_ref.shape[0]):
        fin_r, fin_g = np.isfinite(s_ref[q]), np.isfinite(s_got[q])
        ref = dict(zip(p_ref[q][fin_r].tolist(), s_ref[q][fin_r].tolist()))
        got = dict(zip(p_got[q][fin_g].tolist(), s_got[q][fin_g].tolist()))
        for pos in ref.keys() & got.keys():
            if abs(ref[pos] - got[pos]) > tol:
                return False
        for one, cut in ((ref, s_ref[q][fin_r]), (got, s_got[q][fin_g])):
            other = got if one is ref else ref
            for pos in one.keys() - other.keys():
                if one[pos] - cut.min() > tol:
                    return False
    return True


def test_make_clustered_is_the_jax_generator():
    np.testing.assert_array_equal(pann.make_clustered(300, 24, seed=5),
                                  jann.make_clustered(300, 24, seed=5))


@pytest.mark.parametrize("nprobe,shortlist", [(2, 64), (8, 256), (16, 512)])
@pytest.mark.parametrize("n,dim,kw", [(2000, 32, {}), (6000, 64, {}), (1500, 48, {"m": 6})])
def test_adc_shortlist_matches_jax(n, dim, kw, nprobe, shortlist):
    ix, rows = jax_index(n, dim, seed=3, **kw)
    port = ann_from_jax(jax_arrays(ix), "cpu")
    q = _padded_queries(rows, dim)
    nprobe = min(nprobe, ix.nlist)
    shortlist = min(shortlist, nprobe * port._codes.shape[1])
    js, jp = jann._adc_shortlist(ix._centroids, ix._codebooks, ix._codes, ix._lvalid,
                                 ix._rowpos, jnp.asarray(q), nprobe, shortlist)
    js, jp = np.asarray(js), np.asarray(jp)
    ps, pp = pann._adc_shortlist(port._centroids, port._codebooks, port._codes, port._lvalid,
                                 port._rowpos, torch.from_numpy(q), nprobe, shortlist)
    ps, pp = ps.numpy(), pp.numpy()
    np.testing.assert_array_equal(np.isfinite(js), np.isfinite(ps))
    fin = np.isfinite(js)
    assert np.abs(js[fin] - ps[fin]).max() <= ADC_TOL
    same, _ = _positions_agree(js, jp, pp, 2 * ADC_TOL)
    assert same and _same_rows_but_at_the_cut(js, jp, ps, pp, 2 * ADC_TOL)


def test_adc_scores_match_dequantized_reference():
    """``tests/test_ann.py``'s reference on the port's own index: every live
    slot's score is ``q . c_list + sum_m q_m . codebook[m, code_m]``."""
    dim, n = 32, 512
    rows = pann.make_clustered(n, dim, n_clusters=8, seed=3)
    index = pann.ANNIndex(dim, nlist=8, m=4, seed=3, device="cpu")
    index.add(range(n), rows)
    index.train()
    cent, cb = index._centroids.numpy(), index._codebooks.numpy()
    codes, lvalid, rowpos = index._codes.numpy(), index._lvalid.numpy(), index._rowpos.numpy()
    nlist, list_cap, m = codes.shape
    sub = cb.shape[2]
    q = pknn._normalize(pann.make_clustered(4, dim, n_clusters=8, seed=7))
    sl = nlist * list_cap
    sl_scores, sl_pos = pann._adc_shortlist(
        index._centroids, index._codebooks, index._codes, index._lvalid, index._rowpos,
        torch.from_numpy(q), nlist, sl)
    sl_scores, sl_pos = sl_scores.numpy(), sl_pos.numpy()
    ref = {}
    q_sub = q.reshape(4, m, sub)
    for li in range(nlist):
        for si in range(list_cap):
            if lvalid[li, si]:
                dec = cb[np.arange(m), codes[li, si]]
                for qi in range(4):
                    ref[(qi, int(rowpos[li, si]))] = float(q[qi] @ cent[li] + (q_sub[qi] * dec).sum())
    checked = 0
    for qi in range(4):
        for j in range(sl):
            if np.isfinite(sl_scores[qi, j]):
                assert ref[(qi, int(sl_pos[qi, j]))] == pytest.approx(float(sl_scores[qi, j]),
                                                                      abs=2e-3)
                checked += 1
    assert checked >= 4 * n


def test_adc_shortlist_plain_ties_and_invalid_list():
    """Bit-equal scores (duplicate codes in a list, and the same codes in two
    probed lists of equal centroid score) come out lower flat index first,
    an all-invalid list contributes only -inf, and the twin equals the JAX
    function's shortlist on the same inputs."""
    rng = np.random.default_rng(0)
    nlist, L, m, Q, P = 6, 16, 5, 3, 4
    codes = rng.integers(0, 256, size=(nlist, L, m)).astype(np.uint8)
    codes[1, 7] = codes[1, 2]  # a duplicate row in list 1
    codes[3] = codes[1]  # list 3 repeats list 1
    lvalid = rng.random((nlist, L)) < 0.8
    lvalid[1, [2, 7]] = True
    lvalid[3] = lvalid[1]
    lvalid[4] = False  # an all-invalid list
    rowpos = rng.permutation(nlist * L).reshape(nlist, L).astype(np.int32)
    top_ci = np.array([[1, 3, 4, 0], [4, 1, 3, 2], [0, 1, 2, 3]], np.int32)
    top_c = np.full((Q, P), 0.5, np.float32)
    lut = rng.standard_normal((Q, m, 256)).astype(np.float32)
    S = P * L
    got_s, got_p = pann.adc_shortlist(*(torch.from_numpy(a) for a in
                                        (codes, lvalid, rowpos, top_ci, top_c, lut)), S)
    got_s, got_p = got_s.numpy(), got_p.numpy()
    # the JAX function's arithmetic on the same inputs
    pc = codes[top_ci].reshape(Q, P * L, m).astype(np.int64)
    acc = np.zeros((Q, P * L), np.float32)
    for j in range(m):
        acc = acc + np.take_along_axis(lut[:, j, :], pc[:, :, j], axis=1)
    scores = np.repeat(top_c, L, axis=1) + acc
    scores = np.where(lvalid[top_ci].reshape(Q, -1), scores, -np.inf)
    js, ji = jax_top_k(scores, S)
    np.testing.assert_array_equal(got_s, js)
    np.testing.assert_array_equal(got_p, np.take_along_axis(rowpos[top_ci].reshape(Q, -1), ji, 1))
    # query 0: list 1's duplicate pair, and lists 1 and 3's equal slots, tie bit for bit
    q0 = dict(zip(got_p[0].tolist(), got_s[0].tolist()))
    assert q0[int(rowpos[1, 2])] == q0[int(rowpos[1, 7])] == q0[int(rowpos[3, 2])]
    assert (got_s[1] == -np.inf).sum() >= L  # list 4 is all -inf


def jax_top_k(x: np.ndarray, k: int):
    import jax

    s, i = jax.lax.top_k(jnp.asarray(x), k)
    return np.asarray(s), np.asarray(i)


@pytest.mark.parametrize("k", [1, 10, 16])
@pytest.mark.parametrize("dead", [False, True])
def test_rerank_plain_matches_jax(k, dead):
    ix, rows = jax_index(2000, 32, seed=3)
    port = ann_from_jax(jax_arrays(ix), "cpu")
    q = _padded_queries(rows, 32)
    js_l, jp_l = jann._adc_shortlist(ix._centroids, ix._codebooks, ix._codes, ix._lvalid,
                                     ix._rowpos, jnp.asarray(q), 8, 64)
    rvalid = np.asarray(ix._rvalid).copy()
    if dead:
        rvalid[np.asarray(jp_l)[:, ::3].reshape(-1)] = False
    js, jp = jann._rerank(ix._rerank, jnp.asarray(rvalid), jnp.asarray(q), js_l, jp_l, k)
    js, jp = np.asarray(js), np.asarray(jp)
    ps, pp = pann.rerank_plain(port._rerank, torch.from_numpy(rvalid), torch.from_numpy(q),
                               torch.from_numpy(np.array(js_l)),
                               torch.from_numpy(np.array(jp_l)), k)
    bound = topk_score_bound(torch.from_numpy(q), port._rerank).numpy()[:, None]
    fin = np.isfinite(js)
    np.testing.assert_array_equal(fin, np.isfinite(ps.numpy()))
    assert (np.abs(js - ps.numpy())[fin] <= np.broadcast_to(bound, js.shape)[fin]).all()
    same, _ = _positions_agree(js, jp, pp.numpy(), 2 * bound.max())
    assert same


def test_rerank_agreement_holds_the_twin_and_catches_a_swap():
    """``knn_check.rerank_agreement`` (the card tests' and the smoke's check
    of the rerank kernel) passes the twin's own result and objects to a
    result with two separated ranks swapped or a score moved past the
    bound."""
    from django_assistant_bot_tpu_torch.storage.knn_check import rerank_agreement

    ix, rows = jax_index(2000, 32, seed=3)
    port = ann_from_jax(jax_arrays(ix), "cpu")
    q = torch.from_numpy(_padded_queries(rows, 32))
    sl_s, sl_p = pann._adc_shortlist(port._centroids, port._codebooks, port._codes,
                                     port._lvalid, port._rowpos, q, 8, 64)
    s, p = pann.rerank_plain(port._rerank, port._rvalid, q, sl_s, sl_p, 10)
    args = (port._rerank, port._rvalid, q, sl_s, sl_p)
    assert not rerank_agreement(*args, s, p)["problems"]
    swapped = p.clone()
    swapped[0, [0, 5]] = p[0, [5, 0]]
    assert rerank_agreement(*args, s, swapped)["problems"]
    moved = s.clone()
    moved[1, 3] += 1e-3
    assert rerank_agreement(*args, moved, p)["problems"]


def _search_ids_scores(rows_out):
    return [[i for i, _ in r] for r in rows_out], [[s for _, s in r] for r in rows_out]


@pytest.mark.parametrize("removed", [0, 150])
@pytest.mark.parametrize("nprobe", [None, 4])
def test_bridged_search_batch_equal(removed, nprobe):
    ix, rows = jax_index(6000, 64, seed=0)
    if removed:
        # tombstones through both packages' own remove (below the compaction
        # fraction): a fresh JAX index so the shared one stays untouched
        ix = jann.ANNIndex(64, seed=0)
        ix.add(range(6000), rows)
        ix.train()
    port = ann_from_jax(jax_arrays(ix), "cpu")
    if removed:
        ix.remove(range(0, 6000, 40))
        port.remove(range(0, 6000, 40))
    qs = rows[::300] + 0.01
    j_ids, j_s = _search_ids_scores(ix.search_batch(qs, k=10, nprobe=nprobe))
    p_ids, p_s = _search_ids_scores(port.search_batch(qs, k=10, nprobe=nprobe))
    assert j_ids == p_ids
    bound = float(topk_score_bound(torch.from_numpy(pknn._normalize(qs)), port._rerank).max())
    assert max(abs(a - b) for x, y in zip(j_s, p_s) for a, b in zip(x, y)) <= bound


def test_ann_from_jax_holds_the_state():
    ix, _ = jax_index(2000, 32, seed=3)
    port = ann_from_jax(jax_arrays(ix), "cpu")
    np.testing.assert_array_equal(port._codes.numpy(), np.asarray(ix._codes))
    np.testing.assert_array_equal(port._rerank.view(torch.int16).numpy(),
                                  np.asarray(ix._rerank).view(np.int16))
    assert port.stats()["nlist"] == ix.stats()["nlist"] and port._trained
    assert port._nprobe_eff() == ix._nprobe_eff()


# ----------------------------------------------------------------- training
def test_kmeans_step_separates_clusters_and_stays_normalized():
    rng = np.random.default_rng(0)
    a = np.array([1.0, 0.0, 0.0, 0.0], np.float32)
    b = np.array([0.0, 1.0, 0.0, 0.0], np.float32)
    batch = pknn._normalize(np.concatenate([
        a + 0.05 * rng.standard_normal((64, 4)).astype(np.float32),
        b + 0.05 * rng.standard_normal((64, 4)).astype(np.float32),
    ])).astype(np.float32)
    cents = torch.from_numpy(batch[[0, 64]])
    counts = torch.zeros((2,))
    for _ in range(8):
        cents, counts = pann._kmeans_step(cents, counts, torch.from_numpy(batch))
    cents = cents.numpy()
    np.testing.assert_allclose(np.linalg.norm(cents, axis=1), 1.0, atol=1e-5)
    sims = np.stack([a, b]) @ cents.T
    assert sims.max(axis=1).min() > 0.98
    assert set(sims.argmax(axis=1)) == {0, 1}


def test_pq_step_reduces_quantization_error():
    rng = np.random.default_rng(1)
    m, sub = 2, 4
    batch = rng.standard_normal((512, m, sub)).astype(np.float32) * 0.1
    cb = torch.from_numpy(rng.standard_normal((m, 256, sub)).astype(np.float32))
    counts = torch.zeros((m, 256))

    def err(codebooks):
        c = codebooks.numpy()
        return (((batch[:, :, None, :] - c[None]) ** 2).sum(-1)).min(axis=2).mean()

    e0 = err(cb)
    for _ in range(6):
        cb, counts = pann._pq_step(cb, counts, torch.from_numpy(batch))
    assert err(cb) < e0 * 0.5


@pytest.mark.parametrize("case", ["runners_up_absorb", "overflow_stays_nearest"])
def test_spill_assign_soft_cap(case):
    """``tests/test_ann.py``'s two spill cases, each also equal to the JAX
    function's assignment and fill."""
    if case == "runners_up_absorb":
        n, cap, nl = 90, 20, 3
        lists2 = np.zeros((n, 2), np.int64)
        lists2[:, 1] = np.where(np.arange(n) % 2 == 0, 1, 2)
    else:
        n, cap, nl = 50, 10, 2
        lists2 = np.zeros((n, 2), np.int64)
        lists2[:, 1] = 1
    fill, jfill = np.zeros(nl, np.int64), np.zeros(nl, np.int64)
    out = pann._spill_assign(lists2, fill, cap)
    np.testing.assert_array_equal(out, jann._spill_assign(lists2, jfill, cap))
    np.testing.assert_array_equal(fill, jfill)
    counts = np.bincount(out, minlength=nl)
    if case == "runners_up_absorb":
        assert counts[1] == cap and counts[2] == cap and counts[0] == n - 2 * cap
    else:
        assert counts[0] == n - cap and counts[1] == cap
    assert counts.sum() == n
    np.testing.assert_array_equal(counts, fill[:nl])


def test_scatter_codes_padding_leaves_last_list_intact():
    """Padding entries carry list index ``nlist`` (the JAX function drops
    them): the port filters them, so the last list keeps its slots."""
    nlist, L, m = 4, 8, 3
    codes = torch.full((nlist, L, m), 7, dtype=torch.uint8)
    lvalid = torch.ones((nlist, L), dtype=torch.bool)
    rowpos = torch.arange(nlist * L, dtype=torch.int32).reshape(nlist, L)
    before = (codes.clone(), lvalid.clone(), rowpos.clone())
    li = torch.tensor([1, nlist, nlist, nlist], dtype=torch.int32)
    si = torch.tensor([2, 0, L - 1, 3], dtype=torch.int32)
    c = torch.tensor([[1, 2, 3], [9, 9, 9], [9, 9, 9], [9, 9, 9]], dtype=torch.uint8)
    pos = torch.tensor([99, 98, 97, 96], dtype=torch.int32)
    pann._scatter_codes(codes, lvalid, rowpos, li, si, c, pos)
    assert codes[1, 2].tolist() == [1, 2, 3] and int(rowpos[1, 2]) == 99
    for t, b in zip((codes, lvalid, rowpos), before):
        assert torch.equal(t[nlist - 1], b[nlist - 1])  # the last list untouched
    pann._tombstone(lvalid, li, si)
    assert not bool(lvalid[1, 2]) and bool(lvalid[nlist - 1].all())
    rvalid = torch.ones(5, dtype=torch.bool)
    pann._mask_positions(rvalid, torch.tensor([4, 5, 5]))
    assert rvalid.tolist() == [True, True, True, True, False]


# ------------------------------------------------------------ recall floors
def test_recall_floor_at_default_nprobe():
    dim, n = 64, 6000
    index = pann.ANNIndex(dim, seed=0, device="cpu")
    index.add(range(n), pann.make_clustered(n, dim, seed=0))
    index.train()
    rec = index.probe_recall(n_queries=64, k=10, seed=0)
    assert rec["recall_at_k"] >= 0.9
    assert index.stats()["last_recall"]["recall_at_k"] == rec["recall_at_k"]


def test_untrained_index_serves_exact_results():
    dim, n = 32, 300
    rows = pann.make_clustered(n, dim, seed=5)
    ann = pann.ANNIndex(dim, device="cpu")
    ann.add(range(n), rows)
    exact = pknn.VectorIndex(dim, device="cpu")
    exact.add(range(n), rows)
    q = rows[17] + 0.01
    a, e = ann.search(q, k=5), exact.search(q, k=5)
    assert [i for i, _ in a] == [i for i, _ in e]
    assert a[0][0] == 17
    assert ann.stats()["exact_fallback"] is True


def test_allowed_ids_uses_exact_tier_on_trained_index():
    dim, n = 32, 1000
    rows = pann.make_clustered(n, dim, seed=6)
    index = pann.ANNIndex(dim, seed=6, device="cpu")
    index.add(range(n), rows)
    index.train()
    allowed = set(range(0, n, 7))
    hits = index.search(rows[21], k=5, allowed_ids=allowed)
    assert hits and all(i in allowed for i, _ in hits)
    assert hits[0][0] == 21
    fenced = index.search(rows[22], k=5, allowed_ids=allowed)
    assert fenced and all(i in allowed and i != 22 for i, _ in fenced)


# --------------------------------------------------------------- liveness
def test_append_after_train_is_searchable_without_retrain():
    dim, n = 32, 2000
    index = pann.ANNIndex(dim, seed=1, device="cpu")
    index.add(range(n), pann.make_clustered(n, dim, seed=1))
    index.train()
    retrains0 = index.stats()["retrains"]
    extra = pann.make_clustered(200, dim, seed=11)
    index.add(range(n, n + 200), extra)
    assert index.stats()["pending_appends"] == 200
    assert index.stats()["retrains"] == retrains0
    hits = index.search(extra[5], k=3)
    assert hits[0][0] == n + 5
    assert hits[0][1] == pytest.approx(1.0, abs=5e-3)


def test_append_under_concurrent_queries():
    dim, n = 32, 2000
    rows = pann.make_clustered(n, dim, seed=2)
    index = pann.ANNIndex(dim, seed=2, device="cpu")
    index.add(range(n), rows)
    index.train()
    stop = threading.Event()
    errors = []

    def hammer():
        qs = rows[:8] + 0.01
        while not stop.is_set():
            try:
                out = index.search_batch(qs, k=5)
                assert len(out) == 8 and all(r for r in out)
            except Exception as e:  # noqa: BLE001 - surface to the main thread
                errors.append(e)
                return

    t = threading.Thread(target=hammer)
    t.start()
    try:
        for b in range(4):
            start = n + b * 100
            index.add(range(start, start + 100), pann.make_clustered(100, dim, seed=20 + b))
        index.train()  # full retrain while queries are in flight
    finally:
        stop.set()
        t.join(timeout=60)
    assert not t.is_alive()
    assert not errors
    assert len(index) == n + 400
    assert index.search(pann.make_clustered(100, dim, seed=23)[7], k=1)[0][0] == n + 307


def test_remove_tombstones_then_compaction():
    dim, n = 32, 1200
    rows = pann.make_clustered(n, dim, seed=4)
    index = pann.ANNIndex(dim, seed=4, device="cpu")
    index.add(range(n), rows)
    index.train()
    index.remove(range(0, 100))
    assert len(index) == n - 100
    assert index.stats()["tombstones"] == 100
    assert all(i >= 100 for i, _ in index.search(rows[13], k=10))
    index.remove(range(100, 400))
    st = index.stats()
    assert st["compactions"] >= 1 and st["tombstones"] == 0
    assert len(index) == n - 400
    assert index.search(rows[500], k=3)[0][0] == 500


def test_add_same_id_overwrites_old_vector():
    dim = 32
    rows = pann.make_clustered(64, dim, seed=8)
    index = pann.ANNIndex(dim, nlist=8, m=4, seed=8, device="cpu")
    index.add(range(64), rows)
    index.train()
    new_vec = -rows[3]
    index.add([3], new_vec[None, :])
    assert len(index) == 64
    assert index.search(new_vec, k=1)[0][0] == 3
    top_old = index.search(rows[3], k=1)[0]
    assert top_old[0] != 3 or top_old[1] < 0.9


def test_clear_resets_to_empty_untrained():
    index = pann.ANNIndex(16, nlist=8, m=4, device="cpu")
    index.add(range(128), pann.make_clustered(128, 16, seed=9))
    index.train()
    index.clear()
    assert len(index) == 0
    assert index.search_batch(np.ones((1, 16), np.float32), k=3) == [[]]
    st = index.stats()
    assert not st["trained"] and st["rows"] == 0


def test_refusals():
    """A sharded index and the ORM loader name their ROADMAP items; a
    kernel-bound call on another device type raises."""
    with pytest.raises(NotImplementedError, match="item 15"):
        pann.ANNIndex(32, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="item 16"):
        pann.ANNIndex.from_model(object())
    meta = torch.zeros((2, 4, 4), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        pann.adc_shortlist(meta, None, None, None, None, None, 1)
    with pytest.raises(ValueError, match="unsupported device"):
        pann.rerank(meta, None, None, None, None, 1)


# ------------------------------------------------- the lists' fill (the scan bound)
def _fill_holds(index):
    """The device fill equals the host high-water marks, every slot at or
    past a list's fill is invalid, and the mean the grid plan reads is
    their mean rounded up."""
    counts = index._list_counts
    fill = index._fill
    assert fill.dtype == torch.int32 and fill.device == index.device
    np.testing.assert_array_equal(fill.numpy(), counts)
    assert index._mean_fill == -(-int(counts.sum()) // max(1, counts.size))
    if index._lvalid is not None:
        lv = index._lvalid.numpy()
        for li, f in enumerate(counts.tolist()):
            assert not lv[li, f:].any(), li
            assert f <= lv.shape[1]


def _trained(n=600, dim=16, seed=31, **kw):
    rows = pann.make_clustered(n, dim, n_clusters=8, seed=seed)
    index = pann.ANNIndex(dim, nlist=8, m=4, seed=seed, device="cpu", **kw)
    index.add(range(n), rows)
    index.train()
    return index, rows


@pytest.mark.parametrize("op", ["train", "add", "overwrite", "remove", "growth", "compact",
                                "retrain", "restore", "clear"])
def test_device_fill_tracks_list_counts(op):
    index, rows = _trained()
    _fill_holds(index)
    if op == "add":
        index.add(range(600, 700), pann.make_clustered(100, 16, n_clusters=8, seed=32))
    elif op == "overwrite":
        index.add([3, 5], -rows[[3, 5]])
    elif op == "remove":
        before = index._list_counts.copy()
        index.remove(range(0, 100, 3))  # below the compaction fraction
        np.testing.assert_array_equal(index._list_counts, before)  # tombstones keep the mark
    elif op == "growth":
        cap = index._codes.shape[1]
        near = np.repeat(rows[:1], 3 * cap, axis=0) + 1e-3 * np.arange(3 * cap)[:, None]
        index.add(range(1000, 1000 + 3 * cap), near.astype(np.float32))
        assert index._codes.shape[1] > cap
    elif op == "compact":
        index.remove(range(0, 300))
        assert index.stats()["compactions"] >= 1
    elif op == "retrain":
        index.add(range(600, 800), pann.make_clustered(200, 16, n_clusters=8, seed=33))
        index.train()
    elif op == "restore":
        index.remove(range(0, 50))
        state = index.snapshot_state()
        back = pann.ANNIndex(16, nlist=8, m=4, seed=31, device="cpu")
        back.restore_state(state)
        index = back
    elif op == "clear":
        index.clear()
        assert index._fill.numel() == 0 and index._mean_fill == 0
    _fill_holds(index)


@pytest.mark.parametrize("removed", [0, 150])
def test_device_fill_after_the_jax_bridge(removed):
    """A JAX index bridged over (its own tombstones in the second case):
    the port's fill is the JAX index's high-water marks."""
    ix, rows = jax_index(2000, 32, seed=3)
    if removed:
        ix = jann.ANNIndex(32, seed=3)  # a fresh one: the shared index stays untouched
        ix.add(range(2000), rows)
        ix.train()
        ix.remove(range(0, 2000, 2000 // removed)[:removed])
        assert ix.stats()["tombstones"] == removed
    port = ann_from_jax(jax_arrays(ix), "cpu")
    np.testing.assert_array_equal(port._list_counts, np.asarray(ix._list_counts))
    _fill_holds(port)


def test_adc_shortlist_cpu_ignores_the_fill():
    """The CPU path is the plain twin whatever fill it is handed."""
    index, rows = _trained()
    q = torch.from_numpy(pknn._normalize(rows[:8] + 0.01))
    args = (index._centroids, index._codebooks, index._codes, index._lvalid, index._rowpos, q,
            4, 64)
    want = pann._adc_shortlist(*args)
    for fill in (index._fill, torch.zeros_like(index._fill)):
        got = pann._adc_shortlist(*args, fill, 0)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


# ---------------------------------------------- the ADC kernel's plan and tile walk
_PROBE_CHUNK = 256  # probes a chunk of the kernel's tile walk (PCH in csrc/ann_adc.cu)


def _tiles(fills, blocks, b):
    """The (probe, first slot) tiles block ``b`` of ``blocks`` scores for one
    query whose probes hold ``fills`` slots (each in [0, L]), in the order
    of ``csrc/ann_adc.cu`` step 1: probes in chunks of ``_PROBE_CHUNK``,
    ``ceil(fill / 32)`` tiles a probe numbered across the query, every
    ``blocks``-th tile from ``b``.  A tile's lanes take its 32 slots and
    skip those at or past the fill."""
    out, g0 = [], 0
    for pc0 in range(0, len(fills), _PROBE_CHUNK):
        chunk = fills[pc0:pc0 + _PROBE_CHUNK]
        pre = [0]
        for f in chunk:
            pre.append(pre[-1] + -(-f // kernels.ANN_ADC_TILE))
        t = (b - g0) % blocks
        while t < pre[-1]:
            p = max(i for i in range(len(chunk)) if pre[i] <= t)
            out.append((pc0 + p, (t - pre[p]) * kernels.ANN_ADC_TILE))
            t += blocks
        g0 += pre[-1]
    return out


def _walk(fills, blocks):
    """Every slot the kernel scores for one query: (probe, slot) -> times."""
    seen = {}
    for b in range(blocks):
        for p, s0 in _tiles(fills, blocks, b):
            assert s0 < fills[p]  # a tile starts inside the fill
            for s in range(s0, min(s0 + kernels.ANN_ADC_TILE, fills[p])):
                seen[(p, s)] = seen.get((p, s), 0) + 1
    return seen


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("P,L,blocks", [(1, 64, 1), (6, 100, 3), (64, 1024, 32),
                                        (300, 96, 7), (513, 40, 40), (64, 33, 200),
                                        (256, 64, 32), (257, 32, 5), (1024, 64, 64)])
def test_ann_adc_tiles_cover_every_live_slot_once(P, L, blocks, seed):
    """Over random fills (with lists empty and full), the blocks' tiles
    score every slot below a probe's fill exactly once and none at or past
    it, across probe chunks (256 probes, one past, four); the blocks'
    shares differ by one tile a chunk at most."""
    rng = np.random.default_rng(P * 7 + L + blocks + 1000 * seed)
    fills = rng.integers(0, L + 1, size=P)
    fills[rng.random(P) < 0.2] = 0
    fills[rng.random(P) < 0.2] = L
    fills = fills.tolist()
    seen = _walk(fills, blocks)
    want = {(p, s) for p, f in enumerate(fills) for s in range(f)}
    assert set(seen) == want and set(seen.values()) <= {1}
    shares = [len(_tiles(fills, blocks, b)) for b in range(blocks)]
    chunks = -(-P // _PROBE_CHUNK)
    assert max(shares) - min(shares) <= chunks


@pytest.mark.parametrize("Q", [1, 8, 32, 64, 128])
@pytest.mark.parametrize("P,L,m,S,mean_fill", [
    (64, 30592, 96, 256, 489),  # phase 9's corpus, the default nprobe
    (1024, 30592, 96, 256, 489),  # the recall sweep's widest nprobe
    (256, 30592, 96, 2048, 489),
    (6, 64, 200, 384, 64),  # past the LUT chunk
    (8, 4096, 512, 2048, 4096),  # a 4,096-wide corpus at m 512
    (16, 256, 6, 1, 0),  # empty lists
    (4096, 128, 16, 2048, 100),
])
def test_ann_adc_plan_fits_the_card(Q, P, L, m, S, mean_fill):
    """The plan's launch fits ``csrc/ann_adc.cu``'s limits: shared memory
    within ``ANN_ADC_SMEM`` for the scan (LUT chunk + a 2 S + 512 key
    buffer) and the merge (the blocks' S-key lists, the tail's, and the
    first pairwise merge's outputs), a LUT chunk of m or a multiple of 16
    up to 192, at least one block a query and one per 32
    estimated tiles, and a scratch of Q blocks S keys (no [Q, P L] score
    scratch)."""
    plan = kernels.ann_adc_plan(Q, P, L, m, S, mean_fill, 132)
    sel = (1 << (S - 1).bit_length()) * 8
    assert plan.smem <= kernels.ANN_ADC_SMEM
    assert plan.cap >= 2 * S + kernels.ANN_ADC_THREADS
    assert plan.chunk == m or (plan.chunk % 16 == 0 and 16 <= plan.chunk < m
                               and plan.chunk <= kernels.ANN_ADC_LUT_CHUNK)
    assert plan.chunk * 1024 + plan.cap * 8 + sel <= plan.smem
    merge_lists = plan.blocks + 1 + (plan.blocks + 2) // 2  # the blocks', the tail, the pairs'
    assert merge_lists * S * 8 + sel <= plan.smem
    tiles = P * -(-min(mean_fill, L) // kernels.ANN_ADC_TILE)
    assert plan.blocks >= 1 and (plan.blocks == 1 or plan.blocks <= tiles // 32)
    assert plan.cand_keys == Q * plan.blocks * S and plan.counters == Q


def test_ann_adc_plan_at_the_main_path():
    """At phase 9's search (Q 8, nprobe 64, S 256, m 96, mean fill 489) the
    grid puts two blocks an SM over the card's 132 SMs, the whole LUT
    staged once a block; the nprobe-1024 sweep's scratch is a few MB."""
    plan = kernels.ann_adc_plan(8, 64, 30592, 96, 256, 489, 132)
    assert plan.chunk == 96 and plan.blocks == 32
    per_block = plan.smem + kernels.ANN_ADC_STATIC + 1024
    assert 2 * per_block <= kernels.ANN_ADC_SM_SMEM
    sweep = kernels.ann_adc_plan(128, 1024, 30592, 96, 256, 489, 132)
    assert sweep.cand_keys * 8 + sweep.counters * 4 < 8 * 2 ** 20
    # one wave of blocks: Q blocks <= 2 an SM
    for Q in (1, 8, 32, 64, 128):
        assert Q * kernels.ann_adc_plan(Q, 64, 30592, 96, 256, 489, 132).blocks <= 2 * 132
