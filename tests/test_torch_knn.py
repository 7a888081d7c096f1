"""The port's exact KNN against the JAX package's (CPU):

- ``topk_scores_plain`` against ``_topk_scores_impl`` on both sides of the
  hierarchical top-k's 16,384 rows, with an allow-list mask and with fewer
  valid rows than the k bucket: the same finite slots, scores within the
  f32-accumulation bound ``topk_score_bound`` (D 2^-22 |q| max|x|: the two
  frameworks sum the same exact bf16 products in other orders), ids equal
  at every rank further than twice the bound from its neighbours (the data
  has no ties but the masked rows);
- the ``VectorIndex`` scenarios of ``tests/test_storage.py`` run on both
  packages, ids and scores agreeing;
- ``AsyncSearcher`` coalescing, and what the port refuses.
"""

import asyncio

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from django_assistant_bot_tpu.ops.sampling import _HIER_TOPK_MIN_VOCAB
from django_assistant_bot_tpu.storage import knn as jknn
from django_assistant_bot_tpu_torch import kernels
from django_assistant_bot_tpu_torch.storage import AsyncSearcher, VectorIndex, topk_scores
from django_assistant_bot_tpu_torch.storage.knn import topk_scores_plain
from django_assistant_bot_tpu_torch.storage.knn_check import topk_agreement, topk_score_bound

# staged rows: both packages round to bf16, normalise in f32 and round again;
# the two f32 norms may differ in their last bit, which moves a rare element
# by one bf16 step (2^-8 relative) and so a score by at most 2^-8 |q_d x_d|.
# The scenarios' scores are held to 1e-3 on unit queries, ids exactly.
INDEX_SCORE_TOL = 1e-3


def _rows(N, D, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, D)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    xb = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))  # the staged rows
    q = rng.normal(size=(8, D)).astype(np.float32)
    return xb, q, rng


@pytest.mark.parametrize("mask", ["all", "allow", "sparse"])
@pytest.mark.parametrize("N,D,k", [(4096, 64, 16), (4096, 32, 1024), (17384, 32, 64),
                                   (17384, 16, 1024)])
def test_topk_scores_plain_matches_jax(N, D, k, mask):
    xb, q, rng = _rows(N, D, seed=N + D + k)
    if mask == "all":
        valid = np.ones(N, bool)
    elif mask == "allow":
        valid = rng.random(N) < 0.01
    else:  # fewer valid rows than the k bucket
        valid = np.zeros(N, bool)
        valid[rng.choice(N, size=max(1, k // 3), replace=False)] = True
    js, ji = jknn._topk_scores_impl(jnp.asarray(xb, jnp.bfloat16), jnp.asarray(q),
                                    jnp.asarray(valid), k)
    js, ji = np.asarray(js), np.asarray(ji)
    index = torch.from_numpy(xb).to(torch.bfloat16)
    ts, ti = topk_scores_plain(index, torch.from_numpy(q), torch.from_numpy(valid), k)
    ts, ti = ts.numpy(), ti.numpy()
    assert ti.dtype == np.int32 and ts.shape == (8, k)
    # live slots hold a valid row's score; past them come -inf (masked rows)
    # and, off a multiple of 128 rows, the hierarchical top-k's pad lanes at
    # the finite -1e30 (both packages)
    live = js > -1e29
    np.testing.assert_array_equal(ts > -1e29, live)
    np.testing.assert_array_equal(np.isfinite(ts), np.isfinite(js))
    assert live.sum(axis=1).tolist() == [min(k, int(valid.sum()))] * 8
    bound = topk_score_bound(torch.from_numpy(q), index).numpy()[:, None]
    assert (np.abs(np.where(live, ts - js, 0)) <= bound).all()
    jl = np.where(live, js, -np.inf)
    padded = np.concatenate([np.full((8, 1), np.inf), jl, np.full((8, 1), -np.inf)], axis=1)
    with np.errstate(invalid="ignore"):
        gap = np.minimum(padded[:, :-2] - padded[:, 1:-1], padded[:, 1:-1] - padded[:, 2:])
    sep = live & (gap > 2 * bound)
    # the rank after k is not in the result: the last live id may swap with it
    sep[:, -1] &= int(valid.sum()) <= k
    assert sep.sum() >= 0.75 * (live.sum() - 8)
    np.testing.assert_array_equal(ti[sep], ji[sep])


def test_topk_scores_dispatch_on_the_cpu():
    """CPU tensors take the plain twin and launch nothing; the agreement
    check holds the twin to itself and catches a wrong id."""
    xb, q, _ = _rows(4096, 64, seed=1)
    index, qt = torch.from_numpy(xb).to(torch.bfloat16), torch.from_numpy(q)
    valid = torch.ones(4096, dtype=torch.bool)
    n0 = kernels.LAUNCHES["knn_topk"]
    s, i = topk_scores(index, qt, valid, 16)
    assert kernels.LAUNCHES["knn_topk"] == n0
    ps, pi = topk_scores_plain(index, qt, valid, 16)
    assert torch.equal(s, ps) and torch.equal(i, pi)
    assert topk_agreement(index, qt, valid, s, i)["problems"] == []
    i[0, 0] = i[0, 5]
    assert topk_agreement(index, qt, valid, s, i)["problems"]


def _both(dim):
    return jknn.VectorIndex(dim), VectorIndex(dim, device="cpu")


def _same_hits(a, b):
    """Two search results (lists of (id, score)) agree: ids equal, scores
    within INDEX_SCORE_TOL."""
    assert [i for i, _ in a] == [i for i, _ in b]
    assert all(abs(x - y) <= INDEX_SCORE_TOL for (_, x), (_, y) in zip(a, b))


def test_vector_index_exact_top1_and_allowlist_match_jax():
    rng = np.random.default_rng(0)
    vecs = rng.normal(size=(500, 64)).astype(np.float32)
    jx, tx = _both(64)
    for index in (jx, tx):
        index.add(list(range(1, 501)), vecs)
    for qv in (vecs[123], vecs[7], rng.normal(size=64).astype(np.float32)):
        _same_hits(jx.search(qv, k=5), tx.search(qv, k=5))
    hits = tx.search(vecs[123], k=5)
    assert hits[0][0] == 124 and hits[0][1] == pytest.approx(1.0, abs=2e-2)
    allowed = {7, 99, 123, 250, 9999}
    _same_hits(jx.search(vecs[42], k=10, allowed_ids=allowed),
               tx.search(vecs[42], k=10, allowed_ids=allowed))
    assert {i for i, _ in tx.search(vecs[42], k=10, allowed_ids=allowed)} == {7, 99, 123, 250}
    assert tx.search(vecs[42], k=5, allowed_ids={55555}) == []
    batch = rng.normal(size=(11, 64)).astype(np.float32)
    for a, b in zip(jx.search_batch(batch, k=7), tx.search_batch(batch, k=7)):
        _same_hits(a, b)


def test_vector_index_mutation_growth_and_appends_match_jax():
    """Removes, growth past the pad boundary, in-place appends (no full
    re-stage on either side), an overwrite (one re-stage) and a remove +
    add netting the same count."""
    rng = np.random.default_rng(3)
    a = rng.normal(size=(200, 16)).astype(np.float32)
    b = rng.normal(size=(300, 16)).astype(np.float32)
    c = rng.normal(size=(60, 16)).astype(np.float32)
    probes = [a[10], b[50], c[5], rng.normal(size=16).astype(np.float32)]
    results, stages = [], []
    for index in _both(16):
        got, staged = [], []
        orig = index._stage_full
        index.add(list(range(200)), a)
        got.append(index.search(a[0], k=3))
        index._stage_full = lambda n, orig=orig, staged=staged: (staged.append(n), orig(n))[1]
        index.remove([0, 1, 2])
        got.append(index.search(a[0], k=3))
        index.add(list(range(1000, 1300)), b)
        got += [index.search(p, k=4) for p in probes]
        index.add(list(range(2000, 2060)), c)
        got += [index.search(p, k=4) for p in probes]
        index.add([10], a[11:12])  # an overwrite
        got += [index.search(p, k=4) for p in probes]
        index.remove([1000])
        index.add([99], a[:1])
        got += [index.search(a[0], k=2)]
        results.append(got)
        stages.append(staged)
    for x, y in zip(*results):
        _same_hits(x, y)
    assert stages[0] == stages[1]
    assert results[1][1][0][0] not in (0, 1, 2)


def test_vector_index_device_appends_match_jax():
    """``add_device`` onto a staged index appends in place with the host
    copy deferred; a remove materialises it; an append bucket that spans two
    capacity growths keeps the old rows; a cold index takes device rows."""
    rng = np.random.default_rng(11)
    a = rng.normal(size=(50, 16)).astype(np.float32)
    b = rng.normal(size=(70, 16)).astype(np.float32)
    results = []
    for index, dev in zip(_both(16), (jnp.asarray, torch.from_numpy)):
        got = []
        index.add(list(range(50)), a)
        got.append(index.search(a[0], k=1))
        index.add_device(list(range(100, 170)), dev(b))
        assert len(index) == 120 and index._pending_host
        got += [index.search(a[0], k=2), index.search(b[3], k=2), index.search(b[69], k=2)]
        index.remove([0])
        assert not index._pending_host
        got += [index.search(b[3], k=2), index.search(a[1], k=2)]
        results.append(got)
        cold = type(index)(16) if dev is jnp.asarray else VectorIndex(16, device="cpu")
        cold.add_device([1, 2], dev(a[:2]))
        assert cold.search(a[1], k=1)[0][0] == 2
    for x, y in zip(*results):
        _same_hits(x, y)


def test_vector_index_warmup_and_hierarchical_scale_match_jax():
    n, dim = _HIER_TOPK_MIN_VOCAB + 1000, 32
    rng = np.random.default_rng(7)
    vecs = rng.normal(size=(n, dim)).astype(np.float32)
    q = rng.normal(size=(3, dim)).astype(np.float32)
    jx, tx = _both(dim)
    for index in (jx, tx):
        index.add(range(n), vecs)
        assert index.warmup() is index
        assert index._device_count == n
    for a, b in zip(jx.search_batch(q, k=10), tx.search_batch(q, k=10)):
        _same_hits(a, b)
    assert VectorIndex(8, device="cpu").warmup()._device_index is None


def test_async_searcher_coalesces():
    """Concurrent searches share one batched search with per-caller k; an
    allow-listed search bypasses the coalescer; the results are those of
    the JAX searcher."""
    rng = np.random.default_rng(12)
    vecs = rng.normal(size=(100, 16)).astype(np.float32)
    jx, tx = _both(16)
    rows = []
    calls = []
    for index, cls in ((jx, jknn.AsyncSearcher), (tx, AsyncSearcher)):
        index.add(list(range(100)), vecs)
        orig = index.search_batch

        def spy(queries, k=10, allowed_ids=None, orig=orig):
            calls.append(len(queries))
            return orig(queries, k, allowed_ids=allowed_ids)

        index.search_batch = spy
        searcher = cls(index, window_s=0.01)

        async def drive(searcher=searcher):
            return await asyncio.gather(*(searcher.search(vecs[i], k=1 + i % 3) for i in range(6)))

        got = asyncio.run(drive())
        assert [r[0][0] for r in got] == list(range(6))
        assert [len(r) for r in got] == [1 + i % 3 for i in range(6)]
        hits = asyncio.run(searcher.search(vecs[0], k=2, allowed_ids={5, 7}))
        assert {i for i, _ in hits} == {5, 7}
        rows.append(got)
    # one coalesced call of six each, then the allow-listed search on its own
    assert calls == [6, 1, 6, 1]
    for a, b in zip(*rows):
        _same_hits(a, b)


def test_vector_index_refusals():
    with pytest.raises(NotImplementedError, match="item 15"):
        VectorIndex(8, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="item 16"):
        VectorIndex.from_model(object)
    index = VectorIndex(8, device="cpu")
    with pytest.raises(ValueError, match="ids for"):
        index.add_device([1, 2], torch.zeros((3, 8)))
    index.add([1], np.ones((1, 8), np.float32))
    index.clear()
    assert len(index) == 0 and index.search(np.ones(8, np.float32)) == []
