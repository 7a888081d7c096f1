"""The tensor-core paged tree kernel's launch plan (``kernels.paged_tree_plan``)
on the CPU, at Llama-3-8B's verify shapes and at its edges:

- the query rows of a (slot, KV head) go in as few row chunks as
  ``PAGED_TREE_MAX_WARPS`` / 4 warpgroups of 64 rows allow, as even as they
  can be, covering every row once (a 17-node tree at G 4 in one chunk of two
  warpgroups, 65- and 129-node trees in several);
- the persistent grid is ``PAGED_TREE_BLOCKS_PER_SM`` blocks an SM, fewer
  only where the shapes' most items give a block fewer than ``min_items``;
  the scratch is two partials of a row chunk a block, the counters one a
  row chunk;
- the plan is a function of shapes and the SM count alone: the wrapper
  (``kernels.paged_tree``) hands the kernel the same grid, warps and scratch
  for any lengths (its launch recorded on the CPU, the library stubbed).
"""

import inspect

import pytest
import torch

from django_assistant_bot_tpu_torch import kernels

SMS = 132  # an H100 SXM
# Llama-3-8B's attention (H 32, KH 8, D 128), 8 slots, page 512, 4,096 tokens
LLAMA = dict(B=8, H=32, KH=8, D=128, page=512, NB=8)


def _plan(T, sms=SMS, **kw):
    shapes = dict(LLAMA, **kw)
    return kernels.paged_tree_plan(shapes["B"], shapes["H"], shapes["KH"], T, shapes["D"],
                                   shapes["page"], shapes["NB"], sms)


@pytest.mark.parametrize("T,G,chunks,warps", [(17, 4, 1, 8), (5, 8, 1, 4), (1, 1, 1, 4),
                                               (32, 4, 1, 8), (33, 4, 2, 8), (65, 4, 3, 8),
                                               (65, 8, 5, 8), (129, 8, 9, 8), (129, 4, 5, 8),
                                               (8, 8, 1, 4)])
def test_row_chunks_cover_every_query_row_once(T, G, chunks, warps):
    plan = _plan(T, H=8 * G)
    R = G * T
    assert (plan.row_chunks, plan.warps) == (chunks, warps)
    assert plan.warps in (4, kernels.PAGED_TREE_MAX_WARPS)
    rows = 16 * plan.warps
    assert plan.row_chunks * rows >= R > (plan.row_chunks - 1) * rows
    # as even as they can be: a warpgroup fewer a chunk would not cover the rows
    assert plan.warps == 4 or plan.row_chunks * (rows - 64) < R


@pytest.mark.parametrize("T", [17, 65, 129])
@pytest.mark.parametrize("sms", [132, 114, 8])
def test_grid_and_scratch_from_shapes_and_sms(T, sms):
    plan = _plan(T, sms=sms)
    assert plan.blocks == min(kernels.PAGED_TREE_BLOCKS_PER_SM * sms,
                              -(-plan.items // plan.min_items))
    chunks = LLAMA["NB"] * -(-LLAMA["page"] // 64) + -(-T // 32)
    assert plan.items == LLAMA["B"] * LLAMA["KH"] * plan.row_chunks * chunks
    assert plan.scratch_floats == 2 * plan.blocks * 16 * plan.warps * (LLAMA["D"] + 2)
    assert plan.counters == LLAMA["B"] * LLAMA["KH"] * plan.row_chunks
    assert plan.min_items == kernels.PAGED_TREE_MIN_ITEMS


def test_short_shapes_take_fewer_blocks():
    # one slot, one KV head, a one-page context: 8 chunks and a tree tile
    plan = _plan(17, B=1, KH=1, H=4, page=512, NB=1)
    assert plan.row_chunks == 1
    assert plan.items == 9 and plan.blocks == -(-9 // kernels.PAGED_TREE_MIN_ITEMS)
    assert _plan(17).blocks == kernels.PAGED_TREE_BLOCKS_PER_SM * SMS


def test_plan_takes_no_lengths():
    params = list(inspect.signature(kernels.paged_tree_plan).parameters)
    assert params == ["B", "H", "KH", "T", "D", "page", "NB", "sms", "min_items"]


def _recorded_launch(monkeypatch, lengths, T=17):
    """The arguments ``kernels.paged_tree`` hands the library for bf16
    Llama-3-8B shapes at ``lengths`` (recorded, not launched)."""
    seen = {}

    def fn(*args):
        seen["args"] = args
        return 0

    def scratch(kernel, device, stream, need, n_rows):
        seen["scratch"] = (need, n_rows)
        return torch.zeros(need), torch.zeros(n_rows, dtype=torch.int32)

    monkeypatch.setattr(kernels, "_fn", lambda name: fn)
    monkeypatch.setattr(kernels, "_stream", lambda t: 0)
    monkeypatch.setattr(kernels, "_sm_count", lambda index: SMS)
    monkeypatch.setattr(kernels, "_scratch_buffers", scratch)
    monkeypatch.setattr(kernels, "_count", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "device", lambda d: __import__("contextlib").nullcontext())
    B, H, KH, D, page, NB = 8, 32, 8, 128, 512, 8
    bf = torch.bfloat16
    q = torch.zeros((B, H, T, D), dtype=bf)
    pool = torch.zeros((B * NB, KH, page, D), dtype=bf)
    tree = torch.zeros((B, KH, T, D), dtype=bf)
    bt = torch.arange(B * NB, dtype=torch.int32).reshape(B, NB)
    kernels.paged_tree(q, pool, pool, torch.empty_like(q), bt,
                       torch.tensor(lengths, dtype=torch.int32), tree, tree,
                       torch.ones((T, T), dtype=torch.bool), torch.zeros(T, dtype=torch.int32),
                       window=None)
    args = seen["args"]
    # mma, blocks, warps, min_items, scratch floats
    return args[13], args[-4:-1], args[11], seen["scratch"]


def test_launch_does_not_depend_on_lengths(monkeypatch):
    a = _recorded_launch(monkeypatch, [6, 512, 513, 1042, 1837, 4096, 1501, 701])
    b = _recorded_launch(monkeypatch, [0, 0, 0, 0, 0, 0, 0, 0])
    c = _recorded_launch(monkeypatch, [4096, 1, 1, 1, 0, 0, 0, 0])
    assert a == b == c
    mma, (blocks, warps, min_items), floats, (need, counters) = a
    plan = _plan(17)
    assert mma == 1 and (blocks, warps, min_items) == (plan.blocks, plan.warps, plan.min_items)
    assert floats == need == plan.scratch_floats and counters == plan.counters
