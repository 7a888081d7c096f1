"""qgemm's stream route (``csrc/qgemm.cu`` ``qgemm_stream_kernel``) on the
CPU: its work plan and its grouped entry point, tiny geometry.

- ``kernels.qgemm_stream_plan`` covers every (member, column tile, row of
  K) exactly once, each range starting on a granule (and so a group)
  boundary; every block streams the same bytes to within one granule; a
  tile cut between blocks has one partial slot per block, numbered as the
  kernel numbers them; the f32 partials stay within
  ``QGEMM_STREAM_PARTIAL_FLOATS``; summing the units' partials in the plan's order
  gives the product.
- ``ops.quant.qeinsum_group`` on the CPU gives, per member, exactly the
  separate ``qeinsum_plain`` call, and within 1e-5 of the JAX ``qeinsum`` in
  f32 at int8 and int4 (groups 64 and 128).
- A tied int8 decoder's greedy ids equal the JAX engine's.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from django_assistant_bot_tpu.models import DecoderConfig as JaxDecoderConfig
from django_assistant_bot_tpu.models import llama as jllama
from django_assistant_bot_tpu.ops import quant as jq
from django_assistant_bot_tpu.serving import ByteTokenizer as JaxByteTokenizer
from django_assistant_bot_tpu.serving import GenerationEngine as JaxGenerationEngine
from django_assistant_bot_tpu_torch import kernels
from django_assistant_bot_tpu_torch.convert import params_from_jax
from django_assistant_bot_tpu_torch.models import DecoderConfig
from django_assistant_bot_tpu_torch.ops import quant as tq
from django_assistant_bot_tpu_torch.serving import ByteTokenizer, GenerationEngine

# (K, member widths): Llama-3-8B's grouped QKV, gate/up, wo and down, its
# 128,256-row head, the tiny test model's QKV and gate/up, a ragged width
GROUPS = [
    (4096, (4096, 1024, 1024)), (4096, (14336, 14336)), (4096, (4096,)), (14336, (4096,)),
    (4096, (128256,)), (256, (256, 128, 128)), (256, (512, 512)), (4032, (1040, 48)),
]
FORMATS = [(8, 0), (4, 64), (4, 128), (4, 48)]


def _plans():
    for K, Ns in GROUPS:
        for bits, g in FORMATS:
            if g and K % g:
                continue
            for M in (1, 8, 16, 37, 64):
                for sms in (132, 7):
                    yield M, Ns, K, bits, g, sms


PLANS = list(_plans())


@pytest.mark.parametrize("M,Ns,K,bits,g,sms", PLANS)
def test_stream_plan_covers_every_row_once_on_group_boundaries(M, Ns, K, bits, g, sms):
    plan = kernels.qgemm_stream_plan(M, Ns, K, bits, g, sms)
    assert 8 * plan.mt >= M and plan.mt in (1, 2, 4, 8)
    assert plan.granule % kernels.QGEMM_STREAM_KT == 0 and plan.granule % (g or 16) == 0
    assert plan.tiles == tuple(-(-n // kernels.QGEMM_STREAM_BN) for n in Ns)
    per = -(-plan.total // sms)  # the fewest blocks that keep a block's share at ceil(T / sms)
    assert plan.ctas == -(-plan.total // per) <= sms and len(plan.units) == plan.ctas
    covered = {}
    for units in plan.units:
        assert units  # no block is idle
        for u in units:
            assert 0 <= u.k0 < u.k1 <= K and u.k0 % plan.granule == 0
            assert u.k1 % plan.granule == 0 or u.k1 == K
            covered.setdefault((u.member, u.tile), []).append((u.k0, u.k1))
    assert set(covered) == {(m, t) for m, n in enumerate(plan.tiles) for t in range(n)}
    for ranges in covered.values():  # each tile's K, every row exactly once
        ranges.sort()
        assert ranges[0][0] == 0 and ranges[-1][1] == K
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


@pytest.mark.parametrize("M,Ns,K,bits,g,sms", PLANS)
def test_stream_plan_balances_bytes_and_bounds_partials(M, Ns, K, bits, g, sms):
    plan = kernels.qgemm_stream_plan(M, Ns, K, bits, g, sms)
    granules = [sum(-(-(u.k1 - u.k0) // plan.granule) for u in units) for units in plan.units]
    mean = plan.total / plan.ctas
    assert sum(granules) == plan.total
    # each block's bytes within one granule of the mean
    assert all(abs(n - mean) < 1 for n in granules)
    assert plan.partial_floats == 2 * plan.ctas * 8 * plan.mt * kernels.QGEMM_STREAM_BN
    assert plan.partial_floats <= kernels.QGEMM_STREAM_PARTIAL_FLOATS
    # a block has at most two units that share their tile: its first and last
    for units in plan.units:
        split = [u for u in units if u.slot >= 0]
        assert len(split) <= 2 and all(u in (units[0], units[-1]) for u in split)


@pytest.mark.parametrize("M,Ns,K,bits,g,sms", PLANS)
def test_stream_plan_slots_follow_the_kernels_numbering(M, Ns, K, bits, g, sms):
    """A tile cut between blocks cf..cl: one partial slot per block, block
    c's slot ``2c + (c's range starts before the tile)``, which is how the
    last block finds them (``qgemm_stream_kernel``'s epilogue)."""
    plan = kernels.qgemm_stream_plan(M, Ns, K, bits, g, sms)
    first = [c * plan.total // plan.ctas for c in range(plan.ctas)]
    by_tile = {}
    for c, units in enumerate(plan.units):
        for u in units:
            by_tile.setdefault((u.member, u.tile), []).append((c, u))
    base = np.cumsum((0,) + plan.tiles)
    slots = set()
    for (member, tile), owners in by_tile.items():
        tile_s = (base[member] + tile) * plan.gcount
        cs = [c for c, _ in owners]
        assert cs == list(range(cs[0], cs[-1] + 1))  # consecutive blocks, in K order
        assert [u.k0 for _, u in owners] == sorted(u.k0 for _, u in owners)
        for c, u in owners:
            assert u.splits == len(owners)
            if len(owners) == 1:
                assert u.slot == -1
            else:
                assert u.slot == 2 * c + (first[c] < tile_s)
                assert u.slot not in slots
                slots.add(u.slot)
    assert all(0 <= s < 2 * plan.ctas for s in slots)


@pytest.mark.parametrize("bits,g", [(8, 0), (4, 64), (4, 128)])
def test_stream_plan_partials_in_order_give_the_product(bits, g):
    """The kernel's arithmetic over the plan, in f32 on the CPU: each unit's
    partial over its rows of K (int4: its groups, each rounded through
    ``qeinsum_plain``'s formula in f32, i.e. exactly), the split tiles'
    partials summed in block order: the product of ``qeinsum_plain``."""
    rng = np.random.default_rng(3)
    K, Ns, M = 512, (256, 128, 384), 5
    ws = [tq.quantize_tensor(rng.normal(size=(K, n)).astype(np.float32)) if bits == 8 else
          tq.quantize_tensor_int4(rng.normal(size=(K, n)).astype(np.float32), g) for n in Ns]
    x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32))
    plan = kernels.qgemm_stream_plan(M, Ns, K, bits, g, sms=3)
    assert any(u.slot >= 0 for units in plan.units for u in units)
    deq = [tq.deq(w, torch.float32) for w in ws]
    parts = {}
    for c, units in enumerate(plan.units):
        for u in units:
            bn = kernels.QGEMM_STREAM_BN
            cols = slice(u.tile * bn, (u.tile + 1) * bn)
            p = x[:, u.k0:u.k1] @ deq[u.member][u.k0:u.k1, cols]
            parts.setdefault((u.member, u.tile), []).append(p)
    for m, w in enumerate(ws):
        want = tq.qeinsum_plain("me,eo->mo", x, w, torch.float32)
        got = torch.cat([sum(parts[(m, t)][1:], parts[(m, t)][0])
                         for t in range(plan.tiles[m])], dim=1)
        bound = 1e-5 * (x.abs() @ deq[m].abs()) + 1e-6  # f32 summation order
        assert got.shape == want.shape and bool(((got - want).abs() <= bound).all())


@pytest.mark.parametrize("fmt,g", [("int8", 0), ("int4", 64), ("int4", 128)])
@pytest.mark.parametrize("pattern,Ns", [("bse,eo->bso", (64, 32, 32)),
                                        ("bse,ef->bsf", (96, 96))])
def test_qeinsum_group_equals_separate_calls_and_jax(pattern, Ns, fmt, g):
    """The JAX tests' tiny geometry (K = 128, as the ``qeinsum_plain``
    parity test), members of QKV and gate/up widths, weights at the model
    init's scale (std K^-0.5, so outputs are O(1) and 1e-5 is a few f32
    ulps of them)."""
    rng = np.random.default_rng(11)
    K = 128
    pairs = []
    for n in Ns:
        w = (rng.normal(size=(K, n)) * K ** -0.5).astype(np.float32)
        if fmt == "int8":
            pairs.append((jq.quantize_tensor(jnp.asarray(w)), tq.quantize_tensor(w)))
        else:
            pairs.append((jq.quantize_tensor_int4(jnp.asarray(w), g), tq.quantize_tensor_int4(w, g)))
    x = rng.normal(size=(2, 3, K)).astype(np.float32)
    got = tq.qeinsum_group(pattern, torch.from_numpy(x), [t for _, t in pairs], torch.float32)
    assert len(got) == len(Ns)
    for y, (ja, tb) in zip(got, pairs):
        alone = tq.qeinsum_plain(pattern, torch.from_numpy(x), tb, torch.float32)
        assert torch.equal(y, alone)
        want = np.asarray(jq.qeinsum(pattern, jnp.asarray(x), ja, jnp.float32))
        assert np.abs(y.numpy() - want).max() <= 1e-5


def test_qeinsum_group_of_dense_weights_is_matmul():
    rng = np.random.default_rng(12)
    ws = [torch.from_numpy(rng.normal(size=(64, n)).astype(np.float32)) for n in (32, 48)]
    x = torch.from_numpy(rng.normal(size=(2, 4, 64)).astype(np.float32))
    for y, w in zip(tq.qeinsum_group("bse,eo->bso", x, ws, torch.float32), ws):
        assert torch.equal(y, torch.matmul(x, w))


def test_tied_int8_engine_greedy_ids_identical_to_jax_engine():
    """A tied int8 embedding table as the head (per-E scales on x), int8
    projections: the port's engine against the JAX engine, greedy."""
    jcfg = dataclasses.replace(JaxDecoderConfig.tiny(), tie_embeddings=True)
    cfg = dataclasses.replace(DecoderConfig.tiny(), tie_embeddings=True)
    jparams = jllama.init_int8(jcfg, jax.random.key(4), quantize_embed=True, host_rng=True)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    assert isinstance(params["tok_embed"], tq.QTensor) and "lm_head" not in params
    assert tq.check_kernel_params(params, cfg.dtype) is None
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, 255, n).tolist() for n in (12, 70, 33)]
    kw = dict(max_slots=4, max_seq_len=256, chunk_size=64, decode_steps=4, prefill_piggyback=True)
    jeng = JaxGenerationEngine(jcfg, jparams, JaxByteTokenizer(), kv_layout="paged",
                               scheduler=None, prefix_cache_size=0, **kw)
    teng = GenerationEngine(cfg, params, ByteTokenizer(), device="cpu", **kw)
    out = []
    for eng in (jeng, teng):
        eng._running = True
        futs = [eng.submit(p, max_tokens=10, temperature=0.0) for p in prompts]
        for _ in range(2000):
            if all(f.done() for f in futs):
                break
            eng._loop_iteration()
        eng._running = False
        out.append([f.result(timeout=0).token_ids for f in futs])
    assert out[0] == out[1]


# ------------------------------------------------------------- generic route
# (K, N): Llama-3-8B's projections, K off 64 and off 16 (groups 24 and 40),
# the card tests' small widths
_GENERIC_KN = [(4096, 4096), (4096, 1024), (14336, 4096), (4104, 1024), (4000, 4096),
               (96, 64), (48, 40), (40, 44), (256, 512)]


def _generic_plans():
    for K, N in _GENERIC_KN:
        for bits, g in [(8, 0)] + [(4, g) for g in (2, 4, 6, 8, 24, 40)]:
            if g and K % g:
                continue
            for M in (1, 8, 33, 64, 65, 512):
                for sms in (132, 7):
                    yield M, N, K, bits, g, sms


GENERIC_PLANS = list(_generic_plans())


@pytest.mark.parametrize("M,N,K,bits,g,sms", GENERIC_PLANS)
def test_generic_plan_covers_every_row_once_on_group_boundaries(M, N, K, bits, g, sms):
    """Every (tile, row of K) of the generic kernel's launch is one unit's,
    exactly once, each range starting on a granule and so a group boundary
    (lcm(64, g) rows; K's end may cut the last granule)."""
    plan = kernels.qgemm_generic_plan(M, N, K, bits, g, sms)
    assert 8 * plan.mt >= min(M, kernels.QGEMM_GENERIC_BM) and plan.mt in (1, 2, 4, 8)
    assert plan.granule % kernels.QGEMM_GENERIC_KT == 0 and plan.granule % (g or 1) == 0
    assert (plan.mtiles, plan.ntiles) == (-(-M // (8 * plan.mt)),
                                          -(-N // kernels.QGEMM_GENERIC_BN))
    covered = {}
    for units in plan.units:
        assert units  # no block is idle
        for u in units:
            assert 0 <= u.k0 < u.k1 <= K and u.k0 % plan.granule == 0 and u.k0 % (g or 1) == 0
            assert u.k1 % plan.granule == 0 or u.k1 == K
            covered.setdefault((u.mtile, u.ntile), []).append((u.k0, u.k1))
    assert set(covered) == {(m, n) for m in range(plan.mtiles) for n in range(plan.ntiles)}
    for ranges in covered.values():
        ranges.sort()
        assert ranges[0][0] == 0 and ranges[-1][1] == K
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


@pytest.mark.parametrize("M,N,K,bits,g,sms", GENERIC_PLANS)
def test_generic_plan_stays_within_the_sm_budget_and_balances(M, N, K, bits, g, sms):
    """The blocks the SMs run at once (two an SM up to 16 rows where each
    still takes eight granules, else one), no more, each taking the same
    granules to within one (and at least two while there are enough);
    int4's scale rows a stage cover the groups any 64-row stage touches."""
    plan = kernels.qgemm_generic_plan(M, N, K, bits, g, sms)
    two = plan.mt <= 2 and plan.total >= 2 * kernels.QGEMM_GENERIC_DEEP * sms
    budget = sms * (2 if two else 1)
    per = max(kernels.QGEMM_GENERIC_MIN_GRANULES, -(-plan.total // budget))
    assert plan.ctas == -(-plan.total // per) <= budget and len(plan.units) == plan.ctas
    assert plan.total == plan.mtiles * plan.ntiles * plan.gcount
    granules = [sum(-(-(u.k1 - u.k0) // plan.granule) for u in units) for units in plan.units]
    assert sum(granules) == plan.total
    assert all(abs(n - plan.total / plan.ctas) < 1 for n in granules)
    if bits == 4:
        kt = kernels.QGEMM_GENERIC_KT
        touched = max((k0 + kt - 1) // g - k0 // g + 1
                      for k0 in range(0, plan.granule, kt))
        assert plan.srows == touched
    else:
        assert plan.srows == 0


@pytest.mark.parametrize("M,N,K,bits,g,sms", GENERIC_PLANS)
def test_generic_plan_slots_and_counters_follow_the_kernels_numbering(M, N, K, bits, g, sms):
    """A tile cut between blocks cf..cl: consecutive blocks in K order, one
    partial slot each, block c's ``2c + (c's range starts before the
    tile)`` (how ``qgemm_generic_kernel``'s last block finds them), within
    the scratch the wrapper sizes (two slots of 8 mt x 256 floats a block);
    one counter a tile."""
    plan = kernels.qgemm_generic_plan(M, N, K, bits, g, sms)
    assert plan.partial_floats == 2 * plan.ctas * 8 * plan.mt * kernels.QGEMM_GENERIC_BN
    first = [c * plan.total // plan.ctas for c in range(plan.ctas)]
    by_tile, slots = {}, set()
    for c, units in enumerate(plan.units):
        split = [u for u in units if u.slot >= 0]
        assert len(split) <= 2 and all(u in (units[0], units[-1]) for u in split)
        for u in units:
            by_tile.setdefault((u.mtile, u.ntile), []).append((c, u))
    assert len(by_tile) == plan.mtiles * plan.ntiles  # the counters the wrapper allocates
    for (mtile, ntile), owners in by_tile.items():
        tile_s = (mtile * plan.ntiles + ntile) * plan.gcount
        cs = [c for c, _ in owners]
        assert cs == list(range(cs[0], cs[-1] + 1))
        assert [u.k0 for _, u in owners] == sorted(u.k0 for _, u in owners)
        for c, u in owners:
            assert u.splits == len(owners)
            if len(owners) == 1:
                assert u.slot == -1
            else:
                assert u.slot == 2 * c + (first[c] < tile_s) and u.slot not in slots
                slots.add(u.slot)
    assert all(0 <= s < 2 * plan.ctas for s in slots)


@pytest.mark.parametrize("M,N,K,bits,g,sms", GENERIC_PLANS)
def test_generic_wrapper_grid_is_the_plans(M, N, K, bits, g, sms):
    """The grid ``kernels.qgemm_generic`` sizes its scratch and counters
    from (``_generic_grid``, no work list) is the plan's: its partial floats
    and one counter a tile."""
    plan = kernels.qgemm_generic_plan(M, N, K, bits, g, sms)
    mt, mtiles, ntiles, granule, gcount, total, bps, ctas = kernels._generic_grid(
        M, N, K, bits, g, sms)
    assert (mt, mtiles, ntiles, granule, gcount, total, ctas) == (
        plan.mt, plan.mtiles, plan.ntiles, plan.granule, plan.gcount, plan.total, plan.ctas)
    assert 2 * ctas * 8 * mt * kernels.QGEMM_GENERIC_BN == plan.partial_floats
    assert bps == (2 if mt <= 2 and total >= 2 * kernels.QGEMM_GENERIC_DEEP * sms else 1)


@pytest.mark.parametrize("g", [2, 4, 6, 8, 24, 40])
@pytest.mark.parametrize("M", [3, 70])
def test_generic_plan_in_bf16_numerics_meets_the_kernel_bound(g, M):
    """The kernel's arithmetic over the plan on the CPU: each unit's groups'
    partials rounded to bf16, times the bf16-rounded scale, summed in f32;
    the split tiles' unit sums added in block order, rounded once: within
    ``qgemm_bf16_bound`` of the f32 product, as the JAX function is."""
    rng = np.random.default_rng(g)
    K, N = 960, 300
    w = tq.quantize_tensor_int4(rng.normal(size=(K, N)).astype(np.float32), g)
    assert w.group_size == g
    x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).bfloat16().float()
    plan = kernels.qgemm_generic_plan(M, N, K, 4, g, sms=3)
    assert any(u.slot >= 0 for units in plan.units for u in units)
    vals = tq.unpack_int4(w.q).float()
    scale = w.scale.bfloat16().float()
    bm, bn = 8 * plan.mt, kernels.QGEMM_GENERIC_BN
    out = torch.zeros((plan.mtiles * bm, plan.ntiles * bn))
    for units in plan.units:
        for u in units:
            m0, n0 = u.mtile * bm, u.ntile * bn
            xs, cols = x[m0:min(M, m0 + bm)], slice(n0, min(N, n0 + bn))
            acc = torch.zeros((xs.shape[0], cols.stop - n0))
            for k in range(u.k0, u.k1, g):
                p = xs[:, k:k + g] @ vals[k:k + g, cols]
                acc += p.bfloat16().float() * scale[k // g, cols]
            out[m0:m0 + acc.shape[0], n0:n0 + acc.shape[1]] += acc
    got = out[:M, :N].bfloat16().float()
    ref = tq.qeinsum_plain("me,eo->mo", x, w, torch.float32)
    assert bool(((got - ref).abs() <= tq.qgemm_bf16_bound(x, w, ref)).all())


# ------------------------------------------------------------- route chooser
# Llama-3-8B's projections (in, out), each as a decode (M 8) and a prefill
# (M 512) call, int8 and int4 at the default group and 128
_LLAMA3 = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)]


@pytest.mark.parametrize("K,N", _LLAMA3)
@pytest.mark.parametrize("M", [1, 8, 64, 65, 512, 2048])
@pytest.mark.parametrize("group", [0, 64, 128])
def test_route_chooser_keeps_llama3_shapes_off_generic(K, N, M, group):
    """Every Llama-3-8B projection keeps its tensor-core route (stream up
    to 64 rows, wgmma past them); none takes the generic one."""
    route = kernels.qgemm_route(torch.bfloat16, M, N, K, group)
    assert route == ("stream" if M <= 64 else "wgmma")
    assert kernels.qgemm_route(torch.float32, M, N, K, group) == "cuda_core"
    assert kernels.qgemm_tied_route(torch.bfloat16, 128256, 4096) == "stream"


@pytest.mark.parametrize("M", [8, 512])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("K,N,group,aligned", [
    (4096, 4096, 8, True),   # int4 group 8
    (4096, 4096, 4, True),   # quant_group_size 6 packs at 4 (_int4_group)
    (48, 40, 24, True),      # group 24, out off 16
    (40, 44, 0, True),       # int8, in off 16, out off 8
    (256, 512, 2, True),     # the smallest group
    (4096, 4096, 64, False),  # q or scale off 16 bytes
])
def test_route_chooser_sends_entry7_shapes_to_generic(K, N, group, aligned, dtype, M):
    """The int4 groups, widths and alignments the JAX package serves but the
    tensor-core kernels do not take (ROADMAP Queue 3 entry 7) route to the
    generic kernel, and so does a tied head off E % 16 or V % 8."""
    assert kernels.qgemm_route(dtype, M, N, K, group, qs_aligned=aligned,
                               aligned=aligned) == "generic"
    assert kernels.qgemm_tied_route(dtype, 1000, 40) == "generic"
    assert kernels.qgemm_tied_route(dtype, 1001, 64) == ("generic" if dtype == torch.bfloat16
                                                         else "cuda_core")


def test_quantize_group_6_packs_at_4():
    """``quant_group_size=6`` at in 4096 packs int4 at a group of 4 (the
    largest even divisor <= 6), which the generic route serves."""
    w = tq.quantize_tensor_int4(np.ones((4096, 16), np.float32), 6)
    assert w.group_size == 4 and tq.kernel_refusal(w, torch.bfloat16) is None
