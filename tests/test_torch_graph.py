"""The engine's fused decode tick as a CUDA graph, on the card.

Every test here carries the ``cuda`` marker and skips without a card (the
skip condition is a string, evaluated at setup).  Like
tests/test_torch_kernels.py this file imports neither JAX nor the JAX
package:

    python -m pytest --noconftest -m cuda tests/test_torch_graph.py

- one replay of the captured tick is bitwise equal to the same K steps run
  eagerly on the same inputs (bf16 on the tensor-core paged kernel, f32 on
  the CUDA-core one), and so is one replay of the piggyback graph to the
  chunk and the K steps run eagerly;
- a replay after eager prefill waves and chunks reads the new lengths and
  block tables: the engine's greedy ids on the card equal the CPU engine's;
- the launches recorded at capture are counted at every replay of either
  graph, and the graphs' own paged counters are back at zero after each one;
- prefix sharing: a replay after a suffix wave of hits reads the shared
  pages, bitwise equal to the same steps run eagerly (bf16 and f32), and
  leaves them untouched; a chunk piggybacked from a hit's start leaves the
  shared pages unchanged, with greedy ids equal to the CPU engine's;
- an in-place crash-only restart keeps both graphs (no re-capture): a
  request served after it is bitwise the one a fresh engine serves, pools
  included, and its replays are still counted;
- a captured M = 512 quantized projection (the wgmma kernel, K split at
  wk/wv's width) replays bit for bit as the eager call;
- a tied int8 embedding table as the head: a bf16 replay equals the eager
  steps bitwise, and an f32 engine's greedy ids on the card equal the
  CPU's;
- a Mixtral MoE decoder (4 experts, top 2): the tick, piggyback and JSON
  graphs replay bit for bit as their bodies run eagerly, and count the four
  MoE launches a layer a forward at each replay;
- a speculative engine: each rung's graph replays bit for bit as its body
  run eagerly and counts its paged tree and sampler launches; an f32 spec
  engine's greedy ids on the card equal the CPU spec engine's and the
  card's plain engine's; a bf16 spec engine verifies a 65-node tree on the
  tensor-core kernel, its greedy ids the plain engine's but at near ties;
- narrow pools (``kv_cache_dtype`` fp8 / fp8_e5m2 / bf16, ``attn_fp8``):
  a replay bitwise the eager steps, every recorded paged launch on the
  pool's read; an f32 fp8 in-dot engine's greedy ids equal the CPU's.
"""

import contextlib
import dataclasses

import pytest
import torch

from django_assistant_bot_tpu_torch import kernels
from django_assistant_bot_tpu_torch.models import DecoderConfig, llama
from django_assistant_bot_tpu_torch.ops.attention import paged_gqa_decode_attention
from django_assistant_bot_tpu_torch.ops.quant import (
    QUANTIZABLE,
    QTensor,
    QTensor4,
    qeinsum,
    quantize_decoder_params,
    quantize_tensor,
)
from django_assistant_bot_tpu_torch.ops.sampling import gumbel_noise
from django_assistant_bot_tpu_torch.serving import ByteTokenizer, GenerationEngine

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card"),
]

K = 4


def _cfg(dtype):
    # head_dim 64: bf16 takes the tensor-core paged kernel, f32 the CUDA-core one
    return DecoderConfig(
        vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2,
        num_heads=4, num_kv_heads=2, max_seq_len=1024, rope_theta=10_000.0, dtype=dtype,
    )


def _engine(dtype, device="cuda", fmt=None, **kw):
    cfg = _cfg(dtype)
    params = llama.init(cfg, torch.Generator().manual_seed(3), "cpu")
    if fmt is not None:  # int8 / int4 projections: the qgemm kernel on the card
        params = quantize_decoder_params(params, fmt)
    params = {k: ({n: w.to(device) for n, w in v.items()} if isinstance(v, dict) else v.to(device))
              for k, v in params.items()}
    kw.setdefault("chunk_size", 512)
    kw.setdefault("decode_steps", K)
    return GenerationEngine(cfg, params, ByteTokenizer(), device=device, max_slots=4,
                            max_seq_len=1024, **kw)


def _state(eng):
    c = eng._cache
    # the JSON FSM states last: a JSON tick advances them
    return [c.k, c.v, c.lengths, eng._tokens_dev, eng._toks_dev, eng._fsm_states_dev]


def _replay_vs_eager(eng, graph, bodies):
    """``graph`` replayed and ``bodies`` run eagerly from the same state:
    the two end states, as lists of tensors."""
    before = [t.clone() for t in _state(eng)]
    graph.replay()
    torch.cuda.synchronize()
    replayed = [t.clone() for t in _state(eng)]
    for t, b in zip(_state(eng), before):
        t.copy_(b)
    with torch.no_grad():
        for body in bodies:
            body()
    torch.cuda.synchronize()
    return before, replayed, _state(eng)


def _mid_decode(eng, gen):
    """Random pools, ragged rows (one inactive, one sampled), noise drawn."""
    c = eng._cache
    c.k.copy_(torch.randn(c.k.shape, generator=gen, device="cuda").to(c.k.dtype))
    c.v.copy_(torch.randn(c.v.shape, generator=gen, device="cuda").to(c.v.dtype))
    c.lengths.copy_(torch.tensor([5, 300, 0, 700], dtype=torch.int32))
    n = eng._kv_pool.n_pages
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(2)).to(torch.int32)
    eng._bt_dev.copy_(perm.reshape(eng.max_slots, -1))
    eng._active_dev.copy_(torch.tensor([True, True, False, True]))
    eng._temps_dev.copy_(torch.tensor([0.0, 0.8, 0.0, 1.0]))
    eng._top_ps_dev.copy_(torch.tensor([1.0, 0.9, 1.0, 0.95]))
    eng._tokens_dev.copy_(torch.tensor([7, 300, 0, 42], dtype=torch.int32))
    for i in range(eng.decode_steps):
        gumbel_noise(eng._noise[i], gen)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_replay_bitwise_equal_to_eager_steps(dtype):
    eng = _engine(dtype)
    assert eng.decode_path_stats()["cuda_graph"]
    _mid_decode(eng, torch.Generator(device="cuda").manual_seed(1))
    before, replayed, eager = _replay_vs_eager(eng, eng._graph, [eng._tick_body])
    for name, got, want in zip(("k", "v", "lengths", "tokens", "toks"), replayed, eager):
        assert torch.equal(got, want), name
    assert torch.equal(replayed[2], before[2] + torch.tensor([K, K, 0, K], device="cuda",
                                                             dtype=torch.int32))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_piggyback_replay_bitwise_equal_to_eager_chunk_and_steps(dtype):
    """Inactive slot 2 takes a chunk at position 256 of its own pages while
    the other slots decode K steps: one program, chunk first."""
    eng = _engine(dtype)
    gen = torch.Generator(device="cuda").manual_seed(6)
    _mid_decode(eng, gen)
    eng._chunk_ids_dev.copy_(torch.randint(1, 255, (1, eng.chunk_size), generator=gen,
                                           device="cuda", dtype=torch.int32))
    eng._chunk_bt_dev.copy_(eng._bt_dev[2])
    eng._chunk_slot_dev.fill_(2)
    eng._chunk_start_dev.fill_(256)
    before, replayed, eager = _replay_vs_eager(
        eng, eng._piggyback_graph, [eng._chunk_body, eng._tick_body])
    for name, got, want in zip(("k", "v", "lengths", "tokens", "toks"), replayed, eager):
        assert torch.equal(got, want), name
    assert replayed[2].tolist() == [5 + K, 300 + K, 256 + eng.chunk_size, 700 + K]
    assert not torch.equal(replayed[0], before[0])  # the chunk wrote slot 2's pages


def test_replay_after_prefill_waves_matches_cpu_engine():
    """Waves through the 512 bucket (flash kernel), a short wave and a
    two-chunk prompt (piggybacked) between replays: greedy ids equal the
    CPU engine's, so every replay read the lengths and block tables the
    eager waves wrote."""
    gen = torch.Generator().manual_seed(5)
    prompts = [torch.randint(1, 255, (n,), generator=gen).tolist() for n in (40, 300, 450, 700)]

    def run(device):
        eng = _engine(torch.float32, device=device)
        eng._running = True
        futs = [eng.submit(p, max_tokens=16, temperature=0.0) for p in prompts[:2]]
        eng._loop_iteration()
        if device == "cuda":
            torch.cuda.synchronize()
            # the first wave's slots advanced by one replayed tick
            got = eng._cache.lengths[:2].tolist()
            assert got == [len(prompts[0]) + K, len(prompts[1]) + K], got
        futs += [eng.submit(p, max_tokens=16, temperature=0.0) for p in prompts[2:]]
        for _ in range(500):
            if all(f.done() for f in futs):
                break
            eng._loop_iteration()
        return [f.result(timeout=0).token_ids for f in futs], eng.decode_path_stats()

    card, dec = run("cuda")
    cpu, _ = run("cpu")
    assert card == cpu
    assert dec["cuda_graph"] and dec["prefill_chunks_piggybacked"] > 0


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "mma"), (torch.float32, "cuda_core")])
def test_replays_count_their_launches(dtype, route):
    """Each graph's recorded launches: K steps of paged decode and the
    sampler, the piggyback graph also its chunk's paged prefill (a launch
    a layer, on the route of the dtype); replays count them."""
    eng = _engine(dtype)
    L = eng.cfg.num_layers
    for rec, chunk in ((eng._graph_launches, {}), (eng._piggyback_launches,
                                                   {"paged_prefill": L})):
        assert {k: n for k, n in rec.launches.items() if n} == {
            "paged_decode": K * L, "sample": K, **chunk}
        assert kernels.by_route(rec.sub["paged_decode"])[route] == K * L
        assert kernels.by_route(rec.sub["paged_prefill"]).get(route, 0) == len(chunk) * L
    assert eng.decode_path_stats()["piggyback_paged_prefill_forms"] == {f"{route}:native": L}
    _mid_decode(eng, torch.Generator(device="cuda").manual_seed(4))
    kernels.reset_counts()
    for piggyback in (False, True, False):
        eng._launch_tick(piggyback)
    torch.cuda.synchronize()
    assert {k: n for k, n in kernels.launch_counts().items() if n} == {
        "paged_decode": 3 * K * L, "sample": 3 * K, "paged_prefill": L}
    assert kernels.by_route(kernels.PAGED_FORMS)[route] == 3 * K * L
    assert kernels.PAGED_PREFILL_FORMS[f"{route}:native"] == L
    (part, counters), = eng._graph_scratch.values()
    assert int(counters.abs().sum()) == 0  # each call leaves its counters at zero


_FP8_CASES = [("fp8", False, torch.bfloat16), ("fp8", True, torch.bfloat16),
              ("fp8_e5m2", False, torch.bfloat16), ("fp8_e5m2", True, torch.float32),
              ("bf16", False, torch.float32)]


@pytest.mark.parametrize("kv,attn_fp8,dtype", _FP8_CASES)
def test_narrow_pool_replay_bitwise_equal_to_eager_and_counted(kv, attn_fp8, dtype):
    """An engine on a narrow pool (``kv_cache_dtype``, ``attn_fp8``): one
    replay of its tick is bitwise the K steps run eagerly (the pool writes'
    cast captured with them), and every paged launch the graph recorded is
    on the pool's read (``PAGED_FORMS``)."""
    eng = _engine(dtype, kv_cache_dtype=kv, attn_fp8=attn_fp8)
    assert eng._cache.k.dtype == {"fp8": torch.float8_e4m3fn, "fp8_e5m2": torch.float8_e5m2,
                                  "bf16": torch.bfloat16}[kv]
    _mid_decode(eng, torch.Generator(device="cuda").manual_seed(11))
    _, replayed, eager = _replay_vs_eager(eng, eng._graph, [eng._tick_body])
    for name, got, want in zip(("k", "v", "lengths", "tokens", "toks"), replayed, eager):
        assert torch.equal(got.view(torch.uint8) if got.element_size() == 1 else got,
                           want.view(torch.uint8) if want.element_size() == 1 else want), name
    route = "mma" if dtype == torch.bfloat16 else "cuda_core"
    fmt = {"fp8": "e4m3", "fp8_e5m2": "e5m2", "bf16": "bf16"}[kv]
    form = f"{route}:{fmt}/{'in_dot' if attn_fp8 else 'dequant'}"
    for rec in (eng._graph_launches, eng._piggyback_launches):
        assert rec.sub["paged_decode"][form] == K * eng.cfg.num_layers


def test_fp8_engine_on_the_card_matches_the_cpu():
    """An f32 engine on an fp8 pool with the in-dot read: greedy ids on the
    card (graph ticks, a piggybacked chunk) equal the CPU engine's."""
    gen = torch.Generator().manual_seed(5)
    prompts = [torch.randint(1, 255, (n,), generator=gen).tolist() for n in (40, 300, 700)]

    def run(device):
        eng = _engine(torch.float32, device=device, kv_cache_dtype="fp8", attn_fp8=True)
        eng._running = True
        futs = [eng.submit(p, max_tokens=16, temperature=0.0) for p in prompts]
        for _ in range(500):
            if all(f.done() for f in futs):
                break
            eng._loop_iteration()
        return [f.result(timeout=0).token_ids for f in futs], eng.decode_path_stats()

    card, dec = run("cuda")
    cpu, _ = run("cpu")
    assert card == cpu
    assert dec["cuda_graph"] and dec["attn_fp8"] and dec["prefill_chunks_piggybacked"] > 0


def test_capture_needs_scratch_and_recording():
    """A paged call captured without its scratch allocated, or outside
    ``record_graph_launches``, raises instead of going uncounted or taking
    graph-pool memory into the shared cache."""
    B, H, KH, D, page, NB = 2, 4, 2, 64, 64, 2
    q = torch.randn(B, H, 1, D, device="cuda", dtype=torch.bfloat16)
    pool = torch.randn(B * NB, KH, page, D, device="cuda", dtype=torch.bfloat16)
    bt = torch.arange(B * NB, device="cuda", dtype=torch.int32).reshape(B, NB)
    pos = torch.tensor([3, 100], device="cuda", dtype=torch.int32)
    stream = torch.cuda.Stream()
    for record in (True, False):
        store = {}
        with kernels.private_paged_scratch(store):
            if not record:  # scratch in place: only the missing recording is at fault
                with torch.cuda.stream(stream):
                    paged_gqa_decode_attention(q, pool, pool, bt, pos)
                torch.cuda.synchronize()
            g = torch.cuda.CUDAGraph()
            with pytest.raises(RuntimeError, match="before a CUDA graph capture"
                               if record else "outside record_graph_launches"):
                ctx = kernels.record_graph_launches() if record else contextlib.nullcontext()
                with ctx, torch.cuda.graph(g, stream=stream):
                    paged_gqa_decode_attention(q, pool, pool, bt, pos)
        torch.cuda.synchronize()


def _crank(eng, futs):
    for _ in range(2000):
        if all(f.done() for f in futs):
            return
        eng._loop_iteration()
    raise AssertionError("requests did not finish")


def _registry_pages(eng):
    pages = sorted({p for _, ent in eng._kv_pool.shared_entries() for p in ent.pages})
    return pages, eng._cache.k[:, pages].clone(), eng._cache.v[:, pages].clone()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_replay_after_suffix_wave_reads_shared_pages(dtype):
    """A 600-token head registers (chunked), then three hits prefill only
    their suffixes: the next tick's replay equals the same K steps run
    eagerly over the slots' shared pages, and the shared pages (the boundary
    page too) are bitwise what the registration left."""
    eng = _engine(dtype, prefix_min_tokens=32)
    gen = torch.Generator().manual_seed(8)
    head = torch.randint(1, 255, (600,), generator=gen).tolist()  # 1 full page + a boundary
    eng._running = True
    _crank(eng, [eng.submit(head + [7, 8], max_tokens=2, temperature=0.0, prefix_len=600)])
    pages, k0, v0 = _registry_pages(eng)
    assert len(pages) == 2
    futs = [eng.submit(head + torch.randint(1, 255, (n,), generator=gen).tolist(),
                       max_tokens=64, temperature=t, prefix_len=600)
            for n, t in ((20, 0.0), (90, 0.8), (150, 0.0))]
    eng._loop_iteration()  # admission: one suffix wave, activation, first tick
    assert eng.kv_stats()["prefix_hits"] == 3 and eng.kv_stats()["kv_cow_copies"] == 3
    assert eng.num_active == 3
    torch.cuda.synchronize()
    eng._upload_dirty()
    dev_gen = torch.Generator(device="cuda").manual_seed(9)
    for i in range(K):
        gumbel_noise(eng._noise[i], dev_gen)
    before, replayed, eager = _replay_vs_eager(eng, eng._graph, [eng._tick_body])
    for name, got, want in zip(("k", "v", "lengths", "tokens", "toks"), replayed, eager):
        assert torch.equal(got, want), name
    _, k1, v1 = _registry_pages(eng)
    assert torch.equal(k0, k1) and torch.equal(v0, v1)
    _crank(eng, futs)
    _, k2, v2 = _registry_pages(eng)
    assert torch.equal(k0, k2) and torch.equal(v0, v2)


def test_piggybacked_chunk_from_a_hit_leaves_shared_pages_unchanged():
    """A hit whose suffix is longer than a chunk continues as chunks from
    the prefix length, piggybacked on a live batch's ticks: the shared pages
    stay bitwise unchanged, and the greedy ids equal the CPU engine's."""
    gen = torch.Generator().manual_seed(10)
    head = torch.randint(1, 255, (560,), generator=gen).tolist()  # page 512: 1 full + a boundary
    short = torch.randint(1, 255, (40,), generator=gen).tolist()
    long_tail = torch.randint(1, 255, (300,), generator=gen).tolist()  # two chunks of 256 from 560

    def run(device):
        eng = _engine(torch.float32, device=device, prefix_min_tokens=32, chunk_size=256)
        eng._running = True
        first = eng.submit(head + [3, 4], max_tokens=2, temperature=0.0, prefix_len=560)
        _crank(eng, [first])
        snap = _registry_pages(eng)
        futs = [eng.submit(short, max_tokens=48, temperature=0.0),
                eng.submit(head + long_tail, max_tokens=8, temperature=0.0, prefix_len=560)]
        _crank(eng, futs)
        ids = [first.result(timeout=0).token_ids] + [f.result(timeout=0).token_ids for f in futs]
        return ids, snap, _registry_pages(eng), eng

    card, (pages, k0, v0), (_, k1, v1), eng = run("cuda")
    cpu, *_ = run("cpu")
    assert card == cpu
    assert eng.kv_stats()["prefix_hits"] == 1 and eng.kv_stats()["kv_cow_copies"] == 1
    assert eng.decode_path_stats()["prefill_chunks_piggybacked"] > 0
    assert torch.equal(k0, k1) and torch.equal(v0, v1)


def test_replay_after_in_place_restart_equals_fresh_engine():
    """A request served after a crash-only restart (pools zeroed, generator
    re-seeded, graphs kept) is bitwise the request a fresh engine serves:
    ids, K/V pools and lengths; its replays are counted, and both graphs
    are the ones captured at construction."""
    gen = torch.Generator().manual_seed(11)
    warm = torch.randint(1, 255, (300,), generator=gen).tolist()
    prompts = [torch.randint(1, 255, (n,), generator=gen).tolist() for n in (50, 700)]

    def serve(eng):
        eng._running = True
        futs = [eng.submit(p, max_tokens=24, temperature=0.0) for p in prompts]
        kernels.reset_counts()
        steps0 = eng.steps
        _crank(eng, futs)
        torch.cuda.synchronize()
        return [f.result(timeout=0).token_ids for f in futs], eng.steps - steps0

    eng = _engine(torch.bfloat16)
    graphs = (eng._graph, eng._piggyback_graph)
    eng._running = True
    _crank(eng, [eng.submit(warm, max_tokens=8, temperature=0.7)])
    with eng._iter_lock:
        eng._restart(RuntimeError("injected"))
    assert eng.engine_restarts == 1 and (eng._graph, eng._piggyback_graph) == graphs
    (part, counters), = eng._graph_scratch.values()
    assert int(counters.abs().sum()) == 0
    got, steps = serve(eng)
    assert kernels.launch_counts()["paged_decode"] == eng.cfg.num_layers * steps > 0
    fresh = _engine(torch.bfloat16)
    want, _ = serve(fresh)
    assert got == want
    P = eng._kv_pool.n_pages
    assert torch.equal(eng._cache.k[:, :P], fresh._cache.k[:, :P])
    assert torch.equal(eng._cache.v[:, :P], fresh._cache.v[:, :P])
    assert torch.equal(eng._cache.lengths, fresh._cache.lengths)


@pytest.mark.parametrize("fmt", ["int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_quantized_replay_bitwise_equal_to_eager_and_counted(dtype, fmt):
    """Quantized projections in the captured tick: a replay equals the K
    steps run eagerly bitwise (the qgemm partials sum in a fixed order),
    and each replay counts its qgemm launches a layer a step by format:
    bf16 4 on the stream route (QKV and gate/up one launch each, wo, down),
    f32 7 on the CUDA-core route (one a projection)."""
    eng = _engine(dtype, fmt=fmt)
    L = eng.cfg.num_layers
    per = 4 if dtype == torch.bfloat16 else len(QUANTIZABLE)
    route = "stream" if dtype == torch.bfloat16 else "cuda_core"
    assert eng._graph_launches.launches["qgemm"] == per * L * K
    assert eng._graph_launches.sub["qgemm"][fmt] == per * L * K
    assert eng._graph_launches.sub["qgemm_route"][route] == per * L * K
    assert eng.decode_path_stats()["weight_bits"] == (8 if fmt == "int8" else 4)
    _mid_decode(eng, torch.Generator(device="cuda").manual_seed(1))
    before, replayed, eager = _replay_vs_eager(eng, eng._graph, [eng._tick_body])
    for name, got, want in zip(("k", "v", "lengths", "tokens", "toks"), replayed, eager):
        assert torch.equal(got, want), name
    kernels.reset_counts()
    eng._launch_tick(False)
    eng._launch_tick(True)
    torch.cuda.synchronize()
    # two ticks, and the piggybacked chunk's prefill (512 rows: the wgmma
    # route, one launch a projection)
    assert kernels.QGEMM_FORMATS[fmt] == 2 * per * L * K + len(QUANTIZABLE) * L


@pytest.mark.parametrize("K,N", [(4096, 4096), (4096, 1024)])
@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_quantized_prefill_projection_replay_bitwise_equal_to_eager(fmt, K, N):
    """An M = 512 bf16 projection captured as a CUDA graph (the wgmma
    kernel: its TMA descriptors are kernel parameters the graph keeps by
    value; at N = 1024 K is split through the graph's own scratch) replays
    bit for bit as the eager call, on the inputs written into the captured
    x, and each replay counts one launch on the wgmma route."""
    gen = torch.Generator().manual_seed(11)
    if fmt == "int8":
        w = QTensor(torch.randint(-127, 128, (K, N), generator=gen, dtype=torch.int8).cuda(),
                    (torch.rand((1, N), generator=gen) * 1e-2).cuda())
    else:
        w = QTensor4(torch.randint(0, 256, (K // 2, N), generator=gen, dtype=torch.uint8).cuda(),
                     (torch.rand((K // 64, N), generator=gen) * 1e-1).cuda())
    xs = [torch.randn((512, K), generator=gen).to(torch.bfloat16).cuda() for _ in range(2)]
    x = xs[0].clone()
    stream, store = torch.cuda.Stream(), {}
    with kernels.private_paged_scratch(store):
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):  # the warm-up makes the graph's scratch
            qeinsum("me,eo->mo", x, w, torch.bfloat16)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with kernels.record_graph_launches() as rec:
            with torch.cuda.graph(graph, stream=stream):
                out = qeinsum("me,eo->mo", x, w, torch.bfloat16)
    assert rec.launches["qgemm"] == 1 and rec.sub["qgemm_route"]["wgmma"] == 1
    kernels.reset_counts()
    for xi in xs + xs[:1]:
        x.copy_(xi)
        graph.replay()
        rec.replayed()
        torch.cuda.synchronize()
        eager = qeinsum("me,eo->mo", xi, w, torch.bfloat16)
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
    assert kernels.QGEMM_ROUTES["wgmma"] == 6  # three replays, three eager calls
    if N == 1024:
        (part, counters), = store.values()
        assert int(counters.abs().sum()) == 0  # each call leaves its counters at zero


def _tied_engine(dtype, device="cuda"):
    """A tied int8 embedding table as the head (per-E scales), int8
    projections."""
    cfg = dataclasses.replace(_cfg(dtype), tie_embeddings=True)
    dense = llama.init(_cfg(dtype), torch.Generator().manual_seed(3), "cpu")
    params = quantize_decoder_params({k: v for k, v in dense.items() if k != "lm_head"})
    params["tok_embed"] = quantize_tensor(dense["tok_embed"])
    params = {k: ({n: w.to(device) for n, w in v.items()} if isinstance(v, dict) else v.to(device))
              for k, v in params.items()}
    return GenerationEngine(cfg, params, ByteTokenizer(), device=device, max_slots=4,
                            max_seq_len=1024, decode_steps=K, chunk_size=512)


def test_tied_int8_head_replay_bitwise_equal_to_eager_and_engine_matches_cpu():
    """The tied int8 head on the card: in bf16 a replay of the captured tick
    (the head on the stream kernel's K-contiguous form) equals the K steps
    run eagerly bit for bit; in f32 the engine's greedy ids on the card (the
    head on the CUDA-core kernel) equal the CPU engine's."""
    eng = _tied_engine(torch.bfloat16)
    L = eng.cfg.num_layers
    # 4 stream launches a layer a step, and the head's one a step
    assert eng._graph_launches.sub["qgemm_route"]["stream"] == (4 * L + 1) * K
    _mid_decode(eng, torch.Generator(device="cuda").manual_seed(6))
    before, replayed, eager = _replay_vs_eager(eng, eng._graph, [eng._tick_body])
    for name, got, want in zip(("k", "v", "lengths", "tokens", "toks"), replayed, eager):
        assert torch.equal(got, want), name
    gen = torch.Generator().manual_seed(5)
    prompts = [torch.randint(1, 255, (n,), generator=gen).tolist() for n in (40, 300)]
    ids = {}
    for device in ("cuda", "cpu"):
        e = _tied_engine(torch.float32, device=device)
        e._running = True
        futs = [e.submit(p, max_tokens=16, temperature=0.0) for p in prompts]
        _crank(e, futs)
        ids[device] = [f.result(timeout=0).token_ids for f in futs]
    assert ids["cuda"] == ids["cpu"]


@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_quantized_engine_on_the_card_matches_the_cpu(fmt):
    """f32 int8 / int4 engines: greedy ids on the card (graph ticks, a
    piggybacked chunk, the qgemm kernel) equal the CPU engine's (plain)."""
    gen = torch.Generator().manual_seed(5)
    prompts = [torch.randint(1, 255, (n,), generator=gen).tolist() for n in (40, 300, 700)]

    def run(device):
        eng = _engine(torch.float32, device=device, fmt=fmt)
        eng._running = True
        futs = [eng.submit(p, max_tokens=16, temperature=0.0) for p in prompts[:2]]
        eng._loop_iteration()
        futs.append(eng.submit(prompts[2], max_tokens=16, temperature=0.0))
        _crank(eng, futs)
        return [f.result(timeout=0).token_ids for f in futs], eng.decode_path_stats()

    kernels.reset_counts()
    card, dec = run("cuda")
    assert kernels.launch_counts()["qgemm"] > 0
    cpu, _ = run("cpu")
    assert card == cpu
    assert dec["cuda_graph"] and dec["prefill_chunks_piggybacked"] > 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_moe_graphs_replay_bitwise_and_count_their_launches(dtype):
    cfg = dataclasses.replace(_cfg(dtype), num_experts=4)
    params = llama.init(cfg, torch.Generator().manual_seed(3), "cpu")
    params = {k: ({n: w.cuda() for n, w in v.items()} if isinstance(v, dict) else v.cuda())
              for k, v in params.items()}
    eng = GenerationEngine(cfg, params, ByteTokenizer(), device="cuda", max_slots=4,
                           max_seq_len=1024, decode_steps=K, chunk_size=512)
    L = cfg.num_layers
    gen = torch.Generator(device="cuda").manual_seed(9)
    _mid_decode(eng, gen)
    eng._chunk_ids_dev.copy_(torch.randint(1, 255, (1, eng.chunk_size), generator=gen,
                                           device="cuda", dtype=torch.int32))
    eng._chunk_bt_dev.copy_(eng._bt_dev[2])
    eng._chunk_slot_dev.fill_(2)
    eng._chunk_start_dev.fill_(256)
    eng._ensure_fsm()  # captures the JSON tick's graph
    eng._json_dev.copy_(torch.tensor([True, False, False, True]))
    for graph, bodies in ((eng._graph, [eng._tick_body]),
                          (eng._piggyback_graph, [eng._chunk_body, eng._tick_body]),
                          (eng._json_graph, [eng._json_tick_body])):
        _, replayed, eager = _replay_vs_eager(eng, graph, bodies)
        for name, got, want in zip(("k", "v", "lengths", "tokens", "toks", "fsm"), replayed,
                                   eager):
            assert torch.equal(got, want), name
    # each forward's grouped GEMM routes, as the plan gives them for its
    # token count: the ticks' 4 slots (C 8: mma), the chunk's 512 tokens
    # (C 320: wgmma in bf16); f32 takes cuda_core
    from django_assistant_bot_tpu_torch.models.mixtral import expert_capacity

    E, F, X = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts
    sms = kernels._sm_count(torch.cuda.current_device())

    def forms(tokens):
        got = dict.fromkeys(kernels.MOE_GEMM_FORMS, 0)
        for T in tokens:
            C = expert_capacity(cfg, T)
            for ep, k, n in (("gate_up", E, F), ("down", F, E)):
                got[f"{kernels.moe_gemm_plan(dtype, ep, X, C, k, n, sms=sms).route}:{ep}"] += L
        return got

    tick, chunk = [eng.max_slots] * K, [eng.chunk_size]
    if dtype == torch.bfloat16:
        assert kernels.by_route(forms(chunk))["wgmma"] == 2 * L
        assert kernels.by_route(forms(tick[:1]))["mma"] == 2 * L
    for rec, forwards, tokens in ((eng._graph_launches, K, tick),
                                  (eng._piggyback_launches, K + 1, chunk + tick),
                                  (eng._json_launches, 1, tick[:1])):
        assert {k: rec.launches[k] for k in ("moe_route", "moe_gemm", "moe_combine")} == {
            "moe_route": L * forwards, "moe_gemm": 2 * L * forwards,
            "moe_combine": L * forwards}
        assert rec.sub["moe_gemm"] == forms(tokens)
    kernels.reset_counts()
    eng._launch_tick(True)
    eng._launch_tick(json=True)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["moe_route"] == L * (K + 2)


def _spec_state(eng, rung):
    return _state(eng)[:5] + [eng._history_dev, *eng._spec_out[rung]]


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "mma"), (torch.float32, "cuda_core")])
def test_spec_rung_graphs_replay_bitwise_and_count_their_launches(dtype, route):
    """Each rung's captured speculative tick (2 verify steps) replays bit
    for bit as its body run eagerly from the same mid-decode state (ragged
    rows, one inactive, one sampled, a repetitive history), and counts
    ``paged_tree`` L launches a verify step and one sampler launch a step."""
    eng = _engine(dtype, speculative=3, spec_width=2, decode_steps=2)
    L, steps = eng.cfg.num_layers, eng.decode_steps
    assert set(eng._spec_graphs) == set(eng._spec_ctl.rungs) == {(2, 3), (1, 3), (1, 1)}
    assert eng.graph_captures == 1 + len(eng._spec_graphs) and eng._piggyback_graph is None
    gen = torch.Generator(device="cuda").manual_seed(11)
    _mid_decode(eng, gen)
    motif = torch.tensor([7, 300, 42, 9, 300, 42], dtype=torch.int32)
    eng._history_dev.copy_(motif.repeat(eng.max_seq_len // 6 + 1)[: eng.max_seq_len]
                           .expand(eng.max_slots, -1))
    for rung, (graph, rec) in eng._spec_graphs.items():
        assert {k: n for k, n in rec.launches.items() if n} == {
            "paged_tree": steps * L, "sample": steps}
        assert kernels.by_route(rec.sub["paged_tree"])[route] == steps * L
        state = [t.clone() for t in _spec_state(eng, rung)]
        graph.replay()
        torch.cuda.synchronize()
        replayed = [t.clone() for t in _spec_state(eng, rung)]
        for t, b in zip(_spec_state(eng, rung), state):
            t.copy_(b)
        with torch.no_grad():
            eng._spec_tick_body(rung)
        torch.cuda.synchronize()
        for name, got, want in zip(("k", "v", "lengths", "tokens", "toks", "history", "spec_toks",
                                    "n_new"), replayed, _spec_state(eng, rung)):
            assert torch.equal(got, want), (rung, name)
        n_new = replayed[-1]
        assert bool((n_new[:, 2] == 0).all()) and bool((n_new[:, [0, 1, 3]] >= 1).all())
        grown = replayed[2] - state[2]
        assert grown.tolist() == n_new.sum(0).tolist()
    kernels.reset_counts()
    for rung in eng._spec_ctl.rungs:
        eng._launch_spec_tick(rung)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["paged_tree"] == 3 * steps * L
    assert kernels.by_route(kernels.PAGED_TREE_FORMS)[route] == 3 * steps * L


def test_spec_engine_on_the_card_matches_cpu_and_plain():
    """f32 spec engine: greedy ids on the card equal the CPU spec engine's
    and the card's plain engine's, with drafts accepted; the verify ticks
    ran as replays (paged_tree launches = L x verify steps)."""
    gen = torch.Generator().manual_seed(8)
    motif = torch.randint(1, 255, (9,), generator=gen).tolist()
    prompts = [motif * 6, torch.randint(1, 255, (300,), generator=gen).tolist(), motif * 20]

    def run(device, **kw):
        eng = _engine(torch.float32, device=device, decode_steps=None, **kw)
        eng._running = True
        kernels.reset_counts()
        futs = [eng.submit(p, max_tokens=24, temperature=0.0) for p in prompts]
        for _ in range(2000):
            if all(f.done() for f in futs):
                break
            eng._loop_iteration()
        return [f.result(timeout=0).token_ids for f in futs], eng, kernels.launch_counts()

    card, eng, counts = run("cuda", speculative=4, spec_width=2, spec_probe_every=1)
    cpu, _, _ = run("cpu", speculative=4, spec_width=2, spec_probe_every=1)
    plain, _, _ = run("cuda")
    assert card == cpu == plain
    st = eng.spec_stats()
    assert st["spec_drafted"] > 0 and st["spec_accepted"] > 0
    assert counts["paged_tree"] == eng.cfg.num_layers * eng.spec_ticks_issued * eng.decode_steps


def _decode_and_verify_rows(eng, prefix, tree_spec):
    """The logits for the token after ``prefix`` on one state
    (``prefix[:-1]`` prefilled into a one-slot page table) through a plain
    decode step of ``prefix[-1]`` and through a verify step of the tree
    rooted at it (the root's row)."""
    cfg, params, page = eng.cfg, eng.params, 64
    NB = -(-len(prefix) // page) + 1
    with torch.no_grad():
        ids = torch.zeros((1, -(-len(prefix) // 64) * 64), dtype=torch.int32, device="cuda")
        ids[0, :len(prefix) - 1] = torch.tensor(prefix[:-1], dtype=torch.int32)
        n = torch.tensor([len(prefix) - 1], dtype=torch.int32, device="cuda")
        _, ks, vs = llama.prefill(params, cfg, ids, n)
        cache = llama.init_paged_cache(cfg, 1, NB, page, device="cuda")
        bt = torch.arange(NB, dtype=torch.int32, device="cuda")[None]
        llama.insert_sequences_paged(cache, ks, vs, n, torch.zeros(1, dtype=torch.int32,
                                                                   device="cuda"), bt)
        last = torch.tensor([prefix[-1]], dtype=torch.int32, device="cuda")
        tree = last[:, None].repeat(1, tree_spec.size)
        ver = llama.verify_tree_step_paged(
            params, cfg, tree, cache, bt, torch.from_numpy(tree_spec.depths).cuda(),
            torch.from_numpy(tree_spec.anc_mask).cuda())[0][0, 0]
        dec = llama.decode_step_paged(params, cfg, last, cache, bt)[0][0]
    return dec.float(), ver.float()


def test_spec_engine_on_the_card_refuses_a_tree_past_the_kernel_tile():
    """A bf16 spec engine on the card verifies a 65-node tree (speculative
    16, spec_width 4: two tree tiles on the tensor-core kernel) and serves:
    every verify step's paged_tree launches took the ``mma`` route, drafts
    were accepted, and its greedy ids equal the card's plain engine's but at
    a flagged near tie, as chip_smoke.py's phase 11 holds them: at the first
    divergence the plain decode step's top-two margin lies within the
    verify step's distance from it on one state."""
    from django_assistant_bot_tpu_torch.ops.speculative import make_tree_spec

    gen = torch.Generator().manual_seed(8)
    motif = torch.randint(1, 255, (9,), generator=gen).tolist()
    prompts = [motif * 6, torch.randint(1, 255, (300,), generator=gen).tolist(), motif * 20]

    def run(**kw):
        eng = _engine(torch.bfloat16, decode_steps=None, **kw)
        eng._running = True
        kernels.reset_counts()
        futs = [eng.submit(p, max_tokens=24, temperature=0.0) for p in prompts]
        for _ in range(2000):
            if all(f.done() for f in futs):
                break
            eng._loop_iteration()
        return ([f.result(timeout=0).token_ids for f in futs], eng, kernels.launch_counts(),
                kernels.by_route(kernels.PAGED_TREE_FORMS))

    spec_ids, eng, counts, routes = run(speculative=16, spec_width=4, spec_probe_every=1)
    assert eng.spec_width * eng.speculative + 1 == 65
    verify_launches = eng.cfg.num_layers * eng.spec_ticks_issued * eng.decode_steps
    assert counts["paged_tree"] == verify_launches > 0
    assert routes == {"mma": verify_launches, "cuda_core": 0}
    st = eng.spec_stats()
    assert st["spec_drafted"] > 0 and st["spec_accepted"] > 0
    plain_ids, plain, _, _ = run()
    tree_spec = make_tree_spec(4, 16)
    for prompt, a, b in zip(prompts, spec_ids, plain_ids):
        if a == b:
            continue
        pos = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        assert pos is not None, (a, b)  # one stops early without a divergence
        dec, ver = _decode_and_verify_rows(plain, prompt + b[:pos], tree_spec)
        top2 = torch.topk(dec, 2).values
        assert float(top2[0] - top2[1]) <= float((ver - dec).abs().max()), (pos, a, b)
