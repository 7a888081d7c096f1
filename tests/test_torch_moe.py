"""The port's Mixtral MoE against the JAX package's (CPU, tiny geometry:
E 64, X 4 experts, top 2; inputs from numpy seeds):

- ``expert_capacity`` equal to the JAX function's over a sweep of T, X, K
  and the capacity factor;
- ``moe_route_plain`` against the routing the JAX ``moe_mlp`` implies (its
  lines 46-63 run in JAX): ids equal, gates within 1e-6, the dense dispatch
  rebuilt from the port's slots equal to JAX's, also at capacity factors
  that drop (0.5, 0.25) and with a planted exact tie (two equal router
  columns: the lower expert must win), and ``route_margin`` flags nothing;
- the twins composed (``moe_mlp`` on the CPU) and ``moe_mlp_plain`` against
  the JAX ``moe_mlp`` in f32 at T 1, 8, 512 (1e-5: summation order only);
- the bf16 twins within ``moe_gemm_bf16_bound`` of their f32 references,
  and a misrouted slot shown to break it;
- ``prefill`` logits against the JAX ``prefill`` on ``DecoderConfig.tiny(
  num_experts=4)`` through ``params_from_jax``;
- the JAX ``tests/test_models.py`` Mixtral contract on the port: an HF
  ``MixtralForCausalLM`` saved locally, ``load_decoder`` at no-drop capacity,
  last-token logits through ``prefill`` at several prompt lengths against
  HF's (atol 5e-4, rtol 1e-3);
- greedy ids token-identical to the JAX ``GenerationEngine`` at the default
  loop (8-step ticks, piggybacked chunks), at the default capacity factor and
  at one that drops in prefill and in the piggybacked chunk;
- the registry serves ``num_experts`` on ``tiny`` (over ``/dialog/``) and a
  Mixtral HF directory, and refuses ``quantize`` with a MoE model, naming
  ROADMAP Queue 1 item 17, as ``init_int8`` and ``params_from_jax`` refuse
  quantized experts.
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
from django_assistant_bot_tpu.models import mixtral as jmixtral
from django_assistant_bot_tpu.serving import ByteTokenizer as JaxByteTokenizer
from django_assistant_bot_tpu.serving import GenerationEngine as JaxGenerationEngine
from django_assistant_bot_tpu_torch.convert import params_from_jax
from django_assistant_bot_tpu_torch.models import DecoderConfig, llama, mixtral
from django_assistant_bot_tpu_torch.ops import moe
from django_assistant_bot_tpu_torch.serving import ByteTokenizer, GenerationEngine, ModelRegistry

X, K, E = 4, 2, 64
ITEM = "Queue 1 item 17"


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _configs(factor=1.25):
    jcfg = dataclasses.replace(JaxDecoderConfig.tiny(num_experts=X), expert_capacity_factor=factor)
    cfg = dataclasses.replace(DecoderConfig.tiny(num_experts=X), expert_capacity_factor=factor)
    return jcfg, cfg


@pytest.fixture(scope="module")
def tiny_moe():
    jcfg, cfg = _configs()
    jparams = jllama.init(jcfg, jax.random.key(0))
    return jcfg, jparams, cfg, params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")


def _layer0(jparams, params):
    jp = {k: v[0] for k, v in jparams["layers"].items()}
    tp = {k: v[0] for k, v in params["layers"].items()}
    return jp, tp


# ------------------------------------------------------------------ capacity
@pytest.mark.parametrize("factor", [0.25, 0.5, 1.0, 1.25, 2.0, 8.0])
def test_expert_capacity_matches_jax(factor):
    for experts, top_k in ((4, 1), (4, 2), (8, 2), (16, 4)):
        jcfg = dataclasses.replace(JaxDecoderConfig.tiny(num_experts=experts),
                                   experts_per_token=top_k, expert_capacity_factor=factor)
        cfg = dataclasses.replace(DecoderConfig.tiny(num_experts=experts),
                                  experts_per_token=top_k, expert_capacity_factor=factor)
        for T in (1, 7, 8, 9, 64, 100, 512, 2048, 4096):
            assert mixtral.expert_capacity(cfg, T) == jmixtral.expert_capacity(jcfg, T), (T, experts)


def test_mixtral_8x7b_config_matches_jax():
    j = JaxDecoderConfig.mixtral_8x7b()
    t = DecoderConfig.mixtral_8x7b()
    fields = [f.name for f in dataclasses.fields(j) if f.name != "dtype"]
    assert {f: getattr(t, f) for f in fields} == {f: getattr(j, f) for f in fields}
    assert t.dtype == torch.bfloat16 and t.is_moe


# ------------------------------------------------------------------- routing
def _jax_routing(x, router, C):
    """The JAX ``moe_mlp``'s routing (models/mixtral.py:46-63), run in JAX:
    (ids [T, K], gates [T, K], dispatch [T, X, C], combine [T, X, C])."""
    xt = jnp.asarray(x)
    logits = jnp.einsum("te,ex->tx", xt.astype(jnp.float32), jnp.asarray(router).astype(jnp.float32))
    probs = jax.nn.softmax(logits, axis=-1)
    gate_vals, gate_idx = jax.lax.top_k(probs, K)
    gate_vals = gate_vals / jnp.maximum(gate_vals.sum(-1, keepdims=True), 1e-9)
    T = xt.shape[0]
    dispatch = jnp.zeros((T, X, C), jnp.float32)
    combine = jnp.zeros((T, X, C), jnp.float32)
    counts = jnp.zeros((X,), jnp.int32)
    for choice in range(K):
        onehot_e = jax.nn.one_hot(gate_idx[:, choice], X, dtype=jnp.int32)
        pos = jnp.cumsum(onehot_e, axis=0) - onehot_e + counts[None, :]
        counts = counts + onehot_e.sum(axis=0)
        pos_in_e = (pos * onehot_e).sum(-1)
        keep = pos_in_e < C
        pos_oh = jax.nn.one_hot(pos_in_e, C, dtype=jnp.float32) * keep[:, None]
        slot = onehot_e.astype(jnp.float32)[:, :, None] * pos_oh[:, None, :]
        dispatch = dispatch + slot
        combine = combine + gate_vals[:, choice, None, None] * slot
    return (np.asarray(gate_idx), np.asarray(gate_vals), np.asarray(dispatch),
            np.asarray(combine))


def _dense_from_slots(tok_slot, tok_gate, C):
    T = tok_slot.shape[0]
    dispatch = np.zeros((T, X * C), np.float32)
    combine = np.zeros((T, X * C), np.float32)
    for t in range(T):
        for j in range(K):
            s = int(tok_slot[t, j])
            if s >= 0:
                dispatch[t, s] += 1.0
                combine[t, s] += float(tok_gate[t, j])
    return dispatch.reshape(T, X, C), combine.reshape(T, X, C)


def _route_inputs(T, seed, tie):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, E)).astype(np.float32)
    router = (rng.normal(size=(E, X)) * E ** -0.5).astype(np.float32)
    if tie:
        router[:, 2] = router[:, 1]  # experts 1 and 2: equal logits for every token
    return x, router


@pytest.mark.parametrize("tie", [False, True], ids=["random", "planted_tie"])
@pytest.mark.parametrize("factor", [1.25, 0.5, 0.25])
@pytest.mark.parametrize("T", [8, 512])
def test_route_plain_matches_jax_routing(T, factor, tie):
    jcfg, cfg = _configs(factor)
    C = jmixtral.expert_capacity(jcfg, T)
    x, router = _route_inputs(T, 10 + T, tie)
    ids_j, gates_j, disp_j, comb_j = _jax_routing(x, router, C)
    tok_slot, tok_gate, slot_tok, fill = moe.moe_route_plain(_t(x), _t(router), K, C)
    tok_slot, slot_tok = tok_slot.numpy(), slot_tok.numpy()
    # ids: recovered from the slots where kept, and from the twin directly
    _, probs = moe.router_probs(_t(x), _t(router))
    ids_t = torch.sort(probs, dim=-1, descending=True, stable=True)[1][:, :K].numpy()
    np.testing.assert_array_equal(ids_t, ids_j)
    kept = tok_slot >= 0
    np.testing.assert_array_equal((tok_slot // C)[kept], ids_j[kept])
    np.testing.assert_allclose(tok_gate.numpy(), gates_j, atol=1e-6, rtol=0)
    disp_t, comb_t = _dense_from_slots(tok_slot, tok_gate.numpy(), C)
    np.testing.assert_array_equal(disp_t, disp_j)
    np.testing.assert_allclose(comb_t, comb_j, atol=1e-6, rtol=0)
    # slot_tok / fill are the inverse view of tok_slot
    np.testing.assert_array_equal(fill.numpy(),
                                  np.minimum(np.bincount(ids_j.reshape(-1), minlength=X), C))
    for x_ in range(X):
        for c in range(C):
            t = slot_tok[x_, c]
            assert (t < 0) == (c >= fill[x_]), (x_, c)
            if t >= 0:
                assert (tok_slot[t] == x_ * C + c).sum() == 1
    drops = int((~kept).sum())
    if factor < 1.0 and T == 512:
        assert drops > 0  # the forced-drop cases do drop
    near, flagged = moe.route_margin(_t(x), _t(router), K)
    assert int(flagged.sum()) == 0 and int(near.sum()) == 0
    if tie:  # the tie decides a choice: the lower expert took it
        p = probs.numpy()
        at_boundary = (p[:, 1] == p[:, 2]) & (np.sort(p, -1)[:, -2] == p[:, 1])
        at_boundary &= np.sort(p, -1)[:, -3] == p[:, 1]
        assert at_boundary.any()
        assert (ids_j[at_boundary, 1] == 1).all() and (ids_t[at_boundary, 1] == 1).all()


def test_route_margin_flags_near_ties_and_their_dependents():
    x, router = _route_inputs(64, 3, False)
    _, probs = moe.router_probs(_t(x), _t(router))
    near, flagged = moe.route_margin(_t(x), _t(router), K, eps=1.0)  # every gap is "near"
    assert bool(near.all()) and bool(flagged.all())
    gaps = torch.sort(probs, -1, descending=True)[0]
    gaps = (gaps[:, :K] - gaps[:, 1:K + 1]).amin(-1)
    eps = float(torch.sort(gaps)[0][3])  # four tokens within eps
    near, flagged = moe.route_margin(_t(x), _t(router), K, eps=eps)
    assert int(near.sum()) == 3 and bool((flagged | ~near).all())
    assert int(flagged.sum()) > int(near.sum())  # later tokens of their experts


# ----------------------------------------------------------------- moe_mlp f32
@pytest.mark.parametrize("factor", [1.25, 0.25])
@pytest.mark.parametrize("shape", [(1, 1), (8, 1), (1, 512)], ids=["T1", "T8", "T512"])
def test_moe_mlp_matches_jax(tiny_moe, shape, factor):
    jcfg, jparams, cfg, params = tiny_moe
    jcfg = dataclasses.replace(jcfg, expert_capacity_factor=factor)
    cfg = dataclasses.replace(cfg, expert_capacity_factor=factor)
    jp, tp = _layer0(jparams, params)
    x = np.random.default_rng(sum(shape)).normal(size=(*shape, E)).astype(np.float32)
    want = np.asarray(jmixtral.moe_mlp(jcfg, jp, jnp.asarray(x)))
    got = mixtral.moe_mlp(cfg, tp, _t(x)).numpy()
    plain = mixtral.moe_mlp_plain(cfg, tp, _t(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(plain, want, atol=1e-5, rtol=1e-5)
    near, _ = moe.route_margin(_t(x.reshape(-1, E)), tp["router"], K)
    assert int(near.sum()) == 0


def test_bf16_twins_within_their_bounds(tiny_moe):
    """The bf16 twins (the rounding points the kernels keep) meet
    ``moe_gemm_bf16_bound`` against the f32 reference on the same bf16
    inputs, and a slot routed to the wrong token breaks it."""
    _, _, _, params = tiny_moe
    tp = {k: v[0].to(torch.bfloat16) for k, v in params["layers"].items()}
    x = _t(np.random.default_rng(5).normal(size=(512, E)).astype(np.float32)).to(torch.bfloat16)
    C = mixtral.expert_capacity(DecoderConfig.tiny(num_experts=X), 512)
    tok_slot, tok_gate, slot_tok, fill = moe.moe_route(x, tp["router"], K, C)
    live = torch.arange(C)[None, :, None] < fill[:, None, None]
    h = moe.moe_expert_gemm(x, slot_tok, fill, tp["w_gate"], tp["w_up"], epilogue="gate_up")
    ref, bound = moe.moe_gemm_bf16_bound(x, slot_tok, tp["w_gate"], tp["w_up"], epilogue="gate_up")
    assert bool((((h.float() - ref).abs() <= bound) | ~live).all())
    ye = moe.moe_expert_gemm(h, slot_tok, fill, tp["w_down"], epilogue="down")
    ref, bound = moe.moe_gemm_bf16_bound(h, slot_tok, tp["w_down"], epilogue="down")
    assert bool((((ye.float() - ref).abs() <= bound) | ~live).all())
    wrong = slot_tok.clone()
    wrong[0, 0], wrong[0, 1] = slot_tok[0, 1], slot_tok[0, 0]
    bad = moe.moe_expert_gemm(x, wrong, fill, tp["w_gate"], tp["w_up"], epilogue="gate_up")
    ref, bound = moe.moe_gemm_bf16_bound(x, slot_tok, tp["w_gate"], tp["w_up"], epilogue="gate_up")
    assert not bool(((bad.float() - ref).abs() <= bound).all())
    out = moe.moe_combine(tok_slot, tok_gate, ye)
    assert out.dtype == torch.bfloat16 and out.shape == (512, E) and bool(out.isfinite().all())


# --------------------------------------------------------------- the decoder
def test_prefill_matches_jax(tiny_moe):
    jcfg, jparams, cfg, params = tiny_moe
    rng = np.random.default_rng(1)
    ids = rng.integers(1, 255, (3, 64)).astype(np.int32)
    lengths = np.asarray([64, 40, 1], np.int32)
    lj, kj, vj = jllama.prefill(jparams, jcfg, jnp.asarray(ids), jnp.asarray(lengths))
    lt, kt, vt = llama.prefill(params, cfg, _t(ids), _t(lengths))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), atol=1e-4)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1e-4)


@pytest.fixture(scope="module")
def hf_mixtral(tmp_path_factory):
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.MixtralConfig(
        vocab_size=512, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, intermediate_size=64, num_local_experts=4,
        num_experts_per_tok=2, rope_theta=10000.0, max_position_embeddings=128,
    )
    torch.manual_seed(0)
    model = transformers.MixtralForCausalLM(hf_cfg).eval()
    d = tmp_path_factory.mktemp("mixtral")
    model.save_pretrained(str(d), safe_serialization=True)
    return str(d), model


def test_load_decoder_mixtral_matches_hf(hf_mixtral):
    from django_assistant_bot_tpu_torch.models.hf_loader import load_decoder

    d, model = hf_mixtral
    cfg, params = load_decoder(d, dtype=torch.float32, device="cpu")
    assert cfg.is_moe and params["layers"]["w_gate"].shape == (2, 4, 32, 64)
    # no-drop capacity: every token could route to the same expert
    cfg = dataclasses.replace(cfg, expert_capacity_factor=float(cfg.num_experts))
    ids = np.array([[1, 5, 9, 17, 3, 25, 7, 100, 64, 2, 33, 90, 12]], np.int64)
    with torch.no_grad():
        hf_logits = model(torch.from_numpy(ids)).logits.numpy()
    for n in (1, 6, 13):
        logits, _, _ = llama.prefill(params, cfg, _t(ids[:, :n].astype(np.int32)),
                                     torch.tensor([n], dtype=torch.int32))
        np.testing.assert_allclose(logits.numpy(), hf_logits[:, n - 1], atol=5e-4, rtol=1e-3)


# ------------------------------------------------------------------ the engine
def _crank(eng, futs, limit=3000):
    for _ in range(limit):
        if all(f.done() for f in futs):
            return
        eng._loop_iteration()
    raise AssertionError("requests did not finish within the crank budget")


def _trace(eng, early, late, cranks=2):
    eng._running = True
    futs = [eng.submit(p, max_tokens=10, temperature=0.0) for p in early]
    for _ in range(cranks):
        eng._loop_iteration()
    futs += [eng.submit(p, max_tokens=10, temperature=0.0) for p in late]
    _crank(eng, futs)
    eng._running = False
    return [f.result(timeout=0).token_ids for f in futs], eng.decode_path_stats()


@pytest.mark.parametrize("factor", [1.25, 0.25], ids=["default", "drops"])
def test_default_loop_token_identical_to_jax_engine(tiny_moe, factor, monkeypatch):
    jcfg, jparams, cfg, params = tiny_moe
    jcfg = dataclasses.replace(jcfg, expert_capacity_factor=factor)
    cfg = dataclasses.replace(cfg, expert_capacity_factor=factor)
    rng = np.random.default_rng(3)
    early = [rng.integers(1, 255, n).tolist() for n in (9, 40, 20)]
    late = [rng.integers(1, 255, n).tolist() for n in (150, 70)]  # chunked, piggybacked
    kw = dict(max_slots=4, max_seq_len=256, chunk_size=64, decode_steps=8, prefill_piggyback=True)
    jeng = JaxGenerationEngine(jcfg, jparams, JaxByteTokenizer(), kv_layout="paged",
                               scheduler=None, prefix_cache_size=0, **kw)
    teng = GenerationEngine(cfg, params, ByteTokenizer(), device="cpu", **kw)
    # count the port's drops by call site: prefill, piggybacked chunk, tick
    drops = {"prefill": 0, "chunk": 0, "tick": 0}
    where = {"site": "prefill"}
    route = mixtral.moe_route

    def counting_route(xt, router, top_k, capacity):
        out = route(xt, router, top_k, capacity)
        drops[where["site"]] += int((out[0] < 0).sum())
        return out

    def at(site, fn):
        def run(*a, **k):
            where["site"] = site
            try:
                return fn(*a, **k)
            finally:
                where["site"] = "prefill"
        return run

    monkeypatch.setattr(mixtral, "moe_route", counting_route)
    teng._chunk_body = at("chunk", teng._chunk_body)
    teng._tick_body = at("tick", teng._tick_body)
    want, jdec = _trace(jeng, early, late)
    got, tdec = _trace(teng, early, late)
    assert got == want
    assert tdec["prefill_chunks_piggybacked"] == jdec["prefill_chunks_piggybacked"] > 0
    assert drops["tick"] == 0  # C = 8 >= the 4 slots
    if factor < 1.0:
        assert drops["prefill"] > 0 and drops["chunk"] > 0, drops
    assert teng._kv_pool.pages_free == teng._kv_pool.n_pages


# ---------------------------------------------------------------- the registry
def test_registry_serves_tiny_moe_over_dialog():
    from aiohttp.test_utils import TestClient, TestServer

    from django_assistant_bot_tpu_torch.serving.server import create_app

    registry = ModelRegistry.from_config(
        {"tiny-moe": {"kind": "decoder", "tiny": True, "num_experts": 4, "max_slots": 2,
                      "max_seq_len": 64}},
        device="cpu",
    )
    loop = asyncio.new_event_loop()
    client = TestClient(TestServer(create_app(registry)), loop=loop)
    try:
        loop.run_until_complete(client.start_server())
        eng = registry.get_generator("tiny-moe")
        assert eng.cfg.is_moe and eng.params["layers"]["w_gate"].shape == (2, 4, 64, 128)

        async def go():
            resp = await client.post("/dialog/", json={
                "model": "tiny-moe", "messages": [{"role": "user", "content": "hi"}],
                "max_tokens": 4})
            assert resp.status == 200
            r = (await resp.json())["response"]
            assert 1 <= r["usage"]["completion_tokens"] <= 4

        loop.run_until_complete(go())
    finally:
        loop.run_until_complete(client.close())
        registry.stop()
        loop.close()


def test_registry_serves_mixtral_dir_and_refuses_quantized_moe(hf_mixtral):
    from django_assistant_bot_tpu_torch.serving.registry import ModelSpec

    d, _ = hf_mixtral
    registry = ModelRegistry.from_config(
        {"mix": {"kind": "decoder", "path": d, "dtype": "float32", "max_slots": 2,
                 "max_seq_len": 64}}, device="cpu")
    try:
        eng = registry.get_generator("mix")
        assert eng.cfg.is_moe
        result = asyncio.run(eng.generate([{"role": "user", "content": "hi"}], max_tokens=3,
                                          temperature=0.0))
        assert 1 <= len(result.token_ids) <= 3
    finally:
        registry.stop()
    for fmt in ("int8", "int4"):
        with pytest.raises(ValueError, match=ITEM):
            ModelSpec.from_dict("m", {"tiny": True, "num_experts": 4, "quantize": fmt})
        with pytest.raises(ValueError, match=ITEM):
            ModelRegistry.from_config({"m": {"path": d, "quantize": fmt}}, device="cpu")
    assert ModelSpec.from_dict("m", {"tiny": True, "num_experts": 4}).num_experts == 4


def test_quantized_experts_are_refused(tiny_moe):
    jcfg, _, cfg, _ = tiny_moe
    gen = torch.Generator().manual_seed(0)
    for init in (llama.init_int8, llama.init_int4):
        with pytest.raises(NotImplementedError, match=ITEM):
            init(cfg, gen, "cpu")
    jq = jllama.init_int8(jcfg, jax.random.key(0))
    with pytest.raises(NotImplementedError, match=ITEM):
        params_from_jax(jax.tree.map(np.asarray, jq), cfg, "cpu")
