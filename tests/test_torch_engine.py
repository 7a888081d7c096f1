"""The port's serving path against the JAX package's (CPU, tiny geometry):

- the port's ``GenerationEngine`` and the JAX ``GenerationEngine`` on the
  JAX engine's rollback settings (paged KV, FIFO admission, sequential
  chunked prefill, no prefix cache, single-step ticks), same weights, ragged
  greedy prompts (some past ``chunk_size``): identical token ids (the
  default loop is held to the JAX engine in tests/test_torch_contbatch.py);
- ``/dialog/`` over aiohttp's test client on ``--device cpu``: the wire
  contract of tests/test_serving.py;
- unported knobs and request fields are refused, naming their ROADMAP item,
  and the JAX defaults of the ported ones are accepted.
"""

import asyncio
import json

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
from django_assistant_bot_tpu_torch.serving import (
    ByteTokenizer,
    GenerationEngine,
    ModelRegistry,
    ModelSpec,
    pick_bucket,
)


def _drive(eng, futs, limit=4000):
    """Single-threaded deterministic engine loop (as in
    tests/test_kv_paging.py): every request is queued before the first
    admission, so both engines see the same waves and tick schedule."""
    steps = 0
    while not all(f.done() for f in futs):
        eng._reap_dead_slots()
        eng._admit()
        if eng._chunking is not None:
            eng._chunk_step()
        if eng.num_active > 0:
            eng._issue_tick()
        while eng._inflight and (len(eng._inflight) > eng.lookahead or eng.num_active == 0):
            eng._process_tick()
        steps += 1
        assert steps < limit, "engine made no progress"


def _run(eng, prompts, max_tokens):
    eng._running = True
    futs = [eng.submit(p, max_tokens=max_tokens, temperature=0.0) for p in prompts]
    _drive(eng, futs)
    eng._running = False
    return [f.result(timeout=0).token_ids for f in futs]


@pytest.fixture(scope="module")
def tiny_models():
    jcfg = JaxDecoderConfig.tiny()
    jparams = jllama.init(jcfg, jax.random.key(0))
    cfg = DecoderConfig.tiny()
    return jcfg, jparams, cfg, params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")


@pytest.mark.parametrize("chunk_size,max_slots", [(64, 4), (512, 2)])
def test_engine_token_identical_to_jax_engine(tiny_models, chunk_size, max_slots):
    jcfg, jparams, cfg, params = tiny_models
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 255, n).tolist() for n in (9, 33, 65, 100, 200, 150, 240)]
    kw = dict(max_slots=max_slots, max_seq_len=256, chunk_size=chunk_size)
    jeng = JaxGenerationEngine(
        jcfg, jparams, JaxByteTokenizer(), kv_layout="paged", scheduler=None,
        prefill_piggyback=False, prefix_cache_size=0, decode_steps=1, **kw,
    )
    teng = GenerationEngine(
        cfg, params, ByteTokenizer(), device="cpu", prefill_piggyback=False, decode_steps=1, **kw
    )
    assert teng.kv_page_size == jeng.kv_page_size
    want = _run(jeng, prompts, 12)
    got = _run(teng, prompts, 12)
    assert got == want
    assert teng._kv_pool.pages_free == teng._kv_pool.n_pages  # every page returned


def test_engine_thread_generate_and_stop(tiny_models):
    _, _, cfg, params = tiny_models
    eng = GenerationEngine(cfg, params, ByteTokenizer(), device="cpu", max_slots=2, max_seq_len=128)
    eng.start()
    try:
        result = asyncio.run(
            eng.generate([{"role": "user", "content": "hi"}], max_tokens=5, temperature=0.7)
        )
    finally:
        eng.stop()
    assert result.prompt_tokens == len(ByteTokenizer().encode_chat([{"role": "user", "content": "hi"}]))
    assert 1 <= result.completion_tokens <= 5
    with pytest.raises(RuntimeError, match="stopped"):
        eng.submit([1, 2, 3]).result(timeout=5)


def test_engine_loop_error_fails_requests_and_keeps_serving(tiny_models, monkeypatch):
    """A device-step error is engine-fatal: the crash-only restart fails the
    request that had already emitted tokens (the JAX contract of
    tests/test_serving.py: a replay would repeat output), returns every page
    and leaves the loop serving the next request.  ``lookahead=0`` and one
    step per tick make the first token reach the host before the failing
    second tick; the token-less case is tests/test_torch_supervision.py's."""
    from django_assistant_bot_tpu_torch.models import llama

    _, _, cfg, params = tiny_models
    real = llama.decode_step_paged
    calls = []

    def fail_second(*args, **kwargs):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("injected device fault")
        return real(*args, **kwargs)

    monkeypatch.setattr(llama, "decode_step_paged", fail_second)
    eng = GenerationEngine(cfg, params, ByteTokenizer(), device="cpu", max_slots=2,
                           max_seq_len=128, lookahead=0, decode_steps=1, obs=False)
    eng.start()
    try:
        with pytest.raises(RuntimeError, match="injected"):
            eng.submit([1, 2, 3], max_tokens=4, temperature=0.0).result(timeout=60)
        result = eng.submit([1, 2, 3], max_tokens=4, temperature=0.0).result(timeout=60)
    finally:
        eng.stop()
    assert result.completion_tokens == 4
    sup = eng.supervision_stats()
    assert sup["engine_restarts"] == 1 and sup["restarted_requests_resubmitted"] == 0
    assert eng._kv_pool.pages_free == eng._kv_pool.n_pages


def test_pick_bucket():
    assert pick_bucket(300, (32, 64, 128, 256, 512, 1024), 512) == 512
    assert pick_bucket(9, (32, 64), 512) == 32
    assert pick_bucket(900, (32, 64, 128, 256, 512, 1024), 512) == 512


@pytest.mark.parametrize(
    "knob,value,item",
    [
        ("kv_layout", "legacy", "Queue 1 item 8"),
        ("attn_fp8", True, "Queue 2 entry 5"),
        ("kv_cache_dtype", "fp8_e5m2", "Queue 2 entry 5"),
        ("speculative", 3, "Queue 1 item 9"),
        ("kv_cache_dtype", "fp8", "Queue 2 entry 5"),
    ],
)
def test_engine_refuses_unported_knobs(tiny_models, knob, value, item):
    _, _, cfg, params = tiny_models
    if knob == "speculative":
        # Queue 1 item 9 (speculative decoding) is ported: the engine takes it
        eng = GenerationEngine(cfg, params, ByteTokenizer(), device="cpu", **{knob: value})
        assert eng.speculative == value and eng.spec_stats()["spec_tree_depth"] == value
        return
    if knob == "kv_layout":
        # Queue 1 item 8 (the legacy contiguous KV layout) is ported: the
        # engine takes it and reports it in kv_stats
        eng = GenerationEngine(cfg, params, ByteTokenizer(), device="cpu", **{knob: value})
        assert not eng.paged and eng._cache.k.dim() == 5
        ks = eng.kv_stats()
        assert ks["kv_layout"] == ks["kv_layout_requested"] == ks["kv_layout_effective"] == value
        return
    if item == "Queue 2 entry 5":
        # fp8 KV pools and the in-dot read are ported: the engine takes them
        # (attn_fp8 on an fp8 pool, as the JAX engine requires)
        kw = {knob: value} if knob == "kv_cache_dtype" else {knob: value, "kv_cache_dtype": "fp8"}
        eng = GenerationEngine(cfg, params, ByteTokenizer(), device="cpu", **kw)
        want = {"fp8": torch.float8_e4m3fn, "fp8_e5m2": torch.float8_e5m2}[kw["kv_cache_dtype"]]
        assert eng._cache.k.dtype == eng._cache.v.dtype == want
        assert eng.decode_path_stats()["attn_fp8"] is (knob == "attn_fp8")
        return
    with pytest.raises(NotImplementedError, match=item):
        GenerationEngine(cfg, params, ByteTokenizer(), device="cpu", **{knob: value})


@pytest.mark.parametrize(
    "key,value,item",
    [
        ("quantize", "int8", "Queue 2 entry 3"),
        ("checkpoint", "/x", "Queue 1 item 4"),
        ("kv_host_bytes", 1 << 20, "Queue 1 item 12"),
        ("speculative", 2, "Queue 1 item 9"),
        ("kind", "encoder", "Queue 1 item 7"),
    ],
)
def test_spec_refuses_unported_keys(key, value, item):
    spec = {"kind": "decoder", "tiny": True, key: value}
    if key == "kind":
        # Queue 1 item 7 (embeddings) is ported: an encoder spec is accepted
        assert ModelSpec.from_dict("m", spec).kind == "encoder"
    elif key == "quantize":
        # Queue 2 entry 3 (int8/int4 qeinsum) is ported: the spec is accepted
        assert ModelSpec.from_dict("m", spec).quantize == "int8"
    elif key == "speculative":
        # Queue 1 item 9 (speculative decoding) is ported: the spec is accepted
        assert ModelSpec.from_dict("m", spec).engine_kwargs()["speculative"] == 2
    else:
        with pytest.raises(NotImplementedError, match=item):
            ModelSpec.from_dict("m", spec)
    with pytest.raises(ValueError, match="unknown spec key"):
        ModelSpec.from_dict("m", {"tiny": True, "no_such_knob": 1})
    # the JAX rollback values themselves are accepted
    spec = ModelSpec.from_dict("m", {"tiny": True, "scheduler": False, "prefix_cache": 0})
    assert spec.tiny and spec.device == "cuda"


def test_jax_defaults_of_ported_keys_are_accepted(tiny_models):
    """The JAX ``ModelSpec`` defaults of the keys this slice ported are the
    port's defaults too, and the engine takes them (and the JAX rollback
    values) as the JAX engine does: ``decode_steps`` wins when given, a spec
    ``decode_steps`` of 0 inherits ``burst``."""
    from django_assistant_bot_tpu.serving.registry import ModelSpec as JaxModelSpec
    from django_assistant_bot_tpu_torch.serving import RequestScheduler

    jspec = JaxModelSpec(name="m", kind="decoder")
    keys = ("burst", "decode_steps", "prefill_piggyback", "scheduler", "sched_max_queue",
            "sched_class_weights", "sched_tenant_weights", "sched_admit_max_wait_s",
            "sched_default_deadline_s", "sched_degrade_at", "sched_degrade_max_tokens")
    spec = ModelSpec.from_dict("m", {"tiny": True, **{k: getattr(jspec, k) for k in keys}})
    assert {k: getattr(spec, k) for k in keys} == {k: getattr(jspec, k) for k in keys}
    assert {k: getattr(ModelSpec(name="m"), k) for k in keys} == {k: getattr(jspec, k) for k in keys}
    sched = spec.build_scheduler()
    assert isinstance(sched, RequestScheduler) and sched.cfg.max_queue == 256
    assert ModelSpec(name="m", scheduler=False).build_scheduler() is None
    with pytest.raises(ValueError, match="decode_steps"):
        ModelSpec.from_dict("m", {"tiny": True, "decode_steps": -1})

    _, _, cfg, params = tiny_models
    eng = GenerationEngine(cfg, params, ByteTokenizer(), device="cpu", max_seq_len=128)
    assert (eng.decode_steps, eng.prefill_piggyback, eng.scheduler) == (8, True, None)
    assert GenerationEngine(
        cfg, params, ByteTokenizer(), device="cpu", max_seq_len=128, burst=4
    ).decode_steps == 4
    eng = GenerationEngine(
        cfg, params, ByteTokenizer(), device="cpu", max_seq_len=128, burst=4, decode_steps=2,
        prefill_piggyback=False, scheduler=spec.build_scheduler(),
    )
    assert (eng.decode_steps, eng.prefill_piggyback) == (2, False)
    assert eng.stats()["sched"]["max_queue"] == 256
    with pytest.raises(ValueError, match="decode_steps"):
        GenerationEngine(cfg, params, ByteTokenizer(), device="cpu", decode_steps=0)


# ------------------------------------------------------------------ HTTP
@pytest.fixture(scope="module")
def http_client():
    from aiohttp.test_utils import TestClient, TestServer

    from django_assistant_bot_tpu_torch.serving.server import create_app

    loop = asyncio.new_event_loop()
    registry = ModelRegistry.from_config(
        {"tiny-chat": {"kind": "decoder", "tiny": True, "max_slots": 2, "max_seq_len": 64}},
        device="cpu",
    )
    client = TestClient(TestServer(create_app(registry)), loop=loop)
    loop.run_until_complete(client.start_server())
    yield loop, client
    loop.run_until_complete(client.close())
    loop.close()


def test_http_dialog_contract(http_client):
    loop, client = http_client

    async def go():
        for path in ("/dialog/", "/dialog"):
            resp = await client.post(
                path,
                json={
                    "model": "Tiny-Chat",
                    "messages": [{"role": "user", "content": "hi"}],
                    "max_tokens": 4,
                    "json_format": False,
                },
                headers={"X-Request-Id": "req-1"},
            )
            assert resp.status == 200
            data = await resp.json()
            assert data["request_id"] == "req-1" and resp.headers["X-Request-Id"] == "req-1"
            r = data["response"]
            assert set(r) >= {"result", "usage", "length_limited"}
            assert isinstance(r["result"], str)
            assert r["usage"]["completion_tokens"] <= 4
            assert r["usage"]["total_tokens"] == (
                r["usage"]["prompt_tokens"] + r["usage"]["completion_tokens"]
            )

        resp = await client.post("/dialog/", json={"model": "missing", "messages": [], "max_tokens": 1})
        assert resp.status == 400
        assert (await resp.json())["detail"] == "Model is not supported"
        resp = await client.post("/dialog/", json={"messages": []})
        assert resp.status == 422
        resp = await client.post("/dialog/", json={"model": "tiny-chat", "messages": [], "max_tokens": 0})
        assert resp.status == 422
        resp = await client.post(
            "/dialog/", json={"model": "tiny-chat", "messages": [], "json_format": True}
        )
        assert resp.status == 200
        r = (await resp.json())["response"]
        assert not r["length_limited"], r
        assert isinstance(json.loads(r["result"]), (dict, list)), r

    loop.run_until_complete(go())


def test_http_healthz_and_models(http_client):
    loop, client = http_client

    async def go():
        resp = await client.get("/healthz")
        assert resp.status == 200
        data = await resp.json()
        assert data["status"] == "ok"
        assert "tiny-chat" in data["models"]
        assert data["generators"]["tiny-chat"]["kv_pages_total"] > 0
        resp = await client.get("/models")
        assert (await resp.json())["tiny-chat"]["kind"] == "decoder"

    loop.run_until_complete(go())
