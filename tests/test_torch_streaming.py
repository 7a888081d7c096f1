"""Token streaming in the port (``serving/streaming.py``, the engine's
``generate_stream``, ``"stream": true`` on ``/dialog/``): the contracts of
the JAX package's ``tests/test_streaming.py``.

- the deltas concatenate to the one-shot decode, over random multi-byte
  splits and a flushed tail;
- a greedy stream equals the non-streaming ``generate`` of the port and the
  JAX engine's greedy ids;
- abandoning a stream frees its slot within a tick and counts it;
- the SSE wire: happy path, ``json_format`` refused, unknown model 400,
  disconnect frees the slot.
"""

import asyncio
import dataclasses
import json
import random
import time

import numpy as np
import pytest

import jax

from django_assistant_bot_tpu.models import DecoderConfig as JaxDecoderConfig
from django_assistant_bot_tpu.models import llama as jllama
from django_assistant_bot_tpu.serving import ByteTokenizer as JaxByteTokenizer
from django_assistant_bot_tpu.serving import GenerationEngine as JaxGenerationEngine
from django_assistant_bot_tpu.serving import IncrementalDetokenizer as JaxDetok
from django_assistant_bot_tpu_torch.convert import params_from_jax
from django_assistant_bot_tpu_torch.models import DecoderConfig
from django_assistant_bot_tpu_torch.serving import (
    ByteTokenizer,
    GenerationEngine,
    IncrementalDetokenizer,
    ModelRegistry,
    TokenStream,
)
from django_assistant_bot_tpu_torch.serving.server import create_app

MULTIBYTE_CORPUS = (
    "hello world! "
    "héllo café naïve "
    "👋🌍🤖🔥💡🧪 "
    "日本語のテキストです "
    "한국어 텍스트 "
    "привет мир "
    "🇺🇦🇯🇵 👩‍👩‍👧‍👦 "
)


class _NonByteTokenizer(ByteTokenizer):
    """Forces the general (full re-decode) path of the detokenizer."""

    byte_level = False


# ------------------------------------------------------- incremental detok
@pytest.mark.parametrize("tok_cls", [ByteTokenizer, _NonByteTokenizer])
def test_incremental_detok_property_random_splits(tok_cls):
    """One token at a time over random multi-byte strings: the deltas
    concatenate to the one-shot decode, equal the JAX detokenizer's deltas,
    and never hold a fabricated replacement character."""
    tok = tok_cls()
    jtok = JaxByteTokenizer()
    if not tok.byte_level:
        jtok.byte_level = False
    rng = random.Random(7)
    for _ in range(40):
        s = "".join(rng.choice(MULTIBYTE_CORPUS) for _ in range(rng.randint(0, 30)))
        ids = tok.encode(s)
        detok, jdetok = IncrementalDetokenizer(tok), JaxDetok(jtok)
        parts = [detok.push(i) for i in ids] + [detok.flush()]
        assert parts == [jdetok.push(i) for i in ids] + [jdetok.flush()]
        out = "".join(parts)
        assert out == tok.decode(ids) == s
        assert all("�" not in p for p in parts)


def test_incremental_detok_flushes_truncated_tail():
    """A generation cut mid-character matches the one-shot decode: the
    replacement appears only at the flush."""
    tok = ByteTokenizer()
    ids = list("né".encode("utf-8"))[:-1]
    detok = IncrementalDetokenizer(tok)
    mid = "".join(detok.push(i) for i in ids)
    assert "�" not in mid
    assert mid + detok.flush() == tok.decode(ids)


def test_token_stream_never_blocks_the_producer():
    """Past its capacity the producer drops (and counts) instead of waiting;
    ``finish`` closes the stream once."""
    from concurrent.futures import Future

    async def go():
        st = TokenStream().bind(asyncio.get_running_loop(), capacity=2)
        assert st.push_token(1) is False  # notified at once
        st.push_token(2)
        st.push_token(3)  # over capacity
        assert st.dropped == 1
        fut: Future = Future()
        fut.set_result("done")
        st.finish(fut)
        st.finish(fut)
        return [ev async for ev in st]

    assert asyncio.run(go()) == [("token", 1), ("token", 2), ("done", "done")]


# ----------------------------------------------------------- engine stream
@pytest.fixture(scope="module")
def tiny_models():
    jcfg = dataclasses.replace(JaxDecoderConfig.tiny(), max_seq_len=2048)
    jparams = jllama.init(jcfg, jax.random.key(0))
    cfg = dataclasses.replace(DecoderConfig.tiny(), max_seq_len=2048)
    return jcfg, jparams, cfg, params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")


@pytest.fixture(scope="module")
def stream_engine(tiny_models):
    # a long context: an abandoned generation would run for thousands of
    # ticks if the cancel did not reap it
    _, _, cfg, params = tiny_models
    eng = GenerationEngine(cfg, params, ByteTokenizer(), device="cpu", max_slots=2,
                           max_seq_len=2048).start()
    yield eng
    eng.stop()


def _collect_stream(eng, prompt, **kw):
    async def go():
        chunks = [c async for c in eng.generate_stream(prompt, **kw)]
        return "".join(c.text for c in chunks), chunks, chunks[-1]

    return asyncio.run(go())


def test_engine_stream_byte_identical_to_generate(stream_engine, tiny_models):
    """A greedy stream gives the non-streaming result's ids and text, byte
    for byte, one chunk per token, and the JAX engine's greedy ids."""
    jcfg, jparams, _, _ = tiny_models
    eng = stream_engine
    prompt = "hello streaming world"
    ref = eng.submit(eng.tokenizer.encode(prompt), max_tokens=12,
                     temperature=0.0).result(timeout=300)
    text, chunks, final = _collect_stream(eng, prompt, max_tokens=12, temperature=0.0)
    assert final.done and final.finish_reason in ("stop", "length")
    assert final.result.token_ids == ref.token_ids
    assert text == ref.text == final.result.text
    tokens = [c for c in chunks if not c.done]
    assert [c.index for c in tokens] == list(range(len(tokens)))
    assert [c.token_id for c in tokens] == ref.token_ids
    jeng = JaxGenerationEngine(jcfg, jparams, JaxByteTokenizer(), max_slots=2, max_seq_len=2048,
                               kv_layout="paged", scheduler=None).start()
    try:
        want = jeng.submit(JaxByteTokenizer().encode(prompt), max_tokens=12,
                           temperature=0.0).result(timeout=300)
    finally:
        jeng.stop()
    assert final.result.token_ids == want.token_ids


def test_engine_stream_disconnect_frees_slot_within_tick(stream_engine):
    """Abandoning the iterator mid-generation cancels the request; the reap
    frees the slot within a tick (not the ~2,000 remaining tokens) and counts
    it as cancelled."""
    eng = stream_engine
    before = eng.cancelled_slots

    async def go():
        agen = eng.generate_stream("x" * 16, max_tokens=2000, temperature=0.8)
        got = 0
        async for _ in agen:
            got += 1
            if got >= 2:
                break
        await agen.aclose()
        return got

    assert asyncio.run(go()) >= 2
    steps_at_cancel = eng.steps
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        if eng.num_active == 0 and eng.cancelled_slots > before:
            break
        time.sleep(0.005)
    assert eng.num_active == 0, "slot not reclaimed after stream abandonment"
    # the reap runs at the next iteration: at most the lookahead's ticks
    # in flight and one more ran after the cancel
    assert eng.steps - steps_at_cancel <= (eng.lookahead + 1) * eng.decode_steps
    stats = eng.tick_stats()
    assert stats["stream"]["cancelled_slots"] > before
    assert stats["reclaimed_slots"] >= stats["stream"]["cancelled_slots"]


def test_engine_stream_latency_stats(stream_engine):
    """TTFT and inter-token percentiles accumulate from streamed traffic."""
    eng = stream_engine
    _collect_stream(eng, "stats please", max_tokens=20, temperature=0.0)
    lat = eng.latency_stats()
    assert lat["ttft_n"] >= 1 and lat["ttft_p50_ms"] > 0
    assert lat["itl_n"] >= 1
    assert lat["itl_p95_ms"] >= lat["itl_p50_ms"] >= 0
    assert eng.stats()["stream"].keys() == lat.keys()


# ---------------------------------------------------------------- SSE wire
@pytest.fixture(scope="module")
def sse_client():
    from aiohttp.test_utils import TestClient, TestServer

    loop = asyncio.new_event_loop()
    registry = ModelRegistry.from_config(
        {"tiny-chat": {"kind": "decoder", "tiny": True, "max_slots": 2, "max_seq_len": 1024}},
        device="cpu",
    )
    client = TestClient(TestServer(create_app(registry)), loop=loop)
    loop.run_until_complete(client.start_server())
    yield loop, client, registry
    loop.run_until_complete(client.close())
    loop.close()


async def _read_sse(resp, limit=None):
    events = []
    async for raw in resp.content:
        line = raw.decode("utf-8").strip()
        if not line.startswith("data:"):
            continue
        data = line[len("data:"):].strip()
        if data == "[DONE]":
            events.append("[DONE]")
            break
        events.append(json.loads(data))
        if limit is not None and len(events) >= limit:
            break
    return events


def test_sse_dialog_happy_path(sse_client):
    """``text/event-stream``; the deltas concatenate to the terminal event's
    result, usage rides the terminal event, ``[DONE]`` ends it, and the same
    greedy request without ``stream`` gives the same text."""
    loop, client, _ = sse_client
    body = {"model": "tiny-chat", "messages": [{"role": "user", "content": "hi"}],
            "max_tokens": 6, "temperature": 0.0, "stream": True}

    async def go():
        resp = await client.post("/dialog/", json=body, headers={"X-Request-Id": "sse-1"})
        assert resp.status == 200
        assert resp.headers["Content-Type"].startswith("text/event-stream")
        assert resp.headers["X-Request-Id"] == "sse-1"
        events = await _read_sse(resp)
        assert events[-1] == "[DONE]"
        terminal = events[-2]
        assert terminal["done"] is True and terminal["request_id"] == "sse-1"
        assert terminal["finish_reason"] in ("stop", "length")
        usage = terminal["usage"]
        assert usage["completion_tokens"] <= 6
        assert usage["total_tokens"] == usage["prompt_tokens"] + usage["completion_tokens"]
        deltas = "".join(e["delta"] for e in events[:-2])
        assert deltas == terminal["result"]
        plain = {k: v for k, v in body.items() if k != "stream"}
        resp2 = await client.post("/dialog/", json=plain)
        assert resp2.status == 200
        assert (await resp2.json())["response"]["result"] == terminal["result"]

    loop.run_until_complete(go())


def test_sse_rejects_json_format(sse_client):
    """``stream`` with ``json_format`` is a 422 (the JAX choice), as is a
    ``stream`` flag that is not a boolean."""
    loop, client, _ = sse_client
    msgs = [{"role": "user", "content": "hi"}]

    async def go():
        resp = await client.post("/dialog/", json={"model": "tiny-chat", "messages": msgs,
                                                   "json_format": True, "stream": True})
        assert resp.status == 422
        assert "json_format" in (await resp.json())["detail"]
        resp = await client.post("/dialog/", json={"model": "tiny-chat", "messages": msgs,
                                                   "stream": "yes"})
        assert resp.status == 422

    loop.run_until_complete(go())


def test_sse_unknown_model_is_400(sse_client):
    loop, client, _ = sse_client

    async def go():
        resp = await client.post("/dialog/", json={"model": "nope", "messages": [],
                                                   "stream": True})
        assert resp.status == 400

    loop.run_until_complete(go())


def test_sse_disconnect_frees_slot(sse_client):
    """Closing the connection mid-stream cancels the request: the slot frees
    (not after the remaining ~900 tokens) and ``/healthz`` shows the cancel
    in its ``stream`` block."""
    loop, client, registry = sse_client
    eng = registry.get_generator("tiny-chat")
    before = eng.cancelled_slots

    async def go():
        resp = await client.post("/dialog/", json={
            "model": "tiny-chat", "messages": [{"role": "user", "content": "stream then vanish"}],
            "max_tokens": 900, "stream": True})
        assert resp.status == 200
        assert await _read_sse(resp, limit=2)
        resp.close()
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            if eng.num_active == 0 and eng.cancelled_slots > before:
                break
            await asyncio.sleep(0.01)
        assert eng.num_active == 0 and eng.cancelled_slots > before
        health = await (await client.get("/healthz")).json()
        g = health["generators"]["tiny-chat"]
        assert g["stream"]["cancelled_slots"] == eng.cancelled_slots
        assert "ttft_p50_ms" in g["stream"]

    loop.run_until_complete(go())
