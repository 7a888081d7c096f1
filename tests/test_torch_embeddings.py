"""The port's embedding plane against the JAX package's (CPU):

- ``EmbeddingEngine`` on the same params (``encoder_params_from_jax``) and
  ``ByteTokenizer``: ``embed_sync`` within 1e-5 in f32 (normalised and
  not, texts in three sequence buckets and past the position cap);
  coalescing of concurrent calls into one batch, the same text embedding
  the same whatever its batch-mates, a shed at ``max_queue`` and cancelled
  futures dropped, on both engines;
- the registry's encoder specs (decoder-only knobs refused as the JAX
  registry refuses them) and ``serve --tiny`` registering ``tiny-emb``;
- the HTTP contract of ``/embeddings/`` (``tests/test_serving.py``'s, plus
  429 with ``Retry-After`` on a shed), and the embedders in ``/healthz``,
  ``/models`` and ``/metrics``.
"""

import asyncio
from concurrent.futures import Future

import numpy as np
import pytest
import torch

import jax

from django_assistant_bot_tpu.models import EncoderConfig as JaxEncoderConfig
from django_assistant_bot_tpu.models import encoder as jencoder
from django_assistant_bot_tpu.serving import EmbeddingEngine as JaxEmbeddingEngine
from django_assistant_bot_tpu.serving import SchedulerRejected as JaxSchedulerRejected
from django_assistant_bot_tpu.serving.registry import ModelRegistry as JaxModelRegistry
from django_assistant_bot_tpu_torch.convert import encoder_params_from_jax
from django_assistant_bot_tpu_torch.models import EncoderConfig
from django_assistant_bot_tpu_torch.serving import (
    ByteTokenizer,
    EmbeddingEngine,
    ModelRegistry,
    ModelSpec,
    SchedulerRejected,
)

F32_TOL = 1e-5

TEXTS = ["alpha", "beta gamma", "x" * 40, "a longer sentence " * 5, "y" * 300, "ok"]


@pytest.fixture(scope="module")
def params():
    jcfg = JaxEncoderConfig.tiny()
    jparams = jencoder.init(jcfg, jax.random.key(1))
    cfg = EncoderConfig.tiny()
    return jcfg, jparams, cfg, encoder_params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")


@pytest.mark.parametrize("normalize", [False, True])
def test_embedding_engine_matches_jax(params, normalize):
    jcfg, jparams, cfg, tparams = params
    jeng = JaxEmbeddingEngine(jcfg, jparams, ByteTokenizer(), max_batch=4, normalize=normalize)
    teng = EmbeddingEngine(cfg, tparams, ByteTokenizer(), max_batch=4, normalize=normalize,
                           device="cpu")
    assert teng.seq_buckets == jeng.seq_buckets == (32, 64, 128)
    assert teng._batch_buckets() == jeng._batch_buckets() == [1, 2, 4]
    want = np.asarray(jeng.embed_sync(TEXTS))
    got = np.asarray(teng.embed_sync(TEXTS))
    assert got.shape == (len(TEXTS), cfg.hidden_size)
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0)


def test_embedding_engine_coalesces_and_is_batch_invariant(params):
    _, _, cfg, tparams = params
    eng = EmbeddingEngine(cfg, tparams, ByteTokenizer(), max_batch=8, normalize=True, device="cpu")
    batches = []
    orig = eng._embed_batch
    eng._embed_batch = lambda texts: (batches.append(len(texts)), orig(texts))[1]
    eng._running = True  # no thread yet: the three requests queue up together
    try:
        async def go():
            futs = [asyncio.ensure_future(eng.embed(t))
                    for t in (["alpha", "beta"], ["gamma"], ["delta", "epsilon", "zeta"])]
            await asyncio.sleep(0.01)
            eng._running = False
            eng.start()
            return await asyncio.gather(*futs)

        r1, r2, r3 = asyncio.run(go())
    finally:
        eng.stop()
    assert batches == [6]  # one coalesced device batch
    assert [len(r) for r in (r1, r2, r3)] == [2, 1, 3]
    for v in r1 + r2 + r3:
        assert len(v) == cfg.hidden_size and abs(np.linalg.norm(v) - 1.0) < 1e-4
    # the same text embeds the same whatever its batch-mates (batch 1 vs 8)
    solo = eng.embed_sync(["beta"])[0]
    np.testing.assert_allclose(solo, r1[1], atol=F32_TOL)


@pytest.mark.parametrize("port", [False, True])
def test_embedding_queue_bound_sheds(params, port):
    jcfg, jparams, cfg, tparams = params
    eng = (EmbeddingEngine(cfg, tparams, ByteTokenizer(), max_queue=1, device="cpu") if port
           else JaxEmbeddingEngine(jcfg, jparams, ByteTokenizer(), max_queue=1))
    rejected = SchedulerRejected if port else JaxSchedulerRejected
    eng._running = True  # no coalescer thread: the queue must fill
    try:
        async def drive():
            t1 = asyncio.ensure_future(eng.embed(["a"]))
            await asyncio.sleep(0.01)
            with pytest.raises(rejected) as err:
                await eng.embed(["b"])
            t1.cancel()
            return err.value

        err = asyncio.run(drive())
        assert eng.shed == 1
        assert err.retry_after_s == pytest.approx(1.01)
    finally:
        eng._running = False
        eng.stop()


@pytest.mark.parametrize("port", [False, True])
def test_embedding_coalescer_drops_cancelled_futures(params, port):
    jcfg, jparams, cfg, tparams = params
    eng = (EmbeddingEngine(cfg, tparams, ByteTokenizer(), device="cpu") if port
           else JaxEmbeddingEngine(jcfg, jparams, ByteTokenizer()))
    cancelled: Future = Future()
    cancelled.cancel()
    live: Future = Future()
    eng._queue.put((["dead text"], cancelled))
    eng._queue.put((["live text"], live))
    eng.start()
    try:
        embs = live.result(timeout=60)
        assert len(embs) == 1 and len(embs[0]) == cfg.hidden_size
        assert eng.dropped_cancelled == 1
    finally:
        eng.stop()


def test_embedding_engine_refusals(params):
    _, _, cfg, tparams = params
    with pytest.raises(NotImplementedError, match="item 15"):
        EmbeddingEngine(cfg, tparams, ByteTokenizer(), mesh=object(), device="cpu")
    eng = EmbeddingEngine(cfg, tparams, ByteTokenizer(), device="cpu", max_batch=4)
    eng.warmup(seq_buckets=(32,))  # runs: every batch bucket at that length
    assert asyncio.run(eng.embed([])) == []


# knob -> a value that sets it on an encoder spec
_DECODER_ONLY = {
    "quantize": "int8", "decode_steps": 2, "warmup_json": True, "speculative": 2,
    "kv_cache_dtype": "fp8", "attn_fp8": True, "kv_host_bytes": 1 << 20,
    "kv_spill_dir": "/nonexistent", "replicas": 2, "max_replicas": 2, "autoscale": True,
    "replica_devices": 1, "pool": "prefill",
}


@pytest.mark.parametrize("knob", sorted(_DECODER_ONLY))
def test_registry_refuses_decoder_only_knobs_on_an_encoder(knob):
    spec = {"kind": "encoder", "tiny": True, knob: _DECODER_ONLY[knob]}
    with pytest.raises(ValueError):
        JaxModelRegistry.from_config({"e": spec})
    with pytest.raises(ValueError, match="decoder-only"):
        ModelRegistry.from_config({"e": spec}, device="cpu")


def test_registry_loads_an_encoder():
    with pytest.raises(ValueError, match="kind"):
        ModelSpec.from_dict("x", {"kind": "classifier"})
    spec = ModelSpec.from_dict("e", {"kind": "encoder", "tiny": True, "max_batch": 16,
                                     "normalize": True, "max_queue": 7})
    assert (spec.max_batch, spec.normalize, spec.max_queue) == (16, True, 7)
    registry = ModelRegistry.from_config(
        {"Tiny-Emb": {"kind": "encoder", "tiny": True, "max_batch": 16, "normalize": True,
                      "max_queue": 7}},
        device="cpu",
    )
    try:
        eng = registry.get_embedder("TINY-EMB")
        assert eng is registry.embedders["tiny-emb"] and registry.get_generator("tiny-emb") is None
        assert (eng.max_batch, eng.normalize, eng.max_queue) == (16, True, 7)
        assert eng.device == torch.device("cpu") and eng.cfg == EncoderConfig.tiny()
        v = eng.embed_sync(["hi"])[0]
        assert abs(np.linalg.norm(v) - 1.0) < 1e-4
    finally:
        registry.stop()


def test_serve_tiny_registers_the_encoder(monkeypatch):
    import argparse

    from django_assistant_bot_tpu_torch.cli import serve

    seen = {}
    monkeypatch.setattr("django_assistant_bot_tpu_torch.serving.server.run_server",
                        lambda registry, host, port: seen.update(registry=registry))
    args = argparse.Namespace(tiny=True, config=None, host="127.0.0.1", port=0, device="cpu")
    assert serve.run(args) == 0
    registry = seen["registry"]
    try:
        assert set(registry.embedders) == {"tiny-emb"} and set(registry.generators) == {"tiny-chat"}
        assert registry.embedders["tiny-emb"].normalize is False
    finally:
        registry.stop()


@pytest.fixture(scope="module")
def http_client():
    from aiohttp.test_utils import TestClient, TestServer

    from django_assistant_bot_tpu_torch.serving.server import create_app

    loop = asyncio.new_event_loop()
    registry = ModelRegistry.from_config(
        {"tiny-emb": {"kind": "encoder", "tiny": True, "normalize": True},
         "shed-emb": {"kind": "encoder", "tiny": True, "max_queue": 1}},
        device="cpu",
    )
    client = TestClient(TestServer(create_app(registry)), loop=loop)
    loop.run_until_complete(client.start_server())
    yield loop, client, registry
    loop.run_until_complete(client.close())
    loop.close()


def test_http_embeddings_contract(http_client):
    loop, client, _ = http_client

    async def go():
        for path in ("/embeddings/", "/embeddings"):
            resp = await client.post(path, json={"model": "Tiny-EMB", "texts": ["hello", "world"]})
            assert resp.status == 200
            data = await resp.json()
            assert set(data) == {"embeddings"}
            assert len(data["embeddings"]) == 2 and len(data["embeddings"][0]) == 64
        resp = await client.post("/embeddings/", json={"model": "nope", "texts": ["x"]})
        assert resp.status == 400
        assert (await resp.json())["detail"] == "Model is not supported"
        for body in ({"texts": ["x"]}, {"model": "tiny-emb", "texts": "x"},
                     {"model": "tiny-emb", "texts": [1]}, {"model": 3, "texts": ["x"]}):
            resp = await client.post("/embeddings/", json=body)
            assert resp.status == 422
        resp = await client.post("/embeddings/", data="not json")
        assert resp.status == 422

    loop.run_until_complete(go())


def test_http_embeddings_sheds_with_retry_after(http_client):
    """A full embedding queue answers 429 with ``Retry-After``; /healthz
    and /metrics count the shed."""
    loop, client, registry = http_client
    eng = registry.get_embedder("shed-emb")
    eng.stop()
    eng._running = True  # no coalescer thread: the one queue slot stays taken

    async def go():
        first = asyncio.ensure_future(
            client.post("/embeddings/", json={"model": "shed-emb", "texts": ["a"]}))
        for _ in range(1000):  # until the first request holds the queue slot
            if eng._queue.qsize():
                break
            await asyncio.sleep(0.01)
        assert eng._queue.qsize() == 1
        resp = await client.post("/embeddings/", json={"model": "shed-emb", "texts": ["b"]})
        assert resp.status == 429
        assert int(resp.headers["Retry-After"]) >= 1
        data = await resp.json()
        assert data["retry_after_s"] > 0 and data["reason"] == "embedding queue full"
        health = await (await client.get("/healthz")).json()
        assert health["embedders"]["shed-emb"] == {
            "queue_depth": 1, "max_queue": 1, "shed": 1, "dropped_cancelled": 0}
        models = await (await client.get("/models")).json()
        assert models["shed-emb"]["kind"] == "encoder"
        text = await (await client.get("/metrics")).text()
        assert 'dabt_embed_shed_total{model="shed-emb"} 1' in text
        eng._running = False
        await asyncio.to_thread(eng.stop)  # fails the queued request
        resp = await first
        assert resp.status == 500

    loop.run_until_complete(go())
