"""The port's admission scheduler against the JAX package's (CPU):

- the port's ``RequestScheduler`` (a copy) and the JAX one driven through the
  same scripted scenarios with an injected clock: weighted class shares,
  tenant interleave and weights, the queue bound, the estimated-wait and
  KV-pressure tests, the degradation band, the per-token service model and
  deadline reaping give the same pop orders, shed decisions and stats;
- the port's engine with a scheduler: interactive overtakes background, a
  deadline frees a live slot, submission sheds past the bound (the contracts
  of tests/test_scheduler.py);
- ``/dialog/``: a shed maps to 429 with ``Retry-After``, an expired deadline
  to 504, bad scheduling fields to 422, and ``/healthz`` carries the
  ``sched`` block and the tick gauges.
"""

import asyncio
import dataclasses
import math
import time
from concurrent.futures import Future
from typing import Optional

import pytest
import torch

from django_assistant_bot_tpu.serving import scheduler as jax_sched
from django_assistant_bot_tpu_torch.models import DecoderConfig, llama
from django_assistant_bot_tpu_torch.serving import (
    ByteTokenizer,
    DeadlineExceeded,
    GenerationEngine,
    ModelRegistry,
    SchedulerRejected,
)
from django_assistant_bot_tpu_torch.serving import scheduler as port_sched


@dataclasses.dataclass
class Req:
    rid: int
    future: Future
    submitted_at: float
    priority: str = "interactive"
    tenant: str = "default"
    deadline_at: Optional[float] = None
    admitted: bool = False
    kv_pages: int = 0


class Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


class Script:
    """One scenario's moves on one scheduler module, recorded as a trace."""

    def __init__(self, mod, cfg_kw=None, slots=8):
        self.mod, self.clock, self.trace, self.n = mod, Clock(), [], 0
        self.s = mod.RequestScheduler(mod.SchedulerConfig(**(cfg_kw or {})), slots=slots,
                                      clock=self.clock)

    def req(self, priority="interactive", tenant="default", deadline_in=None, admitted=False,
            kv_pages=0):
        self.n += 1
        dl = self.clock.t + deadline_in if deadline_in is not None else None
        return Req(self.n, Future(), self.clock.t, priority, tenant, dl, admitted, kv_pages)

    def admit(self, priority="interactive", tenant="default", deadline_s=None, kv_pages=0,
              enqueue=True):
        adm = self.s.try_admit(priority, deadline_s, kv_pages=kv_pages)
        self.trace.append(("admit", adm.ok, adm.reason, round(adm.retry_after_s, 9),
                           adm.clamp_max_tokens))
        if adm.ok and enqueue:
            self.s.enqueue(self.req(priority, tenant, admitted=True, kv_pages=kv_pages))

    def pop_all(self, n=None):
        out = []
        while n is None or len(out) < n:
            r = self.s.pop(self.clock.t)
            if r is None:
                break
            out.append((r.rid, r.priority, r.tenant))
        self.trace.append(("pops", out))

    def stats(self, *keys):
        st = self.s.stats()
        self.trace.append(("stats", {k: st[k] for k in keys}))


def weighted_shares(sc):
    for _ in range(18):
        sc.admit("background")
    for _ in range(18):
        sc.admit("interactive")
    sc.pop_all(18)
    sc.pop_all()
    sc.stats("admitted", "queue_depth")


def tenant_interleave(sc):
    sc.s.cfg.class_weights = {"background": 1}
    for tenant in ("a", "b"):
        for _ in range(8):
            sc.admit("background", tenant)
    sc.pop_all(6)
    sc.pop_all()


def tenant_weights(sc):
    sc.s.cfg.class_weights = {"background": 1}
    sc.s.cfg.tenant_weights = {"big": 3.0, "small": 1.0}
    for tenant in ("big", "small"):
        for _ in range(12):
            sc.admit("background", tenant)
    sc.pop_all(8)
    # an idle queue banks no credit: "late" starts at the current virtual time
    sc.admit("background", "late")
    sc.pop_all()


def queue_bound(sc):
    sc.s.cfg.max_queue, sc.s.cfg.admit_max_wait_s = 2, None
    for _ in range(3):
        sc.admit("background", enqueue=False)
    sc.stats("shed", "queue_depth", "pressure")


def estimated_wait(sc):
    sc.s.bind_slots(1)
    sc.s.cfg.admit_max_wait_s, sc.s.cfg.service_time_init = 1.0, 2.0
    sc.s._service_ema_s = 2.0
    sc.admit()
    sc.admit()  # depth 1 x 2 s / 1 slot > 1 s
    sc.s.cfg.admit_max_wait_s = None
    sc.admit(deadline_s=0.5, enqueue=False)  # the queue alone eats the deadline
    for _ in range(60):
        sc.s.note_service(0.001)
    sc.admit(deadline_s=0.5, enqueue=False)
    sc.stats("shed", "est_wait_s", "service_ema_s")


def kv_pressure(sc):
    free = [40]
    sc.s.bind_kv(lambda: free[0], 64)
    sc.s.cfg.admit_max_wait_s, sc.s._service_ema_s = 0.5, 2.0
    sc.admit(kv_pages=30)
    sc.admit(kv_pages=30)  # 30 > 40 - 30 obtainable and the KV wait is long
    free[0] = 64
    sc.admit(kv_pages=30)
    sc.pop_all()
    sc.stats("shed", "queued_kv_pages")


def degrade_band(sc):
    sc.s.cfg.max_queue, sc.s.cfg.degrade_at, sc.s.cfg.degrade_max_tokens = 4, 0.5, 16
    sc.admit("background")
    sc.admit("background")
    sc.trace.append(("degraded", sc.s.degraded()))
    sc.s.set_degrade(8)
    sc.admit("background")
    sc.s.set_degrade(None)
    sc.stats("degraded", "degrade_forced", "queue_depth")


def service_model(sc):
    sc.s.bind_slots(1)
    sc.s.note_service(1.0)
    sc.stats("service_per_token_ema_ms", "service_model_s", "service_ema_s")
    sc.s.note_service(1.0, tokens=10)
    for _ in range(50):
        sc.s.note_service(0.8, tokens=8)
    sc.admit()
    sc.trace.append(("est", round(sc.s.est_wait_s(), 9)))
    sc.stats("service_per_token_ema_ms", "service_model_s", "service_tokens_ema")


def deadline_reaping(sc):
    reqs = [sc.req(deadline_in=d) for d in (None, 0.5, 5.0, None, 0.2)]
    reqs[3].future.cancel()
    for r in reqs:
        sc.s.enqueue(r)
    sc.clock.t += 1.0
    sc.trace.append(("reaped", sc.s.reap(sc.clock.t)))
    sc.trace.append(("failed", [type(r.future.exception(timeout=0)).__name__
                                for r in reqs if r.future.done() and not r.future.cancelled()]))
    head = sc.req(deadline_in=0.1)
    sc.s.enqueue(head, front=True)
    sc.clock.t += 1.0
    sc.pop_all()  # the expired head is dropped at the pop, the live entries served
    sc.stats("expired_queued", "cancelled_queued", "queue_depth")


SCENARIOS = [weighted_shares, tenant_interleave, tenant_weights, queue_bound, estimated_wait,
             kv_pressure, degrade_band, service_model, deadline_reaping]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=[f.__name__ for f in SCENARIOS])
def test_scheduler_decisions_equal_jax_scheduler(scenario):
    traces = []
    for mod in (jax_sched, port_sched):
        sc = Script(mod)
        scenario(sc)
        traces.append(sc.trace)
    assert traces[1] == traces[0]
    assert any(ev[0] in ("pops", "admit", "reaped") for ev in traces[1])


# --------------------------------------------------------- engine integration
def _tiny_engine(max_queue=64, **kw):
    cfg = DecoderConfig.tiny()
    params = llama.init(cfg, torch.Generator().manual_seed(0), "cpu")
    sched = port_sched.RequestScheduler(
        port_sched.SchedulerConfig(max_queue=max_queue, admit_max_wait_s=None)
    )
    return GenerationEngine(cfg, params, ByteTokenizer(), device="cpu", max_slots=1,
                            max_seq_len=256, scheduler=sched, **kw)


@pytest.fixture(scope="module")
def sched_engine():
    eng = _tiny_engine().start()
    yield eng
    eng.stop()


def test_engine_interactive_overtakes_background_queue(sched_engine):
    """One slot and a background backlog: interactive requests finish before
    all but the background work already started."""
    eng = sched_engine
    done = []
    futs = []
    for i in range(5):
        f = eng.submit([1, 2, 3, i + 1], max_tokens=12, temperature=0.0,
                       priority="background", tenant="ingest")
        f.add_done_callback(lambda _, n=f"bg{i}": done.append(n))
        futs.append(f)
    for i in range(2):
        f = eng.submit([7, 8, 9, i + 1], max_tokens=6, temperature=0.0,
                       priority="interactive", tenant="dialog")
        f.add_done_callback(lambda _, n=f"int{i}": done.append(n))
        futs.append(f)
    for f in futs:
        f.result(timeout=120)
    assert max(done.index("int0"), done.index("int1")) < min(done.index("bg3"), done.index("bg4"))


def test_engine_deadline_frees_live_slot_mid_decode(sched_engine):
    eng = sched_engine
    t0 = time.monotonic()
    eng.submit([1, 2, 3], max_tokens=200, temperature=0.0).result(timeout=120)
    warm_s = time.monotonic() - t0
    before = eng.reclaimed_slots
    fut = eng.submit([1, 2, 3], max_tokens=200, temperature=0.0, deadline_s=max(0.02, warm_s / 4))
    with pytest.raises(DeadlineExceeded):
        fut.result(timeout=120)
    deadline = time.monotonic() + 10
    while eng.num_active > 0 and time.monotonic() < deadline:
        time.sleep(0.005)
    assert eng.num_active == 0
    assert eng.reclaimed_slots == before + 1
    r = eng.submit([4, 5], max_tokens=3, temperature=0.0).result(timeout=120)
    assert len(r.token_ids) == 3
    stats = eng.tick_stats()
    assert stats["sched"]["expired_running"].get("interactive", 0) >= 1
    assert eng._kv_pool.pages_free == eng._kv_pool.n_pages


def test_engine_submit_sheds_past_bound():
    eng = _tiny_engine(max_queue=1)
    try:
        eng._running = True  # submit enqueues with no engine thread: the bound is exact
        eng.submit([1, 2], max_tokens=4)
        with pytest.raises(SchedulerRejected) as ei:
            eng.submit([1, 2], max_tokens=4)
        assert ei.value.retry_after_s > 0 and ei.value.reason == "queue_full"
    finally:
        eng._running = False
        eng.stop()
    assert eng.scheduler.queue_depth == 0  # the stranded request was drained


# ----------------------------------------------------------- HTTP integration
@pytest.fixture(scope="module")
def sched_registry():
    common = {"tiny": True, "dtype": "float32", "max_slots": 1, "max_seq_len": 128,
              "sched_admit_max_wait_s": None}
    registry = ModelRegistry.from_config(
        {"sched-chat": {**common, "sched_max_queue": 1}, "deadline-chat": common},
        device="cpu",
    )
    yield registry
    registry.stop()


def _http(registry, fn):
    async def runner():
        from aiohttp.test_utils import TestClient, TestServer

        from django_assistant_bot_tpu_torch.serving.server import create_app

        app = create_app(registry)
        app.on_cleanup.clear()  # the module fixture owns the engines
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            return await fn(client)
        finally:
            await client.close()

    return asyncio.run(runner())


def test_dialog_scheduling_fields_validated(sched_registry):
    async def body(client):
        base = {"model": "deadline-chat", "messages": [{"role": "user", "content": "x"}]}
        for extra in ({"priority": "vip"}, {"tenant": ""}, {"tenant": "x" * 200},
                      {"deadline_s": -1}, {"deadline_s": math.nan}, {"deadline_s": 7200}):
            resp = await client.post("/dialog/", json={**base, **extra})
            assert resp.status == 422, (extra, await resp.text())
        resp = await client.post(
            "/dialog/",
            json={**base, "max_tokens": 2, "priority": "background", "tenant": "ws1",
                  "deadline_s": 30},
        )
        assert resp.status == 200, await resp.text()
        resp = await client.post("/dialog/", json={**base, "max_tokens": 2},
                                 headers={"X-Priority": "background", "X-Tenant": "ws2"})
        assert resp.status == 200, await resp.text()

    _http(sched_registry, body)


def test_dialog_shed_maps_to_429_with_retry_after_and_healthz(sched_registry):
    async def body(client):
        async def one(i):
            return await client.post(
                "/dialog/",
                json={"model": "sched-chat", "messages": [{"role": "user", "content": f"q{i}"}],
                      "max_tokens": 64, "priority": "background"},
                headers={"X-Request-Id": f"burst-{i}"},
            )

        resps = await asyncio.gather(*(one(i) for i in range(10)))
        statuses = [r.status for r in resps]
        assert statuses.count(200) >= 1
        shed = [(i, r) for i, r in enumerate(resps) if r.status == 429]
        assert shed, statuses
        for i, r in shed:
            assert int(r.headers["Retry-After"]) >= 1
            data = await r.json()
            assert data["retry_after_s"] > 0 and data["reason"] == "queue_full"
            assert data["request_id"] == f"burst-{i}" == r.headers["X-Request-Id"]
        health = await (await client.get("/healthz")).json()
        g = health["generators"]["sched-chat"]
        assert g["sched"]["max_queue"] == 1
        assert sum(g["sched"]["shed"].values()) >= len(shed)
        assert {"queue_depth", "wait"} <= set(g["sched"])
        assert g["ticks"] > 0 and g["decode_steps_effective"] == 8
        assert g["prefill_displacement_frac"] == 0.0

    _http(sched_registry, body)


def test_dialog_expired_deadline_maps_to_504(sched_registry):
    async def body(client):
        resp = await client.post(
            "/dialog/",
            json={"model": "deadline-chat", "messages": [{"role": "user", "content": "x"}],
                  "max_tokens": 100, "deadline_s": 0.001},
        )
        assert resp.status == 504, await resp.text()
        data = await resp.json()
        assert "deadline" in data["detail"] and data["request_id"]

    _http(sched_registry, body)
