"""Crash-only supervision and the observability plane: the port against the
JAX package (CPU, tiny geometry, weights bridged through
``convert.params_from_jax``).

- The contracts of tests/test_serving.py:95-181 on both engines: a first
  decode tick that raises leaves a token-less request to be resubmitted (5
  tokens, one restart, one resubmission); a wave whose first prefill group
  raises salvages every unstarted request.
- The engine cases of tests/test_faults.py, each run on the JAX engine and
  the port's with the same fault schedule: inert without faults; a
  ``tick_raise`` mid-trace keeps queued work (ids equal to the unfaulted
  run's and across the engines); the paged pool and prefix registry rebuilt;
  ``nan_logits`` quarantines one slot; ``detok_raise`` fails one request; a
  persistent fault trips the circuit (``EngineUnavailable``), which
  half-opens after the cooldown; ``/healthz`` degraded and 503.
- Realized waits reach the scheduler (ROADMAP Queue 3 entry 5): the engine
  binds ``obs.queue_wait_s``, and the port's scheduler and the JAX one give
  the same admissions, sheds and ``Retry-After`` with a bound histogram.
- ``/metrics`` parsed with the port's copy of the parser, which agrees with
  the JAX parser on the same exposition.
"""

import asyncio
import time
from concurrent.futures import Future

import numpy as np
import pytest

import jax

from django_assistant_bot_tpu.models import DecoderConfig as JaxDecoderConfig
from django_assistant_bot_tpu.models import llama as jllama
from django_assistant_bot_tpu.serving import ByteTokenizer as JaxByteTokenizer
from django_assistant_bot_tpu.serving import GenerationEngine as JaxGenerationEngine
from django_assistant_bot_tpu.serving import engine as jax_engine_mod
from django_assistant_bot_tpu.serving import faults as jax_faults
from django_assistant_bot_tpu.serving import obs as jax_obs
from django_assistant_bot_tpu.serving import scheduler as jax_sched
from django_assistant_bot_tpu_torch.convert import params_from_jax
from django_assistant_bot_tpu_torch.models import DecoderConfig, llama
from django_assistant_bot_tpu_torch.serving import ByteTokenizer, GenerationEngine, ModelSpec
from django_assistant_bot_tpu_torch.serving import engine as port_engine_mod
from django_assistant_bot_tpu_torch.serving import faults as port_faults
from django_assistant_bot_tpu_torch.serving import obs as port_obs
from django_assistant_bot_tpu_torch.serving import scheduler as port_sched

KINDS = ["jax", "torch"]
FAULTS = {"jax": jax_faults, "torch": port_faults}
ENGINE_MODS = {"jax": jax_engine_mod, "torch": port_engine_mod}


@pytest.fixture(autouse=True)
def flight_dir(tmp_path, monkeypatch):
    """Flight-recorder dumps of restarts and quarantines go to the test's
    own directory."""
    monkeypatch.setenv("DABT_FLIGHT_DIR", str(tmp_path))


@pytest.fixture(scope="module")
def models():
    jcfg = JaxDecoderConfig.tiny()
    jparams = jllama.init(jcfg, jax.random.key(1))
    cfg = DecoderConfig.tiny()
    return jcfg, jparams, cfg, params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")


def _engine(kind, models, **kw):
    jcfg, jparams, cfg, params = models
    kw.setdefault("max_slots", 2)
    kw.setdefault("max_seq_len", 64)
    if kind == "jax":
        return JaxGenerationEngine(jcfg, jparams, JaxByteTokenizer(), **kw)
    return GenerationEngine(cfg, params, ByteTokenizer(), device="cpu", **kw)


def _crank(eng, futs, limit=3000):
    """The loop body single-threaded: an iteration, and on an error the
    crash-only restart the loop would run."""
    for _ in range(limit):
        if all(f.done() for f in futs):
            return
        try:
            eng._loop_iteration()
        except Exception as e:
            with eng._iter_lock:
                eng._restart(e)
    raise AssertionError("requests did not finish within the crank budget")


def _fail_first_call(obj, attr):
    """Make ``obj.attr`` raise on its first call only."""
    orig = getattr(obj, attr)
    state = {"armed": True}

    def boom(*args, **kwargs):
        if state.pop("armed", False):
            raise RuntimeError("injected device failure")
        return orig(*args, **kwargs)

    setattr(obj, attr, boom)


# ---------------------------------------------- tests/test_serving.py:95-181
@pytest.mark.parametrize("kind", KINDS)
def test_first_tick_raise_resubmits_token_less_request(models, kind):
    eng = _engine(kind, models).start()
    try:
        # the JAX engine's tick program, the port's tick launch (the CUDA
        # graph's replay on the card): the fault fires before any token
        # reached the host, so the request is salvageable
        _fail_first_call(eng, "_decode_tick" if kind == "jax" else "_launch_tick")
        res = eng.submit([1, 2, 3], max_tokens=5, temperature=0.0).result(timeout=120)
        assert len(res.token_ids) == 5
        assert eng.engine_restarts == 1
        assert eng.supervision_stats()["restarted_requests_resubmitted"] == 1
        res = eng.submit([1, 2, 3], max_tokens=5, temperature=0.0).result(timeout=120)
        assert len(res.token_ids) == 5
        assert eng.engine_restarts == 1
    finally:
        eng.stop()


@pytest.mark.parametrize("kind", KINDS)
def test_wave_prefill_failure_salvages_every_unstarted_group(models, kind, monkeypatch):
    """A wave split into two seq-bucket groups (32 and 64): the first group's
    prefill raises, and both futures still complete after one restart."""
    mod = ENGINE_MODS[kind]
    eng = _engine(kind, models, max_slots=4, max_seq_len=96,
                  **({"prefill_buckets": (32, 64)} if kind == "jax" else {}))
    futs = [Future(), Future()]
    for ids, fut in (([1, 2, 3], futs[0]), (list(range(1, 41)), futs[1])):
        eng._queue.put(mod._Request(prompt_ids=ids, max_tokens=4, temperature=0.0, top_p=0.95,
                                    future=fut, submitted_at=time.monotonic()))
    if kind == "jax":
        _fail_first_call(eng, "_prefill")
    else:
        monkeypatch.setattr(llama, "prefill", llama.prefill)  # restored at teardown
        _fail_first_call(llama, "prefill")
    eng.start()
    try:
        assert [len(f.result(timeout=120).token_ids) for f in futs] == [4, 4]
        assert eng.engine_restarts == 1
        assert len(eng.submit([1, 2, 3], max_tokens=4, temperature=0.0)
                   .result(timeout=120).token_ids) == 4
    finally:
        eng.stop()


# ------------------------------------------- tests/test_faults.py, engines
@pytest.mark.parametrize("kind", KINDS)
def test_engine_inert_without_faults(models, kind, monkeypatch):
    def trip(self, site, key=""):
        raise AssertionError(f"injector consulted on a fault-free engine: {site}")

    monkeypatch.setattr(FAULTS[kind].FaultInjector, "should_fire", trip)
    eng = _engine(kind, models).start()
    try:
        assert eng._faults is None
        r = eng.submit([1, 2, 3], max_tokens=5, temperature=0.0).result(timeout=120)
        assert len(r.token_ids) == 5
        assert eng.poisoned_requests == 0 and eng.engine_restarts == 0
    finally:
        eng.stop()


def _queued_trace(kind, models, arm):
    """Three requests on one slot, a ``tick_raise`` armed before the first
    tick: the in-flight token-less request is resubmitted, the queued two
    ride through untouched."""
    inj = FAULTS[kind].FaultInjector({})
    eng = _engine(kind, models, max_slots=1, faults=inj)
    eng._running = True
    if arm:
        inj.arm("tick_raise")
    futs = [eng.submit([1, 2, 3 + i], max_tokens=5, temperature=0.0) for i in range(3)]
    _crank(eng, futs)
    return [f.result(timeout=0).token_ids for f in futs], eng.supervision_stats()


def test_tick_raise_mid_trace_recovers_without_failing_queued(models):
    ids = {}
    for kind in KINDS:
        ids[kind], sup = _queued_trace(kind, models, arm=True)
        assert all(len(t) == 5 for t in ids[kind])
        assert sup["engine_restarts"] == 1
        assert sup["restarted_requests_resubmitted"] == 1
        assert sup["restarted_requests_failed"] == 0
    clean, sup = _queued_trace("torch", models, arm=False)
    assert ids["torch"] == ids["jax"] == clean and sup["engine_restarts"] == 0


@pytest.mark.parametrize("kind", KINDS)
def test_tick_raise_restart_rebuilds_paged_pool_and_keeps_serving(models, kind):
    """A ``tick_raise`` while pages are allocated and a prefix is registered:
    the restart resets the allocator, salvaged work replays onto fresh pages,
    and post-restart traffic registers and shares the prefix again."""
    inj = FAULTS[kind].FaultInjector({})
    eng = _engine(kind, models, faults=inj, prefix_cache_size=4, prefix_min_tokens=8)
    eng._running = True
    prefix = list(range(1, 13))
    f = eng.submit(prefix + [20], max_tokens=3, temperature=0.0, prefix_len=len(prefix))
    _crank(eng, [f])
    assert eng.kv_stats()["kv_shared_pages"] > 0
    inj.arm("tick_raise")
    futs = [eng.submit(prefix + [30 + i], max_tokens=4, temperature=0.0, prefix_len=len(prefix))
            for i in range(3)]
    _crank(eng, futs)
    assert all(len(f.result(timeout=0).token_ids) == 4 for f in futs)
    assert eng.engine_restarts == 1
    st = eng.kv_stats()
    assert st["kv_pages_used"] == st["kv_shared_pages"] > 0
    assert st["prefix_hits"] >= 1


@pytest.mark.parametrize("kind", KINDS)
def test_nan_logits_quarantines_one_slot_keeps_batch_alive(models, kind):
    inj = FAULTS[kind].FaultInjector({})
    eng = _engine(kind, models, faults=inj)
    eng._running = True
    futs = [eng.submit([1, 2, 3], max_tokens=48, temperature=0.0),
            eng.submit([4, 5, 6], max_tokens=48, temperature=0.0)]
    while eng.num_active < 2:
        eng._loop_iteration()
    inj.arm("nan_logits")
    _crank(eng, futs)
    outcomes = []
    for f in futs:
        exc = f.exception(timeout=0)
        outcomes.append(("ok", f.result(timeout=0)) if exc is None else ("poisoned", exc))
    assert sorted(k for k, _ in outcomes) == ["ok", "poisoned"]
    assert isinstance(next(e for k, e in outcomes if k == "poisoned"),
                      ENGINE_MODS[kind].RequestPoisoned)
    assert len(next(r for k, r in outcomes if k == "ok").token_ids) == 48
    assert eng.poisoned_requests == 1 and eng.engine_restarts == 0
    assert eng._kv_pool.pages_free == eng._kv_pool.n_pages


@pytest.mark.parametrize("kind", KINDS)
def test_detok_raise_quarantines_request_engine_keeps_serving(models, kind):
    inj = FAULTS[kind].FaultInjector({})
    eng = _engine(kind, models, faults=inj)
    eng._running = True
    inj.arm("detok_raise")
    fut = eng.submit([1, 2, 3], max_tokens=4, temperature=0.0)
    _crank(eng, [fut])
    with pytest.raises(FAULTS[kind].FaultInjected, match="detok_raise"):
        fut.result(timeout=0)
    assert eng.poisoned_requests == 1
    fut = eng.submit([1, 2, 3], max_tokens=4, temperature=0.0)
    _crank(eng, [fut])
    assert len(fut.result(timeout=0).token_ids) == 4


@pytest.mark.parametrize("kind", KINDS)
def test_persistent_fault_trips_circuit_submit_fast_fails(models, kind):
    inj = FAULTS[kind].FaultInjector({"tick_raise": {"every": 1}})  # every tick dies
    eng = _engine(kind, models, faults=inj, max_slots=1, max_restarts=2, restart_window_s=60.0,
                  restart_backoff_s=0.005, restart_backoff_max_s=0.02,
                  degraded_cooldown_s=600.0, max_request_restarts=1).start()
    try:
        fut = eng.submit([1, 2, 3], max_tokens=4, temperature=0.0)
        deadline = time.monotonic() + 60
        while not eng.degraded() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert eng.degraded() and eng.circuit_trips == 1
        with pytest.raises(FAULTS[kind].FaultInjected):
            fut.result(timeout=120)  # exhausted its max_request_restarts
        with pytest.raises(ENGINE_MODS[kind].EngineUnavailable) as ei:
            eng.submit([4, 5], max_tokens=2)
        assert ei.value.retry_after_s > 0
        assert eng.supervision_stats()["healthy"] is False
    finally:
        eng.stop()


@pytest.mark.parametrize("kind", KINDS)
def test_circuit_half_open_recovers_after_cooldown(models, kind):
    inj = FAULTS[kind].FaultInjector({"tick_raise": {"every": 1, "max_fires": 3}})
    eng = _engine(kind, models, faults=inj, max_slots=1, max_restarts=2,
                  restart_backoff_s=0.005, restart_backoff_max_s=0.02,
                  degraded_cooldown_s=0.2, max_request_restarts=0).start()
    errors = (ENGINE_MODS[kind].EngineUnavailable, FAULTS[kind].FaultInjected)
    try:
        with pytest.raises(FAULTS[kind].FaultInjected):
            eng.submit([1, 2, 3], max_tokens=4, temperature=0.0).result(timeout=120)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            try:
                r = eng.submit([1, 2, 3], max_tokens=4, temperature=0.0).result(timeout=120)
                break
            except errors:
                time.sleep(0.05)
        else:
            pytest.fail("engine never recovered after the fault stopped")
        assert len(r.token_ids) == 4 and not eng.degraded()
    finally:
        eng.stop()


def test_recovery_failure_declares_the_engine_dead(models):
    """A restart whose own rebuild raises (on the card: a sticky device
    error surfacing at the synchronise) ends the loop instead of spinning:
    queued work fails, later submits fail fast."""
    eng = _engine("torch", models)

    def broken():
        raise RuntimeError("device lost")

    eng._reset_device_state = broken
    _fail_first_call(eng, "_launch_tick")
    eng.start()
    fut = eng.submit([1, 2, 3], max_tokens=4, temperature=0.0)
    with pytest.raises(RuntimeError):
        fut.result(timeout=60)
    eng._thread.join(timeout=30)
    assert not eng._running and not eng.supervision_stats()["healthy"]
    with pytest.raises(RuntimeError, match="stopped"):
        eng.submit([1, 2, 3], max_tokens=2).result(timeout=10)
    eng.stop()


# ----------------------------------------------- realized waits, scheduler
class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


class _Req:
    def __init__(self, n, clock):
        self.future, self.submitted_at = Future(), clock.t
        self.priority, self.tenant, self.deadline_at = "interactive", "default", None
        self.admitted, self.kv_pages, self.rid = True, 0, n


def _hist_scenario(sched_mod, obs_mod):
    """Admissions against a 2 s estimated-wait ceiling with 4 slots: the EMA
    model alone admits; once 32 realized waits of 3 s are in the bound
    histogram, its p95 floors the estimate and the request sheds with that
    estimate as Retry-After; a drained queue admits again."""
    clock = _Clock()
    s = sched_mod.RequestScheduler(sched_mod.SchedulerConfig(admit_max_wait_s=2.0), slots=4,
                                   clock=clock)
    hist = obs_mod.Histogram(obs_mod.WAIT_BUCKETS)
    s.bind_wait_hist(hist)
    trace = []

    def admit():
        adm = s.try_admit("interactive", None)
        trace.append((adm.ok, adm.reason, round(adm.retry_after_s, 9)))
        if adm.ok:
            s.enqueue(_Req(len(trace), clock))

    for _ in range(3):
        admit()
    for _ in range(31):
        hist.observe(3.0)
    admit()  # cold: 31 samples
    hist.observe(3.0)
    admit()  # warm: the p95 of realized waits
    clock.t += 5.0
    while s.pop(clock.t) is not None:
        pass
    admit()  # empty queue: no wait to predict
    st = s.stats()
    trace.append((st["shed"], st["wait_hist_q_s"], st["queue_depth"]))
    return trace


def test_scheduler_with_bound_wait_histogram_matches_jax():
    want = _hist_scenario(jax_sched, jax_obs)
    got = _hist_scenario(port_sched, port_obs)
    assert got == want
    assert [t[:2] for t in got[3:6]] == [(True, ""), (False, "estimated_wait"), (True, "")]
    assert got[4][2] > 2.0  # Retry-After = the histogram's p95 wait


@pytest.mark.parametrize("obs", [True, False])
def test_engine_binds_queue_wait_histogram(models, obs):
    """With ``obs`` on (the spec default) the engine binds its queue-wait
    histogram to the scheduler, as the JAX engine does, and finished
    requests feed it; off, neither side binds one."""
    jeng = _engine("jax", models, scheduler=jax_sched.RequestScheduler(), obs=obs)
    teng = _engine("torch", models, scheduler=port_sched.RequestScheduler(), obs=obs)
    for eng in (jeng, teng):
        bound = eng.scheduler._wait_hist
        assert (bound is eng.obs.queue_wait_s) if obs else (bound is None and eng.obs is None)
    teng._running = True
    futs = [teng.submit([1, 2, 3 + i], max_tokens=3, temperature=0.0) for i in range(3)]
    _crank(teng, futs)
    if obs:
        assert teng.obs.queue_wait_s.count == 3 and teng.obs.ttft_s.count == 3
        assert [t["trace_id"] for t in teng.obs.traces()] and teng.obs.traces_total == 3


def test_spec_supervision_and_obs_defaults_equal_jax():
    from django_assistant_bot_tpu.serving.registry import ModelSpec as JaxModelSpec

    keys = ("obs", "obs_dump_dir", "faults", "fault_seed", "max_restarts", "restart_window_s",
            "restart_backoff_s", "restart_backoff_max_s", "degraded_cooldown_s",
            "heartbeat_degraded_s", "max_request_restarts", "prefix_cache",
            "prefix_min_tokens", "prefix_cache_max_bytes")
    jspec = JaxModelSpec(name="m", kind="decoder")
    spec = ModelSpec.from_dict("m", {"tiny": True, **{k: getattr(jspec, k) for k in keys}})
    assert {k: getattr(spec, k) for k in keys} == {k: getattr(jspec, k) for k in keys}
    assert {k: getattr(ModelSpec(name="m"), k) for k in keys} == {k: getattr(jspec, k)
                                                                  for k in keys}
    kw = ModelSpec(name="m", faults={"tick_raise": {"fire_on": [2]}}, fault_seed=3).engine_kwargs()
    assert isinstance(kw["faults"], port_faults.FaultInjector) and kw["faults"].seed == 3
    assert ModelSpec(name="m", faults={}).build_faults() is None
    assert kw["obs"] is True and kw["max_restarts"] == 5 and kw["prefix_cache_size"] == 8


# ------------------------------------------------------------------- HTTP
def test_parser_copy_matches_jax_parser():
    def render(mod):
        h = mod.Histogram((0.5, 2.0))
        h.observe(0.1)
        h.observe(1.0)
        x = mod._Exposition()
        x.add("t_total", "counter", "a counter", 7, {"model": "m"})
        x.add("g", "gauge", 'label with "quotes" and \\', 1.5, {"k": 'v"w\\x'})
        x.add_histogram("lat_seconds", "a histogram", h, {"model": "m"})
        return x.render()

    text = render(port_obs)
    assert text == render(jax_obs)
    fams = port_obs.parse_prometheus_text(text)
    assert fams == jax_obs.parse_prometheus_text(text)
    assert fams["g"]["samples"][0][1] == {"k": 'v"w\\x'}
    with pytest.raises(ValueError, match="non-cumulative"):
        port_obs.parse_prometheus_text('# TYPE h histogram\nh_bucket{le="1"} 5\n'
                                       'h_bucket{le="2"} 3\nh_bucket{le="+Inf"} 5\n'
                                       'h_sum 1\nh_count 5\n')


def test_healthz_degraded_503_and_metrics():
    from aiohttp.test_utils import TestClient, TestServer

    from django_assistant_bot_tpu_torch.serving import ModelRegistry
    from django_assistant_bot_tpu_torch.serving.server import create_app

    registry = ModelRegistry.from_config(
        {"tiny-chat": {"tiny": True, "max_slots": 2, "max_seq_len": 64}}, device="cpu")
    eng = registry.get_generator("tiny-chat")
    dialog = {"model": "tiny-chat", "messages": [{"role": "user", "content": "hi"}],
              "max_tokens": 2}

    async def go():
        client = TestClient(TestServer(create_app(registry)))
        await client.start_server()
        try:
            resp = await client.post("/dialog/", json=dialog)
            assert resp.status == 200
            data = await (await client.get("/healthz")).json()
            sup = data["generators"]["tiny-chat"]["supervision"]
            assert data["status"] == "ok" and sup["healthy"] is True
            assert "loop_heartbeat_age_s" in sup and sup["engine_restarts"] == 0

            resp = await client.get("/metrics")
            assert resp.status == 200 and resp.headers["Content-Type"].startswith("text/plain")
            fams = port_obs.parse_prometheus_text(await resp.text())
            lab = {"model": "tiny-chat", "replica": "tiny-chat"}
            assert ("dabt_engine_restarts_total", lab, 0.0) in fams[
                "dabt_engine_restarts_total"]["samples"]
            assert fams["dabt_ttft_seconds"]["type"] == "histogram"
            counts = {n: v for n, _, v in fams["dabt_queue_wait_seconds"]["samples"]
                      if n.endswith("_count")}
            assert counts == {"dabt_queue_wait_seconds_count": 1.0}
            for fam in ("dabt_kv_pages_total", "dabt_kv_cow_copies_total",
                        "dabt_sched_queue_depth", "dabt_decode_steps"):
                assert fam in fams, fam

            eng._degraded_until = time.monotonic() + 30.0  # trip the circuit
            resp = await client.post("/dialog/", json=dialog)
            assert resp.status == 503 and int(resp.headers["Retry-After"]) >= 1
            assert "degraded" in (await resp.json())["detail"]
            data = await (await client.get("/healthz")).json()
            assert data["status"] == "degraded"
            assert data["generators"]["tiny-chat"]["supervision"]["degraded"] is True
            eng._degraded_until = None
            eng.heartbeat_degraded_s = 1e-9  # a wedged loop's stale heartbeat
            assert (await (await client.get("/healthz")).json())["status"] == "degraded"
            eng.heartbeat_degraded_s = 30.0
        finally:
            await client.close()

    try:
        asyncio.new_event_loop().run_until_complete(go())
    finally:
        registry.stop()
