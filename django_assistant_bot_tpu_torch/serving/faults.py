"""Deterministic, seeded fault injection for the serving plane (the port's copy
of the JAX package's ``serving/faults.py``, which imports no JAX; the port keeps
its own copy and imports nothing of that package).  The port's engine consults
``ENGINE_SITES`` and its storage plane ``STORAGE_SITES``; the other sites wait
for the planes that consult them.

Crash-only design (Candea & Fox) and chaos-engineering practice agree on one
point: recovery paths that are never exercised don't work.  This module is the
exerciser — a zero-overhead-when-off injection plane with *named sites* wired
into the engine loop and the HTTP provider client, driven either by exact
fire-on-Nth-call schedules (tests are exact, not flaky) or by a seeded
probability stream (same seed → same fire pattern, across processes).

Sites (the full set — unknown names are a config error, not a silent no-op):

================  ============================================================
``tick_raise``    the device decode/prefill dispatch raises (XLA error, TPU
                  preemption, OOM) — exercised at the top of the engine's
                  ``_issue_tick``; classified *engine-fatal* → crash-only
                  restart (see ``GenerationEngine._restart``)
``nan_logits``    a tick's sampled ids come back garbage (what a NaN'd logits
                  row yields after top-k/softmax) — the engine's host-side id
                  validation catches it and *quarantines* only the poisoned
                  slot, keeping its batch-mates alive
``detok_raise``   final detokenization raises — request-poison: fail that one
                  request, the engine keeps serving
``slow_tick``     latency injection: the engine loop sleeps ``delay_s`` before
                  a tick (heartbeat-age / wedged-loop detection evidence)
``timeout``       HTTP client: the request times out before a response
``conn_reset``    HTTP client: the connection drops mid-request
``http_5xx``      HTTP client: the server answers 503
``replica_dead``  router (serving/router.py): the replica the dispatcher is
                  about to pick dies abruptly — its engine loop exits and
                  fails in-flight work, exercising breaker trip + token-less
                  re-route (the fleet-level analogue of ``tick_raise``)
``replica_slow``  router: the dispatch hop to a replica stalls ``delay_s``
                  (slow replica admission / network hop evidence)
``task_raise``    task plane (tasks/queue.py): the task body raises before
                  doing any work — transient, exercises the retry/backoff/DLQ
                  ladder
``task_worker_lost``  task plane: the executing worker "dies" — consulted
                  before the body and after each delivered answer part
                  (bot/tasks.py), the row is left RUNNING with its lease, and
                  lease expiry + reclaim own the re-delivery (the exactly-once
                  ledger's chaos case)
``platform_http_429``  bot delivery: the platform answers flood control —
                  raised as ``RetryLater(delay_s)`` so the queue honors the
                  platform's pacing
``platform_http_5xx``  bot delivery: the platform answers a transient 5xx-
                  shaped connection error — exercises delivery re-raise +
                  queue retry
``net_drop``      fleet wire (serving/fleet.py PeerClient): the connection
                  drops AFTER the request was sent but before the response is
                  read — the server may have executed it, so this is the
                  idempotent-dispatch chaos case (timeout-retry must not
                  double-execute)
``net_delay``     fleet wire: the link stalls ``delay_s`` before the request
                  goes out (slow-link evidence for the connect/read timeout
                  split)
``net_corrupt``   fleet wire: one byte of a KV payload (octet-stream request
                  body, or octet-stream response body) is flipped in flight —
                  the CRC32C integrity check must reject it
``net_partition`` fleet wire: the peer is unreachable at connect time (both
                  sides alive, the link is down) — usually driven by a
                  ``start_after_s``/``duration_s`` window so the bench gets a
                  partition AND a heal
``net_blackhole`` fleet wire: the SYN black-holes (connect times out, nothing
                  answers) — distinct from ``net_partition`` only in detail
                  text; exercises the fast connect-timeout path
``disk_write_fail``  durability plane (storage/durable.py): a WAL append or
                  snapshot write fails up front (ENOSPC, EIO) — the mutation
                  must be rejected whole, never half-applied
``disk_torn_write``  durability plane: a WAL record write is cut mid-record
                  (power loss between write and fsync) — the file keeps a
                  torn tail that recovery must truncate, not trust
``snapshot_corrupt``  durability plane: one byte of a just-written snapshot
                  artifact flips (bit rot, partial page) — the manifest
                  digest walk must reject the snapshot and fall back to the
                  previous valid one
================  ============================================================

Each site's spec is either a bare float (fire probability) or a mapping with
any of: ``p`` (probability), ``fire_on`` (exact 1-based call indices),
``every`` (fire every Nth call), ``max_fires`` (stop after N fires),
``delay_s`` (sleep length for latency sites), ``start_after_s``/``duration_s``
(a clock window measured from the site's first consult — the partition/heal
schedule shape; fires for the whole window, composes with the other triggers,
and ignores ``max_fires`` so a window is never cut short by earlier fires),
and ``edges`` (restrict a site to specific consult keys — see below).
Schedules compose: a call fires if it matches ``fire_on`` OR ``every`` OR the
window OR the probability draw, until ``max_fires`` is exhausted.

Network sites are consulted **per edge**: ``should_fire(site, key=edge)``
where the edge is the caller's ``"{self}->{peer}"`` string.  Each (site, key)
pair keeps its own schedule state and its own RNG seeded
``f"{seed}:{site}:{key}"`` — the same seed reproduces the same per-edge
partition schedule across processes regardless of how edges interleave, which
is what makes a two-process chaos bench replayable.  A spec's ``edges`` list
scopes the site to those keys only (other edges never fire).

Gating: engines take an injector from ``ModelSpec.faults`` (explicit) or from
the ``DABT_FAULTS`` env var (JSON, with ``DABT_FAULT_SEED``).  With neither
set, the engine holds ``None`` and the hot path pays a single ``is None``
check (tests/test_torch_supervision.py asserts no injector method is entered
on a fault-free engine).  The storage plane (``storage/durable.py``)
consults the process-global injector (:func:`global_injector`, loaded once
from the environment; tests set and reset it).  The JAX package's
HTTP-client helper (``raise_http_fault``) waits for the provider client it
serves.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import threading
import time
from typing import Any, Callable, Dict, Mapping, Optional

ENGINE_SITES = ("tick_raise", "nan_logits", "detok_raise", "slow_tick")
HTTP_SITES = ("timeout", "conn_reset", "http_5xx")
# consulted by the multi-replica EngineRouter (serving/router.py), never by an
# engine: one spec can drive engine-, HTTP- and router-level chaos together
ROUTER_SITES = ("replica_dead", "replica_slow")
# consulted by the task plane (tasks/queue.py Worker.execute + bot/tasks.py
# delivery) via the lazy global-injector discipline — no engine involved
TASK_SITES = ("task_raise", "task_worker_lost", "platform_http_429", "platform_http_5xx")
# consulted by the fleet-wire PeerClient (serving/fleet.py) per edge — every
# consult carries a ``key`` ("router->peer" string) with its own seeded state
NET_SITES = ("net_drop", "net_delay", "net_corrupt", "net_partition", "net_blackhole")
# consulted by the retrieval durability plane (storage/durable.py) around WAL
# appends and snapshot writes, via the same lazy global-injector discipline as
# the task plane — the storage package never imports this module eagerly
STORAGE_SITES = ("disk_write_fail", "disk_torn_write", "snapshot_corrupt")
ALL_SITES = ENGINE_SITES + HTTP_SITES + ROUTER_SITES + TASK_SITES + NET_SITES + STORAGE_SITES

ENV_FAULTS = "DABT_FAULTS"
ENV_SEED = "DABT_FAULT_SEED"


class FaultInjected(RuntimeError):
    """An injected fault fired.  ``site`` names the injection point."""

    def __init__(self, site: str, detail: str = ""):
        super().__init__(f"injected fault: {site}" + (f" ({detail})" if detail else ""))
        self.site = site


@dataclasses.dataclass
class _Site:
    name: str
    probability: float = 0.0
    fire_on: frozenset = frozenset()
    every: int = 0
    max_fires: int = 0  # 0 = unlimited
    delay_s: float = 0.05
    # clock window measured from the site's first consult: fires while
    # start_after_s <= elapsed < start_after_s + duration_s (negative = off)
    start_after_s: float = -1.0
    duration_s: float = 0.0
    # consult keys (edges) this site is scoped to; empty = all
    edges: frozenset = frozenset()
    calls: int = 0
    fires: int = 0
    armed: int = 0  # fire unconditionally on the next N calls (tests)
    first_consult: Optional[float] = None
    last_fire_monotonic: Optional[float] = None


def _parse_site(name: str, spec: Any) -> _Site:
    if isinstance(spec, bool):
        raise ValueError(f"fault site {name!r}: spec must be a probability or mapping")
    if isinstance(spec, (int, float)):
        spec = {"p": float(spec)}
    if not isinstance(spec, Mapping):
        raise ValueError(f"fault site {name!r}: unparseable spec {spec!r}")
    unknown = set(spec) - {
        "p", "probability", "fire_on", "every", "max_fires", "delay_s",
        "start_after_s", "duration_s", "edges",
    }
    if unknown:
        raise ValueError(f"fault site {name!r}: unknown keys {sorted(unknown)}")
    p = float(spec.get("p", spec.get("probability", 0.0)))
    if not (0.0 <= p <= 1.0):
        raise ValueError(f"fault site {name!r}: probability {p} outside [0, 1]")
    fire_on = frozenset(int(n) for n in spec.get("fire_on", ()))
    if any(n < 1 for n in fire_on):
        raise ValueError(f"fault site {name!r}: fire_on indices are 1-based")
    start_after_s = float(spec.get("start_after_s", -1.0))
    duration_s = max(0.0, float(spec.get("duration_s", 0.0)))
    if start_after_s >= 0.0 and duration_s <= 0.0:
        raise ValueError(f"fault site {name!r}: start_after_s needs duration_s > 0")
    edges = spec.get("edges", ())
    if isinstance(edges, str) or not all(isinstance(e, str) for e in edges):
        raise ValueError(f"fault site {name!r}: edges must be a list of key strings")
    return _Site(
        name=name,
        probability=p,
        fire_on=fire_on,
        every=max(0, int(spec.get("every", 0))),
        max_fires=max(0, int(spec.get("max_fires", 0))),
        delay_s=max(0.0, float(spec.get("delay_s", 0.05))),
        start_after_s=start_after_s,
        duration_s=duration_s,
        edges=frozenset(edges),
    )


class FaultInjector:
    """Deterministic fire-pattern generator over named sites.

    Thread-safe: sites are consulted from the engine thread and asyncio
    threads concurrently.  Each site draws from its own ``random.Random``
    seeded by ``(seed, site name)`` so one site's call pattern can never
    perturb another's — and the same seed reproduces the same pattern
    regardless of how sites interleave.
    """

    def __init__(
        self,
        spec: Mapping[str, Any],
        *,
        seed: int = 0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.seed = int(seed)
        self._clock = clock
        self._lock = threading.Lock()
        self._sites: Dict[str, _Site] = {}
        self._rngs: Dict[str, random.Random] = {}
        # per-(site, key) substates for edge-scoped consults: each edge clones
        # the base spec lazily and draws from its own str-seeded RNG, so one
        # edge's consult pattern can never perturb another's schedule
        self._subs: Dict[tuple, _Site] = {}
        self._sub_rngs: Dict[tuple, random.Random] = {}
        for name, site_spec in (spec or {}).items():
            if name not in ALL_SITES:
                raise ValueError(
                    f"unknown fault site {name!r}; expected one of {list(ALL_SITES)}"
                )
            self._sites[name] = _parse_site(name, site_spec)
            # str seeding is stable across processes (hashed via sha512, not
            # the per-process-salted hash()) — determinism is the contract
            self._rngs[name] = random.Random(f"{self.seed}:{name}")

    @classmethod
    def from_spec(
        cls, spec: Optional[Mapping[str, Any]], *, seed: int = 0
    ) -> Optional["FaultInjector"]:
        """None/empty spec → None: callers hold no injector at all, so the
        disabled path is a bare ``is None`` check."""
        if not spec:
            return None
        return cls(spec, seed=seed)

    @classmethod
    def from_env(cls, *, seed_offset: int = 0) -> Optional["FaultInjector"]:
        """Env-gated injector (DABT_FAULTS / DABT_FAULT_SEED).  ``seed_offset``
        shifts the seed per consumer — engine replicas use their index so
        probabilistic sites fire different (still deterministic) patterns per
        replica instead of N copies of one pattern failing in lockstep."""
        raw = os.environ.get(ENV_FAULTS, "").strip()
        if not raw:
            return None
        seed = int(os.environ.get(ENV_SEED, "0") or "0")
        return cls(json.loads(raw), seed=seed + int(seed_offset))

    # ------------------------------------------------------------------ sites
    def enabled(self, site: str) -> bool:
        return site in self._sites

    def arm(self, site: str, n: int = 1, *, key: str = "") -> None:
        """Fire unconditionally on the next ``n`` calls of ``site`` (tests:
        exact one-shot faults without counting call indices).  Arming a site
        absent from the spec registers it.  ``key`` arms one edge's substate
        only (other edges keep their own schedules)."""
        with self._lock:
            s = self._sites.get(site)
            if s is None:
                if site not in ALL_SITES:
                    raise ValueError(f"unknown fault site {site!r}")
                s = self._sites[site] = _Site(name=site)
                self._rngs[site] = random.Random(f"{self.seed}:{site}")
            if key:
                s = self._state(site, key)
            s.armed += int(n)

    def _state(self, site: str, key: str) -> _Site:
        """The (site, key) substate, lazily cloned from the base spec with
        fresh counters and its own cross-process-stable RNG.  Caller holds
        ``self._lock``; the base site must exist."""
        sub = self._subs.get((site, key))
        if sub is None:
            sub = dataclasses.replace(
                self._sites[site],
                calls=0, fires=0, armed=0,
                first_consult=None, last_fire_monotonic=None,
            )
            self._subs[(site, key)] = sub
            self._sub_rngs[(site, key)] = random.Random(f"{self.seed}:{site}:{key}")
        return sub

    def should_fire(self, site: str, key: str = "") -> bool:
        """Consult (and advance) a site's schedule.  Unconfigured sites never
        fire and keep no state.  ``key`` selects a per-edge substate (network
        sites) — each edge advances independently and deterministically."""
        with self._lock:
            base = self._sites.get(site)
            if base is None:
                return False
            if base.edges and key not in base.edges:
                return False
            s = self._state(site, key) if key else base
            rng = self._sub_rngs[(site, key)] if key else self._rngs[site]
            now = self._clock()
            if s.first_consult is None:
                s.first_consult = now
            s.calls += 1
            in_window = (
                s.start_after_s >= 0.0
                and s.start_after_s <= (now - s.first_consult) < s.start_after_s + s.duration_s
            )
            fire = False
            if in_window:
                # windows model link state (partitions), not discrete events —
                # they hold for the full duration regardless of max_fires
                fire = True
            elif s.max_fires and s.fires >= s.max_fires:
                return False
            elif s.armed > 0:
                s.armed -= 1
                fire = True
            elif s.calls in s.fire_on:
                fire = True
            elif s.every and s.calls % s.every == 0:
                fire = True
            elif s.probability and rng.random() < s.probability:
                fire = True
            if fire:
                s.fires += 1
                s.last_fire_monotonic = now
            return fire

    def maybe_raise(self, site: str, detail: str = "", *, key: str = "") -> None:
        if self.should_fire(site, key):
            raise FaultInjected(site, detail)

    def sleep_s(self, site: str, key: str = "") -> float:
        """Latency sites: the injected delay for this call (0.0 = no fire)."""
        if self.should_fire(site, key):
            with self._lock:
                s = self._subs[(site, key)] if key else self._sites[site]
                return s.delay_s
        return 0.0

    def stats(self) -> Dict[str, Dict[str, int]]:
        """Per-site call/fire counts; edge substates appear as ``site[key]``
        rows beside the base site (the chaos bench's injected-vs-rejected
        accounting reads the edge rows)."""
        with self._lock:
            out = {
                name: {"calls": s.calls, "fires": s.fires}
                for name, s in self._sites.items()
            }
            for (site, key), s in self._subs.items():
                out[f"{site}[{key}]"] = {"calls": s.calls, "fires": s.fires}
            return out


# Process-global injector for call sites without a per-engine spec (the
# storage plane).  Loaded once from the environment; tests override via
# set_global_injector and MUST reset in teardown.
_global: Optional[FaultInjector] = None
_global_loaded = False
_global_lock = threading.Lock()


def global_injector() -> Optional[FaultInjector]:
    global _global, _global_loaded
    if _global_loaded:
        return _global
    with _global_lock:
        if not _global_loaded:
            _global = FaultInjector.from_env()
            _global_loaded = True
    return _global


def set_global_injector(inj: Optional[FaultInjector]) -> None:
    global _global, _global_loaded
    with _global_lock:
        _global = inj
        _global_loaded = True


def reset_global_injector() -> None:
    """Forget the cached global injector (re-reads the env on next use)."""
    global _global, _global_loaded
    with _global_lock:
        _global = None
        _global_loaded = False
