"""Admission-controlled request scheduler (a copy of the JAX package's
``serving/scheduler.py``, which is host-only: the standard library and
nothing else).  The port keeps its own copy so that it imports nothing of the
JAX package; behaviour is the same, pinned by
``tests/test_torch_scheduler.py`` against the original on scripted scenarios.

The engine feeds from this scheduler instead of an unbounded FIFO: every
``/dialog/`` request passes an admission test, and a burst of background
ingestion traffic cannot starve interactive dialog turns.  The module is
engine-agnostic: it orders and admits anything exposing ``.future``,
``.submitted_at``, ``.priority``, ``.tenant`` and ``.deadline_at`` (the
engine's ``_Request`` does), so every policy is unit testable without a
device.

Policies, in one place:

- **Priority classes.**  Requests carry a class tag (``interactive`` dialog >
  ``background`` ingestion/embedding), propagated end-to-end from the provider
  layer and HTTP headers.  Classes share by *weight* (default 8:1), not strict
  priority — background work cannot be starved forever, but interactive turns
  take ~8 of every 9 free slots under contention.
- **Weighted per-tenant fair share.**  Within a class, tenants (workspaces)
  interleave by stride scheduling over virtual time: one chatty tenant cannot
  monopolize slots.  Both levels collapse into a single stride: each
  ``(class, tenant)`` queue advances its virtual *pass* by
  ``1 / (class_weight * tenant_weight)`` per admitted request and the lowest
  pass runs next — the classic deterministic approximation of weighted fair
  queueing.
- **Deadlines.**  A request may carry an absolute deadline; expired entries
  are dropped at the queue head (future fails with :class:`DeadlineExceeded`)
  and the engine reaps expired *running* slots so an expired request stops
  burning decode ticks (see ``GenerationEngine._reap_dead_slots``).
- **Overload behavior.**  The queue is bounded; past the bound — or past an
  estimated-wait ceiling derived from an EMA of observed service times —
  submission fails *synchronously* with :class:`SchedulerRejected` carrying a
  ``retry_after_s`` hint (HTTP 429 + ``Retry-After`` at the server).  Between
  "fine" and "shed" there is a degradation band: past ``degrade_at`` queue
  pressure the scheduler clamps ``max_tokens`` and asks the engine to disable
  speculative decoding (its verify forward is wasted work at low acceptance).
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable, Deque, Dict, List, Mapping, Optional, Tuple

from .obs import quantile_from_counts

INTERACTIVE = "interactive"
BACKGROUND = "background"


class SchedulerRejected(RuntimeError):
    """Load shed: the request was NOT queued.  ``retry_after_s`` is the
    client back-off hint (HTTP 429 + ``Retry-After``)."""

    def __init__(self, reason: str, retry_after_s: float):
        super().__init__(f"request shed: {reason} (retry after {retry_after_s:.1f}s)")
        self.reason = reason
        self.retry_after_s = float(retry_after_s)


class DeadlineExceeded(RuntimeError):
    """The request's deadline passed before it finished; its queue entry (or
    live decode slot) was reclaimed."""


@dataclasses.dataclass
class SchedulerConfig:
    # bound on queued-but-not-yet-slotted requests (the admission queue; live
    # decode slots are bounded separately by the engine's max_slots)
    max_queue: int = 256
    # class name -> weight; unknown classes get weight 1.  Weighted share,
    # not strict priority: background drains at weight/(sum) under contention.
    class_weights: Mapping[str, float] = dataclasses.field(
        default_factory=lambda: {INTERACTIVE: 8.0, BACKGROUND: 1.0}
    )
    # tenant name -> weight within its class (unlisted tenants get 1.0)
    tenant_weights: Mapping[str, float] = dataclasses.field(default_factory=dict)
    # estimated-wait admission ceiling: shed when the queue's estimated wait
    # exceeds this (None disables the test; the depth bound still applies)
    admit_max_wait_s: Optional[float] = 60.0
    # predictive admission (docs/AUTOSCALING.md): when the engine's queue-wait
    # histogram (obs plane) holds at least admit_hist_min_samples RECENT
    # observations, the estimated wait is the MAX of the depth*EMA/slots model
    # and this quantile of *realized* queue waits — the empirical tail the
    # point EMA cannot see (service-time variance, multi-slot effects).  The
    # histogram is bound via bind_wait_hist(); cold histograms fall back to
    # the EMA model alone.  The quantile is computed over a two-window
    # rotation of the histogram's counts (rotated every admit_hist_window
    # samples), NOT its process lifetime — an overload hours ago must not
    # inflate predictions (and 429 Retry-After hints) at today's light load.
    admit_wait_quantile: float = 0.95
    admit_hist_min_samples: int = 32
    admit_hist_window: int = 2048
    # deadline applied when the client sends none (None = no deadline)
    default_deadline_s: Optional[float] = None
    # graceful degradation band: past this fraction of max_queue, clamp
    # max_tokens and disable speculative decoding; 1.0 disables the band
    degrade_at: float = 0.75
    degrade_max_tokens: int = 256
    # per-request service-time EMA seed (seconds) for the estimated-wait test
    # before any request has finished; decays fast once real finishes arrive
    service_time_init: float = 1.0
    service_time_alpha: float = 0.2
    # wait-time sample window per class for the p50/p95 health stats
    wait_window: int = 512

    @classmethod
    def from_knobs(cls, **kw) -> "SchedulerConfig":
        """Build from flat ModelSpec-style knobs, ignoring Nones."""
        return cls(**{k: v for k, v in kw.items() if v is not None})


@dataclasses.dataclass
class Admission:
    ok: bool
    reason: str = ""
    retry_after_s: float = 0.0
    # degradation: clamp max_tokens to this when set (queue pressure band)
    clamp_max_tokens: Optional[int] = None


class RequestScheduler:
    """Two-level weighted fair queue with bounded admission.

    Thread contract: :meth:`try_admit`, :meth:`note_service`, :meth:`stats`
    and the counters are safe from any thread (one internal lock);
    :meth:`enqueue` / :meth:`peek` / :meth:`pop` / :meth:`drain` mutate the
    queue structure and are engine-thread-only (they still take the lock so
    the cross-thread counters stay coherent).
    """

    def __init__(
        self,
        cfg: Optional[SchedulerConfig] = None,
        *,
        slots: int = 8,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.cfg = cfg or SchedulerConfig()
        self._slots = max(1, int(slots))
        self._clock = clock
        self._lock = threading.Lock()
        self._queues: Dict[Tuple[str, str], Deque] = {}
        self._pass: Dict[Tuple[str, str], float] = {}
        self._vtime = 0.0
        self._depth = 0
        # KV-pressure admission (paged KV plane, docs/KV_PAGING.md): the
        # engine binds a callable reporting the pool's obtainable pages; the
        # scheduler tracks pages already promised to queued requests so a
        # burst cannot over-commit the pool between admissions
        self._kv_available = None
        self._kv_total = 0
        self._queued_kv_pages = 0
        self._spec_gauge_fn = None  # engine's spec_disabled gauge (bind_spec)
        self._kv_tier_stats_fn = None  # host KV tier stats (bind_kv_tier)
        # queue-wait histogram (obs plane) for predictive admission; None
        # keeps the pure EMA model (bind_wait_hist).  The windowing state
        # (last rotation's raw-count mark + the completed previous window)
        # has its own lock: _hist_wait_q runs OUTSIDE the scheduler lock and
        # must still rotate atomically across admitting threads.
        self._wait_hist = None
        self._hist_lock = threading.Lock()
        self._hist_mark: Optional[list] = None
        self._hist_prev: Optional[list] = None
        # autoscaler degradation override (set_degrade): when set, the
        # degradation band is forced on regardless of queue pressure — the
        # clamp applies at admission and degraded() reports True, which also
        # makes the engine skip speculative verify forwards
        self._degrade_forced: Optional[int] = None
        self._service_ema_s = float(self.cfg.service_time_init)
        # per-token service model (note_service with tokens > 0): rate EMA x
        # tokens-per-request EMA replaces the raw per-request EMA once warm,
        # so fused N-step decode ticks don't inflate predicted queue waits
        self._service_per_token_ema_s: Optional[float] = None
        self._service_tokens_ema = 0.0
        # per-class counters (created lazily so new classes just appear)
        self.submitted: Dict[str, int] = collections.defaultdict(int)
        self.admitted: Dict[str, int] = collections.defaultdict(int)
        self.shed: Dict[str, int] = collections.defaultdict(int)  # by reason
        self.expired_queued: Dict[str, int] = collections.defaultdict(int)
        self.expired_running: Dict[str, int] = collections.defaultdict(int)
        self.cancelled_queued: Dict[str, int] = collections.defaultdict(int)
        self._waits: Dict[str, Deque[float]] = collections.defaultdict(
            lambda: collections.deque(maxlen=self.cfg.wait_window)
        )

    # ------------------------------------------------------------- admission
    def bind_slots(self, slots: int) -> "RequestScheduler":
        """Engine capacity for the estimated-wait model (est wait =
        depth * service_ema / slots)."""
        self._slots = max(1, int(slots))
        return self

    def bind_spec(self, gauge_fn) -> "RequestScheduler":
        """Wire the engine's speculative-disable gauge into :meth:`stats`:
        the degradation band already reports ``degraded`` (load-disable);
        with this bound, operators also see the acceptance-controller's
        verdict side by side (``spec_disabled``) and can tell load-disable
        from acceptance-disable without cross-referencing engine stats."""
        self._spec_gauge_fn = gauge_fn
        return self

    def bind_wait_hist(self, hist) -> "RequestScheduler":
        """Wire the obs plane's queue-wait histogram into admission: once it
        holds ``admit_hist_min_samples``, the estimated wait (and therefore
        the shed test and the 429 ``Retry-After`` hint) is floored by the
        ``admit_wait_quantile`` of *realized* waits instead of trusting the
        point service-time EMA alone.  ``hist`` needs ``.count`` and
        ``.raw_counts()`` and ``.bounds`` (:class:`~.obs.Histogram`; an engine
        with ``obs`` on binds its ``queue_wait_s``)."""
        self._wait_hist = hist
        return self

    def set_degrade(self, clamp_max_tokens: Optional[int]) -> None:
        """Force the degradation band on (``clamp_max_tokens``) or release it
        (``None``) — the autoscaler's load-shaping actuator.  While forced,
        :meth:`try_admit` clamps ``max_tokens`` and :meth:`degraded` reports
        True (which also makes the engine skip speculative verify forwards),
        independent of the queue-pressure band."""
        with self._lock:
            self._degrade_forced = (
                None if clamp_max_tokens is None else max(1, int(clamp_max_tokens))
            )

    def _hist_wait_q(self) -> Optional[float]:
        """The WINDOWED wait quantile, or None (cold / unbound).

        Quantiles the previous + current window of the histogram's raw
        counts (two-window rotation every ``admit_hist_window`` samples), so
        the prediction tracks recent traffic instead of the histogram's
        process lifetime.  Called OUTSIDE self._lock: the histogram does its
        own locking, the rotation state its own — no lock is ever nested."""
        h = self._wait_hist
        if h is None:
            return None
        cfg = self.cfg
        with self._hist_lock:
            # the snapshot read happens INSIDE the rotation lock: two
            # admitting threads interleaving "read snapshot / rotate mark"
            # would otherwise diff against a NEWER mark and produce negative
            # window counts (a garbage ~30s quantile).  Lock order is
            # _hist_lock -> Histogram._lock only; nothing acquires them the
            # other way.
            counts, _n = h.raw_counts()
            if self._hist_mark is None:
                self._hist_mark = [0] * len(counts)
            cur = [c - m for c, m in zip(counts, self._hist_mark)]
            eff = (
                cur
                if self._hist_prev is None
                else [a + b for a, b in zip(cur, self._hist_prev)]
            )
            if sum(cur) >= cfg.admit_hist_window:
                # rotate: the current window becomes "previous", so there is
                # always up to 2x window of recent history behind the estimate
                self._hist_prev = cur
                self._hist_mark = counts
        if sum(eff) < cfg.admit_hist_min_samples:
            return None
        return float(quantile_from_counts(h.bounds, eff, cfg.admit_wait_quantile))

    def bind_kv(self, available_fn, total_pages: int) -> "RequestScheduler":
        """Wire the paged-KV pool into admission: ``available_fn`` reports
        obtainable pages (free + evictable cached prefixes), ``total_pages``
        the pool size.  A request that cannot start now — and whose projected
        KV wait (queued-KV backlog in pool drains x the service-time EMA)
        exceeds ``admit_max_wait_s`` — sheds with the distinct ``kv_pressure``
        reason instead of queueing behind memory that frees no faster than
        running requests finish."""
        self._kv_available = available_fn
        self._kv_total = max(0, int(total_pages))
        return self

    def bind_kv_tier(self, stats_fn) -> "RequestScheduler":
        """Wire the host/disk KV tier's stats into :meth:`stats` (the
        ``bind_spec`` discipline: the gauge callable runs OUTSIDE this
        scheduler's lock — it takes the tier's own lock).  Operators and the
        autoscaler then read pool pressure (``queued_kv_pages``, sheds) and
        warm-tier depth (``kv_tier.kv_host_entries`` / bytes) side by side:
        a pool under pressure with a deep warm tier sheds *restorable* work,
        one without sheds *unrecoverable* prefill."""
        self._kv_tier_stats_fn = stats_fn
        return self

    def release_kv(self, pages: int) -> None:
        """Return reserved-but-unneeded pages to the admission ledger (e.g.
        the degradation band clamped max_tokens after the reservation)."""
        with self._lock:
            self._queued_kv_pages = max(0, self._queued_kv_pages - max(0, pages))

    def _service_s_locked(self) -> float:
        """Expected per-request service time: the per-token model (rate EMA x
        tokens-per-request EMA) once the engine has fed token counts, else
        the raw per-request EMA — see :meth:`note_service`."""
        if self._service_per_token_ema_s is not None:
            return self._service_per_token_ema_s * max(
                1.0, self._service_tokens_ema
            )
        return self._service_ema_s

    def _est_wait_s_locked(self, extra: int = 0, hist_q: Optional[float] = None) -> float:
        """Predicted time until a newly queued request could START.

        The depth*EMA/slots model is the rising-load term (a deepening queue
        pushes the prediction up immediately); ``hist_q`` — the warm
        queue-wait histogram quantile, computed by the caller outside the
        lock — floors it with the measured tail of realized waits, which the
        point EMA systematically underestimates under service-time variance."""
        model = (self._depth + extra) * self._service_s_locked() / self._slots
        if hist_q is not None and self._depth + extra > 0:
            return max(model, hist_q)
        return model

    def try_admit(
        self,
        priority: str = INTERACTIVE,
        deadline_s: Optional[float] = None,
        kv_pages: int = 0,
        *,
        now: Optional[float] = None,
    ) -> Admission:
        """The synchronous admission test (any thread).  On ``ok`` the caller
        MUST follow through with :meth:`enqueue` (depth — and the ``kv_pages``
        reservation — are charged here so a racing burst cannot overshoot
        either bound)."""
        cfg = self.cfg
        # the warm histogram quantile reads outside self._lock (its own lock)
        hist_q = self._hist_wait_q()
        with self._lock:
            self.submitted[priority] += 1
            # time until this request could START (everything ahead of it over
            # the engine's slots) — its own service time is the client's
            # business, the deadline test below only covers the queue wait.
            # The Retry-After hint IS that prediction (clamped): a client that
            # backs off exactly this long lands when a slot is expected free,
            # instead of the old est/2 guess (docs/AUTOSCALING.md).
            est = self._est_wait_s_locked(hist_q=hist_q)
            retry = min(30.0, max(0.2, est))
            if self._depth >= cfg.max_queue:
                self.shed["queue_full"] += 1
                return Admission(False, "queue_full", retry)
            if (
                kv_pages
                and self._kv_available is not None
                and self._kv_total
                and cfg.admit_max_wait_s is not None
            ):
                # projected KV pressure: queue depth alone cannot see a pool
                # exhausted by a few long-context admissions.  Shed only when
                # BOTH hold: the request could not start now (its worst-case
                # page demand exceeds the obtainable pages minus what the
                # queue already reserved), and its projected wait for pages —
                # the queued-KV backlog measured in full pool drains, each
                # costing ~one service time — exceeds the same estimated-wait
                # ceiling the depth test uses.  Same philosophy, distinct
                # reason (and counter) so operators can tell memory pressure
                # from compute backlog.
                avail = int(self._kv_available()) - self._queued_kv_pages
                kv_wait = (
                    (self._queued_kv_pages + kv_pages)
                    / self._kv_total
                    * self._service_s_locked()
                )
                if kv_pages > avail and kv_wait > cfg.admit_max_wait_s:
                    self.shed["kv_pressure"] += 1
                    return Admission(False, "kv_pressure", retry)
            if cfg.admit_max_wait_s is not None and est > cfg.admit_max_wait_s:
                self.shed["est_wait"] += 1
                return Admission(False, "estimated_wait", retry)
            if deadline_s is not None and est > deadline_s:
                # the queue alone would eat the whole deadline — shedding now
                # is kinder than a guaranteed DeadlineExceeded later
                self.shed["deadline_infeasible"] += 1
                return Admission(False, "deadline_infeasible", retry)
            self._depth += 1
            self._queued_kv_pages += max(0, int(kv_pages))
            clamp = None
            if (
                cfg.degrade_at < 1.0
                and self._depth >= cfg.degrade_at * cfg.max_queue
            ):
                clamp = int(cfg.degrade_max_tokens)
            if self._degrade_forced is not None:
                # autoscaler override: the tighter clamp wins
                clamp = (
                    self._degrade_forced
                    if clamp is None
                    else min(clamp, self._degrade_forced)
                )
            return Admission(True, clamp_max_tokens=clamp)

    def degraded(self) -> bool:
        """The degradation band is active — queue pressure past ``degrade_at``
        or the autoscaler's forced override — so the engine should skip
        speculative decoding (wasted verify forwards under load)."""
        cfg = self.cfg
        with self._lock:
            if self._degrade_forced is not None:
                return True
            return cfg.degrade_at < 1.0 and (
                self._depth >= cfg.degrade_at * cfg.max_queue
            )

    # ------------------------------------------------------------- the queue
    def _weight(self, key: Tuple[str, str]) -> float:
        cls_w = float(self.cfg.class_weights.get(key[0], 1.0))
        ten_w = float(self.cfg.tenant_weights.get(key[1], 1.0))
        return max(1e-6, cls_w * ten_w)

    def enqueue(self, req, *, front: bool = False) -> None:
        """Insert an (already admitted) request.  Requests that bypassed
        :meth:`try_admit` (internal/test paths writing the engine queue
        directly) are counted here so depth accounting stays true.

        ``front=True`` re-inserts at the HEAD of the request's (class, tenant)
        queue — the crash-only restart path (engine ``_restart``) uses it to
        re-submit salvaged in-flight work ahead of later arrivals.  The
        request keeps its class/tenant tags, so fair-share ordering across
        queues is untouched; within its own queue it simply resumes the place
        it already earned.  Depth was already released when the request was
        popped, so a ``front`` re-insert charges depth again (admitted flag
        notwithstanding) to keep the bound true."""
        key = (
            getattr(req, "priority", INTERACTIVE) or INTERACTIVE,
            getattr(req, "tenant", "default") or "default",
        )
        with self._lock:
            if front or not getattr(req, "admitted", False):
                self._depth += 1
                self._queued_kv_pages += max(0, getattr(req, "kv_pages", 0))
            q = self._queues.get(key)
            if q is None:
                q = self._queues[key] = collections.deque()
            if not q:
                # an idle queue must not bank credit: restart at current vtime
                self._pass[key] = max(self._pass.get(key, 0.0), self._vtime)
            if front:
                q.appendleft(req)
            else:
                q.append(req)

    def _best_key_locked(self) -> Optional[Tuple[str, str]]:
        best = None
        for key, q in self._queues.items():
            if not q:
                continue
            cand = (self._pass[key], -self._weight(key), key)
            if best is None or cand < best[0]:
                best = (cand, key)
        return best[1] if best is not None else None

    def _reap_head_locked(self, now: float, expired: List):
        """Drop dead entries (cancelled / expired) from whichever queue is
        next up; returns the live (key, req) head or None when everything is
        empty.  Expired entries are APPENDED to ``expired``, not resolved —
        resolving a future runs its done-callbacks synchronously (the
        multi-replica router's re-dispatch takes other locks there), and
        doing that under ``self._lock`` is exactly the ABBA shape PR 7's
        review outlawed in :meth:`reap`/:meth:`drain`.  Callers resolve after
        releasing the lock (found by dabtlint DABT102)."""
        while True:
            key = self._best_key_locked()
            if key is None:
                return None
            q = self._queues[key]
            req = q[0]
            if req.future.cancelled():
                q.popleft()
                self._depth = max(0, self._depth - 1)
                self._release_kv_locked(req)
                self.cancelled_queued[key[0]] += 1
                continue
            dl = getattr(req, "deadline_at", None)
            if dl is not None and now >= dl:
                q.popleft()
                self._depth = max(0, self._depth - 1)
                self._release_kv_locked(req)
                self.expired_queued[key[0]] += 1
                expired.append(req)
                continue
            return key, req

    def _resolve_expired(self, expired: List, now: float) -> None:
        """Fail reaped entries OUTSIDE the lock (see _reap_head_locked)."""
        from .engine import _safe_resolve  # local import: engine imports us too

        for req in expired:
            _safe_resolve(
                req.future,
                exc=DeadlineExceeded(
                    f"deadline expired after {now - req.submitted_at:.2f}s in queue"
                ),
            )

    def peek(self, now: Optional[float] = None):
        """Next request the fair-share policy would run, without removing it
        (dead heads are reaped as a side effect)."""
        now = now if now is not None else self._clock()
        expired: List = []
        with self._lock:
            head = self._reap_head_locked(now, expired)
        self._resolve_expired(expired, now)
        return head[1] if head else None

    def pop(self, now: Optional[float] = None):
        """Remove and return the next request; charges its queue's virtual
        pass (this is the fair-share accounting step)."""
        now = now if now is not None else self._clock()
        expired: List = []
        with self._lock:
            head = self._reap_head_locked(now, expired)
            if head is not None:
                key, req = head
                self._queues[key].popleft()
                self._depth = max(0, self._depth - 1)
                self._release_kv_locked(req)
                self._vtime = self._pass[key]
                self._pass[key] += 1.0 / self._weight(key)
                self.admitted[key[0]] += 1
                self._waits[key[0]].append(now - req.submitted_at)
        self._resolve_expired(expired, now)
        return head[1] if head else None

    def reap(self, now: Optional[float] = None) -> int:
        """Drop cancelled/deadline-expired entries ANYWHERE in the queues
        (not just at pop time): the engine calls this every loop iteration so
        a queued request's DeadlineExceeded lands at ~its deadline even when
        every decode slot is busy — and the dead entry stops inflating depth
        (which would shed admittable work with spurious queue_full 429s).
        Returns the number of entries dropped."""
        from .engine import _safe_resolve

        now = now if now is not None else self._clock()
        dropped = 0
        expired = []
        with self._lock:
            for key, q in self._queues.items():
                if not q:
                    continue
                keep: Deque = collections.deque()
                while q:
                    req = q.popleft()
                    if req.future.cancelled():
                        self._depth = max(0, self._depth - 1)
                        self._release_kv_locked(req)
                        self.cancelled_queued[key[0]] += 1
                        dropped += 1
                        continue
                    dl = getattr(req, "deadline_at", None)
                    if dl is not None and now >= dl:
                        self._depth = max(0, self._depth - 1)
                        self._release_kv_locked(req)
                        self.expired_queued[key[0]] += 1
                        dropped += 1
                        expired.append(req)
                        continue
                    keep.append(req)
                q.extend(keep)
        # resolve OUTSIDE the lock: done-callbacks (the multi-replica
        # router's re-dispatch) may take other schedulers' locks
        for req in expired:
            _safe_resolve(
                req.future,
                exc=DeadlineExceeded(
                    f"deadline expired after "
                    f"{now - req.submitted_at:.2f}s in queue"
                ),
            )
        return dropped

    def drain(self, err: BaseException) -> None:
        """Fail everything still queued (engine shutdown).

        Futures resolve OUTSIDE the lock: a routed request's done-callback
        re-dispatches to ANOTHER replica — taking that replica's scheduler
        lock — and two replicas dying simultaneously would otherwise hold
        each other's locks in an ABBA deadlock (each engine thread draining
        its own scheduler while re-dispatching into the other's)."""
        from .engine import _safe_resolve

        victims = []
        with self._lock:
            for q in self._queues.values():
                while q:
                    victims.append(q.popleft())
                    self._depth = max(0, self._depth - 1)
            self._depth = max(0, self._depth)
            self._queued_kv_pages = 0
        for req in victims:
            _safe_resolve(req.future, exc=err)

    def _release_kv_locked(self, req) -> None:
        self._queued_kv_pages = max(
            0, self._queued_kv_pages - max(0, getattr(req, "kv_pages", 0))
        )

    # ------------------------------------------------------------- telemetry
    def note_service(self, seconds: float, tokens: int = 0) -> None:
        """Fold one finished request's service time into the EMA driving the
        estimated-wait admission test.

        With ``tokens > 0`` (the decode steps the request's slot actually sat
        through — the engine charges fused N-step ticks their full N even
        when EOS lands mid-tick, plus one unit per chunked-prefill dispatch,
        sequential or piggybacked), the model becomes PER-TOKEN: a per-token
        rate EMA and a tokens-per-request EMA whose product replaces the raw
        per-request EMA in :meth:`_est_wait_s_locked`.  Why: a
        ``decode_steps=N`` engine delivers residency in N-step quanta and the
        host sees finishes ``lookahead`` ticks late, so short requests'
        measured residency inflates by up to ``lookahead * (N-1)`` steps —
        feeding that directly into the per-request EMA inflates every
        predicted queue wait (and therefore 429 Retry-After hints and the
        autoscaler's backlog signal).  Normalizing by the steps the slot
        really occupied keeps the rate honest; the tokens EMA restores the
        per-request scale.  Calls without ``tokens`` keep the legacy
        per-request EMA behavior byte-for-byte (and that EMA keeps updating
        regardless, as the cold-start fallback)."""
        a = self.cfg.service_time_alpha
        with self._lock:
            self._service_ema_s = (1 - a) * self._service_ema_s + a * max(
                0.0, float(seconds)
            )
            if tokens > 0:
                per_tok = max(0.0, float(seconds)) / int(tokens)
                if self._service_per_token_ema_s is None:
                    self._service_per_token_ema_s = per_tok
                    self._service_tokens_ema = float(tokens)
                else:
                    self._service_per_token_ema_s = (
                        (1 - a) * self._service_per_token_ema_s + a * per_tok
                    )
                    self._service_tokens_ema = (
                        (1 - a) * self._service_tokens_ema + a * float(tokens)
                    )
            elif self._service_per_token_ema_s is not None:
                # token-less evidence after the model warmed (a test harness
                # or non-engine caller): fold it in at the learned
                # tokens-per-request so it still moves the effective model —
                # the tokens EMA itself carries no new information here
                per_tok = max(0.0, float(seconds)) / max(
                    1.0, self._service_tokens_ema
                )
                self._service_per_token_ema_s = (
                    (1 - a) * self._service_per_token_ema_s + a * per_tok
                )

    def note_expired_running(self, priority: str) -> None:
        with self._lock:
            self.expired_running[priority or INTERACTIVE] += 1

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return self._depth

    def pressure(self) -> float:
        with self._lock:
            return self._depth / max(1, self.cfg.max_queue)

    def est_wait_s(self) -> float:
        hist_q = self._hist_wait_q()
        with self._lock:
            return self._est_wait_s_locked(hist_q=hist_q)

    @staticmethod
    def _pctl(sorted_vals, frac: float) -> float:
        if not sorted_vals:
            return 0.0
        idx = min(len(sorted_vals) - 1, max(0, round(frac * (len(sorted_vals) - 1))))
        return sorted_vals[idx]

    def wait_stats(self) -> Dict[str, Dict[str, float]]:
        """Per-class queue-wait percentiles (ms) over the sample window."""
        with self._lock:
            out = {}
            for cls, samples in self._waits.items():
                vals = sorted(samples)
                out[cls] = {
                    "n": len(vals),
                    "p50_ms": round(self._pctl(vals, 0.50) * 1e3, 2),
                    "p95_ms": round(self._pctl(vals, 0.95) * 1e3, 2),
                }
            return out

    def stats(self) -> dict:
        """One JSON-able snapshot for /healthz and tick_stats."""
        waits = self.wait_stats()
        # the engine-side gauges run OUTSIDE the lock: they read engine/tier
        # state (controller verdict, host-tier ledger) and must not nest locks
        spec = self._spec_gauge_fn() if self._spec_gauge_fn is not None else None
        kv_tier = (
            self._kv_tier_stats_fn() if self._kv_tier_stats_fn is not None else None
        )
        hist_q = self._hist_wait_q()
        with self._lock:
            return {
                "queue_depth": self._depth,
                "queued_kv_pages": self._queued_kv_pages,
                "max_queue": self.cfg.max_queue,
                "pressure": round(self._depth / max(1, self.cfg.max_queue), 4),
                "est_wait_s": round(self._est_wait_s_locked(hist_q=hist_q), 4),
                "est_wait_source": "histogram" if hist_q is not None else "ema",
                "wait_hist_q_s": round(hist_q, 4) if hist_q is not None else None,
                "service_ema_s": round(self._service_ema_s, 4),
                # the per-token model actually driving est_wait once warm
                # (None until the engine feeds token counts): rate x
                # tokens-per-request — see note_service
                "service_model_s": round(self._service_s_locked(), 4),
                "service_per_token_ema_ms": (
                    round(self._service_per_token_ema_s * 1e3, 4)
                    if self._service_per_token_ema_s is not None
                    else None
                ),
                "service_tokens_ema": round(self._service_tokens_ema, 2),
                "degraded": self._degrade_forced is not None
                or (
                    self.cfg.degrade_at < 1.0
                    and self._depth >= self.cfg.degrade_at * self.cfg.max_queue
                ),
                "degrade_forced": self._degrade_forced is not None,
                "submitted": dict(self.submitted),
                "admitted": dict(self.admitted),
                "shed": dict(self.shed),
                "expired_queued": dict(self.expired_queued),
                "expired_running": dict(self.expired_running),
                "cancelled_queued": dict(self.cancelled_queued),
                "wait": waits,
                **({"spec_disabled": spec} if spec is not None else {}),
                **({"kv_tier": kv_tier} if kv_tier is not None else {}),
            }
