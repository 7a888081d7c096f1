"""Serving-plane observability: request tracing, ``/metrics``, crash flight
recorder (the port's copy of the JAX package's ``serving/obs.py``, which
imports no JAX; the port keeps its own copy and imports nothing of that
package).

- **Per-request tracing.**  Every request carries a ``trace_id`` (the
  client's ``X-Request-Id`` or one generated at admission).  Span timings
  come from host timestamps the tick path already stamps (``submitted_at`` /
  ``started_at`` / ``first_token_at`` / finish): the recorder adds no device
  synchronisation, and it runs after a tick's ids reached the host, outside
  the captured CUDA graphs.  Completed traces land in a bounded ring
  (:meth:`EngineObs.traces`).
- **Prometheus metrics.**  Fixed-bucket :class:`Histogram` state updated from
  ``_process_tick``'s host bookkeeping (TTFT, inter-token latency, queue
  wait, tick duration) plus the engine, scheduler and KV gauges, rendered as
  text exposition format by :func:`render_prometheus` for ``GET /metrics``.
  :func:`parse_prometheus_text` is a small parser that validates the
  exposition.  The engine binds ``queue_wait_s`` to its scheduler, whose
  estimated-wait admission and ``Retry-After`` are floored by the realized
  waits once the histogram is warm.
- **Crash flight recorder.**  A bounded ring of recent engine events
  (admissions, periodic tick summaries, quarantines, restarts, fault
  fires) that the failure paths dump to a JSON file and a log line
  (:meth:`FlightRecorder.dump`).  ``DABT_FLIGHT_DIR`` overrides the dump
  location (default: ``<tmpdir>/dabt-flight``).

Every timestamp comes from an injectable clock, so fake-clock tests drive
spans and flight stamps deterministically.
"""

from __future__ import annotations

import bisect
import collections
import json
import logging
import math
import os
import tempfile
import threading
import time
import uuid
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

logger = logging.getLogger(__name__)

ENV_FLIGHT_DIR = "DABT_FLIGHT_DIR"

# Fixed histogram bucket ladders (seconds unless noted).  Fixed buckets — not
# reservoirs — so scrapes are mergeable across time and replicas and the
# hot-path observe cost is one bisect + one increment.
TTFT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)
ITL_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0)
WAIT_BUCKETS = TTFT_BUCKETS
TICK_BUCKETS = ITL_BUCKETS
ACCEPT_BUCKETS = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0)


def new_trace_id() -> str:
    """16-hex-char request/trace id (collision odds are irrelevant at the
    ring-buffer horizons this plane keeps)."""
    return uuid.uuid4().hex[:16]


# --------------------------------------------------------------------- metrics
class Histogram:
    """Fixed-bucket histogram, Prometheus semantics (cumulative at render).

    Thread contract: :meth:`observe` is called from the engine thread's tick
    bookkeeping (the hot path: it never touches device state),
    :meth:`snapshot` from scrape threads; one small lock covers both.
    """

    __slots__ = ("bounds", "_counts", "_sum", "_n", "_lock")

    def __init__(self, bounds: Tuple[float, ...]):
        self.bounds = tuple(float(b) for b in bounds)
        self._counts = [0] * (len(self.bounds) + 1)  # +1 = the +Inf bucket
        self._sum = 0.0
        self._n = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        idx = bisect.bisect_left(self.bounds, value)
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._n += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._n

    def raw_counts(self) -> Tuple[List[int], int]:
        """(per-bucket raw counts incl. the +Inf bucket, total n) — the
        windowing substrate: consumers diff two snapshots to quantile over
        only the observations BETWEEN them (serving/scheduler.py)."""
        with self._lock:
            return list(self._counts), self._n

    def quantile(self, q: float) -> float:
        """Bucket-interpolated ``q``-quantile of the observed values.

        The estimate linearly interpolates inside the bucket that contains
        the target rank; values in the ``+Inf`` bucket report the largest
        finite bound (a deliberate *under*-estimate — the admission plane
        uses this as a prediction, and an unbounded guess would shed
        everything forever).  Returns 0.0 on an empty histogram — callers
        gate on :attr:`count` to tell "cold" from "fast"."""
        counts, n = self.raw_counts()
        return quantile_from_counts(self.bounds, counts, q)

    def snapshot(self) -> Tuple[List[Tuple[float, int]], float, int]:
        """(cumulative ``le`` buckets, sum, count) — the exposition shape."""
        with self._lock:
            counts = list(self._counts)
            total, n = self._sum, self._n
        out: List[Tuple[float, int]] = []
        acc = 0
        for b, c in zip(self.bounds, counts):
            acc += c
            out.append((b, acc))
        out.append((float("inf"), acc + counts[-1]))
        return out, total, n


def quantile_from_counts(
    bounds: Tuple[float, ...], counts: List[int], q: float
) -> float:
    """The bucket-interpolation quantile over RAW per-bucket counts (the last
    entry being the +Inf bucket).  Shared by :meth:`Histogram.quantile` and
    the scheduler's windowed predictive-admission floor, which quantiles the
    DIFFERENCE of two count snapshots."""
    q = min(1.0, max(0.0, float(q)))
    n = sum(counts)
    if n == 0:
        return 0.0
    target = max(1, math.ceil(q * n))
    acc = 0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        if acc + c >= target:
            if i >= len(bounds):  # +Inf bucket: report the finite ceiling
                return bounds[-1]
            lo = bounds[i - 1] if i > 0 else 0.0
            hi = bounds[i]
            frac = (target - acc) / c
            return lo + frac * (hi - lo)
        acc += c
    return bounds[-1]  # pragma: no cover - defensive


class _Exposition:
    """Accumulates metric families and renders Prometheus text format."""

    def __init__(self) -> None:
        self._families: "collections.OrderedDict[str, dict]" = collections.OrderedDict()

    @staticmethod
    def _fmt_labels(labels: Optional[Mapping[str, str]]) -> str:
        if not labels:
            return ""
        inner = ",".join(
            '%s="%s"' % (k, str(v).replace("\\", "\\\\").replace('"', '\\"'))
            for k, v in sorted(labels.items())
        )
        return "{%s}" % inner

    @staticmethod
    def _fmt_value(v: float) -> str:
        if v != v:  # NaN
            return "NaN"
        if v == float("inf"):
            return "+Inf"
        if v == float("-inf"):
            return "-Inf"
        if isinstance(v, bool):
            return "1" if v else "0"
        if isinstance(v, int) or float(v).is_integer():
            return str(int(v))
        return repr(float(v))

    def _family(self, name: str, mtype: str, help_text: str) -> dict:
        fam = self._families.get(name)
        if fam is None:
            fam = self._families[name] = {
                "type": mtype,
                "help": help_text,
                "samples": [],
            }
        return fam

    def add(
        self,
        name: str,
        mtype: str,
        help_text: str,
        value: Any,
        labels: Optional[Mapping[str, str]] = None,
    ) -> None:
        if value is None:
            return
        if isinstance(value, bool):
            value = 1.0 if value else 0.0
        self._family(name, mtype, help_text)["samples"].append(
            (name, dict(labels or {}), float(value))
        )

    def add_histogram(
        self,
        name: str,
        help_text: str,
        hist: Histogram,
        labels: Optional[Mapping[str, str]] = None,
    ) -> None:
        fam = self._family(name, "histogram", help_text)
        buckets, total, n = hist.snapshot()
        base = dict(labels or {})
        for le, cum in buckets:
            lab = dict(base)
            lab["le"] = "+Inf" if le == float("inf") else self._fmt_value(le)
            fam["samples"].append((f"{name}_bucket", lab, float(cum)))
        fam["samples"].append((f"{name}_sum", base, float(total)))
        fam["samples"].append((f"{name}_count", base, float(n)))

    def render(self) -> str:
        lines: List[str] = []
        for name, fam in self._families.items():
            lines.append(f"# HELP {name} {fam['help']}")
            lines.append(f"# TYPE {name} {fam['type']}")
            for sample_name, labels, value in fam["samples"]:
                lines.append(
                    f"{sample_name}{self._fmt_labels(labels)} {self._fmt_value(value)}"
                )
        return "\n".join(lines) + "\n"


def parse_prometheus_text(text: str) -> Dict[str, dict]:
    """Small in-repo exposition parser/validator (CI + bench + tests).

    Returns ``{family: {"type": ..., "samples": [(name, labels, value)]}}``.
    Raises :class:`ValueError` on malformed input: a sample without a TYPE,
    an unparseable value, or a histogram whose cumulative buckets decrease or
    whose ``+Inf`` bucket disagrees with ``_count``.
    """
    families: Dict[str, dict] = {}
    typed: Dict[str, str] = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("# TYPE "):
            _, _, rest = line.partition("# TYPE ")
            parts = rest.split()
            if len(parts) != 2:
                raise ValueError(f"malformed TYPE line: {raw!r}")
            typed[parts[0]] = parts[1]
            families.setdefault(parts[0], {"type": parts[1], "samples": []})
            continue
        if line.startswith("#"):
            continue
        # sample: name{labels} value
        if "{" in line:
            name, _, rest = line.partition("{")
            labels_raw, _, value_raw = rest.rpartition("}")
            labels: Dict[str, str] = {}
            if labels_raw:
                for pair in _split_labels(labels_raw):
                    k, _, v = pair.partition("=")
                    if not (v.startswith('"') and v.endswith('"')):
                        raise ValueError(f"unquoted label value: {raw!r}")
                    labels[k] = v[1:-1].replace('\\"', '"').replace("\\\\", "\\")
        else:
            name, _, value_raw = line.partition(" ")
            labels = {}
        name = name.strip()
        value_raw = value_raw.strip()
        try:
            value = float(value_raw.replace("+Inf", "inf").replace("-Inf", "-inf"))
        except ValueError:
            raise ValueError(f"unparseable sample value: {raw!r}") from None
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[: -len(suffix)] in typed:
                base = name[: -len(suffix)]
                break
        if base not in typed:
            raise ValueError(f"sample {name!r} has no preceding TYPE line")
        families[base]["samples"].append((name, labels, value))
    _validate_histograms(families)
    return families


def _split_labels(raw: str) -> List[str]:
    """Split ``k="v",k2="v2"`` on commas outside quotes."""
    out, buf, in_q, esc = [], [], False, False
    for ch in raw:
        if esc:
            buf.append(ch)
            esc = False
            continue
        if ch == "\\":
            buf.append(ch)
            esc = True
            continue
        if ch == '"':
            in_q = not in_q
        if ch == "," and not in_q:
            out.append("".join(buf))
            buf = []
            continue
        buf.append(ch)
    if buf:
        out.append("".join(buf))
    return out


def _validate_histograms(families: Dict[str, dict]) -> None:
    for base, fam in families.items():
        if fam["type"] != "histogram":
            continue
        # group by the label set minus `le`
        series: Dict[tuple, dict] = {}
        for name, labels, value in fam["samples"]:
            key = tuple(sorted((k, v) for k, v in labels.items() if k != "le"))
            s = series.setdefault(key, {"buckets": [], "count": None})
            if name.endswith("_bucket"):
                le = labels.get("le")
                if le is None:
                    raise ValueError(f"{base}: bucket sample without le label")
                s["buckets"].append((float(le.replace("+Inf", "inf")), value))
            elif name.endswith("_count"):
                s["count"] = value
        for key, s in series.items():
            buckets = sorted(s["buckets"])
            if not buckets:
                raise ValueError(f"{base}: histogram series {key} has no buckets")
            prev = -1.0
            for le, cum in buckets:
                if cum < prev:
                    raise ValueError(f"{base}: non-cumulative buckets at le={le}")
                prev = cum
            if buckets[-1][0] != float("inf"):
                raise ValueError(f"{base}: histogram missing +Inf bucket")
            if s["count"] is not None and buckets[-1][1] != s["count"]:
                raise ValueError(
                    f"{base}: +Inf bucket {buckets[-1][1]} != _count {s['count']}"
                )


# ------------------------------------------------------------ flight recorder
class FlightRecorder:
    """Bounded ring of recent serving events + the crash-dump writer.

    ``record()`` is cheap (one deque append under a small lock) and safe from
    any thread; ``dump()`` snapshots the ring and writes a JSON artifact —
    called from failure paths (restart, quarantine, drain), it must never
    crash recovery, so I/O errors log and return ``None``.

    Clock discipline: event stamps use the injectable monotonic
    ``clock`` (comparable with every other serving timestamp); the dump
    artifact additionally carries one wall-clock stamp from the injectable
    ``walltime`` so operators can line artifacts up with external logs.
    """

    def __init__(
        self,
        capacity: int = 256,
        *,
        name: str = "engine",
        clock: Callable[[], float] = time.monotonic,
        walltime: Callable[[], float] = time.time,
        dump_dir: Optional[str] = None,
    ):
        self.name = name
        self._clock = clock
        self._walltime = walltime
        self._dump_dir = dump_dir
        self._lock = threading.Lock()
        self._events: "collections.deque[dict]" = collections.deque(
            maxlen=max(16, int(capacity))
        )
        self._seq = 0
        self.dumps = 0

    def record(self, event: str, **fields: Any) -> None:
        entry = {"t_mono_s": round(self._clock(), 4), "event": event}
        entry.update(fields)
        with self._lock:
            self._seq += 1
            entry["seq"] = self._seq
            self._events.append(entry)

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def dump(self, reason: str, **context: Any) -> Optional[str]:
        """Write the ring to ``<dir>/flight-<name>-<pid>-<n>.json``; returns
        the path (None on failure — dumping must never break recovery)."""
        with self._lock:
            events = list(self._events)
            self.dumps += 1
            n = self.dumps
        payload = {
            "reason": reason,
            "recorder": self.name,
            "dumped_at_unix": round(self._walltime(), 3),
            "dumped_at_mono_s": round(self._clock(), 4),
            **context,
            "events": events,
        }
        directory = (
            os.environ.get(ENV_FLIGHT_DIR, "").strip()
            or self._dump_dir
            or os.path.join(tempfile.gettempdir(), "dabt-flight")
        )
        safe = "".join(c if (c.isalnum() or c in "._-") else "_" for c in self.name)
        path = os.path.join(directory, f"flight-{safe}-{os.getpid()}-{n:03d}.json")
        try:
            os.makedirs(directory, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump(payload, fh, indent=1, default=str)
            os.replace(tmp, path)
        except OSError as e:
            logger.warning("flight recorder dump failed (%s): %s", reason, e)
            return None
        logger.error(
            "flight recorder dumped: reason=%s recorder=%s events=%d -> %s",
            reason,
            self.name,
            len(events),
            path,
        )
        return path


# ----------------------------------------------------------------- engine obs
class EngineObs:
    """Per-engine observability: span traces, metric histograms, flight ring.

    The ``on_*`` methods are the hot-path entry points: pure host-side
    bookkeeping over values ``_process_tick`` already holds, with no device
    synchronisation and no raw ``time.*()`` call under them.
    """

    def __init__(
        self,
        name: str = "engine",
        *,
        clock: Callable[[], float] = time.monotonic,
        trace_capacity: int = 256,
        flight_capacity: int = 256,
        tick_summary_every: int = 64,
        dump_dir: Optional[str] = None,
    ):
        self.name = name
        self._clock = clock
        self.ttft_s = Histogram(TTFT_BUCKETS)
        self.itl_s = Histogram(ITL_BUCKETS)
        self.queue_wait_s = Histogram(WAIT_BUCKETS)
        self.tick_s = Histogram(TICK_BUCKETS)
        self.accept_ratio = Histogram(ACCEPT_BUCKETS)
        self.flight = FlightRecorder(
            flight_capacity, name=name, clock=clock, dump_dir=dump_dir
        )
        self._lock = threading.Lock()
        self._traces: "collections.deque[dict]" = collections.deque(
            maxlen=max(16, int(trace_capacity))
        )
        self.traces_total = 0
        self._tick_summary_every = max(1, int(tick_summary_every))
        self._ticks_seen = 0

    # ---- hot path (called from _process_tick bookkeeping) ----
    def on_tick(self, block_s: float, active: int) -> None:
        """One processed tick: duration histogram + a periodic flight-ring
        summary (every Nth tick, so admissions/faults aren't drowned)."""
        self.tick_s.observe(block_s)
        self._ticks_seen += 1
        if self._ticks_seen % self._tick_summary_every == 0:
            self.flight.record(
                "tick_summary",
                ticks=self._ticks_seen,
                active=active,
                block_ms=round(block_s * 1e3, 3),
            )

    def on_spec_tick(self, accepted: int, drafted: int) -> None:
        """One processed speculative tick: its greedy rows' accept ratio."""
        if drafted > 0:
            self.accept_ratio.observe(accepted / drafted)

    def on_first_token(self, ttft_s: float) -> None:
        self.ttft_s.observe(ttft_s)

    def on_token_gap(self, gap_s: float) -> None:
        self.itl_s.observe(gap_s)

    # ---- request lifecycle (off the per-token path) -------------------------
    def on_admit(self, trace_id: str, priority: str, tenant: str, prompt_tokens: int) -> None:
        self.flight.record(
            "admit",
            trace_id=trace_id,
            priority=priority,
            tenant=tenant,
            prompt_tokens=prompt_tokens,
        )

    def on_shed(self, reason: str, priority: str, trace_id: str = "") -> None:
        self.flight.record(
            "shed", trace_id=trace_id, reason=reason, priority=priority
        )

    def on_finish(self, req: Any, result: Any, *, now: float, detok_s: float) -> None:
        """Close a request's trace from the host timestamps the tick path
        already stamped; observes queue-wait and appends to the trace ring."""
        t0 = req.submitted_at
        started = req.started_at if req.started_at is not None else t0
        first = req.first_token_at if req.first_token_at is not None else now
        queue_wait = max(0.0, started - t0)
        self.queue_wait_s.observe(queue_wait)
        spans = [
            {"name": "admit", "t_s": 0.0},
            {"name": "queue_wait", "t_s": 0.0, "dur_s": round(queue_wait, 6)},
            {
                "name": "prefill",
                "t_s": round(started - t0, 6),
                "dur_s": round(max(0.0, first - started), 6),
            },
            {
                "name": "decode",
                "t_s": round(first - t0, 6),
                "dur_s": round(max(0.0, now - first - detok_s), 6),
                "tokens": result.completion_tokens,
            },
            {"name": "detok", "t_s": round(now - t0 - detok_s, 6), "dur_s": round(detok_s, 6)},
            {"name": "deliver", "t_s": round(now - t0, 6)},
        ]
        trace = {
            "trace_id": req.trace_id,
            "engine": self.name,
            "priority": req.priority,
            "tenant": req.tenant,
            "prompt_tokens": result.prompt_tokens,
            "completion_tokens": result.completion_tokens,
            "restarts": req.restarts,
            # submission stamp in the engine's monotonic clock domain: only
            # DIFFERENCES are meaningful, which is exactly what the workload
            # trace export needs (relative arrival offsets — workload/capture.py)
            "t_submit_s": round(t0, 6),
            "total_s": round(now - t0, 6),
            "spans": spans,
        }
        with self._lock:
            self._traces.append(trace)
            self.traces_total += 1
        self.flight.record(
            "finish",
            trace_id=req.trace_id,
            tokens=result.completion_tokens,
            total_s=round(now - t0, 4),
        )

    def traces(self) -> List[dict]:
        with self._lock:
            return list(self._traces)


# ------------------------------------------------------------------ /metrics
def render_prometheus(registry: Any) -> str:
    """Render one scrape of every generator the registry serves: the engine
    supervision, decode-path, scheduler and KV gauges and the obs histograms
    and the embedding queues (the JAX package's families for what the port
    serves; the router, autoscaler, fleet, task and RAG planes add theirs as
    they are ported).  Pure read path: safe to call from the HTTP event loop while an
    engine is dead, degraded or mid-restart."""
    x = _Exposition()
    for model, eng in sorted(getattr(registry, "generators", {}).items()):
        lab = {"model": model, "replica": getattr(eng, "name", "0")}
        sup = eng.supervision_stats()
        x.add("dabt_engine_steps_total", "counter", "device decode steps issued", eng.steps, lab)
        x.add("dabt_engine_active_slots", "gauge", "live decode slots", eng.num_active, lab)
        x.add("dabt_engine_queued_depth", "gauge", "accepted-but-unslotted requests", eng.queued_depth(), lab)
        x.add("dabt_engine_healthy", "gauge", "engine liveness predicate (1=serving)", sup["healthy"], lab)
        x.add("dabt_engine_degraded", "gauge", "restart circuit open", sup["degraded"], lab)
        x.add("dabt_engine_heartbeat_age_seconds", "gauge", "engine loop heartbeat age", sup["loop_heartbeat_age_s"], lab)
        x.add("dabt_engine_restarts_total", "counter", "crash-only engine restarts", sup["engine_restarts"], lab)
        x.add("dabt_engine_poisoned_requests_total", "counter", "requests quarantined as poison", sup["poisoned_requests"], lab)
        x.add("dabt_engine_circuit_trips_total", "counter", "restart-circuit trips", sup["circuit_trips"], lab)
        x.add("dabt_engine_restart_resubmitted_total", "counter", "token-less requests salvaged across restarts", sup["restarted_requests_resubmitted"], lab)
        x.add("dabt_engine_reclaimed_slots_total", "counter", "slots reclaimed before finish (deadline/cancel)", eng.reclaimed_slots, lab)
        dec = eng.decode_path_stats()
        x.add("dabt_decode_steps", "gauge", "configured fused decode-tick depth", dec.get("decode_steps"), lab)
        x.add("dabt_decode_steps_effective", "gauge", "decode steps the last tick actually ran", dec.get("decode_steps_effective"), lab)
        x.add("dabt_weight_bits", "gauge", "decode weight format width in bits (16/8/4)", dec.get("weight_bits"), lab)
        x.add("dabt_upload_overlap_frac", "gauge", "sampling/block-table upload cycles overlapped with an in-flight tick", dec.get("upload_overlap_frac"), lab)
        x.add("dabt_prefill_displacement_frac", "gauge", "fraction of decode ticks displaced by a sequential prefill chunk", dec.get("prefill_displacement_frac"), lab)
        x.add("dabt_prefill_chunks_piggybacked_total", "counter", "prefill chunks run inside a fused decode tick", dec.get("prefill_chunks_piggybacked"), lab)
        x.add("dabt_prefill_piggyback", "gauge", "piggybacked-prefill program built for this engine", dec.get("prefill_piggyback"), lab)
        sched = getattr(eng, "scheduler", None)
        if sched is not None:
            st = sched.stats()
            x.add("dabt_sched_queue_depth", "gauge", "admission queue depth", st["queue_depth"], lab)
            x.add("dabt_sched_pressure", "gauge", "queue depth / max_queue", st["pressure"], lab)
            x.add("dabt_sched_est_wait_seconds", "gauge", "estimated queue wait", st["est_wait_s"], lab)
            x.add("dabt_sched_degraded", "gauge", "degradation band active", st["degraded"], lab)
            for reason, n in sorted(st["shed"].items()):
                x.add("dabt_sched_shed_total", "counter", "requests shed at admission, by reason", n, {**lab, "reason": reason})
            for cls, n in sorted(st["admitted"].items()):
                x.add("dabt_sched_admitted_total", "counter", "requests admitted, by class", n, {**lab, "class": cls})
        kv = eng.kv_stats()
        x.add("dabt_kv_prefix_hits_total", "counter", "prefix-cache hits", kv.get("prefix_hits"), lab)
        x.add("dabt_kv_prefix_misses_total", "counter", "prefix-cache misses", kv.get("prefix_misses"), lab)
        x.add("dabt_kv_pages_used", "gauge", "KV pool pages in use", kv.get("kv_pages_used"), lab)
        x.add("dabt_kv_pages_free", "gauge", "KV pool pages free", kv.get("kv_pages_free"), lab)
        x.add("dabt_kv_pages_total", "gauge", "KV pool size in pages", kv.get("kv_pages_total"), lab)
        x.add("dabt_kv_shared_pages", "gauge", "KV pool pages held by the prefix registry", kv.get("kv_shared_pages"), lab)
        x.add("dabt_kv_cow_copies_total", "counter", "boundary pages cloned for a prefix sharer", kv.get("kv_cow_copies"), lab)
        x.add("dabt_kv_evictions_total", "counter", "prefix registry entries evicted", kv.get("kv_evictions"), lab)
        spec = eng.spec_stats() if callable(getattr(eng, "spec_stats", None)) else None
        if spec is not None:
            x.add("dabt_spec_drafted_total", "counter", "speculative tokens drafted", spec["spec_drafted"], lab)
            x.add("dabt_spec_accepted_total", "counter", "speculative tokens accepted", spec["spec_accepted"], lab)
            x.add("dabt_spec_accept_rate", "gauge", "cumulative speculative accept rate", spec["spec_accept_rate"], lab)
            x.add("dabt_spec_tree_width", "gauge", "speculative tree width the controller currently issues", spec.get("spec_tree_width"), lab)
            x.add("dabt_spec_tree_depth", "gauge", "speculative tree depth (K) the controller currently issues", spec.get("spec_tree_depth"), lab)
            x.add("dabt_spec_verify_steps", "gauge", "scanned verify passes per speculative tick (decode_steps)", eng.decode_steps, lab)
        obs = getattr(eng, "obs", None)
        if obs is not None:
            x.add_histogram("dabt_ttft_seconds", "time to first token (submit -> first host token)", obs.ttft_s, lab)
            x.add_histogram("dabt_itl_seconds", "inter-token latency (host batch-arrival gaps)", obs.itl_s, lab)
            x.add_histogram("dabt_queue_wait_seconds", "admission queue wait (submit -> prefill start)", obs.queue_wait_s, lab)
            x.add_histogram("dabt_tick_seconds", "decode tick result wait in _process_tick", obs.tick_s, lab)
            x.add_histogram("dabt_spec_tick_accept_ratio", "per-tick speculative accept ratio (greedy rows)", obs.accept_ratio, lab)
            x.add("dabt_traces_total", "counter", "completed request traces recorded", obs.traces_total, lab)
            x.add("dabt_flight_dumps_total", "counter", "flight-recorder dumps written", obs.flight.dumps, lab)
    for model, emb in sorted(getattr(registry, "embedders", {}).items()):
        lab = {"model": model}
        x.add("dabt_embed_queue_depth", "gauge", "embedding coalescer queue depth", emb._queue.qsize(), lab)
        x.add("dabt_embed_shed_total", "counter", "embedding requests shed", emb.shed, lab)
    return x.render()
