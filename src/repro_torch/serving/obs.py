"""Observability for the port's serving stack: metrics registry, request
lifecycle tracer, SLO tracker and a zero-overhead-off recorder — the port's
own copy of ``repro.serving.obs`` (pure host code, no torch).

  * **MetricsRegistry** — process-local monotonic counters, gauges and
    fixed-bucket latency histograms, exported as a Prometheus
    text-format exposition snapshot (:meth:`MetricsRegistry.to_prometheus`).
  * **Tracer** — per-request lifecycle spans
    (``queued → prefill[chunk i] → decode/spec-round → swapped →
    finish|cancel``) with monotonic timestamps, exported as Chrome
    trace-event JSON (:meth:`Tracer.to_chrome`) loadable in Perfetto /
    ``chrome://tracing``.
  * **Recorder** — the engine-facing facade both feed through.  Engines,
    the scheduler and the page allocator hold a recorder and call its
    ``on_*`` hooks; every hook site is guarded by ``if obs:`` so the
    default :class:`NullRecorder` (which is *falsy*) adds exactly one
    truthiness check of host work and **no device syncs** when
    observability is off.

Metric names, labels, buckets and help strings are the JAX package's
letter for letter, so both packages' expositions of the same hook sequence
are byte-equal (``tests/test_torch_obs.py``).

Overhead policy: the recorder only ever runs on the host, *around* the
engines' step programs (outside every captured graph — a hook inside one
would run once, at capture, and never on a replay).  It never synchronises
the device while serving (an attached kernel profiler waits once when it
is attached, at ``reset()`` and at an export, to resolve its events),
never reads tensor values and never changes batch composition, so
streams are bit-equal with recording on.  Timestamps around a program
call measure staging plus the replay's launch, and whatever host-side sync
the engine already does (the sampled tokens come to the host each step,
which is a natural sync point).

Compile-cache misses: a JAX engine counts the growth of a jitted
function's compile cache at each dispatch site; the port counts how often
a :class:`~repro_torch.serving.programs.StepProgram` builds (a capture on
the card, the first call for an input signature on the CPU), under the
same ``site`` labels.

Also here: the leveled logger — ``REPRO_LOG=debug|info|quiet`` (default
``info``).

Validate exported artifacts from the command line::

    python -m repro_torch.serving.obs --metrics metrics.prom \
        --trace trace.json
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import math
import os
import re
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from repro_torch.annotate import annotate

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "Tracer",
    "Span", "Recorder", "NullRecorder", "NULL_RECORDER", "SloThresholds",
    "SloTracker", "log", "log_enabled", "summary_table", "slo_report",
    "validate_prometheus", "validate_chrome_trace", "profiler_offset_us",
]


# ---------------------------------------------------------------------------
# Leveled logging (REPRO_LOG=debug|info|quiet).
# ---------------------------------------------------------------------------

_LOG_LEVELS = {"debug": 10, "info": 20, "quiet": 100}


def _log_threshold() -> int:
    return _LOG_LEVELS.get(os.environ.get("REPRO_LOG", "info").strip().lower(),
                           _LOG_LEVELS["info"])


def log_enabled(level: str = "info") -> bool:
    return _LOG_LEVELS[level] >= _log_threshold()


def log(tag: str, msg: str, *, level: str = "info") -> None:
    """``[tag] msg`` to stdout when ``level`` clears ``REPRO_LOG``.

    The default (``info`` under the default threshold) prints exactly the
    bytes the historical ``print(f"[serve] ...")`` sites did, so CI greps
    keep working; ``REPRO_LOG=quiet`` silences telemetry chatter and
    ``REPRO_LOG=debug`` admits per-step diagnostics."""
    if log_enabled(level):
        print(f"[{tag}] {msg}")


# ---------------------------------------------------------------------------
# Metrics: counters, gauges, fixed-bucket histograms.
# ---------------------------------------------------------------------------

# latency buckets (seconds): ~exponential from 0.5 ms to 30 s
LATENCY_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)
# decode-batch occupancy buckets (rows)
OCCUPANCY_BUCKETS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)


class Counter:
    """Monotonic counter (Prometheus convention: name ends ``_total``)."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (n={n})")
        self.value += n

    def reset(self) -> None:
        self.value = 0.0


class Gauge:
    """Point-in-time value (pool occupancy, fragmentation, ...)."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def reset(self) -> None:
        self.value = 0.0


class Histogram:
    """Fixed-bucket histogram with cumulative Prometheus semantics.

    ``buckets`` are upper bounds (``le``); an implicit ``+Inf`` bucket is
    always appended.  ``observe`` is O(log buckets) host work.
    """

    __slots__ = ("name", "labels", "buckets", "counts", "sum", "count")

    def __init__(self, name: str, buckets=LATENCY_BUCKETS,
                 labels: Tuple[Tuple[str, str], ...] = ()):
        if list(buckets) != sorted(buckets):
            raise ValueError(f"histogram {name}: buckets must be sorted")
        self.name = name
        self.labels = labels
        self.buckets = tuple(float(b) for b in buckets)
        self.counts = [0] * (len(self.buckets) + 1)  # + the +Inf bucket
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.counts[bisect.bisect_left(self.buckets, v)] += 1
        self.sum += v
        self.count += 1

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Approximate quantile by linear interpolation within the
        winning bucket (the standard Prometheus ``histogram_quantile``
        estimate); 0.0 when empty.  Observations landing in the implicit
        ``+Inf`` bucket clamp to the top finite bucket edge — there is no
        upper bound to interpolate toward, so fabricating one would
        report latencies that never happened."""
        if not self.count:
            return 0.0
        rank = min(1.0, max(0.0, q)) * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            if seen + c >= rank and c:
                if i >= len(self.buckets):
                    return self.buckets[-1]
                lo = self.buckets[i - 1] if i > 0 else 0.0
                hi = self.buckets[i]
                return lo + (hi - lo) * max(0.0, rank - seen) / c
            seen += c
        return self.buckets[-1]

    def reset(self) -> None:
        self.counts = [0] * (len(self.buckets) + 1)
        self.sum = 0.0
        self.count = 0


_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")


class MetricsRegistry:
    """Process-local registry keyed by ``(name, sorted labels)``.

    ``counter``/``gauge``/``histogram`` get-or-create (so hot paths can
    cache the returned handle at init and skip the dict lookup), and
    :meth:`to_prometheus` renders the whole registry as a text-format
    exposition snapshot."""

    def __init__(self):
        self._metrics: Dict[Tuple[str, Tuple], object] = {}
        self._help: Dict[str, str] = {}
        self._type: Dict[str, str] = {}

    # -- get-or-create -----------------------------------------------------
    def _get(self, cls, typ, name, help_, labels, **kwargs):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        key = (name, tuple(sorted(labels.items())))
        m = self._metrics.get(key)
        if m is None:
            if self._type.get(name, typ) != typ:
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{self._type[name]}, not {typ}")
            m = cls(name, labels=key[1], **kwargs)
            self._metrics[key] = m
            self._type[name] = typ
            if help_:
                self._help[name] = help_
        return m

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get(Counter, "counter", name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get(Gauge, "gauge", name, help, labels)

    def histogram(self, name: str, help: str = "",
                  buckets=LATENCY_BUCKETS, **labels) -> Histogram:
        return self._get(Histogram, "histogram", name, help, labels,
                         buckets=buckets)

    # -- reads -------------------------------------------------------------
    def value(self, name: str, default: float = 0.0, **labels) -> float:
        """Current value of a counter/gauge (``default`` when absent)."""
        m = self._metrics.get((name, tuple(sorted(labels.items()))))
        return m.value if m is not None else default

    def sum_values(self, name: str) -> float:
        """Sum of a counter family over every label set (e.g. swap bytes
        over both directions)."""
        return sum(m.value for (n, _), m in self._metrics.items()
                   if n == name and isinstance(m, (Counter, Gauge)))

    def find(self, name: str) -> List[object]:
        return [m for (n, _), m in self._metrics.items() if n == name]

    def metrics(self) -> List[object]:
        return list(self._metrics.values())

    def reset(self) -> None:
        for m in self._metrics.values():
            m.reset()

    # -- Prometheus text exposition ---------------------------------------
    @staticmethod
    def _fmt_labels(labels, extra: str = "") -> str:
        parts = []
        for k, v in labels:
            escaped = (str(v).replace("\\", "\\\\").replace('"', '\\"')
                       .replace("\n", "\\n"))
            parts.append(f'{k}="{escaped}"')
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    @staticmethod
    def _fmt_num(v: float) -> str:
        f = float(v)
        return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)

    def to_prometheus(self) -> str:
        """Text-format exposition (version 0.0.4) of the whole registry."""
        by_name: Dict[str, List] = {}
        for (name, _), m in sorted(self._metrics.items()):
            by_name.setdefault(name, []).append(m)
        out: List[str] = []
        for name, ms in by_name.items():
            help_ = self._help.get(name, "")
            if help_:
                out.append(f"# HELP {name} {help_}")
            out.append(f"# TYPE {name} {self._type[name]}")
            for m in ms:
                if isinstance(m, Histogram):
                    cum = 0
                    for le, c in zip(m.buckets, m.counts):
                        cum += c
                        le_label = 'le="%s"' % le
                        out.append(
                            f"{name}_bucket"
                            f"{self._fmt_labels(m.labels, le_label)} {cum}")
                    cum += m.counts[-1]
                    inf_label = 'le="+Inf"'
                    out.append(
                        f"{name}_bucket"
                        f"{self._fmt_labels(m.labels, inf_label)} {cum}")
                    out.append(f"{name}_sum{self._fmt_labels(m.labels)} "
                               f"{self._fmt_num(m.sum)}")
                    out.append(f"{name}_count{self._fmt_labels(m.labels)} "
                               f"{cum}")
                else:
                    out.append(f"{name}{self._fmt_labels(m.labels)} "
                               f"{self._fmt_num(m.value)}")
        return "\n".join(out) + "\n"


# ---------------------------------------------------------------------------
# Tracer: per-request lifecycle spans → Chrome trace-event JSON.
# ---------------------------------------------------------------------------

_PID = 1  # one serving process per trace


class Tracer:
    """Accumulates Chrome trace events (``ph: X`` complete spans and
    ``ph: i`` instants) on a monotonic clock.  ``tid`` is the request
    uid, so Perfetto renders one lane per request; engine-wide events
    (batched decode dispatches) go to the reserved ``tid 0`` lane, the
    kernel profiler's device intervals to a dedicated ``kernels`` lane
    (``KERNEL_TID``) and each step program's staging and launch to a
    ``programs`` lane (``PROGRAM_TID``), so per-lane span-overlap
    validation keeps holding: both nest inside the engine step span on
    ``tid 0`` and would otherwise trip the overlap check.  A span that
    encloses other spans of its own lane (``first_token`` on a request's
    lane) is a ``B``/``E`` pair (:meth:`enclosing`).

    The clock is ``time.perf_counter`` (CLOCK_MONOTONIC).  The epoch is
    taken beside ``time.time_ns()`` (CLOCK_REALTIME) and both go out in
    ``otherData["clock_pair"]``: a ``torch.profiler`` trace stamps
    realtime µs less its ``baseTimeNanoseconds``, so adding
    :func:`profiler_offset_us` to this trace's timestamps lays it onto
    that one."""

    ENGINE_TID = 0
    KERNEL_TID = 1_000_000_000  # far above any request uid + 1
    PROGRAM_TID = 1_000_000_001

    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self._set_epoch()
        self.events: List[dict] = []
        self._named_tids = set()

    def _set_epoch(self) -> None:
        self._epoch = self._clock()
        self._epoch_ns = time.time_ns()

    def _us(self, ts: float) -> float:
        return round((ts - self._epoch) * 1e6, 3)

    def _name_tid(self, tid: int) -> None:
        if tid not in self._named_tids:
            self._named_tids.add(tid)
            if tid == self.ENGINE_TID:
                name = "engine"
            elif tid == self.KERNEL_TID:
                name = "kernels"
            elif tid == self.PROGRAM_TID:
                name = "programs"
            else:
                name = f"req {tid - 1}"
            self.events.append({"ph": "M", "name": "thread_name",
                                "pid": _PID, "tid": tid,
                                "args": {"name": name}})

    def span(self, tid: int, name: str, t0: float, t1: float,
             **args) -> None:
        self._name_tid(tid)
        ev = {"name": name, "ph": "X", "cat": "serving", "pid": _PID,
              "tid": tid, "ts": self._us(t0),
              "dur": max(0.0, round((t1 - t0) * 1e6, 3))}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def enclosing(self, tid: int, name: str, t0: float, t1: float) -> None:
        """A span that may enclose the lane's complete spans, as a
        ``B``/``E`` pair (duration events nest on a lane; complete spans
        of one lane must not overlap)."""
        self._name_tid(tid)
        for ph, ts in (("B", t0), ("E", t1)):
            self.events.append({"name": name, "ph": ph, "cat": "serving",
                                "pid": _PID, "tid": tid, "ts": self._us(ts)})

    def instant(self, tid: int, name: str, ts: float, **args) -> None:
        self._name_tid(tid)
        ev = {"name": name, "ph": "i", "s": "t", "cat": "serving",
              "pid": _PID, "tid": tid, "ts": self._us(ts)}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def to_chrome(self) -> dict:
        """The trace, ``traceEvents`` sorted by timestamp (metadata
        first) — ready for ``json.dump`` and a Perfetto load."""
        meta = [e for e in self.events if e["ph"] == "M"]
        rest = sorted((e for e in self.events if e["ph"] != "M"),
                      key=lambda e: (e["ts"], e["tid"]))
        return {"traceEvents": meta + rest, "displayTimeUnit": "ms",
                "otherData": {"producer": "repro.serving.obs",
                              "clock_pair": {
                                  "perf_counter_s": self._epoch,
                                  "time_ns": self._epoch_ns}}}

    def reset(self) -> None:
        self.events = []
        self._named_tids = set()
        self._set_epoch()


def profiler_offset_us(trace: dict, profiler_trace: dict) -> float:
    """µs to add to a :class:`Tracer` trace's timestamps to put them on a
    ``torch.profiler`` Chrome trace's timeline (its ``ts`` are realtime µs
    less ``baseTimeNanoseconds``), from the tracer's exported clock pair."""
    wall_ns = trace["otherData"]["clock_pair"]["time_ns"]
    return (wall_ns - int(profiler_trace["baseTimeNanoseconds"])) / 1e3


# ---------------------------------------------------------------------------
# SLO health layer: sliding-window service levels + error budgets.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SloThresholds:
    """Service-level objectives the tracker grades the sliding window
    against.  Zero / ``inf`` disables the corresponding check."""

    ttft_p99_s: float = math.inf   # p99 time-to-first-token ceiling
    tpot_p99_s: float = math.inf   # p99 time-per-output-token ceiling
    min_tok_s: float = 0.0         # window throughput floor
    min_acceptance: float = 0.0    # window speculative-acceptance floor
    budget_target: float = 0.99    # fraction of samples that must meet SLO


class SloTracker:
    """Sliding-window service-level health, fed by :class:`Recorder`.

    Keeps raw samples (not histogram buckets) over the last ``window_s``
    seconds so window quantiles are exact, and publishes gauges into the
    shared registry on every :meth:`snapshot`:

      * ``slo_window_tok_s`` — token throughput over the window;
      * ``slo_ttft_p50_seconds`` / ``slo_ttft_p99_seconds`` and the
        ``tpot`` pair — window latency quantiles;
      * ``slo_window_acceptance`` and ``slo_acceptance_drift`` — window
        speculative acceptance and its drift from the cumulative rate
        (a falling window rate on a healthy cumulative one is the early
        signal that draft quality is degrading);
      * ``slo_error_budget_remaining{slo=...}`` — 1.0 when every window
        sample meets the objective, 0.0 once the violating fraction
        exhausts ``1 - budget_target`` (multi-window burn-rate alerting
        reads exactly this gauge);
      * ``slo_violations_total{slo=...}`` — threshold-crossing events
        (counted once per crossing, not once per snapshot), each paired
        with a ``log("slo", ...)`` warning.

    Pure host bookkeeping: deque appends on the token path, everything
    else deferred to ``snapshot()`` (the ``/slo`` endpoint, the
    ``--slo-report`` summary, and tests call it)."""

    def __init__(self, registry: MetricsRegistry, *,
                 clock=time.perf_counter, window_s: float = 30.0,
                 thresholds: Optional[SloThresholds] = None):
        self.registry = registry
        self.window_s = float(window_s)
        self.thresholds = thresholds or SloThresholds()
        self._clock = clock
        self._tok: deque = deque()      # (ts, n)
        self._ttft: deque = deque()     # (ts, seconds)
        self._tpot: deque = deque()     # (ts, seconds)
        self._acc: deque = deque()      # (ts, proposed, accepted)
        self._violating: set = set()
        r = registry
        self._g_tok_s = r.gauge(
            "slo_window_tok_s", "Generated tokens/s over the SLO window")
        self._g_ttft_p50 = r.gauge(
            "slo_ttft_p50_seconds", "Window TTFT p50")
        self._g_ttft_p99 = r.gauge(
            "slo_ttft_p99_seconds", "Window TTFT p99")
        self._g_tpot_p50 = r.gauge(
            "slo_tpot_p50_seconds", "Window TPOT p50")
        self._g_tpot_p99 = r.gauge(
            "slo_tpot_p99_seconds", "Window TPOT p99")
        self._g_acc = r.gauge(
            "slo_window_acceptance",
            "Speculative acceptance over the SLO window")
        self._g_acc_drift = r.gauge(
            "slo_acceptance_drift",
            "Window acceptance minus cumulative acceptance")
        self._g_budget = {
            name: r.gauge("slo_error_budget_remaining",
                          "Remaining error budget per objective "
                          "(1 = clean window, 0 = budget exhausted)",
                          slo=name)
            for name in ("ttft", "tpot", "tok_s", "acceptance")}
        self._c_violations = {
            name: r.counter("slo_violations_total",
                            "SLO threshold crossings", slo=name)
            for name in ("ttft", "tpot", "tok_s", "acceptance")}

    # -- feeds (called from Recorder hooks; O(1) each) ----------------------
    def note_tokens(self, ts: float, n: int) -> None:
        self._tok.append((ts, n))

    def note_ttft(self, ts: float, seconds: float) -> None:
        self._ttft.append((ts, seconds))

    def note_tpot(self, ts: float, seconds: float) -> None:
        self._tpot.append((ts, seconds))

    def note_acceptance(self, ts: float, proposed: int,
                        accepted: int) -> None:
        if proposed > 0:
            self._acc.append((ts, proposed, accepted))

    # -- window math ---------------------------------------------------------
    def _trim(self, now: float) -> None:
        horizon = now - self.window_s
        for q in (self._tok, self._ttft, self._tpot, self._acc):
            while q and q[0][0] < horizon:
                q.popleft()

    @staticmethod
    def _pct(vals: List[float], q: float) -> float:
        if not vals:
            return 0.0
        s = sorted(vals)
        return s[min(len(s) - 1, max(0, math.ceil(q * len(s)) - 1))]

    def _budget(self, vals: List[float], ok) -> float:
        """Error budget remaining: 1 − (violating fraction / allowed
        fraction), clamped to [0, 1]; a sample-free window spends
        nothing."""
        if not vals:
            return 1.0
        bad = sum(1 for v in vals if not ok(v)) / len(vals)
        allowed = max(1e-9, 1.0 - self.thresholds.budget_target)
        return max(0.0, min(1.0, 1.0 - bad / allowed))

    def _check(self, name: str, violated: bool, msg: str) -> None:
        if violated and name not in self._violating:
            self._violating.add(name)
            self._c_violations[name].inc()
            log("slo", f"WARNING {msg}")
        elif not violated:
            self._violating.discard(name)

    def snapshot(self, now: Optional[float] = None) -> dict:
        """Trim the window, publish the gauges, fire threshold-crossing
        warnings, and return the health dict the ``/slo`` endpoint
        serves."""
        now = self._clock() if now is None else now
        self._trim(now)
        th = self.thresholds
        # throughput: span from oldest sample (not the full window) so a
        # short burst right after start-up doesn't read as a low rate
        n_tok = sum(n for _, n in self._tok)
        span = (now - self._tok[0][0]) if self._tok else 0.0
        tok_s = n_tok / span if span > 1e-9 else 0.0
        ttft = [v for _, v in self._ttft]
        tpot = [v for _, v in self._tpot]
        ttft_p50, ttft_p99 = self._pct(ttft, 0.5), self._pct(ttft, 0.99)
        tpot_p50, tpot_p99 = self._pct(tpot, 0.5), self._pct(tpot, 0.99)
        w_prop = sum(p for _, p, _ in self._acc)
        w_acc = sum(a for _, _, a in self._acc)
        win_rate = w_acc / w_prop if w_prop else 0.0
        c_prop = self.registry.value("spec_proposed_total")
        c_rate = (self.registry.value("spec_accepted_total") / c_prop
                  if c_prop else 0.0)
        drift = win_rate - c_rate if w_prop else 0.0
        self._g_tok_s.set(tok_s)
        self._g_ttft_p50.set(ttft_p50)
        self._g_ttft_p99.set(ttft_p99)
        self._g_tpot_p50.set(tpot_p50)
        self._g_tpot_p99.set(tpot_p99)
        self._g_acc.set(win_rate)
        self._g_acc_drift.set(drift)
        budgets = {
            "ttft": self._budget(ttft, lambda v: v <= th.ttft_p99_s),
            "tpot": self._budget(tpot, lambda v: v <= th.tpot_p99_s),
            "tok_s": 1.0 if (not self._tok or tok_s >= th.min_tok_s)
            else 0.0,
            "acceptance": 1.0 if (not w_prop
                                  or win_rate >= th.min_acceptance)
            else 0.0,
        }
        for name, b in budgets.items():
            self._g_budget[name].set(b)
        if ttft and math.isfinite(th.ttft_p99_s):
            self._check("ttft", ttft_p99 > th.ttft_p99_s,
                        f"TTFT p99 {ttft_p99 * 1e3:.1f}ms over "
                        f"{th.ttft_p99_s * 1e3:.1f}ms objective")
        if tpot and math.isfinite(th.tpot_p99_s):
            self._check("tpot", tpot_p99 > th.tpot_p99_s,
                        f"TPOT p99 {tpot_p99 * 1e3:.1f}ms over "
                        f"{th.tpot_p99_s * 1e3:.1f}ms objective")
        if self._tok and th.min_tok_s > 0:
            self._check("tok_s", tok_s < th.min_tok_s,
                        f"window throughput {tok_s:.1f} tok/s under "
                        f"{th.min_tok_s:.1f} tok/s objective")
        if w_prop and th.min_acceptance > 0:
            self._check("acceptance", win_rate < th.min_acceptance,
                        f"window acceptance {win_rate:.3f} under "
                        f"{th.min_acceptance:.3f} objective")
        return {
            "window_s": self.window_s,
            "tok_s": tok_s,
            "ttft_p50_s": ttft_p50, "ttft_p99_s": ttft_p99,
            "tpot_p50_s": tpot_p50, "tpot_p99_s": tpot_p99,
            "ttft_samples": len(ttft), "tpot_samples": len(tpot),
            "acceptance": win_rate, "acceptance_drift": drift,
            "error_budget_remaining": budgets,
            "violating": sorted(self._violating),
            "thresholds": dataclasses.asdict(self.thresholds),
        }

    def reset(self) -> None:
        for q in (self._tok, self._ttft, self._tpot, self._acc):
            q.clear()
        self._violating.clear()


def slo_report(slo: "SloTracker") -> str:
    """Fixed-width ``--slo-report`` rendering of one SLO snapshot."""
    s = slo.snapshot()
    rows = [
        ("window", f"{s['window_s']:.0f}s"),
        ("throughput (tok/s)", f"{s['tok_s']:.1f}"),
        ("TTFT p50/p99 (ms)",
         f"{s['ttft_p50_s'] * 1e3:.2f} / {s['ttft_p99_s'] * 1e3:.2f}"
         f"  (n={s['ttft_samples']})"),
        ("TPOT p50/p99 (ms)",
         f"{s['tpot_p50_s'] * 1e3:.2f} / {s['tpot_p99_s'] * 1e3:.2f}"
         f"  (n={s['tpot_samples']})"),
    ]
    if s["acceptance"] or s["acceptance_drift"]:
        rows.append(("acceptance (window, drift)",
                     f"{s['acceptance']:.3f} "
                     f"({s['acceptance_drift']:+.3f} vs cumulative)"))
    rows.append(("error budget ttft/tpot/tok_s/acc",
                 "/".join(f"{s['error_budget_remaining'][k]:.2f}"
                          for k in ("ttft", "tpot", "tok_s",
                                    "acceptance"))))
    rows.append(("violations",
                 ", ".join(s["violating"]) if s["violating"] else "none"))
    width = max(len(k) for k, _ in rows)
    lines = ["── slo health " + "─" * max(0, width + 10 - 14)]
    lines += [f"{k.ljust(width)}  {v}" for k, v in rows]
    lines.append("─" * (width + 10))
    return "\n".join(lines)


class Span:
    """One timed phase of the program, as a context: ``t0``/``t1`` on the
    recorder's clock, a ``torch.profiler`` range of the same name while the
    profiler records (``repro_torch.annotate``), and, where ``tid`` is
    given, a tracer span on that lane at exit.  Sites whose hook writes
    the spans itself (``on_decode``, ``on_prefill``) read ``t0``/``t1``."""

    __slots__ = ("_rec", "name", "tid", "t0", "t1", "_range")

    def __init__(self, rec: "Recorder", name: str, tid: Optional[int]):
        self._rec, self.name, self.tid = rec, name, tid

    def __enter__(self) -> "Span":
        self._range = annotate(self.name)
        self._range.__enter__()
        self.t0 = self._rec.now()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = self._rec.now()
        self._range.__exit__(*exc)
        tracer = self._rec.tracer
        if self.tid is not None and tracer is not None:
            tracer.span(self.tid, self.name, self.t0, self.t1)


# ---------------------------------------------------------------------------
# The recorder: engine-facing facade over registry + tracer.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _ReqState:
    """Host-side per-request lifecycle bookkeeping (uid-keyed)."""
    __slots__ = ("submit_ts", "queued_open", "swap_open", "first_tok_ts",
                 "last_tok_ts", "tokens", "admit_ts")
    submit_ts: float
    queued_open: Optional[float]
    swap_open: Optional[float]
    first_tok_ts: Optional[float]
    last_tok_ts: Optional[float]
    tokens: int
    admit_ts: Optional[float]  # the last admission (traced only)


class Recorder:
    """Live recorder: every hook updates the registry and (when tracing
    is on) the tracer.  Pure host work around compiled programs — no
    device syncs, no array reads, no effect on batch composition."""

    def __init__(self, *, trace: bool = True, clock=time.perf_counter):
        self._clock = clock
        self.registry = MetricsRegistry()
        self.tracer = Tracer(clock=clock) if trace else None
        self._req: Dict[int, _ReqState] = {}
        self._jit_sites: List[list] = []  # [site, fn, last_cache_size]
        r = self.registry
        # request lifecycle
        self._c_submitted = r.counter(
            "serve_requests_submitted_total", "Requests submitted")
        self._c_finished = r.counter(
            "serve_requests_finished_total", "Requests retired (eos/budget)")
        self._c_cancelled = r.counter(
            "serve_requests_cancelled_total", "Requests cancelled")
        self._c_admitted = r.counter(
            "serve_admitted_total", "Admissions (waiting -> prefill)")
        self._c_resumed = r.counter(
            "serve_resumed_total", "Swapped requests resumed")
        self._c_evict_swap = r.counter(
            "serve_evicted_total", "Evictions by kind", kind="swap")
        self._c_evict_restart = r.counter(
            "serve_evicted_total", "Evictions by kind", kind="restart")
        # data movement / pool
        self._c_swap_out_b = r.counter(
            "serve_swap_bytes_total", "Host-swap traffic", direction="out")
        self._c_swap_in_b = r.counter(
            "serve_swap_bytes_total", "Host-swap traffic", direction="in")
        self._g_pool_used = r.gauge(
            "serve_pool_pages_used", "Page-pool pages in use")
        self._g_pool_free = r.gauge(
            "serve_pool_pages_free", "Page-pool pages free")
        self._g_pool_frag = r.gauge(
            "serve_pool_fragmentation",
            "1 - longest contiguous free run / free pages")
        self._c_rollback = r.counter(
            "serve_pages_rollback_total",
            "Pages freed by speculative rollback")
        # prefix-sharing KV reuse
        self._c_prefix_hit = r.counter(
            "serve_prefix_lookups_total", "Prefix-index lookups at admission",
            result="hit")
        self._c_prefix_miss = r.counter(
            "serve_prefix_lookups_total", "Prefix-index lookups at admission",
            result="miss")
        self._c_prefix_tok = r.counter(
            "serve_prefix_reused_tokens_total",
            "Prompt tokens served from cached prefix pages (not prefilled)")
        self._c_prefix_evict = r.counter(
            "serve_prefix_pages_evicted_total",
            "Cached prefix pages reclaimed under pool pressure")
        self._c_cow_clones = r.counter(
            "serve_cow_clones_total",
            "Copy-on-write page clones (partially-shared prefix pages)")
        self._c_cow_bytes = r.counter(
            "serve_cow_bytes_total", "Bytes copied by copy-on-write clones")
        self._h_prefix_len = r.histogram(
            "serve_cached_prefix_tokens",
            "Cached-prefix length matched per admission (tokens)",
            buckets=(0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0,
                     256.0, 512.0, 1024.0))
        # tokens / steps
        self._c_prefill_tok = r.counter(
            "serve_prefill_tokens_total", "Prompt tokens prefilled (chunked)")
        self._c_decode_tok = r.counter(
            "serve_decode_tokens_total", "Tokens emitted by decode/spec rounds")
        self._c_generated_tok = r.counter(
            "serve_generated_tokens_total",
            "All generated tokens (incl. the first token from prefill)")
        self._c_steps_prefill = r.counter(
            "serve_steps_total", "Engine step phases", kind="prefill")
        self._c_steps_decode = r.counter(
            "serve_steps_total", "Engine step phases", kind="decode")
        self._c_steps_spec = r.counter(
            "serve_steps_total", "Engine step phases", kind="spec")
        self._h_occupancy = r.histogram(
            "serve_batch_occupancy", "Decode rows active per batched step",
            buckets=OCCUPANCY_BUCKETS)
        # latency
        self._h_ttft = r.histogram(
            "serve_ttft_seconds", "Submit -> first generated token")
        self._h_tpot = r.histogram(
            "serve_tpot_seconds",
            "Mean time per output token after the first (per request)")
        self._h_itl = r.histogram(
            "serve_itl_seconds", "Gap between consecutive token emissions")
        # speculative decoding
        self._c_spec_round_greedy = r.counter(
            "spec_rounds_total", "Batched draft+verify rounds by program",
            path="greedy")
        self._c_spec_round_sampled = r.counter(
            "spec_rounds_total", "Batched draft+verify rounds by program",
            path="sampled")
        self._c_spec_req_rounds = r.counter(
            "spec_request_rounds_total",
            "Per-request round participations (the PR-5 stats['rounds'])")
        self._c_spec_proposed = r.counter(
            "spec_proposed_total", "Draft tokens offered for verification")
        self._c_spec_accepted = r.counter(
            "spec_accepted_total", "Accepted draft proposals emitted")
        self._c_spec_corrections = r.counter(
            "spec_corrections_total", "Residual correction tokens emitted")
        self._c_spec_bonuses = r.counter(
            "spec_bonuses_total", "Full-acceptance bonus tokens emitted")
        self._c_spec_emitted = r.counter(
            "spec_emitted_total", "Tokens emitted by speculative rounds")
        # compiled-program cache
        self._jit_miss: Dict[str, Counter] = {}
        self._jit_disabled: set = set()
        # deep-observability attachments: a QualityProbe / KernelProfiler
        # set by the launcher; None keeps the hooks no-ops
        self.quality = None
        self._profiler = None
        self.slo = SloTracker(self.registry, clock=clock)

    # -- plumbing ----------------------------------------------------------
    def __bool__(self) -> bool:
        return True

    @property
    def enabled(self) -> bool:
        return True

    def now(self) -> float:
        return self._clock()

    def span(self, name: str, tid: Optional[int] = None) -> Span:
        """A :class:`Span` named ``name``, on lane ``tid`` if given."""
        return Span(self, name, tid)

    @property
    def profiler(self):
        """The attached kernel profiler (``profiler.py``), or None.
        Attaching one ties its device clock to the host clock
        (``KernelProfiler.anchor``: one device sync, outside any window)."""
        return self._profiler

    @profiler.setter
    def profiler(self, prof) -> None:
        self._profiler = prof
        if prof is not None:
            prof.anchor()

    def reset(self) -> None:
        """Zero every metric and drop spans/lifecycle state (benchmarks
        call this after warm-up so warm-up requests don't pollute the
        measured cells).  Build-count baselines are re-snapshotted so
        warm-up captures don't count as misses; the kernel profiler drops
        its unresolved calls and re-anchors its clock."""
        self.registry.reset()
        if self.tracer is not None:
            self.tracer.reset()
        if self._profiler is not None:
            self._profiler.anchor()
        self._req.clear()
        self.slo.reset()
        for site in self._jit_sites:
            size = self._cache_size(site[1])
            if size is not None:
                site[2] = size

    def _state(self, req) -> _ReqState:
        st = self._req.get(req.uid)
        if st is None:
            ts = self.now()
            st = _ReqState(ts, ts, None, None, None, 0, None)
            self._req[req.uid] = st
        return st

    # -- request lifecycle -------------------------------------------------
    def on_submit(self, req) -> None:
        self._c_submitted.inc()
        ts = self.now()
        self._req[req.uid] = _ReqState(ts, ts, None, None, None, 0, None)

    def on_admit(self, req) -> None:
        self._c_admitted.inc()
        st = self._state(req)
        if st.queued_open is not None and self.tracer is not None:
            st.admit_ts = self.now()
            self.tracer.span(req.uid + 1, "queued", st.queued_open,
                             st.admit_ts)
        st.queued_open = None

    def on_resume(self, req) -> None:
        self._c_resumed.inc()
        st = self._state(req)
        if st.swap_open is not None and self.tracer is not None:
            self.tracer.span(req.uid + 1, "swapped", st.swap_open, self.now())
        st.swap_open = None

    def on_evict(self, req, kind: str) -> None:
        """``kind="swap"`` (RUNNING victim: pages to host) or
        ``"restart"`` (PREFILL victim: recompute from scratch)."""
        ts = self.now()
        st = self._state(req)
        if kind == "restart":
            self._c_evict_restart.inc()
            st.queued_open = ts  # back in the waiting queue
        else:
            self._c_evict_swap.inc()
            st.swap_open = ts
        if self.tracer is not None:
            self.tracer.instant(req.uid + 1, f"evict[{kind}]", ts)

    def on_swap_bytes(self, direction: str, nbytes: int) -> None:
        (self._c_swap_out_b if direction == "out"
         else self._c_swap_in_b).inc(nbytes)

    def on_finish(self, req) -> None:
        self._c_finished.inc()
        ts = self.now()
        st = self._req.pop(req.uid, None)
        if st is not None and st.first_tok_ts is not None and st.tokens > 1:
            tpot = (st.last_tok_ts - st.first_tok_ts) / (st.tokens - 1)
            self._h_tpot.observe(tpot)
            self.slo.note_tpot(ts, tpot)
        if self.tracer is not None:
            self.tracer.instant(req.uid + 1, "finish", ts)
        if self.quality is not None:
            self.quality.on_finish(req)

    def on_request_id(self, req, request_id: str) -> None:
        """A client-supplied ``X-Request-Id`` attached to ``req``: mark
        the request's tracer lane so external log correlation can find
        it in the Perfetto view."""
        if self.tracer is not None:
            self.tracer.instant(req.uid + 1, "x-request-id", self.now(),
                                id=str(request_id))

    def on_cancel(self, req) -> None:
        self._c_cancelled.inc()
        ts = self.now()
        st = self._req.pop(req.uid, None)
        if self.tracer is not None:
            if st is not None and st.queued_open is not None:
                self.tracer.span(req.uid + 1, "queued", st.queued_open, ts)
            if st is not None and st.swap_open is not None:
                self.tracer.span(req.uid + 1, "swapped", st.swap_open, ts)
            self.tracer.instant(req.uid + 1, "cancel", ts)

    # -- step phases -------------------------------------------------------
    def on_prefill(self, req, chunk_index: int, n_tokens: int,
                   t0: float, t1: float) -> None:
        self._c_steps_prefill.inc()
        self._c_prefill_tok.inc(n_tokens)
        if self.tracer is not None:
            self.tracer.span(req.uid + 1, f"prefill[{chunk_index}]", t0, t1,
                             tokens=n_tokens)

    def on_decode(self, rows_reqs, t0: float, t1: float, *,
                  name: str = "decode") -> None:
        """One batched decode (or speculative) dispatch: occupancy, a
        ``tid 0`` engine span, and one per-request span (requests in the
        same batch share the step's wall window; per request the spans
        are sequential, so each lane stays non-overlapping)."""
        (self._c_steps_spec if name == "spec-round"
         else self._c_steps_decode).inc()
        self._h_occupancy.observe(len(rows_reqs))
        if self.tracer is not None:
            self.tracer.span(Tracer.ENGINE_TID, name, t0, t1,
                             rows=len(rows_reqs))
            for _row, req in rows_reqs:
                self.tracer.span(req.uid + 1, name, t0, t1)

    def on_tokens(self, req, n: int, ts: float, *,
                  source: str = "decode") -> None:
        """``n`` tokens appended to ``req`` at ``ts``.  First token →
        TTFT and a ``first_token`` span from the request's last admission;
        later emissions → ITL (per-gap, averaged over the ``n`` tokens a
        speculative round lands at once)."""
        if n <= 0:
            return
        self._c_generated_tok.inc(n)
        if source == "decode":
            self._c_decode_tok.inc(n)
        self.slo.note_tokens(ts, n)
        st = self._state(req)
        if st.first_tok_ts is None:
            st.first_tok_ts = ts
            self._h_ttft.observe(ts - st.submit_ts)
            self.slo.note_ttft(ts, ts - st.submit_ts)
            if st.admit_ts is not None and self.tracer is not None:
                self.tracer.enclosing(req.uid + 1, "first_token",
                                      st.admit_ts, ts)
            gap_n = n - 1
        else:
            gap_n = n
        if gap_n > 0 and st.last_tok_ts is not None:
            gap = max(0.0, ts - st.last_tok_ts) / gap_n
            for _ in range(gap_n):
                self._h_itl.observe(gap)
        st.last_tok_ts = ts
        st.tokens += n

    # -- pool / allocator --------------------------------------------------
    def sample_pool(self, allocator) -> None:
        """Gauge snapshot of the page pool: used/free and a fragmentation
        score (1 - longest contiguous free run / free pages — 0 when the
        free set is one run or empty)."""
        free = allocator.free_pages()
        self._g_pool_used.set(allocator.in_use)
        self._g_pool_free.set(len(free))
        frag = 0.0
        if free:
            longest = run = 1
            prev = None
            for p in sorted(free):
                run = run + 1 if prev is not None and p == prev + 1 else 1
                longest = max(longest, run)
                prev = p
            frag = 1.0 - longest / len(free)
        self._g_pool_frag.set(frag)

    def on_alloc(self, n: int) -> None:
        self.registry.counter("alloc_pages_alloc_total",
                              "Pages handed out by the allocator").inc(n)

    def on_alloc_fail(self, n: int) -> None:
        self.registry.counter(
            "alloc_fail_total",
            "Allocation requests the pool could not satisfy (page "
            "faults drive eviction)").inc()

    def on_free(self, n: int) -> None:
        self.registry.counter("alloc_pages_freed_total",
                              "Pages returned to the allocator").inc(n)

    def on_rollback(self, n_pages: int) -> None:
        if n_pages:
            self._c_rollback.inc(n_pages)

    # -- prefix-sharing KV reuse -------------------------------------------
    def on_prefix_lookup(self, covered: int, n_full_pages: int,
                         partial: bool) -> None:
        """One admission-time prefix-index lookup: ``covered`` prompt
        tokens were served from cached pages (0 = miss)."""
        (self._c_prefix_hit if covered > 0 else self._c_prefix_miss).inc()
        if covered > 0:
            self._c_prefix_tok.inc(covered)
        self._h_prefix_len.observe(float(covered))

    def on_prefix_evict(self, n_pages: int) -> None:
        self._c_prefix_evict.inc(n_pages)

    def on_cow_clone(self, nbytes: int) -> None:
        self._c_cow_clones.inc()
        self._c_cow_bytes.inc(nbytes)

    # -- speculative decoding ----------------------------------------------
    def on_spec_round(self, path: str) -> None:
        (self._c_spec_round_greedy if path == "greedy"
         else self._c_spec_round_sampled).inc()

    def on_spec_row(self, proposed: int, accepted: int, corrections: int,
                    bonuses: int, emitted: int) -> None:
        self._c_spec_req_rounds.inc()
        self._c_spec_proposed.inc(proposed)
        self._c_spec_accepted.inc(accepted)
        self._c_spec_corrections.inc(corrections)
        self._c_spec_bonuses.inc(bonuses)
        self._c_spec_emitted.inc(emitted)
        self.slo.note_acceptance(self.now(), proposed, accepted)

    # -- compiled-program cache misses --------------------------------------
    @staticmethod
    def _cache_size(fn) -> Optional[int]:
        """Build count of a step program (``StepProgram.builds``: captures
        on the card, first calls per input signature on the CPU), or
        ``None`` when ``fn`` keeps none — the caller then marks the site
        *disabled*, so its miss counter is absent instead of lying."""
        n = getattr(fn, "builds", None)
        return n if isinstance(n, int) else None

    def register_jit_site(self, site: str, fn) -> None:
        """Track a step program's builds around the engine's dispatch
        sites; growth between polls is a compile-cache miss (a new
        capture, or a new input signature on the CPU).  Several programs
        may share one site (the JAX sampler is one jitted function, the
        port has one program per batch shape).  Sites whose callable keeps
        no build count register as disabled:
        they are skipped by :meth:`poll_jit` (one debug log, no crash,
        no counter samples)."""
        baseline = self._cache_size(fn)
        if baseline is None:
            if site not in self._jit_disabled:
                self._jit_disabled.add(site)
                log("obs", f"jit cache probe unavailable for site "
                    f"{site!r}; miss counter disabled", level="debug")
            return
        self._jit_miss.setdefault(site, self.registry.counter(
            "jit_cache_misses_total",
            "Compile-cache misses at instrumented dispatch sites",
            site=site))
        for entry in self._jit_sites:
            if entry[0] == site and entry[1] is fn:
                return  # engines sharing a recorder register common sites
        self._jit_sites.append([site, fn, baseline])

    def poll_jit(self) -> None:
        for entry in self._jit_sites:
            size = self._cache_size(entry[1])
            if size is None:
                continue  # probe vanished mid-flight: degrade, don't crash
            if size > entry[2]:
                self._jit_miss[entry[0]].inc(size - entry[2])
                entry[2] = size

    # -- export ------------------------------------------------------------
    def _flush(self) -> None:
        if self._profiler is not None:
            self._profiler.flush()  # the calls whose device time is pending

    def to_prometheus(self) -> str:
        self._flush()
        return self.registry.to_prometheus()

    def to_chrome(self) -> dict:
        if self.tracer is None:
            raise RuntimeError("recorder was built with trace=False")
        self._flush()
        return self.tracer.to_chrome()

    def write_metrics(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.to_prometheus())

    def write_trace(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)


class NullRecorder:
    """The default: falsy, and every hook is the same shared no-op.

    Engines guard every instrumentation site with ``if obs:`` — with a
    ``NullRecorder`` that is ONE host boolean check and nothing else: no
    metric lookup, no timestamp, no allocation, no device sync.  The
    no-op methods exist anyway so an unguarded call is still harmless.
    """

    __slots__ = ()
    enabled = False

    def __bool__(self) -> bool:
        return False

    @staticmethod
    def _noop(*args, **kwargs) -> None:
        return None

    def __getattr__(self, name: str):
        if name.startswith("__"):
            raise AttributeError(name)
        return self._noop


NULL_RECORDER = NullRecorder()


# ---------------------------------------------------------------------------
# Human-readable summary (the `--metrics` table).
# ---------------------------------------------------------------------------


# metric families the curated summary rows already fold in; everything
# else renders in the sorted detail section below them
_SUMMARY_CURATED = frozenset({
    "serve_requests_submitted_total", "serve_requests_finished_total",
    "serve_requests_cancelled_total", "serve_prefill_tokens_total",
    "serve_decode_tokens_total", "serve_generated_tokens_total",
    "serve_ttft_seconds", "serve_tpot_seconds", "serve_itl_seconds",
    "serve_batch_occupancy", "serve_pool_pages_used",
    "serve_pool_pages_free", "serve_pool_fragmentation",
    "serve_swap_bytes_total", "serve_evicted_total",
    "serve_prefix_lookups_total", "serve_cached_prefix_tokens",
    "serve_prefix_reused_tokens_total", "serve_cow_clones_total",
    "serve_cow_bytes_total", "spec_proposed_total", "spec_accepted_total",
    "spec_request_rounds_total", "spec_rounds_total",
    "jit_cache_misses_total",
})


def summary_table(registry: MetricsRegistry) -> str:
    """Fixed-width summary of the serving snapshot: request counts,
    token counters, TTFT/TPOT/ITL histogram stats, batch occupancy,
    page-pool gauges, swap traffic, speculative acceptance and jit
    cache misses — all read from the registry (one source of truth
    with the Prometheus exposition and the benchmark cells).

    Deterministically ordered: the curated headline rows are a fixed
    sequence, and every remaining non-zero metric renders below them
    sorted by metric name then labels, so CI stream diffs of two runs
    over the same workload are stable regardless of metric-registration
    order."""
    v = registry.value
    rows: List[Tuple[str, str]] = []

    def hist(name: str) -> Optional[Histogram]:
        ms = registry.find(name)
        return ms[0] if ms else None

    rows.append(("requests submitted/finished/cancelled",
                 f"{v('serve_requests_submitted_total'):.0f} / "
                 f"{v('serve_requests_finished_total'):.0f} / "
                 f"{v('serve_requests_cancelled_total'):.0f}"))
    rows.append(("tokens prefill/decode/generated",
                 f"{v('serve_prefill_tokens_total'):.0f} / "
                 f"{v('serve_decode_tokens_total'):.0f} / "
                 f"{v('serve_generated_tokens_total'):.0f}"))
    for name, label in (("serve_ttft_seconds", "TTFT"),
                        ("serve_tpot_seconds", "TPOT"),
                        ("serve_itl_seconds", "ITL")):
        h = hist(name)
        if h is not None and h.count:
            rows.append((
                f"{label} p50/p90/p99 (ms)",
                f"{h.quantile(0.5) * 1e3:.2f} / {h.quantile(0.9) * 1e3:.2f} "
                f"/ {h.quantile(0.99) * 1e3:.2f}  (n={h.count})"))
    occ = hist("serve_batch_occupancy")
    if occ is not None and occ.count:
        rows.append(("batch occupancy mean (rows)",
                     f"{occ.mean:.2f}  over {occ.count} steps"))
    rows.append(("page pool used/free",
                 f"{v('serve_pool_pages_used'):.0f} / "
                 f"{v('serve_pool_pages_free'):.0f} "
                 f"(frag {v('serve_pool_fragmentation'):.2f})"))
    swap = (registry.value("serve_swap_bytes_total", direction="out")
            + registry.value("serve_swap_bytes_total", direction="in"))
    if swap:
        rows.append(("host-swap bytes out/in",
                     f"{registry.value('serve_swap_bytes_total', direction='out'):.0f} / "
                     f"{registry.value('serve_swap_bytes_total', direction='in'):.0f}"))
    evic = (registry.value("serve_evicted_total", kind="swap")
            + registry.value("serve_evicted_total", kind="restart"))
    if evic:
        rows.append(("evictions swap/restart",
                     f"{registry.value('serve_evicted_total', kind='swap'):.0f} / "
                     f"{registry.value('serve_evicted_total', kind='restart'):.0f}"))
    lookups = (registry.value("serve_prefix_lookups_total", result="hit")
               + registry.value("serve_prefix_lookups_total", result="miss"))
    if lookups:
        plen = hist("serve_cached_prefix_tokens")
        rows.append((
            "prefix cache hit/miss (reused tokens)",
            f"{registry.value('serve_prefix_lookups_total', result='hit'):.0f}"
            f" / "
            f"{registry.value('serve_prefix_lookups_total', result='miss'):.0f}"
            f"  ({v('serve_prefix_reused_tokens_total'):.0f} tokens, "
            f"mean {plen.mean if plen and plen.count else 0.0:.1f}/adm)"))
        if v("serve_cow_clones_total"):
            rows.append(("cow clones (bytes)",
                         f"{v('serve_cow_clones_total'):.0f} "
                         f"({v('serve_cow_bytes_total'):.0f})"))
    proposed = v("spec_proposed_total")
    if proposed:
        rows.append(("speculative acceptance",
                     f"{v('spec_accepted_total') / proposed:.3f} "
                     f"({v('spec_accepted_total'):.0f}/{proposed:.0f} over "
                     f"{v('spec_request_rounds_total'):.0f} request-rounds)"))
        rows.append(("speculative rounds greedy/sampled",
                     f"{registry.value('spec_rounds_total', path='greedy'):.0f} / "
                     f"{registry.value('spec_rounds_total', path='sampled'):.0f}"))
    misses = registry.sum_values("jit_cache_misses_total")
    rows.append(("jit compile-cache misses", f"{misses:.0f}"))
    # detail section: every family the curated rows don't fold in, in
    # sorted (name, labels) order, zero-valued entries elided
    detail: List[Tuple[str, str]] = []
    for (name, labels), m in sorted(registry._metrics.items()):
        if name in _SUMMARY_CURATED:
            continue
        key = name + MetricsRegistry._fmt_labels(labels)
        if isinstance(m, Histogram):
            if m.count:
                detail.append((key, f"mean {m.mean:.4g}  (n={m.count})"))
        elif m.value:
            detail.append((key, MetricsRegistry._fmt_num(m.value)))
    rows += detail
    width = max(len(k) for k, _ in rows)
    lines = ["── serving metrics " + "─" * max(0, width + 10 - 19)]
    lines += [f"{k.ljust(width)}  {val}" for k, val in rows]
    lines.append("─" * (width + 10))
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Validators (tests + the obs-smoke CI job).
# ---------------------------------------------------------------------------

_PROM_LINE_RE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*"
    r'(\{[a-zA-Z_][a-zA-Z0-9_]*="(\\.|[^"\\])*"'
    r'(,[a-zA-Z_][a-zA-Z0-9_]*="(\\.|[^"\\])*")*\})?'
    r" [0-9eE+.\-]+(?: [0-9]+)?$")


def validate_prometheus(text: str) -> List[str]:
    """Syntax + histogram-invariant check of a text exposition; returns
    a list of problems (empty = valid)."""
    errors: List[str] = []
    hist_buckets: Dict[str, List[Tuple[float, float]]] = {}
    for i, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            if not re.match(r"^# (HELP|TYPE) [a-zA-Z_:][a-zA-Z0-9_:]* ",
                            line):
                errors.append(f"line {i}: malformed comment: {line!r}")
            continue
        if not _PROM_LINE_RE.match(line):
            errors.append(f"line {i}: malformed sample: {line!r}")
            continue
        name = re.split(r"[{ ]", line, maxsplit=1)[0]
        value = float(line.rsplit(" ", 1)[-1])
        if name.endswith("_bucket"):
            m = re.search(r'le="([^"]+)"', line)
            if not m:
                errors.append(f"line {i}: histogram bucket without le=")
                continue
            le = float("inf") if m.group(1) == "+Inf" else float(m.group(1))
            base = name[: -len("_bucket")] + line.split("{", 1)[1].split(
                "le=", 1)[0]
            hist_buckets.setdefault(base, []).append((le, value))
    for base, buckets in hist_buckets.items():
        buckets.sort(key=lambda x: x[0])
        cum = [c for _, c in buckets]
        if cum != sorted(cum):
            errors.append(f"{base}: bucket counts not monotone: {cum}")
        if buckets and buckets[-1][0] != float("inf"):
            errors.append(f"{base}: missing +Inf bucket")
    return errors


def validate_chrome_trace(obj: dict) -> List[str]:
    """Schema + per-request invariant check of a Chrome trace: required
    keys per event, and complete spans sorted and non-overlapping within
    every request lane.  Returns a list of problems (empty = valid)."""
    errors: List[str] = []
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        return ["missing traceEvents key"]
    per_tid: Dict[int, List[Tuple[float, float, str]]] = {}
    for i, ev in enumerate(obj["traceEvents"]):
        ph = ev.get("ph")
        if ph not in ("X", "i", "M", "B", "E"):
            errors.append(f"event {i}: unknown ph {ph!r}")
            continue
        if "name" not in ev or "pid" not in ev:
            errors.append(f"event {i}: missing name/pid")
            continue
        if ph == "M":
            continue
        if "ts" not in ev or "tid" not in ev:
            errors.append(f"event {i}: missing ts/tid")
            continue
        if ph == "X":
            if "dur" not in ev or ev["dur"] < 0:
                errors.append(f"event {i}: complete span without dur")
                continue
            per_tid.setdefault(ev["tid"], []).append(
                (ev["ts"], ev["ts"] + ev["dur"], ev["name"]))
    events = [e for e in obj["traceEvents"] if e.get("ph") != "M"]
    ts_list = [e["ts"] for e in events if "ts" in e]
    if ts_list != sorted(ts_list):
        errors.append("traceEvents not sorted by ts")
    for tid, spans in per_tid.items():
        spans.sort()
        for (s0, e0, n0), (s1, e1, n1) in zip(spans, spans[1:]):
            if s1 < e0 - 1e-9:
                errors.append(
                    f"tid {tid}: span {n1!r} [{s1},{e1}] overlaps "
                    f"{n0!r} [{s0},{e0}]")
    return errors


def _main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Validate exported observability artifacts")
    ap.add_argument("--metrics", help="Prometheus text exposition file")
    ap.add_argument("--trace", help="Chrome trace-event JSON file")
    args = ap.parse_args(argv)
    if not args.metrics and not args.trace:
        ap.error("nothing to validate (pass --metrics and/or --trace)")
    rc = 0
    if args.metrics:
        text = open(args.metrics).read()
        errs = validate_prometheus(text)
        n = sum(1 for ln in text.splitlines()
                if ln.strip() and not ln.startswith("#"))
        if errs:
            rc = 1
            for e in errs:
                print(f"[obs] metrics INVALID: {e}")
        else:
            print(f"[obs] metrics OK: {n} samples parse, histogram "
                  "invariants hold")
    if args.trace:
        obj = json.load(open(args.trace))
        errs = validate_chrome_trace(obj)
        if errs:
            rc = 1
            for e in errs:
                print(f"[obs] trace INVALID: {e}")
        else:
            print(f"[obs] trace OK: {len(obj['traceEvents'])} events, "
                  "spans sorted and non-overlapping per request")
    return rc


if __name__ == "__main__":
    raise SystemExit(_main())
