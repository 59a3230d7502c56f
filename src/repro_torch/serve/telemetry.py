"""Bounded serving telemetry: streaming histograms, SLO counters, exports.

Copy of ``repro/serve/telemetry.py`` (numpy only), with the port's import
paths.

The metrics layer used to keep every TTFT/queue-wait/latency sample in
an unbounded python list — a million-request run would OOM the host just
to answer a p95 question at drain time. This module replaces those lists
with **streaming histograms**: exact samples below a small cap (so short
runs and unit tests keep exact percentiles), fixed log-spaced bucket
counts above it (bounded memory forever after).

Everything here is clock-free by construction: values arrive already
measured (the engine's injectable clock is the only time source), so the
whole telemetry path is deterministic under ``VirtualClock`` — no
wall-clock read ever happens in this module.

Exports:

* :class:`StreamingHistogram` — the bounded sample sink.
* :class:`SLOCounters`       — deadline-miss / TTFT / ITL objective
  violations per tenant, fed from the engine's event stream
  (``serve.trace.EventBus``); the deadline comes from the scheduler's
  existing per-request ``deadline`` field.
* :func:`prometheus_text`    — Prometheus-style text exposition of a
  :class:`~repro_torch.serve.metrics.Metrics` collector (+ optional SLO
  counters).
* :class:`TelemetrySnapshotWriter` — periodic JSON snapshot file driven
  by engine time, for scraping a live serve process.
"""
from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Optional

import numpy as np

# Default bucket layout: log-spaced from 1us to 10_000s, 5 buckets per
# decade (ratio ~1.58x) — 50 buckets + underflow + overflow. Wide enough
# for TTFT (ms) and whole-run latencies (s) alike; relative error of a
# bucketed percentile is bounded by the bucket ratio (~26% midpoint),
# which only applies past the exact cap.
DEFAULT_LO = 1e-6
DEFAULT_DECADES = 10
DEFAULT_PER_DECADE = 5

# Exact samples kept before spilling to buckets. Below this, percentiles
# are exact (backward-compatible with the old list-based metrics for
# every test/bench workload); above it, memory stays O(buckets).
DEFAULT_EXACT_CAP = 1024


class StreamingHistogram:
    """Fixed log-bucket histogram with an exact-sample fast path.

    ``record`` keeps raw samples in a list until ``exact_cap``; crossing
    the cap spills them into the bucket counts once and the list is
    dropped — memory is bounded by the (fixed) bucket count from then
    on. ``percentile`` is exact in the first regime and
    bucket-interpolated (geometric bucket midpoint) in the second.
    """

    __slots__ = ("lo", "per_decade", "n_buckets", "counts", "n", "total",
                 "vmin", "vmax", "exact_cap", "_exact")

    def __init__(self, lo: float = DEFAULT_LO,
                 decades: int = DEFAULT_DECADES,
                 per_decade: int = DEFAULT_PER_DECADE,
                 exact_cap: int = DEFAULT_EXACT_CAP):
        self.lo = float(lo)
        self.per_decade = int(per_decade)
        self.n_buckets = int(decades) * int(per_decade)
        # [underflow, n_buckets log buckets, overflow]
        self.counts = np.zeros(self.n_buckets + 2, np.int64)
        self.n = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self.exact_cap = int(exact_cap)
        self._exact: Optional[List[float]] = []

    # -- layout -------------------------------------------------------------
    def bucket_index(self, x: float) -> int:
        """Index into ``counts`` (0 = underflow, last = overflow)."""
        if x <= self.lo:
            return 0
        i = int(math.floor(math.log10(x / self.lo) * self.per_decade))
        return min(i, self.n_buckets) + 1

    def bucket_le(self, i: int) -> float:
        """Inclusive upper bound of counts[i] (+inf for the overflow)."""
        if i <= 0:
            return self.lo
        if i > self.n_buckets:
            return math.inf
        return self.lo * 10.0 ** (i / self.per_decade)

    @property
    def exact(self) -> bool:
        """True while percentiles are computed from raw samples."""
        return self._exact is not None

    # -- recording ----------------------------------------------------------
    def record(self, x: float) -> None:
        x = float(x)
        self.n += 1
        self.total += x
        self.vmin = min(self.vmin, x)
        self.vmax = max(self.vmax, x)
        if self._exact is not None:
            self._exact.append(x)
            if len(self._exact) > self.exact_cap:
                for v in self._exact:      # spill once, then bucket-only
                    self.counts[self.bucket_index(v)] += 1
                self._exact = None
            return
        self.counts[self.bucket_index(x)] += 1

    # -- queries ------------------------------------------------------------
    def percentile(self, q: float) -> Optional[float]:
        """q in [0, 100]; None when empty (matches the old list ``_pct``)."""
        if self.n == 0:
            return None
        if self._exact is not None:
            return float(np.percentile(np.asarray(self._exact, np.float64), q))
        # bucketed: first bucket whose cumulative count crosses the rank
        rank = (q / 100.0) * self.n
        cum = 0
        for i, c in enumerate(self.counts):
            cum += int(c)
            if cum >= rank and c:
                if i == 0:
                    return self.lo
                if i > self.n_buckets:
                    return self.vmax       # overflow: best bound we have
                # geometric midpoint of the bucket
                hi = self.bucket_le(i)
                lo = self.bucket_le(i - 1)
                return math.sqrt(lo * hi)
        return self.vmax

    @property
    def mean(self) -> Optional[float]:
        return self.total / self.n if self.n else None

    def bucket_counts(self) -> np.ndarray:
        """Bucket counts including any still-exact samples (non-destructive)."""
        counts = self.counts.copy()
        if self._exact is not None:
            for v in self._exact:
                counts[self.bucket_index(v)] += 1
        return counts

    def cumulative(self) -> List[tuple]:
        """[(le_bound, cumulative_count)] over non-trivial buckets plus the
        +Inf terminal — the Prometheus histogram exposition shape."""
        counts = self.bucket_counts()
        out = []
        cum = 0
        for i, c in enumerate(counts):
            cum += int(c)
            if c and i <= self.n_buckets:
                out.append((self.bucket_le(i), cum))
        out.append((math.inf, self.n))
        return out

    def merge(self, other: "StreamingHistogram") -> "StreamingHistogram":
        """Pooled histogram (e.g. all-tenant TTFT). Same layout required."""
        if (self.lo, self.per_decade, self.n_buckets) != \
                (other.lo, other.per_decade, other.n_buckets):
            raise ValueError(
                "cannot merge histograms with different layouts: "
                f"(lo, per_decade, n_buckets)="
                f"{(self.lo, self.per_decade, self.n_buckets)} vs "
                f"{(other.lo, other.per_decade, other.n_buckets)}")
        out = StreamingHistogram(self.lo, self.n_buckets // self.per_decade,
                                 self.per_decade, self.exact_cap)
        out.n = self.n + other.n
        out.total = self.total + other.total
        out.vmin = min(self.vmin, other.vmin)
        out.vmax = max(self.vmax, other.vmax)
        if self._exact is not None and other._exact is not None:
            # pooled report stays exact (transient object; cap not enforced
            # so pooling never loses precision the parts still have)
            out._exact = self._exact + other._exact
        else:
            out._exact = None
            out.counts = self.bucket_counts() + other.bucket_counts()
        return out

    @staticmethod
    def merged(hists: List["StreamingHistogram"]) -> "StreamingHistogram":
        if not hists:
            return StreamingHistogram()
        out = hists[0]
        for h in hists[1:]:
            out = out.merge(h)
        return out

    def to_dict(self) -> dict:
        """JSON-able summary (snapshot/export form)."""
        return {
            "count": self.n,
            "sum": self.total,
            "min": self.vmin if self.n else None,
            "max": self.vmax if self.n else None,
            "exact": self.exact,
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "p99": self.percentile(99),
        }


# ---------------------------------------------------------------------------
# SLO counters
# ---------------------------------------------------------------------------
class SLOCounters:
    """Per-tenant SLO violation counters fed from the serve event stream.

    * **deadline misses** — a request finished after its scheduler
      ``deadline`` (the field admission already sorts by; no new
      plumbing). Requests without a deadline never count.
    * **TTFT violations** — first token later than ``ttft_target_s``
      after arrival.
    * **ITL violations** — mean inter-token latency
      ``(latency - ttft) / (tokens - 1)`` above ``itl_target_s``
      (single-token requests have no ITL and never count).

    Consumes the same :class:`~repro_torch.serve.trace.ServeEvent` stream as
    ``Metrics``/``Tracer`` (duck-typed ``consume``), so it can ride the
    engine's event bus with zero engine-side special cases.
    """

    def __init__(self, ttft_target_s: Optional[float] = None,
                 itl_target_s: Optional[float] = None):
        self.ttft_target_s = ttft_target_s
        self.itl_target_s = itl_target_s
        self.deadline_misses: Dict[str, int] = {}
        self.ttft_violations: Dict[str, int] = {}
        self.itl_violations: Dict[str, int] = {}
        self.n_done = 0

    @staticmethod
    def _bump(d: Dict[str, int], tenant: Optional[str]) -> None:
        key = tenant if tenant is not None else "__base__"
        d[key] = d.get(key, 0) + 1

    def consume(self, ev) -> None:
        if ev.kind == "first_token":
            if self.ttft_target_s is not None \
                    and ev.attrs["ttft"] > self.ttft_target_s:
                self._bump(self.ttft_violations, ev.attrs.get("tenant"))
        elif ev.kind == "done":
            self.n_done += 1
            tenant = ev.attrs.get("tenant")
            slack = ev.attrs.get("deadline_slack")
            if slack is not None and slack < 0:
                self._bump(self.deadline_misses, tenant)
            if self.itl_target_s is not None:
                n_tok = ev.attrs.get("n_tokens") or 0
                ttft = ev.attrs.get("ttft")
                if n_tok > 1 and ttft is not None:
                    itl = (ev.attrs["latency"] - ttft) / (n_tok - 1)
                    if itl > self.itl_target_s:
                        self._bump(self.itl_violations, tenant)

    def report(self) -> dict:
        return {
            "requests_done": self.n_done,
            "ttft_target_s": self.ttft_target_s,
            "itl_target_s": self.itl_target_s,
            "deadline_misses": dict(sorted(self.deadline_misses.items())),
            "ttft_violations": dict(sorted(self.ttft_violations.items())),
            "itl_violations": dict(sorted(self.itl_violations.items())),
        }


# ---------------------------------------------------------------------------
# Prometheus-style text exposition
# ---------------------------------------------------------------------------
def _fmt_le(le: float) -> str:
    return "+Inf" if math.isinf(le) else f"{le:.6g}"


def prometheus_text(metrics, slo: Optional[SLOCounters] = None,
                    namespace: str = "repro_serve") -> str:
    """Render a ``Metrics`` collector as Prometheus text exposition.

    Counters for requests/tokens/steps (per tenant and per decode path),
    histograms (cumulative log buckets + _sum/_count) for TTFT, queue
    wait and latency. Pure function of the collector — safe to call any
    time, including from the snapshot writer.
    """
    lines: List[str] = []

    def counter(name: str, value, labels: str = "", help_: str = ""):
        if help_:
            lines.append(f"# HELP {namespace}_{name} {help_}")
        lines.append(f"# TYPE {namespace}_{name} counter")
        lines.append(f"{namespace}_{name}{labels} {value}")

    lines.append(f"# TYPE {namespace}_requests_total counter")
    lines.append(f"# TYPE {namespace}_tokens_total counter")
    for tenant, st in sorted(metrics.tenants.items()):
        lab = f'{{tenant="{tenant}"}}'
        lines.append(f"{namespace}_requests_total{lab} {st.n_requests}")
        lines.append(f"{namespace}_tokens_total{lab} {st.n_tokens}")
    counter("decode_steps_total", metrics.n_decode_steps)
    counter("prefills_total", metrics.n_prefills)
    if getattr(metrics, "decode_paths", None):
        lines.append(f"# TYPE {namespace}_decode_path_steps_total counter")
        for path, n in sorted(metrics.decode_paths.items()):
            lines.append(f"{namespace}_decode_path_steps_total"
                         f'{{path="{path}"}} {n}')

    for hist_name, attr in (("ttft_seconds", "ttfts"),
                            ("queue_wait_seconds", "queue_waits"),
                            ("latency_seconds", "latencies")):
        lines.append(f"# TYPE {namespace}_{hist_name} histogram")
        for tenant, st in sorted(metrics.tenants.items()):
            h: StreamingHistogram = getattr(st, attr)
            for le, cum in h.cumulative():
                lines.append(
                    f'{namespace}_{hist_name}_bucket{{tenant="{tenant}",'
                    f'le="{_fmt_le(le)}"}} {cum}')
            lines.append(f'{namespace}_{hist_name}_sum{{tenant="{tenant}"}} '
                         f"{h.total:.9g}")
            lines.append(f'{namespace}_{hist_name}_count'
                         f'{{tenant="{tenant}"}} {h.n}')

    if slo is not None:
        for name, d in (("deadline_misses_total", slo.deadline_misses),
                        ("ttft_violations_total", slo.ttft_violations),
                        ("itl_violations_total", slo.itl_violations)):
            lines.append(f"# TYPE {namespace}_{name} counter")
            for tenant, n in sorted(d.items()):
                lines.append(f'{namespace}_{name}{{tenant="{tenant}"}} {n}')
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Periodic JSON snapshots
# ---------------------------------------------------------------------------
class TelemetrySnapshotWriter:
    """Write a JSON telemetry snapshot every ``interval_s`` of engine time.

    Driven entirely by the ``now`` values the engine passes in (its
    injectable clock), so snapshots are deterministic under
    ``VirtualClock`` and the writer itself never reads a clock. Files
    are written atomically (tmp + rename) so a scraper never sees a
    torn snapshot.
    """

    def __init__(self, path: str, interval_s: float):
        if interval_s <= 0:
            raise ValueError(f"interval_s={interval_s} must be > 0")
        self.path = path
        self.interval_s = float(interval_s)
        self.last_write_t: Optional[float] = None
        self.n_written = 0

    def maybe_write(self, now: float, payload_fn) -> bool:
        """Write if the interval elapsed; ``payload_fn()`` builds the body
        lazily (only called when actually writing). Returns True on write."""
        if self.last_write_t is not None \
                and now - self.last_write_t < self.interval_s:
            return False
        self.write(now, payload_fn())
        return True

    def write(self, now: float, payload: dict) -> None:
        body = {"t": now, "seq": self.n_written, **payload}
        tmp = f"{self.path}.tmp"
        with open(tmp, "w") as f:
            json.dump(body, f, indent=2, default=_json_default)
        os.replace(tmp, self.path)
        self.last_write_t = now
        self.n_written += 1


def _json_default(o):
    if isinstance(o, StreamingHistogram):
        return o.to_dict()
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON serializable: {type(o)!r}")
