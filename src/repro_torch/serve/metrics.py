"""Per-tenant serving metrics: throughput, TTFT, latency, occupancy.

Copy of ``repro/serve/metrics.py`` (numpy only), with the port's import
paths.

Collected host-side by the continuous engine with an injectable clock so
tests and benchmarks get deterministic numbers. ``report()`` returns a
plain-dict snapshot suitable for JSON (BENCH_serve.json).

Since the telemetry PR, ``Metrics`` is a **consumer of the engine's
event stream** (``serve.trace.EventBus``): the engine emits one typed
event per hook site and metrics, tracing and SLO counters all read the
same events — one source of truth. The ``record_*`` methods remain the
public surface (and are what ``consume`` dispatches to), so direct
callers keep working.

Per-tenant samples (TTFT, queue wait, latency) are held in
:class:`~repro_torch.serve.telemetry.StreamingHistogram`\\ s: exact percentiles
below the histogram's cap, fixed log-bucket counts above it — a
million-request run is bounded memory instead of three unbounded lists
per tenant.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.serve.telemetry import StreamingHistogram


@dataclass
class TenantStats:
    n_requests: int = 0
    n_tokens: int = 0
    # arrival -> first token / arrival -> admit / arrival -> done
    ttfts: StreamingHistogram = field(default_factory=StreamingHistogram)
    queue_waits: StreamingHistogram = field(default_factory=StreamingHistogram)
    latencies: StreamingHistogram = field(default_factory=StreamingHistogram)

    def report(self, wall: float) -> dict:
        return {
            "requests": self.n_requests,
            "tokens": self.n_tokens,
            "tokens_per_sec": self.n_tokens / wall if wall > 0 else None,
            "ttft_p50": self.ttfts.percentile(50),
            "ttft_p95": self.ttfts.percentile(95),
            "queue_wait_p50": self.queue_waits.percentile(50),
            "latency_p50": self.latencies.percentile(50),
            "latency_p95": self.latencies.percentile(95),
        }


class Metrics:
    """Aggregates per-tenant and whole-engine serving statistics.

    With ``data_shards > 1`` the engine also reports per-data-shard
    occupancy and throughput (slot rows shard over the mesh ``data``
    axis in contiguous pools; the balanced-admission policy is judged
    by exactly these numbers) plus per-shard **unique-tenant counts**
    per decode step — the number of distinct deltas each shard
    dequantizes, the observable the tenant-affinity admission policy
    exists to shrink. ``residency`` (set by the engine at drain time)
    carries the pre-decoded value-cache stats, and the per-step
    value-path/packed-path split is tallied here. ``decode_paths``
    counts decode steps per attributed dispatch path (see
    ``serve.trace.path_label``).
    """

    def __init__(self, n_slots: int, data_shards: int = 1):
        from repro_torch.serve.scheduler import shard_pool_size
        self.n_slots = n_slots
        self.data_shards = data_shards
        self.shard_size = shard_pool_size(n_slots, data_shards)
        self.tenants: Dict[str, TenantStats] = {}
        self.step_active: List[int] = []     # active slots at each decode step
        # per-shard active counts at each decode step, [steps][data_shards]
        self.step_shard_active: List[List[int]] = []
        # per-shard distinct non-base tenant rows at each decode step
        self.step_shard_unique: List[List[int]] = []
        self.shard_tokens: List[int] = [0] * data_shards
        self.n_decode_steps = 0
        self.n_prefills = 0
        # decode steps served from the pre-decoded value cache vs packed
        self.residency_value_steps = 0
        self.residency_packed_steps = 0
        self.residency: Optional[dict] = None   # DeltaResidency.stats()
        # decode steps per attributed dispatch path label
        self.decode_paths: Dict[str, int] = {}
        self.jit_traces = 0
        # tenant lifecycle transitions (register/rollout/retire from the
        # engine; ready/promote/evict from the registry), by event kind
        self.lifecycle: Dict[str, int] = {}
        # inter-token latency: gap between consecutive "token" events of
        # one request, pooled across requests. The observable chunked
        # prefill's SLO knob protects — a prefill that preempts decode
        # shows up as an ITL spike on every in-flight request.
        self.itls = StreamingHistogram()
        self._last_token_t: Dict[int, float] = {}   # rid -> last token time
        self.t_start: Optional[float] = None
        self.t_end: Optional[float] = None

    def _tenant(self, name: Optional[str]) -> TenantStats:
        key = name if name is not None else "__base__"
        return self.tenants.setdefault(key, TenantStats())

    # -- event-stream consumer ----------------------------------------------
    def consume(self, ev) -> None:
        """Apply one ``serve.trace.ServeEvent`` — the engine's event bus
        calls this; each kind maps onto the record hook below."""
        kind, a = ev.kind, ev.attrs
        if kind == "step":
            self.record_step(a["n_active"], a.get("shard_active"),
                             a.get("shard_unique"), a.get("residency_used"))
            path = a.get("path")
            if path is not None:
                self.decode_paths[path] = self.decode_paths.get(path, 0) + 1
        elif kind == "token":
            self.record_token(a.get("tenant"), a.get("n", 1))
            rid = a.get("rid")
            if rid is not None:
                last = self._last_token_t.get(rid)
                if last is not None:
                    self.itls.record(max(0.0, ev.t - last))
                self._last_token_t[rid] = ev.t
        elif kind == "admit":
            self.record_admit(a.get("tenant"), a["wait"])
        elif kind == "first_token":
            self.record_first_token(a.get("tenant"), a["ttft"])
        elif kind == "done":
            self.record_done(a.get("tenant"), a["latency"])
            self._last_token_t.pop(a.get("rid"), None)
        elif kind == "shard_token":
            self.record_shard_token(a["shard"], a.get("n", 1))
        elif kind == "start":
            self.start(ev.t)
        elif kind == "stop":
            self.stop(ev.t)
        elif kind == "jit_trace":
            self.jit_traces += 1
        elif kind in ("tenant_register", "tenant_rollout", "tenant_retire",
                      "tenant_ready", "tenant_promote", "tenant_evict"):
            self.lifecycle[kind] = self.lifecycle.get(kind, 0) + 1

    # -- recording hooks ----------------------------------------------------
    def start(self, now: float) -> None:
        if self.t_start is None:
            self.t_start = now

    def stop(self, now: float) -> None:
        self.t_end = now

    def record_admit(self, tenant: Optional[str], wait: float) -> None:
        t = self._tenant(tenant)
        t.n_requests += 1
        t.queue_waits.record(wait)
        self.n_prefills += 1

    def record_first_token(self, tenant: Optional[str], ttft: float) -> None:
        self._tenant(tenant).ttfts.record(ttft)

    def record_token(self, tenant: Optional[str], n: int = 1) -> None:
        self._tenant(tenant).n_tokens += n

    def record_done(self, tenant: Optional[str], latency: float) -> None:
        self._tenant(tenant).latencies.record(latency)

    def record_step(self, n_active: int,
                    shard_active: Optional[List[int]] = None,
                    shard_unique: Optional[List[int]] = None,
                    residency_used: Optional[bool] = None) -> None:
        self.n_decode_steps += 1
        self.step_active.append(n_active)
        if shard_active is not None:
            if len(shard_active) != self.data_shards:
                # ValueError (not assert): a ragged row must fail loudly
                # even under python -O, not corrupt the step matrix
                raise ValueError(
                    f"shard_active has {len(shard_active)} entries for "
                    f"{self.data_shards} data shards")
            self.step_shard_active.append(list(shard_active))
        if shard_unique is not None:
            if len(shard_unique) != self.data_shards:
                raise ValueError(
                    f"shard_unique has {len(shard_unique)} entries for "
                    f"{self.data_shards} data shards")
            self.step_shard_unique.append(list(shard_unique))
        if residency_used is not None:
            if residency_used:
                self.residency_value_steps += 1
            else:
                self.residency_packed_steps += 1

    def record_shard_token(self, shard: int, n: int = 1) -> None:
        if not 0 <= shard < self.data_shards:
            raise ValueError(
                f"shard {shard} out of range for {self.data_shards} "
                f"data shards")
        self.shard_tokens[shard] += n

    # -- reporting ----------------------------------------------------------
    @property
    def occupancy(self) -> Optional[float]:
        if not self.step_active:
            return None
        return float(np.mean(self.step_active)) / self.n_slots

    def shard_report(self, wall: float) -> Optional[list]:
        """Per-data-shard occupancy / throughput rows (None when data=1)."""
        if self.data_shards <= 1:
            return None
        if self.step_shard_active:
            per_step = np.asarray(self.step_shard_active, np.float64)
            occ = (per_step.mean(axis=0) / self.shard_size).tolist()
        else:
            occ = [None] * self.data_shards
        uniq = self.unique_tenants_per_shard_mean
        return [{
            "shard": s,
            "slots": [s * self.shard_size, (s + 1) * self.shard_size],
            "occupancy": occ[s],
            "unique_tenants_mean": None if uniq is None else uniq[s],
            "tokens": self.shard_tokens[s],
            "tokens_per_sec": self.shard_tokens[s] / wall if wall > 0 else None,
        } for s in range(self.data_shards)]

    @property
    def unique_tenants_per_shard_mean(self) -> Optional[List[float]]:
        """Mean (over decode steps) distinct non-base tenants per shard —
        the per-device dequantization load affinity admission shrinks."""
        if not self.step_shard_unique:
            return None
        per_step = np.asarray(self.step_shard_unique, np.float64)
        return per_step.mean(axis=0).tolist()

    @property
    def shard_imbalance_max(self) -> Optional[int]:
        """Max over decode steps of (most - least active shard). Balanced
        admission keeps this small; decode-time finishes can widen it."""
        if not self.step_shard_active:
            return None
        per_step = np.asarray(self.step_shard_active, np.int64)
        return int(np.max(per_step.max(axis=1) - per_step.min(axis=1)))

    def report(self) -> dict:
        wall = 0.0
        if self.t_start is not None and self.t_end is not None:
            # clamp: stop() never called after a reset leaves t_end from
            # a previous epoch; 0.0 beats a negative wall time downstream
            wall = max(0.0, self.t_end - self.t_start)
        total_tokens = sum(t.n_tokens for t in self.tenants.values())
        pooled_ttft = StreamingHistogram.merged(
            [t.ttfts for t in self.tenants.values() if t.ttfts.n])
        uniq = self.unique_tenants_per_shard_mean
        residency = None
        if self.residency is not None \
                or self.residency_value_steps or self.residency_packed_steps:
            residency = dict(self.residency or {})
            residency["value_steps"] = self.residency_value_steps
            residency["packed_steps"] = self.residency_packed_steps
        return {
            "data_shards": self.data_shards,
            "shards": self.shard_report(wall),
            "shard_imbalance_max": self.shard_imbalance_max,
            "unique_tenants_per_shard_mean": uniq,
            "unique_tenants_mean": None if uniq is None
            else float(np.mean(uniq)),
            "residency": residency,
            "wall_time_s": wall,
            "n_slots": self.n_slots,
            "decode_steps": self.n_decode_steps,
            "prefills": self.n_prefills,
            "batch_occupancy": self.occupancy,
            "total_tokens": total_tokens,
            "tokens_per_sec": total_tokens / wall if wall > 0 else None,
            # pooled across all requests (a median of per-tenant medians
            # is not a p50)
            "ttft_p50": pooled_ttft.percentile(50),
            "ttft_p95": pooled_ttft.percentile(95),
            "itl_p50": self.itls.percentile(50),
            "itl_p95": self.itls.percentile(95),
            "decode_paths": dict(sorted(self.decode_paths.items())) or None,
            "tenant_lifecycle": dict(sorted(self.lifecycle.items())) or None,
            "tenants": {k: t.report(wall) for k, t in sorted(self.tenants.items())},
        }
