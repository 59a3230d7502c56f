"""Request-lifecycle tracing and decode-path attribution for the engine.

Copy of ``repro/serve/trace.py`` (framework-free). In the eager port the
dispatch code runs on every call, so a note context collects the path of
that call.

Three pieces:

* **Event bus** — the engine emits typed :class:`ServeEvent`\\ s at every
  hook site (submit → admit → prefill → first-token → token → done, plus
  per-decode-step and jit-trace events). ``Metrics``, :class:`Tracer`
  and ``SLOCounters`` all consume the *same* stream, so there is one
  source of truth for what happened during a run.

* **Path attribution** — the dispatch layers (``kernels/ops.py``,
  ``kernels/fallback.py``, ``core/apply.py``) decide silently between
  formulations (segments-pallas vs gather vs dense, values vs packed
  residency, autotune tiles). :func:`note_path` lets them report that
  decision into a thread-local context the engine opens around each
  jitted call. Because those code paths only run while jax traces, a
  non-empty note list doubles as a jit (re)compile detector; on cached
  executions the engine replays the notes it memoised per call
  signature. Cost when no context is open: one ``getattr`` returning
  ``None``.

* **Chrome-trace export** — :meth:`Tracer.export` writes Chrome/Perfetto
  "trace event" JSON (open at https://ui.perfetto.dev). Track layout:
  pid 1 = one tid per request (queue_wait / prefill / decode child
  spans under a root request span, first-token instant; chunked-prefill
  engines additionally emit one ``prefill_chunk`` span per chunk, so
  chunk scheduling is visible per request); pid 2 = the engine
  (decode_step spans with path-attribution args, jit_trace instants).

The tracer holds **no clock**: every timestamp comes from events, which
carry the engine's injectable clock — traces are deterministic under
``VirtualClock`` and this module performs zero wall-clock reads.

``python -m repro_torch.serve.trace --validate trace.json`` checks an emitted
file (JSON parses, ≥1 request span with child prefill+decode spans,
monotonic non-negative timestamps) — CI runs it on the serve smoke job.
"""
from __future__ import annotations

import json
import threading
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

__all__ = [
    "EVENT_SCHEMA",
    "ServeEvent", "EventBus", "Tracer",
    "attribution", "note_path", "path_label",
    "validate_chrome_trace",
]


# ---------------------------------------------------------------------------
# Events
# ---------------------------------------------------------------------------
# The closed set of event names any ``bus.emit`` site may use. Adding an
# event means adding it here FIRST — deltalint rule DL004 cross-checks
# every emit site against this dict (and flags entries nothing emits),
# because a typo'd kind silently falls through every ``_on_<kind>``
# consumer dispatch: no metrics, no trace span, no SLO accounting, no
# error. Keys are event kinds; values say who emits it and what it marks.
EVENT_SCHEMA: Dict[str, str] = {
    "submit": "engine: request entered the queue (rid, tenant, deadline)",
    "admit": "engine: request won a slot (rid, slot, wait, deadline_slack)",
    "prefill": "engine: whole-prompt prefill span closed (rid, t_start)",
    "prefill_chunk": "engine: one chunk of a chunked prefill (rid, start, "
                     "length, last)",
    "first_token": "engine: first token surfaced for a request (rid, ttft)",
    "token": "engine: one generated token (rid, tenant)",
    "shard_token": "engine: token attributed to a data shard (data>1 only)",
    "step": "engine: one batched decode step span (n_active, path, notes)",
    "done": "engine: request finished (rid, latency, ttft, n_tokens)",
    "start": "engine: run loop started",
    "stop": "engine: run loop stopped",
    "jit_trace": "engine: a jitted entry (re)traced (signature, site, "
                 "first) — first=False is a recompile; CompileGuard "
                 "strict mode raises on these outside warmup",
    "tenant_register": "engine: new tenant delta installed (tenant, row)",
    "tenant_rollout": "engine: existing tenant's delta replaced in place",
    "tenant_retire": "engine: tenant removed from the serving table",
    "tenant_ready": "registry: compressed artifact ready to serve (tier)",
    "tenant_promote": "registry: tenant promoted cold->warm on demand",
    "tenant_evict": "registry: tenant demoted/evicted by traffic pressure",
}
@dataclass
class ServeEvent:
    """One engine event. ``t`` is engine time (injectable clock); span-like
    kinds (prefill, step) carry their start in ``attrs["t_start"]``."""
    kind: str
    t: float
    attrs: Dict[str, Any] = field(default_factory=dict)


class EventBus:
    """Fans engine events out to consumers (duck-typed ``consume(ev)``)."""

    def __init__(self, consumers: Optional[List[Any]] = None):
        self.consumers: List[Any] = [c for c in (consumers or [])
                                     if c is not None]

    def attach(self, consumer: Any) -> None:
        if consumer is not None:
            self.consumers.append(consumer)

    def emit(self, kind: str, t: float, **attrs) -> None:
        ev = ServeEvent(kind, t, attrs)
        for c in self.consumers:
            c.consume(ev)


# ---------------------------------------------------------------------------
# Thread-local path attribution
# ---------------------------------------------------------------------------
_tls = threading.local()


@contextmanager
def attribution():
    """Open a note-collection context on this thread.

    The engine wraps each jitted dispatch call in one of these; dispatch
    code inside (which only executes while jax traces) reports decisions
    via :func:`note_path`. Yields the (mutable) note list. Nesting
    restores the outer context on exit.
    """
    prev = getattr(_tls, "notes", None)
    _tls.notes = []
    try:
        yield _tls.notes
    finally:
        _tls.notes = prev


def note_path(site: str, **attrs) -> None:
    """Report a dispatch decision (no-op unless a context is open).

    ``site`` names the decision point (e.g. ``"correction_nd"``,
    ``"segments"``); attrs carry what was chosen (formulation, tiles,
    shapes). Duplicate notes within one context are dropped so loops
    over layers don't balloon the record.
    """
    notes = getattr(_tls, "notes", None)
    if notes is None:
        return
    entry = {"site": site, **attrs}
    if entry not in notes:
        notes.append(entry)


def path_label(notes: List[dict]) -> str:
    """Compact human label for a note set, e.g. ``"segments-pallas+values"``.

    Used for the per-step ``path`` attribute and the ``decode_paths``
    counters in ``Metrics`` — coarse by design (formulation + residency
    path), with the full notes preserved in trace span args.
    """
    if not notes:
        return "unknown"
    forms = []
    residency = None
    for n in notes:
        f = n.get("formulation")
        if f and f not in forms:
            forms.append(f)
        if "residency" in n and n["residency"] is not None:
            residency = n["residency"]
    label = "+".join(forms) if forms else "unknown"
    if residency is not None:
        label += f"+{residency}"
    return label


# ---------------------------------------------------------------------------
# Tracer
# ---------------------------------------------------------------------------
class Tracer:
    """Builds Chrome-trace spans from the serve event stream.

    ``step_sample=N`` keeps every Nth decode-step span (request
    lifecycle spans are always kept — they are bounded by request count,
    step spans are not). ``max_events`` hard-caps stored events; once
    hit, further decode-step spans are dropped (counted in
    ``dropped_events``) while request spans still record.
    """

    _PID_REQ = 1
    _PID_ENGINE = 2

    def __init__(self, step_sample: int = 1, max_events: int = 200_000):
        if step_sample < 1:
            raise ValueError(f"step_sample={step_sample} must be >= 1")
        self.step_sample = step_sample
        self.max_events = max_events
        self.events: List[dict] = []       # chrome-trace event dicts
        self.dropped_events = 0
        self._arrival: Dict[int, float] = {}      # rid -> submit time
        self._admit_end: Dict[int, float] = {}    # rid -> prefill span end
        self._tenant: Dict[int, Optional[str]] = {}
        self._open_rids: set = set()
        self._n_steps_seen = 0
        self.n_request_spans = 0

    # -- event-bus consumer -------------------------------------------------
    def consume(self, ev: ServeEvent) -> None:
        fn = getattr(self, f"_on_{ev.kind}", None)
        if fn is not None:
            fn(ev)

    # -- helpers ------------------------------------------------------------
    @staticmethod
    def _us(t: float) -> float:
        return t * 1e6

    def _span(self, name: str, pid: int, tid: int,
              t0: float, t1: float, args: Optional[dict] = None,
              _always: bool = True) -> None:
        if not _always and len(self.events) >= self.max_events:
            self.dropped_events += 1
            return
        self.events.append({
            "name": name, "ph": "X", "pid": pid, "tid": tid,
            "ts": self._us(t0), "dur": max(0.0, self._us(t1) - self._us(t0)),
            "args": args or {},
        })

    def _instant(self, name: str, pid: int, tid: int, t: float,
                 args: Optional[dict] = None) -> None:
        self.events.append({
            "name": name, "ph": "i", "pid": pid, "tid": tid,
            "ts": self._us(t), "s": "t", "args": args or {},
        })

    # -- lifecycle handlers -------------------------------------------------
    def _on_submit(self, ev: ServeEvent) -> None:
        rid = ev.attrs["rid"]
        self._arrival[rid] = ev.t
        self._tenant[rid] = ev.attrs.get("tenant")
        self._open_rids.add(rid)

    def _on_admit(self, ev: ServeEvent) -> None:
        rid = ev.attrs["rid"]
        arrival = self._arrival.get(rid, ev.t - ev.attrs.get("wait", 0.0))
        self._arrival.setdefault(rid, arrival)
        self._open_rids.add(rid)
        self._span("queue_wait", self._PID_REQ, rid, arrival, ev.t, {
            "tenant": ev.attrs.get("tenant"),
            "queue_wait_s": ev.attrs.get("wait"),
            "deadline_slack_s": ev.attrs.get("deadline_slack"),
            "slot": ev.attrs.get("slot"),
        })

    def _on_prefill(self, ev: ServeEvent) -> None:
        rid = ev.attrs["rid"]
        t0 = ev.attrs.get("t_start", ev.t)
        self._admit_end[rid] = ev.t
        self._span("prefill", self._PID_REQ, rid, t0, ev.t, {
            "tenant": ev.attrs.get("tenant"),
            "prompt_len": ev.attrs.get("prompt_len"),
            "bucket": ev.attrs.get("bucket"),
            "slot": ev.attrs.get("slot"),
        })

    def _on_prefill_chunk(self, ev: ServeEvent) -> None:
        """One chunk of a chunked prefill: a child span on the request
        track. The whole-prompt ``prefill`` span still closes the
        lifecycle when the LAST chunk lands (emitted by the engine), so
        chunk spans are pure detail under it."""
        rid = ev.attrs["rid"]
        t0 = ev.attrs.get("t_start", ev.t)
        self._span("prefill_chunk", self._PID_REQ, rid, t0, ev.t, {
            "tenant": ev.attrs.get("tenant"),
            "start": ev.attrs.get("start"),
            "length": ev.attrs.get("length"),
            "last": ev.attrs.get("last"),
            "slot": ev.attrs.get("slot"),
            "n_decode": ev.attrs.get("n_decode"),
        })

    def _on_first_token(self, ev: ServeEvent) -> None:
        self._instant("first_token", self._PID_REQ, ev.attrs["rid"], ev.t, {
            "ttft_s": ev.attrs.get("ttft"),
        })

    def _on_done(self, ev: ServeEvent) -> None:
        rid = ev.attrs["rid"]
        arrival = self._arrival.pop(rid, None)
        decode_t0 = self._admit_end.pop(rid, None)
        self._open_rids.discard(rid)
        self._tenant.pop(rid, None)
        if decode_t0 is not None and ev.t >= decode_t0:
            self._span("decode", self._PID_REQ, rid, decode_t0, ev.t, {
                "tokens": ev.attrs.get("n_tokens"),
            })
        if arrival is not None:
            self.n_request_spans += 1
            self._span("request", self._PID_REQ, rid, arrival, ev.t, {
                "tenant": ev.attrs.get("tenant"),
                "latency_s": ev.attrs.get("latency"),
                "ttft_s": ev.attrs.get("ttft"),
                "tokens": ev.attrs.get("n_tokens"),
                "deadline_slack_s": ev.attrs.get("deadline_slack"),
            })

    # -- engine handlers ----------------------------------------------------
    def _on_step(self, ev: ServeEvent) -> None:
        self._n_steps_seen += 1
        if (self._n_steps_seen - 1) % self.step_sample:
            return
        t0 = ev.attrs.get("t_start", ev.t)
        self._span("decode_step", self._PID_ENGINE, 0, t0, ev.t, {
            "n_active": ev.attrs.get("n_active"),
            "path": ev.attrs.get("path"),
            "residency_used": ev.attrs.get("residency_used"),
            "shard_active": ev.attrs.get("shard_active"),
            "shard_unique": ev.attrs.get("shard_unique"),
            "notes": ev.attrs.get("notes"),
            "recompiled": ev.attrs.get("recompiled"),
        }, _always=False)

    def _on_jit_trace(self, ev: ServeEvent) -> None:
        self._instant("jit_recompile" if not ev.attrs.get("first")
                      else "jit_compile",
                      self._PID_ENGINE, 0, ev.t, {
                          "signature": str(ev.attrs.get("signature")),
                          "site": ev.attrs.get("site"),
                          "notes": ev.attrs.get("notes"),
                      })

    # -- tenant lifecycle handlers ------------------------------------------
    # register/rollout/retire come from the engine; ready/promote/evict
    # from the delta registry. All land as instants on the engine
    # process's "lifecycle" track, so a rollout's timing reads directly
    # against the decode steps it must not perturb.
    def _on_lifecycle(self, ev: ServeEvent) -> None:
        self._instant(ev.kind, self._PID_ENGINE, 1, ev.t, dict(ev.attrs))

    def _on_tenant_register(self, ev: ServeEvent) -> None:
        self._on_lifecycle(ev)

    def _on_tenant_rollout(self, ev: ServeEvent) -> None:
        self._on_lifecycle(ev)

    def _on_tenant_retire(self, ev: ServeEvent) -> None:
        self._on_lifecycle(ev)

    def _on_tenant_ready(self, ev: ServeEvent) -> None:
        self._on_lifecycle(ev)

    def _on_tenant_promote(self, ev: ServeEvent) -> None:
        self._on_lifecycle(ev)

    def _on_tenant_evict(self, ev: ServeEvent) -> None:
        self._on_lifecycle(ev)

    # -- export -------------------------------------------------------------
    def to_chrome_trace(self) -> dict:
        """Chrome "JSON object format" trace; events sorted by ts."""
        meta = [
            {"name": "process_name", "ph": "M", "pid": self._PID_REQ,
             "args": {"name": "requests"}},
            {"name": "process_name", "ph": "M", "pid": self._PID_ENGINE,
             "args": {"name": "engine"}},
            {"name": "thread_name", "ph": "M", "pid": self._PID_ENGINE,
             "tid": 0, "args": {"name": "decode"}},
            {"name": "thread_name", "ph": "M", "pid": self._PID_ENGINE,
             "tid": 1, "args": {"name": "lifecycle"}},
        ]
        events = sorted(self.events, key=lambda e: (e["ts"], e.get("tid", 0)))
        trace = {
            "traceEvents": meta + events,
            "displayTimeUnit": "ms",
            "otherData": {
                "generator": "repro_torch.serve.trace",
                "step_sample": self.step_sample,
                "dropped_events": self.dropped_events,
                "unfinished_requests": sorted(self._open_rids),
            },
        }
        return trace

    def export(self, path: str) -> dict:
        trace = self.to_chrome_trace()
        with open(path, "w") as f:
            json.dump(trace, f)
        return trace


# ---------------------------------------------------------------------------
# Validation (used by CI serve-smoke and tests)
# ---------------------------------------------------------------------------
def validate_chrome_trace(trace: dict) -> List[str]:
    """Structural checks on an exported trace; returns problem strings
    (empty list = valid). Checks: trace shape, non-negative monotonic
    timestamps, and ≥1 request span with child prefill+decode spans on
    its track inside its interval."""
    problems: List[str] = []
    events = trace.get("traceEvents")
    if not isinstance(events, list) or not events:
        return ["traceEvents missing or empty"]

    spans = [e for e in events if e.get("ph") == "X"]
    last_ts = -1.0
    for e in events:
        ts = e.get("ts")
        if e.get("ph") == "M":
            continue
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"bad ts on event {e.get('name')!r}: {ts!r}")
            continue
        if ts < last_ts:
            problems.append(
                f"timestamps not monotonic at {e.get('name')!r}: "
                f"{ts} < {last_ts}")
        last_ts = ts
        if e.get("ph") == "X" and e.get("dur", 0) < 0:
            problems.append(f"negative dur on {e.get('name')!r}")

    requests = [e for e in spans if e["name"] == "request"]
    if not requests:
        problems.append("no request spans")
    ok_lifecycle = 0
    for r in requests:
        tid, t0 = r["tid"], r["ts"]
        t1 = t0 + r.get("dur", 0)
        kids = {e["name"] for e in spans
                if e["tid"] == tid and e["name"] != "request"
                and e["ts"] >= t0 - 1e-6
                and e["ts"] + e.get("dur", 0) <= t1 + 1e-6}
        if {"prefill", "decode"} <= kids:
            ok_lifecycle += 1
    if requests and not ok_lifecycle:
        problems.append(
            "no request span has child prefill+decode spans on its track")

    # chunked-prefill traces: every prefill_chunk span must sit on a
    # request track, inside that request's interval, and the chunk
    # cursors on one track must be contiguous (start_{i+1} = start_i +
    # length_i) ending in exactly one last=True chunk
    req_by_tid = {r["tid"]: (r["ts"], r["ts"] + r.get("dur", 0))
                  for r in requests}
    chunks_by_tid: dict = {}
    for e in spans:
        if e["name"] != "prefill_chunk":
            continue
        tid = e["tid"]
        if tid not in req_by_tid:
            problems.append(f"prefill_chunk span on tid {tid} "
                            "with no request span")
            continue
        t0, t1 = req_by_tid[tid]
        if not (e["ts"] >= t0 - 1e-6
                and e["ts"] + e.get("dur", 0) <= t1 + 1e-6):
            problems.append(
                f"prefill_chunk span on tid {tid} outside its request")
        chunks_by_tid.setdefault(tid, []).append(e["args"])
    for tid, chunks in chunks_by_tid.items():
        chunks.sort(key=lambda a: a.get("start", 0))
        cursor = 0
        for a in chunks:
            if a.get("start") != cursor:
                problems.append(
                    f"prefill_chunk cursor gap on tid {tid}: "
                    f"start={a.get('start')} expected {cursor}")
                break
            cursor += a.get("length", 0)
        if sum(1 for a in chunks if a.get("last")) != 1:
            problems.append(
                f"tid {tid} does not end in exactly one last=True chunk")
    return problems


def _main(argv: Optional[List[str]] = None) -> int:
    import argparse
    p = argparse.ArgumentParser(
        description="Validate a Chrome-trace JSON emitted by "
                    "launch/serve.py --trace-out")
    p.add_argument("--validate", metavar="FILE", required=True)
    a = p.parse_args(argv)
    try:
        with open(a.validate) as f:
            trace = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(f"INVALID: cannot load {a.validate}: {e}")
        return 1
    problems = validate_chrome_trace(trace)
    n_spans = sum(1 for e in trace.get("traceEvents", [])
                  if e.get("ph") == "X")
    n_req = sum(1 for e in trace.get("traceEvents", [])
                if e.get("ph") == "X" and e.get("name") == "request")
    if problems:
        for msg in problems:
            print(f"INVALID: {msg}")
        return 1
    print(f"OK: {n_spans} spans ({n_req} requests), "
          f"{len(trace['traceEvents'])} events")
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
