"""CompileGuard: the one recompile-detection implementation (port of
``repro/analysis/compile_guard.py``).

The static-decode-shape contract says the engine's hot entry points see a
*fixed* number of call signatures: warmup meets each shape family once,
and after that every register/rollout/retire/decode step reuses one. The
reference counts a signature as a jit compile-cache entry; the port's
engine is eager, so an entry's "compiles" are the distinct signatures
(the call's signature plus the delta stacks' shapes) that
``ContinuousEngine._record_path`` has recorded for that site — the keys
that would retrace a jit in the reference. Each entry of
:data:`ENTRY_PATHS` on the port's engine (``serve.engine.Signatures``)
exposes that count as ``_cache_size()``, so :class:`CompileGuard` reads
the same numbers the reference's ``jit_trace`` events and compile caches
give. Captures of CUDA graphs, should the engine take them, count into
the same ``_cache_size()``.

Two detection modes, composable:

* **Cache-size budgets** (always on): :meth:`snapshot` records every
  resolvable entry's signature count; :meth:`check` (also run by
  ``__exit__``) compares against declared ``budgets`` (max *total*
  sizes) and/or ``max_new`` (max *new* signatures since the last
  snapshot) and raises :class:`CompileBudgetError` naming the entry,
  the observed count, and the budget.

* **Event-bus strict mode** (``strict=True`` or :meth:`attach`): the
  guard registers as an EventBus consumer and watches ``jit_trace``
  events; a retrace (``first=False``) outside a declared
  :meth:`warmup` phase raises immediately at the emit site — the
  stack trace points at the call that retraced, not at teardown.

No framework import: entries are duck-typed via ``_cache_size()``, so
the module stays importable from the lint/CI layer.

Usage::

    guard = CompileGuard(eng, budgets={"decode": 1})
    with guard:
        with guard.warmup():
            eng.step(); eng.step()      # traces allowed + re-baselined
        for _ in range(100):
            eng.step()                  # any decode retrace -> raises
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

__all__ = ["CompileBudgetError", "CompileGuard", "ENTRY_PATHS"]


class CompileBudgetError(RuntimeError):
    """An entry met more signatures than its declared budget allows."""


# Attribute chains from an engine to each guarded entry. Entries that
# don't resolve on a given engine (e.g. no residency tier, table mode
# off) are simply skipped; lazily-built ones baseline at 0.
ENTRY_PATHS: Dict[str, Tuple[str, ...]] = {
    "decode": ("_decode",),
    "prefill": ("_prefill",),
    "decode_masked": ("_decode_masked",),
    "combined": ("_combined",),
    "promote": ("residency", "_promote"),
    "table_write": ("_table", "_write_jit"),
}


def _resolve(engine: Any, chain: Tuple[str, ...]) -> Optional[Any]:
    obj = engine
    for attr in chain:
        obj = getattr(obj, attr, None)
        if obj is None:
            return None
    return obj if hasattr(obj, "_cache_size") else None


class CompileGuard:
    """Snapshot entry signature counts and enforce compile budgets.

    Parameters
    ----------
    engine:
        Anything exposing the :data:`ENTRY_PATHS` attributes (a
        ``ContinuousEngine``; entries that don't resolve are skipped). May
        also expose ``.bus`` for strict mode.
    budgets:
        ``entry name -> max total cache size`` checked by
        :meth:`check` / ``__exit__``.
    max_new:
        ``entry name -> max NEW compiles since the last snapshot``.
        ``{"decode": 0}`` is the lifecycle drill's "hot path never
        retraces" gate.
    strict:
        Attach to ``engine.bus`` on ``__enter__`` and raise the moment
        a ``jit_trace`` retrace event (``first=False``) fires outside
        a :meth:`warmup` phase.
    label:
        Prefixed to error messages so multi-guard tests read cleanly.
    """

    def __init__(self, engine: Any, *,
                 budgets: Optional[Dict[str, int]] = None,
                 max_new: Optional[Dict[str, int]] = None,
                 strict: bool = False, label: str = "") -> None:
        self.engine = engine
        self.budgets = dict(budgets or {})
        self.max_new = dict(max_new or {})
        self.strict = strict
        self.label = label
        self._baseline: Dict[str, int] = {}
        self._in_warmup = False
        self._attached = False
        self._retrace_events: List[Any] = []
        unknown = sorted((set(self.budgets) | set(self.max_new))
                         - set(ENTRY_PATHS))
        if unknown:
            raise ValueError(
                f"unknown CompileGuard entries {unknown}; known entries are "
                f"{sorted(ENTRY_PATHS)}")
        self.snapshot()

    # -- introspection ----------------------------------------------------
    def entries(self) -> Dict[str, Any]:
        """Resolvable guarded entries on this engine, by name."""
        out = {}
        for name, chain in ENTRY_PATHS.items():
            fn = _resolve(self.engine, chain)
            if fn is not None:
                out[name] = fn
        return out

    def sizes(self) -> Dict[str, int]:
        """Current compile-cache size per resolvable entry."""
        return {name: int(fn._cache_size())
                for name, fn in self.entries().items()}

    def snapshot(self) -> Dict[str, int]:
        """Re-baseline: subsequent :meth:`new_compiles` counts from here."""
        self._baseline = self.sizes()
        return dict(self._baseline)

    def new_compiles(self, name: str) -> int:
        """Compiles of ``name`` since the last :meth:`snapshot` (0 for
        entries that didn't exist at baseline and still don't)."""
        return self.sizes().get(name, 0) - self._baseline.get(name, 0)

    def report(self) -> Dict[str, Dict[str, int]]:
        """``{entry: {"total": n, "new": m}}`` for every live entry."""
        return {name: {"total": total,
                       "new": total - self._baseline.get(name, 0)}
                for name, total in self.sizes().items()}

    # -- event-bus strict mode --------------------------------------------
    def attach(self) -> "CompileGuard":
        """Register as an EventBus consumer on ``engine.bus``."""
        bus = getattr(self.engine, "bus", None)
        if bus is None:
            raise ValueError(
                f"{self._tag}engine {type(self.engine).__name__} has no "
                ".bus — strict mode needs the serve EventBus")
        if not self._attached:
            bus.attach(self)       # EventBus duck-types consume(ev) on us
            self._attached = True
        return self

    def detach(self) -> None:
        bus = getattr(self.engine, "bus", None)
        if bus is not None and self._attached:
            consumers = getattr(bus, "consumers", None)
            if consumers is not None and self in consumers:
                consumers.remove(self)
        self._attached = False

    def consume(self, ev: Any) -> None:
        """EventBus consumer: record ``jit_trace`` retraces; in strict
        mode, raise at the emit site unless inside :meth:`warmup`."""
        if getattr(ev, "kind", None) != "jit_trace":
            return
        attrs = getattr(ev, "attrs", None) or {}
        if attrs.get("first", True):
            return
        self._retrace_events.append(ev)
        if self.strict and not self._in_warmup:
            raise CompileBudgetError(
                f"{self._tag}jit retrace outside warmup: "
                f"path={attrs.get('path', '?')!r} "
                f"sig={attrs.get('sig', '?')!r} — the static-decode-shape "
                "contract says hot-path shapes never change; find the "
                "dynamic extent in this stack")

    @property
    def retraces(self) -> List[Any]:
        """``jit_trace`` retrace events observed while attached."""
        return list(self._retrace_events)

    @contextmanager
    def warmup(self) -> Iterator["CompileGuard"]:
        """Suspend strict-mode raising; re-:meth:`snapshot` on exit so
        warmup traces don't count against ``max_new``."""
        prev = self._in_warmup
        self._in_warmup = True
        try:
            yield self
        finally:
            self._in_warmup = prev
            if not prev:
                self._retrace_events.clear()
                self.snapshot()

    # -- budget enforcement -----------------------------------------------
    @property
    def _tag(self) -> str:
        return f"[{self.label}] " if self.label else ""

    def check(self) -> Dict[str, Dict[str, int]]:
        """Enforce ``budgets`` / ``max_new``; returns :meth:`report`."""
        rep = self.report()
        problems: List[str] = []
        for name, budget in sorted(self.budgets.items()):
            total = rep.get(name, {}).get("total", 0)
            if total > budget:
                problems.append(
                    f"entry {name!r} compiled {total} time(s), budget "
                    f"{budget}")
        for name, budget in sorted(self.max_new.items()):
            new = rep.get(name, {}).get("new", 0)
            if new > budget:
                problems.append(
                    f"entry {name!r} recompiled {new} time(s) since "
                    f"baseline, budget {budget}")
        if problems:
            raise CompileBudgetError(
                f"{self._tag}compile budget exceeded: "
                + "; ".join(problems)
                + f" (full report: {rep})")
        return rep

    # -- context manager ---------------------------------------------------
    def __enter__(self) -> "CompileGuard":
        self.snapshot()
        if self.strict:
            self.attach()
        return self

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> None:
        self.detach()
        if exc_type is None:
            self.check()


def count_recompiles(engine: Any, run: Callable[[], Any], *,
                     entry: str = "decode") -> int:
    """Run ``run()`` and return how many times ``entry`` recompiled —
    the drop-in replacement for hand-rolled before/after
    ``_cache_size()`` arithmetic."""
    guard = CompileGuard(engine)
    run()
    return guard.new_compiles(entry)
