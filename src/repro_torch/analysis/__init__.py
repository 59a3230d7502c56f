"""Static analysis + runtime sanitizers for the port's coded contracts
(port of ``repro/analysis``).

Two pieces:

* :mod:`repro_torch.analysis.lint` — ``deltalint``, an AST-based lint pass
  (``python -m repro_torch.analysis.lint src/repro_torch``) whose rules encode the
  identity/determinism invariants this codebase has fought for: no
  dot-family reductions in the bit-identity correction paths, no
  process-seeded randomness in compression, typed exceptions in runtime
  paths, a closed event-name schema, complete codec registrations,
  deterministic storage iteration, and value-naming error messages.
  Pure stdlib: importing (and running) it pulls in no framework, so a
  lint job finishes in seconds.

* :mod:`repro_torch.analysis.compile_guard` — :class:`CompileGuard`, the ONE
  recompile-detection implementation: snapshots the signature count of
  every guarded entry on an engine, asserts declared budgets, and
  (attached to the engine's event bus) can raise the moment a
  ``jit_trace`` retrace event fires outside a declared warmup phase.
"""
from repro_torch.analysis.compile_guard import (
    CompileBudgetError, CompileGuard, count_recompiles)

__all__ = [
    "CompileBudgetError", "CompileGuard", "count_recompiles",
    "Finding", "lint_paths", "lint_source",
]

_LINT_NAMES = ("Finding", "lint_paths", "lint_source", "RULES")


def __getattr__(name):
    # Lazy so `python -m repro_torch.analysis.lint` doesn't import the lint
    # module twice (package import + runpy execution -> RuntimeWarning).
    if name in _LINT_NAMES:
        from repro_torch.analysis import lint
        return getattr(lint, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
