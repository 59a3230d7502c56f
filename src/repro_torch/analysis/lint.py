"""deltalint for the PyTorch port: contract-checking static analysis
(port of ``repro/analysis/lint.py``).

Generic style is ruff's job; these rules encode the *domain* contracts
that keep DeltaDQ serving token-identical and deterministic, scoped to
``repro_torch/``:

========  ==============================================================
DL001     No ``einsum`` / ``dot_general`` / ``tensordot`` calls, no
          ``matmul`` / ``dot`` / ``vdot`` / ``mm`` / ``bmm`` of an array
          module (``torch``, ``np``, ``jnp`` ...), and no ``@`` in the
          bit-identity correction paths (``kernels/fallback.py``,
          ``core/apply.py``). A library GEMM (cuBLAS, or a CPU BLAS)
          picks its reduction order by the batch extent; the elementwise
          multiply + axis-``sum`` formulation does not, and the
          token-identity contract (mixed batch == per-tenant, exact)
          rides on it. ``@`` is flagged wherever it appears in those
          files: on the AST a product of two tensors cannot be told from
          one of numpy arrays or of any type defining ``__matmul__``, so
          every audited site (the base GEMMs, the reference's
          reconstruct-then-matmul paths) carries the escape hatch.
DL002     No ``hash()`` / ``time.time`` / process-global numpy RNG in
          ``core/`` + ``serve/``. ``hash()`` is PYTHONHASHSEED-
          randomized (zlib.crc32 is the sanctioned replacement); engine
          time must come from the injectable clock (VirtualClock
          determinism), and randomness must be explicitly seeded to keep
          compression bit-reproducible across processes.
DL003     No bare ``assert`` in runtime ``src/repro_torch`` paths —
          ``python -O`` strips asserts, silently disabling the check.
          Raise a typed exception naming the offending values instead.
DL004     Every ``bus.emit("<name>", ...)`` event name must appear in
          ``serve/trace.py``'s ``EVENT_SCHEMA`` and vice-versa — the
          static twin of the runtime trace validator.
DL005     (The reference's recompile-risk ``jax.jit`` patterns: a jit
          built inside a loop or immediately invoked.) The port is eager
          and builds no jit, so the rule has no counterpart here and
          never fires; ``analysis.CompileGuard`` keeps the runtime half
          of the contract (new call signatures of the engine's entry
          points).
DL006     A class registered via ``register_codec`` must implement the
          DeltaCodec protocol surface (``leaf_spec`` and its sharding
          twin ``leaf_axes`` included) — a partial codec fails at
          serving time deep inside pack/apply instead of at
          registration.
DL007     Deterministic storage paths (``core/pack.py``,
          ``core/codecs.py``): no mutable default arguments, no
          iteration over ``set`` literals/calls (string hashing is
          PYTHONHASHSEED-dependent, so iteration order is not
          reproducible across processes — sort first).
DL008     Public ``serve/`` functions raising on user input must name
          the offending value in the message (f-string / ``.format`` /
          ``%``).
========  ==============================================================

Escape hatch: ``# deltalint: allow[DL001] <reason>`` on the offending
line (or alone on the line above it) suppresses that rule there; the
reason is mandatory (an allow without one is reported as DL000). Rules
may be comma-separated: ``allow[DL001,DL003] <reason>``.

CLI::

    python -m repro_torch.analysis.lint src/repro_torch [--json findings.json]

Exits 0 when clean, 1 when any finding survives. Pure stdlib: it imports
no framework, so a lint job runs in seconds.
"""
from __future__ import annotations

import ast
import json
import re
import sys
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["Finding", "RULES", "lint_paths", "lint_source", "main"]


# ---------------------------------------------------------------------------
# Findings + per-file context
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""
    rule: str
    path: str          # display path (as given on the CLI / virtual rel)
    line: int
    col: int
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"


RULES: Dict[str, str] = {
    "DL000": "deltalint allow-comment without a reason",
    "DL001": "dot-family reduction in a bit-identity correction path",
    "DL002": "process-seeded randomness / wall clock in core+serve",
    "DL003": "bare assert in a runtime path (stripped by python -O)",
    "DL004": "bus.emit event name not in the trace EVENT_SCHEMA (or unused schema entry)",
    "DL005": "recompile-risk jax.jit pattern: no counterpart in the eager port (never fires)",
    "DL006": "register_codec class missing part of the DeltaCodec protocol",
    "DL007": "non-deterministic storage-path construct (mutable default / set iteration)",
    "DL008": "public serve/ raise does not name the offending value",
}

_ALLOW_RE = re.compile(
    r"#\s*deltalint:\s*allow\[([A-Za-z0-9,\s]+)\]\s*(.*?)\s*$")


class _FileCtx:
    """Parsed file + allow-comment map + collected cross-file facts."""

    def __init__(self, display: str, rel: str, source: str):
        self.display = display
        self.rel = rel                     # normalized "repro_torch/..." posix path
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=display)
        self.findings: List[Finding] = []
        # line -> set of allowed rule ids ("*" = all)
        self.allows: Dict[int, set] = {}
        # cross-file facts for DL004
        self.emit_sites: List[Tuple[str, int, int]] = []   # (name, line, col)
        self.event_schema: Optional[Dict[str, int]] = None  # name -> line
        self._scan_allows()

    def _scan_allows(self) -> None:
        for i, text in enumerate(self.lines, start=1):
            m = _ALLOW_RE.search(text)
            if not m:
                continue
            rules = {r.strip().upper() for r in m.group(1).split(",")
                     if r.strip()}
            if not m.group(2):
                self.findings.append(Finding(
                    "DL000", self.display, i, text.index("#"),
                    "allow[...] needs a reason: say WHY this site is "
                    "exempt (audited, traced-body invariant, ...)"))
            target = i
            if text.lstrip().startswith("#"):
                # comment-only line: the allow covers the next code line
                # (skipping blank lines and comment continuations)
                for j in range(i + 1, len(self.lines) + 1):
                    nxt = self.lines[j - 1].strip()
                    if nxt and not nxt.startswith("#"):
                        target = j
                        break
            self.allows.setdefault(target, set()).update(rules)

    def allowed(self, rule: str, line: int) -> bool:
        got = self.allows.get(line, ())
        return rule in got or "*" in got

    def add(self, rule: str, node: ast.AST, message: str) -> None:
        line = getattr(node, "lineno", 1)
        if self.allowed(rule, line):
            return
        self.findings.append(Finding(
            rule, self.display, line, getattr(node, "col_offset", 0), message))


def _rel_of(path: Path) -> str:
    """Normalize to a 'repro_torch/...' posix path for rule scoping (falls
    back to the basename for files outside a repro_torch package)."""
    parts = path.resolve().parts
    for i in range(len(parts) - 1, -1, -1):
        if parts[i] == "repro_torch":
            return "/".join(parts[i:])
    return path.name


def _chain(node: ast.AST) -> Optional[str]:
    """Dotted attribute chain as a string ('jnp.dot'), None if dynamic."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _in_scope(rel: str, prefixes: Sequence[str]) -> bool:
    return any(rel == p or rel.startswith(p) for p in prefixes)


# ---------------------------------------------------------------------------
# DL001 — dot-family reductions in bit-identity paths
# ---------------------------------------------------------------------------
_DL001_FILES = ("repro_torch/kernels/fallback.py", "repro_torch/core/apply.py")
_DOT_TAILS = {"einsum", "dot_general", "tensordot"}
_DOT_FNS = {"dot", "matmul", "vdot", "mm", "bmm"}
_ARRAY_MODULES = {"jnp", "np", "jax", "numpy", "lax", "torch"}
_DL001_FIX = ("use the elementwise multiply + axis-sum formulation "
              "(kernels/fallback.py module doc) or add an audited "
              "allow[DL001] with a reason")


def _rule_dl001(ctx: _FileCtx) -> None:
    if not _in_scope(ctx.rel, _DL001_FILES):
        return
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult):
            ctx.add("DL001", node,
                    "@ in a bit-identity correction path: a library GEMM's "
                    "reduction order varies with the batch extent; "
                    + _DL001_FIX)
            continue
        if not isinstance(node, ast.Call):
            continue
        chain = _chain(node.func)
        if chain is None:
            continue
        head, _, tail = chain.rpartition(".")
        name = tail or chain
        banned = name in _DOT_TAILS or (
            name in _DOT_FNS and head.split(".")[0] in _ARRAY_MODULES)
        if banned:
            ctx.add("DL001", node,
                    f"{chain}() in a bit-identity correction path: a "
                    "library GEMM's reduction order varies with the batch "
                    "extent; " + _DL001_FIX)


# ---------------------------------------------------------------------------
# DL002 — nondeterminism sources in core/ + serve/
# ---------------------------------------------------------------------------
_DL002_SCOPE = ("repro_torch/core/", "repro_torch/serve/")
_NP_GLOBAL_RNG = {
    "rand", "randn", "randint", "random", "random_sample", "normal",
    "uniform", "choice", "shuffle", "permutation", "seed",
}


def _rule_dl002(ctx: _FileCtx) -> None:
    if not _in_scope(ctx.rel, _DL002_SCOPE):
        return
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Call):
            if isinstance(node.func, ast.Name) and node.func.id == "hash":
                ctx.add("DL002", node,
                        "hash() is PYTHONHASHSEED-randomized across "
                        "processes; use zlib.crc32 for deterministic seeds")
                continue
            chain = _chain(node.func)
            if chain is None:
                continue
            if (chain.startswith("np.random.")
                    or chain.startswith("numpy.random.")):
                tail = chain.rpartition(".")[2]
                if tail in _NP_GLOBAL_RNG:
                    ctx.add("DL002", node,
                            f"{chain}() uses the process-global numpy RNG; "
                            "seed an explicit Generator "
                            "(np.random.default_rng(seed)) instead")
                elif tail in ("default_rng", "SeedSequence") and not (
                        node.args or node.keywords):
                    ctx.add("DL002", node,
                            f"{chain}() without a seed draws OS entropy — "
                            "compression/serving must be bit-reproducible; "
                            "pass an explicit seed")
        elif isinstance(node, ast.Attribute):
            if _chain(node) == "time.time":
                ctx.add("DL002", node,
                        "time.time reads the wall clock; engine code must "
                        "use the injectable clock (VirtualClock contract) — "
                        "launch/ timing loops live outside this scope")


# ---------------------------------------------------------------------------
# DL003 — bare asserts in runtime paths
# ---------------------------------------------------------------------------
def _rule_dl003(ctx: _FileCtx) -> None:
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Assert):
            ctx.add("DL003", node,
                    "bare assert is stripped by python -O; raise "
                    "ValueError/RuntimeError naming the offending values, "
                    "or allow[DL003] a genuinely-internal invariant with a "
                    "reason")


# ---------------------------------------------------------------------------
# DL004 — bus.emit names <-> trace.py EVENT_SCHEMA
# ---------------------------------------------------------------------------
_TRACE_FILE = "repro_torch/serve/trace.py"
_ENGINE_FILE = "repro_torch/serve/engine.py"


def _collect_dl004(ctx: _FileCtx) -> None:
    """Per-file half: collect emit sites and (in trace.py) the schema."""
    for node in ast.walk(ctx.tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "emit"):
            owner = node.func.value
            owner_chain = _chain(owner) or ""
            if not (owner_chain == "bus" or owner_chain.endswith(".bus")):
                continue
            if not node.args:
                continue
            first = node.args[0]
            if isinstance(first, ast.Constant) and isinstance(first.value, str):
                ctx.emit_sites.append((first.value, node.lineno,
                                       node.col_offset))
            elif (isinstance(first, ast.IfExp)
                  and isinstance(first.body, ast.Constant)
                  and isinstance(first.orelse, ast.Constant)):
                ctx.emit_sites.append((str(first.body.value), node.lineno,
                                       node.col_offset))
                ctx.emit_sites.append((str(first.orelse.value), node.lineno,
                                       node.col_offset))
            else:
                ctx.add("DL004", first,
                        "bus.emit event name must be a string literal (or a "
                        "literal conditional) so the schema cross-check can "
                        "see it")
    if ctx.rel == _TRACE_FILE:
        for node in ast.walk(ctx.tree):
            targets: List[ast.expr] = []
            if isinstance(node, ast.Assign):
                targets = node.targets
                value = node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets = [node.target]
                value = node.value
            else:
                continue
            names = [t.id for t in targets if isinstance(t, ast.Name)]
            if "EVENT_SCHEMA" in names and isinstance(value, ast.Dict):
                ctx.event_schema = {}
                for k in value.keys:
                    if isinstance(k, ast.Constant) and isinstance(k.value, str):
                        ctx.event_schema[k.value] = k.lineno


def _finish_dl004(ctxs: List[_FileCtx]) -> None:
    """Cross-file half: run once over all analyzed files."""
    schema_ctx = next((c for c in ctxs if c.event_schema is not None), None)
    if schema_ctx is None:
        return      # trace.py (or its schema) not in this lint scope
    schema = schema_ctx.event_schema or {}
    emitted: Dict[str, List[Tuple[_FileCtx, int, int]]] = {}
    for c in ctxs:
        for name, line, col in c.emit_sites:
            emitted.setdefault(name, []).append((c, line, col))
    for name, sites in sorted(emitted.items()):
        if name in schema:
            continue
        for c, line, col in sites:
            if not c.allowed("DL004", line):
                c.findings.append(Finding(
                    "DL004", c.display, line, col,
                    f"event {name!r} is not in serve/trace.py EVENT_SCHEMA "
                    f"(known: {sorted(schema)}); typo'd names silently drop "
                    "metrics/trace/SLO accounting"))
    # the reverse direction only means something when the emitting layer
    # is actually part of this lint run
    if any(c.rel == _ENGINE_FILE for c in ctxs):
        for name, line in sorted(schema.items()):
            if name not in emitted and not schema_ctx.allowed("DL004", line):
                schema_ctx.findings.append(Finding(
                    "DL004", schema_ctx.display, line, 0,
                    f"EVENT_SCHEMA entry {name!r} is never emitted by any "
                    "analyzed bus.emit site — dead schema documents events "
                    "that cannot happen"))


# ---------------------------------------------------------------------------
# DL006 — register_codec protocol completeness
# ---------------------------------------------------------------------------
# the reference's surface (``repro/analysis/lint.py:423``)
_CODEC_METHODS = {
    "compress_leaf", "reconstruct_dense", "runtime_packed", "storage_bits",
    "to_storage_parts", "from_storage_parts", "leaf_spec", "leaf_axes",
}
_CODEC_ATTRS = {"name", "spec_cls", "leaf_cls"}
_PROTOCOL_ROOTS = {"DeltaCodec"}    # bases whose stubs don't count


def _class_members(cls: ast.ClassDef) -> set:
    got = set()
    for stmt in cls.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            got.add(stmt.name)
        elif isinstance(stmt, ast.Assign):
            got.update(t.id for t in stmt.targets if isinstance(t, ast.Name))
        elif isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target,
                                                            ast.Name):
            if stmt.value is not None:
                got.add(stmt.target.id)
    return got


def _rule_dl006(ctx: _FileCtx) -> None:
    classes = {n.name: n for n in ast.walk(ctx.tree)
               if isinstance(n, ast.ClassDef)}
    registered: List[Tuple[ast.ClassDef, ast.Call]] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        chain = _chain(node.func) or ""
        if chain.rpartition(".")[2] != "register_codec" or not node.args:
            continue
        arg = node.args[0]
        if (isinstance(arg, ast.Call) and isinstance(arg.func, ast.Name)
                and arg.func.id in classes):
            registered.append((classes[arg.func.id], node))
    for cls, site in registered:
        members: set = set()
        seen = set()
        stack = [cls]
        while stack:
            c = stack.pop()
            if c.name in seen:
                continue
            seen.add(c.name)
            members |= _class_members(c)
            for b in c.bases:
                bname = _chain(b) or ""
                bname = bname.rpartition(".")[2]
                if bname in classes and bname not in _PROTOCOL_ROOTS:
                    stack.append(classes[bname])
        missing = sorted((_CODEC_METHODS | _CODEC_ATTRS) - members)
        if missing:
            ctx.add("DL006", cls,
                    f"codec class {cls.name} (registered at line "
                    f"{site.lineno}) is missing DeltaCodec protocol "
                    f"members: {missing} — a partial codec fails at "
                    "serving time instead of at registration")


# ---------------------------------------------------------------------------
# DL007 — deterministic storage paths
# ---------------------------------------------------------------------------
_DL007_FILES = ("repro_torch/core/pack.py", "repro_torch/core/codecs.py")
_MUTABLE_CTORS = {"list", "dict", "set"}


def _is_mutable_default(node: ast.AST) -> bool:
    if isinstance(node, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                         ast.DictComp, ast.SetComp)):
        return True
    return (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id in _MUTABLE_CTORS)


def _rule_dl007(ctx: _FileCtx) -> None:
    if not _in_scope(ctx.rel, _DL007_FILES):
        return
    for node in ast.walk(ctx.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            defaults = list(node.args.defaults) + [
                d for d in node.args.kw_defaults if d is not None]
            for d in defaults:
                if _is_mutable_default(d):
                    ctx.add("DL007", d,
                            "mutable default argument is shared across "
                            "calls — storage-layer state must not leak "
                            "between leaves; default to None and build "
                            "inside")
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            it = node.iter
            is_set = isinstance(it, ast.Set) or (
                isinstance(it, ast.Call) and isinstance(it.func, ast.Name)
                and it.func.id == "set")
            if is_set:
                ctx.add("DL007", it,
                        "iterating a set: order is PYTHONHASHSEED-dependent "
                        "for str keys, so pytree/storage layouts would vary "
                        "across processes — iterate sorted(...) instead")


# ---------------------------------------------------------------------------
# DL008 — value-naming raise messages in public serve/ functions
# ---------------------------------------------------------------------------
_DL008_SCOPE = ("repro_torch/serve/",)
_EXC_NAMES = {"ValueError", "TypeError", "KeyError", "RuntimeError",
              "IndexError"}


def _is_static_string(node: ast.AST) -> bool:
    """True when the expression can only ever produce one fixed string."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str)
    if isinstance(node, ast.JoinedStr):
        return not any(isinstance(v, ast.FormattedValue) for v in node.values)
    if isinstance(node, ast.BinOp) and isinstance(node.op, (ast.Add, ast.Mod)):
        return _is_static_string(node.left) and _is_static_string(node.right)
    return False


def _public(name: str) -> bool:
    return not name.startswith("_") or (
        name.startswith("__") and name.endswith("__"))


def _rule_dl008(ctx: _FileCtx) -> None:
    if not _in_scope(ctx.rel, _DL008_SCOPE):
        return

    class V(ast.NodeVisitor):
        def __init__(self) -> None:
            self.fn_stack: List[str] = []

        def _fn(self, node: ast.AST) -> None:
            self.fn_stack.append(node.name)
            self.generic_visit(node)
            self.fn_stack.pop()

        visit_FunctionDef = visit_AsyncFunctionDef = _fn

        def visit_Raise(self, node: ast.Raise) -> None:
            self.generic_visit(node)
            if not self.fn_stack or not _public(self.fn_stack[-1]):
                return
            exc = node.exc
            if not isinstance(exc, ast.Call):
                return
            name = (_chain(exc.func) or "").rpartition(".")[2]
            if name not in _EXC_NAMES:
                return
            if not exc.args or _is_static_string(exc.args[0]):
                ctx.add("DL008", node,
                        f"{name} raised from public "
                        f"{'.'.join(self.fn_stack)}() must NAME the "
                        "offending value in its message (f-string the "
                        "value in) — 'bad value' without the value is a "
                        "debugging session, not a diagnosis")

    V().visit(ctx.tree)


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------
# DL005 has no rule function: the eager port builds no jit (module doc)
_PER_FILE_RULES = (_rule_dl001, _rule_dl002, _rule_dl003, _rule_dl006,
                   _rule_dl007, _rule_dl008)


def lint_source(source: str, rel: str, display: Optional[str] = None
                ) -> List[Finding]:
    """Lint one in-memory source blob. ``rel`` is the virtual
    'repro_torch/...'-style path used for rule scoping (fixture tests use
    this to place snippets inside any rule's jurisdiction)."""
    ctx = _FileCtx(display or rel, rel, source)
    for rule in _PER_FILE_RULES:
        rule(ctx)
    _collect_dl004(ctx)
    _finish_dl004([ctx])
    return ctx.findings


def _iter_py(paths: Iterable[str]) -> List[Path]:
    out: List[Path] = []
    for p in paths:
        path = Path(p)
        if path.is_dir():
            out.extend(sorted(path.rglob("*.py")))
        else:
            out.append(path)
    return out


def lint_paths(paths: Iterable[str]) -> List[Finding]:
    """Lint files/directories; runs the cross-file DL004 check over the
    whole set. Returns findings sorted by (path, line)."""
    ctxs: List[_FileCtx] = []
    findings: List[Finding] = []
    for path in _iter_py(paths):
        try:
            source = path.read_text()
            ctx = _FileCtx(str(path), _rel_of(path), source)
        except (OSError, SyntaxError) as e:
            findings.append(Finding("DL000", str(path), 1, 0,
                                    f"cannot lint: {e}"))
            continue
        for rule in _PER_FILE_RULES:
            rule(ctx)
        _collect_dl004(ctx)
        ctxs.append(ctx)
    _finish_dl004(ctxs)
    for ctx in ctxs:
        findings.extend(ctx.findings)
    return sorted(findings, key=lambda f: (f.path, f.line, f.col, f.rule))


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="deltalint: contract-checking static analysis "
                    "(identity/determinism invariants)")
    ap.add_argument("paths", nargs="*", default=["src/repro_torch"],
                    help="files or directories (default: src/repro_torch)")
    ap.add_argument("--json", metavar="FILE", default=None,
                    help="also write a machine-readable findings report")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule table and exit")
    args = ap.parse_args(argv)
    if args.list_rules:
        for rule, summary in sorted(RULES.items()):
            print(f"{rule}  {summary}")
        return 0
    findings = lint_paths(args.paths or ["src/repro_torch"])
    n_files = len(_iter_py(args.paths or ["src/repro_torch"]))
    if args.json:
        counts: Dict[str, int] = {}
        for f in findings:
            counts[f.rule] = counts.get(f.rule, 0) + 1
        report = {"version": 1, "files": n_files,
                  "findings": [asdict(f) for f in findings],
                  "counts": counts}
        with open(args.json, "w") as fh:
            json.dump(report, fh, indent=2)
    for f in findings:
        print(f.format())
    if findings:
        print(f"deltalint: {len(findings)} finding(s) in {n_files} file(s)",
              file=sys.stderr)
        return 1
    print(f"deltalint: clean ({n_files} files)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
