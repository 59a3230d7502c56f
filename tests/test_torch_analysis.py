"""The port's tooling against the reference's: ``CompileGuard`` on the
port's engine and deltalint for ``repro_torch``.

* CompileGuard: one smoke stream served by the port's
  ``ContinuousEngine`` and by the reference's (f32 smoke config, the same
  VirtualClock trace, the same tenants carried across): both guards'
  ``report()`` and ``count_recompiles`` are equal, exactly, on the
  whole-prompt, chunked and tenant-table engines; a new signature of a
  seen call (a re-stack's new leading dimension) raises in strict mode.
* deltalint: every fixture of ``tests/test_analysis_lint.py`` for the
  rules the port keeps (DL000, DL002-DL004, DL006-DL008), placed under
  ``repro_torch/...``, gives the port's lint the (rule, line, col) list
  the reference's lint gives under ``repro/...``; DL001 on its own torch
  fixtures; ``src/repro_torch`` lints clean through the API and the CLI.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.analysis import CompileGuard as JCompileGuard  # noqa: E402
from repro.analysis import count_recompiles as j_count_recompiles  # noqa: E402
from repro.analysis.lint import lint_paths as j_lint_paths  # noqa: E402
from repro.analysis.lint import lint_source as j_lint_source  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import ContinuousEngine as JContinuousEngine  # noqa: E402
from repro.serve import VirtualClock as JVirtualClock  # noqa: E402

from repro_torch.analysis import (  # noqa: E402
    CompileBudgetError,
    CompileGuard,
    count_recompiles,
)
from repro_torch.analysis.compile_guard import ENTRY_PATHS  # noqa: E402
from repro_torch.analysis.lint import RULES, lint_paths, lint_source  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import DeltaDQSpec  # noqa: E402
from repro_torch.launch.serve import synth_tenants  # noqa: E402
from repro_torch.serve import ContinuousEngine, VirtualClock  # noqa: E402

import torch_bridge as br  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
ARCH = "llama3.2-1b"
SPEC = DeltaDQSpec(alpha=8.0, k_bits=4, m=8, h_g=16)


# ---------------------------------------------------------------------------
# CompileGuard on the port's engine vs the reference's
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _fleet():
    """f32 smoke base made by the reference and 3 tenants packed by the
    port (``synth_tenants``: eager JAX would compile its compression per
    primitive and shape), each carried across to the other package."""
    jcfg = dataclasses.replace(j_smoke(ARCH), param_dtype="float32")
    base = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(get_smoke_config(ARCH), param_dtype="float32")
    tbase = br.params_to_port(base)
    tten = [d for _, d, _ in synth_tenants(tcfg, tbase, 3, SPEC, seed=0)]
    return jcfg, base, [br.deltas_to_jax(d) for d in tten], tcfg, tbase, tten


def _prompts(vocab, lengths=(5, 9, 7, 12, 3, 10)):
    rng = np.random.default_rng(3)
    return [rng.integers(0, vocab, L).astype(np.int32) for L in lengths]


def _drill(eng, ten, prompts, guards, count):
    """Two tenants serve; a third registers mid-run (a re-stack on the
    dynamic engine, a row write on the table); then a warm re-serve.
    ``guards`` snapshot after warm-up; ``count`` is count_recompiles."""
    for i in range(2):
        eng.register_tenant(f"t{i}", ten[i])
    hs = [eng.submit(f"t{i % 2}", p, max_new_tokens=4, arrival=0.001 * i)
          for i, p in enumerate(prompts[:4])]
    for _ in range(3):
        eng.step(eng._now())
    guard = guards(eng)
    eng.register_tenant("t2", ten[2])
    hs.append(eng.submit("t2", prompts[4], max_new_tokens=4, arrival=eng._now()))
    eng.run()
    new = count(eng, lambda: [eng.submit("t1", prompts[5], max_new_tokens=3,
                                         arrival=eng._now()), eng.run()])
    return [h.output() for h in hs], guard, new


@pytest.mark.parametrize("mode", ["dynamic", "chunked", "table"])
def test_compile_guard_report_equals_reference(mode):
    """The same drill on both engines: every guarded entry's total and new
    signatures equal the reference's compile-cache sizes, and so does
    count_recompiles of a warm re-serve (0)."""
    jcfg, jbase, jten, tcfg, tbase, tten = _fleet()
    kw = dict(n_slots=3, max_seq=32)
    if mode == "chunked":
        kw.update(chunked_prefill=True, chunk_size=4)
    if mode == "table":
        kw.update(tenant_capacity=4)
    jeng = JContinuousEngine(jcfg, jbase, clock=JVirtualClock(tick=1e-3), **kw)
    teng = ContinuousEngine(tcfg, tbase, clock=VirtualClock(tick=1e-3), **kw)
    prompts = _prompts(tcfg.vocab)
    jout, jguard, jnew = _drill(jeng, jten, prompts, JCompileGuard, j_count_recompiles)
    tout, tguard, tnew = _drill(teng, tten, prompts, CompileGuard, count_recompiles)
    for a, b in zip(tout, jout):
        np.testing.assert_array_equal(a, b)
    assert tguard.report() == jguard.report()
    assert set(tguard.entries()) == set(jguard.entries())
    assert tnew == jnew == 0
    want_new = {"dynamic": 1, "chunked": 0, "table": 0}[mode]
    assert tguard.new_compiles("decode") == want_new


def test_strict_guard_raises_on_a_new_signature():
    """After warm-up a registration on the dynamic engine re-stacks the
    tenant rows: the decode step's next call has a seen signature with
    new stack shapes (a retrace in the reference), and a strict guard
    raises at that call; under warmup() it does not."""
    _, _, _, tcfg, tbase, tten = _fleet()
    eng = ContinuousEngine(tcfg, tbase, n_slots=3, max_seq=32,
                           clock=VirtualClock(tick=1e-3))
    prompts = _prompts(tcfg.vocab)
    for i in range(2):
        eng.register_tenant(f"t{i}", tten[i])
    for i, p in enumerate(prompts[:2]):
        eng.submit(f"t{i}", p, max_new_tokens=6, arrival=0.0)
    eng.step(eng._now())
    eng.step(eng._now())
    guard = CompileGuard(eng, strict=True, label="inject").attach()
    eng.register_tenant("t2", tten[2])
    with pytest.raises(CompileBudgetError, match=r"\[inject\] jit retrace outside warmup"):
        eng.step(eng._now())
    guard.detach()
    assert guard.new_compiles("decode") == 1
    assert len(guard.retraces) == 1
    # the same retrace inside warmup() is allowed and re-baselined
    eng2 = ContinuousEngine(tcfg, tbase, n_slots=3, max_seq=32,
                            clock=VirtualClock(tick=1e-3))
    eng2.register_tenant("t0", tten[0])
    eng2.submit("t0", prompts[0], max_new_tokens=6, arrival=0.0)
    eng2.step(eng2._now())
    eng2.step(eng2._now())
    g2 = CompileGuard(eng2, strict=True, max_new={"decode": 0}).attach()
    with g2.warmup():
        eng2.register_tenant("t1", tten[1])
        eng2.step(eng2._now())
    g2.check()
    g2.detach()


def test_entries_resolve_as_in_the_reference():
    """Every ENTRY_PATHS name the reference resolves on an engine
    resolves on the port's: the four step entries always, the table's
    write with tenant_capacity, residency's promote with an enabled
    tier."""
    _, _, _, tcfg, tbase, tten = _fleet()
    eng = ContinuousEngine(tcfg, tbase, n_slots=2, max_seq=32)
    assert set(CompileGuard(eng).entries()) == {"decode", "prefill", "decode_masked",
                                                "combined"}
    eng = ContinuousEngine(tcfg, tbase, n_slots=2, max_seq=32, tenant_capacity=2,
                           residency_budget_bytes=1 << 30)
    eng.register_tenant("t0", tten[0])
    eng.submit("t0", _prompts(tcfg.vocab)[0], max_new_tokens=2)
    eng.run()
    assert set(CompileGuard(eng).entries()) == set(ENTRY_PATHS)
    assert CompileGuard(eng).sizes()["table_write"] == 1


# ---------------------------------------------------------------------------
# deltalint: the reference's fixtures, placed under repro_torch/
# ---------------------------------------------------------------------------
_FULL_CODEC = """
class GoodCodec:
    name = 'good'
    spec_cls = object
    leaf_cls = object
    def compress_leaf(self): ...
    def reconstruct_dense(self): ...
    def runtime_packed(self): ...
    def storage_bits(self): ...
    def to_storage_parts(self): ...
    def from_storage_parts(self): ...
    def leaf_spec(self): ...
    def leaf_axes(self): ...
register_codec(GoodCodec())
"""

# (source, path under the package): tests/test_analysis_lint.py's
# single-file fixtures of the rules the port keeps
FIXTURES = [
    ("import jax.numpy as jnp\n"
     "y = jnp.einsum('ij,jk->ik', a, b)  # deltalint: allow[DL001]\n", "core/apply.py"),
    ("import time\nimport numpy as np\n"
     "s = hash(path)\nt = time.time()\nr = np.random.rand(3)\n"
     "g = np.random.default_rng()\n", "core/compress.py"),
    ("import time\nimport zlib\nimport numpy as np\n"
     "s = zlib.crc32(path.encode())\nt = time.monotonic()\n"
     "g = np.random.default_rng(1234)\nr = g.normal(size=3)\n", "serve/engine.py"),
    ("import time\nt0 = time.time()\n", "launch/serve.py"),
    ("def f(x):\n    assert x > 0\n    return x\n", "models/ssm.py"),
    ("def f(x):\n    if x <= 0:\n        raise ValueError(f'x={x} must be positive')\n"
     "    return x\n", "models/ssm.py"),
    ("def step(x):\n    # deltalint: allow[DL003] traced-body shape invariant\n"
     "    assert x.shape[1] == 1\n", "models/ssm.py"),
    ("def go(bus, name, t):\n    bus.emit(name, t)\n", "serve/registry.py"),
    ("class HalfCodec:\n    name = 'half'\n    def compress_leaf(self): ...\n"
     "register_codec(HalfCodec())\n", "core/codecs.py"),
    (_FULL_CODEC, "core/codecs.py"),
    # every member but the sharding twin leaf_axes: DL006 fires in both
    (_FULL_CODEC.replace("    def leaf_axes(self): ...\n", ""), "core/codecs.py"),
    ("class Base:\n    name = 'b'\n    spec_cls = object\n    leaf_cls = object\n"
     "    def compress_leaf(self): ...\n    def reconstruct_dense(self): ...\n"
     "    def runtime_packed(self): ...\n    def storage_bits(self): ...\n"
     "    def to_storage_parts(self): ...\n    def from_storage_parts(self): ...\n"
     "    def leaf_spec(self): ...\nclass Child(Base):\n    def leaf_axes(self): ...\n"
     "register_codec(Child())\n", "core/codecs.py"),
    ("def pack(leaves, seen=[]):\n    for k in set(leaves):\n        seen.append(k)\n",
     "core/pack.py"),
    ("def pack(leaves, seen=None):\n    seen = [] if seen is None else seen\n"
     "    for k in sorted(set(leaves)):\n        seen.append(k)\n", "core/codecs.py"),
    ("def f(xs=[]):\n    pass\n", "serve/engine.py"),
    ("def submit(self, tenant):\n    raise ValueError('unknown tenant')\n",
     "serve/engine.py"),
    ("def merge(self, other):\n    raise RuntimeError()\n"
     "def check(self, x):\n    raise TypeError('bad ' + 'layout')\n", "serve/telemetry.py"),
    ("def submit(self, tenant):\n    raise ValueError(f'unknown tenant {tenant!r}')\n"
     "def place(self, slot):\n    raise RuntimeError('slot %d occupied' % slot)\n",
     "serve/scheduler.py"),
    ("def _inner(x):\n    raise ValueError('nope')\n", "serve/engine.py"),
    ("def f(x):\n    raise ValueError('nope')\n", "core/pack.py"),
]


def _where(findings):
    return [(f.rule, f.line, f.col) for f in findings]


@pytest.mark.parametrize("i", range(len(FIXTURES)))
def test_lint_fixture_findings_equal_reference(i):
    src, rel = FIXTURES[i]
    want = _where(j_lint_source(src, "repro/" + rel))
    assert _where(lint_source(src, "repro_torch/" + rel)) == want


_TRACE_SRC = ("EVENT_SCHEMA = {\n    'token': 'engine: one token',\n"
              "    'ghost': 'documented but never emitted',\n}\n")


def _tree(root, pkg, trace_src, engine_src):
    d = root / pkg / "serve"
    d.mkdir(parents=True)
    (d / "trace.py").write_text(trace_src)
    if engine_src is None:
        return [str(d / "trace.py")]
    (d / "engine.py").write_text(engine_src)
    return [str(d / "trace.py"), str(d / "engine.py")]


@pytest.mark.parametrize("trace_src,engine_src", [
    (_TRACE_SRC, "def go(bus, t):\n    bus.emit('token', t)\n    bus.emit('tokn', t)\n"),
    ("EVENT_SCHEMA = {'token': 'engine: one token'}\n",
     "def go(self, t):\n    self.bus.emit('token', t)\n"
     "    self.engine.bus.emit('token' if t else 'token', t)\n"),
    (_TRACE_SRC, None),
])
def test_lint_dl004_cross_file_equals_reference(tmp_path, trace_src, engine_src):
    jp = _tree(tmp_path / "j", "repro", trace_src, engine_src)
    tp = _tree(tmp_path / "t", "repro_torch", trace_src, engine_src)
    want = [(Path(f.path).name, f.rule, f.line, f.col) for f in j_lint_paths(jp)]
    got = [(Path(f.path).name, f.rule, f.line, f.col) for f in lint_paths(tp)]
    assert got == want


DL001_FIRES = [
    "import torch\ny = torch.einsum('bi,bio->bo', x, w)\n",
    "import torch\ny = torch.matmul(x, w)\n",
    "import torch\ny = torch.mm(x, w)\n",
    "import torch\ny = torch.bmm(x, w)\n",
    "import torch\ny = torch.tensordot(x, w, dims=1)\n",
    "y = x @ w\n",
    "y = (x.to(dt) @ w.to(dt)).sum(0)\n",
]


@pytest.mark.parametrize("src", DL001_FIRES)
@pytest.mark.parametrize("rel", ["kernels/fallback.py", "core/apply.py"])
def test_dl001_fires_on_torch_products(src, rel):
    found = [f for f in lint_source(src, "repro_torch/" + rel) if f.rule == "DL001"]
    assert len(found) == 1 and found[0].line == src.count("\n")


def test_dl001_silent_on_sanctioned_twin_and_out_of_scope():
    ok = ("import torch\n"
          "y = (x[:, :, None] * dense).sum(dim=1)\n"
          "z = torch.take_along_dim(x, i, dim=-2) * v\n")
    assert lint_source(ok, "repro_torch/kernels/fallback.py") == []
    for src in DL001_FIRES:
        assert lint_source(src, "repro_torch/models/lm.py") == []
    allowed = ("y = x @ w  # deltalint: allow[DL001] base GEMM, not the correction\n"
               "# deltalint: allow[DL001] the reference's reconstruct path\n"
               "z = torch.matmul(x, w)\n")
    assert lint_source(allowed, "repro_torch/core/apply.py") == []


def test_dl005_has_no_counterpart():
    """The eager port builds no jit: DL005 stays in the rule table, says
    so, and never fires (the reference's DL005 fixture is silent here)."""
    assert "no counterpart" in RULES["DL005"]
    src = "import jax\nfor f in fns:\n    g = jax.jit(f)\ny = jax.jit(h)(x)\n"
    assert [f.rule for f in j_lint_source(src, "repro/kernels/autotune.py")] == ["DL005"] * 2
    assert lint_source(src, "repro_torch/kernels/autotune.py") == []


def test_shipped_port_tree_is_clean():
    findings = lint_paths([str(REPO / "src" / "repro_torch")])
    assert findings == [], "\n".join(f.format() for f in findings)


def test_port_lint_cli_exits_zero_and_one(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    report = tmp_path / "findings.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint",
         str(REPO / "src" / "repro_torch"), "--json", str(report)],
        capture_output=True, text=True, cwd=str(REPO), env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    data = json.loads(report.read_text())
    assert data["findings"] == [] and data["files"] > 50
    bad = tmp_path / "repro_torch" / "core"
    bad.mkdir(parents=True)
    (bad / "pack.py").write_text("def f(x):\n    assert x\n")
    proc = subprocess.run([sys.executable, "-m", "repro_torch.analysis.lint", str(tmp_path)],
                          capture_output=True, text=True, cwd=str(REPO), env=env)
    assert proc.returncode == 1 and "DL003" in proc.stdout
