"""The port's serving path: ``Engine.generate`` against the JAX reference,
mixed-tenant decode against per-tenant decode inside the port, and the
port's import boundary (no jax, no ``repro``).
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config  # noqa: E402
from repro.core import DeltaDQSpec, compress  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402

from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.core.apply import (  # noqa: E402
    stack_tenant_deltas,
    wrap_slot_deltas,
    zero_delta_like,
)
from repro_torch.launch.serve import RATIO_SPECS, synth_tenants  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.serve import Engine, tenant_segments  # noqa: E402

import torch_bridge as br  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = DeltaDQSpec(alpha=8.0, k_bits=4, m=8, h_g=16)
# the serving slice's modules, which the boundary test must reach
SERVING_MODULES = ("repro_torch.serve.kv", "repro_torch.serve.metrics",
                   "repro_torch.serve.telemetry", "repro_torch.serve.engine",
                   "repro_torch.serve.registry", "repro_torch.core.codecs",
                   "repro_torch.launch.serve", "repro_torch.launch.mesh",
                   "repro_torch.dist.sharding", "repro_torch.dist.grad_compress")


def _fleet(dtype, n=2):
    cfg = dataclasses.replace(get_smoke_config("wizard-llama2-7b"), param_dtype=dtype)
    base = jlm.init_params(cfg, jax.random.PRNGKey(0))
    tenants = []
    for t in range(n):
        ft = jax.tree.map(
            lambda p, t=t: p + 0.02 * jax.random.normal(
                jax.random.PRNGKey(7 + t), p.shape, jnp.float32).astype(p.dtype)
            if p.ndim >= 2 else p, base)
        tenants.append((f"tenant{t}", compress(base, ft, SPEC)[0]))
    return cfg, base, tenants


def test_generate_tokens_match_reference_f32():
    """f32 params: the logits agree to ~1e-5, so greedy tokens are equal."""
    cfg, base, tenants = _fleet("float32")
    jeng = JEngine(cfg, base, max_seq=32)
    teng = Engine(cfg, br.params_to_port(base), max_seq=32)
    for name, d in tenants:
        jeng.register_tenant(name, d)
        teng.register_tenant(name, br.deltas_to_port(d))
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (2, 8)).astype(np.int32)
    outs = {}
    for tenant in (None, "tenant0", "tenant1"):
        want = jeng.generate(tenant, prompts, max_new_tokens=6)
        got = teng.generate(tenant, prompts, max_new_tokens=6)
        np.testing.assert_array_equal(got, want)
        outs[tenant] = got
    assert not np.array_equal(outs[None], outs["tenant0"])


def test_generate_logits_match_reference_bf16():
    """bf16 params: the frameworks round at different places, so a near
    tie may flip a token — hold the logits (teacher-forced through the
    reference on the port's tokens) at atol/rtol 1e-3 instead."""
    cfg, base, tenants = _fleet("bfloat16", n=1)
    name, d = tenants[0]
    teng = Engine(cfg, br.params_to_port(base), max_seq=32)
    teng.register_tenant(name, br.deltas_to_port(d))
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, (2, 8)).astype(np.int32)
    logits = []
    toks = teng.generate(name, prompts, max_new_tokens=5, logits_out=logits)
    cache = jlm.init_cache(cfg, 2, 32)
    jlog, cache = jax.jit(jlm.prefill, static_argnums=0)(
        cfg, base, {"tokens": jnp.asarray(prompts)}, cache, deltas=d)
    j_decode = jax.jit(jlm.decode_step, static_argnums=0)
    for t in range(5):
        np.testing.assert_allclose(logits[t].numpy(), np.asarray(jlog), atol=1e-3, rtol=1e-3)
        jlog, cache = j_decode(cfg, base, cache, jnp.asarray(toks[:, t:t + 1]),
                                      jnp.int32(8 + t), deltas=d)


def test_mixed_slot_decode_equals_per_tenant_decode_exactly():
    _mixed_slot_decode_equals_per_tenant_decode(skip_zero_row=False)


def test_mixed_slot_decode_zero_row_skipped_equals_per_tenant_decode():
    """The engine's layout: base slots (row 0) are in no segment and get a
    zero-filled correction, bit-equal to decoding the zero delta."""
    _mixed_slot_decode_equals_per_tenant_decode(skip_zero_row=True)


def _mixed_slot_decode_equals_per_tenant_decode(skip_zero_row):
    """One decode step over 8 slots of {base, tenant0..2} with per-slot
    positions (the call ContinuousEngine._decode_all makes) equals each
    tenant's own decode of the same batch, bit for bit, on the CPU."""
    cfg = t_smoke("wizard-llama2-7b")
    base = tlm.init_params(cfg, 0, device="cpu")
    fleet = synth_tenants(cfg, base, 3, RATIO_SPECS[128], seed=0)
    trees = [d for _, d, _ in fleet]
    rows = np.array([0, 1, 2, 3, 1, 0, 3, 2], np.int32)     # 0 = base
    B, S, max_seq = len(rows), 8, 32
    rng = np.random.default_rng(2)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))).long()
    pad = np.arange(B) % 3
    positions = torch.from_numpy(np.arange(S)[None, :] - pad[:, None]).long()
    step_tok = torch.from_numpy(rng.integers(0, cfg.vocab, (B, 1))).long()
    step_pos = torch.from_numpy(S - pad).long()

    per_tenant, caches = [], []
    for t in range(4):
        d = None if t == 0 else trees[t - 1]
        cache = tlm.init_cache(cfg, B, max_seq, device="cpu")
        _, cache = tlm.prefill(cfg, base, {"tokens": prompts, "positions": positions},
                               cache, deltas=d)
        caches.append([{k: v.clone() for k, v in c.items()} for c in cache])
        logits, _ = tlm.decode_step(cfg, base, cache, step_tok, step_pos, deltas=d)
        per_tenant.append(logits)

    # slot b's cache row comes from its own tenant's prefill
    mixed_cache = [{k: torch.stack([caches[rows[b]][li][k][b] for b in range(B)])
                    for k in ("k", "v", "pos")} for li in range(cfg.n_layers)]
    stacked = stack_tenant_deltas([zero_delta_like(trees[0])] + trees)
    seg = tenant_segments(rows, skip_zero_row=skip_zero_row).to("cpu")
    sd = wrap_slot_deltas(stacked, torch.from_numpy(rows).long(), segments=seg)
    mixed, _ = tlm.decode_step(cfg, base, mixed_cache, step_tok, step_pos, deltas=sd)
    for b in range(B):
        assert torch.equal(mixed[b], per_tenant[rows[b]][b]), b
    assert not torch.equal(per_tenant[1], per_tenant[0])


def test_port_imports_no_jax_and_no_reference():
    code = (
        "import sys, pkgutil, importlib\n"
        "import repro_torch\n"
        "walked = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,\n"
        "                                                'repro_torch.')]\n"
        "for name in walked:\n"
        "    importlib.import_module(name)\n"
        f"missing = set({SERVING_MODULES!r}) - set(walked)\n"
        "assert not missing, missing\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(REPO, "src"), REPO])
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("ok")


@pytest.mark.parametrize("module", SERVING_MODULES + ("chip_smoke", "chip_mesh_phase"))
def test_serving_sources_import_no_jax_and_no_reference(module):
    """No import of jax or ``repro`` anywhere in the source, function-level
    imports included (the subprocess check sees module-level ones)."""
    rel = module.replace(".", os.sep) + ".py"
    top = module in ("chip_smoke", "chip_mesh_phase")
    path = os.path.join(REPO, rel if top else os.path.join("src", rel))
    with open(path) as f:
        lines = [ln.strip() for ln in f]
    bad = [ln for ln in lines if ln.startswith(("import ", "from "))
           and ln.split()[1].split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad
