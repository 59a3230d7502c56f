"""The port's dense LM against the JAX reference.

Weights and packed deltas come from the reference (random init,
128x-spec compression of a perturbed copy) and are carried across by
``repro_torch.convert``. Logits of ``forward``, ``prefill`` and
``decode_step`` must agree:

* f32 ``param_dtype``: atol/rtol 1e-4 (only summation order differs);
* bf16 ``param_dtype``: atol/rtol 1e-3 plus greedy argmax agreement.
  The weights are bf16 but the residual stream is f32 in both packages
  (embeddings and norms are f32), so the gap stays small; the looser
  bound leaves room for the two frameworks' bf16->f32 matmul kernels.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config  # noqa: E402
from repro.core import DeltaDQSpec, compress  # noqa: E402
from repro.models import lm as jlm  # noqa: E402

from repro_torch.core.apply import merge_delta  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402

import torch_bridge as br  # noqa: E402

TOL = {"float32": dict(atol=1e-4, rtol=1e-4), "bfloat16": dict(atol=1e-3, rtol=1e-3)}
MOE_ARCHS = ["qwen3-moe-30b-a3b", "llama4-scout-17b-a16e"]
ARCHS = ["wizard-llama2-7b", "llama3.2-1b", "gemma3-1b", "gemma-7b", "phi3-medium-14b",
         *MOE_ARCHS]
SPEC = DeltaDQSpec(alpha=8.0, k_bits=4, m=8, h_g=16)

# the reference's model functions under jit, as its engines call them:
# one compile per shape instead of one per primitive
j_forward = jax.jit(jlm.forward, static_argnums=0, static_argnames="remat")
j_prefill = jax.jit(jlm.prefill, static_argnums=0)
j_decode = jax.jit(jlm.decode_step, static_argnums=0)


@functools.lru_cache(maxsize=None)
def _setup(name, dtype):
    cfg = dataclasses.replace(get_smoke_config(name), param_dtype=dtype)
    base = jlm.init_params(cfg, jax.random.PRNGKey(0))
    ft = jax.tree.map(
        lambda p: p + 0.02 * jax.random.normal(jax.random.PRNGKey(1), p.shape,
                                               jnp.float32).astype(p.dtype)
        if p.ndim >= 2 else p, base)
    deltas, _ = compress(base, ft, SPEC)
    return cfg, base, deltas, br.params_to_port(base), br.deltas_to_port(deltas)


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(np.int32)


def _check(got, want, dtype):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, **TOL[dtype])
    assert (got.argmax(-1) == want.argmax(-1)).all()


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_deltas", [False, True])
def test_forward_logits_match_reference(name, dtype, with_deltas):
    cfg, base, deltas, tbase, tdeltas = _setup(name, dtype)
    toks = _tokens(cfg, 2, 12, 0)
    want = j_forward(cfg, base, {"tokens": jnp.asarray(toks)},
                     deltas=deltas if with_deltas else None)
    got = tlm.forward(cfg, tbase, {"tokens": torch.from_numpy(toks).long()},
                      deltas=tdeltas if with_deltas else None)
    _check(got, want, dtype)


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_logits_match_reference(name, dtype):
    cfg, base, deltas, tbase, tdeltas = _setup(name, dtype)
    B, S, max_seq = 2, 8, 16
    toks = _tokens(cfg, B, S, 1)
    for d, td in ((None, None), (deltas, tdeltas)):
        jc = jlm.init_cache(cfg, B, max_seq)
        jlog, jc = j_prefill(cfg, base, {"tokens": jnp.asarray(toks)}, jc, deltas=d)
        tc = tlm.init_cache(cfg, B, max_seq, device="cpu")
        tlog, tc = tlm.prefill(cfg, tbase, {"tokens": torch.from_numpy(toks).long()},
                               tc, deltas=td)
        _check(tlog, jlog, dtype)
        for t in range(3):
            nxt = np.asarray(jnp.argmax(jlog, axis=-1)).astype(np.int32)[:, None]
            jlog, jc = j_decode(cfg, base, jc, jnp.asarray(nxt),
                                jnp.int32(S + t), deltas=d)
            tlog, tc = tlm.decode_step(cfg, tbase, tc, torch.from_numpy(nxt).long(),
                                       S + t, deltas=td)
            _check(tlog, jlog, dtype)
        for f in ("k", "v", "pos"):
            np.testing.assert_allclose(
                tc[0][f].to(torch.float32).numpy(),
                np.asarray(jc[0][f]).astype(np.float32), **TOL[dtype])


def test_decode_step_per_slot_positions_match_reference():
    cfg, base, deltas, tbase, tdeltas = _setup("wizard-llama2-7b", "float32")
    B, max_seq = 3, 16
    jc = jlm.init_cache(cfg, B, max_seq)
    tc = tlm.init_cache(cfg, B, max_seq, device="cpu")
    # left-padded prompts: negative positions mark pad slots
    toks = _tokens(cfg, B, 6, 2)
    pos = np.array([[-2, -1, 0, 1, 2, 3], [0, 1, 2, 3, 4, 5], [-1, 0, 1, 2, 3, 4]],
                   np.int32)
    jlog, jc = j_prefill(cfg, base, {"tokens": jnp.asarray(toks),
                                     "positions": jnp.asarray(pos)}, jc, deltas=deltas)
    tlog, tc = tlm.prefill(cfg, tbase, {"tokens": torch.from_numpy(toks).long(),
                                        "positions": torch.from_numpy(pos).long()},
                           tc, deltas=tdeltas)
    _check(tlog, jlog, "float32")
    step_pos = pos[:, -1] + 1
    nxt = _tokens(cfg, B, 1, 3)
    jlog, jc = j_decode(cfg, base, jc, jnp.asarray(nxt), jnp.asarray(step_pos),
                        deltas=deltas)
    tlog, tc = tlm.decode_step(cfg, tbase, tc, torch.from_numpy(nxt).long(),
                               torch.from_numpy(step_pos).long(), deltas=tdeltas)
    _check(tlog, jlog, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_separate_computation_equals_merged_weights(dtype):
    """Serving base + packed delta equals serving the merged weights
    (examples/quickstart.py:31-36), inside the port."""
    cfg, _, _, tbase, tdeltas = _setup("wizard-llama2-7b", dtype)
    toks = torch.from_numpy(_tokens(cfg, 2, 16, 4)).long()
    sep = tlm.forward(cfg, tbase, {"tokens": toks}, deltas=tdeltas)
    merged = tlm.forward(cfg, merge_delta(tbase, tdeltas), {"tokens": toks})
    # bf16 merged weights round base + delta once more than the separate path
    tol = 1e-4 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(sep.numpy(), merged.numpy(), atol=tol, rtol=tol)


def test_port_init_params_layout_matches_reference():
    cfg = get_smoke_config("wizard-llama2-7b")
    ref = br.flatten_with_paths(jlm.param_specs(cfg))
    got = tlm.param_shapes(cfg)
    assert set(got) == set(ref)
    for path, (shape, dtype) in got.items():
        assert tuple(shape) == tuple(ref[path].shape), path
        assert str(dtype).replace("torch.", "") == ref[path].dtype.name, path
    p1 = tlm.init_params(cfg, 0, device="cpu")
    p2 = tlm.init_params(cfg, 0, device="cpu")
    assert torch.equal(p1["attn"]["wq"], p2["attn"]["wq"])
    assert p1["attn"]["wq"].dtype == torch.bfloat16


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_port_moe_params_layout_matches_reference(name):
    cfg = get_smoke_config(name)
    ref = br.flatten_with_paths(jlm.param_specs(cfg))
    got = tlm.param_shapes(cfg)
    assert set(got) == set(ref)
    for path, (shape, dtype) in got.items():
        assert tuple(shape) == tuple(ref[path].shape), path
        assert str(dtype).replace("torch.", "") == ref[path].dtype.name, path
    from repro_torch.configs import get_smoke_config as t_smoke
    assert t_smoke(name).n_params() == cfg.n_params()
    assert t_smoke(name).n_active_params() == cfg.n_active_params()


@pytest.mark.parametrize("name", MOE_ARCHS)
@pytest.mark.parametrize("B", [1, 3, 5])
def test_moe_decode_batch_sizes_match_reference(name, B):
    """Decode at several batch sizes: the capacity C = max(int(B * K / E *
    1.25), 1) changes with B, so the drops of each step differ."""
    cfg, base, deltas, tbase, tdeltas = _setup(name, "float32")
    S, max_seq = 6, 12
    toks = _tokens(cfg, B, S, 10 + B)
    jc = jlm.init_cache(cfg, B, max_seq)
    jlog, jc = j_prefill(cfg, base, {"tokens": jnp.asarray(toks)}, jc, deltas=deltas)
    tc = tlm.init_cache(cfg, B, max_seq, device="cpu")
    tlog, tc = tlm.prefill(cfg, tbase, {"tokens": torch.from_numpy(toks).long()}, tc,
                           deltas=tdeltas)
    _check(tlog, jlog, "float32")
    for t in range(3):
        nxt = _tokens(cfg, B, 1, 20 + t)
        jlog, jc = j_decode(cfg, base, jc, jnp.asarray(nxt), jnp.int32(S + t), deltas=deltas)
        tlog, tc = tlm.decode_step(cfg, tbase, tc, torch.from_numpy(nxt).long(), S + t,
                                   deltas=tdeltas)
        _check(tlog, jlog, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decompress_matches_reference(dtype):
    """The merge path (``decompress`` -> ``merge_delta`` -> ``ops.dequant``
    per layer slice) against the reference's ``decompress``."""
    from repro.core.compress import decompress as j_decompress

    from repro_torch.core import decompress
    from repro_torch.utils import iter_leaves

    cfg, base, deltas, tbase, tdeltas = _setup("wizard-llama2-7b", dtype)
    want = dict(iter_leaves(br.params_to_port(jax.jit(j_decompress)(base, deltas))))
    got = dict(iter_leaves(decompress(tbase, tdeltas)))
    assert set(got) == set(want)
    for path, g in got.items():
        w = want[path]
        assert g.dtype == w.dtype and g.shape == w.shape, path
        if dtype == "float32":
            assert torch.equal(g, w), path
        else:
            np.testing.assert_allclose(g.float().numpy(), w.float().numpy(),
                                       **TOL[dtype], err_msg=path)


def test_quickstart_separate_equals_merged_within_bound():
    from repro_torch.configs import get_smoke_config as t_smoke
    from repro_torch.launch import quickstart

    cfg = t_smoke(quickstart.ARCH)
    out = quickstart.run(cfg, device="cpu", verbose=False)
    assert tuple(out["separate"].shape) == (2, 16, cfg.vocab)
    assert bool(torch.isfinite(out["separate"]).all())
    assert out["rel"] <= quickstart.REL_TOL and out["ok"], out["rel"]
