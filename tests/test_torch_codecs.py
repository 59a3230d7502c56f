"""The port's codec family against the JAX reference: BitDelta and
LowRank leaves, their runtime lowerings, ``compress`` by codec name and
``codec="auto"``, and mixed-codec serving.

Integer arrays (sign bits, packed codes, ``idx``) and the LowRank SVD
factors (the same numpy call on the same f32 residual) must match
EXACTLY; BitDelta's scale (a mean, summed in another order) and
LowRank's dense reconstruction (a matmul) within 1e-6 relative.
Mixed-codec engines run on the f32 smoke config: tokens equal to each
tenant served alone (exact) and to the JAX engine's, logits within
1e-4 of the reference's (f32, summation order only). Inputs are made
from numpy seeds or carried across from JAX leaves (``torch_bridge``).
"""
import dataclasses
import functools
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.core import BitDeltaSpec as JBitDeltaSpec  # noqa: E402
from repro.core import DeltaDQSpec as JSpec  # noqa: E402
from repro.core import LowRankSpec as JLowRankSpec  # noqa: E402
from repro.core import codecs as jc  # noqa: E402
from repro.core import compress as jcompress  # noqa: E402
from repro.core import decompress as jdecompress  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import ContinuousEngine as JContinuousEngine  # noqa: E402
from repro.serve import VirtualClock as JVirtualClock  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import codecs as tc  # noqa: E402
from repro_torch.core import pack as tpack  # noqa: E402
from repro_torch.core.apply import stack_tenant_deltas, zero_delta_like  # noqa: E402
from repro_torch.core.compress import compress, compress_leaf_layerwise, decompress  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve import ContinuousEngine, VirtualClock  # noqa: E402
from repro_torch.serve.scheduler import tenant_segments  # noqa: E402
from repro_torch.serve.trace import attribution  # noqa: E402

import torch_bridge as br  # noqa: E402

ARCH = "wizard-llama2-7b"
REL = 1e-6                        # f32 sums/products in another order
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
SPECS = {"bitdelta": (JBitDeltaSpec(), tc.BitDeltaSpec()),
         "lowrank": (JLowRankSpec(rank=4), tc.LowRankSpec(rank=4))}
SHAPES = [(64, 48), (2, 96, 40)]


def _np(t):
    return t.detach().cpu().numpy()


def _pair(shape, seed=0):
    rng = np.random.default_rng(seed + len(shape))
    b = rng.standard_normal(shape).astype(np.float32)
    return b, (b + 0.02 * rng.standard_normal(shape)).astype(np.float32)


def _both_leaves(name, shape):
    """(jax leaf, port leaf) of the same (base, ft) pair; the port's
    stacked leaf is compressed a matrix at a time."""
    b, f = _pair(shape)
    jspec, tspec = SPECS[name]
    jl = jc.get_codec(name).compress_leaf(jax.random.PRNGKey(0), jnp.asarray(b),
                                          jnp.asarray(f), jspec)
    ft = torch.from_numpy(f)
    tl = compress_leaf_layerwise(tc.get_codec(name), tspec, torch.from_numpy(b),
                                 lambda i: ft.reshape(-1, *shape[-2:])[i])
    return jl, tl


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


# ---------------------------------------------------------------------------
# Leaves and lowerings
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", sorted(SPECS))
def test_codec_leaf_matches_reference(name, shape):
    jl, tl = _both_leaves(name, shape)
    got = br.leaf_to_port(jl)
    assert type(got) is type(tl) and tl.stack_shape() == jl.stack_shape()
    exact = {"bitdelta": ("sign",), "lowrank": ("codes", "zero", "u", "v", "scale")}[name]
    for f in exact:
        np.testing.assert_array_equal(_np(getattr(tl, f)), _np(getattr(got, f)), err_msg=f)
    if name == "bitdelta":
        assert _rel(_np(tl.scale), _np(got.scale)) <= REL
    assert tc.get_codec(name).storage_bits(tl) == jc.get_codec(name).storage_bits(jl)
    assert _rel(_np(tc.get_codec(name).reconstruct_dense(tl)),
                jc.get_codec(name).reconstruct_dense(jl)) <= REL


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", sorted(SPECS))
def test_runtime_lowering_matches_reference_and_is_bit_faithful(name, shape):
    """The serving contract (``test_core_pack.py::
    test_codec_runtime_lowering_bit_faithful``): the PackedDelta lowering
    reconstructs exactly the codec's own dense delta; its integer arrays
    equal the reference's lowering bit for bit, and idx is contiguous."""
    jl, tl = _both_leaves(name, shape)
    c = tc.get_codec(name)
    rt = c.runtime_packed(tl)
    want = jc.get_codec(name).runtime_packed(jl)
    assert isinstance(rt, tpack.PackedDelta) and rt.codec == name
    assert (rt.h_g, rt.keep, rt.alpha, rt.k_bits, rt.m) == \
        (want.h_g, want.keep, want.alpha, want.k_bits, want.m)
    assert rt.idx.is_contiguous() and rt.codes.is_contiguous()
    for f in ("idx", "zero") + (("codes",) if name == "bitdelta" else ("scale",)):
        np.testing.assert_array_equal(_np(getattr(rt, f)), np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert _rel(_np(rt.codes if name == "lowrank" else rt.scale),
                getattr(want, "codes" if name == "lowrank" else "scale")) <= REL
    assert torch.equal(tpack.reconstruct_dense(rt), c.reconstruct_dense(tl))
    assert torch.equal(c.decode_values(tl), tpack.decode_values(rt))


def test_lowering_of_full_width_site_is_inside_the_kernel_envelope():
    """The wi site of wizard-llama2-7b at full width (h_in 4096, and MLP
    wo's 11008): keep = h_g = 128, so both correction kernels take the
    lowerings (checked on a zero-filled leaf, shapes only)."""
    for h_in in (4096, 11008):
        leaf = tc.BitDeltaLeaf(sign=torch.zeros((h_in // 8, 8), dtype=torch.uint8),
                               scale=torch.tensor(0.0), h_in=h_in, h_out=8)
        rt = tc.get_codec("bitdelta").runtime_packed(leaf)
        assert (rt.h_g, rt.keep, rt.k_bits) == (128, 128, 2)
        assert ops.kernel_supported(rt) and ops.envelope_miss(rt) is None


# ---------------------------------------------------------------------------
# compress over a params tree
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _smoke_pair():
    cfg = j_smoke(ARCH)
    base = jlm.init_params(cfg, jax.random.PRNGKey(0))
    ft = jax.tree.map(
        lambda p: p + 0.02 * jax.random.normal(jax.random.PRNGKey(1), p.shape,
                                               jnp.float32).astype(p.dtype)
        if p.ndim >= 2 else p, base)
    return base, ft, br.params_to_port(base), br.params_to_port(ft)


@pytest.mark.parametrize("name", ["deltadq", "bitdelta", "lowrank"])
def test_compress_by_codec_name_matches_reference_bits(name):
    jbase, jft, base, ft = _smoke_pair()
    jd, jrep = jcompress(jbase, jft, codec=name)
    td, trep = compress(base, ft, codec=name)
    assert dataclasses.asdict(trep.spec) == dataclasses.asdict(jrep.spec)
    for f in ("n_compressed", "n_dense", "dense_delta_bits", "packed_value_bits",
              "packed_total_bits", "ratio_paper", "ratio_honest"):
        assert getattr(trep, f) == getattr(jrep, f), f
    assert trep.per_codec == jrep.per_codec and trep.leaf_codecs == jrep.leaf_codecs
    assert trep.summary() == jrep.summary()
    if name == "bitdelta":           # sign bits of every leaf, exactly
        for path, leaf in br.flatten_with_paths(
                jd, is_leaf=lambda x: x is None or jc.is_codec_leaf(x)).items():
            if leaf is not None:
                node = td
                for k in path.split("/"):
                    node = node[k]
                np.testing.assert_array_equal(_np(node.sign), np.asarray(leaf.sign))


def test_bitdelta_report_bits_hand_computed():
    """``test_core_compress.py::test_bitdelta_report_bits_hand_computed``."""
    g = torch.Generator().manual_seed(5)
    base = {"attn": {"wq": torch.randn(32, 16, generator=g),
                     "wo": torch.randn(64, 16, generator=g)},
            "mlp": {"wi": torch.randn(32, 24, generator=g)}}
    ft = {k: {n: w + 0.01 for n, w in v.items()} for k, v in base.items()}
    _, report = compress(base, ft, tc.BitDeltaSpec())
    value = 32 * 16 + 64 * 16 + 32 * 24
    total = value + 3 * 32
    assert report.n_compressed == 3
    assert report.packed_value_bits == value and report.packed_total_bits == total
    assert report.dense_delta_bits == 16 * value
    assert report.per_codec["bitdelta"]["total_bits"] == total
    assert report.ratio_paper == pytest.approx(16.0)


@pytest.mark.parametrize("budget", [2.0, 0.5, 8.0])
def test_auto_picks_the_reference_codec_per_leaf(budget):
    """``codec="auto"``: the same codec per leaf and the same budget_met
    as ``repro.core.compress`` (the candidates' errors are far apart, so
    DeltaDQ's other dropout keys cannot change a pick)."""
    jbase, jft, base, ft = _smoke_pair()
    _, jrep = jcompress(jbase, jft, codec="auto", budget_bits=budget)
    td, trep = compress(base, ft, codec="auto", budget_bits=budget)
    assert trep.leaf_codecs == jrep.leaf_codecs
    assert trep.budget_met == jrep.budget_met
    assert trep.budget_bits == budget and trep.spec is None
    for path, ch in trep.auto_choices.items():
        want = jrep.auto_choices[path]
        assert ch["codec"] == want["codec"] and ch["budget_met"] == want["budget_met"]
        assert ch["bits_per_element"] == want["bits_per_element"]
    assert f"auto(budget={budget}" in trep.summary()


@pytest.mark.parametrize("budget,lowrank_calls", [(2.0, 0), (0.5, 7)])
def test_auto_compresses_lowrank_only_when_nothing_fits(budget, lowrank_calls,
                                                        monkeypatch):
    """LowRank's size is fixed by the shapes (``planned_total_bits``, equal
    to its compressed leaf's ``storage_bits``): over the budget, it can
    win only when no candidate fits, so its host SVD runs only then."""
    _, _, base, ft = _smoke_pair()
    c = tc.get_codec("lowrank")
    _, tl = _both_leaves("lowrank", (2, 96, 40))
    assert c.planned_total_bits((2, 96, 40), tc.LowRankSpec(rank=4)) == \
        c.storage_bits(tl)["total_bits"]
    calls = []
    real = tc.LowRankCodec.compress_leaf
    monkeypatch.setattr(tc.LowRankCodec, "compress_leaf",
                        lambda self, *a, **k: calls.append(1) or real(self, *a, **k))
    _, rep = compress(base, ft, codec="auto", budget_bits=budget)
    assert len(calls) == lowrank_calls * 2        # 7 leaves, 2 layers each
    assert rep.budget_met == (budget == 2.0)


def test_auto_and_codec_argument_errors():
    _, _, base, ft = _smoke_pair()
    with pytest.raises(ValueError, match="budget_bits"):
        compress(base, ft, codec="auto")
    with pytest.raises(ValueError, match="auto"):
        compress(base, ft, codec="bitdelta", budget_bits=1.0)
    with pytest.raises(ValueError, match="does not belong"):
        compress(base, ft, tc.BitDeltaSpec(), codec="deltadq")


def test_codec_registry_lookups():
    assert tc.codec_names() == jc.codec_names() == ["deltadq", "bitdelta", "lowrank"]
    for name in tc.codec_names():
        c = tc.get_codec(name)
        assert tc.codec_for_spec(c.default_spec()) is c
        assert dataclasses.asdict(c.default_spec()) == \
            dataclasses.asdict(jc.get_codec(name).default_spec())
    with pytest.raises(KeyError, match="unknown codec"):
        tc.get_codec("nope")
    with pytest.raises(ValueError, match="already registered"):
        tc.register_codec(tc.BitDeltaCodec())
    _, tl = _both_leaves("bitdelta", (64, 48))
    assert tc.codec_of_leaf(tl).name == "bitdelta" and tc.is_codec_leaf(tl)
    rt = tc.runtime_packed_leaf(tl)
    assert tc.codec_of_leaf(rt).name == "bitdelta"
    assert torch.equal(tc.reconstruct_dense_any(rt), tc.reconstruct_dense_any(tl))
    assert tc.runtime_packed_leaf(None) is None and tc.runtime_packed_leaf(rt) is rt


@pytest.mark.parametrize("name", ["bitdelta", "lowrank"])
def test_decompress_matches_reference(name):
    """Merge through reconstruct_dense_any, one layer slice at a time."""
    jbase, jft, base, ft = _smoke_pair()
    jd, _ = jcompress(jbase, jft, codec=name)
    got = decompress(base, br.deltas_to_port(jd))
    want = br.params_to_port(jdecompress(jbase, jd))
    for (p, a), (_, b) in zip(br.flatten_with_paths(got).items(),
                              br.flatten_with_paths(want).items()):
        diff = (a.float() - b.float()).abs()
        # bf16 weights: at most one rounding step apart where the f32
        # sums differ in their last bit
        assert float(diff.max()) <= float(b.float().abs().max()) * 2 ** -7, p


# ---------------------------------------------------------------------------
# The kernels' envelope and the zero row
# ---------------------------------------------------------------------------
def _wide_packed():
    """A dropout-only packing with h_g 512 (> MAX_HG) — out of envelope."""
    from repro_torch.core.dropout import groupwise_dropout_pack
    g = torch.Generator().manual_seed(3)
    return groupwise_dropout_pack(torch.randn(512, 16, generator=g) * 0.02,
                                  h_g=512, alpha=8.0, generator=g)


@pytest.mark.parametrize("entry", ["delta_spmm", "delta_spmm_segments",
                                   "delta_spmm_slots"])
def test_out_of_envelope_branch_leaves_a_note(entry):
    """A CPU tensor outside the envelope takes the plain formulation and
    leaves a note naming the failing dimension (a CUDA tensor raises)."""
    d = _wide_packed()
    assert ops.envelope_miss(d) == "h_g"
    x = torch.randn(3, 512, generator=torch.Generator().manual_seed(4))
    # the segments case serves row 1; the slots case rows 0 and 1
    stack = stack_tenant_deltas([{"w": d}, {"w": d}])["w"]
    with warnings.catch_warnings(), attribution() as notes:
        warnings.simplefilter("error")
        if entry == "delta_spmm":
            y = ops.delta_spmm(x, d)
        elif entry == "delta_spmm_segments":
            y = ops.delta_spmm_segments(x, stack, torch.tensor([1]), torch.tensor([0, 3]))
        else:
            y = ops.delta_spmm_slots(x[:2, None], stack)[:, 0]
    want = x[:y.shape[0]] @ tpack.reconstruct_dense(d)
    assert torch.allclose(y, want, atol=1e-5, rtol=1e-5)
    assert {"site": entry, "formulation": "plain-out-of-envelope", "codec": "deltadq",
            "dim": "h_g"} in notes


@pytest.mark.parametrize("name", ["bitdelta", "lowrank"])
def test_zero_row_gives_exact_zero(name):
    """Mixed-codec identity rests on a group's row 0 contributing exactly
    0.0 to rows it does not own."""
    _zero_row_gives_exact_zero(name, skip_zero_row=False)


@pytest.mark.parametrize("name", ["bitdelta", "lowrank"])
def test_skipped_zero_row_gives_exact_zero(name):
    """The engine's layout leaves row 0 out of every segment: its rows are
    zero-filled, the same exact 0.0, and the others keep their bits."""
    _zero_row_gives_exact_zero(name, skip_zero_row=True)


def _zero_row_gives_exact_zero(name, skip_zero_row):
    _, tl = _both_leaves(name, (64, 48))
    rt = tc.get_codec(name).runtime_packed(tl)
    stack = stack_tenant_deltas([zero_delta_like({"w": rt}), {"w": rt}])["w"]
    x = torch.randn(4, 64, generator=torch.Generator().manual_seed(6))
    seg = tenant_segments(np.array([0, 1, 0, 1], np.int32),
                          skip_zero_row=skip_zero_row).to("cpu")
    y = ops.delta_spmm_segments(x.index_select(0, seg.order), stack, seg.seg_rows,
                                seg.seg_offsets)
    y = y.index_select(0, seg.inv_order)
    assert torch.equal(y[[0, 2]], torch.zeros_like(y[[0, 2]]))
    assert torch.equal(y[[1, 3]], ops.delta_spmm(x[[1, 3]], rt))


@pytest.mark.parametrize("rows, offsets", [
    ([0, 2, 0, 1], [2, 3, 4, 4, 4]),     # row 0's two slots sort first, uncovered
    ([1, 1, 2, 2], [0, 2, 4, 4, 4]),     # no zero row: the plain layout
    ([0, 0, 0, 0], [4, 4, 4, 4, 4]),     # only the zero row: no segment at all
])
def test_segments_skip_zero_row_layout(rows, offsets):
    """``skip_zero_row`` drops row 0's segment and nothing else: the sort
    and the other segments stay as ``tenant_segments`` builds them."""
    plain = tenant_segments(np.array(rows, np.int32))
    seg = tenant_segments(np.array(rows, np.int32), skip_zero_row=True)
    assert seg.seg_offsets.tolist() == offsets
    assert np.array_equal(seg.order, plain.order)
    assert np.array_equal(seg.inv_order, plain.inv_order)
    n = len(set(rows) - {0})
    assert seg.seg_rows[:n].tolist() == sorted(set(rows) - {0})
    assert not seg.seg_rows[n:].any()


# ---------------------------------------------------------------------------
# Mixed-codec serving
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _mixed_fleet():
    """f32 smoke config: DeltaDQ 128x, BitDelta, DeltaDQ 32x, compressed
    by the reference and carried across."""
    jcfg = dataclasses.replace(j_smoke(ARCH), param_dtype="float32")
    jbase = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    specs = [JSpec(alpha=8.0, k_bits=4, m=8, h_g=16), JBitDeltaSpec(),
             JSpec(alpha=8.0, k_bits=4, m=1, h_g=16)]
    jten = []
    for t, spec in enumerate(specs):
        ft = jax.tree.map(
            lambda p, t=t: p + 0.02 * jax.random.normal(
                jax.random.PRNGKey(7 + t), p.shape, jnp.float32).astype(p.dtype)
            if p.ndim >= 2 else p, jbase)
        jten.append((f"t{t}", jcompress(jbase, ft, spec)[0]))
    tcfg = dataclasses.replace(get_smoke_config(ARCH), param_dtype="float32")
    tten = [(n, br.deltas_to_port(d)) for n, d in jten]
    return jcfg, jbase, jten, tcfg, br.params_to_port(jbase), tten


def _mixed_stream(vocab, n=7, seed=3):
    rng = np.random.default_rng(seed)
    return [(f"t{i % 3}" if i % 4 != 3 else None,
             rng.integers(0, vocab, 4 + (i * 5) % 9).astype(np.int32)) for i in range(n)]


def _serve(eng, stream, max_new=5, gap=0.002):
    hs = [eng.submit(t, p, max_new_tokens=max_new, arrival=gap * i)
          for i, (t, p) in enumerate(stream)]
    eng.run()
    return [h.output() for h in hs]


def _kw(chunked):
    return dict(n_slots=3, max_seq=32, **(dict(chunked_prefill=True, chunk_size=4)
                                          if chunked else {}))


@pytest.mark.parametrize("chunked", [False, True])
def test_mixed_codec_engine_equals_each_tenant_alone(chunked):
    """``test_serve_scheduler.py:461``: every request of a three-group
    fleet (DeltaDQ 128x, BitDelta, DeltaDQ 32x) equals an engine holding
    only its tenant, token for token."""
    _, _, _, tcfg, tbase, tten = _mixed_fleet()
    eng = ContinuousEngine(tcfg, tbase, clock=VirtualClock(tick=1e-3), **_kw(chunked))
    for n, d in tten:
        eng.register_tenant(n, d)
    assert [g.codecs for g in eng._groups] == [("deltadq",), ("bitdelta",), ("deltadq",)]
    stream = _mixed_stream(tcfg.vocab)
    mixed = _serve(eng, stream)
    for name, d in tten:
        alone = ContinuousEngine(tcfg, tbase, clock=VirtualClock(tick=1e-3), **_kw(chunked))
        alone.register_tenant(name, d)
        idx = [i for i, (t, _) in enumerate(stream) if t == name]
        got = _serve(alone, [stream[i] for i in idx])
        for i, g in zip(idx, got):
            np.testing.assert_array_equal(g, mixed[i], err_msg=name)


@pytest.mark.parametrize("chunked", [False, True])
def test_mixed_codec_engine_matches_jax_engine(chunked):
    """Same fleet, same VirtualClock trace: the port's tokens equal the
    JAX engine's, and so do the groups' codecs and rows."""
    jcfg, jbase, jten, tcfg, tbase, tten = _mixed_fleet()
    jeng = JContinuousEngine(jcfg, jbase, clock=JVirtualClock(tick=1e-3), **_kw(chunked))
    teng = ContinuousEngine(tcfg, tbase, clock=VirtualClock(tick=1e-3), **_kw(chunked))
    for (n, jd), (_, td) in zip(jten, tten):
        jeng.register_tenant(n, jd)
        teng.register_tenant(n, td)
    jeng._refresh_stacked()
    assert [g.codecs for g in teng._groups] == [g.codecs for g in jeng._groups]
    assert [g.lut.tolist() for g in teng._groups] == [g.lut.tolist() for g in jeng._groups]
    stream = _mixed_stream(tcfg.vocab)
    for a, b in zip(_serve(teng, stream), _serve(jeng, stream)):
        np.testing.assert_array_equal(a, b)


def test_mixed_codec_decode_logits_match_jax():
    """One decode step over all three groups plus a base row, through each
    engine's own slot-delta tree (MultiSlotDelta leaves): logits within
    1e-4 of the reference's."""
    jcfg, jbase, jten, tcfg, tbase, tten = _mixed_fleet()
    jeng = JContinuousEngine(jcfg, jbase, n_slots=4, max_seq=16)
    teng = ContinuousEngine(tcfg, tbase, n_slots=4, max_seq=16)
    for (n, jd), (_, td) in zip(jten, tten):
        jeng.register_tenant(n, jd)
        teng.register_tenant(n, td)
    jeng._refresh_stacked()
    rows = np.array([2, 0, 3, 1], np.int32)
    tok = np.array([[5], [9], [2], [7]], np.int32)
    pos = np.zeros(4, np.int32)
    jsd, _ = jeng._slot_delta(rows)
    jlog, _ = jlm.decode_step(jcfg, jbase, jlm.init_cache(jcfg, 4, 16), jnp.asarray(tok),
                              jnp.asarray(pos), deltas=jsd)
    tsd, _ = teng._slot_delta(rows)
    tlog, _ = lm.decode_step(tcfg, tbase, lm.init_cache(tcfg, 4, 16, device="cpu"),
                             torch.as_tensor(tok).long(), torch.as_tensor(pos).long(),
                             deltas=tsd)
    np.testing.assert_allclose(_np(tlog), np.asarray(jlog), **LOGIT_TOL)


def test_heterogeneous_specs_register_into_codec_groups():
    """``test_serve_scheduler.py:415``: another packing forms its own
    group; a tree of another structure is refused and leaves the store as
    it was."""
    _, _, _, tcfg, tbase, tten = _mixed_fleet()
    eng = ContinuousEngine(tcfg, tbase, n_slots=2, max_seq=32, clock=VirtualClock(tick=1e-3))
    eng.register_tenant("t0", tten[0][1])
    eng.register_tenant("t-hetero", tten[2][1])
    assert len(eng._groups) == 2 and eng.restacks == 2
    bad = {k: dict(v) for k, v in tten[2][1].items()}
    bad["attn"]["wq"] = None
    with pytest.raises(ValueError, match="structure"):
        eng.register_tenant("bad", bad)
    assert [t.name for t in eng.store.ordered()] == ["t0", "t-hetero"]
    assert len(eng._groups) == 2


def test_mixed_codec_cli_on_cpu(capsys):
    from repro_torch.launch import serve as cli
    assert cli.main(["--device", "cpu", "--tenants", "3", "--codec", "mixed",
                     "--check-identity", "--requests", "6", "--max-new", "3"]) == 0
    out = capsys.readouterr().out
    assert "token identity vs per-tenant-alone engines: OK (6 requests, 2 codec groups)" \
        in out
    assert [type(s).__name__ for s in cli.tenant_specs("mixed", 3)] == \
        ["DeltaDQSpec", "BitDeltaSpec", "DeltaDQSpec"]
