"""The port's storage layer (``core.pack`` m-part CSR parts and the codecs'
``to/from_storage_parts``) against the JAX reference's.

Twins of ``tests/test_core_pack.py``'s storage tests. The packed delta is
made by the reference (its own dropout draws) and carried across, so the
two packages decompose the same arrays: every part (group offsets, local
indices, low codes) and every meta entry must be EQUAL, and so must the
reloaded runtime arrays (``idx``, ``codes``, ``scale``, ``zero``) and
their dense reconstruction. The loaded delta lands on the caller's
device (the CPU here; the card test is in ``test_torch_cuda.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import from_storage_parts as j_from_parts  # noqa: E402
from repro.core import groupwise_dropout_pack as j_pack  # noqa: E402
from repro.core import reconstruct_dense as j_dense  # noqa: E402
from repro.core import to_storage_parts as j_to_parts  # noqa: E402
from repro.core.codecs import BitDeltaSpec as JBitSpec  # noqa: E402
from repro.core.codecs import DeltaDQSpec as JDQSpec  # noqa: E402
from repro.core.codecs import LowRankSpec as JLRSpec  # noqa: E402
from repro.core.codecs import get_codec as j_get_codec  # noqa: E402

from repro_torch.core import (  # noqa: E402
    StoragePart,
    from_storage_parts,
    reconstruct_dense,
    to_storage_parts,
)
from repro_torch.core import quant  # noqa: E402
from repro_torch.core.codecs import get_codec  # noqa: E402

import torch_bridge as br  # noqa: E402

CPU = "cpu"


def _np(t):
    return t.detach().cpu().numpy()


def _jpack(h_in=256, h_out=32, h_g=64, alpha=8, k=4, m=4, seed=0):
    rng = jax.random.PRNGKey(seed)
    d = jax.random.normal(rng, (h_in, h_out)) * 0.01
    return j_pack(rng, d, h_g=h_g, alpha=alpha, k_bits=k, m=m)


def _canonical(p):
    """(idx, q) with each (group, column)'s K entries sorted by idx: the
    m-part reassembly keeps the (idx, code) pairs but interleaves the
    parts' order within a (g, o) row."""
    q = _np(quant.unpack_bits(p.codes, quant.pack_width(p.k_bits), p.keep,
                              axis=p.codes.ndim - 2))
    idx = _np(p.idx).astype(np.int64)
    order = np.argsort(idx, axis=1, kind="stable")
    return (np.take_along_axis(idx, order, axis=1),
            np.take_along_axis(q, order, axis=1))


def _assert_parts_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert isinstance(a, StoragePart) and a.part == b.part
        for f in ("group_offsets", "local_idx", "low_codes"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("k,m", [(4, 1), (4, 4), (4, 8), (8, 8), (2, 2), (1, 1)])
def test_storage_parts_match_reference(k, m):
    jp = _jpack(k=k, m=m)
    p = br.packed_to_port(jp)
    parts = to_storage_parts(p)
    _assert_parts_equal(parts, j_to_parts(jp))
    assert sum(len(q.low_codes) for q in parts) == p.nnz
    for a, b in zip(parts, j_to_parts(jp)):
        assert a.storage_bits(k, m, p.h_g) == b.storage_bits(k, m, p.h_g)
    p2 = from_storage_parts(parts, h_in=p.h_in, h_out=p.h_out, h_g=p.h_g,
                            keep=p.keep, alpha=p.alpha, k_bits=k,
                            scale=p.scale, zero=p.zero, device=CPU)
    torch.testing.assert_close(reconstruct_dense(p2), reconstruct_dense(p),
                               rtol=0, atol=0)


@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("m", [1, 2, 4])
def test_storage_roundtrip_restores_the_packing(k, m):
    """to_storage_parts -> from_storage_parts gives back the packed arrays
    exactly (each column's entries in the packing's idx order), every
    static field, and the reference's reloaded arrays in canonical order
    (the reference leaves them in part order)."""
    if 2 ** k < m:
        pytest.skip("more parts than code levels")
    jp = _jpack(h_in=128, h_out=24, h_g=32, alpha=4, k=k, m=m, seed=k * 10 + m)
    p = br.packed_to_port(jp)
    meta = dict(h_in=p.h_in, h_out=p.h_out, h_g=p.h_g, keep=p.keep,
                alpha=p.alpha, k_bits=k)
    p2 = from_storage_parts(to_storage_parts(p), scale=p.scale, zero=p.zero,
                            device=CPU, **meta)
    jp2 = j_from_parts(j_to_parts(jp), scale=jp.scale, zero=jp.zero, **meta)
    assert (p2.h_in, p2.h_out, p2.h_g, p2.keep, p2.alpha, p2.k_bits, p2.m) \
        == (jp2.h_in, jp2.h_out, jp2.h_g, jp2.keep, jp2.alpha, jp2.k_bits, jp2.m)
    for f in ("idx", "codes", "scale", "zero"):
        a, b = getattr(p2, f), getattr(p, f)
        assert a.dtype == b.dtype == br.packed_to_port(jp2).__dict__[f].dtype, f
        assert torch.equal(a, b), f
    assert p2.device.type == CPU and p2.codes.is_contiguous()
    for a, b in zip(_canonical(p2), _canonical(br.packed_to_port(jp2))):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(_np(reconstruct_dense(p2)), np.asarray(j_dense(jp2)))


def test_low_code_bit_width():
    for part in to_storage_parts(br.packed_to_port(_jpack(k=4, m=8))):
        if len(part.low_codes):
            assert part.low_codes.max() <= 2**4 // 8 - 1   # 1-bit storage


def test_storage_layer_refusals_match_reference():
    jp = _jpack()
    stacked = br.packed_to_port(j_pack(jax.random.PRNGKey(1),
                                       jax.random.normal(jax.random.PRNGKey(2),
                                                         (3, 128, 16)) * 0.01,
                                       h_g=32, alpha=4, k_bits=4))
    with pytest.raises(ValueError, match="per-matrix"):
        to_storage_parts(stacked)
    raw = br.packed_to_port(j_pack(jax.random.PRNGKey(0),
                                   jax.random.normal(jax.random.PRNGKey(3),
                                                     (64, 16)), h_g=16, alpha=4))
    with pytest.raises(ValueError, match="k_bits=None"):
        to_storage_parts(raw)
    with pytest.raises(ValueError, match="k_bits=None"):
        j_to_parts(jp.__class__(**{**jp.__dict__, "k_bits": None}))


# ---------------------------------------------------------------------------
# The codecs' storage (parts, meta) against the reference's
# ---------------------------------------------------------------------------
J_SPECS = {
    "deltadq": JDQSpec(alpha=8.0, k_bits=4, m=2, h_g=16),
    "deltadq-raw": JDQSpec(alpha=8.0, k_bits=None, h_g=16),
    "bitdelta": JBitSpec(),
    "lowrank": JLRSpec(rank=4, k_bits=4),
}


def _codec_leaf(case, h_in=64, h_out=24, seed=0):
    name = case.split("-")[0]
    c = j_get_codec(name)
    rng = jax.random.PRNGKey(seed)
    base = jax.random.normal(rng, (h_in, h_out))
    ft = base + 0.01 * jax.random.normal(jax.random.fold_in(rng, 1), (h_in, h_out))
    jleaf = c.compress_leaf(jax.random.fold_in(rng, 2), base, ft, J_SPECS[case])
    return name, c, jleaf, br.leaf_to_port(jleaf)


def _assert_tree_equal(got, want):
    if isinstance(want, list):
        _assert_parts_equal(got, want)
        return
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
        assert got[k].dtype == np.asarray(want[k]).dtype, k


@pytest.mark.parametrize("case", sorted(J_SPECS))
def test_codec_storage_parts_match_reference(case):
    name, jc, jleaf, leaf = _codec_leaf(case)
    c = get_codec(name)
    parts, meta = c.to_storage_parts(leaf)
    jparts, jmeta = jc.to_storage_parts(jleaf)
    assert meta == jmeta and meta["codec"] == name
    _assert_tree_equal(parts, jparts)
    leaf2 = c.from_storage_parts(parts, meta, device=CPU)
    jleaf2 = jc.from_storage_parts(jparts, jmeta)
    want = br.leaf_to_port(jleaf2)
    for f in {"deltadq": ("idx", "codes", "scale", "zero"),
              "bitdelta": ("sign", "scale"),
              "lowrank": ("codes", "scale", "zero", "u", "v")}[name]:
        a, b = getattr(leaf2, f), getattr(want, f)
        assert a.dtype == b.dtype and a.device.type == CPU, f
        assert torch.equal(a, getattr(leaf, f)), f     # the original, exactly
        if case != "deltadq":   # m-part CSR: the reference's is in part order
            assert torch.equal(a, b), f
    if case == "deltadq":
        for a, b in zip(_canonical(leaf2), _canonical(want)):
            np.testing.assert_array_equal(a, b)
    assert {k: getattr(leaf2, k) for k in ("h_in", "h_out")} == \
        {k: getattr(jleaf2, k) for k in ("h_in", "h_out")}
    got, want = _np(c.reconstruct_dense(leaf2)), np.asarray(jc.reconstruct_dense(jleaf))
    if name == "lowrank":   # core + u @ v: the frameworks' f32 matmuls differ
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    else:                   # elementwise decodes: exact
        np.testing.assert_array_equal(got, want)
    assert c.storage_bits(leaf2) == jc.storage_bits(jleaf2)


@pytest.mark.parametrize("case", sorted(J_SPECS))
def test_codec_storage_refuses_stacked_leaves(case):
    """The storage layer works per matrix: a stacked leaf of any codec
    raises ValueError, as the reference's stacked-leaf check does."""
    name, jc, jleaf, leaf = _codec_leaf(case)
    stacked = _stack_leaves([leaf, leaf])
    assert stacked.stack_shape() == (2,)
    with pytest.raises(ValueError, match="per-matrix"):
        get_codec(name).to_storage_parts(stacked)
    if name != "deltadq":
        # the reference raises the same way where its check comes first
        # (its DeltaDQ codec reads float(scale) of the stack before its
        # check, a TypeError; the port checks first)
        jstacked = jax.tree.map(lambda a: jnp.stack([a, a]), jleaf)
        with pytest.raises(ValueError, match="per-matrix"):
            jc.to_storage_parts(jstacked)


def _stack_leaves(leaves):
    from dataclasses import fields, replace
    first = leaves[0]
    arrays = {f.name: torch.stack([getattr(x, f.name) for x in leaves])
              for f in fields(first) if isinstance(getattr(first, f.name), torch.Tensor)}
    return replace(first, **arrays)
