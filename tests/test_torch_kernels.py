"""The port's delta-correction dispatch against the JAX reference.

On the CPU the port's ``ops.delta_spmm`` / ``ops.delta_spmm_segments``
run their plain torch versions; the reference runs its Pallas kernels in
interpret mode. Both see the same packed deltas (packed by the port from
numpy-seeded deltas and carried across through numpy; the packer itself
is held exactly against the reference's in ``test_torch_core.py``) and
the same activations, and must agree
at atol/rtol 1e-4 in f32 (``tests/test_kernels.py:44``): the two sum in
different orders. The bit-stability properties the token-identity
contract rests on are held EXACTLY inside the port.

The CUDA kernels themselves are held against these plain versions by
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.apply import stack_tenant_deltas as j_stack  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.serve.scheduler import tenant_segments as j_segments  # noqa: E402

from repro_torch.core import apply as tapply  # noqa: E402
from repro_torch.core.dropout import groupwise_dropout_pack  # noqa: E402
from repro_torch.kernels import fallback as tfb  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.serve.scheduler import tenant_segments as t_segments  # noqa: E402

import torch_bridge as br  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)

SWEEP = [   # tests/test_kernels.py:23-31
    # (T, h_in, h_out, h_g, alpha, k_bits)
    (64, 256, 128, 64, 8, 4),
    (32, 512, 256, 128, 4, 8),
    (128, 256, 384, 32, 2, 2),
    (16, 128, 128, 16, 8, 1),
    (8, 64, 96, 16, 4, None),
    (100, 256, 96, 256, 16, 4),
    (1, 128, 64, 32, 4, 4),
]


def _pack(h_in, h_out, h_g, alpha, k, seed=0, scale=0.01):
    """A reference PackedDelta, packed by the port (no JAX compile per
    shape) from a numpy-seeded delta."""
    rng = np.random.default_rng(seed)
    d = torch.from_numpy((rng.standard_normal((h_in, h_out)) * scale).astype(np.float32))
    u = torch.from_numpy(rng.random((h_in // h_g, h_g, h_out)).astype(np.float32))
    return br.packed_to_jax(groupwise_dropout_pack(d, h_g=h_g, alpha=alpha, k_bits=k, u=u))


def _x(T, h_in, seed):
    return (np.random.default_rng(seed).standard_normal((T, h_in))).astype(np.float32)


def _stacked(n, h_in=128, h_out=256, h_g=64, alpha=8, k=4):
    ps = [_pack(h_in, h_out, h_g, alpha, k, seed=s) for s in range(n)]
    return j_stack([{"w": p} for p in ps])["w"]


# ---------------------------------------------------------------------------
# delta_spmm
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("T,h_in,h_out,h_g,alpha,k", SWEEP)
def test_delta_spmm_cpu_matches_reference_kernel(T, h_in, h_out, h_g, alpha, k):
    p = _pack(h_in, h_out, h_g, alpha, k)
    x = _x(T, h_in, 1)
    want = np.asarray(jops.delta_spmm(jnp.asarray(x), p, interpret=True))
    tp = br.packed_to_port(p)
    got = tops.delta_spmm(torch.from_numpy(x), tp)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(tref.delta_spmm_ref(torch.from_numpy(x), tp).numpy(),
                               want, **TOL)


@pytest.mark.parametrize("T,h_in,h_out,h_g,alpha,k", SWEEP)
def test_correction_kernel_order_matches_plain_and_reference(T, h_in, h_out, h_g, alpha, k):
    """kernels/ref.py's oracle of the CUDA kernels' reduction order is the
    same function: within 1e-5 of the plain version (another order) and
    within the kernel tolerance of the reference's interpret-mode kernel."""
    p = _pack(h_in, h_out, h_g, alpha, k)
    tp = br.packed_to_port(p)
    x = torch.from_numpy(_x(T, h_in, 1))
    got = tref.correction_kernel_order(x, tp)
    assert got.dtype == torch.float32 and tuple(got.shape) == (T, h_out)
    torch.testing.assert_close(got, tfb.correction(x, tp), atol=1e-5, rtol=1e-5)
    want = np.asarray(jops.delta_spmm(jnp.asarray(x.numpy()), p, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_correction_kernel_order_rows_are_t_invariant():
    """A row's bits do not depend on the rows beside it (the contract the
    kernels keep at every T and row tile)."""
    tp = br.packed_to_port(_pack(256, 96, 16, 8, 4, seed=3, scale=0.5))
    x = torch.from_numpy(_x(40, 256, 4) * 2.0)
    full = tref.correction_kernel_order(x, tp)
    for sl in (slice(0, 1), slice(3, 11), slice(5, 6), slice(8, 40)):
        assert torch.equal(tref.correction_kernel_order(x[sl], tp), full[sl])


def test_delta_spmm_bf16_input_and_leading_dims():
    p = _pack(256, 128, 64, 8, 4)
    x = _x(32, 256, 3).reshape(4, 8, 256)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    want = np.asarray(jops.delta_spmm(
        jnp.asarray(xb.to(torch.float32).numpy()).astype(jnp.bfloat16), p,
        interpret=True))
    got = tops.delta_spmm(xb, br.packed_to_port(p))
    assert tuple(got.shape) == (4, 8, 128)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_outside_envelope_takes_plain_formulation():
    p = _pack(512, 64, 512, 64, 4)            # h_g > MAX_HG
    tp = br.packed_to_port(p)
    assert not tops.kernel_supported(tp) and not jops.kernel_supported(p)
    x = _x(4, 512, 5)
    np.testing.assert_allclose(
        tops.delta_spmm(torch.from_numpy(x), tp).numpy(),
        np.asarray(jops.delta_spmm(jnp.asarray(x), p, interpret=True)), **TOL)


def test_gather_correction_batch_extent_bit_stable():
    """A row's correction has the same bits alone, in a group, or in a
    full slot batch (tests/test_kernel_segments.py:69, inside the port)."""
    tp = br.packed_to_port(_pack(128, 256, 64, 8, 4, scale=0.5))
    x = torch.from_numpy(_x(8, 128, 2) * 2.0)
    full = tfb.gather_correction(x, tp)
    for sl in (slice(0, 1), slice(2, 5), slice(3, 8)):
        assert torch.equal(tfb.gather_correction(x[sl], tp), full[sl])


def test_rows_vs_shared_vals_bit_identical():
    """Per-row gather with every row on one tenant bit-matches the shared
    tenant gather (tests/test_kernel_segments.py:81, inside the port)."""
    stk = br.packed_to_port(_stacked(1))
    B = 4
    rows = torch.zeros(B, dtype=torch.int64)
    gat = stk.with_arrays(stk.idx[rows], stk.codes[rows], stk.scale[rows],
                          stk.zero[rows])
    x = torch.from_numpy(_x(B, 128, 3))
    y_rows = tfb.gather_correction_rows(x[:, None, :], gat)[:, 0]
    y_shared = tfb.gather_correction(x, stk.index(0))
    assert torch.equal(y_rows, y_shared)


# ---------------------------------------------------------------------------
# segments
# ---------------------------------------------------------------------------
def _seg_case(rows, h_in=128, h_out=256, h_g=64, alpha=8, n_tenants=3, seed=5):
    stk = _stacked(n_tenants, h_in=h_in, h_out=h_out, h_g=h_g, alpha=alpha)
    x = _x(len(rows), h_in, seed)
    seg = j_segments(np.asarray(rows, np.int32))
    xs = x[np.asarray(seg.order)]
    return stk, x, seg, xs


@pytest.mark.parametrize("rows,h_out", [
    ([0, 0, 0, 0], 256),                    # single tenant
    ([2, 0, 2, 1, 0, 2, 1, 0], 256),        # mixed, duplicates
    ([1, 2, 0], 256),                       # all distinct
    ([2, 0, 2, 1, 0, 2, 1, 0], 96),
    ([2, 0, 2, 1, 0, 2, 1, 0], 251),        # ragged column tile
])
def test_segments_cpu_matches_reference_kernel(rows, h_out):
    stk, x, seg, xs = _seg_case(rows, h_out=h_out)
    want = np.asarray(jops.delta_spmm_segments(
        jnp.asarray(xs), stk, jnp.asarray(seg.seg_rows),
        jnp.asarray(seg.seg_offsets), interpret=True))
    got = tops.delta_spmm_segments(torch.from_numpy(xs), br.packed_to_port(stk),
                                   torch.from_numpy(seg.seg_rows),
                                   torch.from_numpy(seg.seg_offsets))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_segments_multi_row_blocks_matches_reference():
    """T spanning several reference row tiles (tb=8)."""
    rows = [0] * 5 + [1] * 11
    stk, x, seg, xs = _seg_case(rows, h_in=64, h_out=128, h_g=32, alpha=4,
                                n_tenants=2, seed=7)
    want = np.asarray(jops.delta_spmm_segments(
        jnp.asarray(xs), stk, jnp.asarray(seg.seg_rows),
        jnp.asarray(seg.seg_offsets), tb=8, interpret=True))
    got = tops.delta_spmm_segments(torch.from_numpy(xs), br.packed_to_port(stk),
                                   torch.from_numpy(seg.seg_rows),
                                   torch.from_numpy(seg.seg_offsets))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_segment_rows_bit_equal_to_per_tenant_rows():
    """Each sorted row's segment correction equals that tenant's shared
    gather on the same rows, bit for bit (inside the port)."""
    rows = [2, 0, 2, 1, 0, 2, 1, 0]
    stk, x, seg, xs = _seg_case(rows)
    tstk = br.packed_to_port(stk)
    got = tfb.segment_correction(torch.from_numpy(xs), tstk,
                                 torch.from_numpy(seg.seg_rows),
                                 torch.from_numpy(seg.seg_offsets))
    sorted_rows = np.asarray(rows)[np.asarray(seg.order)]
    for t in range(3):
        per = tfb.gather_correction(torch.from_numpy(xs), tstk.index(t))
        sel = torch.from_numpy(sorted_rows == t)
        assert torch.equal(got[sel], per[sel])


def test_segment_correction_zero_fills_uncovered_rows():
    """Rows that no segment covers, and a segment whose tenant row is
    outside the stack, are zero (the reference kernel zero-fills its
    output); covered rows keep their bits."""
    tstk = br.packed_to_port(_stacked(2))
    x = torch.from_numpy(_x(10, 128, 9))
    seg_rows = torch.tensor([1, 5, 0], dtype=torch.int32)
    seg_offsets = torch.tensor([0, 3, 5, 7], dtype=torch.int32)
    got = tops.delta_spmm_segments(x, tstk, seg_rows, seg_offsets)
    assert torch.equal(got[3:5], torch.zeros_like(got[3:5]))
    assert torch.equal(got[7:], torch.zeros_like(got[7:]))
    assert torch.equal(got[:3], tfb.gather_correction(x[:3], tstk.index(1)))
    assert torch.equal(got[5:7], tfb.gather_correction(x[5:7], tstk.index(0)))


@pytest.mark.parametrize("rows,h_out", [
    ([2, 0, 2, 1, 0, 2, 1, 0], 256),        # mixed, duplicates, padded segments
    ([1, 2, 0], 96),                        # all distinct
    ([0] * 5 + [1] * 11, 130),              # segments straddling 8-row tiles
])
def test_segments_kernel_order_matches_plain_and_reference(rows, h_out):
    """kernels/ref.py's oracle of the segments kernel is the same function
    as the plain version (within 1e-5: another order) and the reference's
    interpret-mode kernel (the kernel tolerance), and each covered row has
    the bits of correction_kernel_order with its tenant."""
    stk, x, seg, xs = _seg_case(rows, h_out=h_out)
    tstk = br.packed_to_port(stk)
    args = (torch.from_numpy(xs), tstk, torch.from_numpy(seg.seg_rows),
            torch.from_numpy(seg.seg_offsets))
    got = tref.segments_kernel_order(*args)
    torch.testing.assert_close(got, tfb.segment_correction(*args), atol=1e-5, rtol=1e-5)
    want = np.asarray(jops.delta_spmm_segments(
        jnp.asarray(xs), stk, jnp.asarray(seg.seg_rows),
        jnp.asarray(seg.seg_offsets), interpret=True))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    sorted_rows = np.asarray(rows)[np.asarray(seg.order)]
    for t in set(rows):
        sel = torch.from_numpy(sorted_rows == t)
        per = tref.correction_kernel_order(torch.from_numpy(xs), tstk.index(t))
        assert torch.equal(got[sel], per[sel])


def test_segments_kernel_order_zero_fills_like_plain():
    """Rows that no segment covers and a segment whose tenant row is
    outside the stack are zero in the oracle, as in the plain version."""
    tstk = br.packed_to_port(_stacked(2))
    x = torch.from_numpy(_x(10, 128, 9))
    seg_rows = torch.tensor([1, 5, 0], dtype=torch.int32)
    seg_offsets = torch.tensor([1, 3, 5, 7], dtype=torch.int32)
    got = tref.segments_kernel_order(x, tstk, seg_rows, seg_offsets)
    plain = tfb.segment_correction(x, tstk, seg_rows, seg_offsets)
    zero = torch.ones(10, dtype=torch.bool)
    zero[1:3] = zero[5:7] = False
    assert not got[zero].any() and not plain[zero].any()
    assert torch.equal(got[1:3], tref.correction_kernel_order(x[1:3], tstk.index(1)))
    torch.testing.assert_close(got, plain, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("offsets,tb,want_row_tiles", [
    ([0, 2, 5, 8, 8, 8, 8, 8, 8], 8, 3),     # tenant_segments' padded layout
    ([0, 5, 16, 36], 8, 1 + 2 + 3),          # segments tiled from their own start
    ([0, 5, 16, 36], 2, 3 + 6 + 10),
    (list(range(9)), 8, 8),                  # delta_spmm_slots: one-row segments
    ([3, 3, 3], 4, 0),                       # all empty
])
def test_segment_decode_tiles_counts_segment_row_tiles(offsets, tb, want_row_tiles):
    """The segments kernel decodes each group's [keep, ob] tile once per
    (segment row tile, column tile); ob is the decode route's 128."""
    kw = dict(n_groups=4, h_out=300, tb=tb, ob=tops.KERNEL_OB)
    assert tops.segment_decode_tiles(np.asarray(offsets), **kw) == want_row_tiles * 4 * 3


def test_tenant_segments_layout_matches_reference():
    for rows in ([2, 0, 2, 1], [0, 0, 0, 0], [1, 2, 3, 0], [3, 3, 1, 1, 0, 2, 2, 2]):
        a = t_segments(np.asarray(rows, np.int32))
        b = j_segments(np.asarray(rows, np.int32))
        for f in ("order", "inv_order", "seg_rows", "seg_offsets"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        for tb, ob in ((8, 32), (128, 128)):
            kw = dict(n_groups=4, h_out=256, tb=tb, ob=ob)
            assert tops.segment_decode_tiles(a.seg_offsets, **kw) == \
                jops.segment_decode_tiles(b.seg_offsets, **kw)
        assert tops.per_row_decode_tiles(len(rows), n_groups=4, h_out=256, ob=32) \
            == jops.per_row_decode_tiles(len(rows), n_groups=4, h_out=256, ob=32)


@pytest.mark.parametrize("mode", ["segments", "per_row"])
def test_slot_delta_matmul_modes_match_reference(mode):
    from repro.core.apply import slot_delta_matmul as j_sdm
    from repro.core.apply import wrap_slot_deltas as j_wrap
    """A SlotDelta with a segment layout takes the segments dispatch; one
    without (segments=None) the per-row gather, in both packages."""
    stk = _stacked(3)
    rows = np.array([2, 0, 2, 1, 0, 1], np.int32)
    x = _x(len(rows), 128, 8).reshape(len(rows), 1, 128)
    segmented = mode == "segments"
    jseg = jax.tree.map(jnp.asarray, j_segments(rows)) if segmented else None
    want = np.asarray(j_sdm(jnp.asarray(x),
                            j_wrap({"w": stk}, jnp.asarray(rows), segments=jseg)["w"]))
    tseg = t_segments(rows).to("cpu") if segmented else None
    sd = tapply.wrap_slot_deltas({"w": br.packed_to_port(stk)},
                                 torch.from_numpy(rows).long(), segments=tseg)["w"]
    got = tapply.slot_delta_matmul(torch.from_numpy(x), sd)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_kernel_envelope_matches_reference():
    for h_g, alpha, k in ((16, 8, 4), (256, 2, 4), (64, 8, None), (512, 8, 4)):
        p = _pack(h_g * 2, 32, h_g, alpha, k)
        assert tops.kernel_supported(br.packed_to_port(p)) == jops.kernel_supported(p)


# ---------------------------------------------------------------------------
# dequant / fused_base_delta (the merge path and the kernels entry point)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("T,h_in,h_out,h_g,alpha,k", SWEEP[:5])
def test_dequant_cpu_bit_equal_to_reference_kernel(T, h_in, h_out, h_g, alpha, k):
    """No reduction: every element is (q - z) * s or 0 in both packages."""
    p = _pack(h_in, h_out, h_g, alpha, k)
    want = np.asarray(jops.dequant(p, interpret=True))
    tp = br.packed_to_port(p)
    got = tops.dequant(tp).numpy()
    assert got.dtype == np.float32 and got.shape == (h_in, h_out)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(tref.dequant_tile_ref(tp).numpy(), want)


@pytest.mark.parametrize("T,h_in,h_out,h_g,alpha,k", SWEEP[:3])
def test_fused_base_delta_cpu_matches_reference_kernel(T, h_in, h_out, h_g, alpha, k):
    p = _pack(h_in, h_out, h_g, alpha, k)
    x = _x(T, h_in, 1)
    w = (np.random.default_rng(2).standard_normal((h_in, h_out)) * 0.05).astype(np.float32)
    want = np.asarray(jops.fused_base_delta(jnp.asarray(x), jnp.asarray(w), p,
                                            interpret=True))
    tp = br.packed_to_port(p)
    got = tops.fused_base_delta(torch.from_numpy(x), torch.from_numpy(w), tp)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(
        tref.fused_base_delta_ref(torch.from_numpy(x), torch.from_numpy(w), tp).numpy(),
        want, **TOL)


def test_merge_kernels_outside_envelope_take_plain_formulation():
    p = _pack(512, 64, 512, 64, 4)            # h_g > MAX_HG
    tp = br.packed_to_port(p)
    x = _x(3, 512, 6).reshape(1, 3, 512)
    w = (np.random.default_rng(3).standard_normal((512, 64)) * 0.05).astype(np.float32)
    np.testing.assert_array_equal(tops.dequant(tp).numpy(),
                                  np.asarray(jops.dequant(p, interpret=True)))
    got = tops.fused_base_delta(torch.from_numpy(x), torch.from_numpy(w), tp)
    want = jops.fused_base_delta(jnp.asarray(x), jnp.asarray(w), p, interpret=True)
    assert tuple(got.shape) == (1, 3, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_autotune_gather_max_t_matches_reference_table(monkeypatch):
    """The port's crossover equals the reference's at every base entry of
    the committed table (it only picks the CPU formulation); tiles are
    not taken."""
    import json

    from repro.kernels import autotune as jat
    from repro_torch.kernels import autotune as tat
    monkeypatch.delenv("REPRO_AUTOTUNE_TABLE", raising=False)
    jat.invalidate_cache()
    with open(jat.DEFAULT_TABLE_PATH) as f:
        entries = json.load(f)["entries"]
    keys = [k for k in entries if "@" not in k]
    assert len(keys) == len(tat.GATHER_MAX_T)
    for key in keys:
        h_g, keep, kb, h_in, h_out = key.split("/")
        args = (int(h_g), int(keep), None if kb == "None" else int(kb), int(h_in),
                int(h_out))
        want = jat.lookup(*args)["gather_max_t"]
        assert want == max(int(entries[key]["gather_max_t"]), jat.MIN_GATHER_T)
        assert tat.lookup(*args)["gather_max_t"] == want, key
        assert {k: v for k, v in tat.lookup(*args).items() if k != "gather_max_t"} \
            == {k: v for k, v in tat.DEFAULTS.items() if k != "gather_max_t"}
    assert tat.lookup(16, 2, 4, 4096, 11008) == tat.DEFAULTS


def test_kernels_demo_plain_versions_agree_with_oracles():
    from repro_torch.launch import kernels_demo
    T, h_in, h_out, h_g = kernels_demo.DEMO
    out = kernels_demo.run("cpu", T=T, h_in=h_in, h_out=h_out, h_g=h_g, verbose=False)
    assert set(out) == {"delta_spmm", "delta_spmm_segments", "fused_base_delta",
                        "dequant"}
    assert all(r["ok"] for r in out.values()), out


# ---------------------------------------------------------------------------
# packings past the reference's Pallas envelope: the CUDA kernels take them
# ---------------------------------------------------------------------------
WIDE = [   # (T, h_in, h_out, h_g, alpha, k_bits)
    (5, 1024, 40, 512, 8, 4),      # h_g 512: int32 idx, G = 2
    (3, 512, 40, 512, 8, None),    # h_g = h_in, DeltaDQSpec()'s row-wise default: f32 codes, G = 1
    (4, 2048, 24, 512, 2, 1),      # G = 4, alpha 2: keep 256, 1-bit codes
]


@pytest.mark.parametrize("T,h_in,h_out,h_g,alpha,k", WIDE)
def test_wide_packing_oracles_match_reference(T, h_in, h_out, h_g, alpha, k):
    """The CUDA kernels' bit-exact oracles at packings the reference
    serves through its XLA branch (int32 idx, G = 1/2/4, keep 256):
    ``correction_kernel_order`` and ``segments_kernel_order`` within the
    kernel tolerance of the reference's ``delta_spmm`` /
    ``delta_spmm_segments``, ``dequant_tile_ref`` bit for bit equal to
    its ``dequant``; the card's envelope takes the packing, the
    reference's does not."""
    from repro_torch.core.codecs import DeltaDQSpec
    if h_g == h_in:
        spec = DeltaDQSpec()
        assert (spec.h_g, spec.alpha, spec.k_bits) == (None, alpha, k)
    stk = _stacked(2, h_in=h_in, h_out=h_out, h_g=h_g, alpha=alpha, k=k)
    p0 = jax.tree.map(lambda a: a[0], stk)
    tstk = br.packed_to_port(stk)
    tp = tstk.index(0)
    assert tp.idx.dtype == torch.int32 and tp.keep == h_g // alpha
    assert not jops.kernel_supported(p0)
    assert tops.envelope_miss(tp) == "h_g" and tops.card_envelope_miss(tp) is None
    x = _x(T, h_in, 1)
    seg = j_segments(np.asarray([1, 0, 1, 1, 0][:T], np.int32))
    xs = x[np.asarray(seg.order)]
    # one jit for the reference's three calls: eager JAX compiles per primitive
    want, dense, want_seg = jax.jit(lambda x, p, xs, s, r, o: (
        jops.delta_spmm(x, p, interpret=True), jops.dequant(p, interpret=True),
        jops.delta_spmm_segments(xs, s, r, o, interpret=True)))(
        jnp.asarray(x), p0, jnp.asarray(xs), stk, jnp.asarray(seg.seg_rows),
        jnp.asarray(seg.seg_offsets))
    np.testing.assert_allclose(tref.correction_kernel_order(torch.from_numpy(x), tp).numpy(),
                               np.asarray(want), **TOL)
    np.testing.assert_array_equal(tref.dequant_tile_ref(tp).numpy().view(np.int32),
                                  np.asarray(dense).view(np.int32))
    got = tref.segments_kernel_order(torch.from_numpy(xs), tstk,
                                     torch.from_numpy(seg.seg_rows),
                                     torch.from_numpy(seg.seg_offsets))
    np.testing.assert_allclose(got.numpy(), np.asarray(want_seg), **TOL)


@pytest.mark.parametrize("h_g", [256, 512])
def test_check_delta_takes_int32_idx_exactly_above_256(h_g):
    """The kernels read idx of the packer's dtype: uint8 up to h_g = 256,
    int32 above; the other dtype raises."""
    from repro_torch.kernels import delta_spmm as kern
    d = br.packed_to_port(_pack(1024, 16, h_g, 8, 4))
    want = torch.uint8 if h_g <= 256 else torch.int32
    assert d.idx.dtype == want == kern.idx_dtype(h_g)
    assert kern.check_delta(d, d.idx.device, stacked=False) == (h_g // 16, 4)
    other = torch.int32 if want == torch.uint8 else torch.uint8
    with pytest.raises(ValueError, match="idx must be"):
        kern.check_delta(d.with_arrays(d.idx.to(other), d.codes, d.scale, d.zero),
                         d.idx.device, stacked=False)


def _meta_packings(h_in, alpha, k):
    """One port and one reference PackedDelta (arrays on the meta device /
    shape structs) per candidate group size of the search."""
    from repro.core.pack import PackedDelta as JPacked
    from repro.core.groupsearch import candidate_group_sizes as j_cands
    from repro_torch.core.dropout import keep_count
    from repro_torch.core.groupsearch import candidate_group_sizes
    from repro_torch.core.pack import PackedDelta
    from repro_torch.core.quant import packed_len
    cands = candidate_group_sizes(h_in, alpha)
    assert cands == j_cands(h_in, alpha)
    for h_g in cands:
        G, keep, O = h_in // h_g, keep_count(h_g, alpha), 8
        kp = keep if k is None else packed_len(keep, k)
        idt = torch.uint8 if h_g <= 256 else torch.int32
        cdt = torch.float32 if k is None else torch.uint8
        meta = dict(h_in=h_in, h_out=O, h_g=h_g, keep=keep, alpha=float(alpha), k_bits=k,
                    m=1)
        port = PackedDelta(idx=torch.empty((G, keep, O), dtype=idt, device="meta"),
                           codes=torch.empty((G, kp, O), dtype=cdt, device="meta"),
                           scale=torch.empty((), device="meta"),
                           zero=torch.empty((), dtype=torch.int32, device="meta"), **meta)
        ref = JPacked(idx=jax.ShapeDtypeStruct((G, keep, O), jnp.int32),
                      codes=jax.ShapeDtypeStruct((G, kp, O), jnp.uint8),
                      scale=jax.ShapeDtypeStruct((), jnp.float32),
                      zero=jax.ShapeDtypeStruct((), jnp.int32), **meta)
        yield port, ref


@pytest.mark.parametrize("alpha", [2, 4, 8])
def test_card_envelope_takes_every_searched_group_size(alpha):
    """Every group size the search tries (alpha up to h_in) at wizard's
    input widths, at every code width, lies inside the CUDA kernels'
    envelope; the reference's Pallas envelope, which picks the CPU
    formulation, is unchanged."""
    n = 0
    for h_in in (4096, 11008):
        for k in (None, 1, 2, 4, 8):
            for port, ref in _meta_packings(h_in, alpha, k):
                assert tops.card_envelope_miss(port) is None, (h_in, port.h_g, k)
                assert tops.kernel_supported(port) == jops.kernel_supported(ref)
                n += 1
    assert n > 5 * 2 * 5


def _card_prefill_fits(tb, h_g, keep):
    """The library's ``delta_spmm_prefill_ok`` (a card test holds it):
    the 128-row tile takes every packing, its windowed walk what no whole
    group fits."""
    from repro_torch.kernels import delta_spmm as kern
    return tb in kern.PREFILL_TILES and 1 <= keep <= h_g


@pytest.mark.parametrize("packing", ["row-wise", "h_g 1024", "bitdelta"])
def test_wide_packings_take_the_prefill_tile_by_rule_on_the_card(monkeypatch, tmp_path,
                                                                packing):
    """By rule (no table) on the card, DeltaDQSpec()'s row-wise default, an
    h_g 1024 packing (int32 idx, G = 2) and the BitDelta lowering (keep =
    h_g = 128) take the decode tile that holds T up to 64 rows and the
    128-row tile from PREFILL_MIN_T rows; every row is the kernel-order
    oracle's, within the kernel tolerance of the reference's
    ``delta_spmm``. The device kind, the library's answer and the
    wrapper (by its oracle, recording the tile) are stood in."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels import delta_spmm as kern
    h_in, h_out, h_g, alpha, k = {"row-wise": (512, 24, 512, 8, None),
                                  "h_g 1024": (2048, 24, 1024, 8, 4),
                                  "bitdelta": (256, 24, 128, 1, 2)}[packing]
    monkeypatch.setenv(autotune.TABLE_ENV, str(tmp_path / "absent.json"))
    autotune.invalidate_cache()
    monkeypatch.setattr(tops, "_device_kind", lambda x: "cuda")
    monkeypatch.setattr(kern, "prefill_fits", _card_prefill_fits)
    tiles = []

    def stand(x2, d, tb):
        tiles.append(tb)
        return tref.correction_kernel_order(x2, d)
    monkeypatch.setattr(kern, "delta_spmm_cuda", stand)
    p = _pack(h_in, h_out, h_g, alpha, k)
    tp = br.packed_to_port(p)
    assert (tp.keep, tp.idx.dtype) == (h_g // alpha, kern.idx_dtype(h_g))
    x = torch.from_numpy(_x(130, h_in, 2))
    Ts = (1, 8, 64, tops.PREFILL_MIN_T, 128, 130)
    for T in Ts:
        assert torch.equal(tops.delta_spmm(x[:T], tp).view(torch.int32),
                           tref.correction_kernel_order(x[:T], tp).view(torch.int32))
    assert tiles == [1, 8, 8, 128, 128, 128]
    want = np.asarray(jax.jit(lambda x, p: jops.delta_spmm(x, p, interpret=True))(
        jnp.asarray(x.numpy()), p))
    np.testing.assert_allclose(tops.delta_spmm(x, tp).numpy(), want, **TOL)
    autotune.invalidate_cache()


def test_wide_packings_take_the_kernels_on_the_card(monkeypatch):
    """On a CUDA tensor every entry point sends a wide packing to its
    kernel wrapper and leaves no plain-out-of-envelope note; only what
    no producer emits raises (k_bits outside 1-8, a stacked delta at a
    single-delta entry point). The CPU host has no card: the device kind
    is stood in for, and the wrappers by their oracles, which count."""
    from repro_torch.core.apply import stack_tenant_deltas
    from repro_torch.kernels import delta_spmm as kern
    from repro_torch.serve.trace import attribution
    calls = []

    def stand(name, fn):
        def call(*a, **kw):
            calls.append(name)
            return fn(*a)
        return call

    monkeypatch.setattr(tops, "_device_kind", lambda x: "cuda")
    monkeypatch.setattr(kern, "prefill_fits", _card_prefill_fits)
    monkeypatch.setattr(kern, "delta_spmm_cuda", stand("delta_spmm", tref.correction_kernel_order))
    monkeypatch.setattr(kern, "delta_spmm_segments_cuda",
                        stand("delta_spmm_segments", tref.segments_kernel_order))
    monkeypatch.setattr(kern, "fused_base_delta_cuda",
                        stand("fused_base_delta", tfb.fused_base_delta))
    monkeypatch.setattr(kern, "dequant_cuda", stand("dequant", tfb.dequant))
    tstk = br.packed_to_port(_stacked(2, h_in=1024, h_out=24, h_g=512, alpha=8, k=None))
    d = tstk.index(0)
    x = torch.from_numpy(_x(4, 1024, 3))
    w = torch.zeros((1024, 24))
    rows, offs = torch.tensor([1, 0], dtype=torch.int32), torch.tensor([0, 1, 4], dtype=torch.int32)
    with attribution() as notes:
        assert torch.equal(tops.delta_spmm(x, d), tref.correction_kernel_order(x, d))
        assert torch.equal(tops.delta_spmm(torch.from_numpy(_x(70, 1024, 4)), d).view(torch.int32),
                           tref.correction_kernel_order(torch.from_numpy(_x(70, 1024, 4)), d)
                           .view(torch.int32))
        tops.delta_spmm_segments(x, tstk, rows, offs)
        tops.delta_spmm_slots(x[:2, None], tstk)
        tops.delta_spmm_experts(x.reshape(2, 2, 1024), tstk)
        tops.fused_base_delta(x, w, d)
        tops.dequant(d)
    assert calls == ["delta_spmm", "delta_spmm", "delta_spmm_segments", "delta_spmm_segments",
                     "delta_spmm_segments", "fused_base_delta", "dequant"]
    assert not [n for n in notes if n.get("formulation") == "plain-out-of-envelope"]
    # T = 4 on a decode tile, T = 70 on the 128-row tile
    assert [n["formulation"] for n in notes if n["site"] == "delta_spmm"] == \
        ["cuda", "cuda-prefill"]
    bad = d.with_arrays(d.idx, d.codes, d.scale, d.zero)
    bad = type(d)(**{**bad.__dict__, "k_bits": 12})
    bad_stack = stack_tenant_deltas([{"w": bad}, {"w": bad}])["w"]
    for site, call in (("delta_spmm", lambda: tops.delta_spmm(x, bad)),
                       ("delta_spmm_segments",
                        lambda: tops.delta_spmm_segments(x, bad_stack, rows, offs)),
                       ("delta_spmm_slots", lambda: tops.delta_spmm_slots(x[:2, None], bad_stack)),
                       ("delta_spmm_experts",
                        lambda: tops.delta_spmm_experts(x.reshape(2, 2, 1024), bad_stack)),
                       ("fused_base_delta", lambda: tops.fused_base_delta(x, w, bad)),
                       ("dequant", lambda: tops.dequant(bad))):
        with pytest.raises(ValueError, match=rf"{site}: .*envelope \(k_bits\)"):
            call()
    for call in (lambda: tops.delta_spmm(x, tstk), lambda: tops.dequant(tstk),
                 lambda: tops.fused_base_delta(x, w, tstk)):
        with pytest.raises(ValueError, match=r"envelope \(stack\)"):
            call()
    assert len(calls) == 7
