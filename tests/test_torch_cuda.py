"""The port's CUDA kernels against their plain torch versions, on the card.

Every case is marked ``gpu`` and skips without an NVIDIA card: a CUDA
kernel has no CPU mode. The file imports neither jax nor ``repro``, so
it runs on a machine that has only the port:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

``python3 chip_smoke.py`` makes the same checks at full model width.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.apply import merge_delta, stack_tenant_deltas  # noqa: E402
from repro_torch.core.dropout import groupwise_dropout_pack  # noqa: E402
from repro_torch.core.pack import reconstruct_dense  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402
from repro_torch.kernels import delta_spmm as kern  # noqa: E402
from repro_torch.kernels import fallback as fb  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.serve.scheduler import tenant_segments  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)   # f32, the two sum in different orders

SWEEP = [   # tests/test_kernels.py:23-31 plus the 128x serving point
    # (T, h_in, h_out, h_g, alpha, k_bits)
    (64, 256, 128, 64, 8, 4),
    (32, 512, 256, 128, 4, 8),
    (128, 256, 384, 32, 2, 2),
    (16, 128, 128, 16, 8, 1),
    (8, 64, 96, 16, 4, None),
    (100, 256, 96, 256, 16, 4),
    (1, 128, 64, 32, 4, 4),
    (40, 256, 200, 16, 8, 4),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _pack(h_in, h_out, h_g, alpha, k, seed, device):
    g = torch.Generator().manual_seed(seed)
    delta = torch.randn((h_in, h_out), generator=g) * 0.01
    p = groupwise_dropout_pack(delta, h_g=h_g, alpha=alpha, k_bits=k, generator=g)
    return p.to(device)


def _x(T, h_in, seed, device, dtype=torch.float32):
    x = np.random.default_rng(seed).standard_normal((T, h_in)).astype(np.float32)
    return torch.from_numpy(x).to(device=device, dtype=dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("T,h_in,h_out,h_g,alpha,k", SWEEP)
def test_delta_spmm_kernel_matches_plain(cuda, T, h_in, h_out, h_g, alpha, k):
    d = _pack(h_in, h_out, h_g, alpha, k, 0, cuda)
    x = _x(T, h_in, 1, cuda)
    before = kern.LAUNCHES["delta_spmm"]
    got = ops.delta_spmm(x, d)
    torch.cuda.synchronize()
    assert kern.LAUNCHES["delta_spmm"] == before + 1
    torch.testing.assert_close(got, fb.correction(x, d), **TOL)


@pytest.mark.gpu
def test_delta_spmm_kernel_bf16_input(cuda):
    """The kernels take f32 activations: ops upcasts a bf16 x (exactly),
    the wrapper itself refuses it."""
    d = _pack(256, 128, 16, 8, 4, 1, cuda)
    x = _x(24, 256, 2, cuda, torch.bfloat16)
    torch.testing.assert_close(ops.delta_spmm(x, d), fb.correction(x, d), **TOL)
    assert torch.equal(ops.delta_spmm(x, d), ops.delta_spmm(x.float(), d))
    with pytest.raises(TypeError):
        kern.delta_spmm_cuda(x, d, tb=8)


@pytest.mark.gpu
def test_delta_spmm_kernel_rows_bit_stable(cuda):
    """A row has the same bits alone, in T=8 and in T=40 (other row tiles)."""
    d = _pack(512, 96, 16, 8, 4, 3, cuda)
    x = _x(40, 512, 4, cuda)
    full = ops.delta_spmm(x, d)
    for sl in (slice(0, 1), slice(3, 11), slice(5, 6), slice(20, 40)):
        assert torch.equal(ops.delta_spmm(x[sl], d), full[sl])


@pytest.mark.gpu
@pytest.mark.parametrize("T", [64, 100, 128, 256])
@pytest.mark.parametrize("h_in,h_out,h_g,alpha,k", [c[1:] for c in SWEEP])
def test_delta_spmm_prefill_rows_equal_tb8_rows(cuda, T, h_in, h_out, h_g, alpha, k):
    """delta_spmm above 32 rows, on the prefill route (128-row tile) above
    64 rows, every packing (h_g=256 on its windowed walk), and on the
    decode route at T=64, gives every row the bits of the tb=8 route and
    of the kernel-order oracle."""
    d = _pack(h_in, h_out, h_g, alpha, k, 0, cuda)
    x = _x(T, h_in, 11, cuda)
    prefill = ops.spmm_row_tile(T, d) in kern.PREFILL_TILES
    assert prefill == (T > 64)
    before = dict(kern.ROUTES)
    got = ops.delta_spmm(x, d)
    torch.cuda.synchronize()
    assert kern.ROUTES["delta_spmm_prefill"] == before["delta_spmm_prefill"] + int(prefill)
    assert kern.ROUTES["delta_spmm_decode"] == before["delta_spmm_decode"] + int(not prefill)
    chunks = torch.cat([kern.delta_spmm_cuda(x[i:i + 8], d, tb=8) for i in range(0, T, 8)])
    assert torch.equal(got.view(torch.int32), chunks.view(torch.int32))
    want = ref.correction_kernel_order(x, d)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("tb", kern.PREFILL_TILES)
@pytest.mark.parametrize("h_out", [200, 12800])    # 32- and 64-column blocks on 132 SMs
def test_delta_spmm_prefill_multi_block_deterministic(cuda, tb, h_out):
    d = _pack(64, h_out, 16, 8, 4, 12, cuda)
    x = _x(300, 64, 13, cuda)
    a = kern.delta_spmm_cuda(x, d, tb=tb)
    b = kern.delta_spmm_cuda(x, d, tb=tb)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert torch.equal(a.view(torch.int32), kern.delta_spmm_cuda(x, d, tb=8).view(torch.int32))


DECODE_T = [1, 2, 3, 5, 8, 9, 17, 32, 33, 64]
DECODE_CASES = [   # the envelope's edges: (h_in, h_out, h_g, alpha, k_bits)
    (256, 200, 16, 8, 4),       # h_out not a multiple of 16 (plain loads)
    (512, 130, 256, 2, 8),      # h_g 256, keep 128, h_out not a multiple of 4
    (384, 128, 32, 4, 3),       # odd k (packed at width 4), G = 12
    (256, 96, 64, 8, 1),        # 1-bit codes, G = 4: classes 4..7 empty
    (128, 256, 16, 2, None),    # raw f32 codes
    (4096, 160, 64, 2, 8),      # a class share over 48 KB: a ring of 4 stages
    (4096, 96, 256, 2, None),   # f32 codes, 80 KB a group: a ring of 2 stages
    # past the reference's Pallas envelope, as the compressor emits them
    (1024, 136, 512, 2, 4),     # h_g 512: int32 idx, keep 256, G = 2, ragged h_out
    (2048, 256, 2048, 8, None),  # h_g = h_in (DeltaDQSpec()'s default): f32 codes, G = 1
    (4096, 128, 1024, 8, 1),    # G = 4, int32 idx, 1-bit codes
    (2048, 200, 512, 2, None),  # a 256 KB group, past shared memory: runs of kept slots
    (11008, 128, 11008, 8, None),  # wizard's MLP wo row-wise: keep 1376, a 44 KB slab row
]
# the wide packings every route is held on (DECODE_CASES' last five)
WIDE_CASES = DECODE_CASES[-5:]


def _bits_equal(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("T", DECODE_T)
@pytest.mark.parametrize("h_in,h_out,h_g,alpha,k", DECODE_CASES)
def test_decode_route_equals_kernel_order(cuda, T, h_in, h_out, h_g, alpha, k):
    """The decode route (every T up to 64) equals the kernel-order oracle
    bit for bit at the envelope's edges, counts one decode-route launch,
    and gives the same bits on a second call."""
    d = _pack(h_in, h_out, h_g, alpha, k, 21, cuda)
    x = _x(T, h_in, 22, cuda)
    assert ops.spmm_row_tile(T, d) in kern.ROW_TILES
    before = kern.ROUTES["delta_spmm_decode"]
    got = ops.delta_spmm(x, d)
    torch.cuda.synchronize()
    assert kern.ROUTES["delta_spmm_decode"] == before + 1
    assert _bits_equal(got, ref.correction_kernel_order(x, d))
    assert _bits_equal(got, ops.delta_spmm(x, d))


@pytest.mark.gpu
@pytest.mark.parametrize("h_in,h_out,h_g,alpha,k", WIDE_CASES)
def test_wide_packing_every_route(cuda, h_in, h_out, h_g, alpha, k):
    """A packing past the reference's envelope on every route of the
    card: delta_spmm at DECODE_T (decode tiles) and at 65 and 128 rows
    (the 128-row tile, its windowed walk where a group does not fit), and
    at 65 and 128 rows on every tile the packing takes, the segments
    kernel (uncovered rows and an out-of-stack tenant zero), the slots and
    the expert route (with counts), all bit-equal to the kernel-order
    oracle and so to each other; dequant bit-equal to its plain version,
    fused_base_delta within the kernel tolerance; every call a kernel
    launch."""
    tenants = [_pack(h_in, h_out, h_g, alpha, k, 90 + t, cuda) for t in range(3)]
    d = tenants[0]
    assert d.idx.dtype == kern.idx_dtype(h_g) and ops.card_envelope_miss(d) is None
    assert ops.envelope_miss(d) is not None
    stack = stack_tenant_deltas([{"w": t} for t in tenants])["w"]
    x = _x(128, h_in, 91, cuda)
    wants = [ref.correction_kernel_order(x, t) for t in tenants]
    assert kern.prefill_fits(128, d.h_g, d.keep)
    for T in (65, 128):
        for tb in kern.SPMM_TILES:
            assert _bits_equal(kern.delta_spmm_cuda(x[:T], d, tb=tb), wants[0][:T]), (T, tb)
    kern.reset_launches()
    Ts = (*DECODE_T, 65, 128)
    for T in Ts:
        assert ops.spmm_row_tile(T, d) == (128 if T > 64 else ops.row_tile(T))
        assert _bits_equal(ops.delta_spmm(x[:T], d), wants[0][:T]), T
    rows = torch.tensor([1, 0, 2, 5], dtype=torch.int32, device=cuda)
    offs = torch.tensor([1, 4, 8, 11, 12], dtype=torch.int32, device=cuda)
    got = ops.delta_spmm_segments(x[:13], stack, rows, offs)
    want = torch.zeros_like(got)
    for t, lo, hi in ((1, 1, 4), (0, 4, 8), (2, 8, 11)):
        want[lo:hi] = wants[t][lo:hi]
    assert _bits_equal(got, want)
    pick = [1, 0, 2, 1]
    slot = stack_tenant_deltas([{"w": tenants[t]} for t in pick])["w"]
    got = ops.delta_spmm_slots(x[:4, None], slot)
    for b, t in enumerate(pick):
        assert _bits_equal(got[b, 0], wants[t][b])
    counts = torch.tensor([4, 1, 0], device=cuda)
    got = ops.delta_spmm_experts(x[:12].reshape(3, 4, h_in), stack, counts)
    for e in range(3):
        live = int(counts[e])
        assert _bits_equal(got[e, :live], wants[e][4 * e:4 * e + live])
        assert not got[e, live:].any()
    assert torch.equal(ops.dequant(d).view(torch.int32), fb.dequant(d).view(torch.int32))
    for w_dtype in (torch.bfloat16, torch.float32):
        w = (_x(h_in, h_out, 92, cuda) * 0.05).to(w_dtype)
        for T in (8, 128):
            torch.testing.assert_close(ops.fused_base_delta(x[:T], w, d),
                                       fb.fused_base_delta(x[:T], w, d), **TOL)
    torch.cuda.synchronize()
    assert kern.ROUTES == {"delta_spmm_decode": len(DECODE_T), "delta_spmm_prefill": 2}
    assert kern.LAUNCHES == {"delta_spmm": len(Ts), "delta_spmm_segments": 3,
                             "fused_base_delta": 4, "dequant": 1}


@pytest.mark.gpu
def test_unsorted_kept_slots_on_every_kernel(cuda):
    """Kept slots in another order than by index (no producer emits one;
    the fused kernel walks sorted slots with a cursor and checks the order
    first): each kernel still matches its plain version, the correction
    kernels to the oracle's bits, dequant bit for bit."""
    d = _pack(2048, 136, 2048, 8, None, 95, cuda)   # G = 1, f32 codes
    flip = d.with_arrays(d.idx.flip(-2).contiguous(), d.codes.flip(-2).contiguous(),
                         d.scale, d.zero)
    x = _x(128, 2048, 96, cuda)
    w = (_x(2048, 136, 97, cuda) * 0.05).to(torch.bfloat16)
    for T in (8, 128):
        got = ops.fused_base_delta(x[:T], w, flip)
        torch.testing.assert_close(got, fb.fused_base_delta(x[:T], w, flip), **TOL)
        torch.testing.assert_close(got, ops.fused_base_delta(x[:T], w, d), **TOL)
        assert _bits_equal(ops.delta_spmm(x[:T], flip), ref.correction_kernel_order(x[:T], flip))
    assert torch.equal(ops.dequant(flip).view(torch.int32), fb.dequant(flip).view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("h_g,k", [(2048, None), (512, 4), (256, 2)])
def test_prefill_window_one_unsorted_column(cuda, h_g, k):
    """One column's kept slots shuffled (no producer emits it): the
    128-row tile's windowed walk finds that column unsorted as it enters
    the group and walks it in slot order, every other column through the
    windows; every row equals the kernel-order oracle, and the decode
    tiles."""
    d = _pack(2048, 96, h_g, 8, k, 130, cuda)
    idx, codes = d.idx.clone(), d.codes.clone()
    perm = torch.randperm(d.keep, generator=torch.Generator().manual_seed(131)).to(cuda)
    idx[:, :, 37] = idx[:, perm, 37]
    if k is None:        # f32 codes move with their slots
        codes[:, :, 37] = codes[:, perm, 37]
    shuffled = d.with_arrays(idx, codes, d.scale, d.zero)
    x = _x(200, 2048, 132, cuda)
    want = ref.correction_kernel_order(x, shuffled)
    assert not _bits_equal(want, ref.correction_kernel_order(x, d))
    for T in (65, 128, 200):
        got = kern.delta_spmm_cuda(x[:T], shuffled, tb=128)
        assert _bits_equal(got, want[:T]), T
        assert _bits_equal(got, kern.delta_spmm_cuda(x[:T], shuffled, tb=8)), T


@pytest.mark.gpu
@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("k", [None, 4])
def test_narrow_decode_tiles_below_eight_groups(cuda, G, k):
    """G < 8 takes the narrow decode tile (32 columns, a warp a row, a
    cluster of G blocks): at every decode tile and T up to 9, and in the
    segments kernel (uncovered rows and an out-of-stack tenant zero),
    every row equals the kernel-order oracle."""
    # f32 codes at a ragged width (plain loads), 4-bit codes at 7 full
    # 32-column tiles (16-byte copies)
    h_in, h_out = 1024, 200 if k is None else 224
    tenants = [_pack(h_in, h_out, h_in // G, 8, k, 140 + t, cuda) for t in range(3)]
    d = tenants[0]
    for tb in kern.ROW_TILES:
        plan = kern.decode_plan(d, tb)
        assert plan["cols"] == 32 and plan["cluster"] == G, plan
    x = _x(13, h_in, 141, cuda)
    wants = [ref.correction_kernel_order(x, t) for t in tenants]
    for T in (1, 2, 3, 5, 8, 9):
        for tb in kern.ROW_TILES:
            assert _bits_equal(kern.delta_spmm_cuda(x[:T], d, tb=tb), wants[0][:T]), (T, tb)
    stack = stack_tenant_deltas([{"w": t} for t in tenants])["w"]
    rows = torch.tensor([1, 0, 2, 5], dtype=torch.int32, device=cuda)
    offs = torch.tensor([1, 4, 8, 11, 12], dtype=torch.int32, device=cuda)
    want = torch.zeros((13, h_out), device=cuda)
    for t, lo, hi in ((1, 1, 4), (0, 4, 8), (2, 8, 11)):
        want[lo:hi] = wants[t][lo:hi]
    for tb in kern.ROW_TILES:
        got = kern.delta_spmm_segments_cuda(x, stack, rows, offs, tb=tb)
        assert _bits_equal(got, want), tb


@pytest.mark.gpu
def test_decode_route_reads_x_from_global_where_one_slab_row_does_not_fit(cuda):
    """G = 1 at h_in = 65536: one row's x slab (256 KB) exceeds shared
    memory, so the plan reads x from global memory, one row a block; the
    rows keep the oracle's bits."""
    d = _pack(65536, 96, 65536, 64, 4, 93, cuda)
    plan = kern.decode_plan(d, 8)
    assert plan["x_global"] and plan["rows"] == 1 and plan["kc"] < d.keep
    x = _x(8, 65536, 94, cuda)
    want = ref.correction_kernel_order(x, d)
    for T in (1, 3, 8):
        assert _bits_equal(ops.delta_spmm(x[:T], d), want[:T])


@pytest.mark.gpu
def test_decode_plan_found_for_every_emitted_packing(cuda):
    """The decode route's plan exists, within shared memory, for every
    packing the compressor emits at the full-width sites of every config:
    each compressible leaf's (h_in, h_out), each group size the search
    tries for alpha 2, 4 and 8, each code width, each row tile. Host
    arithmetic in the library: nothing launches."""
    from types import SimpleNamespace

    from repro_torch.configs import get_config, list_archs
    from repro_torch.core.compress import is_compressible
    from repro_torch.core.dropout import keep_count
    from repro_torch.core.groupsearch import candidate_group_sizes
    from repro_torch.launch.dryrun import param_specs
    from repro_torch.utils import map_with_paths, materialize
    sites = set()

    def site(path, leaf):
        if leaf is not None and is_compressible(path, leaf):
            sites.add(tuple(leaf.shape[-2:]))

    for arch in list_archs():
        map_with_paths(site, materialize(param_specs(get_config(arch))))
    assert (4096, 11008) in sites and (24576, 3072) in sites
    n = 0
    for h_in, h_out in sorted(sites):
        for alpha in (2, 4, 8):
            for h_g in candidate_group_sizes(h_in, alpha):
                for k in (None, 1, 2, 4, 8):
                    d = SimpleNamespace(h_in=h_in, h_out=h_out, h_g=h_g,
                                        keep=keep_count(h_g, alpha), k_bits=k,
                                        codec="deltadq")
                    for tb in kern.ROW_TILES:
                        plan = kern.decode_plan(d, tb)
                        assert plan is not None, (h_in, h_out, h_g, alpha, k, tb)
                        assert plan["smem_bytes"] <= 232448 and 1 <= plan["rows"] <= tb
                        assert not plan["x_global"]
                        assert plan["cluster"] == min(h_in // h_g, 8)
                        n += 1
    assert n > 1000


@pytest.mark.gpu
@pytest.mark.parametrize("T", [1, 5, 9, 64])
def test_decode_route_on_a_layer_slice(cuda, T):
    """A layer slice of a stacked [L, ...] delta (an offset that is not
    16-byte aligned takes plain loads) has the bits of its own copy."""
    layers = [_pack(192, 80, 16, 8, 4, 60 + i, cuda) for i in range(3)]
    stacked = stack_tenant_deltas([{"w": t} for t in layers])["w"]
    x = _x(T, 192, 23, cuda)
    for i in range(3):
        got = ops.delta_spmm(x, stacked.index(i))
        assert _bits_equal(got, ref.correction_kernel_order(x, layers[i]))
        assert _bits_equal(got, ops.delta_spmm(x, layers[i]))


@pytest.mark.gpu
@pytest.mark.parametrize("tb", kern.ROW_TILES)
def test_decode_tiles_give_every_row_the_same_bits(cuda, tb):
    """Each decode tile (a cap on the rows a block computes) gives every
    row of T = 21 the bits of the oracle."""
    d = _pack(256, 200, 16, 8, 4, 24, cuda)
    x = _x(21, 256, 25, cuda)
    assert _bits_equal(kern.delta_spmm_cuda(x, d, tb=tb), ref.correction_kernel_order(x, d))


SEGMENT_CASES = {   # (T, seg_rows, seg_offsets), over a stack of 3 tenants
    "slots, 8 one-row segments": (8, list(range(3)) * 2 + [0, 1], list(range(9))),
    "tenant_segments, padded": (8, [0, 1, 2, 0, 0, 0, 0, 0], [0, 2, 5, 8, 8, 8, 8, 8, 8]),
    "empty segments between": (6, [1, 0, 2, 2], [0, 2, 2, 6, 6]),
    "out-of-stack tenant row": (7, [2, 3, 0], [0, 3, 5, 7]),
    "uncovered rows before and after": (12, [1, 0], [2, 5, 9]),
    "straddling row tiles": (36, [1, 0, 2], [0, 5, 16, 36]),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(SEGMENT_CASES))
def test_segments_kernel_bits(cuda, case):
    """Segment rows equal delta_spmm rows of their tenant and the
    segments oracle bit for bit; uncovered rows and out-of-stack tenants
    are zero; two calls give the same bits."""
    T, seg_rows, seg_offsets = SEGMENT_CASES[case]
    tenants = [_pack(256, 200, 16, 8, 4, 70 + t, cuda) for t in range(3)]
    stack = stack_tenant_deltas([{"w": t} for t in tenants])["w"]
    xs = _x(T, 256, 26, cuda)
    rows = torch.tensor(seg_rows, dtype=torch.int32, device=cuda)
    offs = torch.tensor(seg_offsets, dtype=torch.int32, device=cuda)
    before = kern.LAUNCHES["delta_spmm_segments"]
    got = ops.delta_spmm_segments(xs, stack, rows, offs)
    torch.cuda.synchronize()
    assert kern.LAUNCHES["delta_spmm_segments"] == before + 1
    assert _bits_equal(got, ref.segments_kernel_order(xs, stack, rows, offs))
    covered = torch.zeros(T, dtype=torch.bool, device=cuda)
    for s, t in enumerate(seg_rows):
        lo, hi = seg_offsets[s], seg_offsets[s + 1]
        if hi > lo and t < 3:
            covered[lo:hi] = True
            assert _bits_equal(got[lo:hi], ops.delta_spmm(xs, stack.index(t))[lo:hi])
    assert not got[~covered].any()
    assert _bits_equal(got, ops.delta_spmm_segments(xs, stack, rows, offs))


@pytest.mark.gpu
def test_slots_rows_equal_delta_spmm_rows(cuda):
    """delta_spmm_slots (one-row segments of a row-gathered stack) gives
    each row the bits of delta_spmm with that row's delta."""
    tenants = [_pack(256, 200, 16, 8, 4, 80 + t, cuda) for t in range(2)]
    stack = stack_tenant_deltas([{"w": t} for t in tenants])["w"]
    pick = torch.tensor([1, 0, 1, 1], device=cuda)
    g = stack.with_arrays(stack.idx[pick], stack.codes[pick], stack.scale[pick],
                          stack.zero[pick])
    x = _x(8, 256, 27, cuda).reshape(4, 2, 256)
    got = ops.delta_spmm_slots(x, g)
    for b, t in enumerate(pick.tolist()):
        assert _bits_equal(got[b], ops.delta_spmm(x[b], tenants[t]))


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [[2, 0, 2, 1, 0, 2, 1, 0], [0, 0, 0, 0],
                                  [1] * 5 + [0] * 11 + [2] * 20])
def test_segments_kernel_matches_plain_and_spmm_bits(cuda, rows):
    tenants = [_pack(128, 200, 16, 8, 4, 10 + t, cuda) for t in range(3)]
    stack = stack_tenant_deltas([{"w": t} for t in tenants])["w"]
    rows = np.asarray(rows, np.int32)
    seg = tenant_segments(rows).to(cuda)
    xs = _x(len(rows), 128, 5, cuda).index_select(0, seg.order)
    before = kern.LAUNCHES["delta_spmm_segments"]
    got = ops.delta_spmm_segments(xs, stack, seg.seg_rows, seg.seg_offsets)
    torch.cuda.synchronize()
    assert kern.LAUNCHES["delta_spmm_segments"] == before + 1
    torch.testing.assert_close(
        got, fb.segment_correction(xs, stack, seg.seg_rows, seg.seg_offsets), **TOL)
    sorted_rows = torch.as_tensor(rows, device=cuda)[seg.order]
    for t in range(3):
        sel = sorted_rows == t
        assert torch.equal(got[sel], ops.delta_spmm(xs, stack.index(t))[sel])


@pytest.mark.gpu
def test_segments_kernel_zero_fills_uncovered_rows(cuda):
    """Rows past the last segment, and a segment whose tenant row is
    outside the stack, come back zero, as from the plain version."""
    tenants = [_pack(64, 96, 16, 8, 4, 40 + t, cuda) for t in range(2)]
    stack = stack_tenant_deltas([{"w": t} for t in tenants])["w"]
    x = _x(10, 64, 9, cuda)
    seg_rows = torch.tensor([1, 5, 0], dtype=torch.int32, device=cuda)
    seg_offsets = torch.tensor([0, 3, 5, 7], dtype=torch.int32, device=cuda)
    for _ in range(2):     # the second call reuses the first's freed output
        got = ops.delta_spmm_segments(x, stack, seg_rows, seg_offsets)
        torch.testing.assert_close(
            got, fb.segment_correction(x, stack, seg_rows, seg_offsets), **TOL)
        assert torch.equal(got[3:5], torch.zeros_like(got[3:5]))
        assert torch.equal(got[7:], torch.zeros_like(got[7:]))
        assert torch.equal(got[:3], ops.delta_spmm(x[:3], stack.index(1)))
        del got


@pytest.mark.gpu
def test_slots_route_through_segments_kernel(cuda):
    tenants = [_pack(64, 96, 16, 8, 4, 20 + t, cuda) for t in range(2)]
    stack = stack_tenant_deltas([{"w": t} for t in tenants])["w"]
    rows = torch.tensor([1, 0, 1], device=cuda)
    g = stack.with_arrays(stack.idx[rows], stack.codes[rows], stack.scale[rows],
                          stack.zero[rows])
    x = _x(6, 64, 6, cuda).reshape(3, 2, 64)
    torch.testing.assert_close(ops.delta_spmm_slots(x, g),
                               fb.gather_correction_rows(x, g), **TOL)


@pytest.mark.gpu
def test_kernel_wrappers_raise_on_bad_inputs(cuda):
    d = _pack(64, 32, 16, 8, 4, 7, cuda)
    with pytest.raises(ValueError):
        kern.delta_spmm_cuda(_x(4, 64, 0, cuda).t().contiguous().t(), d, tb=8)
    with pytest.raises(ValueError):
        kern.delta_spmm_cuda(_x(4, 64, 0, "cpu"), d, tb=8)
    with pytest.raises(ValueError):
        kern.delta_spmm_cuda(_x(4, 64, 0, cuda), d, tb=12)


@pytest.mark.gpu
@pytest.mark.parametrize("T,h_in,h_out,h_g,alpha,k", SWEEP)
def test_dequant_kernel_bit_equal_to_plain(cuda, T, h_in, h_out, h_g, alpha, k):
    d = _pack(h_in, h_out, h_g, alpha, k, 0, cuda)
    before = kern.LAUNCHES["dequant"]
    got = ops.dequant(d)
    torch.cuda.synchronize()
    assert kern.LAUNCHES["dequant"] == before + 1
    assert got.dtype == torch.float32 and tuple(got.shape) == (h_in, h_out)
    assert torch.equal(got.view(torch.int32), fb.dequant(d).view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("w_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T,h_in,h_out,h_g,alpha,k", SWEEP)
def test_fused_kernel_matches_plain(cuda, w_dtype, T, h_in, h_out, h_g, alpha, k):
    d = _pack(h_in, h_out, h_g, alpha, k, 0, cuda)
    x = _x(T, h_in, 1, cuda)
    w = (_x(h_in, h_out, 2, cuda) * 0.05).to(w_dtype)
    before = kern.LAUNCHES["fused_base_delta"]
    got = ops.fused_base_delta(x, w, d)
    torch.cuda.synchronize()
    assert kern.LAUNCHES["fused_base_delta"] == before + 1
    torch.testing.assert_close(got, fb.fused_base_delta(x, w, d), **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("w_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h_out", [96, 200, 100])   # 100: bf16 rows not 16-byte aligned
@pytest.mark.parametrize("T", [2, 16, 17, 128])
def test_fused_kernel_ragged_shapes_and_splits(cuda, w_dtype, h_out, T):
    """Ragged rows and columns, the K split (T=2 over one column block
    splits K) and its fixed-order combine: within tolerance, and two calls
    give the same bits."""
    d = _pack(256, h_out, 16, 8, 4, 14, cuda)
    x = _x(T, 256, 15, cuda)
    w = (_x(256, h_out, 16, cuda) * 0.05).to(w_dtype)
    got = ops.fused_base_delta(x, w, d)
    torch.testing.assert_close(got, fb.fused_base_delta(x, w, d), **TOL)
    again = ops.fused_base_delta(x, w, d)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


@pytest.mark.gpu
def test_fused_kernel_leading_dims_and_rows(cuda):
    """x [..., h_in] keeps its leading dims; a row does not depend on
    the batch it is in beyond summation order (the tolerance)."""
    d = _pack(256, 200, 16, 8, 4, 4, cuda)
    w = (_x(256, 200, 5, cuda) * 0.05).to(torch.bfloat16)
    x = _x(40, 256, 6, cuda)
    full = ops.fused_base_delta(x.reshape(4, 10, 256), w, d)
    assert tuple(full.shape) == (4, 10, 200)
    torch.testing.assert_close(ops.fused_base_delta(x[5:6], w, d), full.reshape(40, 200)[5:6],
                               **TOL)


@pytest.mark.gpu
def test_merge_delta_runs_dequant_per_layer_slice(cuda):
    layers = [_pack(64, 96, 16, 8, 4, 50 + i, cuda) for i in range(3)]
    stacked = stack_tenant_deltas([{"w": t} for t in layers])["w"]      # [L=3, ...]
    params = {"w": (_x(192, 96, 7, cuda) * 0.05).reshape(3, 64, 96).to(torch.bfloat16),
              "b": _x(1, 96, 8, cuda)[0]}
    before = kern.LAUNCHES["dequant"]
    merged = merge_delta(params, {"w": stacked, "b": None})
    torch.cuda.synchronize()
    assert kern.LAUNCHES["dequant"] == before + 3
    want = (params["w"].float() + reconstruct_dense(stacked)).to(torch.bfloat16)
    assert merged["w"].dtype == torch.bfloat16 and torch.equal(merged["w"], want)
    assert merged["b"] is params["b"]


@pytest.mark.gpu
def test_merge_kernel_wrappers_raise_on_bad_inputs(cuda):
    d = _pack(64, 32, 16, 8, 4, 7, cuda)
    x = _x(4, 64, 0, cuda)
    w = torch.zeros((64, 32), device=cuda)
    for bad_w in (w.t().contiguous().t(), torch.zeros((32, 64), device=cuda),
                  w.cpu()):
        with pytest.raises(ValueError):
            kern.fused_base_delta_cuda(x, bad_w, d, tb=8)
    with pytest.raises(TypeError):
        kern.fused_base_delta_cuda(x, w.double(), d, tb=8)
    with pytest.raises(TypeError):
        kern.fused_base_delta_cuda(x.to(torch.bfloat16), w, d, tb=8)
    with pytest.raises(ValueError):
        kern.fused_base_delta_cuda(x, w, d, tb=12)
    with pytest.raises(ValueError):
        kern.fused_base_delta_cuda(x.cpu(), w, d, tb=8)
    with pytest.raises(ValueError):
        kern.dequant_cuda(d.to("cpu"))
    stacked = stack_tenant_deltas([{"w": d}, {"w": d}])["w"]
    with pytest.raises(ValueError):
        kern.dequant_cuda(stacked)


def test_merge_kernel_wrappers_refuse_cpu_tensors_before_building():
    """The fused and dequant wrappers raise on CPU tensors and on deltas
    they cannot read, without reaching the build (runs on the CPU)."""
    d = _pack(64, 32, 16, 8, 4, 7, "cpu")
    with pytest.raises(ValueError):
        kern.fused_base_delta_cuda(_x(4, 64, 0, "cpu"), torch.zeros((64, 32)), d, tb=8)
    with pytest.raises(ValueError):
        kern.dequant_cuda(d)
    stacked = stack_tenant_deltas([{"w": d}, {"w": d}])["w"]
    assert kern.check_delta(d, d.idx.device, stacked=False) == (1, 4)
    with pytest.raises(ValueError):
        kern.check_delta(stacked, d.idx.device, stacked=False)


def test_launch_checks_accept_layer_slices_and_reject_bad_layouts():
    """The wrappers' layout checks run on the CPU too: a layer slice of a
    [R, L, ...] tenant stack (what mixed decode hands the segments kernel)
    is strided along R and accepted; what the kernels cannot read raises."""
    layers = [{"w": _pack(64, 32, 16, 8, 4, 30 + i, "cpu")} for i in range(3)]
    per_tenant = [{"w": stack_tenant_deltas([layers[i]["w"], layers[(i + 1) % 3]["w"]])}
                  for i in range(3)]                       # [L=2] stacks
    stack = stack_tenant_deltas(per_tenant)["w"]           # [R=3, L=2, ...]
    sliced = stack.with_arrays(stack.idx[:, 1], stack.codes[:, 1], stack.scale[:, 1],
                               stack.zero[:, 1])
    assert not sliced.idx.is_contiguous()
    x = _x(4, 64, 0, "cpu")
    assert kern.check_inputs(x, sliced, stacked=True) == (1, 4)
    assert kern.check_inputs(x, layers[0]["w"], stacked=False) == (1, 4)
    with pytest.raises(ValueError):
        kern.check_inputs(_x(4, 32, 0, "cpu"), layers[0]["w"], stacked=False)
    for dtype in (torch.float64, torch.bfloat16):
        with pytest.raises(TypeError):
            kern.check_inputs(x.to(dtype), layers[0]["w"], stacked=False)
    bad = layers[0]["w"].with_arrays(layers[0]["w"].idx.to(torch.int32),
                                     layers[0]["w"].codes, layers[0]["w"].scale,
                                     layers[0]["w"].zero)
    with pytest.raises(ValueError):
        kern.check_inputs(x, bad, stacked=False)
    with pytest.raises(ValueError):
        kern.delta_spmm_cuda(x, layers[0]["w"], tb=8)       # a CPU tensor


def test_prefill_row_tiles_are_delta_spmm_only(monkeypatch):
    """delta_spmm takes the 128-row prefill tile above 64 rows where its
    shared memory fits, else the decode route's tile (1/2/4/8 rows, the
    smallest holding T up to 8); the segments kernel takes the decode
    tiles too, the fused kernel keeps its caps 8/16/32 (CPU)."""
    def no_build():
        raise AssertionError("the tile choice asked the library")
    monkeypatch.setattr(kern, "_load", no_build)
    d = _pack(64, 32, 16, 8, 4, 7, "cpu")
    # up to 64 rows the choice never asks whether the prefill tile fits
    assert [ops.spmm_row_tile(T, d) for T in (1, 2, 3, 5, 8, 9, 32, 33, 64)] \
        == [1, 2, 4, 8, 8, 8, 8, 8, 8]
    # past 64 rows it does (the library's answer, a card test, stood in
    # for: every packing, since the windowed walk)
    monkeypatch.setattr(kern, "prefill_fits",
                        lambda tb, h_g, keep: tb in kern.PREFILL_TILES and 1 <= keep <= h_g)
    assert [ops.spmm_row_tile(T, d) for T in (65, 100, 128, 129, 160, 161, 256, 300)] \
        == [128] * 8
    big = _pack(512, 32, 256, 16, 4, 7, "cpu")             # h_g 256: the windowed walk
    assert ops.spmm_row_tile(128, big) == 128
    assert [ops.row_tile(T) for T in (1, 2, 3, 4, 7, 9, 33, 128, 256)] == \
        [1, 2, 4, 4, 8, 8, 8, 8, 8]
    assert [ops.fused_row_tile(T) for T in (1, 9, 33, 128, 256)] == [8, 16, 32, 32, 32]
    assert set(kern.PREFILL_TILES).isdisjoint(kern.ROW_TILES)


@pytest.mark.gpu
def test_prefill_fits_asks_the_library(cuda):
    assert kern.prefill_fits(128, 16, 2) and kern.prefill_fits(128, 128, 16)
    # every packing: the windowed walk takes what no whole group fits
    assert kern.prefill_fits(128, 256, 16) and kern.prefill_fits(128, 128, 128)
    assert kern.prefill_fits(128, 11008, 1376) and kern.prefill_fits(128, 4096, 4096)
    assert not kern.prefill_fits(128, 16, 17)        # keep above h_g: no packing
    assert not kern.prefill_fits(64, 16, 2)          # not a prefill tile


def test_prefill_tiles_rejected_by_segments_and_fused_before_building(monkeypatch):
    def no_build():
        raise AssertionError("the wrapper reached the build")
    monkeypatch.setattr(kern, "_load", no_build)
    d = _pack(64, 32, 16, 8, 4, 7, "cpu")
    stack = stack_tenant_deltas([{"w": d}, {"w": d}])["w"]
    rows = torch.zeros(1, dtype=torch.int32)
    offs = torch.tensor([0, 4], dtype=torch.int32)
    for tb in (64, *kern.PREFILL_TILES):
        with pytest.raises(ValueError, match=f"tb={tb}"):
            kern.delta_spmm_segments_cuda(_x(4, 64, 0, "cpu"), stack, rows, offs, tb=tb)
        with pytest.raises(ValueError, match=f"tb={tb}"):
            kern.fused_base_delta_cuda(_x(4, 64, 0, "cpu"), torch.zeros((64, 32)), d, tb=tb)
    for tb in (12, 64):
        with pytest.raises(ValueError, match=f"tb={tb}"):
            kern.delta_spmm_cuda(_x(4, 64, 0, "cpu"), d, tb=tb)


# ---------------------------------------------------------------------------
# The continuous-batching engine on the card (smoke config)
# ---------------------------------------------------------------------------
@pytest.fixture
def engine_fleet(cuda):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import RATIO_SPECS, synth_tenants
    from repro_torch.models import lm
    cfg = get_smoke_config("wizard-llama2-7b")
    base = lm.init_params(cfg, 0, device=cuda)
    return cfg, base, synth_tenants(cfg, base, 3, RATIO_SPECS[128], seed=0)


def _cuda_engine(fleet, **kw):
    from repro_torch.serve import ContinuousEngine, VirtualClock
    cfg, base, tenants = fleet
    eng = ContinuousEngine(cfg, base, n_slots=4, max_seq=32,
                           clock=VirtualClock(tick=1e-3), **kw)
    for name, d, rep in tenants:
        eng.register_tenant(name, d, rep)
    return eng


def _cuda_stream(vocab, lengths=(5, 9, 7, 12, 5, 9, 3, 7, 11, 4)):
    rng = np.random.default_rng(9)
    return [(f"tenant{i % 3}" if i % 4 else None, rng.integers(0, vocab, L))
            for i, L in enumerate(lengths)]


def _submit_all(eng, stream, idx=None, max_new=6):
    idx = range(len(stream)) if idx is None else idx
    return [eng.submit(stream[i][0], stream[i][1], max_new_tokens=max_new,
                       arrival=0.002 * i) for i in idx]


@pytest.mark.gpu
@pytest.mark.parametrize("chunked", [False, True])
def test_engine_mixed_equals_alone_on_card(engine_fleet, chunked):
    """Mixed-tenant serving == each tenant's requests alone, token for
    token, at equal n_slots: the base GEMMs and attention run at the same
    extents and the delta kernels' rows do not depend on the layout."""
    eng = _cuda_engine(engine_fleet, **(dict(chunked_prefill=True, chunk_size=4)
                                        if chunked else {}))
    stream = _cuda_stream(engine_fleet[0].vocab)
    mixed = _submit_all(eng, stream)
    eng.run()
    for tenant in (None, "tenant0", "tenant1", "tenant2"):
        eng.reset_metrics()
        idx = [i for i, (t, _) in enumerate(stream) if t == tenant]
        alone = _submit_all(eng, stream, idx)
        eng.run()
        for i, r in zip(idx, alone):
            np.testing.assert_array_equal(r.output(), mixed[i].output())


def spmm_routes(deltas, Ts) -> dict:
    """delta_spmm launches by route that ``ops``' choice gives one call at
    each T of ``Ts`` at every layer of every packed leaf of ``deltas``."""
    from repro_torch.core.pack import PackedDelta
    from repro_torch.utils import iter_leaves
    out = {"delta_spmm_decode": 0, "delta_spmm_prefill": 0}
    for _, leaf in iter_leaves(deltas):
        if isinstance(leaf, PackedDelta):
            for layer in range(leaf.stack_shape()[0]):
                for T in Ts:
                    tb = ops.spmm_row_tile(T, leaf.index(layer))
                    out["delta_spmm_prefill" if tb in kern.PREFILL_TILES
                        else "delta_spmm_decode"] += 1
    return out


@pytest.mark.gpu
def test_engine_launch_counts_on_card(engine_fleet):
    """Every prefill launches delta_spmm once per linear site (base
    requests on the zero tree), every decode step delta_spmm_segments
    once per site; each site's route is ops' choice at its bucket."""
    cfg = engine_fleet[0]
    sites = 7 * cfg.n_layers
    eng = _cuda_engine(engine_fleet)
    stream = _cuda_stream(cfg.vocab)
    _submit_all(eng, stream)
    kern.reset_launches()
    rep = eng.run().report()
    torch.cuda.synchronize()
    assert rep["prefills"] == len(stream) and rep["total_tokens"] == 6 * len(stream)
    assert kern.LAUNCHES["delta_spmm"] == sites * len(stream)
    buckets = [eng.buckets.bucket(len(p)) for _, p in stream]      # 8 and 16
    assert dict(kern.ROUTES) == spmm_routes(engine_fleet[2][0][1], buckets)
    assert kern.LAUNCHES["delta_spmm_segments"] == sites * rep["decode_steps"]
    assert kern.LAUNCHES["fused_base_delta"] == kern.LAUNCHES["dequant"] == 0
    assert rep["decode_paths"] == {"segments-cuda+packed": rep["decode_steps"]}


@pytest.mark.gpu
def test_engine_chunks_launch_segments_at_chunk_size(engine_fleet, monkeypatch):
    """Chunked prefill threads every chunk through the segments kernel
    (a one-row segment of chunk_size = 3 tokens) and every step's decode
    through it at T = n_slots = 4; no whole-prompt delta_spmm runs."""
    cfg = engine_fleet[0]
    rows = []
    real = kern.delta_spmm_segments_cuda

    def spy(x2, d, seg_rows, seg_offsets, *, tb):
        rows.append(x2.shape[0])
        return real(x2, d, seg_rows, seg_offsets, tb=tb)

    monkeypatch.setattr(kern, "delta_spmm_segments_cuda", spy)
    eng = _cuda_engine(engine_fleet, chunked_prefill=True, chunk_size=3)
    stream = _cuda_stream(cfg.vocab)
    _submit_all(eng, stream)
    kern.reset_launches()
    rep = eng.run().report()
    torch.cuda.synchronize()
    sites = 7 * cfg.n_layers
    n_chunks = sum(-(-len(p) // 3) for _, p in stream)
    assert kern.LAUNCHES["delta_spmm"] == 0
    assert rows.count(3) == sites * n_chunks
    assert rows.count(4) == sites * rep["decode_steps"]
    assert set(rows) == {3, 4}
    assert kern.LAUNCHES["delta_spmm_segments"] == len(rows)


# ---------------------------------------------------------------------------
# The codec packings: BitDelta and LowRank lowerings (keep = h_g = 128)
# ---------------------------------------------------------------------------
def _codec_packed(codec, h_in, h_out, seed, device):
    from repro_torch.core import codecs
    g = torch.Generator().manual_seed(seed)
    c = codecs.get_codec(codec)
    base = torch.randn((h_in, h_out), generator=g) * 0.02
    ft = base + torch.randn((h_in, h_out), generator=g) * 0.02
    spec = codecs.BitDeltaSpec() if codec == "bitdelta" else codecs.LowRankSpec(rank=4)
    return c.runtime_packed(c.compress_leaf(base, ft, spec)).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("T", [1, 8, 16, 64, 128])
@pytest.mark.parametrize("codec", ["bitdelta", "lowrank"])
def test_codec_packings_through_both_kernels(cuda, codec, T):
    """Both correction kernels against their plain versions on a codec's
    lowering, a row's bits equal in its segment, and the group's zero
    row exactly 0.0 (the mixed-codec identity rests on it)."""
    from repro_torch.core.apply import zero_delta_like
    d = _codec_packed(codec, 384, 200, 50, cuda)
    assert (d.h_g, d.keep) == (128, 128) and ops.envelope_miss(d) is None
    x = _x(T, 384, 51, cuda)
    before = dict(kern.LAUNCHES)
    y = ops.delta_spmm(x, d)
    torch.testing.assert_close(y, fb.correction(x, d, gather_max_t=8), **TOL)
    stack = stack_tenant_deltas([zero_delta_like({"w": d}), {"w": d}])["w"]
    rows = (np.arange(T) % 2).astype(np.int32)
    seg = tenant_segments(rows).to(cuda)
    xs = x.index_select(0, seg.order)
    ys = ops.delta_spmm_segments(xs, stack, seg.seg_rows, seg.seg_offsets)
    torch.cuda.synchronize()
    assert kern.LAUNCHES["delta_spmm"] == before["delta_spmm"] + 1
    assert kern.LAUNCHES["delta_spmm_segments"] == before["delta_spmm_segments"] + 1
    own = torch.as_tensor(rows, device=cuda)[seg.order] == 1
    assert torch.equal(ys[own], y.index_select(0, seg.order)[own])
    assert torch.equal(ys[~own], torch.zeros_like(ys[~own]))


@pytest.mark.gpu
@pytest.mark.parametrize("h_in,h_out", [(2048, 384), (1024, 200), (11008 // 8, 136), (200, 40)])
@pytest.mark.parametrize("codec", ["bitdelta", "lowrank"])
def test_dense_walk_equals_its_twin_at_every_tile(cuda, codec, h_in, h_out):
    """The dense-group walk (the codecs' lowerings: no idx read) is bit-equal
    to its plain twin at every decode tile and every T up to 8 rows a
    tile, in a two-group segments layout (rows of the other group on the
    zero row) with each segment row equal to delta_spmm's row; the plan
    and the launch counters say the walk ran."""
    from repro_torch.core.apply import zero_delta_like
    from repro_torch.core.pack import dense_groups
    d = _codec_packed(codec, h_in, h_out, 60, cuda)
    assert dense_groups(d)
    stack = stack_tenant_deltas([zero_delta_like({"w": d}), {"w": d}])["w"]
    for tb in kern.ROW_TILES:
        plan = kern.decode_plan(d, tb)
        assert plan["walk"] == "dense" and plan["cols"] == 128 and plan["rows"] <= tb
    for T in (1, 2, 3, 5, 8, 13, 37):
        x = _x(T, h_in, 61 + T, cuda)
        want = ref.dense_groups_kernel_order(x, d)
        assert _bits_equal(want, ref.correction_kernel_order(x, d))
        before = dict(kern.WALKS)
        for tb in kern.ROW_TILES:
            assert _bits_equal(kern.delta_spmm_cuda(x, d, tb=tb), want), (T, tb)
        rows = (np.arange(T) % 3 == 1).astype(np.int32)
        seg = tenant_segments(rows).to(cuda)
        xs = x.index_select(0, seg.order)
        seg_rows, seg_offsets = (t.to(torch.int32).contiguous()
                                 for t in (seg.seg_rows, seg.seg_offsets))
        wants = ref.dense_segments_kernel_order(xs, stack, seg_rows, seg_offsets)
        for tb in kern.ROW_TILES:
            ys = kern.delta_spmm_segments_cuda(xs, stack, seg_rows, seg_offsets, tb=tb)
            assert _bits_equal(ys, wants), (T, tb)
        own = torch.as_tensor(rows, device=cuda)[seg.order] == 1
        assert torch.equal(ys[own], want.index_select(0, seg.order)[own])
        assert torch.equal(ys[~own], torch.zeros_like(ys[~own]))
        torch.cuda.synchronize()
        assert kern.WALKS["delta_spmm_dense"] == before["delta_spmm_dense"] + 4
        assert kern.WALKS["delta_spmm_segments_dense"] == before["delta_spmm_segments_dense"] + 4


@pytest.mark.gpu
@pytest.mark.parametrize("codec", ["bitdelta", "lowrank"])
def test_dense_walk_on_layer_and_column_slices(cuda, codec):
    """A layer slice of an [R, L] codec group (strided along R) and a mesh
    rank's column slice take the dense walk and equal the twin: a slice's
    columns are the whole matrix's columns bit for bit."""
    from repro_torch.launch import mesh as mesh_lib
    layers = [_codec_packed(codec, 512, 256, 70 + i, cuda) for i in range(3)]
    tenant = layers[0].with_arrays(*(torch.stack([getattr(d, f) for d in layers])
                                     for f in ("idx", "codes", "scale", "zero")))
    table = stack_tenant_deltas([{"w": tenant}, {"w": tenant}])["w"]        # [R, L, ...]
    sl = table.with_arrays(table.idx[:, 1], table.codes[:, 1], table.scale[:, 1],
                           table.zero[:, 1])
    x = _x(8, 512, 71, cuda)
    offs = torch.tensor([0, 5, 8], dtype=torch.int32, device=cuda)
    rows = torch.tensor([1, 0], dtype=torch.int32, device=cuda)
    before = dict(kern.WALKS)
    want = ref.dense_groups_kernel_order(x, layers[1])
    got = ops.delta_spmm_segments(x, sl, rows, offs)
    assert _bits_equal(got, want)
    for m in range(2):
        view = mesh_lib.ServingMesh.view(model=2, model_index=m)
        cut = mesh_lib.shard_delta(layers[1], view)
        assert cut.shards == 2 and kern.decode_plan(cut, 8)["walk"] == "dense"
        assert _bits_equal(ops.delta_spmm(x, cut), want[:, m * 128:(m + 1) * 128])
    torch.cuda.synchronize()
    assert kern.WALKS["delta_spmm_dense"] == before["delta_spmm_dense"] + 2
    assert kern.WALKS["delta_spmm_segments_dense"] == before["delta_spmm_segments_dense"] + 1


@pytest.mark.gpu
@pytest.mark.parametrize("h_in", [512, 1024])
@pytest.mark.parametrize("k", [2, None])
def test_deltadq_keep_h_g_with_permuted_idx_takes_the_general_walk(cuda, k, h_in):
    """A DeltaDQ packing at keep = h_g (alpha 1) is no lowering: its idx is
    what the packer wrote, here permuted in every group and column, so the
    decode tiles take a walk that reads it (the general one, the narrow
    tile's at G < 8) and match plain."""
    d = _pack(h_in, 136, 128, 1.0, k, 62, cuda)
    G, K, O = d.idx.shape
    perm = torch.stack([torch.randperm(K, generator=torch.Generator().manual_seed(o))
                        for o in range(O)], dim=1).to(cuda)
    d = d.with_arrays(torch.gather(d.idx, 1, perm.expand(G, K, O)).contiguous(), d.codes,
                      d.scale, d.zero)
    assert d.codec == "deltadq" and d.keep == d.h_g
    x = _x(8, h_in, 63, cuda)
    before = dict(kern.WALKS)
    want = ref.correction_kernel_order(x, d)
    for tb in kern.ROW_TILES:
        assert kern.decode_plan(d, tb)["walk"] == ("narrow" if G < 8 else "general")
        assert _bits_equal(kern.delta_spmm_cuda(x, d, tb=tb), want)
    torch.testing.assert_close(ops.delta_spmm(x, d), fb.correction(x, d, gather_max_t=8),
                               **TOL)
    stack = stack_tenant_deltas([{"w": d}, {"w": d}])["w"]
    offs = torch.tensor([0, 3, 8], dtype=torch.int32, device=cuda)
    rows = torch.tensor([1, 0], dtype=torch.int32, device=cuda)
    assert _bits_equal(kern.delta_spmm_segments_cuda(x, stack, rows, offs, tb=8), want)
    torch.cuda.synchronize()
    assert kern.WALKS == before


@pytest.mark.gpu
def test_prefill_tile_refuses_keep_128_and_decode_route_takes_it(cuda):
    """The BitDelta lowering (keep = h_g = 128), once refused by the
    128-row tile, takes it by rule from 65 rows on the windowed walk, bit
    for bit the decode route's tile 8 and a row alone; a tile the kernels
    do not have still raises."""
    d = _codec_packed("bitdelta", 256, 96, 52, cuda)
    assert kern.prefill_fits(128, 128, 128)
    assert ops.spmm_row_tile(128, d) == 128
    x = _x(128, 256, 53, cuda)
    before = dict(kern.ROUTES)
    y = ops.delta_spmm(x, d)
    torch.cuda.synchronize()
    assert kern.ROUTES["delta_spmm_prefill"] == before["delta_spmm_prefill"] + 1
    assert kern.ROUTES["delta_spmm_decode"] == before["delta_spmm_decode"]
    assert _bits_equal(y, kern.delta_spmm_cuda(x, d, tb=8))
    assert _bits_equal(y[5:6], ops.delta_spmm(x[5:6], d))
    with pytest.raises(ValueError, match="not in"):
        kern.delta_spmm_cuda(x, d, tb=64)


@pytest.mark.gpu
def test_table_row_write_leaves_other_rows_unchanged(cuda):
    """TenantTable.write/clear on the card: in place, one row's bytes."""
    from repro_torch.serve import TenantTable
    trees = [{"w": _pack(128, 64, 16, 8, 4, 60 + t, cuda)} for t in range(3)]
    table = TenantTable(trees[0], capacity=3)
    w = table.stacked["w"]
    ptrs = [a.data_ptr() for a in (w.idx, w.codes, w.scale, w.zero)]
    table.write(1, trees[0])
    table.write(3, trees[2])
    before = [a.clone() for a in (w.idx, w.codes, w.scale, w.zero)]
    table.write(2, trees[1])
    table.clear(3)
    torch.cuda.synchronize()
    for a, b in zip((w.idx, w.codes, w.scale, w.zero), before):
        assert torch.equal(a[:2], b[:2]) and not a[3].any()
    assert torch.equal(w.codes[2], trees[1]["w"].codes)
    assert [a.data_ptr() for a in (w.idx, w.codes, w.scale, w.zero)] == ptrs


@pytest.mark.gpu
@pytest.mark.parametrize("entry", ["delta_spmm", "delta_spmm_segments",
                                   "delta_spmm_slots", "fused_base_delta", "dequant",
                                   "delta_spmm_experts"])
def test_out_of_envelope_on_the_card_raises(cuda, entry):
    """No plain formulation runs on the card: every entry point refuses a
    packing outside the CUDA kernels' envelope, naming the dimension. The
    kernels take every packing a producer emits (h_g 512 runs, see
    test_wide_packing_every_route); what is left outside is what none
    emits: k_bits above 8 (no packed width holds it) and a stacked delta
    at a single-delta entry point."""
    import dataclasses
    g = torch.Generator().manual_seed(61)
    wide = groupwise_dropout_pack(torch.randn(512, 32, generator=g) * 0.02, h_g=512,
                                  alpha=8.0, generator=g).to(cuda)
    assert ops.envelope_miss(wide) == "h_g" and ops.card_envelope_miss(wide) is None
    d = dataclasses.replace(_pack(512, 32, 16, 8, 4, 61, cuda), k_bits=12)
    assert ops.envelope_miss(d) == ops.card_envelope_miss(d) == "k_bits"
    x = _x(4, 512, 62, cuda)
    stack = stack_tenant_deltas([{"w": d}, {"w": d}])["w"]
    calls = {
        "delta_spmm": lambda: ops.delta_spmm(x, d),
        "delta_spmm_segments": lambda: ops.delta_spmm_segments(
            x, stack, torch.tensor([1], device=cuda), torch.tensor([0, 4], device=cuda)),
        "delta_spmm_slots": lambda: ops.delta_spmm_slots(x[:2, None], stack),
        "fused_base_delta": lambda: ops.fused_base_delta(
            x, torch.zeros(512, 32, device=cuda), d),
        "dequant": lambda: ops.dequant(d),
        "delta_spmm_experts": lambda: ops.delta_spmm_experts(x.reshape(2, 2, 512), stack),
    }
    with pytest.raises(ValueError, match=rf"{entry}: .*envelope \(k_bits\)"):
        calls[entry]()
    if entry in ("delta_spmm", "fused_base_delta", "dequant"):
        wide_stack = stack_tenant_deltas([{"w": wide}, {"w": wide}])["w"]
        single = {"delta_spmm": lambda: ops.delta_spmm(x, wide_stack),
                  "fused_base_delta": lambda: ops.fused_base_delta(
                      x, torch.zeros(512, 32, device=cuda), wide_stack),
                  "dequant": lambda: ops.dequant(wide_stack)}
        with pytest.raises(ValueError, match=rf"{entry}: .*envelope \(stack\)"):
            single[entry]()


@pytest.mark.gpu
@pytest.mark.parametrize("chunked", [False, True])
def test_mixed_codec_engine_equals_alone_on_card(engine_fleet, chunked):
    """tenant1 served as BitDelta beside two DeltaDQ tenants: two codec
    groups, every step one segments call per group and site, and every
    request equal to an engine holding only its tenant."""
    from repro_torch.core.codecs import BitDeltaSpec
    from repro_torch.launch.serve import synth_tenants
    cfg, base, tenants = engine_fleet
    bd = synth_tenants(cfg, base, 1, [BitDeltaSpec()], seed=1)[0]
    fleet = (cfg, base, [tenants[0], ("tenant1",) + bd[1:], tenants[2]])
    kw = dict(chunked_prefill=True, chunk_size=4) if chunked else {}
    eng = _cuda_engine(fleet, **kw)
    assert [g.codecs for g in eng._groups] == [("deltadq",), ("bitdelta",)]
    stream = _cuda_stream(cfg.vocab)
    mixed = _submit_all(eng, stream)
    kern.reset_launches()
    eng.run()
    torch.cuda.synchronize()
    assert kern.LAUNCHES["delta_spmm_segments"] % (2 * 7 * cfg.n_layers) == 0
    for name, d, rep in [(None, None, None)] + fleet[2]:
        alone = _cuda_engine((cfg, base, [] if name is None else [(name, d, rep)]), **kw)
        idx = [i for i, (t, _) in enumerate(stream) if t == name]
        got = _submit_all(alone, stream, idx)
        alone.run()
        for i, r in zip(idx, got):
            np.testing.assert_array_equal(r.output(), mixed[i].output())


@pytest.mark.gpu
def test_resident_values_on_the_card_raise(cuda):
    """The residency tier's values formulation is plain torch: on a CUDA
    tensor ``ops.delta_spmm_segments(values=)`` raises ValueError naming
    ``values`` (no plain version runs on the card); without values the
    kernel runs."""
    from repro_torch.serve import DeltaResidency
    stack = stack_tenant_deltas([_pack(256, 128, 16, 8, 4, s, cuda) for s in range(3)])
    r = DeltaResidency({"w": stack}, 1 << 30)
    rm = r.ensure(np.asarray([1, 2]))
    seg = tenant_segments(np.asarray([1, 2, 2, 1], np.int32)).to(cuda)
    x = _x(4, 256, 3, cuda)[seg.order]
    with pytest.raises(ValueError, match="values"):
        ops.delta_spmm_segments(x, stack, seg.seg_rows, seg.seg_offsets,
                                values=r.values["w"], res_map=torch.as_tensor(rm).to(cuda))
    ops.delta_spmm_segments(x, stack, seg.seg_rows, seg.seg_offsets)


@pytest.mark.gpu
def test_residency_engine_on_the_card_serves_packed(engine_fleet):
    """A residency engine on the card builds and accounts the tier but
    never consults it: every step is a packed step, tokens equal the
    engine without a tier, and a direct ensure() decodes bit-exact
    values into the card's buffers."""
    from repro_torch.core.pack import decode_values
    stream = _cuda_stream(engine_fleet[0].vocab)
    plain = _cuda_engine(engine_fleet)
    want = _submit_all(plain, stream)
    plain.run()
    eng = _cuda_engine(engine_fleet, residency_budget_bytes=1 << 30)
    got = _submit_all(eng, stream)
    eng.run()
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.output(), a.output())
    res = eng.metrics.report()["residency"]
    assert res["enabled"] and res["value_steps"] == 0 and res["hits"] == 0
    assert res["packed_steps"] == eng.metrics.report()["decode_steps"] > 0
    rm = eng.residency.ensure(np.asarray([1, 2, 3]))
    d = eng._groups[0].stacked["attn"]["wq"]
    vals = eng.residency.values["attn"]["wq"]
    for row in (1, 2, 3):
        assert torch.equal(vals[rm[row]], decode_values(d.index(row)))


@pytest.mark.gpu
def test_storage_roundtrip_into_the_kernel(cuda):
    """A packing through to_storage_parts -> from_storage_parts onto the
    card: idx, codes, scale and zero equal the original, so
    ``delta_spmm`` on the reloaded delta equals the original's output bit
    for bit."""
    import dataclasses
    from repro_torch.core.pack import from_storage_parts, to_storage_parts
    d = dataclasses.replace(_pack(512, 256, 16, 8, 4, 4, cuda), m=8)
    d2 = from_storage_parts(to_storage_parts(d), h_in=d.h_in, h_out=d.h_out,
                            h_g=d.h_g, keep=d.keep, alpha=d.alpha, k_bits=d.k_bits,
                            scale=d.scale, zero=d.zero, device=cuda)
    assert d2.device.type == "cuda"
    for f in ("idx", "codes", "scale", "zero"):
        assert torch.equal(getattr(d2, f), getattr(d, f)), f
    for T in (1, 8, 128):
        x = _x(T, 512, 5, cuda)
        assert torch.equal(ops.delta_spmm(x, d2), ops.delta_spmm(x, d))


@pytest.mark.gpu
@pytest.mark.parametrize("C", [1, 10, 64])
def test_expert_route_bits_and_counts(cuda, C):
    """delta_spmm_experts on an expert stack: one segments launch, each
    expert a segment, bit for bit the segments kernel's oracle; with
    per-expert counts (an empty and a full expert among them) every bit as
    the all-C layout; within TOL of the dense formulation."""
    E, h_in, h_out = 16, 256, 96
    stack = stack_tenant_deltas([{"w": _pack(h_in, h_out, 16, 8, 4, 70 + e, cuda)}
                                 for e in range(E)])["w"]
    counts = np.random.default_rng(C).integers(0, C + 1, E)
    counts[:2] = (0, C)
    counts = torch.from_numpy(counts).to(cuda)
    x = _x(E * C, h_in, 71, cuda).reshape(E, C, h_in)
    x[torch.arange(C, device=cuda)[None, :] >= counts[:, None]] = 0.0
    kern.reset_launches()
    full = ops.delta_spmm_experts(x, stack)
    part = ops.delta_spmm_experts(x, stack, counts)
    assert kern.LAUNCHES["delta_spmm_segments"] == 2
    assert torch.equal(full.view(torch.int32), part.view(torch.int32))
    rows, offs = ops.expert_segments(E, C, None, cuda)
    want = ref.segments_kernel_order(x.reshape(-1, h_in), stack, rows, offs)
    assert torch.equal(full.reshape(-1, h_out).view(torch.int32), want.view(torch.int32))
    torch.testing.assert_close(full, torch.matmul(x, reconstruct_dense(stack)), **TOL)


@pytest.mark.gpu
def test_moe_model_on_card_matches_cpu(cuda):
    """The MoE smoke model with a tenant (expert deltas included): logits
    on the card (segments kernel at the expert sites, delta_spmm at
    attention) against the CPU's (dense reconstruction and the plain
    versions), and the expert sites never take a plain formulation."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import RATIO_SPECS, synth_tenants
    from repro_torch.models import lm
    from repro_torch.serve.trace import attribution
    from repro_torch.utils import map_with_paths
    cfg = dataclasses.replace(get_smoke_config("qwen3-moe-30b-a3b"), param_dtype="float32")
    base = lm.init_params(cfg, 0, device="cpu")
    [(_, deltas, _)] = synth_tenants(cfg, base, 1, RATIO_SPECS[128], seed=0)
    to = lambda t: map_with_paths(lambda _p, a: None if a is None else a.to(cuda), t)  # noqa: E731
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, (2, 12)))
    want = lm.forward(cfg, base, {"tokens": toks}, deltas=deltas)
    kern.reset_launches()
    with attribution() as notes:
        got = lm.forward(cfg, to(base), {"tokens": toks.to(cuda)}, deltas=to(deltas))
    assert kern.LAUNCHES["delta_spmm_segments"] == 3 * cfg.n_layers
    forms = {n["formulation"] for n in notes}
    assert "experts-cuda" in forms and not forms & {"experts-torch", "experts-dense",
                                                    "plain-out-of-envelope"}
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


# the model families' linear sites new to the kernels (h_in, h_out): mamba2's
# wdt (32 output columns), wbc and wout; recurrentgemma's linear_x and MQA
# wk; seamless's encoder and cross sites; the vlm's cross wk
FAMILY_SITES = [(1024, 32), (1024, 256), (2048, 1024), (4096, 4096), (4096, 256),
                (1024, 1024), (4096, 1024)]


@pytest.mark.gpu
@pytest.mark.parametrize("T", [2, 8, 128])
@pytest.mark.parametrize("h_in,h_out", FAMILY_SITES)
def test_delta_spmm_at_family_sites(cuda, T, h_in, h_out):
    """delta_spmm at the 128x packing of each new site, on the route ops
    takes: within TOL of the plain version, every row the bits of the
    kernel-order oracle."""
    d = _pack(h_in, h_out, 16, 8, 4, h_out + T, cuda)
    x = _x(T, h_in, T, cuda)
    got = ops.delta_spmm(x, d)
    torch.testing.assert_close(got, fb.correction(x, d), **TOL)
    assert _bits_equal(got, ref.correction_kernel_order(x, d))


@pytest.mark.gpu
@pytest.mark.parametrize("T,h_in,h_out", [(512, 1024, 1024), (3200, 4096, 1024)])
def test_delta_spmm_at_memory_rows(cuda, T, h_in, h_out):
    """The memory-side sites' row counts: seamless's B * 256 encoder
    frames and the vlm's B * 1600 image tokens, on the prefill route."""
    d = _pack(h_in, h_out, 16, 8, 4, 90, cuda)
    x = _x(T, h_in, 91, cuda)
    assert ops.spmm_row_tile(T, d) not in kern.ROW_TILES
    got = ops.delta_spmm(x, d)
    torch.testing.assert_close(got, fb.correction(x, d), **TOL)
    assert _bits_equal(got[:8], ops.delta_spmm(x[:8], d))


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["mixed", "chunk"])
def test_segments_kernel_at_32_columns(cuda, layout):
    """The segments kernel at mamba2's wdt (1024 x 32): the mixed decode
    layout of 8 slots and one 16-row chunk segment, bit for bit."""
    tenants = [_pack(1024, 32, 16, 8, 4, 120 + t, cuda) for t in range(3)]
    stack = stack_tenant_deltas([{"w": t} for t in tenants])["w"]
    if layout == "mixed":
        seg = tenant_segments(np.asarray([0, 1, 2, 1, 0, 2, 2, 1], np.int32)).to(cuda)
        xs = _x(8, 1024, 121, cuda).index_select(0, seg.order)
        rows, offs = seg.seg_rows.to(torch.int32), seg.seg_offsets.to(torch.int32)
    else:
        xs = _x(16, 1024, 122, cuda)
        rows = torch.tensor([1], dtype=torch.int32, device=cuda)
        offs = torch.tensor([0, 16], dtype=torch.int32, device=cuda)
    got = ops.delta_spmm_segments(xs, stack, rows, offs)
    assert _bits_equal(got, ref.segments_kernel_order(xs, stack, rows, offs))
    torch.testing.assert_close(got, fb.segment_correction(xs, stack, rows, offs), **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["mamba2-370m", "recurrentgemma-9b", "seamless-m4t-medium",
                                  "llama-3.2-vision-11b"])
def test_family_model_on_card_matches_cpu(cuda, name):
    """Each new family's smoke model with a tenant: logits on the card
    (delta_spmm at every site) against the CPU's (the plain versions),
    with the frontend inputs of the cross-attention families."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import RATIO_SPECS, synth_tenants
    from repro_torch.models import lm
    from repro_torch.utils import map_with_paths
    cfg = dataclasses.replace(get_smoke_config(name), param_dtype="float32")
    base = lm.init_params(cfg, 0, device="cpu")
    [(_, deltas, _)] = synth_tenants(cfg, base, 1, RATIO_SPECS[128], seed=0)
    to = lambda t: map_with_paths(lambda _p, a: None if a is None else a.to(cuda), t)  # noqa: E731
    rng = np.random.default_rng(4)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16)))}
    if cfg.family == "encdec":
        batch["enc_feats"] = torch.from_numpy(rng.standard_normal((2, 12, cfg.d_model))
                                              .astype(np.float32))
    if cfg.family == "vlm":
        batch["image_embeds"] = torch.from_numpy(
            rng.standard_normal((2, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32))
    want = lm.forward(cfg, base, batch, deltas=deltas)
    kern.reset_launches()
    got = lm.forward(cfg, to(base), {k: v.to(cuda) for k, v in batch.items()},
                     deltas=to(deltas))
    assert kern.LAUNCHES["delta_spmm"] > 0
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# gradients through the correction kernels
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("T", [8, 256])   # the decode and the prefill route forward
def test_correction_backward_matches_native_autograd(cuda, T):
    """ops.delta_spmm under grad at a wizard site (wi 4096 x 11008, 128x
    spec): the kernel forward and the dequant kernel's g @ D^T backward
    against native autograd through the plain correction."""
    d = _pack(4096, 11008, 16, 8, 4, 31, cuda)
    x = _x(T, 4096, 32, cuda).requires_grad_()
    gy = _x(T, 11008, 33, cuda)
    kern.reset_launches()
    y = ops.delta_spmm(x, d)
    got, = torch.autograd.grad(y, x, gy)
    torch.cuda.synchronize()
    assert kern.LAUNCHES["delta_spmm"] == 1 and kern.LAUNCHES["dequant"] == 1
    x2 = x.detach().clone().requires_grad_()
    y2 = fb.correction_nd(x2, d)
    want, = torch.autograd.grad(y2, x2, gy)
    torch.testing.assert_close(y, y2, **TOL)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.gpu
def test_expert_correction_backward_matches_native_autograd(cuda):
    """ops.delta_spmm_experts under grad at a qwen3 expert stack (128
    experts of 2048 x 768) with per-expert counts: each expert's live
    rows get g @ D_e^T (dequantized expert by expert), the rows past its
    count zero, as the forward zero-fills them."""
    E, C = 128, 6
    d = stack_tenant_deltas([{"w": _pack(2048, 768, 16, 8, 4, 40 + e, cuda)}
                             for e in range(E)])["w"]
    counts = torch.from_numpy(np.random.default_rng(5).integers(0, C + 1, E)).to(cuda)
    live = (torch.arange(C, device=cuda)[None, :] < counts[:, None])[..., None]
    x = (torch.randn(E, C, 2048, device=cuda) * live).requires_grad_()
    gy = torch.randn(E, C, 768, device=cuda)
    kern.reset_launches()
    y = ops.delta_spmm_experts(x, d, counts)
    got, = torch.autograd.grad(y, x, gy)
    torch.cuda.synchronize()
    assert kern.LAUNCHES["delta_spmm_segments"] == 1 and kern.LAUNCHES["dequant"] == E
    x2 = x.detach().clone().requires_grad_()
    y2 = x2 @ reconstruct_dense(d)
    want, = torch.autograd.grad(y2, x2, gy)
    torch.testing.assert_close(y, y2 * live, **TOL)
    torch.testing.assert_close(got, want * live, **TOL)
    assert not got[~live.expand_as(got)].any()


@pytest.mark.gpu
def test_routes_without_backward_raise_under_grad(cuda):
    """delta_spmm_segments, delta_spmm_slots and fused_base_delta had no
    backward and raised under grad on the card; they are autograd
    Functions now: under grad they return an output with a grad_fn and
    no error, without grad a plain tensor."""
    tenants = [_pack(256, 128, 16, 8, 4, 50 + t, cuda) for t in range(2)]
    stack = stack_tenant_deltas([{"w": t} for t in tenants])["w"]
    x = _x(4, 256, 51, cuda).requires_grad_()
    rows = torch.tensor([0, 1], dtype=torch.int32, device=cuda)
    offs = torch.tensor([0, 2, 4], dtype=torch.int32, device=cuda)
    w = _x(256, 128, 52, cuda)
    calls = {
        "delta_spmm_segments": lambda: ops.delta_spmm_segments(x, stack, rows, offs),
        "delta_spmm_slots": lambda: ops.delta_spmm_slots(x[:2, None], stack),
        "fused_base_delta": lambda: ops.fused_base_delta(x, w, tenants[0]),
    }
    for name, call in calls.items():
        assert call().grad_fn is not None, name
        with torch.no_grad():
            assert call().grad_fn is None, name


def _route_case(route, device, packing="128x"):
    """(call(x, w), plain(x, w), x, w, n_dequant) for one route at a full
    wizard wi site (4096 x 11008, the 128x spec or, ``wide``,
    DeltaDQSpec()'s row-wise default: h_g = h_in, int32 idx, f32 codes):
    two tenants' segments with rows outside every segment, four one-row
    slots, or the fused kernel with a bf16 base weight that requires
    grad."""
    h_in, h_out = 4096, 11008
    h_g, k = (16, 4) if packing == "128x" else (h_in, None)
    tenants = [_pack(h_in, h_out, h_g, 8, k, 60 + t, device) for t in range(2)]
    stack = stack_tenant_deltas([{"w": t} for t in tenants])["w"]
    if route == "segments":
        rows = torch.tensor([1, 0, -1], dtype=torch.int32, device=device)
        offs = torch.tensor([0, 5, 12, 14], dtype=torch.int32, device=device)
        return (lambda x, w: ops.delta_spmm_segments(x, stack, rows, offs),
                lambda x, w: fb.segment_correction(x, stack, rows, offs),
                _x(16, h_in, 61, device), None, 2)
    if route == "slots":
        slot_stack = stack_tenant_deltas([{"w": tenants[b % 2]} for b in range(4)])["w"]
        x = _x(4, h_in, 62, device).reshape(4, 1, h_in)
        return (lambda x, w: ops.delta_spmm_slots(x, slot_stack),
                lambda x, w: fb.gather_correction_rows(x, slot_stack), x, None, 4)
    w = (_x(h_in, h_out, 63, device) * 0.02).to(torch.bfloat16)
    return (lambda x, w: ops.fused_base_delta(x, w, tenants[0]),
            lambda x, w: x @ (w.float() + fb.dequant(tenants[0])),
            _x(8, h_in, 64, device), w, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("packing", ["128x", "wide"])
@pytest.mark.parametrize("route", ["segments", "slots", "fused"])
def test_route_backward_matches_native_autograd(cuda, route, packing):
    """The three routes' CUDA backward (one dequant kernel a tenant, row
    or merge, and one dense product) against native autograd through
    their plain versions, at the 128x spec and at the row-wise default
    (wide): input gradients, and the fused kernel's weight gradient; rows
    outside every segment get a zero gradient."""
    call, plain, x, w, n_dequant = _route_case(route, cuda, packing)
    x = x.requires_grad_()
    if w is not None:
        w = w.requires_grad_()
    y = call(x, w)
    gy = torch.randn(y.shape, device=cuda)
    kern.reset_launches()
    got = torch.autograd.grad(y, [t for t in (x, w) if t is not None], gy)
    torch.cuda.synchronize()
    assert kern.LAUNCHES["dequant"] == n_dequant
    x2 = x.detach().clone().requires_grad_()
    w2 = None if w is None else w.detach().clone().requires_grad_()
    y2 = plain(x2, w2)
    want = torch.autograd.grad(y2, [t for t in (x2, w2) if t is not None], gy)
    torch.testing.assert_close(y, y2, **TOL)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        # f32 sums in two orders; a bf16 weight gradient may round one
        # spacing apart (2^-8 of a value, at most 2^-7 of the largest)
        rel = 2.0 ** -7 if b.dtype == torch.bfloat16 else 1e-4
        scale = b.float().abs().max()
        torch.testing.assert_close(a.float(), b.float(), atol=rel * scale, rtol=0)
    if route == "segments":
        assert not got[0][12:].any()


# ---------------------------------------------------------------------------
# the autotune table (kernels/autotune.py)
# ---------------------------------------------------------------------------
BUCKET_EDGES = (1, 2, 4, 5, 8, 9, 16, 17, 32, 33, 64, 65, 128, 129, 256, 300)


@pytest.mark.gpu
def test_sweep_point_finds_every_candidate_bit_equal(cuda):
    """The sweep at a small point: every candidate bit-equal to the rule's
    tile (the sweep raises otherwise), a legal fastest tb at every bucket,
    and the segments kernel's fastest decode tile at SEG_T's buckets."""
    from types import SimpleNamespace
    point = (16, 2, 4, 256, 384)
    base, overlays = autotune.sweep_point(*point, seed=3)
    cands = autotune.candidates(16, 2)
    assert 128 in cands and base["sweep_s"] > 0
    assert sorted(overlays) == list(autotune.T_GRID)
    stand_in = SimpleNamespace(h_g=16, keep=2)
    for T, ov in overlays.items():
        assert ov["tb"] in cands and sorted(map(int, ov["ms"])) == sorted(cands)
        assert ov["ms"][str(ov["tb"])] == min(ov["ms"].values())
        assert ov["rule_tb"] == ops.rule_spmm_tile(T, stand_in)
        assert ("seg_tb" in ov) == (T in autotune.SEG_T)
        if T in autotune.SEG_T:
            assert sorted(map(int, ov["seg_ms"])) == list(kern.ROW_TILES)
            assert ov["seg_ms"][str(ov["seg_tb"])] == min(ov["seg_ms"].values())


@pytest.mark.gpu
@pytest.mark.parametrize("point", autotune.DEFAULT_POINTS)
def test_committed_table_keeps_every_bit(cuda, monkeypatch, tmp_path, point):
    """At each committed point, ops.delta_spmm and the segments kernel
    give the same bits with the committed table as by the rules, at both
    edges of every bucket (the table is applied where it names this card)."""
    monkeypatch.delenv(autotune.TABLE_ENV, raising=False)
    autotune.invalidate_cache()
    gen = torch.Generator(device=cuda)
    gen.manual_seed(5)
    tenants = [autotune.pack_point(*point, generator=gen) for _ in range(2)]
    d, stack = tenants[0], stack_tenant_deltas([{"w": t} for t in tenants])["w"]
    x = torch.randn((BUCKET_EDGES[-1], d.h_in), generator=gen, device=cuda)

    def run():
        out = []
        for T in BUCKET_EDGES:
            offs = torch.tensor([0, T // 2, T], dtype=torch.int32, device=cuda)
            rows = torch.tensor([1, 0], dtype=torch.int32, device=cuda)
            out.append((ops.delta_spmm(x[:T], d),
                        ops.delta_spmm_segments(x[:T], stack, rows, offs)))
        return out

    applies = autotune.load_table().get("device") == autotune.card_name()
    tiles = [ops.spmm_tile(T, d) for T in BUCKET_EDGES]
    assert all(src == ("table" if applies else "rule") for _, src in tiles)
    with_table = run()
    monkeypatch.setenv(autotune.TABLE_ENV, str(tmp_path / "absent.json"))
    autotune.invalidate_cache()
    assert all(src == "rule" for _, src in (ops.spmm_tile(T, d) for T in BUCKET_EDGES))
    by_rule = run()
    autotune.invalidate_cache()
    for T, (a, b) in zip(BUCKET_EDGES, zip(with_table, by_rule)):
        assert _bits_equal(a[0], b[0]) and _bits_equal(a[1], b[1]), T
