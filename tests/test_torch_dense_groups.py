"""The dense-group walk's plain twins and predicate against the kernels'
oracles and the JAX reference.

The codecs lower BitDelta and LowRank leaves to keep-everything packings
(keep = h_g, ``idx = arange(h_g)`` in every group and column); on the
card the correction kernels' decode tiles take a dense-group walk for
them that reads no idx (``kernels/csrc/dense.cuh``). Here, on the CPU:

- the walk's plain twins (``kernels/ref.py::dense_groups_kernel_order``,
  ``dense_segments_kernel_order``), which read ``x[:, g*h_g + k]`` and
  never idx, equal the kernels' oracles (``correction_kernel_order``,
  ``segments_kernel_order``, which read idx) bit for bit on the port's
  lowerings, and match the JAX package's ``delta_spmm`` /
  ``delta_spmm_segments`` (Pallas in interpret mode, as its own tests run
  it) on the JAX lowering of the same leaf at atol = rtol = 1e-4
  (``tests/test_kernels.py:44``: the two sum in different orders);
- the predicate (``core.pack.dense_groups``) holds for both lowerings per
  matrix, stacked, on a layer slice and on a mesh column slice, and for
  no packing the DeltaDQ compressor emits;
- the invariant the walk rests on: every lowering's idx is arange.

Inputs come from numpy seeds; the JAX leaves cross over through numpy
(``torch_bridge``). The card's side is ``tests/test_torch_cuda.py``.
"""
import ast
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import BitDeltaSpec as JBitDeltaSpec  # noqa: E402
from repro.core import LowRankSpec as JLowRankSpec  # noqa: E402
from repro.core import codecs as jc  # noqa: E402
from repro.core.apply import stack_tenant_deltas as j_stack  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402

from repro_torch.core import codecs as tc  # noqa: E402
from repro_torch.core import pack as tpack  # noqa: E402
from repro_torch.core.apply import stack_tenant_deltas, zero_delta_like  # noqa: E402
from repro_torch.core.compress import compress_leaf_layerwise  # noqa: E402
from repro_torch.core.dropout import groupwise_dropout_pack  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.serve.scheduler import tenant_segments  # noqa: E402

import torch_bridge as br  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
SPECS = {"bitdelta": (JBitDeltaSpec(), tc.BitDeltaSpec()),
         "lowrank": (JLowRankSpec(rank=4), tc.LowRankSpec(rank=4))}
# (h_in, h_out): eight groups of 128 (every class chain holds one), and
# h_in 200, whose lowering's group size is 100 (two groups)
SHAPES = [(1024, 40), (200, 24)]
_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src",
                    "repro_torch")


def _pair(shape, seed):
    rng = np.random.default_rng(seed)
    b = rng.standard_normal(shape).astype(np.float32)
    return b, (b + 0.02 * rng.standard_normal(shape)).astype(np.float32)


def _jax_leaf(name, shape, seed=0):
    b, f = _pair(shape, seed)
    return jc.get_codec(name).compress_leaf(jax.random.PRNGKey(seed), jnp.asarray(b),
                                            jnp.asarray(f), SPECS[name][0])


def _lowerings(name, shape, seed=0):
    """(the JAX lowering, the port's lowering) of one leaf: the JAX leaf
    carried across exactly, each package lowering its own."""
    jl = _jax_leaf(name, shape, seed)
    return jc.get_codec(name).runtime_packed(jl), \
        tc.get_codec(name).runtime_packed(br.leaf_to_port(jl))


def _port_lowering(name, shape, seed=0):
    b, f = _pair(shape, seed)
    c = tc.get_codec(name)
    return c.runtime_packed(c.compress_leaf(torch.from_numpy(b), torch.from_numpy(f),
                                            SPECS[name][1]))


def _x(T, h_in, seed):
    return np.random.default_rng(seed).standard_normal((T, h_in)).astype(np.float32)


def _bits_equal(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def _layout(T, n):
    """T rows over tenant rows 0 .. n - 1 in turn, sorted by tenant:
    (order, seg_rows, seg_offsets)."""
    seg = tenant_segments((np.arange(T) % n).astype(np.int32)).to("cpu")
    return seg.order, seg.seg_rows, seg.seg_offsets


# ---------------------------------------------------------------------------
# the twins against the kernels' oracles, bit for bit
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("T", [1, 2, 8, 37])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_twins_equal_the_kernels_oracles(name, T, shape):
    d = _port_lowering(name, shape)
    assert tpack.dense_groups(d) and d.h_g == tc._runtime_hg(shape[0])
    x = torch.from_numpy(_x(T, shape[0], 1))
    assert _bits_equal(ref.dense_groups_kernel_order(x, d), ref.correction_kernel_order(x, d))
    other = _port_lowering(name, shape, seed=7)
    stack = stack_tenant_deltas([zero_delta_like({"w": d}), {"w": d}, {"w": other}])["w"]
    order, seg_rows, seg_offsets = _layout(T, 3)
    xs = x.index_select(0, order)
    got = ref.dense_segments_kernel_order(xs, stack, seg_rows, seg_offsets)
    assert _bits_equal(got, ref.segments_kernel_order(xs, stack, seg_rows, seg_offsets))


def test_twins_refuse_other_packings():
    d = groupwise_dropout_pack(torch.zeros(64, 8), h_g=16, alpha=1.0, k_bits=4,
                               generator=torch.Generator().manual_seed(0))
    x = torch.zeros(2, 64)
    with pytest.raises(ValueError, match="dense-group"):
        ref.dense_groups_kernel_order(x, d)
    stack = stack_tenant_deltas([{"w": d}])["w"]
    with pytest.raises(ValueError, match="dense-group"):
        ref.dense_segments_kernel_order(x, stack, torch.tensor([0], dtype=torch.int32),
                                        torch.tensor([0, 2], dtype=torch.int32))


# ---------------------------------------------------------------------------
# the twins against the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", sorted(SPECS))
def test_twins_match_the_reference_kernels(name, shape):
    jd, td = _lowerings(name, shape)
    assert td.codec == jd.codec == name and tpack.dense_groups(td)
    x = _x(8, shape[0], 2)
    want = np.asarray(jops.delta_spmm(jnp.asarray(x), jd, interpret=True))
    np.testing.assert_allclose(ref.dense_groups_kernel_order(torch.from_numpy(x), td).numpy(),
                               want, **TOL)
    jd2, td2 = _lowerings(name, shape, seed=3)
    jstack = j_stack([{"w": jd}, {"w": jd2}])["w"]
    tstack = stack_tenant_deltas([{"w": td}, {"w": td2}])["w"]
    order, seg_rows, seg_offsets = _layout(8, 2)
    xs = x[order.numpy()]
    want = np.asarray(jops.delta_spmm_segments(
        jnp.asarray(xs), jstack, jnp.asarray(seg_rows.numpy()), jnp.asarray(seg_offsets.numpy()),
        interpret=True))
    got = ref.dense_segments_kernel_order(torch.from_numpy(xs), tstack, seg_rows, seg_offsets)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# ---------------------------------------------------------------------------
# the predicate and the invariant it rests on
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(SPECS))
def test_predicate_and_arange_idx_on_every_form_of_a_lowering(name):
    """Per matrix, stacked (tenants, and a [L] leaf compressed layer by
    layer), a layer slice (of the [L] leaf and of an [R, L] tenant stack)
    and a mesh column slice: the predicate holds and idx is arange in
    every group and column."""
    shape = (256, 48)
    d = _port_lowering(name, shape)
    b, f = _pair((3, *shape), 5)
    ft = torch.from_numpy(f)
    layered = tc.get_codec(name).runtime_packed(compress_leaf_layerwise(
        tc.get_codec(name), SPECS[name][1], torch.from_numpy(b), lambda i: ft[i]))
    tenants = stack_tenant_deltas([{"w": d}, {"w": _port_lowering(name, shape, 9)}])["w"]
    table = stack_tenant_deltas([{"w": layered}, {"w": layered}])["w"]   # [R, L, ...]
    forms = {"matrix": d, "tenants": tenants, "layers": layered,
             "layer slice": layered.index(1),
             "table layer slice": table.with_arrays(table.idx[:, 1], table.codes[:, 1],
                                                    table.scale[:, 1], table.zero[:, 1])}
    for m in range(2):
        view = mesh_lib.ServingMesh.view(model=2, model_index=m)
        forms[f"column slice {m}"] = mesh_lib.shard_delta(d, view)
        forms[f"stacked column slice {m}"] = mesh_lib.shard_delta(tenants, view)
    assert forms["column slice 1"].shards == 2
    for what, form in forms.items():
        assert form.codec == name and tpack.dense_groups(form), what
        want = torch.arange(form.h_g, dtype=form.idx.dtype)[:, None]
        for idx in form.idx.reshape(-1, form.h_g, form.h_out):
            assert bool((idx == want).all()), what


@pytest.mark.parametrize("h_in", [1376, 200, 256])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_lowerings_are_contiguous_at_every_group_size(name, h_in):
    """The kernels take contiguous tiles only: a lowering's idx and codes
    are contiguous also where the group size (86 at h_in 1376) is no
    multiple of the codes a byte holds."""
    d = _port_lowering(name, (h_in, 24))
    assert d.h_g == tc._runtime_hg(h_in)
    assert d.idx.is_contiguous() and d.codes.is_contiguous()


@pytest.mark.parametrize("kw", [
    dict(h_g=16, alpha=8.0, k_bits=4),          # the 128x spec
    dict(h_g=1024, alpha=8.0, k_bits=4),        # [envelope]'s h_g 1024 packing
    dict(h_g=2048, alpha=8.0, k_bits=None),     # DeltaDQSpec()'s row-wise default
    dict(h_g=128, alpha=1.0, k_bits=2),         # keep = h_g, a lowering's shape
    dict(h_g=128, alpha=1.0, k_bits=None),
])
def test_predicate_false_for_deltadq_packings(kw):
    """Every packing of the DeltaDQ packer is outside the walk, alpha 1
    (keep = h_g, a lowering's very shape) included: its idx is whatever
    the packer wrote, here permuted."""
    g = torch.Generator().manual_seed(0)
    d = groupwise_dropout_pack(torch.randn(2048, 16, generator=g) * 0.01, generator=g, **kw)
    assert d.codec == "deltadq" and not tpack.dense_groups(d)
    if d.keep == d.h_g:
        perm = d.with_arrays(d.idx.flip(-2).contiguous(), d.codes, d.scale, d.zero)
        assert not tpack.dense_groups(perm)
    assert not tpack.dense_groups(stack_tenant_deltas([{"w": d}, {"w": d}])["w"])


def test_only_the_lowerings_set_a_codec_label():
    """``codec`` other than "deltadq" comes from the codecs' lowering
    (``core/codecs.py::_dense_as_structured``) or from a stored packing's
    own meta (``convert.packed_delta_from_numpy``), and no other call in
    the port sets it (``PackedDelta(...)`` or ``replace(...)``)."""
    found = []
    for root, _, files in os.walk(_SRC):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            tree = ast.parse(open(path).read())
            for fn in ast.walk(tree):
                if not isinstance(fn, ast.FunctionDef):
                    continue
                for call in ast.walk(fn):
                    if isinstance(call, ast.Call) and \
                            any(k.arg == "codec" for k in call.keywords):
                        callee = call.func.attr if isinstance(call.func, ast.Attribute) \
                            else getattr(call.func, "id", "")
                        if callee in ("PackedDelta", "replace"):
                            found.append((os.path.relpath(path, _SRC), fn.name))
    assert sorted(set(found)) == [("convert.py", "packed_delta_from_numpy"),
                                  ("core/codecs.py", "_dense_as_structured")]
