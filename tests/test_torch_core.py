"""The port's packed format against the JAX reference: quant, pack,
dropout and compress.

Integer results (codes, indices, bit packing, report bits) must match
EXACTLY. Inputs are made from numpy seeds and handed to both packages;
dropout keys are the reference's own ``jax.random.uniform`` draws.
"""
import dataclasses
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config  # noqa: E402
from repro.core import DeltaDQSpec as JSpec  # noqa: E402
from repro.core import compress as jcompress  # noqa: E402
from repro.core import dropout as jdropout  # noqa: E402
from repro.core import pack as jpack  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.core.codecs import _pick_hg as j_pick_hg  # noqa: E402
from repro.models import lm as jlm  # noqa: E402

from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.core import codecs as tcodecs  # noqa: E402
from repro_torch.core.compress import compress as t_compress  # noqa: E402
from repro_torch.core.compress import compress_leaf_layerwise  # noqa: E402
from repro_torch.core import dropout as tdropout  # noqa: E402
from repro_torch.core import pack as tpack  # noqa: E402
from repro_torch.core import quant as tquant  # noqa: E402

import torch_bridge as br  # noqa: E402


def _np(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# quant
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k_bits", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("axis", [0, 1])
def test_pack_unpack_matches_reference(k_bits, axis):
    rng = np.random.default_rng(k_bits * 10 + axis)
    q = rng.integers(0, 2**k_bits, size=(13, 6, 5)).astype(np.int32)
    w = tquant.pack_width(k_bits)
    assert w == jquant.pack_width(k_bits)
    assert tquant.packed_len(13, k_bits) == jquant.packed_len(13, k_bits)
    got = tquant.pack_bits(torch.from_numpy(q), w, axis=axis)
    want = np.asarray(jquant.pack_bits(jnp.asarray(q), w, axis=axis))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(_np(got), want)
    n = q.shape[axis]
    back = tquant.unpack_bits(got, w, n, axis=axis)
    np.testing.assert_array_equal(
        _np(back), np.asarray(jquant.unpack_bits(jnp.asarray(want), w, n, axis=axis)))
    np.testing.assert_array_equal(_np(back), q)


@pytest.mark.parametrize("k_bits,lead", [(4, 0), (8, 0), (2, 1), (3, 1)])
def test_quantize_matches_reference(k_bits, lead):
    rng = np.random.default_rng(k_bits)
    shape = (3, 16, 24) if lead else (16, 24)
    x = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    q, qp = tquant.quantize(torch.from_numpy(x), k_bits, lead_dims=lead)
    jq, jqp = jquant.quantize(jnp.asarray(x), k_bits, lead_dims=lead)
    np.testing.assert_array_equal(_np(q), np.asarray(jq))
    np.testing.assert_array_equal(_np(qp.scale), np.asarray(jqp.scale))
    np.testing.assert_array_equal(_np(qp.zero), np.asarray(jqp.zero))
    if not lead:   # dequantize takes per-tensor (unstacked) params
        np.testing.assert_array_equal(
            _np(tquant.dequantize(q, qp)), np.asarray(jquant.dequantize(jq, jqp)))


@pytest.mark.parametrize("k_bits,m", [(4, 1), (4, 8), (3, 2), (8, 16)])
def test_separate_quantization_parts_match(k_bits, m):
    q = np.arange(2**k_bits, dtype=np.int32)
    pid, low = tquant.decompose(torch.from_numpy(q), k_bits, m)
    jpid, jlow = jquant.decompose(jnp.asarray(q), k_bits, m)
    np.testing.assert_array_equal(_np(pid), np.asarray(jpid))
    np.testing.assert_array_equal(_np(low), np.asarray(jlow))
    np.testing.assert_array_equal(_np(tquant.recompose(pid, low, k_bits, m)), q)
    assert tquant.storage_bits_per_value(k_bits, m) == \
        jquant.storage_bits_per_value(k_bits, m)
    for alpha in (2.0, 8.0):
        assert tquant.compression_ratio(alpha, k_bits, m) == \
            jquant.compression_ratio(alpha, k_bits, m)
    assert tquant.compression_ratio(8.0, None) == jquant.compression_ratio(8.0, None)


# ---------------------------------------------------------------------------
# dropout + pack
# ---------------------------------------------------------------------------
DROPOUT_CASES = [
    # (shape, h_g, alpha, k_bits, m)
    ((128, 64), 16, 8.0, 4, 8),
    ((256, 96), 64, 4.0, 8, 1),
    ((64, 32), 16, 2.0, 2, 1),
    ((64, 48), 32, 8.0, 3, 1),        # odd k: packed at width 4
    ((128, 40), 128, 8.0, None, 1),   # dropout only (raw f32 values)
    ((2, 64, 32), 16, 8.0, 4, 8),     # layer-stacked leaf
]


@pytest.mark.parametrize("shape,h_g,alpha,k_bits,m", DROPOUT_CASES)
def test_groupwise_dropout_pack_exact_with_reference_keys(shape, h_g, alpha, k_bits, m):
    seed = sum(shape) + h_g
    delta = (np.random.default_rng(seed).standard_normal(shape) * 0.02).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    want = jdropout.groupwise_dropout_pack(key, jnp.asarray(delta), h_g=h_g,
                                           alpha=alpha, k_bits=k_bits, m=m)
    h_in, h_out = shape[-2:]
    grouped = (*shape[:-2], h_in // h_g, h_g, h_out)
    u = np.array(jax.random.uniform(key, grouped))   # the reference's own draw
    got = tdropout.groupwise_dropout_pack(torch.from_numpy(delta), h_g=h_g,
                                          alpha=alpha, k_bits=k_bits, m=m,
                                          u=torch.from_numpy(u))
    assert got.keep == want.keep == tdropout.keep_count(h_g, alpha)
    assert got.idx.dtype == torch.uint8
    for f in ("idx", "codes", "scale", "zero"):
        np.testing.assert_array_equal(_np(getattr(got, f)),
                                      np.asarray(getattr(want, f)), err_msg=f)
    np.testing.assert_array_equal(_np(tpack.decode_values(got)),
                                  np.asarray(jpack.decode_values(want)))
    np.testing.assert_array_equal(_np(tpack.reconstruct_dense(got)),
                                  np.asarray(jpack.reconstruct_dense(want)))
    assert got.nnz == want.nnz and got.stack_shape() == want.stack_shape()
    assert got.value_bits() == want.value_bits()
    assert got.index_bits() == want.index_bits()
    assert got.total_bits() == want.total_bits()


def test_dropout_stable_argsort_keeps_lowest_index_on_ties():
    """Tied keys must select by position, as jnp's stable argsort does."""
    delta = torch.arange(32, dtype=torch.float32).reshape(32, 1)
    u = torch.full((2, 16, 1), 0.5)
    p = tdropout.groupwise_dropout_pack(delta, h_g=16, alpha=8.0, u=u)
    np.testing.assert_array_equal(_np(p.idx)[:, :, 0], [[0, 1], [0, 1]])


def test_dropout_generator_draws_are_reproducible():
    delta = torch.randn(64, 32, generator=torch.Generator().manual_seed(0))

    def pack(seed):
        g = torch.Generator().manual_seed(seed)
        return tdropout.groupwise_dropout_pack(delta, h_g=16, alpha=8.0,
                                               k_bits=4, m=8, generator=g)
    a, b = pack(3), pack(3)
    assert torch.equal(a.idx, b.idx) and torch.equal(a.codes, b.codes)
    assert not torch.equal(a.idx, pack(4).idx)


@pytest.mark.parametrize("h_in,h_g,alpha", [(64, 16, 8.0), (192, 128, 8.0),
                                            (48, 64, 4.0), (4096, 16, 8.0)])
def test_pick_hg_matches_reference(h_in, h_g, alpha):
    assert tcodecs._pick_hg(h_in, tcodecs.DeltaDQSpec(alpha=alpha, h_g=h_g)) == \
        j_pick_hg(h_in, JSpec(alpha=alpha, h_g=h_g))


# ---------------------------------------------------------------------------
# compress
# ---------------------------------------------------------------------------
def _smoke_pair(name="wizard-llama2-7b"):
    cfg = get_smoke_config(name)
    base = jlm.init_params(cfg, jax.random.PRNGKey(0))
    ft = jax.tree.map(
        lambda p: p + 0.02 * jax.random.normal(jax.random.PRNGKey(1), p.shape,
                                               jnp.float32).astype(p.dtype)
        if p.ndim >= 2 else p, base)
    return cfg, base, ft


@pytest.mark.parametrize("spec", [
    dict(alpha=8.0, k_bits=4, m=8, h_g=16),
    dict(alpha=8.0, k_bits=None, h_g=16),
    dict(alpha=4.0, k_bits=8, m=1, h_g=32),
])
def test_compress_report_matches_reference(spec):
    _, base, ft = _smoke_pair()
    jd, jrep = jcompress(base, ft, JSpec(**spec))
    td, trep = t_compress(br.params_to_port(base), br.params_to_port(ft),
                                  tcodecs.DeltaDQSpec(**spec))
    for f in ("n_compressed", "n_dense", "dense_delta_bits", "packed_value_bits",
              "packed_total_bits", "ratio_paper", "ratio_honest"):
        assert getattr(trep, f) == getattr(jrep, f), f
    assert sorted(trep.skipped_paths) == sorted(jrep.skipped_paths)
    assert trep.leaf_codecs == jrep.leaf_codecs
    # the deltas trees mirror params with the same leaves compressed
    tflat = br.flatten_with_paths(
        jd, is_leaf=lambda x: x is None or isinstance(x, br.JaxPackedDelta))
    for path, leaf in tflat.items():
        node = td
        for k in path.split("/"):
            node = node[k]
        assert (node is None) == (leaf is None), path
        if leaf is not None:
            assert tuple(node.idx.shape) == tuple(leaf.idx.shape)
            assert tuple(node.codes.shape) == tuple(leaf.codes.shape)


def test_compress_layerwise_exact_with_reference_keys():
    """A layer-stacked leaf compressed one slice at a time equals the
    reference's whole-leaf compression given the reference's keys."""
    cfg, base, ft = _smoke_pair()
    spec = JSpec(alpha=8.0, k_bits=4, m=8, h_g=16)
    jd, _ = jcompress(base, ft, spec)
    path = "mlp/wo"
    leaf_key = jax.random.fold_in(jax.random.PRNGKey(spec.seed),
                                  zlib.crc32(path.encode()) & 0x7FFFFFFF)
    b, f = base["mlp"]["wo"], ft["mlp"]["wo"]
    h_in, h_out = b.shape[-2:]
    u = np.array(jax.random.uniform(
        leaf_key, (b.shape[0], h_in // 16, 16, h_out)))
    tb_, tf_ = br.params_to_port({"b": b, "f": f}).values()
    got = compress_leaf_layerwise(
        tcodecs.DeltaDQCodec(), tcodecs.DeltaDQSpec(**dataclasses.asdict(spec)),
        tb_, lambda i: tf_[i], u_slice=lambda i: torch.from_numpy(u[i]))
    want = jd["mlp"]["wo"]
    for fld in ("idx", "codes", "scale", "zero"):
        np.testing.assert_array_equal(_np(getattr(got, fld)),
                                      np.asarray(getattr(want, fld)), err_msg=fld)


def test_port_configs_match_reference():
    for name in ("wizard-llama2-7b", "llama3.2-1b"):
        assert dataclasses.asdict(t_smoke(name)) == \
            dataclasses.asdict(get_smoke_config(name))
    from repro.configs import get_config
    from repro_torch.configs import get_config as t_get
    full = t_get("wizard-llama2-7b")
    assert dataclasses.asdict(full) == dataclasses.asdict(get_config("wizard-llama2-7b"))
    assert full.n_params() == get_config("wizard-llama2-7b").n_params()
