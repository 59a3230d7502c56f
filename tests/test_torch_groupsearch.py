"""The port's compression-side tools against the JAX reference: the
group-size search (``core.groupsearch``, paper §3.3 / Table 4), the
baselines (``core.baselines``, §4.1) and the dropout baselines
(``core.dropout.rowwise_dropout_pack``/``bernoulli_dropout_dense``).

Twins of ``tests/test_groupsearch.py``, ``tests/test_baselines.py`` and
``tests/test_core_dropout.py``. Every random draw is the reference's own
(``jax.random.uniform`` / ``bernoulli`` of its keys) handed to the port,
so masks, packings and h_g* must be EQUAL; the proxy errors and the
quantized baselines are f32 sums and match within 1e-4 relative.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import DeltaDQSpec as JSpec  # noqa: E402
from repro.core import baselines as jbase  # noqa: E402
from repro.core import dropout as jdropout  # noqa: E402
from repro.core import groupsearch as jgs  # noqa: E402

from repro_torch.core import DeltaDQSpec, baselines  # noqa: E402
from repro_torch.core import dropout as tdropout  # noqa: E402
from repro_torch.core import groupsearch as tgs  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)   # f32: the frameworks sum in other orders


def _np(t):
    return t.detach().cpu().numpy()


def _t(a):
    return torch.from_numpy(np.array(a))


def _spec(jspec):
    return DeltaDQSpec(**dataclasses.asdict(jspec))


# ---------------------------------------------------------------------------
# Group-size search
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("h_in,alpha", [(256, 8), (96, 4), (4096, 8), (5120, 8),
                                        (1152, 8), (11008, 8), (7, 8)])
def test_candidates_match_reference(h_in, alpha):
    got = tgs.candidate_group_sizes(h_in, alpha)
    assert got == jgs.candidate_group_sizes(h_in, alpha)
    assert all(h_in % c == 0 for c in got) and got[-1] == h_in


def _weights(seed, d_model, q_dim, kv_dim, scale=0.01):
    rng = jax.random.PRNGKey(seed)
    wq_b = jax.random.normal(rng, (d_model, q_dim)) * 0.1
    wk_b = jax.random.normal(jax.random.fold_in(rng, 1), (d_model, kv_dim)) * 0.1
    wq_f = wq_b + jax.random.normal(jax.random.fold_in(rng, 2), wq_b.shape) * scale
    wk_f = wk_b + jax.random.normal(jax.random.fold_in(rng, 3), wk_b.shape) * scale
    x = jax.random.normal(jax.random.fold_in(rng, 4), (16, d_model))
    return x, wq_b, wk_b, wq_f, wk_f


def _keys(rng, hg, d_model, q_dim, kv_dim):
    """The uniform keys the reference's ``attention_proxy_error`` draws
    from ``rng`` at ``hg``: split, then one uniform per packing."""
    r1, r2 = jax.random.split(rng)
    G = d_model // hg
    return (_t(jax.random.uniform(r1, (G, hg, q_dim))),
            _t(jax.random.uniform(r2, (G, hg, kv_dim))))


@pytest.mark.parametrize("q_dim,kv_dim,head_dim", [(64, 64, None), (64, 32, None),
                                                   (64, 32, 16)])
@pytest.mark.parametrize("hg", [4, 32, 512])
def test_attention_proxy_error_matches_reference(q_dim, kv_dim, head_dim, hg):
    """Same keys: equal packings, so the error is equal within 1e-4 (f32)
    — h_g = 512 = h_in takes int32 idx (above 256), outside the kernels'
    envelope, on the plain reconstruction; GQA scores per head."""
    d_model = 512
    x, wq_b, wk_b, wq_f, wk_f = _weights(1, d_model, q_dim, kv_dim)
    jspec = JSpec(alpha=4.0, k_bits=4, m=2)
    rng = jax.random.PRNGKey(11)
    want = float(jgs.attention_proxy_error(x, wq_b, wk_b, wq_f, wk_f, hg, jspec, rng,
                                           head_dim=head_dim))
    got = tgs.attention_proxy_error(*map(_t, (x, wq_b, wk_b, wq_f, wk_f)), hg,
                                    _spec(jspec), keys=_keys(rng, hg, d_model, q_dim,
                                                             kv_dim),
                                    head_dim=head_dim)
    assert got.dtype == torch.float32 and got.ndim == 0
    np.testing.assert_allclose(float(got), want, **TOL)


@pytest.mark.parametrize("k_bits", [None, 4])
def test_search_proxy_matches_reference(k_bits):
    """The reference's per-candidate keys (``fold_in(PRNGKey(seed), h_g)``
    then split) handed over: h_g* equal, every error within 1e-4."""
    d_model = 128
    x, wq_b, wk_b, wq_f, wk_f = _weights(0, d_model, 64, 64)
    jspec = JSpec(alpha=4.0, k_bits=k_bits, m=1, seed=3)
    want = jgs.search_proxy(x, wq_b, wk_b, wq_f, wk_f, jspec)
    root = jax.random.PRNGKey(jspec.seed)
    keys = {hg: _keys(jax.random.fold_in(root, hg), hg, d_model, 64, 64)
            for hg in jgs.candidate_group_sizes(d_model, jspec.alpha)}
    got = tgs.search_proxy(*map(_t, (x, wq_b, wk_b, wq_f, wk_f)), _spec(jspec),
                           keys=keys)
    assert got.method == want.method == "proxy"
    assert got.h_g_star == want.h_g_star
    assert sorted(got.errors) == sorted(want.errors)
    for hg in want.errors:
        np.testing.assert_allclose(got.errors[hg], want.errors[hg], **TOL)
    assert got.seconds > 0


def test_search_proxy_draws_from_a_generator():
    """Without keys each candidate draws from the generator (seeded from
    ``spec.seed`` by default): reproducible, and h_g* is the argmin."""
    x, wq_b, wk_b, wq_f, wk_f = map(_t, _weights(0, 128, 64, 64))
    spec = DeltaDQSpec(alpha=4.0, k_bits=None, seed=5)
    a = tgs.search_proxy(x, wq_b, wk_b, wq_f, wk_f, spec)
    b = tgs.search_proxy(x, wq_b, wk_b, wq_f, wk_f, spec)
    assert a.errors == b.errors
    assert a.h_g_star in tgs.candidate_group_sizes(128, 4)
    assert a.errors[a.h_g_star] == min(a.errors.values())
    g = torch.Generator().manual_seed(9)
    c = tgs.search_proxy(x, wq_b, wk_b, wq_f, wk_f, spec, generator=g,
                         candidates=[8, 32])
    assert sorted(c.errors) == [8, 32]


def test_direct_search_api():
    scores = {4: 3.0, 8: 1.0, 16: 2.0, 32: 5.0, 64: 6.0, 128: 7.0}
    got = tgs.search_direct(lambda hg: scores[hg], 128, DeltaDQSpec(alpha=4.0))
    want = jgs.search_direct(lambda hg: scores[hg], 128, JSpec(alpha=4.0))
    assert got.h_g_star == want.h_g_star == 8
    assert got.errors == want.errors and got.method == "direct"


def test_proxy_agrees_with_direct_on_layer_error():
    """When the direct objective IS the attention error (same keys), both
    selectors pick the same h_g."""
    d_model = 64
    x, wq_b, wk_b, wq_f, wk_f = map(_t, _weights(7, d_model, 32, 32, scale=0.02))
    spec = DeltaDQSpec(alpha=4.0, seed=0)
    g = torch.Generator().manual_seed(0)
    keys = {hg: (torch.rand((d_model // hg, hg, 32), generator=g),
                 torch.rand((d_model // hg, hg, 32), generator=g))
            for hg in tgs.candidate_group_sizes(d_model, 4)}
    proxy = tgs.search_proxy(x, wq_b, wk_b, wq_f, wk_f, spec, keys=keys)
    direct = tgs.search_direct(
        lambda hg: float(tgs.attention_proxy_error(x, wq_b, wk_b, wq_f, wk_f, hg, spec,
                                                   keys=keys[hg])),
        d_model, spec)
    assert proxy.h_g_star == direct.h_g_star
    assert proxy.errors == direct.errors


# ---------------------------------------------------------------------------
# Baselines (§4.1)
# ---------------------------------------------------------------------------
@pytest.fixture
def delta():
    return jax.random.normal(jax.random.PRNGKey(0), (256, 64)) * 0.01


@pytest.mark.parametrize("alpha", [2, 8, 16])
def test_magnitude_matches_reference(delta, alpha):
    got = _np(baselines.magnitude(_t(delta), alpha=alpha))
    np.testing.assert_array_equal(got, np.asarray(jbase.magnitude(None, delta, alpha=alpha)))
    assert abs(float((got != 0).mean()) - 1 / alpha) < 0.01
    kept_min = np.abs(got[got != 0]).min()
    assert kept_min >= np.abs(np.asarray(delta)[got == 0]).max()


def test_magnitude_keeps_ties_with_the_threshold():
    """The reference's tie rule: every entry ``>=`` the keep-th largest
    magnitude survives, so ties at the threshold keep more than n/alpha."""
    d = jnp.asarray(np.array([[3.0, -2.0], [2.0, 1.0]], np.float32))
    got = _np(baselines.magnitude(_t(d), alpha=4))      # keep = 1 -> thresh 3
    np.testing.assert_array_equal(got, np.asarray(jbase.magnitude(None, d, alpha=4)))
    got = _np(baselines.magnitude(_t(d), alpha=2))      # keep = 2 -> thresh 2: a tie
    np.testing.assert_array_equal(got, np.asarray(jbase.magnitude(None, d, alpha=2)))
    assert (got != 0).sum() == 3


@pytest.mark.parametrize("alpha", [2, 4, 8])
def test_dare_matches_reference_given_its_mask(delta, alpha):
    """The reference's Bernoulli mask handed over (``mask=``), or the
    uniform keys it is drawn from (``u=``): equal output; survivors
    rescaled by 1/keep-rate."""
    key = jax.random.PRNGKey(alpha)
    want = np.asarray(jbase.dare(key, delta, alpha=alpha))
    mask = _t(jax.random.bernoulli(key, 1.0 / alpha, delta.shape))
    np.testing.assert_array_equal(_np(baselines.dare(_t(delta), alpha=alpha, mask=mask)),
                                  want)
    u = _t(jax.random.uniform(key, delta.shape))
    np.testing.assert_array_equal(_np(baselines.dare(_t(delta), alpha=alpha, u=u)), want)
    out = _np(baselines.dare(_t(delta), alpha=alpha,
                             generator=torch.Generator().manual_seed(1)))
    assert abs(float((out != 0).mean()) - 1 / alpha) < 0.03
    nz = out != 0
    np.testing.assert_allclose(out[nz], np.asarray(delta)[nz] * alpha, rtol=1e-5)


@pytest.mark.parametrize("alpha,k_bits", [(8, 4), (2, 4), (32, 2), (16, 8)])
def test_deltazip_matches_reference(delta, alpha, k_bits):
    got = _np(baselines.deltazip(_t(delta), alpha=alpha, k_bits=k_bits))
    want = np.asarray(jbase.deltazip(None, delta, alpha=alpha, k_bits=k_bits))
    np.testing.assert_array_equal(got != 0, want != 0)     # the same support
    np.testing.assert_allclose(got, want, **TOL)
    if (alpha, k_bits) == (8, 4):   # alpha_sparse 2: half of each column
        assert abs(float((got != 0).mean()) - 0.5) < 0.05
        col = got[:, 0]
        assert len(np.unique(np.round(col[col != 0], 8))) <= 16 * (256 // 128) + 1


def test_group_quant_and_colwise_thresh_match_reference(delta):
    for k, g in ((4, 128), (2, 64), (3, 96)):
        np.testing.assert_allclose(_np(baselines._group_quant(_t(delta), k, g)),
                                   np.asarray(jbase._group_quant(delta, k, g)), **TOL)
    mag = jnp.abs(delta)
    for keep in (1, 64, 256):
        np.testing.assert_array_equal(_np(baselines._colwise_thresh(_t(mag), keep)),
                                      np.asarray(jbase._colwise_thresh(mag, keep)))


def test_methods_and_bits_match_reference(delta):
    assert sorted(baselines.METHODS) == sorted(jbase.METHODS)
    for name in baselines.METHODS:
        for alpha, k in ((8, 4), (16, 2), (2, 8)):
            assert baselines.method_bits(name, delta.shape, alpha=alpha, k_bits=k) == \
                jbase.method_bits(name, delta.shape, alpha=alpha, k_bits=k)
    with pytest.raises(KeyError):
        baselines.method_bits("nope", delta.shape, alpha=8)


# ---------------------------------------------------------------------------
# Dropout baselines
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("h_in,k_bits", [(64, 4), (512, 4), (96, None)])
def test_rowwise_dropout_pack_matches_reference(h_in, k_bits):
    """Row-wise dropout (one group of h_in rows) with the reference's keys:
    equal idx (int32 above 256 rows), codes, scale and zero."""
    rng = jax.random.PRNGKey(h_in)
    d = jax.random.normal(jax.random.fold_in(rng, 1), (h_in, 24)) * 0.01
    want = jdropout.rowwise_dropout_pack(rng, d, alpha=8, k_bits=k_bits, m=2)
    u = _t(jax.random.uniform(rng, (1, h_in, 24)))
    got = tdropout.rowwise_dropout_pack(_t(d), alpha=8, k_bits=k_bits, m=2, u=u)
    assert (got.h_g, got.keep, got.k_bits, got.m) == (want.h_g, want.keep, want.k_bits,
                                                      want.m)
    for f in ("idx", "codes", "scale", "zero"):
        a, b = _np(getattr(got, f)), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("alpha", [2, 8])
def test_bernoulli_dropout_dense_matches_reference(alpha):
    """The reference's uniform draw of its key gives its Bernoulli mask
    (``jax.random.bernoulli``'s rule ``u < p``): equal output."""
    rng = jax.random.PRNGKey(alpha)
    d = jax.random.normal(jax.random.fold_in(rng, 1), (128, 32)) * 0.01
    want = np.asarray(jdropout.bernoulli_dropout_dense(rng, d, alpha=alpha))
    got = tdropout.bernoulli_dropout_dense(_t(d), alpha=alpha,
                                           u=_t(jax.random.uniform(rng, d.shape)))
    np.testing.assert_array_equal(_np(got), want)
    drawn = _np(tdropout.bernoulli_dropout_dense(
        _t(d), alpha=alpha, generator=torch.Generator().manual_seed(0)))
    assert abs(float((drawn != 0).mean()) - 1 / alpha) < 0.05
    with pytest.raises(ValueError):
        tdropout.bernoulli_dropout_dense(_t(d), alpha=alpha, u=torch.zeros(3))
