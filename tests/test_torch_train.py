"""The port's training path against the JAX reference: schedules, AdamW,
the data pipeline, gradients (remat on and off, and through ``deltas=``)
and ``make_train_step`` (``lm.loss_fn`` for every config:
``test_torch_loss.py``).

Params come from the reference's init and are carried across by
``tests/torch_bridge.py`` (bf16 as raw bits). Stated tolerances:

* schedules and AdamW: rel 1e-6 (f32, the same operations in the same
  order; only the two frameworks' f32 kernels differ, by an ulp where
  XLA contracts a multiply-add), for AdamW's leaves relative to each
  leaf's largest element (``master - lr * delta`` cancels near zero, so
  an ulp of ``lr * delta`` is a large share of a small result);
* data batches: exactly equal;
* losses: rel 1e-4 (bf16 weights, f32 residual stream: the logits agree
  within 1e-3, ``test_torch_model.py``, and the mean over tokens
  averages that down);
* gradients: per leaf, max|port - ref| <= 2^-6 * max|ref| (two bf16
  spacings at the leaf's largest gradient: a bf16 leaf's gradient is
  rounded to bf16 in both packages, and an f32 difference in the last
  bits moves a rounding by one spacing, at most 2^-7 of the value);
* after 5 steps, per leaf, the f32 master's change from the start:
  max|port - ref| <= 2^-7 * max|ref change| over every element (the
  gradients' differences above, through AdamW's ``m / sqrt(v)``, which
  depends on a gradient's size only weakly); the params are the master
  cast to the param dtype, and a bf16 param differs from the reference's
  by at most the masters' difference plus one bf16 spacing (each is its
  master rounded to the nearest bf16).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ArchConfig as JArchConfig  # noqa: E402
from repro.configs import get_smoke_config  # noqa: E402
from repro.core import DeltaDQSpec, compress  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import schedule as jsched  # noqa: E402
from repro.optim.adamw import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.train import make_train_step as j_make_train_step  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import ArchConfig, get_smoke_config as t_smoke  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.kernels import fallback, ops  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim import schedule as tsched  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402
from repro_torch.train.train_step import make_eval_step, value_and_grad  # noqa: E402
from repro_torch.utils import flatten_with_paths  # noqa: E402

import torch_bridge as br  # noqa: E402

OPT_TOL = dict(rtol=1e-6, atol=0)
LOSS_RTOL = 1e-4
GRAD_REL = 2.0 ** -6
MASTER_REL = 2.0 ** -7
ARCH = "llama3.2-1b"
TINY = dict(name="tiny-sys", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv=2, head_dim=16, d_ff=128, vocab=64, act="silu", tie_embeddings=True)

j_loss = jax.jit(jlm.loss_fn, static_argnums=0, static_argnames="remat")
j_grad = jax.jit(jax.grad(lambda cfg, p, b, deltas=None, remat=False:
                          jlm.loss_fn(cfg, p, b, deltas=deltas, remat=remat)[0],
                          argnums=1), static_argnums=0, static_argnames="remat")


def _np(a):
    """A JAX array or port tensor as an f32 numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).cpu().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _flat_np(tree):
    """{path: f32 numpy} of a dict tree of either package's arrays."""
    return {k: _np(v) for k, v in flatten_with_paths(tree).items()}


def _assert_leaf_close(got, want, rel, msg=""):
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * float(np.abs(want).max()),
                               err_msg=msg)


def _assert_grads_close(got: dict, want: dict, rel=GRAD_REL):
    assert got.keys() == want.keys()
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        err = float(np.abs(got[k] - want[k]).max())
        assert err <= rel * scale, (k, err, scale)


# ---------------------------------------------------------------------------
# schedules and AdamW
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("make", [
    lambda s: s.cosine_with_warmup(10, 100),
    lambda s: s.cosine_with_warmup(0, 50, min_frac=0.2),
    lambda s: s.constant(),
    lambda s: s.inverse_sqrt(16),
])
def test_schedules_match_reference(make):
    jf, tf = make(jsched), make(tsched)
    for step in range(121):
        want = np.float32(jf(jnp.int32(step)))
        got = tf(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.item(), want, **OPT_TOL)
        assert tf(step).item() == got.item()   # a Python int as well


def _opt_tree(rng):
    """Decayed (wq, embed) and undecayed (ln1, final_norm/scale) leaves,
    bf16 stacks and f32 vectors, as the models' trees."""
    shapes = {"attn": {"wq": ((3, 8, 4), "bfloat16"), "ln1": ((3, 8), "float32")},
              "embed": {"tok": ((16, 8), "float32")},
              "final_norm": {"scale": ((8,), "float32")}}

    def make(spec, scale):
        shape, dt = spec
        return jnp.asarray(rng.standard_normal(shape).astype(np.float32) * scale,
                           jnp.dtype(dt))
    p = {k: {n: make(s, 0.5) for n, s in v.items()} for k, v in shapes.items()}
    g = [{k: {n: make(s, 3.0) for n, s in v.items()} for k, v in shapes.items()}
         for _ in range(3)]
    return p, g


@pytest.mark.parametrize("clip", [1.0, 1e6])   # clipped, and not
def test_adamw_update_matches_reference(clip):
    rng = np.random.default_rng(0)
    jp, jgs = _opt_tree(rng)
    jcfg = JAdamWConfig(lr=1e-2, grad_clip=clip, schedule=jsched.cosine_with_warmup(1, 4))
    tcfg = AdamWConfig(lr=1e-2, grad_clip=clip, schedule=tsched.cosine_with_warmup(1, 4))
    tp = br.params_to_port(jp)
    jst, tst = jadamw.init(jp), tadamw.init(tp)
    for jg in jgs:
        jp, jst, jm = jadamw.update(jcfg, jp, jg, jst)
        tp, tst, tm = tadamw.update(tcfg, tp, br.params_to_port(jg), tst)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(_np(tm[k]), _np(jm[k]), **OPT_TOL)
        for name in ("m", "v", "master"):
            want, got = _flat_np(jst[name]), _flat_np(tst[name])
            for k in want:
                _assert_leaf_close(got[k], want[k], OPT_TOL["rtol"], f"{name}/{k}")
        want, got = _flat_np(jp), _flat_np(tp)
        for k in want:
            _assert_leaf_close(got[k], want[k], OPT_TOL["rtol"], k)
        assert int(tst["step"]) == int(jst["step"])
    assert tp["attn"]["wq"].dtype == torch.bfloat16
    # wd 0.1 decays wq and embed/tok only
    assert tadamw._decay_mask("attn/wq") == 1.0 and tadamw._decay_mask("attn/ln1") == 0.0


def test_grad_clip_and_state_roundtrip():
    g = {"a": torch.ones(4) * 100.0}
    clipped, norm = tadamw.clip_by_global_norm(g, 1.0)
    assert norm.item() == pytest.approx(200.0)
    assert torch.linalg.norm(clipped["a"]).item() == pytest.approx(1.0, rel=1e-5)
    st = tadamw.init({"w": torch.randn(3, 2).bfloat16()})
    back = convert.opt_state_from_numpy(convert.opt_state_to_numpy(st), device="cpu")
    assert all(torch.equal(back[k]["w"], st[k]["w"]) for k in ("m", "v", "master"))
    assert back["step"].dtype == torch.int32
    assert tadamw.state_specs({"w": ((3, 2), torch.bfloat16)})["master"]["w"] == \
        ((3, 2), torch.float32)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
def _sources(mod, path):
    return [mod.SyntheticLM(vocab=50, seq_len=12, batch=3, seed=4),
            mod.MemmapTokens(path, seq_len=10, batch=4, seed=2),
            mod.SortTask(vocab=64, seq_len=24, batch=5, n_digits=4, seed=1),
            mod.FormatOnlyTask(vocab=64, seq_len=24, batch=5, n_digits=4, seed=2),
            mod.PretrainMixture(vocab=64, seq_len=16, batch=4, seed=0)]


def test_data_sources_equal_reference(tmp_path):
    path = str(tmp_path / "tokens.bin")
    np.random.default_rng(3).integers(0, 1000, 500).astype(np.int32).tofile(path)
    assert (tpipe.EOS, tpipe.SEP, tpipe.PAD) == (jpipe.EOS, jpipe.SEP, jpipe.PAD)
    for js, ts in zip(_sources(jpipe, path), _sources(tpipe, path)):
        for step in (0, 1, 7, 123):
            want, got = js.batch_at(step), ts.batch_at(step)
            assert want.keys() == got.keys()
            for k in want:
                assert want[k].dtype == got[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
        if isinstance(js, jpipe.SortTask):
            for step in (0, 9000):
                for w, g in zip(js.prompts_at(step), ts.prompts_at(step)):
                    np.testing.assert_array_equal(g, w)
    first = next(iter(tpipe.SyntheticLM(vocab=50, seq_len=12, batch=3, seed=4)))
    np.testing.assert_array_equal(first["tokens"],
                                  jpipe.SyntheticLM(50, 12, 3, 4).batch_at(0)["tokens"])


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------
def _port_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.fixture(scope="module")
def smoke():
    cfg = get_smoke_config(ARCH)
    jp = jlm.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, t_smoke(ARCH), jp


def _port_grads(tcfg, tp, b, remat, deltas=None):
    (_, _), g = value_and_grad(
        lambda p, bb: tlm.loss_fn(tcfg, p, bb, deltas=deltas, remat=remat), tp, b)
    return g


def test_grads_match_reference_remat_on_and_off(smoke):
    cfg, tcfg, jp = smoke
    tp = br.params_to_port(jp)
    b = jpipe.PretrainMixture(vocab=cfg.vocab, seq_len=32, batch=4).batch_at(0)
    got = {}
    for remat in (False, True):
        want = _flat_np(j_grad(cfg, jp, b, remat=remat))
        g = _port_grads(tcfg, tp, _port_batch(b), remat)
        assert g["attn"]["wq"].dtype == torch.bfloat16    # the param dtype
        got[remat] = g
        _assert_grads_close(_flat_np(g), want)
    # remat recomputes the same eager ops: equal to the bit
    for k, v in flatten_with_paths(got[False]).items():
        assert torch.equal(v, flatten_with_paths(got[True])[k]), k


def _assert_change_close(got, want, start, rel=MASTER_REL, msg=""):
    """A leaf's change from ``start``: max|(got - start) - (want - start)|
    <= rel * max|want - start|, over every element."""
    d_want = want.astype(np.float64) - start
    d_got = got.astype(np.float64) - start
    scale = float(np.abs(d_want).max())
    assert scale > 0, (msg, "the reference did not move this leaf")
    err = float(np.abs(d_got - d_want).max())
    assert err <= rel * scale, (msg, err, scale)


def _bf16_spacing(x):
    """The spacing of bf16 values at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x.astype(np.float64)), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def test_train_steps_match_reference(smoke):
    cfg, tcfg, jp0 = smoke
    lr, steps = 1e-3, 5
    data = jpipe.PretrainMixture(vocab=cfg.vocab, seq_len=32, batch=8)
    jstep = jax.jit(j_make_train_step(cfg, JAdamWConfig(
        lr=lr, schedule=jsched.cosine_with_warmup(2, 10))))
    tstep = make_train_step(tcfg, AdamWConfig(lr=lr, schedule=tsched.cosine_with_warmup(2, 10)))
    jp, jo = jp0, jadamw.init(jp0)
    tp = br.params_to_port(jp0)
    to = tadamw.init(tp)
    for i in range(steps):
        if i == steps - 1:      # the port's master before the last update
            before_last = {k: v.copy() for k, v in _flat_np(to["master"]).items()}
        jp, jo, jm = jstep(jp, jo, data.batch_at(i), jax.random.PRNGKey(i))
        tp, to, tm = tstep(tp, to, data.batch_at(i), i)
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]),
                                   rtol=LOSS_RTOL)
    start = _flat_np(jp0)
    want_m, got_m = _flat_np(jo["master"]), _flat_np(to["master"])
    assert want_m.keys() == got_m.keys() == start.keys()
    for k in start:
        _assert_change_close(got_m[k], want_m[k], start[k], msg=k)
        # the check refuses no update, an update in the wrong direction,
        # and a run that skipped the last update
        for bad in (start[k], 2 * start[k].astype(np.float64) - want_m[k], before_last[k]):
            with pytest.raises(AssertionError):
                _assert_change_close(bad, want_m[k], start[k], msg=k)
    want_p = _flat_np(jp)
    for k, v in flatten_with_paths(tp).items():
        assert not v.requires_grad and v.grad_fn is None, k
        master = flatten_with_paths(to["master"])[k]
        assert master.dtype == torch.float32 and torch.equal(v, master.to(v.dtype)), k
        if v.dtype == torch.bfloat16:
            # each param is its master rounded to bf16, within half a
            # spacing: the params differ by the masters' difference plus
            # at most one spacing at the larger of the two
            got = _np(v).astype(np.float64)
            err = np.abs(got - want_p[k])
            bound = (np.abs(got_m[k].astype(np.float64) - want_m[k])
                     + _bf16_spacing(np.maximum(np.abs(got), np.abs(want_p[k]))))
            assert (err <= bound).all(), (k, float((err - bound).max()))
        else:
            np.testing.assert_array_equal(_np(v), got_m[k], err_msg=k)


def test_microbatch_equivalence(smoke):
    """n_micro=4 vs 1 within the reference's own atol 5e-3
    (``tests/test_train.py:34-50``); the loss reported is the last
    microbatch's, as the reference's scan carry gives it."""
    cfg, tcfg, jp = smoke
    batch = jpipe.PretrainMixture(vocab=cfg.vocab, seq_len=32, batch=8).batch_at(0)
    outs = []
    for nm in (1, 4):
        tp = br.params_to_port(jp)
        step = make_train_step(tcfg, AdamWConfig(lr=1e-3), n_micro=nm)
        outs.append(step(tp, tadamw.init(tp), batch))
    for k, v in flatten_with_paths(outs[0][0]).items():
        np.testing.assert_allclose(_np(flatten_with_paths(outs[1][0])[k]), _np(v),
                                   atol=5e-3, err_msg=k)
    last = {k: torch.from_numpy(v[6:]) for k, v in batch.items()}
    want = tlm.loss_fn(tcfg, br.params_to_port(jp), last, remat=True)[0]
    assert outs[1][2]["loss"].item() == want.item()
    jstep = jax.jit(j_make_train_step(cfg, JAdamWConfig(lr=1e-3), n_micro=4))
    jm = jstep(jp, jadamw.init(jp), batch, jax.random.PRNGKey(0))[2]
    np.testing.assert_allclose(outs[1][2]["loss"].item(), float(jm["loss"]), rtol=LOSS_RTOL)


def test_grads_through_deltas_match_reference():
    """Grad of loss_fn(deltas=) at tests/test_system.py's TINY config (a
    short JAX trace) vs ``jax.grad``; and the autograd Function's backward
    (``ops.delta_spmm``: plain forward, ``g @ dequant(d)^T``) equal to
    native autograd through the plain correction. At 256 rows the plain
    correction is the dense product, so the two run the same ops: equal
    to the bit."""
    cfg = JArchConfig(**TINY)
    tcfg = ArchConfig(**TINY)
    jp = jlm.init_params(cfg, jax.random.PRNGKey(0))
    ft = jax.tree.map(lambda p: p * 1.01 if p.ndim >= 2 else p, jp)
    deltas, _ = compress(jp, ft, DeltaDQSpec(alpha=4.0, k_bits=8, h_g=16))
    b = jpipe.PretrainMixture(vocab=cfg.vocab, seq_len=32, batch=8).batch_at(0)
    want = _flat_np(j_grad(cfg, jp, b, deltas=deltas))
    tp, td = br.params_to_port(jp), br.deltas_to_port(deltas)
    tb = _port_batch(b)
    fn = _port_grads(tcfg, tp, tb, False, td)
    _assert_grads_close(_flat_np(fn), want)
    # the correction moves the grads: without deltas they differ
    plain = _flat_np(_port_grads(tcfg, tp, tb, False))
    assert max(float(np.abs(plain[k] - want[k]).max() / np.abs(want[k]).max())
               for k in want) > 2 * GRAD_REL

    orig = ops.delta_spmm
    try:
        ops.delta_spmm = lambda x, d: fallback.correction_nd(x, d)
        native = _port_grads(tcfg, tp, tb, False, td)
    finally:
        ops.delta_spmm = orig
    for k, v in flatten_with_paths(native).items():
        assert torch.equal(flatten_with_paths(fn)[k], v), k
    # make_eval_step runs loss_fn(deltas=) without a graph
    m = make_eval_step(tcfg)(tp, b, deltas=td)
    np.testing.assert_allclose(m["loss"].item(), float(j_loss(cfg, jp, b, deltas=deltas)[0]),
                               rtol=LOSS_RTOL)
    assert m["loss"].grad_fn is None


def test_correction_function_matches_native_autograd():
    """ops.delta_spmm's backward at decode-sized and prefill-sized rows
    (the gather and the dense plain formulations forward) against native
    autograd through the same plain correction, f32 and bf16 inputs."""
    from repro_torch.core.dropout import groupwise_dropout_pack
    g = torch.Generator().manual_seed(0)
    d = groupwise_dropout_pack(torch.randn(64, 48, generator=g) * 0.01, h_g=16,
                               alpha=4, k_bits=4, generator=g)
    for T in (3, 100):
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(2, T, 64, generator=g).to(dt).requires_grad_()
            y = ops.delta_spmm(x, d)
            assert y.grad_fn is not None and y.dtype == torch.float32
            gy = torch.randn(y.shape, generator=g)
            got, = torch.autograd.grad(y, x, gy)
            x2 = x.detach().clone().requires_grad_()
            want, = torch.autograd.grad(fallback.correction_nd(x2, d), x2, gy)
            assert got.dtype == dt
            torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)
            with torch.no_grad():
                assert ops.delta_spmm(x, d).grad_fn is None


# ---------------------------------------------------------------------------
# the segments, slots and fused routes' backward vs jax.grad of the
# reference's formulations
# ---------------------------------------------------------------------------
def _route_inputs():
    """Two tenants' packed deltas (64 x 48, 128x-style k=4), stacked, and
    their twins in the reference's layout."""
    from repro_torch.core.apply import stack_tenant_deltas
    from repro_torch.core.dropout import groupwise_dropout_pack
    g = torch.Generator().manual_seed(3)
    ds = [groupwise_dropout_pack(torch.randn(64, 48, generator=g) * 0.01, h_g=16,
                                 alpha=4, k_bits=4, generator=g) for _ in range(2)]
    stack = stack_tenant_deltas([{"w": d} for d in ds])["w"]
    return g, ds, stack, br.packed_to_jax(stack)


@pytest.mark.parametrize("route", ["segments", "slots", "fused"])
def test_route_backward_matches_reference(route):
    """ops.delta_spmm_segments (two tenants' segments and an empty one),
    delta_spmm_slots and fused_base_delta (and its weight gradient) under
    grad: their Functions' input gradients against ``jax.grad`` of the
    reference's formulations (``fallback.segment_correction``,
    ``fallback.gather_correction_rows``, ``x @ (w + dequant(d))``), per
    input within 2^-6 of its max|g| as the model's grads above. Rows the
    port's segments zero-fill (outside every segment, or in a segment
    whose row is outside the stack, which the reference's formulation
    does not define) get an exact zero, as native autograd through the
    port's plain version gives."""
    from repro.core.pack import reconstruct_dense as j_dense
    from repro.kernels import fallback as jfb
    g, ds, stack, jstack = _route_inputs()
    if route == "segments":
        rows = np.array([1, 0, 1], np.int32)
        offs = np.array([0, 3, 3, 11], np.int32)
        x = torch.randn(11, 64, generator=g)

        def port(x, w):
            return ops.delta_spmm_segments(x, stack, torch.from_numpy(rows),
                                           torch.from_numpy(offs))

        def ref(x, w):
            return jfb.segment_correction(x, jstack, jnp.asarray(rows), jnp.asarray(offs))
        w = None
    elif route == "slots":
        from repro_torch.core.apply import stack_tenant_deltas
        rows_stack = stack_tenant_deltas([{"w": ds[b % 2]} for b in range(3)])["w"]
        jrows = br.packed_to_jax(rows_stack)
        x = torch.randn(3, 2, 64, generator=g)

        def port(x, w):
            return ops.delta_spmm_slots(x, rows_stack)

        def ref(x, w):
            return jfb.gather_correction_rows(x, jrows)
        w = None
    else:
        x = torch.randn(5, 64, generator=g)
        w = torch.randn(64, 48, generator=g) * 0.1

        def port(x, w):
            return ops.fused_base_delta(x, w, ds[0])

        def ref(x, w):
            return x @ (w + j_dense(br.packed_to_jax(ds[0])))
    gy = torch.randn(port(x, w).shape, generator=g)
    xs = [x] if w is None else [x, w]
    leaves = [t.clone().requires_grad_() for t in xs]
    y = port(*leaves, *([None] if w is None else []))
    assert y.grad_fn is not None
    got = torch.autograd.grad(y, leaves, gy)
    argnums = (0,) if w is None else (0, 1)
    want = jax.grad(lambda *a: jnp.sum(ref(*a, *([None] if w is None else []))
                                       * jnp.asarray(gy.numpy())),
                    argnums=argnums)(*[jnp.asarray(t.numpy()) for t in xs])
    for a, b in zip(got, want):
        _assert_grads_close({"g": _np(a)}, {"g": _np(b)})
    if route == "segments":
        rows_t = torch.tensor([1, 0, -1], dtype=torch.int32)
        offs_t = torch.tensor([0, 3, 7, 9], dtype=torch.int32)
        x1 = x.clone().requires_grad_()
        dx, = torch.autograd.grad(ops.delta_spmm_segments(x1, stack, rows_t, offs_t), x1, gy)
        x2 = x.clone().requires_grad_()
        native, = torch.autograd.grad(fallback.segment_correction(x2, stack, rows_t, offs_t),
                                      x2, gy)
        torch.testing.assert_close(dx, native, atol=1e-6, rtol=1e-5)
        assert not dx[7:].any() and dx[:7].abs().min() >= 0 and dx[:7].any()
