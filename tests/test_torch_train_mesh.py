"""The port's training mesh (``make_train_step(mesh=)``, ZeRO-1, the int8
compressed all-reduce, ``Checkpointer`` on a mesh) against the port's
single-device step and the JAX reference.

One world of 4 CPU ranks (gloo) is spawned for the whole file
(``launch.mesh.run_ranks``, a file rendezvous under the test's temporary
directory); every rank runs ``tests/torch_train_mesh_cases.py``'s cases,
the llama3.2-1b smoke config at seq 16, batch 8, from the reference's
init at seed 0 with ``tests/test_torch_train.py``'s optimizer, and the
tests read the results. Stated tolerances, those of
``tests/test_torch_train.py``, for its setup:

* losses: rel 1e-4 (``LOSS_RTOL``). A rank's f32 grads are summed over
  ``data`` and rounded to bf16 once, where one device rounds the whole
  batch's: they differ in the f32 summation order only;
* the f32 masters after 3 steps, per leaf: max|mesh - one device| <=
  2^-7 * max|one device's change from the start| (``MASTER_REL``);
* the int8 codes: exact; the compressed transform's values: rel 1e-6.
"""
import concurrent.futures
import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.dist import ErrorFeedback as JErrorFeedback  # noqa: E402
from repro.dist import grad_compress as jgc  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import schedule as jsched  # noqa: E402
from repro.optim.adamw import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.train import make_train_step as j_make_train_step  # noqa: E402

from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.dist import ErrorFeedback, grad_compress as gc  # noqa: E402
from repro_torch.dist import make_compressed_allreduce  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train.train_step import value_and_grad, make_loss  # noqa: E402
from repro_torch.utils import flatten_with_paths, iter_leaves  # noqa: E402

import torch_bridge as br  # noqa: E402
import torch_train_mesh_cases as C  # noqa: E402

LOSS_RTOL = 1e-4
MASTER_REL = 2.0 ** -7
TRANSFORM_RTOL = 1e-6


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every case on every rank of one world of 4, and the single-device
    runs in this process: 3 + MORE steps (the uninterrupted run), and 3
    steps with the compressed transform of a (data 2) mesh."""
    tmp = tmp_path_factory.mktemp("train_mesh")
    ckpt = str(tmp / "elastic")
    p0 = _p0()
    # the world runs while this process makes the single-device runs
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        world_runs = pool.submit(mesh_lib.run_ranks, C.run, C.WORLD, (ckpt, *_host0()),
                                 device="cpu", timeout_s=240.0, rank_timeout_s=120.0,
                                 rendezvous_dir=str(tmp))
        single = _single_device_runs(p0)
        ranks = world_runs.result()
    return {"ranks": ranks, "single": single, "ckpt": ckpt, "p0": flatten_with_paths(p0)}


def _single_device_runs(p0) -> dict:
    cfg, data, opt_cfg = C.setup()
    p, o, losses = C.train(cfg, data, opt_cfg, p0, adamw.init(p0), 0, C.STEPS)
    # copies: AdamW goes on updating its state in place
    single = {"losses": losses, "params": flatten_with_paths(p),
              "master": {k: v.clone() for k, v in flatten_with_paths(o["master"]).items()}}
    *_, more = C.train(cfg, data, opt_cfg, p, o, C.STEPS, C.MORE)
    single["uninterrupted"] = losses + more
    view = mesh_lib.ServingMesh.view(data=2)
    pc, _, single["compress"] = C.train(cfg, data, opt_cfg, p0, adamw.init(p0), 0, C.STEPS,
                                        grad_transform=make_compressed_allreduce(view, "data"))
    single["compress_params"] = flatten_with_paths(pc)
    *_, single["micro"] = C.train(cfg, data, opt_cfg, p0, adamw.init(p0), 0, C.STEPS,
                                  n_micro=C.N_MICRO)
    return single


@functools.lru_cache(maxsize=None)
def _jp0() -> dict:
    """The reference's init at seed 0 (never updated in place; one jit, the
    eager init's values)."""
    return jax.jit(jlm.init_params, static_argnums=0)(j_smoke(C.ARCH), jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _host0() -> tuple:
    return params_to_numpy(br.params_to_port(_jp0()))


def _p0() -> dict:
    """The reference's init at seed 0, carried to the port (fresh tensors)."""
    return params_from_numpy(*_host0(), device="cpu")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).numpy()


def _assert_master_close(got: dict, want: dict, start: dict):
    for k, w in want.items():
        d_want = _np(w).astype(np.float64) - _np(start[k])
        err = float(np.abs(got[k].astype(np.float64) - _np(w)).max())
        scale = float(np.abs(d_want).max())
        assert scale > 0 and err <= MASTER_REL * scale, (k, err, scale)


def test_world_is_gloo_over_four_ranks(world):
    ranks = world["ranks"]
    assert ranks[0]["backend"] == "gloo"
    assert sorted((r["coords"][(2, 2)]["data"], r["coords"][(2, 2)]["model"])
                  for r in ranks) == [(0, 0), (0, 1), (1, 0), (1, 1)]


@pytest.mark.parametrize("layout", C.LAYOUTS)
def test_mesh_steps_match_single_device(world, layout):
    """(a) Losses on every rank and the gathered params and masters equal
    the port's single-device steps; a bf16 param differs from the single
    device's by at most its master's difference plus one bf16 spacing."""
    single = world["single"]
    for r in world["ranks"]:
        np.testing.assert_allclose(r["losses"][layout], single["losses"], rtol=LOSS_RTOL)
    r0 = world["ranks"][0]
    assert r0["params"][layout].keys() == single["params"].keys()
    _assert_master_close(r0["master"][layout], single["master"],
                         {k: v.to(torch.float32) for k, v in world["p0"].items()})
    for k, w in single["params"].items():
        got = r0["params"][layout][k]
        assert got.shape == tuple(w.shape), k
        if w.dtype == torch.bfloat16:
            assert np.array_equal(got, _np(torch.from_numpy(got).to(torch.bfloat16))), k
            diff = np.abs(got - _np(w))
            bound = (np.abs(r0["master"][layout][k] - _np(single["master"][k]))
                     + 2.0 ** (np.floor(np.log2(np.maximum(np.abs(_np(w)), 2.0 ** -126))) - 7))
            assert (diff <= bound).all(), k


def test_mesh_microbatches_match_single_device(world):
    """(a) ``n_micro=2`` at (2, 2): the global batch cut into microbatches
    first and each one's rows over ``data``; every rank's losses (the last
    microbatch's) equal the single device's ``n_micro=2`` steps."""
    for r in world["ranks"]:
        np.testing.assert_allclose(r["losses"]["micro"], world["single"]["micro"],
                                   rtol=LOSS_RTOL)
    # the last microbatch's loss, not the whole batch's
    assert world["single"]["micro"][0] != world["single"]["losses"][0]


def test_mesh_losses_match_reference_single_device(world):
    """(a) The (2, 2) mesh's losses equal the reference's ``make_train_step``
    on one device, on the same params (one jit)."""
    _, data, _ = C.setup()
    jcfg = j_smoke(C.ARCH)
    jp = _jp0()
    step = jax.jit(j_make_train_step(jcfg, JAdamWConfig(
        lr=C.LR, schedule=jsched.cosine_with_warmup(C.WARMUP, C.HORIZON))))
    jo, losses = jadamw.init(jp), []
    for i in range(C.STEPS):
        jp, jo, m = step(jp, jo, data.batch_at(i), jax.random.PRNGKey(i))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(world["ranks"][0]["losses"][(2, 2)], losses, rtol=LOSS_RTOL)


def test_grad_compress_matches_single_device_transform(world):
    """(b) ``--grad-compress`` at (2, 2) equals one device applying
    ``make_compressed_allreduce(ServingMesh.view(data=2))`` to its grads."""
    single = world["single"]
    for r in world["ranks"]:
        np.testing.assert_allclose(r["losses"]["compress"], single["compress"], rtol=LOSS_RTOL)
    got = world["ranks"][0]["params"]["compress"]
    for k, w in single["compress_params"].items():
        assert got[k].shape == tuple(w.shape), k
    # the rounding moved the params off the uncompressed run's
    assert any(not np.array_equal(got[k], world["ranks"][0]["params"][(2, 2)][k])
               for k in got)


def test_compressed_transform_matches_reference_leaf_for_leaf():
    """(b) The transform on the same f32 grads: int8 codes exact, values
    rel 1e-6, leaf for leaf; the identity at data 1."""
    cfg, data, _ = C.setup()
    p = lm.init_params(cfg, 0, device="cpu")
    _, g = value_and_grad(make_loss(cfg), p, {"tokens": torch.as_tensor(
        data.batch_at(0)["tokens"]).long()})
    g = {k: v.to(torch.float32) for k, v in flatten_with_paths(g).items()}
    got = make_compressed_allreduce(mesh_lib.ServingMesh.view(data=2), "data")(g)
    jg = {k: jnp.asarray(v.numpy()) for k, v in g.items()}
    want = jax.jit(jgc.make_compressed_allreduce(types.SimpleNamespace(shape={"data": 2}),
                                                 "data"))(jg)
    j_codes = jax.jit(lambda t: jax.tree.map(
        lambda v: jgc._quantize_int8(v, jnp.max(jnp.abs(v))), t))(jg)
    for k, v in g.items():
        q, scale = gc._quantize_int8(v, torch.max(torch.abs(v)))
        jq, jscale = j_codes[k]
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq), err_msg=k)
        # XLA's fusion may divide by 127 as a product with its reciprocal
        np.testing.assert_allclose(float(scale), float(jscale), rtol=TRANSFORM_RTOL, err_msg=k)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=TRANSFORM_RTOL,
                                   err_msg=k)
    same = make_compressed_allreduce(mesh_lib.ServingMesh.view(data=1), "data")(g)
    assert same is g


def test_wire_all_reduce_matches_reference_quantization(world):
    """(c) ``compressed_all_reduce`` over 4 ranks: the reference's
    ``_quantize_int8`` of each rank's vector at the agreed max, int32 codes
    summed, ``* scale / 4``; the same bits on every rank."""
    vs = [jnp.asarray(C.wire_vector(r)) for r in range(C.WORLD)]
    amax = jnp.max(jnp.stack([jnp.max(jnp.abs(v)) for v in vs]))
    codes = [jgc._quantize_int8(v, amax) for v in vs]
    total = sum(q.astype(jnp.int32) for q, _ in codes)
    want = np.asarray(total.astype(jnp.float32) * codes[0][1] / C.WORLD)
    for r in world["ranks"]:
        np.testing.assert_array_equal(r["wire"], want)
    for v in vs:     # the codes themselves
        q, _ = gc._quantize_int8(torch.tensor(np.asarray(v)), torch.tensor(np.asarray(amax)))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jgc._quantize_int8(v, amax)[0]))


def test_error_feedback_matches_reference_over_rounds():
    """(c) ``ErrorFeedback`` over 5 rounds of the same gradient: what is
    sent and the carried residual equal the reference's; the mean sent
    converges to the gradient (``tests/test_dist.py:86-105``)."""
    g = np.random.default_rng(1).normal(size=512).astype(np.float32)
    tg, jg = {"w": torch.from_numpy(g)}, {"w": jnp.asarray(g)}
    tr, jr = ErrorFeedback.init(tg), JErrorFeedback.init(jg)
    acc = np.zeros(512)
    for _ in range(5):
        ts, tr = ErrorFeedback.apply(tg, tr)
        js, jr = JErrorFeedback.apply(jg, jr)
        np.testing.assert_allclose(ts["w"].numpy(), np.asarray(js["w"]), rtol=TRANSFORM_RTOL)
        np.testing.assert_allclose(tr["w"].numpy(), np.asarray(jr["w"]), rtol=0, atol=1e-6)
        acc += ts["w"].numpy()
    assert np.abs(acc / 5 - g).max() < 5e-3


@pytest.mark.parametrize("layout", [(2, 2), (4, 1)])
def test_per_rank_bytes_equal_layouts(world, layout):
    """(d) Each rank holds exactly the layouts' ``local_shape`` bytes: its
    params in the train layout and each of m, v, master in ZeRO-1."""
    for r in world["ranks"]:
        b = r["bytes"][layout]
        assert b["held"]["params"] == b["layout"]["params"]
        assert b["held"]["state"] == [b["layout"]["state"]] * 3


def test_zero1_halves_state_on_a_sub_mesh(world):
    """(d) On (2, 1), ranks 0 and 1 of the world: each holds at most half
    the single-device AdamW state plus the leaves ZeRO-1 cannot cut."""
    cfg, _, _ = C.setup()
    view = mesh_lib.ServingMesh.view(data=2)
    z = mesh_lib.train_shardings(cfg, view)["opt"]["master"]
    whole = {k: v.numel() * 4 for k, v in world["p0"].items()}
    uncut = sum(whole[k] for k, pl in iter_leaves(z) if all(e is None for e in pl))
    for r in world["ranks"][:2]:
        for nbytes in r["bytes"]["sub"]["state"]:
            assert nbytes <= sum(whole.values()) / 2 + uncut
    assert "sub" not in world["ranks"][2]["bytes"]


def test_elastic_restore_continues_the_run(world):
    """(e) Saved after 3 steps at (2, 2), restored at (4, 1) and on one
    process: 2 more steps give the uninterrupted run's losses. The saved
    ``arrays.npz`` restores in the reference's ``Checkpointer`` too."""
    cfg, data, opt_cfg = C.setup()
    want = world["single"]["uninterrupted"][C.STEPS:]
    for r in world["ranks"]:
        np.testing.assert_allclose(r["losses"]["elastic"], want, rtol=LOSS_RTOL)
    p0 = _p0()
    state, man = Checkpointer(world["ckpt"]).restore({"params": p0, "opt": adamw.init(p0)})
    assert man["extra"]["data_step"] == C.STEPS
    jp = _jp0()
    jstate, _ = JCheckpointer(world["ckpt"]).restore({"params": jp, "opt": jadamw.init(jp)})
    flat_j = flatten_with_paths(jstate)
    for k, v in flatten_with_paths(state).items():
        a = _np(v) if v.is_floating_point() else v.numpy()
        np.testing.assert_array_equal(a, np.asarray(flat_j[k]).astype(a.dtype), err_msg=k)
    *_, losses = C.train(cfg, data, opt_cfg, state["params"], state["opt"], C.STEPS, C.MORE)
    np.testing.assert_allclose(losses, want, rtol=LOSS_RTOL)


def test_same_rows_control_fails_the_loss_bound(world):
    """(f) Both data ranks fed the same rows: the first loss (a forward
    pass) leaves the bound, so the bound can catch a wrong placement of
    the rows (``test_unreduced_grads_control_fails_the_loss_bound``: a
    wrong reduction)."""
    single = world["single"]["losses"][0]
    got = world["ranks"][0]["losses"]["same_rows"][0]
    assert abs(got - single) > LOSS_RTOL * abs(single)


def test_unreduced_grads_control_fails_the_loss_bound(world):
    """The data all-reduce of the grads skipped at (2, 2): step 1's loss
    (before any update) still equals one device's, and steps 2 and 3 leave
    the bound, so the bound can catch a wrong reduction."""
    single = world["single"]["losses"]
    got = world["ranks"][0]["losses"]["unreduced"]
    np.testing.assert_allclose(got[0], single[0], rtol=LOSS_RTOL)
    for g, w in zip(got[1:], single[1:]):
        assert abs(g - w) > LOSS_RTOL * abs(w), (g, w)


def test_restore_refuses_a_compressed_member(tmp_path):
    """Checkpoints are written by ``np.savez``, whose members are stored;
    a compressed ``arrays.npz`` is refused, not read another way."""
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"w": torch.ones(4)})
    path = tmp_path / "step_00000001" / "arrays.npz"
    np.savez_compressed(path, w=np.ones(4, np.float32))
    with pytest.raises(ValueError, match="compressed"):
        ck.restore({"w": torch.zeros(4)})
