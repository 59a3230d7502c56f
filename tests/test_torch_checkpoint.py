"""The port's checkpointer against the JAX reference's, and crash-restart.

Both write ``step_%08d/{arrays.npz, manifest.json}`` with bf16 as raw
uint16 bits, so a checkpoint written by either package restores in the
other; every comparison here is to the bit. The port's crash-restart
(3 steps, save, drop everything, restore, 3 more) equals 6 uninterrupted
steps to the bit, as ``tests/test_checkpoint.py:25-46`` holds the
reference, both through ``make_train_step`` and through
``repro_torch.launch.train``'s ``--ckpt-dir``/``--resume``.
"""
import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro.configs import get_smoke_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402

from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.data import PretrainMixture  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402
from repro_torch.utils import flatten_with_paths  # noqa: E402

import torch_bridge as br  # noqa: E402

ARCH = "llama3.2-1b"


def _bits(a) -> np.ndarray:
    """Any array's raw bits (bf16 as uint16), for exact comparison."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    arr, _ = br.to_numpy(a)
    return arr


def _assert_trees_bit_equal(got, want):
    g, w = flatten_with_paths(got), flatten_with_paths(want)
    assert g.keys() == w.keys()
    for k in w:
        gb, wb = _bits(g[k]), _bits(w[k])
        assert gb.dtype == wb.dtype and gb.shape == wb.shape, k
        np.testing.assert_array_equal(gb, wb, err_msg=k)


def _state(seed=0):
    """A port train state with bf16 stacks, f32 leaves and the int32 step."""
    params = tlm.init_params(t_smoke(ARCH), seed, device="cpu")
    opt = adamw.init(params)
    opt["m"]["attn"]["wq"].normal_(generator=torch.Generator().manual_seed(seed))
    opt["step"] += 3
    return {"params": params, "opt": opt}


def test_roundtrip_async_latest_and_bf16_bits(tmp_path):
    ck = Checkpointer(str(tmp_path / "ck"))
    assert ck.latest_step() is None
    with pytest.raises(FileNotFoundError):
        ck.restore({"x": torch.zeros(3)})
    s1, s7 = _state(1), _state(7)
    ck.save(1, s1)
    ck.save(7, s7, extra={"data_step": 7}, blocking=False)
    ck.wait()
    assert ck.latest_step() == 7
    r7, man = ck.restore(_state(0))
    _assert_trees_bit_equal(r7, s7)
    assert man["extra"] == {"data_step": 7} and ck.restore_manifest()["step"] == 7
    r1, _ = ck.restore(_state(0), step=1)
    _assert_trees_bit_equal(r1, s1)
    assert r1["params"]["attn"]["wq"].dtype == torch.bfloat16
    assert r1["opt"]["step"].dtype == torch.int32 and r1["opt"]["step"].item() == 3
    # the format: raw uint16 bits named in bit_dtypes, keys the "/" paths
    path = tmp_path / "ck" / "step_00000007"
    man = json.loads((path / "manifest.json").read_text())
    assert man["bit_dtypes"]["params/attn/wq"] == "bfloat16"
    assert man["leaves"] == sorted(flatten_with_paths(s7))
    with np.load(path / "arrays.npz") as data:
        assert data["params/attn/wq"].dtype == np.uint16
        np.testing.assert_array_equal(data["params/attn/wq"],
                                      _bits(s7["params"]["attn"]["wq"]))
    # a step directory without its manifest is not a checkpoint
    os.makedirs(tmp_path / "ck" / "step_00000009")
    assert ck.latest_step() == 7
    with pytest.raises(NotImplementedError, match="item 10"):
        ck.restore(_state(0), shardings={})


def test_async_save_holds_the_state_at_save_time(tmp_path, monkeypatch):
    """``save(blocking=False)`` writes the state as it was when ``save``
    returned, while training goes on updating it in place (AdamW writes m,
    v and master in place). The write is held until the state has been
    changed, so a save that kept views of the live tensors would fail
    every time, not only when the thread loses a race."""
    import threading
    go, savez = threading.Event(), np.savez

    def held_savez(*args, **kwargs):
        assert go.wait(60)
        return savez(*args, **kwargs)

    monkeypatch.setattr(np, "savez", held_savez)
    ck = Checkpointer(str(tmp_path / "ck"))
    state = _state(3)
    want = {k: _bits(v).copy() for k, v in flatten_with_paths(state).items()}
    ck.save(1, state, blocking=False)
    step = make_train_step(t_smoke(ARCH), AdamWConfig(lr=1e-3))
    batch = PretrainMixture(vocab=t_smoke(ARCH).vocab, seq_len=16, batch=2).batch_at(0)
    step(state["params"], state["opt"], batch)          # m, v, master in place
    for v in flatten_with_paths(state["params"]).values():
        v.add_(1)
    assert not np.array_equal(_bits(state["opt"]["master"]["attn"]["wq"]),
                              want["opt/master/attn/wq"])
    go.set()
    ck.wait()
    got, _ = ck.restore(_state(0))
    for k, v in flatten_with_paths(got).items():
        np.testing.assert_array_equal(_bits(v), want[k], err_msg=k)


def test_checkpoints_cross_read_with_reference(tmp_path):
    cfg = get_smoke_config(ARCH)
    jp = jlm.init_params(cfg, jax.random.PRNGKey(0))
    jo = jadamw.init(jp)
    jo["m"] = jax.tree.map(lambda x: x + 0.25, jo["m"])
    jo["step"] = jnp.int32(5)
    jstate = {"params": jp, "opt": jo}
    # JAX writes, the port reads
    JCheckpointer(str(tmp_path / "j")).save(5, jstate, extra={"data_step": 5})
    tstate, man = Checkpointer(str(tmp_path / "j")).restore(_state(0))
    assert man["extra"]["data_step"] == 5
    _assert_trees_bit_equal(tstate, jstate)
    # the port writes, JAX reads
    mine = _state(3)
    Checkpointer(str(tmp_path / "t")).save(11, mine, extra={"data_step": 11})
    back, man = JCheckpointer(str(tmp_path / "t")).restore(jstate)
    assert man["step"] == 11 and back["params"]["attn"]["wq"].dtype == jnp.bfloat16
    _assert_trees_bit_equal(back, mine)


def _train(tcfg, params, opt, data, step_fn, start, n):
    for i in range(start, start + n):
        params, opt, _ = step_fn(params, opt, data.batch_at(i), i)
    return params, opt


def test_failure_restart_bitexact(tmp_path):
    """Kill mid-training, restore, continue: bitwise identical to no failure."""
    tcfg = t_smoke(ARCH)
    data = PretrainMixture(vocab=tcfg.vocab, seq_len=16, batch=4)
    step_fn = make_train_step(tcfg, AdamWConfig(lr=1e-3))

    def fresh():
        params = tlm.init_params(tcfg, 0, device="cpu")
        return params, adamw.init(params)

    p_ref, o_ref = _train(tcfg, *fresh(), data, step_fn, 0, 6)
    ck = Checkpointer(str(tmp_path / "ck"))
    p1, o1 = _train(tcfg, *fresh(), data, step_fn, 0, 3)
    ck.save(3, {"params": p1, "opt": o1}, extra={"data_step": 3})
    del p1, o1   # crash
    p0, o0 = fresh()
    state, manifest = ck.restore({"params": p0, "opt": o0})
    assert manifest["extra"]["data_step"] == 3
    p2, o2 = _train(tcfg, state["params"], state["opt"], data, step_fn,
                    manifest["extra"]["data_step"], 3)
    _assert_trees_bit_equal({"params": p2, "opt": o2}, {"params": p_ref, "opt": o_ref})


def test_launcher_resume_bitexact(tmp_path, capsys):
    """``launch/train.py`` with ``--ckpt-dir``/``--ckpt-every``: a run cut
    after its step-3 checkpoint and resumed with ``--resume`` ends in the
    uninterrupted run's step-6 checkpoint, to the bit, with its losses."""
    args = ["--device", "cpu", "--steps", "6", "--batch", "4", "--seq", "16",
            "--ckpt-every", "3", "--log-every", "1"]
    full = train_cli.main(args + ["--ckpt-dir", str(tmp_path / "a")])
    os.makedirs(tmp_path / "b")
    shutil.copytree(tmp_path / "a" / "step_00000003", tmp_path / "b" / "step_00000003")
    resumed = train_cli.main(args + ["--ckpt-dir", str(tmp_path / "b"), "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 3" in out and "step     5 loss" in out
    assert resumed["start"] == 3 and resumed["losses"] == full["losses"][3:]
    with np.load(tmp_path / "a" / "step_00000006" / "arrays.npz") as a, \
            np.load(tmp_path / "b" / "step_00000006" / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with pytest.raises(NotImplementedError, match="item 10"):
        train_cli.main(["--device", "cpu", "--data", "2"])
