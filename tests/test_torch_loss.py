"""``lm.loss_fn`` of the port against the JAX reference at every
registered smoke config (dense, moe, ssm, hybrid, encdec, vlm), with and
without ``labels``/``loss_mask``.

Params come from the reference's init through ``tests/torch_bridge.py``.
Stated tolerance: rel 1e-4 (bf16 weights, f32 residual stream: the
logits agree within 1e-3, ``test_torch_model.py``, and the mean over
tokens averages that down); rel 1e-3 for seamless-m4t-medium, whose
encoder residual is bf16 (``test_torch_encdec.py`` holds its logits to
``ENC_BF16_TOL``, rtol 1e-3, for the same reason).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_smoke_config, list_archs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402

from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402

import torch_bridge as br  # noqa: E402

LOSS_RTOL = 1e-4
ENC_BF16_RTOL = 1e-3

j_loss = jax.jit(jlm.loss_fn, static_argnums=0, static_argnames="remat")


def _port_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _batch(cfg, B, S, seed, labels: bool):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if labels:
        b["labels"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
        b["loss_mask"] = (rng.random((B, S)) < 0.7).astype(np.float32)
    if cfg.family == "encdec":
        b["enc_feats"] = rng.standard_normal((B, 8, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        b["image_embeds"] = rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    return b


@pytest.mark.parametrize("arch", list_archs())
def test_loss_fn_matches_reference(arch):
    cfg = get_smoke_config(arch)
    jp = jlm.init_params(cfg, jax.random.PRNGKey(0))
    tp = br.params_to_port(jp)
    tcfg = t_smoke(arch)
    S = 16
    rtol = ENC_BF16_RTOL if cfg.family == "encdec" else LOSS_RTOL
    for labels in (False, True):
        b = _batch(cfg, 2, S, 5, labels)
        jl, jm = j_loss(cfg, jp, b)
        tl, tm = tlm.loss_fn(tcfg, tp, _port_batch(b))
        assert tl.dtype == torch.float32 and tl.shape == ()
        np.testing.assert_allclose(tl.item(), float(jl), rtol=rtol, err_msg=arch)
        assert tm["loss"] is tl and tm["tokens"].item() == float(jm["tokens"])
    # no labels: the last position is masked; labels without a mask: all count
    assert tlm.loss_fn(tcfg, tp, _port_batch(_batch(cfg, 2, S, 5, False)))[1][
        "tokens"].item() == 2 * (S - 1)
    b = _batch(cfg, 2, S, 6, True)
    del b["loss_mask"]
    assert tlm.loss_fn(tcfg, tp, _port_batch(b))[1]["tokens"].item() == 2 * S
