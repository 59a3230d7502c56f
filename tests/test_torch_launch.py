"""The port's launchers added with its tooling, on the CPU at smoke size:
``launch/multi_tenant_serving.py`` (the twin of
``examples/multi_tenant_serving.py``) and ``launch/serve.py
--strict-compile``. Exact: token streams and counts."""
import argparse

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import multi_tenant_serving  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402


def test_multi_tenant_serving_streams_request0(capsys):
    """Every tenant's requests are served; request 0's tokens reach its
    on_token callback one by one and equal its output; tenants generate
    differently for one prompt; the memory ledger prints."""
    ap = ["--device", "cpu", "--tenants", "3", "--requests", "6", "--slots", "3"]
    assert multi_tenant_serving.main(ap) == 0
    out = capsys.readouterr().out
    assert out.count("[stream r0] token") == multi_tenant_serving.MAX_NEW
    assert "memory ledger: base" in out and "distinct generations" in out
    args = argparse.Namespace(device="cpu", tenants=3, requests=6, slots=3)
    res = multi_tenant_serving.run(args)
    np.testing.assert_array_equal(np.asarray(res["streamed"]), res["request0"])
    rep = res["report"]
    assert rep["prefills"] == 6 and rep["total_tokens"] == 6 * multi_tenant_serving.MAX_NEW
    assert sorted(rep["tenants"]) == ["tenant0", "tenant1", "tenant2"]
    assert res["distinct"] >= 2


@pytest.mark.parametrize("extra", [[], ["--chunked", "--check-identity"],
                                   ["--lifecycle", "--tenants", "3"]])
def test_serve_strict_compile(capsys, extra):
    """``--strict-compile``: a strict CompileGuard rides the serving engine
    (and the lifecycle drill's post-warm-up gate) without a retrace."""
    assert serve_cli.main(["--device", "cpu", "--strict-compile", "--requests", "6",
                           "--max-new", "4", *extra]) == 0
    out = capsys.readouterr().out
    if "--lifecycle" in extra:
        assert "decode-step jit_trace events across register/rollout/retire: 0; " \
            "re-stacks: 0; CompileGuard {'decode': {'total': 1, 'new': 0}" in out


def test_strict_compile_raises_on_a_retrace(monkeypatch):
    """The serving engine under --strict-compile raises at a retrace: the
    stream's decode signature is recorded with new stack shapes."""
    from repro_torch.analysis import CompileBudgetError
    from repro_torch.serve import engine as engine_mod
    real = engine_mod.ContinuousEngine._group_shapes
    calls = {"n": 0}

    def shifting(self):
        calls["n"] += 1
        return real(self) + ((calls["n"] // 4,),)
    monkeypatch.setattr(engine_mod.ContinuousEngine, "_group_shapes", shifting)
    with pytest.raises(CompileBudgetError, match="retrace outside warmup"):
        serve_cli.main(["--device", "cpu", "--strict-compile", "--requests", "6",
                        "--max-new", "6"])
