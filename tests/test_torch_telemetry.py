"""The port's copies of the serving telemetry against the reference's.

``repro_torch.serve.{telemetry,metrics}`` are copies of the reference's
numpy-only modules: on the same samples and the same event stream,
``StreamingHistogram``, ``SLOCounters``, ``prometheus_text``,
``TelemetrySnapshotWriter`` and ``Metrics`` must give the reference's
outputs exactly. The port's engine drives them in
``tests/test_torch_serve.py``.
"""
import numpy as np
import pytest

from repro.serve import metrics as j_metrics
from repro.serve import telemetry as j_tel
from repro.serve import trace as j_trace

from repro_torch.serve import metrics as t_metrics
from repro_torch.serve import telemetry as t_tel
from repro_torch.serve import trace as t_trace


def _samples(n, seed):
    return np.random.default_rng(seed).lognormal(-4.0, 1.5, n)


@pytest.mark.parametrize("n,exact_cap", [(0, 1024), (7, 1024), (300, 1024),
                                         (2500, 1024), (50, 16)])
def test_streaming_histogram_matches_reference(n, exact_cap):
    """Exact regime, spilled-to-buckets regime and a merge of the two."""
    xs = _samples(n, n)
    j = j_tel.StreamingHistogram(exact_cap=exact_cap)
    t = t_tel.StreamingHistogram(exact_cap=exact_cap)
    for x in xs:
        j.record(float(x))
        t.record(float(x))
    for q in (0, 1, 50, 90, 95, 99, 100):
        assert t.percentile(q) == j.percentile(q)
    assert t.mean == j.mean and t.exact == j.exact
    assert np.array_equal(t.bucket_counts(), j.bucket_counts())
    assert t.to_dict() == j.to_dict()
    assert t.cumulative() == j.cumulative()
    other = _samples(40, 99)
    jm = j_tel.StreamingHistogram.merged([j, j_tel.StreamingHistogram()])
    tm = t_tel.StreamingHistogram.merged([t, t_tel.StreamingHistogram()])
    for x in other:
        jm.record(float(x))
        tm.record(float(x))
    assert tm.to_dict() == jm.to_dict()
    assert tm.percentile(95) == jm.percentile(95)


def _events(seed):
    """A serve event stream: three tenants, deadlines, a jit trace, steps
    on two decode paths and lifecycle events."""
    rng = np.random.default_rng(seed)
    evs = [("start", 0.0, {}),
           ("tenant_register", 0.0, {"tenant": "a", "row": 1}),
           ("jit_trace", 0.001, {"signature": ("decode", 1, False)})]
    t = 0.001
    for rid in range(9):
        tenant = [None, "a", "b"][rid % 3]
        arrival = 0.002 * rid
        t += float(rng.uniform(1e-3, 5e-3))
        evs.append(("admit", t, {"rid": rid, "tenant": tenant,
                                 "wait": t - arrival}))
        ttft = t + 1e-3 - arrival
        evs.append(("first_token", t + 1e-3, {"rid": rid, "tenant": tenant,
                                              "ttft": ttft}))
        n = int(rng.integers(1, 6))
        for k in range(n):
            tk = t + 1e-3 * (k + 1)
            evs.append(("token", tk, {"rid": rid, "tenant": tenant}))
            evs.append(("step", tk, {"n_active": int(rng.integers(1, 4)),
                                     "path": "segments-x" if k % 2 else "base"}))
        done = t + 1e-3 * n
        deadline = None if rid % 2 else arrival + 0.004
        evs.append(("done", done, {"rid": rid, "tenant": tenant,
                                   "latency": done - arrival, "ttft": ttft,
                                   "n_tokens": n, "deadline_slack":
                                   None if deadline is None else deadline - done}))
    evs.append(("tenant_retire", t, {"tenant": "a"}))
    evs.append(("stop", t + 0.01, {}))
    return evs


def _feed(trace_mod, consumers, evs):
    for kind, t, attrs in evs:
        ev = trace_mod.ServeEvent(kind, t, dict(attrs))
        for c in consumers:
            c.consume(ev)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_slo_and_prometheus_match_reference(seed, tmp_path):
    evs = _events(seed)
    jm, jslo = j_metrics.Metrics(4), j_tel.SLOCounters(ttft_target_s=2e-3,
                                                       itl_target_s=1e-3)
    tm, tslo = t_metrics.Metrics(4), t_tel.SLOCounters(ttft_target_s=2e-3,
                                                       itl_target_s=1e-3)
    _feed(j_trace, [jm, jslo], evs)
    _feed(t_trace, [tm, tslo], evs)
    assert tm.report() == jm.report()
    assert tm.jit_traces == jm.jit_traces == 1
    assert tslo.report() == jslo.report()
    assert t_tel.prometheus_text(tm, tslo) == j_tel.prometheus_text(jm, jslo)
    # the snapshot writer: same files for the same engine times
    paths = {}
    for name, mod, m, slo in (("j", j_tel, jm, jslo), ("t", t_tel, tm, tslo)):
        paths[name] = tmp_path / f"{name}.json"
        w = mod.TelemetrySnapshotWriter(str(paths[name]), 0.005)
        wrote = [w.maybe_write(now, lambda: {"metrics": m.report(),
                                             "slo": slo.report()})
                 for now in (0.0, 0.002, 0.006, 0.0105)]
        assert wrote == [True, False, True, False]
    assert paths["t"].read_text() == paths["j"].read_text()


def test_metrics_data_shards_and_bad_rows_match_reference():
    jm, tm = j_metrics.Metrics(4, data_shards=2), t_metrics.Metrics(4, data_shards=2)
    for m in (jm, tm):
        m.start(0.0)
        m.record_step(3, shard_active=[2, 1], shard_unique=[1, 1])
        m.record_step(2, shard_active=[1, 1], shard_unique=[1, 0],
                      residency_used=True)
        m.record_shard_token(1, 3)
        m.stop(0.5)
        with pytest.raises(ValueError):
            m.record_step(1, shard_active=[1])
        with pytest.raises(ValueError):
            m.record_shard_token(2)
    assert tm.report() == jm.report()
