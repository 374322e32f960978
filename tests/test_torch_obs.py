"""Parity of the port's observability plane (``repro_torch.obs``) with
``repro.obs`` on the CPU: the same observations give the same quantiles,
snapshots and Prometheus exposition text; the trace header, spans and the
slow-query log behave alike; the disabled hub records nothing; and the
mining hooks (``PipelineMiner(obs=...)``, ``mine_chunked``,
``mine_windowed``) fill the JAX package's histograms, counters, gauges
and span, series for series.  Modelled on ``tests/test_obs.py``; its
three HTTP tests wait for the port's protocol module (ROADMAP A10b)."""
import math
import threading

import numpy as np
import pytest

import repro.obs as J
import repro_torch.obs as T
from repro.core import BatchMiner as JBatch
from repro.core import NOACMiner as JNOAC
from repro.data import synthetic as JS
from repro_torch.core import BatchMiner, NOACMiner
from repro_torch.data import synthetic as TS


def _samples(seed, n=2000):
    rng = np.random.default_rng(seed)
    return rng.lognormal(mean=2.0, sigma=1.2, size=n).tolist()


def _drive(obs_mod, samples):
    """One registry fed the same operations, collectors included."""
    reg = obs_mod.Registry()
    for i, v in enumerate(samples):
        reg.histogram("lat_ms", route="/q" if i % 3 else "/b").observe(v)
        reg.counter("hits", worker=i % 2).inc()
        reg.gauge("depth").set(i % 7)
    reg.histogram("narrow", lo=1.0, hi=10.0).observe(0.0)
    reg.histogram("narrow", lo=1.0, hi=10.0).observe(1e6)
    reg.counter("bytes").inc(12.5)
    reg.gauge("level", shard=2).add(3.0)
    reg.register_collector(lambda: [
        ("stat_a", {"role": "writer"}, 3), ("stat_inf", {}, float("inf")),
        ("stat_str", {}, "nope"), ("stat_flag", {}, True)])
    return reg


@pytest.mark.parametrize("seed", [7, 8])
def test_exposition_text_and_dict_equal(seed):
    samples = _samples(seed)
    jr, tr = _drive(J, samples), _drive(T, samples)
    assert tr.expose() == jr.expose()
    assert tr.to_dict() == jr.to_dict()
    # histogram observations, plus one per counter and gauge series
    assert tr.sample_count() == jr.sample_count() == len(samples) + 7


def test_histogram_quantiles_and_bounds_equal():
    samples = _samples(3, 5000)
    jh, th = J.Histogram(), T.Histogram()
    for v in samples:
        jh.observe(v)
        th.observe(v)
    assert th.snapshot() == jh.snapshot()
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert th.quantile(q) == jh.quantile(q)
    assert th.percentiles() == jh.percentiles()
    # the documented error bound against the exact order statistic
    exact = np.sort(samples)
    tol = math.sqrt(th.ratio) - 1.0
    for q in (0.1, 0.5, 0.9, 0.99):
        want = float(exact[int(math.floor(q * (len(exact) - 1)))])
        assert abs(th.quantile(q) - want) / want <= tol + 1e-9
    empty = T.Histogram()
    assert empty.quantile(0.5) is None
    with pytest.raises(ValueError):
        empty.quantile(1.5)
    assert (T.DEFAULT_BUCKET_RATIO, T.TRACE_HEADER) == (
        J.DEFAULT_BUCKET_RATIO, J.TRACE_HEADER)


def test_concurrent_writers_lose_nothing():
    reg = T.Registry()

    def work(i):
        for j in range(300):
            reg.counter("hits", worker=i % 2).inc()
            reg.histogram("lat_ms").observe(float(j + 1))

    threads = [threading.Thread(target=work, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert (reg.counter("hits", worker=0).value
            + reg.counter("hits", worker=1).value) == 1800
    assert reg.histogram("lat_ms").count == 1800
    with pytest.raises(ValueError):
        reg.gauge("hits")


def test_trace_header_spans_and_slow_log_alike():
    for mod in (J, T):
        assert mod.parse_trace_header(
            mod.format_trace_header("ab12", "cd34")) == ("ab12", "cd34")
    for bad in (None, "", 42, "XYZ/1", "/orphan", "  /  ", "ab12"):
        assert T.parse_trace_header(bad) == J.parse_trace_header(bad)
    views = []
    for mod in (J, T):
        tr = mod.Tracer(service="t", ring=16)
        with tr.span("root") as root:
            tr.start("child", trace_id=root.trace_id,
                     parent_id=root.span_id).set("k", 1).finish()
        spans = tr.spans(root.trace_id)
        with pytest.raises(KeyError):
            with tr.span("boom"):
                raise KeyError("k")
        (boom,) = [s for s in tr.spans() if s["name"] == "boom"]
        for _ in range(40):
            with tr.span("filler"):
                pass
        views.append(([s["name"] for s in spans],
                      [s["attrs"] for s in spans], boom["status"],
                      len(tr), tr.dropped))
        log = mod.SlowQueryLog(threshold_ms=10.0, keep=3)
        log.record("/query", 5.0)
        for ms in (20.0, 40.0, 30.0, 50.0, 25.0):
            log.record("/query", ms, handler_ms=ms - 1.0, wait_ms=1.0,
                       trace_id=f"t{int(ms)}", coverage=[0, 1])
        views.append(([{k: v for k, v in e.items() if k != "wall"}
                       for e in log.entries()], log.stats()))
    assert views[2] == views[0] and views[3] == views[1]
    assert views[2][0] == ["child", "root"]
    assert views[2][2:4] == ("error", 16)


def test_null_obs_records_nothing():
    obs = T.NULL_OBS
    assert not obs.enabled and T.Obs.disabled() is obs
    assert isinstance(obs.metrics.counter("never"), T.NullInstrument)
    obs.metrics.counter("never").inc()
    obs.metrics.histogram("h").observe(1.0)
    obs.metrics.gauge("g").set(9.0)
    assert obs.metrics.sample_count() == 0 and obs.metrics.expose() == ""
    sp = obs.tracer.start("x")
    assert sp.set("a", 1).error("boom") is sp and sp.header() is None
    sp.finish()
    assert len(obs.tracer) == 0
    assert not obs.slow.record("/query", 1e9)
    assert T.Obs.create(service="s").describe() == J.Obs.create(
        service="s").describe()


def _series(reg, skip=("pipeline_window_peak_bytes",)):
    """{name: (kind, [(labels, histogram count | value)])} — the clock-
    free content of a registry (peak bytes are the process's RSS on the
    CPU, so only their labels compare)."""
    out = {}
    for name, ent in reg.to_dict().items():
        rows = []
        for row in ent["series"]:
            if ent["kind"] == "histogram":
                rows.append((row["labels"], row["count"]))
            else:
                rows.append((row["labels"],
                             None if name in skip else row["value"]))
        out[name] = (ent["kind"], sorted(rows, key=repr))
    return out


def _span_view(tracer):
    return [(s["name"], sorted(s["attrs"]),
             {k: v for k, v in s["attrs"].items()
              if k in ("rows", "modes", "budget", "windows",
                       "seam_carries")})
            for s in tracer.spans()]


@pytest.mark.parametrize("variant", ["prime", "noac"])
def test_mining_hooks_fill_the_jax_series(variant):
    """``__call__``, ``mine_chunked`` and ``mine_windowed`` (two budgets)
    on one hub each: the same histogram series with the same counts, the
    same seam-carry count, window gauges and span attributes."""
    if variant == "prime":
        jctx = JS.random_context((9, 8, 7), 160, seed=8)
        tctx = TS.random_context((9, 8, 7), 160, seed=8)
        jm, tm = JBatch(jctx.sizes), BatchMiner(tctx.sizes, device="cpu")
        args = (tctx.tuples,)
    else:
        jctx = JS.random_context((8, 7, 6), 120, seed=9,
                                 values=True).deduplicated()
        tctx = TS.random_context((8, 7, 6), 120, seed=9,
                                 values=True).deduplicated()
        jm = JNOAC(jctx.sizes, delta=40.0)
        tm = NOACMiner(tctx.sizes, delta=40.0, device="cpu")
        args = (tctx.tuples, tctx.values)
    jm.obs, tm.obs = J.Obs.create(), T.Obs.create()
    kw = {} if len(args) == 1 else {"values": args[1]}
    for m in (jm, tm):
        m(*args)
        m.mine_chunked(args[0], chunk_budget=50, **kw)
        for budget in (37, None):
            m.mine_windowed(args[0], window_budget=budget, **kw)
    got, want = _series(tm.obs.metrics), _series(jm.obs.metrics)
    assert got == want
    assert got["pipeline_stage_ms"][1][0] == (
        {"stage": "device_mine"}, 1)
    if variant == "prime":      # budget 37 splits a key segment
        assert got["pipeline_seam_carries_total"][1][0][1] > 0
    peaks = tm.obs.metrics.to_dict()["pipeline_window_peak_bytes"]
    assert sorted(r["labels"]["stage"] for r in peaks["series"]) == [
        "stage1_scan", "stage2_mix", "stage3_sort"]
    assert _span_view(tm.obs.tracer) == _span_view(jm.obs.tracer)
    assert [s["name"] for s in tm.obs.tracer.spans()] == \
        ["pipeline.windowed"] * 2
