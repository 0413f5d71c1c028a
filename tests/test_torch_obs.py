"""The port's observability layer against ``repro``'s, at TOY size on the CPU.

- ``repro_torch.obs`` copies: the same instrument updates give the same
  ``MetricsRegistry`` summaries and percentiles, the same spans give the
  same Chrome trace events (names, categories, args, nesting; pids aside)
  and text summary as ``repro.obs``.
- ``HealthMonitor``: the same loss sequences fed to both packages' monitors
  raise at the same index (NaN, Inf, z-score divergence); a paced trainer
  whose step sleeps past ``stall_timeout_s`` raises ``RunStalledError`` and
  leaves a flight record.
- Attribution: ``TrainResult.attribution`` has ``repro``'s keys and phase
  counts; a run with attribution, telemetry and health on has the same
  losses, bitwise, as one with them off (host sparse, host dense, fused;
  deterministic algorithms); the mp engine with all three hooks on.
- Traced recall and serving: ``evaluate_recall(telemetry=)`` gives a span
  per corpus search, histogram counts equal to the searches and the
  untraced metrics; a traced ``BatchedServer`` gives the untraced outputs
  with one ``serve.batch`` span per batch.
- Memory accounting on the CPU reports zeros and says so.
"""
import math
import os
import time

import numpy as np
import pytest
import torch

import repro.obs as jobs
from repro.graph import TOY as JTOY
from repro.graph import generate as jgenerate
from repro_torch import obs as tobs
from repro_torch.core.recall import evaluate_recall
from repro_torch.graph import TOY as TTOY
from repro_torch.graph import generate as tgenerate
from repro_torch.obs import memory as tmemory
from repro_torch.train import attribution as tattr
from test_torch_fused import _port_trainer
from test_torch_train import _trainer

pytestmark = pytest.mark.quick


@pytest.fixture(scope="module")
def both():
    return jgenerate(JTOY, seed=0), tgenerate(TTOY, seed=0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the allocator counters and CUDA events exist there only")
    return torch.device("cuda")


@pytest.fixture
def deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


# -------------------------------------------------------------- the copies
def _drive_metrics(mod):
    reg = mod.MetricsRegistry()
    reg.counter("a").inc()
    reg.counter("a").inc(4)
    reg.counter("b")
    reg.gauge("g").set(3.5)
    reg.gauge("g").set(1.0)
    h = reg.histogram("lat")
    rng = np.random.default_rng(0)
    for v in rng.lognormal(12.0, 2.0, 500):
        h.observe(float(v))
    hb = reg.histogram("small", buckets=(1.0, 2.0, 5.0))
    for v in (0.5, 1.0, 1.5, 3.0, 7.0, 9.0):
        hb.observe(v)
    return reg


def test_metrics_registry_matches_repro():
    j, t = _drive_metrics(jobs), _drive_metrics(tobs)
    assert t.summary() == j.summary()
    for name in ("lat", "small"):
        for p in (0.0, 1.0, 25.0, 50.0, 90.0, 99.0, 99.9, 100.0):
            assert t.histogram(name).percentile(p) == j.histogram(name).percentile(p)
    assert tobs.DEFAULT_NS_BUCKETS == jobs.DEFAULT_NS_BUCKETS
    with pytest.raises(ValueError):
        tobs.Histogram("bad", buckets=(2.0, 1.0))


def _drive_tracer(mod):
    tr = mod.Tracer(capacity=4, process_name="trainer")
    tr.add_span("outer", "trainer", 1_000, 10_000, {"step": 1})
    tr.add_span("inner", "phase", 2_000, 3_000)
    tr.add_span("retrieval.item", "retrieval", 20_000, 5_000, {"method": "device", "queries": 3})
    for i in range(5):  # past capacity: drops
        tr.add_span("dispatch", "phase", 30_000 + 100 * i, 50)
    tr.ingest("worker", 4242, [("serve", "worker", 40_000, 1_000, {"rid": 7})],
              offset_ns=500, dropped=2)
    return tr


def _strip(events):
    return [{k: v for k, v in e.items() if k != "pid"} for e in events]


def test_chrome_trace_and_summary_match_repro():
    j, t = _drive_tracer(jobs), _drive_tracer(tobs)
    jt, tt = jobs.chrome_trace(j), tobs.chrome_trace(t)
    assert _strip(tt["traceEvents"]) == _strip(jt["traceEvents"])
    assert tt["otherData"] == jt["otherData"] and tt["displayTimeUnit"] == "ms"
    assert tobs.text_summary(t) == jobs.text_summary(j)
    assert t.span_count() == j.span_count() and t.dropped_count() == j.dropped_count() == 6


def test_nested_spans_match_repro():
    """Real nested ``span`` contexts: the same names, categories, args and
    containment in both packages' exports."""
    def drive(mod):
        tel = mod.Telemetry()
        with tel.span("step", step=3):
            with tel.span("dispatch", cat="phase"):
                pass
            with mod.span_scope(tel.tracer, "loss_fetch", cat="phase", window=2):
                pass
        tel.tracer.mark("prefetch.wedged_producer", where="close")
        return [e for e in tel.chrome_trace()["traceEvents"] if e["ph"] in ("X", "i")]

    def shape(events):
        xs = [e for e in events if e["ph"] == "X"]
        inside = {(a["name"], b["name"]) for a in xs for b in xs if a is not b
                  and a["ts"] <= b["ts"] and b["ts"] + b["dur"] <= a["ts"] + a["dur"]}
        return ([(e["ph"], e["name"], e["cat"], e.get("args")) for e in events], inside)

    jshape, tshape = shape(drive(jobs)), shape(drive(tobs))
    assert tshape == jshape
    assert ("step", "dispatch") in tshape[1] and ("step", "loss_fetch") in tshape[1]
    assert tobs.span_scope(None, "x") is tobs.span_scope(None, "y")


def test_duration_ring_and_phase_timer_total_match_repro():
    jr, tr = jobs.DurationRing(4), tobs.DurationRing(4)
    for v in (1.0, 2.0, 3.0, 4.0, 5.0, 6.0):
        jr.add(v)
        tr.add(v)
    assert tr.total() == jr.total() and tr.count == jr.count == 6
    from repro.train import attribution as jattr
    jt, tt = jattr.PhaseTimer(capacity=3), tattr.PhaseTimer(capacity=3)
    for v in (0.1, 0.2, 0.3, 0.4):
        jt.add("dispatch", v)
        tt.add("dispatch", v)
    js, ts = jt.summary(2.0, 4), tt.summary(2.0, 4)
    assert {k: v for k, v in ts.items() if k != "thread_cpu_s"} == js
    assert tattr.median([3.0, 1.0, 2.0, 4.0]) == jattr.median([3.0, 1.0, 2.0, 4.0]) == 2.5
    assert tattr.measure_handoff_overhead(items=64) > 0.0


def test_phase_timer_records_thread_cpu_time():
    timer = tattr.PhaseTimer()
    with timer.phase("dispatch"):
        time.sleep(0.05)  # wall without CPU
    with timer.phase("assemble"):
        c_end = time.thread_time() + 0.03
        while time.thread_time() < c_end:  # CPU on this thread
            pass
    s = timer.summary(0.2, 1)
    assert s["phases"]["dispatch"]["total_s"] >= 0.05
    assert s["thread_cpu_s"]["dispatch"] < 0.02
    assert s["thread_cpu_s"]["assemble"] >= 0.03
    assert "device_span" not in s  # no CUDA events off the card
    with timer.device_span():  # a no-op on the CPU
        pass


# ------------------------------------------------------------------- health
def _health_cfg(mod, tmp_path, **kw):
    base = dict(stall_timeout_s=60.0, poll_interval_s=0.01, worker_heartbeat_s=0.0,
                divergence_window=8, flightrec_dir=str(tmp_path))
    base.update(kw)
    return mod.HealthConfig(**base)


def _first_raise(mod, values, tmp_path):
    mon = mod.HealthMonitor(_health_cfg(mod, tmp_path))
    for i, v in enumerate(values):
        try:
            mon.observe_losses((v,))
        except mod.LossAnomalyError as e:
            assert os.path.isfile(os.path.join(e.flightrec, "health.json"))
            return i
    return None


HEALTH_SEQS = {
    "nan": [5.5 - 0.01 * i for i in range(20)] + [math.nan] + [5.0] * 3,
    "inf": [5.5] * 3 + [math.inf],
    "neg-inf": [5.5 - 0.02 * i for i in range(10)] + [-math.inf],
    "divergence": [5.5 - 0.01 * i + 0.002 * (-1) ** i for i in range(30)] + [9.0],
    "realistic-decay": [5.5 * math.exp(-0.01 * i) + 0.003 * math.sin(i) for i in range(200)],
}


@pytest.mark.parametrize("name", list(HEALTH_SEQS))
def test_health_raises_at_the_same_index_as_repro(name, tmp_path):
    seq = HEALTH_SEQS[name]
    j = _first_raise(jobs, seq, tmp_path / "repro")
    t = _first_raise(tobs, seq, tmp_path / "port")
    assert t == j
    assert (t is None) == (name == "realistic-decay")


def test_paced_trainer_stall_raises_and_flight_records(both, tmp_path):
    """A step that sleeps past ``stall_timeout_s``: the watchdog dumps a
    flight record and the loop raises ``RunStalledError`` at the next beat."""
    tel = tobs.Telemetry()
    tr = _trainer("port", both[1], False, steps=6, telemetry=tel,
                  health=_health_cfg(tobs, tmp_path, stall_timeout_s=0.15))
    real = tr._dense_step

    def slow(params, opt_state, batch):
        out = real(params, opt_state, batch)
        if tr._health_monitor._last_step >= 1:
            time.sleep(0.6)
        return out

    tr._dense_step = slow
    with pytest.raises(tobs.RunStalledError) as err:
        tr.train()
    rec = err.value.flightrec
    assert rec and os.path.basename(rec).endswith("-stall")
    for f in ("stacks.txt", "health.json", "trace.json"):
        assert os.path.isfile(os.path.join(rec, f)), f
    assert tel.metrics.summary()["counters"]["health.stalls"] == 1
    assert tr._health_monitor._thread is None  # stopped in train()'s finally


# ---------------------------------------------------------------- attribution
def _all_hooks(tmp_path):
    return dict(attribution=True, telemetry=tobs.Telemetry(),
                health=_health_cfg(tobs, tmp_path, stall_timeout_s=600.0))


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
def test_attribution_has_repros_keys_and_counts(both, sparse):
    kw = dict(steps=10, prefetch_batches=2, attribution=True)
    ja = _trainer("repro", both[0], sparse, **kw).train().attribution
    ta = _trainer("port", both[1], sparse, **kw).train().attribution
    assert set(ta) - set(ja) == {"thread_cpu_s"}  # device_span only on CUDA
    assert set(ja) <= set(ta)
    assert set(ta["phases"]) == set(ja["phases"]) == set(tattr.PHASES) - {"loss_fetch"}
    for p, entry in ta["phases"].items():
        assert set(entry) == set(ja["phases"][p])
        assert entry["count"] == ja["phases"][p]["count"], p
    for p in ("assemble", "h2d", "dispatch"):
        assert ta["phases"][p]["count"] == ta["steps"] == 10
    assert set(ta["thread_cpu_s"]) == set(ta["phases"])


@pytest.mark.parametrize("case", ["host-sparse", "host-dense", "fused"])
def test_hooks_leave_losses_bitwise(both, case, deterministic, tmp_path):
    def run(**hooks):
        if case == "fused":
            tr = _port_trainer(both[1], "fused", 12, **hooks)
        else:
            tr = _trainer("port", both[1], case == "host-sparse", steps=12,
                          prefetch_batches=2, loss_fetch_every=4, **hooks)
        return tr, tr.train()

    _, off = run()
    tr, on = run(**_all_hooks(tmp_path))
    assert on.losses == off.losses and len(on.losses) == 12
    for k in off.params:
        assert torch.equal(on.params[k], off.params[k]), k
    a = on.attribution
    assert a["phases"]["dispatch"]["count"] == 12
    assert tr._health_monitor.fault is None and tr._health_monitor._last_step == 11
    tel = tr.cfg.telemetry
    assert tel.tracer.span_count() > 0
    assert tr._memory.peaks.keys() >= {"fused" if case == "fused" else "tables", "steady"}
    if case == "fused":
        assert on.plan["sampling"] == "fused" and "sample" not in a["phases"]
    else:
        assert a["phases"]["loss_fetch"]["count"] >= 1
        assert tel.metrics.summary()["gauges"]["prefetch.queue_depth"]["max"] >= 1


def test_attribution_off_by_default_and_mp_still_raises(both, tmp_path):
    """Attribution is off by default; the mp engine (which no longer raises)
    runs with all three hooks: the monitor holds the client, the host
    phases are attributed and the workers' serve spans reach the tracer."""
    assert _trainer("port", both[1], True, steps=3).train().attribution is None
    hooks = _all_hooks(tmp_path)
    tr = _trainer("port", both[1], True, steps=6, prefetch_batches=2, engine_backend="mp",
                  engine_local_threshold=0, **hooks)
    with tr:
        a = tr.train().attribution
        assert tr._health_monitor._client is tr.engine and tr._health_monitor.fault is None
    assert a["phases"]["sample"]["count"] >= 1 and a["phases"]["dispatch"]["count"] == 6
    workers = [name for name, _, spans, _ in hooks["telemetry"].tracer.foreign() if spans]
    assert set(workers) == {"graph-worker-0", "graph-worker-1"}


def test_fused_fallback_counter_and_mark(both):
    tel = tobs.Telemetry()
    tr = _port_trainer(both[1], "fused", 3, fused_budget_mb=0.0001, telemetry=tel)
    assert tr._fused_sampler is None
    assert tel.metrics.summary()["counters"]["trainer.fused_fallback"] == 1
    assert [m[0] for m in tel.tracer.marks()] == ["trainer.fused_fallback"]


# ------------------------------------------------------------ recall, serving
@pytest.fixture(scope="module")
def toy_emb(both):
    ds = both[1]
    rng = np.random.default_rng(3)
    emb = rng.standard_normal((ds.graph.num_nodes, 16)).astype(np.float32)
    pairs = np.concatenate([np.stack([u, i], 1) for (u, i) in ds.train_edges.values()], 0)
    return ds, emb[: ds.num_users], emb[ds.num_users : ds.num_users + ds.num_items], pairs


@pytest.mark.parametrize("method", ["device", "ivf", "bruteforce"])
def test_traced_recall_equals_untraced(toy_emb, method):
    ds, ue, ie, pairs = toy_emb
    kw = dict(top_k=20, method=method, device="cpu")
    plain = evaluate_recall(ue, ie, pairs, ds.test_pairs, **kw)
    tel = tobs.Telemetry()
    traced = evaluate_recall(ue, ie, pairs, ds.test_pairs, telemetry=tel, **kw)
    assert traced == plain
    spans = [s for _, _, ss, _ in tel.tracer.threads() for s in ss]
    names = sorted(s[0] for s in spans)
    assert names == ["retrieval.item", "retrieval.item", "retrieval.user"]  # u2i, icf, ucf
    assert all(s[1] == "retrieval" and s[4]["method"] == method for s in spans)
    snap = tel.metrics.summary()
    assert snap["histograms"]["retrieval.search_ns"]["count"] == len(spans)
    if method == "ivf":
        assert snap["counters"]["ivf.cells_probed"] > 0
        assert snap["counters"]["ivf.candidates_scored"] > 0
        assert "ivf.spill_events" in snap["counters"]


def test_traced_batched_server_equals_untraced():
    from repro_torch.configs import get_arch
    from repro_torch.serve.engine import BatchedServer, ServeConfig

    spec = get_arch("smollm-135m", reduced=True)
    model = spec.init_params(torch.Generator().manual_seed(0), device="cpu")
    cfg = ServeConfig(batch_size=2, max_new_tokens=4, cache_len=32)
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(0, 100, size=n)) for n in (3, 5, 2, 4, 6)]
    plain = BatchedServer(spec, model, cfg).generate(prompts)
    tel = tobs.Telemetry(process_name="server")
    traced = BatchedServer(spec, model, cfg, telemetry=tel).generate(prompts)
    assert traced == plain
    spans = [s for _, _, ss, _ in tel.tracer.threads() for s in ss]
    assert [s[0] for s in spans] == ["serve.batch"] * 3
    assert [s[4]["requests"] for s in spans] == [2, 2, 1]
    snap = tel.metrics.summary()
    assert snap["counters"]["serve.requests"] == 5
    assert snap["histograms"]["serve.request_ns"]["count"] == 5
    assert snap["gauges"]["serve.queue_depth"] == {"value": 0.0, "max": 5.0}


# ------------------------------------------------------------------- memory
def test_memory_on_cpu_reports_zeros_and_says_so():
    reg = tobs.MetricsRegistry()
    acc = tobs.MemoryAccountant(reg, device="cpu")
    with tmemory.sample_scope(acc, "tables"):
        torch.ones(1024)
    assert acc.sample("steady") == 0 and acc.peaks == {"tables": 0, "steady": 0}
    s = acc.summary()
    assert s["live_array_bytes"] == 0 and s["device_stats"] == {}
    assert "not a measurement" in s["note"]
    assert reg.summary()["gauges"]["memory.tables_bytes"] == {"value": 0.0, "max": 0.0}
    assert tmemory.sample_scope(None, "x").__class__.__name__ == "nullcontext"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tobs.memory_snapshot()


@pytest.mark.cuda
def test_memory_on_the_card_reads_the_allocator(cuda):
    acc = tobs.MemoryAccountant(device="cuda")
    before = acc.sample("a")
    x = torch.empty(1 << 20, device="cuda")
    assert acc.sample("b") >= before + x.numel() * 4
    stats = tobs.device_memory_stats("cuda")
    (name, s), = stats.items()
    assert s["max_memory_allocated"] >= x.numel() * 4 and "note" not in acc.summary()


@pytest.mark.cuda
def test_device_span_on_the_card(cuda):
    timer = tattr.PhaseTimer(device="cuda")
    a = torch.randn(512, 512, device="cuda")
    for _ in range(3):
        with timer.phase("dispatch"), timer.device_span():
            a = a @ a / 512.0
    torch.cuda.synchronize()
    s = timer.summary(0.1, 3)["device_span"]
    assert s["count"] == 3 and s["span_ms"]["min_ms"] > 0.0
    assert s["gap_to_next_step_ms"]["min_ms"] >= 0.0
