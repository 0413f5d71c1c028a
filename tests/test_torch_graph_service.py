"""The port's multi-process shared-memory graph engine against ``repro``'s.

``repro_torch.graph.service`` is a numpy copy of ``repro.graph.service``:
CSR shards in POSIX shared memory, served by spawned worker processes. On
TOY (seed 1, the instance ``repro``'s own service suite uses) these tests
hold, bitwise:

- shards against the port's in-process partitions and ``repro``'s shards;
- ``sample_neighbors`` / ``sample_many`` through the port's ``GraphClient``
  against the port's ``DistributedGraphEngine`` and ``repro``'s, under
  balanced and owner dispatch, slab overflow to pickle, out-of-order
  gathers, hybrid local serving and threshold 0;
- walks, egos and pairs of the port's ``SamplePipeline`` over the client
  against ``repro``'s pipeline over its in-process engine;
- a port training run on ``engine_backend="mp"`` against the in-process run
  (bitwise) and ``repro``'s in-process run (1e-5), and full-graph
  embeddings over the client against the in-process engine's.

Also: worker stats across the process boundary and ``reset_stats``; a
worker's error raised with its traceback, a crash raised and not hung, the
trainer reaping its workers when ``train()`` raises, a double shutdown;
``HealthMonitor`` heartbeats over a live client; worker serve spans in an
exported trace; a spawned worker's imports (no torch, no JAX); the
``--engine-backend mp`` examples on the CPU. Every test runs under a hard
SIGALRM watchdog, so a stuck worker fails its test and never wedges the
suite.
"""
import json
import os
import pathlib
import signal
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.graph as jgraph
from repro.graph.service import attach_shard as j_attach_shard
from repro.graph.service import build_shard as j_build_shard
from repro.sampling.pipeline import SamplePipeline as JPipeline
from repro_torch import convert
from repro_torch import graph as tgraph
from repro_torch import obs as tobs
from repro_torch.graph import DistributedGraphEngine, GraphClient
from repro_torch.graph.service import EngineWorkerError, attach_shard, build_shard, shm
from repro_torch.infer import embed_all_nodes
from repro_torch.obs.health import HealthConfig, HealthMonitor
from repro_torch.sampling import SamplePipeline
from test_torch_model import _cfgs
from test_torch_sampling import _pipes
from test_torch_train import _trainer

pytestmark = pytest.mark.mp

REPO = pathlib.Path(__file__).resolve().parents[1]
HARD_TIMEOUT_S = 120
RELS = ("u2click2i", "i2click2u")


@pytest.fixture(autouse=True)
def _watchdog():
    """Hard per-test timeout: a hung worker or pipe fails loudly, never blocks."""

    def _expired(signum, frame):
        raise TimeoutError(f"test exceeded hard {HARD_TIMEOUT_S}s watchdog")

    old = signal.signal(signal.SIGALRM, _expired)
    signal.alarm(HARD_TIMEOUT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture
def deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


@pytest.fixture(scope="module")
def both(toy_ds_alt):
    """``repro``'s seed-1 TOY (the shared session instance) and the port's."""
    return toy_ds_alt, tgraph.generate(tgraph.TOY, seed=1)


@pytest.fixture(scope="module")
def ds(both):
    return both[1]


@pytest.fixture(scope="module")
def inproc(ds):
    return DistributedGraphEngine(ds.graph, num_partitions=4)


@pytest.fixture(scope="module")
def j_inproc(both):
    return jgraph.DistributedGraphEngine(both[0].graph, num_partitions=4)


@pytest.fixture(scope="module")
def client(ds):
    with GraphClient(ds.graph, num_partitions=4, num_workers=2) as c:
        yield c


def _equal_all(got, *wants):
    for want in wants:
        assert len(got) == len(want)
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x, y)


# ------------------------------------------------------------------- shards
@pytest.mark.quick
class TestShmShards:
    def test_shard_roundtrip_bitwise(self, both, ds):
        """A port shard attaches to the port's partition rows, and the two
        packages' shards attach in each other, array for array."""
        seg, manifest = build_shard(ds.graph, part_id=1, num_parts=4)
        jseg, jmanifest = j_build_shard(both[0].graph, part_id=1, num_parts=4)
        try:
            ref = DistributedGraphEngine(ds.graph, num_partitions=4).partitions[1]
            att, views = attach_shard(manifest)
            jatt, jviews = j_attach_shard(manifest)
            xatt, xviews = attach_shard(jmanifest)
            assert views.keys() == jviews.keys() == xviews.keys()
            for rel, (indptr, indices) in ref.rel_rows.items():
                np.testing.assert_array_equal(views[f"{rel}/indptr"], indptr)
                np.testing.assert_array_equal(views[f"{rel}/indices"], indices)
                np.testing.assert_array_equal(views[f"{rel}/degs"], np.diff(indptr))
                assert not views[f"{rel}/indices"].flags.writeable
            for key in views:
                assert views[key].dtype == xviews[key].dtype
                np.testing.assert_array_equal(views[key], jviews[key])
                np.testing.assert_array_equal(views[key], xviews[key])
            for a in (att, jatt, xatt):
                a.close()
        finally:
            for s in (seg, jseg):
                s.close()
                s.unlink()

    def test_too_small_shm_fails_at_construction(self):
        free = shm.shm_free_bytes()
        if free is None:
            pytest.skip(f"no {shm.SHM_DIR} on this host")
        shm.ensure_room(1, "one byte")
        with pytest.raises(OSError, match="free"):
            shm.ensure_room(free + (1 << 30), "a segment past the free space")


# ------------------------------------------------------------------ samples
@pytest.mark.quick
class TestBitwiseEquivalence:
    @pytest.mark.parametrize("seed", [0, 7])
    def test_sample_neighbors_matches_both_engines(self, inproc, j_inproc, client, seed):
        got = client.sample_neighbors(np.random.default_rng(seed), np.arange(80), RELS[0], 5)
        for eng in (inproc, j_inproc):
            want = eng.sample_neighbors(np.random.default_rng(seed), np.arange(80), RELS[0], 5)
            np.testing.assert_array_equal(got, want)
        assert got.dtype == np.int64

    def test_sample_many_matches_both_engines(self, ds, inproc, j_inproc, client):
        nodes = np.random.default_rng(3).integers(0, ds.graph.num_nodes, 120)
        queries = [(nodes, RELS[0], 4, -1), (nodes[:50], RELS[1], 2, -1)]
        got = client.sample_many(np.random.default_rng(11), queries)
        _equal_all(got, inproc.sample_many(np.random.default_rng(11), queries),
                   j_inproc.sample_many(np.random.default_rng(11), queries))

    @pytest.mark.parametrize("kw", [
        dict(dispatch="owner"),
        dict(dispatch="owner", slot_bytes=256),  # replies too large: pickled
        dict(dispatch="balanced", slot_bytes=256),  # request too large: owner fan-out
        dict(dispatch="balanced", slot_bytes=6 << 10),  # replies overflow: "pickleq"
    ], ids=["owner", "owner-pickle", "balanced-owner-fallback", "balanced-pickleq"])
    def test_dispatch_and_slab_overflow_match(self, ds, j_inproc, kw):
        nodes = np.random.default_rng(5).integers(0, ds.graph.num_nodes, 300)
        queries = [(nodes, RELS[0], 6, -1), (nodes, RELS[1], 2, -1)]
        want = j_inproc.sample_many(np.random.default_rng(9), queries)
        with GraphClient(ds.graph, num_partitions=4, num_workers=2, **kw) as c:
            _equal_all(c.sample_many(np.random.default_rng(9), queries), want)
            pickled = sum(s["pickle_replies"] for s in c.worker_stats())
        assert (pickled > 0) == (kw.get("slot_bytes") is not None)

    def test_async_submit_gather_out_of_order(self, inproc, client):
        h1 = client.submit(np.random.default_rng(1), [(np.arange(60), RELS[0], 3, -1)])
        h2 = client.submit(np.random.default_rng(2), [(np.arange(60), RELS[0], 3, -1)])
        out2, out1 = client.gather(h2)[0], client.gather(h1)[0]
        for seed, out in ((1, out1), (2, out2)):
            np.testing.assert_array_equal(out, inproc.sample_neighbors(
                np.random.default_rng(seed), np.arange(60), RELS[0], 3))

    def test_out_of_order_gather_never_reuses_held_slots(self, ds, inproc):
        """Deep pipelining with out-of-order gathers never hands a new
        request a slab slot an un-gathered request still owns."""
        with GraphClient(ds.graph, num_partitions=4, num_workers=1, slab_slots=4) as c:
            rngs = [np.random.default_rng(100 + i) for i in range(8)]
            refs = [inproc.sample_neighbors(np.random.default_rng(100 + i), np.arange(70),
                                            RELS[0], 4) for i in range(8)]
            handles = {i: c.submit(rngs[i], [(np.arange(70), RELS[0], 4, -1)])
                       for i in range(4)}
            np.testing.assert_array_equal(c.gather(handles.pop(3))[0], refs[3])
            for i in range(4, 8):
                h = c.submit(rngs[i], [(np.arange(70), RELS[0], 4, -1)])
                np.testing.assert_array_equal(c.gather(h)[0], refs[i])
            for i, h in handles.items():
                np.testing.assert_array_equal(c.gather(h)[0], refs[i])


@pytest.mark.quick
class TestHybridLocalServing:
    def test_local_round_matches_workers_and_both_engines(self, ds, inproc, j_inproc, client):
        nodes = np.random.default_rng(13).integers(0, ds.graph.num_nodes, 200)
        queries = [(nodes, RELS[0], 4, -1), (nodes[:60], RELS[1], 3, -1)]
        remote = client.sample_many(np.random.default_rng(21), queries)
        with GraphClient(ds.graph, num_partitions=4, num_workers=2,
                         local_threshold=10_000) as c:
            local = c.sample_many(np.random.default_rng(21), queries)
            agg = c.aggregate_stats()
        assert agg["local_neighbor_requests"] == len(nodes) + 60 and agg["local_batches"] == 1
        _equal_all(local, remote, inproc.sample_many(np.random.default_rng(21), queries),
                   j_inproc.sample_many(np.random.default_rng(21), queries))

    def test_rng_stream_identical_across_serving_modes(self, ds):
        outs = {}
        for thr in (0, 10_000):
            with GraphClient(ds.graph, num_partitions=4, num_workers=1,
                             local_threshold=thr) as c:
                rng = np.random.default_rng(4)
                c.sample_many(rng, [(np.arange(50), RELS[0], 3, -1)])
                outs[thr] = c.sample_many(rng, [(np.arange(120), RELS[1], 2, -1)])[0]
        np.testing.assert_array_equal(outs[0], outs[10_000])

    def test_mixed_local_remote_stats_invariant(self, ds):
        with GraphClient(ds.graph, num_partitions=4, num_workers=2, local_threshold=100) as c:
            rng = np.random.default_rng(0)
            c.sample_many(rng, [(np.arange(80), RELS[0], 2, -1)])  # local
            c.sample_many(rng, [(np.arange(300), RELS[0], 2, -1)])  # remote
            agg = c.aggregate_stats()
            assert agg["local_neighbor_requests"] == 80 and agg["local_batches"] == 1
            # served (workers + local) == issued (the client's mirror)
            assert agg["neighbor_requests"] == c.stats.neighbor_requests == 380
            c.reset_stats()
            agg = c.aggregate_stats()
            assert agg["neighbor_requests"] == agg["local_neighbor_requests"] == 0

    def test_threshold_zero_is_all_remote(self, client):
        client.reset_stats()
        client.sample_many(np.random.default_rng(1), [(np.arange(16), RELS[0], 2, -1)])
        agg = client.aggregate_stats()
        assert agg["local_neighbor_requests"] == 0 and agg["neighbor_requests"] == 16


# ----------------------------------------------------------------- pipeline
@pytest.mark.parametrize("order", ["walk_ego_pair", "walk_pair_ego"])
def test_pipeline_over_client_matches_repro(both, j_inproc, client, order):
    """Walks, pairs and egos of the port's pipeline over the client equal
    ``repro``'s pipeline over its in-process engine."""
    jpc, tpc = _pipes(order=order, neg_mode="random")
    want = list(JPipeline(j_inproc, jpc, seed=5).batches(3))
    got = list(SamplePipeline(client, tpc, seed=5).batches(3))
    assert len(got) == len(want) == 3
    for x, y in zip(got, want):
        for name in ("src_ids", "dst_ids", "neg_ids"):
            np.testing.assert_array_equal(getattr(x, name), getattr(y, name))
        for ex, ey in ((x.src_ego, y.src_ego), (x.dst_ego, y.dst_ego),
                       (x.neg_ego, y.neg_ego)):
            _equal_all(ex.levels, ey.levels)


# ------------------------------------------------------------------ training
@pytest.mark.parametrize("threshold", [0, 8192], ids=["all-workers", "hybrid"])
def test_training_losses_bitwise_inproc_and_close_to_repro(both, threshold, deterministic):
    """Four sparse steps on the mp engine: the in-process run's losses
    bitwise, and ``repro``'s in-process run's within 1e-5, from the same
    initial weights."""
    jds, tds = both
    jt = _trainer("repro", jds, True, steps=4)
    init = {k: np.asarray(v) for k, v in jt.init_params().items()}
    want = jt.train({k: jnp.asarray(v) for k, v in init.items()}).losses
    base = _trainer("port", tds, True, steps=4).train(init).losses
    tr = _trainer("port", tds, True, steps=4, engine_backend="mp", num_engine_workers=2,
                  engine_local_threshold=threshold, prefetch_batches=2)
    with tr:
        got = tr.train(init).losses
        served = tr.engine.aggregate_stats()
    assert got == base
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (served["local_batches"] == served["batches"]) == (threshold > 0)


def test_calibrated_plan_times_steps_on_the_mp_engine(both):
    """``prefetch_batches=None`` calibrates on the engine the run samples
    from: the client serves the calibration's rounds too."""
    tr = _trainer("port", both[1], True, steps=40, prefetch_batches=None, auto_backend=True,
                  engine_backend="mp", num_engine_workers=2, engine_local_threshold=0)
    with tr:
        plan = tr._resolve_plan(tr.init_params())
        served = tr.engine.aggregate_stats()
    assert plan["calibrated"] and "pipelined_step_s" in plan["measurements"]
    assert served["batches"] > 0 and served["local_batches"] == 0


def test_embeddings_over_client_equal_inproc(ds, inproc, client):
    _, tcfg = _cfgs(ds.graph, side_info=True)
    model = convert.init_params(tcfg, seed=0, device="cpu")
    got = embed_all_nodes(model, client, ds.graph, batch_size=256, seed=3, device="cpu")
    want = embed_all_nodes(model, inproc, ds.graph, batch_size=256, seed=3, device="cpu")
    assert got.shape == (ds.graph.num_nodes, tcfg.embedding.dim)
    np.testing.assert_array_equal(got, want)


# -------------------------------------------------------------------- stats
@pytest.mark.quick
class TestStatsAggregation:
    def test_worker_counters_survive_process_boundary(self, ds, client):
        eng = DistributedGraphEngine(ds.graph, num_partitions=4)
        client.reset_stats()
        rng_a, rng_b = np.random.default_rng(0), np.random.default_rng(0)
        for lo in (0, 40, 160):
            eng.sample_neighbors(rng_a, np.arange(lo, lo + 40), RELS[0], 3)
            client.sample_neighbors(rng_b, np.arange(lo, lo + 40), RELS[0], 3)
        assert client.stats.neighbor_requests == eng.stats.neighbor_requests == 120
        assert client.stats.cross_partition_requests == eng.stats.cross_partition_requests
        agg = client.aggregate_stats()
        assert agg["neighbor_requests"] == 120 and agg["num_workers"] == 2
        per = client.worker_stats()
        assert sum(s["neighbor_requests"] for s in per) == 120
        assert all(s["batches"] > 0 for s in per)
        assert all(s["shm_replies"] + s["pickle_replies"] == s["batches"] for s in per)
        assert all(s["imports_torch"] is False for s in per)

    def test_reset_stats_clears_both_sides(self, client):
        client.sample_neighbors(np.random.default_rng(0), np.arange(20), RELS[0], 2)
        client.reset_stats()
        assert client.stats.neighbor_requests == client.stats.batches == 0
        assert client.aggregate_stats()["neighbor_requests"] == 0

    def test_engine_stats_reset_and_step(self, ds):
        eng = DistributedGraphEngine(ds.graph, num_partitions=4)
        got = eng.step(np.random.default_rng(2), np.arange(30), RELS[0])
        want = eng.sample_neighbors(np.random.default_rng(2), np.arange(30), RELS[0], 1)
        np.testing.assert_array_equal(got, want[:, 0])
        assert eng.stats.batches == 2
        eng.stats.reset()
        assert (eng.stats.neighbor_requests, eng.stats.cross_partition_requests,
                eng.stats.batches) == (0, 0, 0)


# ------------------------------------------------------------ failure modes
class TestFailureModes:
    def test_worker_error_raises_with_traceback(self, ds):
        with GraphClient(ds.graph, num_partitions=2, num_workers=1, slab_slots=4) as c:
            # more failures than slab slots: an error reply must recycle its slot
            for _ in range(6):
                with pytest.raises(EngineWorkerError, match="KeyError") as err:
                    c.sample_neighbors(np.random.default_rng(0), np.arange(10),
                                       "no2such2rel", 2)
                assert err.value.slot_safe and err.value.worker_id == 0
            out = c.sample_neighbors(np.random.default_rng(0), np.arange(10), RELS[0], 2)
            assert out.shape == (10, 2)

    def test_worker_crash_raises_not_hangs(self, ds):
        c = GraphClient(ds.graph, num_partitions=2, num_workers=2)
        try:
            c._procs[0].kill()
            with pytest.raises(EngineWorkerError, match="died|unreachable|closed"):
                c.sample_neighbors(np.random.default_rng(0), np.arange(50), RELS[0], 2)
        finally:
            c.shutdown()
        assert all(not p.is_alive() for p in c._procs)

    def test_trainer_propagates_dead_workers_and_reaps(self, both):
        tr = _trainer("port", both[1], True, steps=50, prefetch_batches=2,
                      engine_backend="mp", num_engine_workers=2, engine_local_threshold=0)
        client = tr.engine
        for proc in client._procs:
            proc.kill()
        with pytest.raises(EngineWorkerError):
            tr.train()
        assert all(not p.is_alive() for p in client._procs)
        assert client._closed

    @pytest.mark.quick
    def test_double_shutdown_idempotent(self, ds):
        c = GraphClient(ds.graph, num_partitions=2, num_workers=1)
        c.shutdown()
        c.shutdown()
        with pytest.raises(RuntimeError):
            c.sample_neighbors(np.random.default_rng(0), np.arange(4), RELS[0], 1)
        with GraphClient(ds.graph, num_partitions=2, num_workers=1) as c2:
            c2.shutdown()
        assert all(not p.is_alive() for p in c2._procs)


# ------------------------------------------------------------ observability
def test_health_heartbeats_over_a_live_client(ds, tmp_path):
    """Every live worker answers; a killed one is silent and, after
    ``worker_silent_rounds`` rounds, marks the run degraded."""
    tel = tobs.Telemetry()
    with GraphClient(ds.graph, num_partitions=4, num_workers=2) as c:
        mon = HealthMonitor(HealthConfig(worker_silent_rounds=2, worker_heartbeat_timeout_s=2.0,
                                         flightrec_dir=str(tmp_path)), telemetry=tel, client=c)
        assert c.heartbeat(timeout=5.0) == {0: True, 1: True}
        mon._heartbeat_round()
        assert not mon.degraded and mon._silent == {0: 0, 1: 0}
        c._procs[1].kill()
        c._procs[1].join(timeout=10)
        assert not c._procs[1].is_alive()
        for _ in range(2):
            mon._heartbeat_round()
        assert mon._silent == {0: 0, 1: 2} and mon.degraded
    assert tel.metrics.summary()["counters"]["health.worker_silent"] == 1
    assert "health.degraded" in [m[0] for m in tel.tracer.marks()]


def test_worker_spans_in_exported_trace(ds, tmp_path):
    tel = tobs.Telemetry()
    with GraphClient(ds.graph, num_partitions=4, num_workers=2, telemetry=tel) as c:
        rng = np.random.default_rng(0)
        for _ in range(3):
            c.sample_many(rng, [(np.arange(64), RELS[0], 3, -1), (np.arange(64), RELS[1], 2, -1)])
        c.drain_worker_spans()
        pids = {p.pid for p in c._procs}
    path = tel.write_trace(str(tmp_path / "t.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    serve = [e for e in events if e.get("name") == "worker.sampleq"]
    assert len(serve) == 3 and {e["pid"] for e in serve} <= pids
    client_spans = {e.get("name") for e in events if e.get("cat") == "client"}
    assert {"client.dispatch", "client.wait", "client.compose"} <= client_spans
    counters = tel.metrics.summary()["counters"]
    assert counters["client.rounds_worker"] == 3 and counters.get("client.pickle_fallback", 0) == 0


@pytest.mark.parametrize("module", ["repro_torch.graph.service.worker", "train_torch",
                                    "eval_torch"])
def test_spawned_worker_imports_no_torch_or_jax(module, tmp_path):
    """A worker's import chain is the worker module with the package inits,
    numpy only; and the client starts workers without re-running the calling
    script, so a script that imports torch (both examples do, at module
    level) still gets workers without it."""
    script = tmp_path / "spawner.py"
    script.write_text(
        "import sys\n"
        f"import {module}\n"
        "from repro_torch.graph import SPECS, GraphClient, generate\n"
        "if __name__ == '__main__':\n"
        "    bad = sorted({m.split('.')[0] for m in sys.modules} & {'torch', 'jax', 'repro'})\n"
        "    with GraphClient(generate(SPECS['toy'], seed=1).graph, num_partitions=2,\n"
        "                     num_workers=2) as c:\n"
        "        print('parent', bad)\n"
        "        print('workers', [s['imports_torch'] for s in c.worker_stats()])\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO / "src"),
                                                       str(REPO / "examples")]))
    res = subprocess.run([sys.executable, str(script)], env=env, capture_output=True,
                         text=True, timeout=HARD_TIMEOUT_S - 10, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "workers [False, False]" in res.stdout, res.stdout
    if module.startswith("repro_torch"):
        assert "parent []" in res.stdout, res.stdout
    else:  # the script's own torch, which the workers do not inherit
        assert "parent ['torch']" in res.stdout, res.stdout


# ----------------------------------------------------------------- examples
@pytest.mark.parametrize("script,flags,expect", [
    ("train_torch.py", ["--steps", "6", "--engine-local-threshold", "0"],
     "imports torch: False"),
    ("eval_torch.py", ["--steps", "4", "--models", "lightgcn", "--strategies", "u2i"],
     "| lightgcn | device |"),
], ids=["train_torch", "eval_torch"])
def test_examples_run_on_the_mp_engine(script, flags, expect):
    """``--engine-backend mp --device cpu`` on TOY, as a user runs it: a
    script that imports torch at module level, whose workers do not."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO / "src"),
                                                       str(REPO / "examples")]))
    res = subprocess.run([sys.executable, str(REPO / "examples" / script), "--device", "cpu",
                          "--engine-backend", "mp", *flags], env=env, capture_output=True,
                         text=True, timeout=HARD_TIMEOUT_S - 10, cwd=REPO)
    assert res.returncode == 0, res.stderr[-4000:]
    assert expect in res.stdout
