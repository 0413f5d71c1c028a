"""Graph4Rec trainer on a CUDA card: walk → pair → ego batches through a
grad step, with the sparse/dense optimizer split and recall evaluation.

The port of ``repro.train.trainer``, for both sampling backends:

- **Batches.** ``SamplePipeline`` (numpy, the same stream as ``repro``'s)
  feeds ``host_batch`` / ``sparse_host_batch``, in a named background
  prefetch thread (``prefetch_batches`` deep) or inline (0). The one H2D
  copy per batch happens in the consumer-side stager ``_staged_batches``:
  fresh pinned buffers per batch, ``.to(device, non_blocking=True)``,
  double-buffered when prefetching.
- **Dense step** (tables below ``sparse_min_rows``, or
  ``sparse_updates=False``): the gradient of every parameter, row-wise
  AdaGrad on the ``emb/*`` tables and Adam on the GNN weights, functional.
- **Sparse step** (the paper's PS pull/push, §3.6): the batch arrives
  remapped onto each table's touched rows (``uniq``); the step gathers those
  rows, differentiates w.r.t. them and the GNN weights, applies Adam to the
  weights and row-wise AdaGrad to the touched rows IN PLACE through the
  ``row_adagrad`` kernel. O(unique ids) per step. Both steps are the same
  rule: ``tests/test_torch_train.py`` holds them equal.
- Every step dispatch runs under ``lint.sanitizer.transfer_sanitizer``
  (``torch.cuda.set_sync_debug_mode("error")``; ``sanitize_transfers``),
  the counterpart of ``jax.transfer_guard``: a host sync inside the step
  raises. Losses stay on the device and are read back in windows by
  ``host_floats_async`` (an asynchronous copy into pinned memory), resolved
  a window later.
- **Fused step** (``sampling_backend="fused"``): the batch is sampled on
  the device inside the step (``sampling.fused.FusedSampler``: walk, the
  ``window_pair_draw`` kernel for the pair stage, ego gathers) from draws of one device
  ``torch.Generator`` seeded by ``cfg.seed``, then the dense step runs on
  it, as ``repro``'s fused step uses the dense full-table rule. No
  prefetcher and no stager: there is no host batch. A graph whose padded
  tables exceed ``fused_budget_mb`` (estimated, then measured) falls back
  to the host pipeline with a logged warning.
- **Graph engine** (``engine_backend``): ``"inproc"`` samples from the
  engine object passed in; ``"mp"`` wraps its graph in a
  ``graph.service.GraphClient`` (CSR shards in POSIX shared memory, served
  by ``num_engine_workers`` spawned worker processes, rounds of at most
  ``engine_local_threshold`` nodes answered in this process over the same
  shards). Both give the same host batches, bitwise, so the same losses.
  The trainer owns the client it builds: ``close()``, the context manager
  and a ``train()`` that raises reap its workers.
- ``prefetch_batches=None`` lets a short calibration (host batch cost, step
  time, and the measured wall of a few pipelined host steps) choose serial
  or prefetch, and ``sampling_backend="auto"`` adds the fused step's time
  to choose the backend, as ``repro`` does. The pipelined wall is measured,
  not estimated from its parts: the prefetch thread and the step's dispatch
  share the GIL, so pipelined steps can take longer than either alone.

- **Observability**, as ``repro``'s trainer wires it, each hook off by
  default at one ``is None`` test a call site: ``attribution=True`` threads
  a ``train.attribution.PhaseTimer`` through the loop (``sample`` and
  ``assemble`` in the producer, ``batch_wait`` and ``h2d`` in the stager,
  ``dispatch`` around the step with a CUDA event pair for its span on the
  device timeline, ``loss_fetch`` around the loss readback) into
  ``TrainResult.attribution``; ``telemetry`` (an ``obs.Telemetry``) makes
  every phase a span and adds the prefetch and stager gauges, the
  wedged-producer and fused-fallback counters and marks, and per-phase
  device-memory peaks (``trainer._memory``); ``health`` (an
  ``obs.HealthConfig``) runs a ``HealthMonitor`` (``trainer._health_monitor``)
  that beats per step, watches the drained losses and flight-records a
  stall. None of them syncs or touches the training stream: a run with all
  three on has the same losses, bitwise.

``use_kernel_aggr``, ``use_kernel_rowopt`` and ``fused_use_kernel_pairs``
are kept for config parity and select nothing: on the card the kernels
always run.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import queue
import threading
import time
from typing import Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch import convert
from repro_torch.core import model as model_lib
from repro_torch.core.recall import evaluate_recall
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.embedding import optimizer as emb_opt
from repro_torch.embedding import table as emb
from repro_torch.graph.generator import RecsysDataset
from repro_torch.graph.service import GraphClient
from repro_torch.infer import embed_all_nodes
from repro_torch.lint.sanitizer import (AsyncFloats, device_barrier, host_floats_async,
                                        host_scalar, transfer_sanitizer)
from repro_torch.obs.health import HealthMonitor
from repro_torch.obs.memory import MemoryAccountant
from repro_torch.obs.trace import span_scope
from repro_torch.sampling.fused import FusedConfig, FusedDraws, fused_eligibility
from repro_torch.sampling.pipeline import PipelineConfig, SamplePipeline, make_train_sampler
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.attribution import PhaseTimer, device_span_scope, median, phase_scope

log = logging.getLogger("repro_torch.train")

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainerConfig:
    """``repro.train.TrainerConfig``, field for field (see its comments)."""

    num_steps: int = 200
    sparse_lr: float = 0.2
    dense_lr: float = 1e-3
    eval_every: int = 0  # 0 -> only at end
    eval_top_k: int = 100
    eval_top_n: int = 20
    eval_max_users: int = 0  # 0 -> every held-out user
    eval_method: str = "device"  # device | ivf | bruteforce
    eval_batch_size: int = 1024
    eval_at_end: bool = True
    log_every: int = 50
    seed: int = 0
    # 0 = serial loop; an int always wins; None = calibrate (or 2 when
    # auto_backend is off / the run is too short to calibrate)
    prefetch_batches: Optional[int] = None
    auto_backend: bool = True
    calibrate_batches: int = 3
    calibrate_min_steps: int = 32
    sync_every_step: bool = False
    use_kernel_aggr: Optional[bool] = None  # kept for config parity; unused
    sparse_updates: bool = True
    sparse_min_rows: int = 32768  # 0 forces the sparse path
    unique_bucket: int = 0
    adagrad_init_accum: float = 0.1
    use_kernel_rowopt: bool = False  # kept for config parity; unused
    loss_fetch_every: int = 64
    engine_backend: str = "inproc"  # inproc | mp (graph.service.GraphClient)
    # mp worker processes (clamped to the partition count); 0 = half the cores
    num_engine_workers: int = 0
    # mp partitions when handed a bare HeteroGraph; a built engine's win
    num_engine_partitions: int = 4
    # mp: rounds of at most this many nodes are served in this process over
    # the client's own shard views (0 = every round goes to a worker)
    engine_local_threshold: int = 8192
    sampling_backend: str = "host"  # host | fused | auto (calibration decides)
    fused_max_degree: int = 32
    fused_budget_mb: float = 256.0
    fused_oversample: float = 2.0
    fused_use_kernel_pairs: bool = True  # kept for config parity; selects nothing
    # every step dispatch under torch.cuda.set_sync_debug_mode("error")
    sanitize_transfers: bool = True
    attribution: bool = False  # PhaseTimer summary into TrainResult.attribution
    telemetry: Optional[object] = None  # an obs.Telemetry: spans, metrics, memory
    health: Optional[object] = None  # an obs.HealthConfig: stall and loss watchdog


@dataclasses.dataclass
class TrainResult:
    params: Params  # on the trainer's device, ``repro``'s key names
    losses: List[float]
    eval_history: List[Dict[str, float]]
    wall_time_s: float
    pairs_seen: int
    plan: Optional[Dict] = None
    attribution: Optional[Dict] = None  # PhaseTimer summary when cfg.attribution


def _check_config(cfg: TrainerConfig) -> None:
    if cfg.engine_backend not in ("inproc", "mp"):
        raise ValueError(f"unknown engine_backend {cfg.engine_backend!r}")
    if cfg.sampling_backend not in ("host", "fused", "auto"):
        raise ValueError(f"unknown sampling_backend {cfg.sampling_backend!r}")
    if cfg.eval_method not in ("device", "ivf", "bruteforce"):
        raise ValueError(f"unknown eval_method {cfg.eval_method!r}")


_DONE = object()


class _Prefetcher:
    """Bounded background-thread prefetch between the host pipeline and the
    step loop. Producer exceptions re-raise in the consumer, and a producer
    that dies without its sentinel surfaces as an error, not a hang.

    Optional telemetry: ``queue_gauge`` tracks the queue's fill level, a
    wedged producer becomes the ``prefetch.wedged_producer`` counter and a
    trace mark, and ``health_check`` (``HealthMonitor.check``) lets a
    consumer polling an empty queue raise a watchdog's fault."""

    def __init__(self, it: Iterator, depth: int, queue_gauge=None, telemetry=None,
                 health_check=None):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, int(depth)))
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._gauge = queue_gauge
        self._c_wedged = (telemetry.metrics.counter("prefetch.wedged_producer")
                          if telemetry is not None else None)
        self._tracer = telemetry.tracer if telemetry is not None else None
        self._health_check = health_check
        self._thread = threading.Thread(
            target=self._fill, args=(it,), name="repro-torch-prefetch", daemon=True
        )
        self._thread.start()

    def _fill(self, it: Iterator) -> None:
        try:
            for item in it:
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        if self._gauge is not None:
                            self._gauge.set(self._q.qsize())
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
        except BaseException as e:  # re-raised by __next__
            self._err = e
        finally:
            while not self._stop.is_set():
                try:
                    self._q.put(_DONE, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> "_Prefetcher":
        return self

    def __next__(self):
        while True:
            try:
                item = self._q.get(timeout=0.5)
            except queue.Empty:
                if self._health_check is not None:
                    self._health_check()
                if self._thread.is_alive():
                    continue
                try:  # it may have delivered between the timeout and the check
                    item = self._q.get_nowait()
                except queue.Empty:
                    if self._err is not None:
                        raise self._err
                    raise RuntimeError("prefetch producer thread died without "
                                       "delivering a batch or its error")
            if item is _DONE:
                self._thread.join(timeout=5.0)
                if self._thread.is_alive():
                    log.warning("prefetch producer still running after its "
                                "end-of-stream sentinel; it is a daemon and will "
                                "exit with the process")
                    self._mark_wedged("after-sentinel")
                if self._err is not None:
                    raise self._err
                raise StopIteration
            return item

    def close(self) -> None:
        """Unblock and retire the producer (early consumer exit)."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
        if self._thread.is_alive():
            log.warning("prefetch producer still running after close(); it will "
                        "exit after its current sampling round")
            self._mark_wedged("close")

    def _mark_wedged(self, where: str) -> None:
        if self._c_wedged is not None:
            self._c_wedged.inc()
        if self._tracer is not None:
            self._tracer.mark("prefetch.wedged_producer", where=where)


def _stage(item: Tuple[Dict, int], device: torch.device):
    """The one H2D copy of a host batch: fresh pinned buffers on CUDA."""
    host, npairs = item
    return model_lib.stage(host, device), npairs


def _staged_batches(it: Iterator, device: torch.device, timer: Optional[PhaseTimer] = None,
                    double_buffer: bool = True, staged_gauge=None) -> Iterator:
    """Consumer-side H2D stager. With ``double_buffer`` (any prefetching
    run) batch k+1's copy is issued before batch k is yielded, so the next
    device batch is resident when its step is dispatched; two device
    batches rotate. The serial path stages one batch at a time.

    Phases: ``batch_wait`` is the time blocked on the upstream iterator
    (queue starvation when prefetching, inline sampling and assembly when
    serial), ``h2d`` the staging copy itself."""
    it = iter(it)
    if not double_buffer:
        while True:
            with phase_scope(timer, "batch_wait"):
                item = next(it, _DONE)
            if item is _DONE:
                return
            with phase_scope(timer, "h2d"):
                staged = _stage(item, device)
            if staged_gauge is not None:
                staged_gauge.set(1)
            yield staged
    with phase_scope(timer, "batch_wait"):
        item = next(it, _DONE)
    if item is _DONE:
        return
    with phase_scope(timer, "h2d"):
        pending = _stage(item, device)
    while True:
        with phase_scope(timer, "batch_wait"):
            item = next(it, _DONE)
        if item is _DONE:
            if staged_gauge is not None:
                staged_gauge.set(1)
            yield pending
            return
        with phase_scope(timer, "h2d"):
            staged = _stage(item, device)
        if staged_gauge is not None:
            staged_gauge.set(2)  # two device batches resident (double buffer)
        yield pending
        pending = staged


def _round_spikes(durs: List[float]) -> List[int]:
    """Indices of round-paying batches (4x over the median) in a series of
    per-batch host costs; carry batches cost microseconds."""
    if len(durs) < 2:
        return []
    thr = 4.0 * median(durs)
    return [i for i, d in enumerate(durs) if d > thr]


class Graph4RecTrainer:
    def __init__(
        self,
        dataset: RecsysDataset,
        engine,
        model_cfg: model_lib.Graph4RecConfig,
        pipe_cfg: PipelineConfig,
        cfg: TrainerConfig = TrainerConfig(),
        device: DeviceLike = None,
    ):
        _check_config(cfg)
        self.device = resolve_device(device)
        self.dataset = dataset
        self.model_cfg = model_cfg
        self.pipe_cfg = pipe_cfg
        self.cfg = cfg
        # both paths step the tables with the same row-wise AdaGrad rule
        self.opt = opt_lib.masked(
            opt_lib.rowwise_adagrad(cfg.sparse_lr, init_accum=cfg.adagrad_init_accum),
            opt_lib.adam(cfg.dense_lr),
            select_a=lambda k: k.startswith("emb/"),
        )
        self._dense_opt = opt_lib.adam(cfg.dense_lr)
        # per-table unique-id bucket widths, grown and kept by sparse_host_batch
        self._buckets: Dict[str, int] = {}
        if cfg.unique_bucket:
            self._buckets["node"] = cfg.unique_bucket
            for slot in model_cfg.embedding.slots:
                self._buckets[f"slot:{slot.name}"] = cfg.unique_bucket
        num_nodes = dataset.graph.num_nodes
        self._sparse_on = cfg.sparse_updates and (
            cfg.sparse_min_rows <= 0 or num_nodes >= cfg.sparse_min_rows
        )
        if cfg.sparse_updates and not self._sparse_on:
            log.info("sparse_updates requested but num_nodes=%d < sparse_min_rows=%d; "
                     "using the equivalent dense step", num_nodes, cfg.sparse_min_rows)
        # 'bag' side info on the dense path: the full count matrices, on the
        # device once; the sparse path ships a per-batch sub matrix instead
        self._slot_counts = (
            model_lib.slot_count_arrays(dataset.graph, model_cfg, self.device)
            if model_lib.bag_slot_specs(model_cfg) and not self._sparse_on else None
        )
        self._plan: Optional[Dict] = None
        # per-train() observability state, kept for tests and post-mortems
        # (trainer._health_monitor.fault, trainer._memory.peaks)
        self._health_monitor: Optional[HealthMonitor] = None
        self._memory: Optional[MemoryAccountant] = None
        # the fused sampler: built now for "fused" (or the host fallback
        # with a warning), lazily by the calibration for "auto"
        self._fused_sampler = None
        self._fused_measured_bytes: Optional[int] = None
        if cfg.sampling_backend == "fused":
            ok, why = self._build_fused()
            if ok:
                log.info("fused sampling backend active (%s)", why)
            else:
                log.warning("sampling_backend='fused' ineligible: %s; falling back "
                            "to the host pipeline", why)
                self._count_fused_fallback(why)
        self._train_pairs = np.concatenate(
            [np.stack([u, i], 1) for (u, i) in dataset.train_edges.values()], axis=0)
        # last, so nothing after it can fail and strand the workers it starts
        self._engine_workers = (cfg.num_engine_workers if cfg.num_engine_workers > 0
                                else max(1, (os.cpu_count() or 2) // 2))
        self._owned_client: Optional[GraphClient] = None
        if cfg.engine_backend == "mp":
            # a built engine lends its partitioning; a bare HeteroGraph is
            # partitioned straight into shared memory, with no in-process copy
            kw = ({} if hasattr(engine, "graph")
                  else {"num_partitions": cfg.num_engine_partitions})
            engine = self._owned_client = GraphClient(
                engine, num_workers=self._engine_workers,
                local_threshold=cfg.engine_local_threshold, telemetry=cfg.telemetry, **kw)
        self.engine = engine

    # ------------------------------------------------------------ lifecycle
    def close(self) -> None:
        """Reap the mp engine's worker processes. Idempotent; also runs on
        context-manager exit and when ``train()`` raises."""
        if self._owned_client is not None:
            self._owned_client.shutdown()

    def __enter__(self) -> "Graph4RecTrainer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _count_fused_fallback(self, why: str) -> None:
        tel = self.cfg.telemetry
        if tel is not None:
            tel.metrics.counter("trainer.fused_fallback").inc()
            tel.tracer.mark("trainer.fused_fallback", reason=why)

    def _build_fused(self) -> Tuple[bool, str]:
        """Build the fused sampler if the graph passes the memory gate, on
        the estimate and then on the measured bytes. Idempotent; returns
        (built, reason)."""
        if self._fused_sampler is not None:
            return True, "already built"
        cfg = self.cfg
        fused_cfg = FusedConfig(max_degree=cfg.fused_max_degree, budget_mb=cfg.fused_budget_mb,
                                use_kernel_pairs=cfg.fused_use_kernel_pairs,
                                oversample=cfg.fused_oversample)
        graph = self.dataset.graph
        bspecs = model_lib.bag_slot_specs(self.model_cfg)
        vspecs = model_lib.value_slot_specs(self.model_cfg)
        ok, why = fused_eligibility(graph, self.pipe_cfg, vspecs, bspecs, fused_cfg)
        if not ok:
            return False, why
        sampler = make_train_sampler(
            graph, self.pipe_cfg, backend="fused", seed=cfg.seed, value_slots=vspecs,
            bag_slots=bspecs, fused_cfg=fused_cfg, device=self.device,
            bag_counts=(model_lib.slot_count_arrays(graph, self.model_cfg, self.device)
                        if bspecs else None),
        )
        # the estimate admitted it; re-gate on the bytes actually resident
        measured = sampler.device_table_bytes()
        self._fused_measured_bytes = measured
        ok, why = fused_eligibility(graph, self.pipe_cfg, vspecs, bspecs, fused_cfg,
                                    measured_bytes=measured)
        log.info("fused eligibility: %s (measured %.1f MiB, budget %.1f MiB)",
                 why, measured / (1 << 20), cfg.fused_budget_mb)
        if ok:
            self._fused_sampler = sampler
        return ok, why

    # ---------------------------------------------------------- parameters
    def init_params(self, flat: Optional[Mapping[str, np.ndarray]] = None) -> Params:
        """Parameters on the trainer's device under ``repro``'s keys: the
        given numpy arrays (converted weights, checked against the config)
        or, with none, draws from ``torch.Generator`` seeded by ``cfg.seed``."""
        if flat is None:
            model = convert.init_params(self.model_cfg, seed=self.cfg.seed, device=self.device)
        else:
            model = convert.params_from_numpy(flat, self.model_cfg, device=self.device)
        return {k: v.detach() for k, v in model.params.items()}

    def _device_params(self, params) -> Params:
        """Fresh device copies: the sparse step updates tables in place, so
        a caller-held dict survives ``train``."""
        if params is None:
            return self.init_params()
        if any(isinstance(v, np.ndarray) for v in params.values()):
            return self.init_params(params)
        return {k: v.detach().to(self.device).clone() for k, v in params.items()}

    # ---------------------------------------------------------------- steps
    def _dense_step(self, params: Params, opt_state, batch: Dict):
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss = model_lib.loss_fn(leaves, self.model_cfg, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        with torch.no_grad():
            g = {k: torch.zeros_like(v) if gk is None else gk
                 for (k, v), gk in zip(params.items(), grads)}
            updates, opt_state = self.opt.update(g, opt_state, params)
            params = opt_lib.apply_updates(params, updates)
        return params, opt_state, loss.detach()

    def _sparse_step(self, params: Params, opt_state, batch: Dict):
        """Gather → step → scatter: ``batch`` arrives id-remapped, its
        ``uniq`` entry names each table's touched global rows."""
        uniq = {f"emb/{k}": v for k, v in batch["uniq"].items()}
        model_batch = {k: v for k, v in batch.items() if k != "uniq"}
        sparse_p, dense_p = model_lib.sparse_dense_split(params)
        row_state, dense_state = opt_state
        # tables the batch never touches pass straight through
        touched = {k: v for k, v in sparse_p.items() if k in uniq}
        sub = {k: emb.gather_rows(v, uniq[k]).requires_grad_(True) for k, v in touched.items()}
        dense_leaves = {k: v.detach().requires_grad_(True) for k, v in dense_p.items()}
        loss = model_lib.loss_fn({**dense_leaves, **sub}, self.model_cfg, model_batch)
        leaves = list(sub.values()) + list(dense_leaves.values())
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(v) if g is None else g for v, g in zip(leaves, grads)]
        g_sub = dict(zip(sub, grads[: len(sub)]))
        g_dense = dict(zip(dense_leaves, grads[len(sub):]))
        with torch.no_grad():
            d_updates, dense_state = self._dense_opt.update(g_dense, dense_state, dense_p)
            dense_p = opt_lib.apply_updates(dense_p, d_updates)
            new_touched, touched_state = emb_opt.rowwise_adagrad_scatter_update(
                touched, g_sub, uniq, row_state, lr=self.cfg.sparse_lr, eps=1e-8)
        row_state = emb_opt.RowAdagradState(accum={**row_state.accum, **touched_state.accum})
        params = {**dense_p, **sparse_p, **new_touched}
        return params, (row_state, dense_state), loss.detach()

    def _fused_step(self, params: Params, opt_state, draws: FusedDraws):
        """The batch sampled on the device from ``draws``, then the dense
        full-table step on it (``repro``'s fused step uses the dense rule)."""
        return self._dense_step(params, opt_state, self._fused_sampler.sample_from(draws))

    def _init_opt_state(self, params: Params):
        if not self._sparse_on:
            return self.opt.init(params)
        sparse_p, dense_p = model_lib.sparse_dense_split(params)
        return (emb_opt.rowwise_adagrad_init(sparse_p, init_accum=self.cfg.adagrad_init_accum),
                self._dense_opt.init(dense_p))

    def _step_fn(self):
        return self._sparse_step if self._sparse_on else self._dense_step

    def _host_batches(self, pipeline: SamplePipeline, num: int,
                      timer: Optional[PhaseTimer] = None) -> Iterator[Tuple[Dict, int]]:
        """Host pipeline -> (host numpy batch, pairs); runs in the prefetch
        thread when there is one. No H2D copy here: the stager makes it."""
        for batch in pipeline.batches(num):
            with phase_scope(timer, "assemble"):
                if self._sparse_on:
                    host = model_lib.sparse_host_batch(self.dataset.graph, batch,
                                                       self.model_cfg, buckets=self._buckets)
                else:
                    host = model_lib.host_batch(self.dataset.graph, batch, self.model_cfg,
                                                slot_counts=self._slot_counts)
            yield host, len(batch.src_ids)

    def _fused_batch_iter(self) -> Iterator[Tuple[FusedDraws, int]]:
        """The fused run's batch stream: each step's draws, taken when the
        step comes from one device generator seeded by ``cfg.seed``."""
        gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        npairs = self.pipe_cfg.batch_pairs
        for _ in range(self.cfg.num_steps):
            yield self._fused_sampler.draw(gen), npairs

    def _barrier(self) -> None:
        device_barrier(device=self.device)

    # ------------------------------------------------------------- planning
    def _calibrate(self, params: Params) -> Dict:
        """Per-batch host cost, the step's time alone and the wall of a few
        pipelined host steps (and, for "auto" sampling, the fused step's),
        measured on separate same-seed pipelines and generators and on
        throwaway parameter copies, so a calibrated run trains exactly as an
        explicitly configured one."""
        cfg = self.cfg
        n = max(2, cfg.calibrate_batches)
        pipeline = make_train_sampler(self.engine, self.pipe_cfg, backend="host", seed=cfg.seed)
        # Batches come in rounds: one walk + ego round fills a carry buffer
        # that the next batches drain in microseconds. Average the window
        # between two round spikes; without two, the plain mean (an
        # over-estimate, which can only bias toward prefetching).
        cap, budget_s = 64, 0.5
        host_it = self._host_batches(pipeline, cap)
        durs: List[float] = []
        host_batches: List[Dict] = []
        elapsed = 0.0
        for i in range(cap):
            t0 = time.perf_counter()
            item = next(host_it, None)
            if item is None:
                break
            d = time.perf_counter() - t0
            durs.append(d)
            elapsed += d
            if len(host_batches) < n:
                host_batches.append(item)
            if i + 1 < n:
                continue
            if len(_round_spikes(durs)) >= 2 or elapsed >= budget_s:
                break
        spikes = _round_spikes(durs)
        if len(spikes) >= 2:
            host_s = sum(durs[spikes[0]:spikes[-1]]) / (spikes[-1] - spikes[0])
        else:
            host_s = elapsed / max(1, len(durs))
        step_fn = self._step_fn()
        step_times: List[float] = []
        for i in range(n):
            p = {k: v.clone() for k, v in params.items()}
            st = self._init_opt_state(p)
            dev, _ = _stage(host_batches[i % len(host_batches)], self.device)
            self._barrier()
            t0 = time.perf_counter()
            step_fn(p, st, dev)
            self._barrier()
            step_times.append(time.perf_counter() - t0)
        meas: Dict = {"host_batch_s": host_s, "step_s": median(step_times[1:])}
        depth = 2 if cfg.prefetch_batches is None else cfg.prefetch_batches
        if depth > 0:
            # a round's worth of steps where the spikes showed one
            steps = min(16, max(n, spikes[-1] - spikes[0] if len(spikes) >= 2 else n))
            meas["pipelined_step_s"] = self._pipelined_step_s(params, depth, steps)
        if cfg.sampling_backend == "auto":
            ok, why = self._build_fused()
            if ok:
                # its own same-seed generator: the run's stream is untouched
                gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
                fused_times: List[float] = []
                for _ in range(n):
                    p = {k: v.clone() for k, v in params.items()}
                    st = self.opt.init(p)
                    self._barrier()
                    t0 = time.perf_counter()
                    self._fused_step(p, st, self._fused_sampler.draw(gen))
                    self._barrier()
                    fused_times.append(time.perf_counter() - t0)
                meas["fused_step_s"] = median(fused_times[1:])
            else:
                meas["fused_ineligible"] = why
                self._count_fused_fallback(why)
        return meas

    def _pipelined_step_s(self, params: Params, depth: int, steps: int) -> float:
        """Mean wall of ``steps`` host steps run as ``train`` runs them (the
        prefetch thread ``depth`` deep, the stager, the step, no sync between
        steps) after one that fills the pipe, on a same-seed pipeline and a
        throwaway parameter copy. The producer has batches to make until the
        last timed step, as in a long run, where a queue it had filled ahead
        would otherwise let the last steps run without it."""
        pipeline = make_train_sampler(self.engine, self.pipe_cfg, backend="host",
                                      seed=self.cfg.seed)
        ahead = depth + 2  # the queue, the batch being put and the stager's
        prefetcher = _Prefetcher(self._host_batches(pipeline, steps + 1 + ahead), depth)
        p = {k: v.clone() for k, v in params.items()}
        st = self._init_opt_state(p)
        step_fn = self._step_fn()
        t0 = 0.0
        try:
            for i, (dev, _) in enumerate(_staged_batches(prefetcher, self.device)):
                p, st, _ = step_fn(p, st, dev)
                if i == 0:
                    self._barrier()
                    t0 = time.perf_counter()
                elif i == steps:
                    break
            self._barrier()
            wall = time.perf_counter() - t0
        finally:
            prefetcher.close()
        return wall / steps

    def _resolve_plan(self, params: Params) -> Dict:
        """The run's plan: sampling backend and prefetch depth. Explicit
        settings win; "auto" knobs are decided by calibration (or legacy
        defaults when it is off or the run is too short to calibrate).
        Cached per trainer."""
        if self._plan is not None:
            return self._plan
        cfg = self.cfg
        auto_prefetch = cfg.prefetch_batches is None
        auto_sampling = cfg.sampling_backend == "auto"
        plan: Dict = {"engine_backend": cfg.engine_backend,
                      "engine_workers": (self._engine_workers if cfg.engine_backend == "mp"
                                         else None),
                      "calibrated": False}
        calibrate = (cfg.auto_backend and (auto_prefetch or auto_sampling)
                     and cfg.num_steps >= cfg.calibrate_min_steps)
        if not calibrate:
            plan["sampling"] = ("fused" if self._fused_sampler is not None
                                and cfg.sampling_backend == "fused" else "host")
            plan["prefetch"] = (0 if plan["sampling"] == "fused"
                                else (2 if auto_prefetch else cfg.prefetch_batches))
            plan["reason"] = (
                "explicit settings" if not (auto_prefetch or auto_sampling)
                else "auto_backend off" if not cfg.auto_backend
                else f"run too short to calibrate (num_steps={cfg.num_steps} < "
                     f"{cfg.calibrate_min_steps}); legacy defaults")
            plan["fused_measured_bytes"] = self._fused_measured_bytes
            self._plan = plan
            return plan
        meas = self._calibrate(params)
        plan["calibrated"] = True
        plan["measurements"] = {k: round(v, 6) if isinstance(v, float) else v
                                for k, v in meas.items()}
        host_s, step_s = meas["host_batch_s"], meas["step_s"]
        serial_est = host_s + step_s
        pipelined_s = meas.get("pipelined_step_s", float("inf"))  # measured, not estimated
        # the host run the plan would make: serial, pipelined or the better one
        host_est = (min(serial_est, pipelined_s) if auto_prefetch
                    else pipelined_s if cfg.prefetch_batches > 0 else serial_est)
        sampling = "host" if auto_sampling else cfg.sampling_backend
        if auto_sampling and meas.get("fused_step_s", float("inf")) < host_est:
            sampling = "fused"
        if sampling == "fused" and self._fused_sampler is None:
            sampling = "host"  # an explicit "fused" that failed the memory gate
        plan["sampling"] = sampling
        if sampling == "fused":
            plan["prefetch"] = 0
            plan["reason"] = (
                f"fused step {meas.get('fused_step_s', 0.0) * 1e3:.2f}ms < host pipeline "
                f"{host_est * 1e3:.2f}ms" if auto_sampling else "explicit fused sampling")
        elif not auto_prefetch:
            plan["prefetch"] = cfg.prefetch_batches
            plan["reason"] = "explicit prefetch_batches"
        elif serial_est > 1.1 * pipelined_s:
            # prefetch pays only on a clear (>10%) measured win
            plan["prefetch"] = 2
            plan["reason"] = (
                f"prefetch: serial est {serial_est * 1e3:.2f}ms > 1.1x pipelined "
                f"{pipelined_s * 1e3:.2f}ms measured (host {host_s * 1e3:.2f}ms, step "
                f"{step_s * 1e3:.2f}ms)")
        else:
            plan["prefetch"] = 0
            plan["reason"] = (
                f"serial: pipelining would save <10% (serial est {serial_est * 1e3:.2f}ms "
                f"vs pipelined {pipelined_s * 1e3:.2f}ms measured)")
        log.info("backend plan: %s", plan["reason"])
        plan["fused_measured_bytes"] = self._fused_measured_bytes
        self._plan = plan
        return plan

    # ------------------------------------------------------------ evaluation
    def evaluate(self, params: Params, split: str = "val") -> Dict[str, float]:
        """Full-graph inference on the device, then recall by
        ``eval_method``: the device top-k, IVF with the default
        ``IVFConfig()`` (as ``repro``'s trainer), or the numpy brute force;
        every held-out user by default."""
        ds = self.dataset
        tel = self.cfg.telemetry
        model = model_lib.Graph4RecModel(self.model_cfg, params)
        with span_scope(tel.tracer if tel is not None else None, "infer.embed_all_nodes",
                        cat="eval"):
            all_emb = embed_all_nodes(model, self.engine, ds.graph,
                                      batch_size=self.cfg.eval_batch_size,
                                      seed=self.cfg.seed + 7, device=self.device)
        user_emb = all_emb[: ds.num_users]
        item_emb = all_emb[ds.num_users : ds.num_users + ds.num_items]
        eval_pairs = ds.val_pairs if split == "val" else ds.test_pairs
        return evaluate_recall(
            user_emb, item_emb, self._train_pairs, eval_pairs,
            top_k=self.cfg.eval_top_k, top_n=self.cfg.eval_top_n,
            max_users=self.cfg.eval_max_users, method=self.cfg.eval_method,
            device=self.device, telemetry=tel,
        )

    # ----------------------------------------------------------------- train
    def train(self, params: Optional[Mapping] = None) -> TrainResult:
        try:
            return self._train(params)
        except BaseException:
            # a failed run (a producer error, a dead engine worker, an
            # interrupt, in calibration or in the loop) leaves no worker behind
            self.close()
            raise

    def _train(self, params: Optional[Mapping]) -> TrainResult:
        cfg = self.cfg
        params = self._device_params(params)
        plan = self._resolve_plan(params)
        tel = cfg.telemetry
        tracer = tel.tracer if tel is not None else None
        # the monitor watches beats and pulses from its own thread and sees
        # only losses already read back, so it never changes the run
        monitor = (HealthMonitor(cfg.health, telemetry=tel, client=self._owned_client)
                   if cfg.health is not None else None)
        self._health_monitor = monitor
        mem = MemoryAccountant(tel.metrics, self.device) if tel is not None else None
        self._memory = mem
        # tracing and health ride the timer (spans, pulses); the summary in
        # TrainResult.attribution stays gated on cfg.attribution alone
        timer = (PhaseTimer(tracer=tracer, pulse=monitor.pulse if monitor is not None else None,
                            device=self.device)
                 if (cfg.attribution or tracer is not None or monitor is not None) else None)
        use_fused = plan["sampling"] == "fused"
        if use_fused:
            opt_state = self.opt.init(params)
            step_fn = self._fused_step
        else:
            opt_state = self._init_opt_state(params)
            step_fn = self._step_fn()
        loss_hist: List[torch.Tensor] = []  # in-flight on-device tail
        losses: List[float] = []
        pending: List[AsyncFloats] = []  # started readbacks, FIFO
        depth = plan["prefetch"]
        drain_tail = max(1, depth + 1)
        evals: List[Dict[str, float]] = []
        pairs_seen = 0
        steps_done = 0
        prefetcher: Optional[_Prefetcher] = None
        if use_fused:
            batch_iter: Iterator = self._fused_batch_iter()
        else:
            pipeline = make_train_sampler(self.engine, self.pipe_cfg, backend="host",
                                          seed=cfg.seed, timer=timer)
            host_iter: Iterator = self._host_batches(pipeline, cfg.num_steps, timer)
            if depth > 0:
                prefetcher = _Prefetcher(
                    host_iter, depth,
                    queue_gauge=(tel.metrics.gauge("prefetch.queue_depth")
                                 if tel is not None else None),
                    telemetry=tel,
                    health_check=monitor.check if monitor is not None else None)
                host_iter = prefetcher
            batch_iter = _staged_batches(
                host_iter, self.device, timer, double_buffer=depth > 0,
                staged_gauge=(tel.metrics.gauge("stager.device_batches")
                              if tel is not None else None))
        if mem is not None:
            # everything long-lived is resident: parameters, optimizer state
            # and, for a fused run, the device sampling tables
            mem.sample("fused" if use_fused else "tables")
        t0 = time.perf_counter()
        if monitor is not None:
            monitor.start()
        try:
            for step, (dev, npairs) in enumerate(batch_iter):
                with phase_scope(timer, "dispatch"), device_span_scope(timer), \
                        transfer_sanitizer(cfg.sanitize_transfers, self.device):
                    params, opt_state, loss = step_fn(params, opt_state, dev)
                loss_hist.append(loss)
                pairs_seen += npairs
                steps_done += 1
                if monitor is not None:
                    monitor.beat(step)
                if cfg.sync_every_step:
                    with phase_scope(timer, "loss_fetch"):
                        self._barrier()
                if cfg.loss_fetch_every and len(loss_hist) >= cfg.loss_fetch_every + drain_tail:
                    done, loss_hist = loss_hist[:-drain_tail], loss_hist[-drain_tail:]
                    with phase_scope(timer, "loss_fetch"):
                        # resolve the previous window (long complete by now)
                        # and start this one's copy without waiting on it
                        if pending:
                            drained = pending.pop(0).resolve()
                            losses.extend(drained)
                            if monitor is not None:
                                monitor.observe_losses(drained)
                        pending.append(host_floats_async(done))
                if cfg.log_every and (step + 1) % cfg.log_every == 0:
                    log.info("step %d loss %.4f", step + 1, host_scalar(loss))
                if cfg.eval_every and (step + 1) % cfg.eval_every == 0:
                    evals.append(self.evaluate(params))
        finally:
            if monitor is not None:
                monitor.stop()
            if prefetcher is not None:
                prefetcher.close()
        self._barrier()
        wall = time.perf_counter() - t0
        observed = len(losses)  # mid-run windows already went past the monitor
        for window in pending:
            losses.extend(window.resolve())
        if loss_hist:
            losses.extend(host_floats_async(loss_hist).resolve())
        if monitor is not None:
            # the tail never went through a mid-run window: a run that
            # diverged in its last steps still fails loudly
            monitor.observe_losses(losses[observed:])
        if mem is not None:
            mem.sample("steady")
        if cfg.eval_at_end:
            evals.append(self.evaluate(params))
            if mem is not None:
                mem.sample("eval")
        if tracer is not None and self._owned_client is not None:
            # the workers' serve spans since the last stats round, into the
            # trace before the caller exports it
            self._owned_client.drain_worker_spans()
        return TrainResult(params=params, losses=losses, eval_history=evals,
                           wall_time_s=wall, pairs_seen=pairs_seen, plan=dict(plan),
                           attribution=(timer.summary(wall, steps_done)
                                        if timer is not None and cfg.attribution else None))
