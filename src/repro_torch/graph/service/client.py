"""Async multi-process graph-engine client (Graph4Rec §3.1, out-of-process).

``GraphClient`` is a drop-in for ``DistributedGraphEngine`` /
``HeteroGraph.sample_neighbors``: same partition ownership
(``node % num_partitions``), same request counters, and — because both
backends derive per-(query, partition) generators from one seed drawn off
the caller's RNG (see ``graph/engine.py``) — bitwise-identical samples under
a fixed seed. The difference is *where* partitions live: CSR shards sit in
POSIX shared memory and are served by dedicated worker processes, so
sampling scales past the trainer's single Python core and the prefetch
thread is never sampling-bound.

Request flow (the paper's batched-RPC graph servers):

- ``submit`` owner-sorts every query's nodes once (stable argsort) and
  dispatches a whole query group — a walker step or ego hop — as one
  request round. Payloads ride in per-worker shared-memory slab slots, not
  pickles: with "balanced" dispatch the chosen worker receives the sorted
  nodes plus the caller-order index and composes its int32 replies in
  caller order inside the slab, so the client's entire per-sample cost is
  one contiguous copy; with "owner" dispatch (the paper's multi-machine
  layout) per-partition sub-requests fan out to each partition's owner and
  the client row-scatters the replies out of the slabs.
- a background reader thread drains reply tags eagerly into an inbox, so a
  worker can never block on a full reply pipe while the client is blocked
  sending (the classic duplex-pipe deadlock), and worker death is noticed
  immediately instead of hanging a ``recv``.
- ``gather`` waits on the inbox and assembles per-query output arrays;
  slab slots are recycled through a per-worker semaphore ring, which also
  bounds pipelining depth.
- ``sample_many`` / ``sample_neighbors`` are the synchronous wrappers the
  walker, ego sampler, and pipeline consume unchanged.
- with ``local_threshold > 0`` the client serves *small* rounds itself from
  zero-copy views over its own shard segments (hybrid serving): tiny rounds
  are latency-bound, and skipping the pipe round-trip beats any worker on
  hosts where workers share cores with the trainer. The sampling core and
  seeding are exactly the worker's, so results stay bitwise identical.

Every failure mode raises ``EngineWorkerError`` (worker traceback, death, or
timeout) rather than blocking: the trainer's prefetch thread propagates it
to ``train()`` which reaps the workers. Shutdown is idempotent and also
hooked to a ``weakref.finalize`` + the worker-side orphan watchdog, so
worker processes are reaped on trainer exit, exception, or crash.

NumPy copy of ``repro.graph.service.client`` for the PyTorch port, under
``repro``'s metric names. Workers start by ``spawn``, never ``fork``: by the
time the trainer starts them it holds a CUDA context, which a forked child
cannot use; and they start without re-running the calling script, so a
script that imports torch starts numpy-only workers all the same.
"""
from __future__ import annotations

import contextlib
import dataclasses
import multiprocessing as mp
import sys
import threading
import time
import weakref
from multiprocessing import shared_memory
from multiprocessing.connection import wait as conn_wait
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.graph.engine import (
    SEED_BOUND,
    EngineStats,
    partition_rng,
    sample_csr_rows,
)
from repro_torch.graph.service import shm as shm_lib
from repro_torch.graph.service.worker import worker_main


@contextlib.contextmanager
def _main_not_reimported():
    """Start spawned workers without re-running the parent's ``__main__``.

    ``spawn`` re-imports the parent's main module in every child (as
    ``__mp_main__``) unless that module has neither a spec name nor a file,
    as in an interactive session. A worker needs only ``worker_main`` and its
    arguments, which live in importable modules, so hiding both while
    ``Process.start()`` records them keeps whatever the calling script
    imports (torch and its CUDA libraries) out of every worker."""
    main = sys.modules["__main__"]
    spec = main.__spec__
    path = main.__dict__.pop("__file__", None)
    main.__spec__ = None
    try:
        yield
    finally:
        main.__spec__ = spec
        if path is not None:
            main.__file__ = path


class EngineWorkerError(RuntimeError):
    """A graph-service worker failed, died, or timed out.

    ``slot_safe`` records whether the worker is provably done with the
    request's slab slot (it replied with an error, or is dead): the client
    then recycles the slot. On a timeout the worker may still be writing,
    so the slot is deliberately leaked instead of risking reuse.

    Diagnostic context rides on the exception so a crash report is
    actionable without a re-run: ``worker_id``, the last request id
    (``rid``), and the worker's counter snapshot at failure (``stats`` —
    shipped inside the error payload, or the last stats round the client
    saw for a worker that died / timed out; None when no round ever
    completed).
    """

    def __init__(
        self,
        message: str,
        slot_safe: bool = False,
        worker_id: Optional[int] = None,
        rid: Optional[int] = None,
        stats: Optional[Dict] = None,
    ):
        super().__init__(message)
        self.slot_safe = slot_safe
        self.worker_id = worker_id
        self.rid = rid
        self.stats = stats


@dataclasses.dataclass
class PendingRequest:
    """In-flight ``submit`` handle: outputs + per-worker scatter plan."""

    rid: int
    outs: List[np.ndarray]
    # worker -> list of (query_index, scatter row indices, num_samples)
    plan: Dict[int, List[Tuple[int, np.ndarray, int]]]
    # worker -> reply-slab slot reserved for this request
    slots: Dict[int, int]
    # balanced ("sampleq") calls: per-query (n, k) plus the slot layout
    # (computed once at submit; the worker derives the identical layout
    # from the same shapes); both None for owner-dispatch fan-out.
    # ``qpickle`` marks the request-fits/replies-don't case: the request
    # still rides the slab but the worker answers "pickleq" (qlayout None).
    qshapes: Optional[List[Tuple[int, int]]] = None
    qlayout: Optional[List[Tuple[int, int, int]]] = None
    qpickle: bool = False
    t0_ns: int = 0  # submit timestamp when tracing (0 = telemetry off)


def _reap(procs, conns, segs, reader_stop) -> None:
    """Module-level teardown shared by ``shutdown`` and the GC finalizer."""
    reader_stop.set()
    for conn in conns:
        try:
            conn.send(("shutdown", -1))
        except Exception:
            pass
    deadline = time.monotonic() + 5.0
    for proc in procs:
        proc.join(timeout=max(0.0, deadline - time.monotonic()))
    for proc in procs:
        if proc.is_alive():
            proc.terminate()
    for proc in procs:
        if proc.is_alive():
            proc.join(timeout=1.0)
        if proc.is_alive():
            proc.kill()
    for conn in conns:
        try:
            conn.close()
        except Exception:
            pass
    for seg in segs:
        try:
            seg.close()
        except Exception:
            pass
        try:
            seg.unlink()
        except Exception:
            pass  # already unlinked (double shutdown) or never created


class GraphClient:
    """Client for the shared-memory multi-process graph engine."""

    def __init__(
        self,
        graph,
        num_partitions: int = 4,
        num_workers: int = 2,
        client_part: int = 0,
        start_timeout: float = 60.0,
        request_timeout: float = 120.0,
        dispatch: str = "balanced",
        slab_slots: int = 8,
        slot_bytes: int = 4 << 20,
        local_threshold: int = 0,
        telemetry=None,
    ):
        """``slab_slots`` x ``slot_bytes`` is each worker's slab geometry: a
        ring of slots that request/reply payloads land in. In-flight requests
        per worker are capped at the slot count (semaphore), so a slot is
        never overwritten before its gather; a caller that over-pipelines
        gets an EngineWorkerError after ``request_timeout`` instead of a
        deadlock, and a call too large for a slot transparently falls back
        to pipe-pickled payloads.

        ``dispatch`` picks how a query group maps onto workers:

        - "balanced" (default): the whole group goes to the worker with the
          fewest in-flight requests. Because every shard segment is mapped
          into every worker (shared pages cost no extra memory on one host),
          any worker can serve any partition; concurrent callers — e.g. the
          prefetch producer and a mid-training eval, or a pipelined driver —
          then spread across the fleet with one round-trip per call.
        - "owner": sub-requests go to the worker owning each partition (the
          paper's multi-machine layout, where adjacency cannot be shared);
          a single call fans out across workers and gathers their replies.

        Either way the per-(query, partition) seeding is identical, so
        sampling results are bitwise independent of the dispatch mode.

        ``local_threshold`` (0 = off) enables *hybrid serving*: a
        ``sample_many`` round whose total node count is at or below the
        threshold is answered in-process over zero-copy views of the
        client's own shard segments, using the exact worker sampling core
        (``sample_csr_rows`` + ``partition_rng``) — bitwise identical to a
        worker reply by construction. Small rounds (a walker step over a
        few hundred frontier nodes) are latency-bound, not throughput-bound:
        a pipe round-trip costs more than the sampling itself, and on hosts
        where workers share cores with the trainer the IPC is pure loss.
        Large rounds still go to the worker fleet.

        ``telemetry`` (a ``repro_torch.obs.Telemetry``, default None = disabled)
        turns on request-round tracing and metrics: dispatch/wait/compose
        spans per round, round-latency histograms, slab-slot occupancy and
        pickle-fallback counters, and — because workers are spawned with
        ``trace=True`` — worker serve spans collected on the ``stats``
        control round, clock-offset-corrected into the client's timeline.
        Disabled costs one ``is None`` test per instrumented site.
        """
        if hasattr(graph, "graph"):  # accept a DistributedGraphEngine
            engine = graph
            graph = engine.graph
            num_partitions = engine.num_partitions
            client_part = engine.client_part
        self.graph = graph
        self.num_partitions = int(num_partitions)
        self.num_workers = max(1, min(int(num_workers), self.num_partitions))
        self.client_part = int(client_part)
        self.num_nodes = graph.num_nodes
        self.relation_names = graph.relation_names()
        self.stats = EngineStats()
        self.request_timeout = float(request_timeout)
        if dispatch not in ("balanced", "owner"):
            raise ValueError(f"unknown dispatch {dispatch!r}")
        self.dispatch = dispatch
        self.slab_slots = int(slab_slots)
        self.slot_bytes = int(slot_bytes)
        self.local_threshold = int(local_threshold)
        # served-side counters for the hybrid local path, folded into
        # aggregate_stats so the served == issued invariant keeps holding
        # when some rounds never reach a worker
        self._local_lock = threading.Lock()
        self._local_stats = {
            "neighbor_requests": 0, "sub_requests": 0, "batches": 0,
            "busy_ns": 0,
        }
        # telemetry (optional): tracer + metric handles resolved once so the
        # hot path pays one attribute load + is-None test when disabled
        self._tracer = telemetry.tracer if telemetry is not None else None
        if telemetry is not None:
            m = telemetry.metrics
            self._m_round_ns = m.histogram("client.round_latency_ns")
            self._m_rounds_worker = m.counter("client.rounds_worker")
            self._m_rounds_local = m.counter("client.rounds_local")
            self._m_pickle = m.counter("client.pickle_fallback")
            self._m_slab = m.gauge("client.slab_slots_inflight")
        else:
            self._m_round_ns = None
            self._m_rounds_worker = None
            self._m_rounds_local = None
            self._m_pickle = None
            self._m_slab = None
        # last stats snapshot seen per worker (control rounds + err payloads):
        # attached to EngineWorkerError when a worker dies or times out
        self._last_stats: Dict[int, Dict] = {}
        # heartbeat rounds a worker never answered: their late replies are
        # swept from the inbox on the next heartbeat instead of leaking
        self._stale_hb: set = set()

        # Everything allocated below (shm segments, worker processes) is
        # reaped if ANY construction step fails — a failed __init__ must not
        # leave graph-sized segments in /dev/shm or orphaned workers.
        self._segs = []
        self._procs = []
        self._conns = []
        self._reader_stop = threading.Event()
        try:
            # ---- build shards + per-worker reply slabs once, in shared memory
            manifests = []
            for p in range(self.num_partitions):
                seg, manifest = shm_lib.build_shard(graph, p, self.num_partitions)
                self._segs.append(seg)
                manifests.append(manifest)
            # zero-copy views over our own shard segments: the hybrid local
            # path serves small rounds from these (address space, not memory)
            self._local_views = [
                shm_lib.manifest_views(self._segs[p], manifests[p])
                for p in range(self.num_partitions)
            ]
            self._slabs = []
            shm_lib.ensure_room(
                self.num_workers * self.slab_slots * self.slot_bytes,
                f"{self.num_workers} reply slabs",
            )
            for _ in range(self.num_workers):
                slab = shared_memory.SharedMemory(
                    create=True, size=self.slab_slots * self.slot_bytes
                )
                self._slabs.append(slab)
                self._segs.append(slab)

            # ---- spawn workers. Ownership (round-robin) steers "owner"
            # dispatch, but every worker maps every shard: attaching a
            # segment costs address space, not memory, and it is what lets
            # "balanced" dispatch hand any request round to any worker.
            self._worker_of = [
                p % self.num_workers for p in range(self.num_partitions)
            ]
            t_spawn = time.perf_counter()
            ctx = mp.get_context("spawn")
            for w in range(self.num_workers):
                parent_conn, child_conn = ctx.Pipe(duplex=True)
                proc = ctx.Process(
                    target=worker_main,
                    args=(w, manifests, child_conn, self._slabs[w].name,
                          self.slot_bytes, self._tracer is not None),
                    name=f"repro-torch-graph-worker-{w}",
                    daemon=True,
                )
                with _main_not_reimported():
                    proc.start()
                child_conn.close()  # child holds its own copy
                self._conns.append(parent_conn)
                self._procs.append(proc)
            self._slot_sems = [
                threading.Semaphore(self.slab_slots)
                for _ in range(self.num_workers)
            ]
            # free-list (not a ring counter): out-of-order gathers return
            # slots in arbitrary order, and a reservation must never hand
            # out a slot a pending request still owns
            self._free_slots = [
                list(range(self.slab_slots)) for _ in range(self.num_workers)
            ]
            # guards _free_slots/_inflight/_rr (tiny critical sections,
            # taken from gather without the client-wide dispatch lock)
            self._state_lock = threading.Lock()
            self._inflight = [0] * self.num_workers
            # most slab slots ever reserved at once, across workers
            self.slab_high_water = 0
            self._rr = 0

            self._lock = threading.Lock()  # serializes rid alloc + pipe sends
            self._rid = 0
            self._cv = threading.Condition()
            self._inbox: Dict[Tuple[int, int], Tuple[str, object]] = {}
            self._dead: Dict[int, str] = {}  # worker -> reason
            self._closed = False
            self._handshake(start_timeout)
            # spawn to the last "ready": interpreter start, the worker
            # module's numpy imports and the shard attaches
            self.start_s = time.perf_counter() - t_spawn
        except BaseException:
            _reap(self._procs, self._conns, self._segs, self._reader_stop)
            raise

        self._reader = threading.Thread(
            target=self._read_loop, name="repro-torch-graph-client-reader", daemon=True
        )
        self._reader.start()
        self._finalizer = weakref.finalize(
            self, _reap, self._procs, self._conns, self._segs, self._reader_stop
        )

    # ------------------------------------------------------------- lifecycle
    def _handshake(self, timeout: float) -> None:
        deadline = time.monotonic() + timeout
        for w, conn in enumerate(self._conns):
            while not conn.poll(0.1):
                if not self._procs[w].is_alive():
                    raise EngineWorkerError(
                        f"graph worker {w} exited during startup "
                        f"(exitcode={self._procs[w].exitcode})"
                    )
                if time.monotonic() > deadline:
                    raise EngineWorkerError(f"graph worker {w} startup timed out")
            msg = conn.recv()
            if msg[0] != "ready":
                raise EngineWorkerError(f"graph worker {w} bad handshake: {msg!r}")

    def shutdown(self) -> None:
        """Stop workers and release shared memory. Safe to call repeatedly."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._cv.notify_all()
        # finalize() runs _reap exactly once and disarms the GC hook
        self._finalizer()

    close = shutdown  # alias

    def __enter__(self) -> "GraphClient":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    def __del__(self):  # belt and braces; finalize also covers interpreter exit
        try:
            self.shutdown()
        except Exception:
            pass

    # ----------------------------------------------------------- reply inbox
    def _read_loop(self) -> None:
        """Eagerly drain every worker pipe into the inbox.

        Keeping the pipes drained is what makes deep pipelining safe: a
        worker's reply ``send`` always completes, so it is always back to
        reading requests, and a client ``send`` can never deadlock against
        an unread reply.
        """
        conn_of = {id(c): w for w, c in enumerate(self._conns)}
        live = list(self._conns)
        while not self._reader_stop.is_set():
            if not live:
                return
            try:
                ready = conn_wait(live, timeout=0.1)
            except OSError:
                return  # conns closed under us during shutdown
            notify: List[Tuple[Tuple[int, int], Tuple[str, object]]] = []
            for conn in ready:
                w = conn_of[id(conn)]
                try:
                    msg = conn.recv()
                except (EOFError, OSError):
                    with self._cv:
                        self._dead.setdefault(w, "connection closed")
                        self._cv.notify_all()
                    live.remove(conn)
                    continue
                tag, rid = msg[0], msg[1]
                notify.append(((w, rid), (tag, msg[2] if len(msg) > 2 else None)))
            if notify:
                with self._cv:
                    self._inbox.update(notify)
                    self._cv.notify_all()
            # poll worker liveness even when idle: a SIGKILLed worker's pipe
            # stays half-open until the process is collected
            for w, proc in enumerate(self._procs):
                if not proc.is_alive() and w not in self._dead:
                    with self._cv:
                        self._dead[w] = f"process died (exitcode={proc.exitcode})"
                        self._cv.notify_all()

    def _wait_reply(self, w: int, rid: int):
        deadline = time.monotonic() + self.request_timeout
        with self._cv:
            while True:
                if (w, rid) in self._inbox:
                    tag, payload = self._inbox.pop((w, rid))
                    if tag == "err":
                        # the worker answered (and survives): slot reusable
                        if isinstance(payload, dict):
                            tb = payload.get("traceback")
                            snap = payload.get("stats")
                        else:  # plain-string payload (unknown-op reply)
                            tb, snap = payload, None
                        detail = f"\n{tb}"
                        if snap is not None:
                            self._last_stats[w] = snap
                            detail += f"\nworker {w} stats at failure: {snap}"
                        raise EngineWorkerError(
                            f"graph worker {w} failed serving request {rid}:"
                            + detail,
                            slot_safe=True,
                            worker_id=w, rid=rid, stats=snap,
                        )
                    return payload
                if w in self._dead:
                    raise EngineWorkerError(
                        f"graph worker {w} (pid {self._procs[w].pid}) "
                        f"{self._dead[w]} while request {rid} was in flight",
                        slot_safe=True,  # dead workers write nothing more
                        worker_id=w, rid=rid,
                        stats=self._last_stats.get(w),
                    )
                if self._closed:
                    raise EngineWorkerError(
                        "GraphClient was shut down", slot_safe=True,
                        worker_id=w, rid=rid,
                    )
                if time.monotonic() > deadline:
                    # worker may still be writing this slot: do NOT reuse it
                    raise EngineWorkerError(
                        f"graph worker {w} request {rid} timed out "
                        f"after {self.request_timeout:.0f}s",
                        worker_id=w, rid=rid,
                        stats=self._last_stats.get(w),
                    )
                self._cv.wait(timeout=0.1)

    # -------------------------------------------------------------- requests
    def _send(self, w: int, msg) -> None:
        try:
            self._conns[w].send(msg)
        except (BrokenPipeError, OSError) as e:
            raise EngineWorkerError(f"graph worker {w} unreachable: {e}") from e

    def _control(self, op: str):
        """Broadcast a control op to every worker; return per-worker replies."""
        if self._closed:
            raise RuntimeError("GraphClient is shut down")
        with self._lock:
            rid = self._rid = self._rid + 1
            for w in range(self.num_workers):
                self._send(w, (op, rid))
        return [self._wait_reply(w, rid) for w in range(self.num_workers)]

    def _control_one(self, w: int, op: str):
        """One control round against a single worker (serial — the stats
        round brackets it with timestamps for clock-offset estimation)."""
        if self._closed:
            raise RuntimeError("GraphClient is shut down")
        with self._lock:
            rid = self._rid = self._rid + 1
            self._send(w, (op, rid))
        return self._wait_reply(w, rid)

    def _route(self, nodes: np.ndarray):
        """Sort-based owner routing: one stable argsort instead of P boolean
        mask passes. Returns (order, sorted32, starts, cross) where
        nodes[order] is grouped by partition (``sorted32`` is that grouping
        as int32 — CSR ids fit), and partition p's segment is
        ``order[starts[p]:starts[p+1]]``."""
        owners = nodes % self.num_partitions
        order = np.argsort(owners, kind="stable")
        sorted32 = nodes[order].astype(np.int32, copy=False)
        counts = np.bincount(owners, minlength=self.num_partitions)
        starts = np.zeros(self.num_partitions + 1, dtype=np.int64)
        np.cumsum(counts, out=starts[1:])
        cross = len(nodes) - int(counts[self.client_part])
        return order, sorted32, starts, cross

    def submit(self, rng: np.random.Generator, queries: Sequence[Tuple]) -> PendingRequest:
        """Route + dispatch a query group; returns a handle for ``gather``.

        ``queries``: sequence of ``(nodes, relation, num_samples, pad_id)``.
        One seed per query is drawn from ``rng`` (in order — the same stream
        consumption as the in-process engine), so submission interleaving
        across threads never changes any caller's results. Queries that
        share one frontier array (an ego hop asks every relation about the
        same nodes) are routed once.
        """
        if self._closed:
            raise RuntimeError("GraphClient is shut down")
        t0_ns = time.perf_counter_ns() if self._tracer is not None else 0
        P = self.num_partitions
        outs: List[np.ndarray] = []
        qshapes: List[Tuple[int, int]] = []
        metas: List[Tuple] = []
        routed: List[Tuple] = []  # per query: (route, relation, k, pad, seed)
        # id(array) -> (array, routing): the kept reference makes the id a
        # valid key for the duration of this submit (no address reuse).
        # Routing, seed draws, and stats need no client lock: the rng belongs
        # to the caller and the stats mirror locks itself.
        routes: Dict[int, Tuple] = {}
        for nodes, relation, num_samples, pad_id in queries:
            nodes = np.asarray(nodes, dtype=np.int64)
            seed = int(rng.integers(0, SEED_BOUND))
            cached = routes.get(id(nodes))
            if cached is None or cached[0] is not nodes:
                route = self._route(nodes)
                routes[id(nodes)] = (nodes, route)
            else:
                route = cached[1]
            self.stats.add(len(nodes), route[3])
            outs.append(np.empty((len(nodes), num_samples), dtype=np.int64))
            qshapes.append((len(nodes), num_samples))
            metas.append(
                (relation, num_samples, pad_id, seed, len(nodes),
                 tuple(int(s) for s in route[2]))
            )
            routed.append((route, relation, num_samples, pad_id, seed))

        qlayout = qreq = None
        if self.dispatch == "balanced":
            qlayout = shm_lib.sampleq_layout(qshapes, self.slot_bytes)
            if qlayout is not None:
                qreq = [(a, b) for a, b, _ in qlayout]
            else:
                # replies overflow the slot but the request region fits:
                # keep the balanced whole-call exchange — the worker samples
                # in caller order and pickles the reply back ("pickleq") —
                # instead of degrading to owner fan-out
                qreq = shm_lib.sampleq_request_layout(qshapes, self.slot_bytes)
        if qreq is not None and any(n for n, _ in qshapes):
            with self._state_lock:
                # least-loaded worker, round-robin among ties so sequential
                # (sync) callers still exercise the whole fleet
                w = min(
                    range(self.num_workers),
                    key=lambda i: (
                        self._inflight[i], (i - self._rr) % self.num_workers
                    ),
                )
                self._rr = (w + 1) % self.num_workers
            slot = self._reserve_slot(w)
            try:
                # the slot is exclusively ours: slab writes need no lock
                for (route, *_), (n, _k), (a_off, b_off) in zip(
                    routed, qshapes, qreq
                ):
                    order, sorted32, _starts, _cross = route
                    np.copyto(
                        shm_lib.slot_view(
                            self._slabs[w], slot, self.slot_bytes, a_off, (n,)
                        ),
                        sorted32, casting="unsafe",
                    )
                    np.copyto(
                        shm_lib.slot_view(
                            self._slabs[w], slot, self.slot_bytes, b_off, (n,)
                        ),
                        order, casting="unsafe",
                    )
                with self._lock:
                    rid = self._rid = self._rid + 1
                    self._send(w, ("sampleq", rid, slot, metas))
            except BaseException:
                self._release_slot(w, slot)
                raise
            if self._tracer is not None:
                self._tracer.add_span(
                    "client.dispatch", "client", t0_ns,
                    time.perf_counter_ns() - t0_ns, {"rid": rid},
                )
            return PendingRequest(
                rid=rid, outs=outs, plan={w: []}, slots={w: slot},
                qshapes=qshapes, qlayout=qlayout, qpickle=qlayout is None,
                t0_ns=t0_ns,
            )

        # owner dispatch (or a call too large for a slab slot): fan the
        # per-partition sub-requests out to the partitions' owners
        per_worker: Dict[int, List[Tuple]] = {}
        plan: Dict[int, List[Tuple[int, np.ndarray, int]]] = {}
        for qi, (route, relation, num_samples, pad_id, seed) in enumerate(routed):
            order, sorted32, starts, _cross = route
            for p in range(P):
                lo, hi = int(starts[p]), int(starts[p + 1])
                if lo == hi:
                    continue
                w = self._worker_of[p]
                per_worker.setdefault(w, []).append(
                    (relation, p, sorted32[lo:hi] // P, num_samples, pad_id, seed)
                )
                plan.setdefault(w, []).append((qi, order[lo:hi], num_samples))
        slots: Dict[int, int] = {}
        try:
            for w in sorted(per_worker):
                slots[w] = self._reserve_slot(w)
            with self._lock:
                rid = self._rid = self._rid + 1
                for w, subs in per_worker.items():
                    self._send(w, ("sample", rid, slots[w], subs))
        except BaseException:
            for w, slot in slots.items():
                self._release_slot(w, slot)
            raise
        if self._tracer is not None:
            self._tracer.add_span(
                "client.dispatch", "client", t0_ns,
                time.perf_counter_ns() - t0_ns, {"rid": rid},
            )
        return PendingRequest(
            rid=rid, outs=outs, plan=plan, slots=slots, t0_ns=t0_ns
        )

    def _reserve_slot(self, w: int) -> int:
        """Claim a free slab slot on worker ``w`` (bounded wait, no client
        lock held — a saturated worker only stalls its own callers)."""
        if not self._slot_sems[w].acquire(timeout=self.request_timeout):
            raise EngineWorkerError(
                f"no reply slot free on worker {w} after "
                f"{self.request_timeout:.0f}s — more than "
                f"{self.slab_slots} requests pipelined without gather?"
            )
        with self._state_lock:
            self._inflight[w] += 1
            inflight = sum(self._inflight)
            self.slab_high_water = max(self.slab_high_water, inflight)
            if self._m_slab is not None:
                self._m_slab.set(inflight)
            return self._free_slots[w].pop()

    def _release_slot(self, w: int, slot: int) -> None:
        with self._state_lock:
            self._free_slots[w].append(slot)
            self._inflight[w] -= 1
            if self._m_slab is not None:
                self._m_slab.set(sum(self._inflight))
        self._slot_sems[w].release()

    def gather(self, pending: PendingRequest) -> List[np.ndarray]:
        """Collect a ``submit``'s replies and assemble per-query outputs.

        Balanced ("sampleq") calls come back already composed in caller
        order, so the client's whole per-sample cost is one contiguous
        int32 -> int64 copy per query. Owner fan-out replies are scattered
        row-wise straight out of each worker's slab slot — either way, no
        pickling and no intermediate copies.

        Every worker's slot is settled even when some fail: slots are
        recycled whenever the worker is provably done with them
        (``EngineWorkerError.slot_safe``), and the first error is re-raised
        after the remaining workers are drained.
        """
        tracer = self._tracer
        first_err: Optional[BaseException] = None
        for w, scatter in pending.plan.items():
            slot = pending.slots[w]
            release = True
            try:
                w0 = time.perf_counter_ns() if tracer is not None else 0
                kind, payload = self._wait_reply(w, pending.rid)
                if tracer is not None:
                    now = time.perf_counter_ns()
                    tracer.add_span(
                        "client.wait", "client", w0, now - w0,
                        {"rid": pending.rid, "worker": w},
                    )
                    c0 = now
                if kind in ("pickle", "pickleq") and self._m_pickle is not None:
                    self._m_pickle.inc()
                if pending.qshapes is not None:  # balanced whole-call reply
                    if pending.qlayout is not None:  # composed in the slab
                        for out, (n, k), (_, _, r_off) in zip(
                            pending.outs, pending.qshapes, pending.qlayout
                        ):
                            view = shm_lib.slot_view(
                                self._slabs[w], slot, self.slot_bytes,
                                r_off, (n, k),
                            )
                            np.copyto(out, view, casting="unsafe")
                    else:  # "pickleq": caller-order arrays over the pipe
                        for out, arr in zip(pending.outs, payload):
                            np.copyto(out, arr, casting="unsafe")
                elif kind == "shm":
                    shapes = [(len(idx), k) for _, idx, k in scatter]
                    offsets = shm_lib.reply_layout(shapes, self.slot_bytes)
                    for (qi, idx, k), off, shape in zip(scatter, offsets, shapes):
                        view = shm_lib.slot_view(
                            self._slabs[w], payload, self.slot_bytes, off, shape
                        )
                        pending.outs[qi][idx] = view
                else:  # pickle fallback (reply group exceeded a slab slot)
                    for (qi, idx, _), arr in zip(scatter, payload):
                        pending.outs[qi][idx] = arr
                if tracer is not None:
                    tracer.add_span(
                        "client.compose", "client", c0,
                        time.perf_counter_ns() - c0,
                        {"rid": pending.rid, "worker": w},
                    )
            except EngineWorkerError as e:
                release = e.slot_safe
                if first_err is None:
                    first_err = e
            finally:
                if release:
                    self._release_slot(w, slot)
        if first_err is not None:
            raise first_err
        if self._m_round_ns is not None and pending.t0_ns:
            self._m_round_ns.observe(time.perf_counter_ns() - pending.t0_ns)
            self._m_rounds_worker.inc()
        return pending.outs

    # ----------------------------------------------------------- engine API
    def _sample_local(
        self, rng: np.random.Generator, queries: Sequence[Tuple]
    ) -> List[np.ndarray]:
        """Serve one query group in-process over the client's shard views.

        Mirrors the worker exactly — one seed per query drawn in order from
        the caller's generator, owner routing via ``_route``, and
        ``sample_csr_rows(..., degs_all=...)`` under
        ``partition_rng(seed, p)`` per partition — so the reply is bitwise
        identical to what the worker fleet would have produced, and the
        caller's RNG stream advances identically either way.
        """
        if self._closed:
            raise RuntimeError("GraphClient is shut down")
        t0 = time.perf_counter_ns()
        P = self.num_partitions
        outs: List[np.ndarray] = []
        served = 0
        subs = 0
        # Mask routing (not submit's argsort): for a local reply there is no
        # wire payload to pack, and the engine-style per-partition masks are
        # cheaper. Draws are bitwise unchanged either way — a stable argsort
        # groups by owner preserving in-partition order, so the rows each
        # partition_rng(seed, p) sees are identical. Queries sharing one
        # frontier array (an ego hop asks every relation about the same
        # nodes) are routed once — masks and local rows are relation-free.
        routes: Dict[int, Tuple] = {}
        for nodes, relation, num_samples, pad_id in queries:
            nodes = np.asarray(nodes, dtype=np.int64)
            seed = int(rng.integers(0, SEED_BOUND))
            cached = routes.get(id(nodes))
            if cached is None or cached[0] is not nodes:
                owners = nodes % P
                cross = len(nodes) - int((owners == self.client_part).sum())
                parts = []
                for p in range(P):
                    mask = owners == p
                    if mask.any():
                        parts.append((p, mask, nodes[mask] // P))
                routes[id(nodes)] = (nodes, cross, parts)
            else:
                _, cross, parts = cached
            self.stats.add(len(nodes), cross)
            out = np.empty((len(nodes), num_samples), dtype=np.int64)
            for p, mask, local_rows in parts:
                views = self._local_views[p]
                out[mask] = sample_csr_rows(
                    views[f"{relation}/indptr"],
                    views[f"{relation}/indices"],
                    partition_rng(seed, p),
                    local_rows,
                    num_samples,
                    pad_id,
                    degs_all=views[f"{relation}/degs"],
                )
                subs += 1
            served += len(nodes)
            outs.append(out)
        dur = time.perf_counter_ns() - t0
        with self._local_lock:
            s = self._local_stats
            s["neighbor_requests"] += served
            s["sub_requests"] += subs
            s["batches"] += 1
            s["busy_ns"] += dur
        if self._tracer is not None:
            self._tracer.add_span(
                "client.local", "client", t0, dur, {"queries": len(queries)}
            )
            self._m_round_ns.observe(dur)
            self._m_rounds_local.inc()
        return outs

    def sample_many(
        self, rng: np.random.Generator, queries: Sequence[Tuple]
    ) -> List[np.ndarray]:
        if self.local_threshold > 0:
            total = 0
            for nodes, _rel, _k, _pad in queries:
                total += len(nodes)
            if total <= self.local_threshold:
                return self._sample_local(rng, queries)
        return self.gather(self.submit(rng, queries))

    def sample_neighbors(
        self,
        rng: np.random.Generator,
        nodes: np.ndarray,
        relation: str,
        num_samples: int,
        pad_id: int = -1,
    ) -> np.ndarray:
        return self.sample_many(rng, [(nodes, relation, num_samples, pad_id)])[0]

    def step(
        self, rng: np.random.Generator, nodes: np.ndarray, relation: str, pad_id: int = -1
    ) -> np.ndarray:
        return self.sample_neighbors(rng, nodes, relation, 1, pad_id)[:, 0]

    # ---------------------------------------------------------------- stats
    def worker_stats(self) -> List[Dict[str, int]]:
        """Per-worker counter dicts, fetched across the process boundary.

        Serial one-worker-at-a-time rounds, each bracketed with local
        ``perf_counter_ns`` timestamps: when tracing, the worker's reply
        piggybacks its drained serve-span ring plus its own clock reading,
        and the client estimates the clock offset as
        ``worker_clock - (t0 + t1) // 2`` (midpoint of the round trip)
        before ingesting the spans into the tracer's timeline. Each
        snapshot is also cached as the worker's last-known stats for
        ``EngineWorkerError`` context.
        """
        out: List[Dict[str, int]] = []
        for w in range(self.num_workers):
            t0 = time.perf_counter_ns()
            snap = self._control_one(w, "stats")
            t1 = time.perf_counter_ns()
            out.append(self._absorb_stats(w, snap, t0, t1))
        return out

    def _absorb_stats(self, w: int, snap: Dict, t0: int, t1: int) -> Dict:
        """Fold one stats reply in: strip the piggybacked trace payload
        (span ingest with the round-trip-midpoint clock offset) and cache
        the snapshot as the worker's last-known stats."""
        spans = snap.pop("spans", None)
        dropped = snap.pop("dropped_spans", 0)
        clock = snap.pop("clock_ns", None)
        self._last_stats[w] = dict(snap)
        if self._tracer is not None and spans:
            offset = (clock - (t0 + t1) // 2) if clock is not None else 0
            self._tracer.ingest(
                f"graph-worker-{w}", snap.get("pid", -(w + 1)),
                [
                    (name, "worker", s0, d, {"rid": r})
                    for name, r, s0, d in spans
                ],
                offset_ns=offset, dropped=dropped,
            )
        return snap

    def heartbeat(self, timeout: float = 5.0) -> Dict[int, bool]:
        """Bounded per-worker liveness probe on the ``stats`` control round.

        The health monitor's worker-liveness vehicle (no new IPC op):
        unlike :meth:`worker_stats`, a silent worker neither raises nor
        blocks for ``request_timeout`` — each worker gets ``timeout``
        seconds and a miss is reported as ``False``. The missed round's
        rid is remembered and its late reply (if the worker was merely
        slow) is swept from the inbox on the next heartbeat, so repeated
        probes never leak inbox entries. A responsive reply is absorbed
        exactly like a stats round (span ingest + last-stats cache), so
        heartbeats double as periodic trace drains.
        """
        if self._closed:
            return {}
        with self._cv:
            for key in [k for k in self._stale_hb if k in self._inbox]:
                self._inbox.pop(key)
                self._stale_hb.discard(key)
        alive: Dict[int, bool] = {}
        for w in range(self.num_workers):
            with self._cv:
                if w in self._dead:
                    alive[w] = False
                    continue
            t0 = time.perf_counter_ns()
            try:
                with self._lock:
                    rid = self._rid = self._rid + 1
                    self._send(w, ("stats", rid))
            except EngineWorkerError:
                alive[w] = False
                continue
            deadline = time.monotonic() + timeout
            reply = None
            with self._cv:
                while True:
                    if (w, rid) in self._inbox:
                        tag, payload = self._inbox.pop((w, rid))
                        if tag == "ok":
                            reply = payload
                        break
                    if (
                        w in self._dead
                        or self._closed
                        or time.monotonic() >= deadline
                    ):
                        break
                    self._cv.wait(timeout=0.1)
            t1 = time.perf_counter_ns()
            if reply is None:
                self._stale_hb.add((w, rid))
                alive[w] = False
            else:
                self._absorb_stats(w, reply, t0, t1)
                alive[w] = True
        return alive

    def drain_worker_spans(self) -> None:
        """Pull every worker's pending serve spans into the tracer.

        A convenience alias for a tracing-time ``worker_stats`` round —
        call once before export so spans since the last stats round are
        not lost. No-op when telemetry is off.
        """
        if self._tracer is not None:
            self.worker_stats()

    def aggregate_stats(self) -> Dict[str, float]:
        """Cross-partition totals summed over every worker process.

        ``neighbor_requests`` here counts queries as *served*; it must equal
        the client-side ``stats.neighbor_requests`` mirror (which counts
        queries as *issued*) — the invariant the service tests pin. Rounds
        answered by the hybrid local path (``local_threshold``) are folded
        in as served-side counts and also broken out under ``local_*`` keys.
        """
        per = self.worker_stats()
        with self._local_lock:
            local = dict(self._local_stats)
        agg: Dict[str, float] = {
            "neighbor_requests": (
                sum(s["neighbor_requests"] for s in per)
                + local["neighbor_requests"]
            ),
            "sub_requests": sum(s["sub_requests"] for s in per)
            + local["sub_requests"],
            "batches": sum(s["batches"] for s in per) + local["batches"],
            "busy_s": (sum(s["busy_ns"] for s in per) + local["busy_ns"]) / 1e9,
            "num_workers": len(per),
            "local_neighbor_requests": local["neighbor_requests"],
            "local_batches": local["batches"],
        }
        return agg

    def reset_stats(self) -> None:
        self.stats.reset()
        with self._local_lock:
            for key in self._local_stats:
                self._local_stats[key] = 0
        self._control("reset")
