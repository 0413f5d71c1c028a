"""Graph-service worker: one process serving neighbor queries for its shards.

A worker attaches the shared-memory CSR shards of the partitions it owns
(zero-copy — no adjacency is ever pickled to a worker) and loops on a duplex
pipe serving batched requests. The module imports only NumPy-side code so
spawned workers never pay a torch import (``repro_torch/__init__.py`` and
``repro_torch/graph/__init__.py`` import nothing else either), and a worker
never touches CUDA.

Protocol (one tuple per message, pickled over the pipe):

    ("sample", rid, slot, [(relation, part_id, local_rows, k, pad_id, seed), ...])
        -> ("ok", rid, ("shm", slot))        replies written as int32 arrays
                                             into the worker's reply-slab
                                             slot (offsets via reply_layout)
        -> ("ok", rid, ("pickle", [arrays])) fallback when a reply group is
                                             too large for a slab slot
    ("sampleq", rid, slot, [meta, ...])
        -> ("ok", rid, ("shmq", slot))       whole-call caller-order reply
                                             composed inside the slot
        -> ("ok", rid, ("pickleq", [arrays])) fallback when the reply region
                                             overflows the slot (the request
                                             region still rode in shm)
    ("stats", rid)    -> ("ok", rid, {counter dict})  with the process's
                         resident set ("rss_kb", None off Linux) and whether
                         it has imported torch ("imports_torch"); when
                         tracing, the dict
                         additionally carries the drained span ring
                         ("spans"/"dropped_spans"), "clock_ns" (this
                         process's perf_counter_ns, for client-side clock
                         offset correction) and always "pid"
    ("reset", rid)    -> ("ok", rid, None)
    ("shutdown", rid) -> worker replies ("ok", rid, None) and exits

Both serve ops count exactly one of ``shm_replies``/``pickle_replies`` per
request round, so ``shm_replies + pickle_replies == batches`` holds on
every path (the conservation invariant tests/test_torch_graph_service.py
pins).

Reply transport: only the tag crosses the pipe on the shm path — the sample
payload lands in shared memory (int32: CSR indices are int32, so nothing is
lost), so the client never pays pickle/copy costs proportional to
batch x num_samples and its reader thread stays off the hot path.

Any per-request failure is reported as ("err", rid, {"traceback": ...,
"stats": {...}}) — the client re-raises it as ``EngineWorkerError`` carrying
the worker id, request id, and the worker's stats snapshot at failure — so a
bad relation name in one query can never wedge the service, and the crash
report is actionable without re-running.

Tracing (``trace=True`` at spawn): each serve round appends
``(op_name, rid, t0_ns, dur_ns)`` to a bounded local ring (plain list +
counter — this module never imports repro_torch.obs, workers stay
numpy-only);
the "stats" round drains it. Timestamps are this process's
``perf_counter_ns``; the client corrects them into its own timebase.

Randomness: each sub-request derives ``partition_rng(seed, part_id)`` — the
same derivation the in-process engine uses — so replies are bitwise
independent of which process serves a partition.

Liveness: the loop wakes every ``_POLL_S`` to check its parent is still
alive (spawned workers are re-parented when the trainer dies) and exits on
orphaning, so a crashed trainer never strands graph servers.

NumPy copy of ``repro.graph.service.worker`` for the PyTorch port: the same
protocol and the same draws.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import sys
import time
import traceback
from typing import Dict, List, Sequence

import numpy as np

from repro_torch.graph.engine import partition_rng, sample_csr_rows
from repro_torch.graph.service.shm import (
    ShardManifest, attach_segment, attach_shard, reply_layout, sampleq_layout,
    sampleq_request_layout, slot_view,
)

_POLL_S = 0.25
_SPAN_CAP = 8192  # bounded serve-span ring per worker (tracing only)


def _rss_kb():
    """This process's resident set in KiB (not ``ru_maxrss``: a spawned
    child inherits its parent's peak across ``exec``)."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
    except OSError:
        return None
    return pages * os.sysconf("SC_PAGE_SIZE") // 1024


def _parent_alive() -> bool:
    parent = mp.parent_process()
    if parent is not None:
        return parent.is_alive()
    return os.getppid() != 1  # fork fallback: re-parented to init == orphaned


def worker_main(
    worker_id: int,
    manifests: Sequence[ShardManifest],
    conn,
    slab_name: str = "",
    slot_bytes: int = 0,
    trace: bool = False,
) -> None:
    """Entry point of one graph-service worker process."""
    segs = []
    slab = None
    stats: Dict[str, int] = {
        "worker_id": worker_id,
        "neighbor_requests": 0,
        "sub_requests": 0,
        "batches": 0,
        "busy_ns": 0,
        "shm_replies": 0,
        "pickle_replies": 0,
    }
    # serve-span ring: (op_name, rid, t0_ns, dur_ns), drained by "stats"
    spans: List[tuple] = [None] * _SPAN_CAP if trace else []
    span_n = 0
    try:
        shards: Dict[int, Dict[str, np.ndarray]] = {}
        for m in manifests:
            seg, views = attach_shard(m)
            segs.append(seg)
            shards[m.part_id] = views
        if slab_name:
            slab = attach_segment(slab_name)
            segs.append(slab)
        conn.send(("ready", worker_id, [m.part_id for m in manifests]))
        while True:
            if not conn.poll(_POLL_S):
                if not _parent_alive():
                    return
                continue
            try:
                msg = conn.recv()
            except EOFError:
                return  # client closed its end
            op, rid = msg[0], msg[1]
            if op == "shutdown":
                conn.send(("ok", rid, None))
                return
            try:
                if op == "sample":
                    t0 = time.perf_counter_ns()
                    slot, subs = msg[2], msg[3]
                    offsets = (
                        reply_layout(
                            [(len(rows), k) for _, _, rows, k, _, _ in subs],
                            slot_bytes,
                        )
                        if slab is not None
                        else None
                    )
                    replies: List[np.ndarray] = []
                    served = 0
                    for si, (relation, part_id, local_rows, k, pad_id, seed) in enumerate(subs):
                        views = shards[part_id]
                        out = (
                            slot_view(
                                slab, slot, slot_bytes, offsets[si],
                                (len(local_rows), k),
                            )
                            if offsets is not None
                            else None
                        )
                        sampled = sample_csr_rows(
                            views[f"{relation}/indptr"],
                            views[f"{relation}/indices"],
                            partition_rng(seed, part_id),
                            local_rows,
                            k,
                            pad_id,
                            degs_all=views[f"{relation}/degs"],
                            out=out,
                        )
                        if offsets is None:
                            replies.append(sampled)
                        served += len(local_rows)
                    stats["neighbor_requests"] += served
                    stats["sub_requests"] += len(subs)
                    stats["batches"] += 1
                    if offsets is not None:
                        stats["shm_replies"] += 1
                        payload = ("shm", slot)
                    else:
                        stats["pickle_replies"] += 1
                        payload = ("pickle", replies)
                    dur = time.perf_counter_ns() - t0
                    stats["busy_ns"] += dur
                    if trace:
                        spans[span_n % _SPAN_CAP] = (
                            "worker.sample", rid, t0, dur,
                        )
                        span_n += 1
                    conn.send(("ok", rid, payload))
                elif op == "sampleq":
                    # whole-call exchange (balanced dispatch): requests AND
                    # caller-order composition live in the slab slot, so the
                    # client's GIL never touches per-partition scatters
                    t0 = time.perf_counter_ns()
                    slot, metas = msg[2], msg[3]
                    shapes = [(m[4], m[1]) for m in metas]
                    offsets = sampleq_layout(shapes, slot_bytes)
                    if offsets is not None:
                        req_offs = [(a, b) for a, b, _ in offsets]
                    else:
                        # replies overflow the slot but the request region
                        # rode in shm: sample into fresh arrays and pickle
                        # the caller-order replies back ("pickleq")
                        req_offs = sampleq_request_layout(shapes, slot_bytes)
                    replies = []
                    served = 0
                    num_parts = manifests[0].num_parts
                    for qi, (relation, k, pad_id, seed, n, starts) in enumerate(
                        metas
                    ):
                        a_off, b_off = req_offs[qi]
                        nodes = slot_view(slab, slot, slot_bytes, a_off, (n,))
                        order = slot_view(slab, slot, slot_bytes, b_off, (n,))
                        if offsets is not None:
                            reply = slot_view(
                                slab, slot, slot_bytes, offsets[qi][2], (n, k)
                            )
                        else:
                            reply = np.empty((n, k), dtype=np.int32)
                            replies.append(reply)
                        for p in range(num_parts):
                            lo, hi = starts[p], starts[p + 1]
                            if lo == hi:
                                continue
                            views = shards[p]
                            sampled = sample_csr_rows(
                                views[f"{relation}/indptr"],
                                views[f"{relation}/indices"],
                                partition_rng(seed, p),
                                nodes[lo:hi] // num_parts,
                                k,
                                pad_id,
                                degs_all=views[f"{relation}/degs"],
                                out=np.empty((hi - lo, k), dtype=np.int32),
                            )
                            reply[order[lo:hi]] = sampled
                        served += n
                    stats["neighbor_requests"] += served
                    stats["sub_requests"] += len(metas)
                    stats["batches"] += 1
                    if offsets is not None:
                        stats["shm_replies"] += 1
                        payload = ("shmq", slot)
                    else:
                        stats["pickle_replies"] += 1
                        payload = ("pickleq", replies)
                    dur = time.perf_counter_ns() - t0
                    stats["busy_ns"] += dur
                    if trace:
                        spans[span_n % _SPAN_CAP] = (
                            "worker.sampleq", rid, t0, dur,
                        )
                        span_n += 1
                    conn.send(("ok", rid, payload))
                elif op == "stats":
                    snap = dict(stats)
                    snap["pid"] = os.getpid()
                    snap["rss_kb"] = _rss_kb()
                    snap["imports_torch"] = "torch" in sys.modules
                    if trace:
                        if span_n <= _SPAN_CAP:
                            drained = spans[:span_n]
                        else:
                            i = span_n % _SPAN_CAP
                            drained = spans[i:] + spans[:i]
                        snap["spans"] = drained
                        snap["dropped_spans"] = max(0, span_n - _SPAN_CAP)
                        snap["clock_ns"] = time.perf_counter_ns()
                        spans = [None] * _SPAN_CAP
                        span_n = 0
                    conn.send(("ok", rid, snap))
                elif op == "reset":
                    for key in (
                        "neighbor_requests", "sub_requests", "batches",
                        "busy_ns", "shm_replies", "pickle_replies",
                    ):
                        stats[key] = 0
                    conn.send(("ok", rid, None))
                else:
                    conn.send(("err", rid, f"unknown op {op!r}"))
            except Exception:
                conn.send(("err", rid, {
                    "traceback": traceback.format_exc(),
                    "stats": dict(stats),
                }))
    except (EOFError, BrokenPipeError, KeyboardInterrupt):
        pass
    finally:
        for seg in segs:
            try:
                seg.close()
            except Exception:
                pass
        try:
            conn.close()
        except Exception:
            pass
