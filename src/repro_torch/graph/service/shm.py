"""POSIX shared-memory CSR shards for the out-of-process graph engine.

The parent (trainer) process partitions the graph once — the same
``node_id % num_partitions`` ownership and vectorized CSR slice-gather the
in-process engine uses — and packs each partition's per-relation
``(indptr, indices)`` arrays into ONE ``multiprocessing.shared_memory``
segment. Workers attach by name and get zero-copy read-only NumPy views, so
partition adjacency is materialized exactly once no matter how many worker
processes serve it, and spawning a worker costs no graph serialization.

A ``ShardManifest`` (plain picklable dataclass) carries everything a worker
needs to reconstruct the views: segment name plus per-array offset / shape /
dtype. Segment lifetime is owned by the parent: workers only ``close()``
their mappings, the creator ``unlink()``s on shutdown.

NumPy copy of ``repro.graph.service.shm`` for the PyTorch port: the same
shard layout, so a shard built by either package attaches in the other.
"""
from __future__ import annotations

import dataclasses
import errno
import os
import weakref
from multiprocessing import shared_memory
from typing import Dict, List, Optional, Tuple

import numpy as np

_ALIGN = 64  # cache-line align each array inside a segment
SHM_DIR = "/dev/shm"  # where Linux keeps POSIX shared-memory segments


def shm_free_bytes() -> Optional[int]:
    """Free bytes of the shared-memory filesystem (None where there is no
    ``/dev/shm`` to ask)."""
    try:
        st = os.statvfs(SHM_DIR)
    except OSError:
        return None
    return st.f_bavail * st.f_frsize


def ensure_room(nbytes: int, what: str) -> None:
    """Raise before creating a segment that ``/dev/shm`` cannot hold.

    Segments are sparse until written, so an oversized one is created
    without complaint and the first write past the free space kills the
    writer with SIGBUS; this check turns that into an error at construction.
    """
    free = shm_free_bytes()
    if free is not None and nbytes > free:
        raise OSError(
            errno.ENOSPC,
            f"{what} needs {nbytes} bytes of shared memory; {SHM_DIR} has {free} free",
        )


def _unlink_by_name(name: str) -> None:
    """Finalizer backstop: unlink a segment by name if it still exists.

    Keyed by name (not the SharedMemory object) so the finalizer holds no
    reference to the segment it guards; if the owner already unlinked on the
    explicit close path this is a no-op.
    """
    try:
        seg = attach_segment(name)
    except FileNotFoundError:
        return
    try:
        seg.unlink()
    finally:
        seg.close()


@dataclasses.dataclass(frozen=True)
class ArraySpec:
    """Location of one NumPy array inside a shared-memory segment."""

    offset: int
    shape: Tuple[int, ...]
    dtype: str


@dataclasses.dataclass(frozen=True)
class ShardManifest:
    """Everything needed to attach one partition's CSR shard."""

    seg_name: str
    part_id: int
    num_parts: int
    num_nodes: int
    # "<relation>/indptr" and "<relation>/indices" -> location
    arrays: Dict[str, ArraySpec]


def _aligned(nbytes: int) -> int:
    return (nbytes + _ALIGN - 1) // _ALIGN * _ALIGN


def build_shard(
    graph, part_id: int, num_parts: int
) -> Tuple[shared_memory.SharedMemory, ShardManifest]:
    """Gather partition ``part_id``'s owned CSR rows into a shm segment.

    Row ownership and local re-indexing (local row = global // num_parts)
    match ``engine._Partition`` exactly, so a worker serving this shard is
    bitwise-interchangeable with the in-process partition.
    """
    from repro_torch.graph.engine import _gather_rows

    owned = np.arange(part_id, graph.num_nodes, num_parts, dtype=np.int64)
    packed: List[Tuple[int, np.ndarray]] = []
    arrays: Dict[str, ArraySpec] = {}
    offset = 0
    for name, csr in graph.relations.items():
        indptr, indices = _gather_rows(csr.indptr, csr.indices, owned)
        # degrees are precomputed shard metadata: the worker's hot loop then
        # does one gather per query instead of two gathers + a subtraction
        degs = np.diff(indptr)
        for key, arr in (
            (f"{name}/indptr", indptr),
            (f"{name}/indices", indices),
            (f"{name}/degs", degs),
        ):
            arr = np.ascontiguousarray(arr)
            arrays[key] = ArraySpec(offset, tuple(arr.shape), str(arr.dtype))
            packed.append((offset, arr))
            offset += _aligned(arr.nbytes)
    ensure_room(offset, f"partition {part_id}'s CSR shard")
    seg = shared_memory.SharedMemory(create=True, size=max(offset, 1))
    # the explicit unlink path is GraphClient.close(); this finalizer is the
    # backstop that keeps /dev/shm clean if the creator dies before closing
    weakref.finalize(seg, _unlink_by_name, seg.name)
    for off, arr in packed:
        view = np.ndarray(arr.shape, dtype=arr.dtype, buffer=seg.buf, offset=off)
        view[...] = arr
    manifest = ShardManifest(
        seg_name=seg.name,
        part_id=part_id,
        num_parts=num_parts,
        num_nodes=int(graph.num_nodes),
        arrays=dict(arrays),
    )
    return seg, manifest


def attach_segment(name: str) -> shared_memory.SharedMemory:
    """Attach an existing segment without resource-tracker registration
    (the pre-3.13 equivalent of ``track=False``): attachers share the
    creator's tracker process, so letting an attach register — or worse,
    unregister — the segment corrupts the creator's accounting and spews
    KeyErrors or spurious leak warnings at teardown. The creator alone owns
    unlink."""
    try:  # tracker internals are stable across 3.8-3.12 but guard anyway
        from multiprocessing import resource_tracker

        orig_register = resource_tracker.register

        def _register_skip_shm(name_, rtype):
            if rtype != "shared_memory":
                orig_register(name_, rtype)

        resource_tracker.register = _register_skip_shm
    except Exception:
        orig_register = None
        resource_tracker = None
    try:
        return shared_memory.SharedMemory(name=name)
    finally:
        if resource_tracker is not None and orig_register is not None:
            resource_tracker.register = orig_register


# ------------------------------------------------------------- reply slabs
def reply_layout(
    shapes: List[Tuple[int, int]], slot_bytes: int, itemsize: int = 4
) -> Optional[List[int]]:
    """Byte offsets of each reply array inside one slab slot, or None if the
    replies do not fit (-> the worker falls back to pickling them).

    Computed identically by the worker (to write) and the client (to read),
    from the shapes the client already knows — so only a tiny tag crosses
    the pipe for a shared-memory reply.
    """
    offsets: List[int] = []
    offset = 0
    for n, k in shapes:
        offsets.append(offset)
        offset += _aligned(n * k * itemsize)
    if offset > slot_bytes:
        return None
    return offsets


def sampleq_layout(
    shapes: List[Tuple[int, int]], slot_bytes: int
) -> Optional[List[Tuple[int, int, int]]]:
    """Slot layout for a whole-call ("sampleq") exchange, one (nodes_offset,
    order_offset, reply_offset) triple per query.

    The client writes each query's owner-sorted global nodes and caller-order
    indices (both int32) into the slot; the worker samples every partition
    segment and scatters the replies into the reply region *in caller order*,
    so the client's entire per-sample cost is one contiguous int32 -> int64
    copy. Returns None when the call does not fit (-> owner-dispatch
    fallback).
    """
    offsets: List[Tuple[int, int]] = []
    offset = 0
    for n, _ in shapes:
        a = offset
        offset += _aligned(n * 4)
        b = offset
        offset += _aligned(n * 4)
        offsets.append((a, b))
    out: List[Tuple[int, int, int]] = []
    for (a, b), (n, k) in zip(offsets, shapes):
        out.append((a, b, offset))
        offset += _aligned(n * k * 4)
    if offset > slot_bytes:
        return None
    return out


def sampleq_request_layout(
    shapes: List[Tuple[int, int]], slot_bytes: int
) -> Optional[List[Tuple[int, int]]]:
    """Request-region offsets of a "sampleq" slot: one (nodes_offset,
    order_offset) pair per query — the prefix of :func:`sampleq_layout`
    without the reply region.

    Used when the *replies* overflow the slot but the request still fits:
    the client ships the request through the slab as usual and the worker
    answers with a pickled caller-order reply ("pickleq") instead of
    forcing the whole call down to owner-dispatch fan-out. Returns None
    when even the request region does not fit. Computed identically on
    both sides from the shapes the client already knows, like the other
    layouts.
    """
    offsets: List[Tuple[int, int]] = []
    offset = 0
    for n, _ in shapes:
        a = offset
        offset += _aligned(n * 4)
        b = offset
        offset += _aligned(n * 4)
        offsets.append((a, b))
    if offset > slot_bytes:
        return None
    return offsets


def slot_view(
    seg: shared_memory.SharedMemory,
    slot: int,
    slot_bytes: int,
    offset: int,
    shape: Tuple[int, int],
) -> np.ndarray:
    """An int32 (n, k) view into slab ``slot`` at ``offset``."""
    return np.ndarray(
        shape, dtype=np.int32, buffer=seg.buf, offset=slot * slot_bytes + offset
    )


def attach_shard(
    manifest: ShardManifest, writeable: bool = False
) -> Tuple[shared_memory.SharedMemory, Dict[str, np.ndarray]]:
    """Attach a shard by manifest: zero-copy views over the live segment.

    The attach is deliberately hidden from ``resource_tracker`` (the
    pre-3.13 equivalent of ``track=False``): workers share the creator's
    tracker process, so letting an attach register — or worse, unregister —
    the segment corrupts the creator's accounting and spews KeyErrors or
    spurious leak warnings at teardown. The creator alone owns unlink.
    """
    seg = attach_segment(manifest.seg_name)
    return seg, manifest_views(seg, manifest, writeable)


def manifest_views(
    seg: shared_memory.SharedMemory,
    manifest: ShardManifest,
    writeable: bool = False,
) -> Dict[str, np.ndarray]:
    """Zero-copy array views over an already-held segment (either the
    creator's own handle or one returned by :func:`attach_shard`)."""
    views: Dict[str, np.ndarray] = {}
    for key, spec in manifest.arrays.items():
        arr = np.ndarray(
            spec.shape, dtype=np.dtype(spec.dtype), buffer=seg.buf, offset=spec.offset
        )
        arr.flags.writeable = writeable
        views[key] = arr
    return views
