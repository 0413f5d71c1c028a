"""CUDA wrapper: IVF gather-then-score shortlist (``csrc/ivf.cu``).

The Hopper counterpart of ``repro/kernels/ivf.py:ivf_list_topk_pallas``:
(Q, d) f32 queries against the probed lists of an (Ip, d) int8 code table
with (Ip, 1) f32 scales, each list given by its (Q, P) start and length,
give the ``shortlist`` best ((Q, S) f32 approximate scores, (Q, S) int32
packed-row indices), best first, the lower flat (probe, offset) index first
on equal scores, (-inf, -1) where no candidate is left. The source file
carries the design note.

One launch a call, in one of two regimes that ``plan_launch`` picks from
the sizes alone (the lengths stay on the card):

- ``shared``: a query's P * lpad candidate keys live in shared memory,
  split by probes over the blocks of one thread-block cluster (at most
  ``MAX_CLUSTER``); the cluster selects the S best once and writes them.
  The cluster size is the smallest whose blocks fit, raised only while the
  Q * c blocks leave one wave of the card's resident blocks short.
- ``global``: where even ``MAX_CLUSTER`` blocks cannot hold them, one block
  a query merges each sorted chunk into a running list in a (2, Q, S)
  64-bit workspace that the wrapper allocates.

The wrapper reads nothing back, so a search that calls it does not sync.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, Tuple

import torch

from repro_torch.kernels import build

MAX_CLUSTER = 8  # blocks a cluster, the portable size (csrc/ivf.cu:kMaxCluster)
SHARED_CAP = 232_448  # dynamic shared memory a block may use (227 KB on an H100)
BINS = 256  # radix-select histogram bins (csrc/ivf.cu:kBins)
RANK_CHUNK = 2048  # a peer's keys a cluster block copies at a time (csrc/ivf.cu:kRankChunk)
# How a shared-path block reads its code rows (csrc/ivf.cu:kBytes .. kPre4):
# byte loads, or 16-byte loads a row ahead into registers at 2 or 4 units a
# row (d 32, 64)
LOADS = ("bytes", "prefetch2", "prefetch4")

# Kernel launches since the last reset (chip_smoke.py reads and resets it):
# one per call, in either regime.
launches = 0


def _r16(n: int) -> int:
    return -(-n // 16) * 16


def load_mode(d: int, aligned: bool) -> str:
    """How the shared path reads code rows (csrc/ivf.cu:load_mode): at d 32
    and 64 on a 16-byte aligned table, each thread's next row loaded into
    registers while it scores this one; else byte loads."""
    modes = {32: "prefetch2", 64: "prefetch4"}
    return modes.get(d, "bytes") if aligned else "bytes"


def keep_cap(probes_per_block: int, lpad: int, shortlist: int) -> int:
    """The most keys a block keeps (csrc/ivf.cu:keep_cap): the select stops
    at S + S/8 + 32 kept keys, and a block keeps no more than its slots."""
    return min(probes_per_block * lpad, shortlist + shortlist // 8 + 32)


def shared_bytes(probes_per_block: int, lpad: int, d: int, cluster: int = 1,
                 shortlist: int = 1) -> int:
    """Dynamic shared memory of a shared-path block holding that many
    probes of lpad rows at width d (csrc/ivf.cu:shared_bytes): the keys, two
    histograms and their cluster sum, the query, the lists' starts and the
    prefix of their lengths, a few scalars and, in a cluster, each kept
    key's count and a chunk of a peer's keys."""
    rank = (_r16(4 * keep_cap(probes_per_block, lpad, shortlist)) + RANK_CHUNK * 8
            if cluster > 1 else 0)
    return (_r16(probes_per_block * lpad * 8) + 3 * BINS * 4 + _r16(d * 4)
            + _r16((2 * probes_per_block + 1) * 4) + 64 + rank)


def block_probes(num_probes: int, cluster: int, rank: int) -> range:
    """The probes block ``rank`` of a query's cluster scores: dealt round
    the blocks, nearest first (csrc/ivf.cu:ivf_select_kernel)."""
    return range(rank, num_probes, cluster)


def plan_launch(num_queries: int, num_probes: int, lpad: int, d: int, shortlist: int,
                num_sms: int, residency: Callable[[int], Tuple[int, int]]) -> dict:
    """The launch for these sizes. ``residency(c)`` is (resident blocks an
    SM, resident clusters on the card) of the shared path in clusters of c
    blocks, each holding ``ceil(P / c)`` probes of lpad rows.

    The smallest cluster size in 1 .. min(``MAX_CLUSTER``, P) whose blocks
    fit ``SHARED_CAP`` and the card, raised to the next that fits only while
    the Q * c blocks are fewer than one wave of resident blocks (the
    blocks an SM times the SMs, or the resident clusters' blocks, the
    fewer). None fits: the global path (cluster 0)."""
    P, Q = num_probes, num_queries
    plan = None
    for c in range(1, min(MAX_CLUSTER, P) + 1):
        ppb = -(-P // c)
        smem = shared_bytes(ppb, lpad, d, c, shortlist)
        if smem > SHARED_CAP:
            continue
        per_sm, clusters = residency(c)
        if per_sm < 1 or clusters < 1:
            continue
        wave = min(num_sms * per_sm, clusters * c)
        plan = {"regime": "shared", "cluster": c, "probes_per_block": ppb,
                "shared_bytes": smem, "blocks": Q * c, "blocks_per_sm": per_sm,
                "resident_clusters": clusters, "wave": wave, "waves": -(-Q * c // wave)}
        if Q * c >= wave:
            break
    if plan is None:
        return {"regime": "global", "cluster": 0, "probes_per_block": P, "blocks": Q,
                "workspace_bytes": 2 * Q * shortlist * 8}
    return plan


@functools.lru_cache(maxsize=None)
def kernel_attrs(load: str, cluster: int, probes_per_block: int, lpad: int, d: int,
                 shortlist: int) -> dict:
    """The shared path's instantiation for ``load`` (one of ``LOADS``) with
    blocks of that many probes and that shortlist in clusters of
    ``cluster``, or the global
    path's kernel for cluster 0: registers a thread, local memory bytes
    (spills and stack), dynamic shared memory bytes, resident blocks an SM
    and resident clusters on the current card (0 for the global path)."""
    out = (ctypes.c_int * 5)()
    build.check(build.library().g4r_ivf_attrs(LOADS.index(load), cluster, probes_per_block,
                                              lpad, d, shortlist, out),
                "ivf_list_topk attributes")
    return {"registers": out[0], "local_bytes": out[1], "shared_bytes": out[2],
            "blocks_per_sm": out[3], "clusters": out[4]}


def launch_plan(queries: torch.Tensor, codes: torch.Tensor, num_probes: int, lpad: int,
                shortlist: int) -> dict:
    """The launch ``ivf_list_topk_cuda`` makes for these inputs."""
    Q, d = queries.shape
    dev = queries.device
    load = load_mode(d, codes.data_ptr() % 16 == 0)
    with torch.cuda.device(dev):
        num_sms = torch.cuda.get_device_properties(dev).multi_processor_count

        def residency(c):
            a = kernel_attrs(load, c, -(-num_probes // c), lpad, d, shortlist)
            return a["blocks_per_sm"], a["clusters"]

        return dict(plan_launch(Q, num_probes, lpad, d, shortlist, num_sms, residency),
                    load=load)


def _checked(queries, codes, scales, starts, lengths, lpad, shortlist) -> None:
    if queries.dim() != 2 or codes.dim() != 2 or queries.shape[1] != codes.shape[1]:
        raise ValueError(f"ivf_list_topk wants (Q, d) queries and (Ip, d) codes; got "
                         f"{tuple(queries.shape)} and {tuple(codes.shape)}")
    Q = queries.shape[0]
    Ip = codes.shape[0]
    if scales.numel() != Ip:
        raise ValueError(f"scales must hold one value per code row ({Ip}); got "
                         f"{tuple(scales.shape)}")
    if starts.dim() != 2 or starts.shape[0] != Q or lengths.shape != starts.shape:
        raise ValueError(f"starts and lengths must be (Q={Q}, P); got "
                         f"{tuple(starts.shape)} and {tuple(lengths.shape)}")
    P = starts.shape[1]
    if lpad < 1 or P < 1 or not 0 < shortlist <= P * lpad:
        raise ValueError(f"need lpad >= 1, P >= 1 and shortlist in [1, P * lpad]; got "
                         f"lpad={lpad}, P={P}, shortlist={shortlist}")
    if P * lpad >= 2**31:
        raise ValueError(f"flat candidate indices are 32-bit; P * lpad = {P * lpad}")
    want = {"queries": (queries, torch.float32), "codes": (codes, torch.int8),
            "scales": (scales, torch.float32), "starts": (starts, torch.int32),
            "lengths": (lengths, torch.int32)}
    for name, (t, dtype) in want.items():
        if t.dtype != dtype:
            raise TypeError(f"ivf_list_topk wants {name} as {dtype}; got {t.dtype}")
    dev = queries.device
    if not queries.is_cuda or any(t.device != dev for t, _ in want.values()):
        raise ValueError("ivf_list_topk kernel wants every input on one CUDA device; got "
                         + ", ".join(f"{n} on {t.device}" for n, (t, _) in want.items()))
    if not all(t.is_contiguous() for t, _ in want.values()):
        raise ValueError("ivf_list_topk kernel wants contiguous inputs")


def _launch(queries, codes, scales, starts, lengths, lpad, shortlist, cluster):
    global launches
    Q, d = queries.shape
    P = starts.shape[1]
    dev = queries.device
    out_s = torch.empty((Q, shortlist), dtype=torch.float32, device=dev)
    out_r = torch.empty((Q, shortlist), dtype=torch.int32, device=dev)
    if Q == 0:
        return out_s, out_r
    ws = (torch.empty((2, Q, shortlist), dtype=torch.int64, device=dev) if cluster == 0
          else None)
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.g4r_ivf_list_topk_i8(
            queries.data_ptr(), codes.data_ptr(), scales.data_ptr(), starts.data_ptr(),
            lengths.data_ptr(), None if ws is None else ws.data_ptr(), out_s.data_ptr(),
            out_r.data_ptr(), Q, P, d, lpad, shortlist, codes.shape[0], cluster, stream,
        )
    build.check(err, "ivf_list_topk")
    launches += 1
    return out_s, out_r


def ivf_list_topk_cuda(
    queries: torch.Tensor,
    codes: torch.Tensor,
    scales: torch.Tensor,
    starts: torch.Tensor,
    lengths: torch.Tensor,
    lpad: int,
    shortlist: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Q, d) f32, (Ip, d) int8, (Ip, 1) f32, (Q, P) int32 starts and
    lengths on one CUDA device -> ((Q, S) f32 scores, (Q, S) int32 rows)."""
    _checked(queries, codes, scales, starts, lengths, lpad, shortlist)
    if queries.shape[0] == 0:
        return _launch(queries, codes, scales, starts, lengths, lpad, shortlist, 1)
    plan = launch_plan(queries, codes, starts.shape[1], lpad, shortlist)
    return _launch(queries, codes, scales, starts, lengths, lpad, shortlist, plan["cluster"])


def ivf_list_topk_planned(
    queries: torch.Tensor,
    codes: torch.Tensor,
    scales: torch.Tensor,
    starts: torch.Tensor,
    lengths: torch.Tensor,
    lpad: int,
    shortlist: int,
    cluster: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ivf_list_topk_cuda`` with the plan given: the shared path in
    clusters of ``cluster`` blocks (1 .. min(``MAX_CLUSTER``, P), each block
    within ``SHARED_CAP``), or the global path (0). For tests and
    measurements of the plans the wrapper does not pick."""
    _checked(queries, codes, scales, starts, lengths, lpad, shortlist)
    P, d = starts.shape[1], queries.shape[1]
    if cluster != 0 and not (1 <= cluster <= min(MAX_CLUSTER, P) and shared_bytes(
            -(-P // cluster), lpad, d, cluster, shortlist) <= SHARED_CAP):
        raise ValueError(f"no shared-path plan of {cluster} blocks a query holds P={P} "
                         f"probes of lpad={lpad} rows at d={d} in {SHARED_CAP} bytes a block")
    return _launch(queries, codes, scales, starts, lengths, lpad, shortlist, cluster)
