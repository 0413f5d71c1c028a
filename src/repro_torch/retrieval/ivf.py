"""IVF (inverted-file) approximate retrieval over an int8 index resident on
the device: the port of ``repro.retrieval.ivf``.

The item table is clustered into ``nlist`` cells (spherical k-means on the
normalized rows); each cell's members form one contiguous run of packed
rows (CSR ``offsets``; ``order`` maps packed row -> item id), stored as
per-row absmax int8 ``codes`` and f32 ``scales``. A search scores only the
``nprobe`` cells nearest each query:

1. centroid scores ``q . centroid`` (f32 row sums, no TF32) and the
   top-nprobe cells, the lower cell index first on ties;
2. the shortlist: ``kernels.ops.ivf_list_topk`` scores every probed list's
   rows as ``(codes . q) * scale`` and keeps the ``shortlist`` best (the
   CUDA kernel on the card, its plain version on the CPU);
3. packed rows -> item ids, the exclusion mask;
4. the exact re-rank: the survivors re-scored against the exact f32 table,
   re-sorted by ascending id, then a first-occurrence top-k, so on equal
   exact scores the lower id wins, as in ``retrieval.topk``. At
   ``nprobe >= nlist`` the shortlist is the whole probe budget and the
   result equals the exact oracle.

The build is the reference's numpy code, copied, drawing the same
``np.random.default_rng(config.seed)`` stream in the same order, so the
index fields are bitwise equal to ``repro``'s on one machine. An
``IVFIndex`` uploads centroids, codes, scales, order, offsets and (with
``keep_exact_device``) the exact table once, when it is made; ``search()``
moves only the queries and exclusions in and the (Q, k) results out. It
sweeps the queries in blocks that keep the device working set of one block
(the (Q, S) shortlist, the kernel's workspace, the re-rank's (Q, S, d)
gather) under ``SEARCH_BUDGET_BYTES``; queries are independent, so the
blocking changes no result.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.ref import desc_order
from repro_torch.lint.sanitizer import host_array
from repro_torch.retrieval.topk import _deterministic_topk_rows, to_device

_INT32_MAX = np.iinfo(np.int32).max
# auto assignment mode switches to hierarchical above this many
# item x centroid score pairs (the full-table assignment GEMM cost)
_HIER_AUTO_THRESHOLD = 2_000_000_000
# truncated spill preference depth: a full (n_spill, nlist) stable argsort
# is tens of GB at the 10M arm; 32 next-best cells place everything in
# practice, with a full-ranking fallback for the rare leftovers
_SPILL_PREF_RANKS = 32
# device bytes one search block may hold (shortlist, kernel workspace,
# re-rank gather); more queries than that are swept in blocks
SEARCH_BUDGET_BYTES = 2 << 30


@dataclasses.dataclass(frozen=True)
class IVFConfig:
    """``repro.retrieval.IVFConfig``, field for field (see its comments).

    ``backend`` keeps ``auto|ref|pallas`` so configs stay interchangeable;
    it selects nothing: the device decides, as the port's other kernel
    flags do."""

    nlist: int = 64
    nprobe: int = 8
    kmeans_iters: int = 8
    train_size: int = 0
    balance_factor: float = 4.0
    assign_chunk: int = 65536
    seed: int = 0
    rerank: int = 0
    keep_exact_device: bool = True
    assign_mode: str = "auto"
    backend: str = "auto"

    def validate(self) -> None:
        if self.nlist <= 0:
            raise ValueError(f"nlist must be positive, got {self.nlist}")
        if self.nprobe <= 0:
            raise ValueError(f"nprobe must be positive, got {self.nprobe}")
        if self.assign_chunk <= 0:
            raise ValueError(
                f"assign_chunk must be positive, got {self.assign_chunk} "
                "(a non-positive chunk width would silently assign nothing)"
            )
        if self.rerank < 0:
            raise ValueError(f"rerank must be >= 0, got {self.rerank}")
        if self.assign_mode not in ("auto", "exact", "hier"):
            raise ValueError(
                f"assign_mode must be auto|exact|hier, got {self.assign_mode!r}"
            )
        if self.backend not in ("auto", "ref", "pallas"):
            raise ValueError(
                f"backend must be auto|ref|pallas, got {self.backend!r}"
            )


# ------------------------------------------------------------- build helpers
def _quantize_rows(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row absmax int8 quantization -> (codes int8, scales (R, 1) f32)."""
    scales = np.maximum(
        np.abs(x).max(axis=1, keepdims=True) / 127.0, 1e-12
    ).astype(np.float32)
    codes = np.rint(x / scales).astype(np.int8)
    return codes, scales


def _assign_exact(norm: np.ndarray, cent: np.ndarray, chunk: int) -> np.ndarray:
    """Chunked full-table argmax assignment (O(chunk x nlist) live scores)."""
    out = np.empty(norm.shape[0], dtype=np.int64)
    for lo in range(0, norm.shape[0], chunk):
        out[lo : lo + chunk] = np.argmax(norm[lo : lo + chunk] @ cent.T, axis=1)
    return out


def _assign_hier(
    norm: np.ndarray,
    cent: np.ndarray,
    chunk: int,
    rng: np.random.Generator,
    probe_groups: int = 4,
) -> np.ndarray:
    """Two-level assignment: each item scores ~sqrt(nlist) centroid groups
    (a tiny k-means over the centroids), then only the member centroids of
    its ``probe_groups`` best groups; an item whose argmax centroid lies
    outside them lands on its best probed one (a build-time approximation;
    one cell per item still holds)."""
    nlist, d = cent.shape
    G = max(1, int(round(np.sqrt(nlist))))
    if G < 2:
        return _assign_exact(norm, cent, chunk)
    gc = cent[rng.choice(nlist, size=G, replace=False)].copy()
    for _ in range(4):
        ga = np.argmax(cent @ gc.T, axis=1)
        sums = np.zeros((G, d), np.float32)
        np.add.at(sums, ga, cent)
        nrm = np.linalg.norm(sums, axis=1, keepdims=True)
        ok = nrm[:, 0] > 1e-12
        gc[ok] = (sums / np.maximum(nrm, 1e-12))[ok]
    ga = np.argmax(cent @ gc.T, axis=1)
    members = [np.flatnonzero(ga == g) for g in range(G)]
    gcount = np.bincount(ga, minlength=G)
    pg = min(probe_groups, G)
    assign = np.zeros(norm.shape[0], dtype=np.int64)
    for lo in range(0, norm.shape[0], chunk):
        blk = norm[lo : lo + chunk]
        gs = blk @ gc.T  # (c, G)
        gs[:, gcount == 0] = -np.inf  # a memberless group buys nothing
        topg = np.argpartition(-gs, pg - 1, axis=1)[:, :pg]
        best = np.full(len(blk), -np.inf, dtype=np.float32)
        aa = np.zeros(len(blk), dtype=np.int64)
        # ascending group order + strict > keeps the update deterministic
        for g in range(G):
            mem = members[g]
            if not len(mem):
                continue
            sel = np.flatnonzero((topg == g).any(axis=1))
            if not len(sel):
                continue
            sc = blk[sel] @ cent[mem].T  # (n_sel, |mem|)
            am = sc.argmax(axis=1)
            mx = sc[np.arange(len(sel)), am]
            upd = mx > best[sel]
            hit = sel[upd]
            best[hit] = mx[upd]
            aa[hit] = mem[am[upd]]
        assign[lo : lo + chunk] = aa
    return assign


def _place_rank_rounds(
    spill: np.ndarray,
    prefs: np.ndarray,
    assign: np.ndarray,
    counts: np.ndarray,
    cap: int,
) -> np.ndarray:
    """One admission round per preference rank: round r places every
    still-unplaced spilled item whose r-th-preference cell has room,
    admitting by ascending item id when a cell can't take all claimants.
    Mutates ``assign``/``counts``; returns the placed mask."""
    nlist = len(counts)
    placed = np.zeros(len(spill), dtype=bool)
    for r in range(prefs.shape[1]):
        active = np.flatnonzero(~placed)
        if not len(active):
            break
        tgt = prefs[active, r]
        room = np.maximum(cap - counts, 0)
        # group claimants by target cell, id ascending; admit the first
        # ``room[cell]`` of each group
        lex = np.lexsort((spill[active], tgt))
        tg = tgt[lex]
        grp_start = np.flatnonzero(np.r_[True, np.diff(tg) > 0])
        within = np.arange(len(tg)) - np.repeat(
            grp_start, np.diff(np.r_[grp_start, len(tg)])
        )
        ok = within < room[tg]
        sel = active[lex[ok]]
        assign[spill[sel]] = tg[ok]
        counts += np.bincount(tg[ok], minlength=nlist)
        placed[sel] = True
    return placed


def _spill_hot_cells(
    norm: np.ndarray, cent: np.ndarray, assign: np.ndarray, cap: int
) -> np.ndarray:
    """Move the weakest members of over-``cap`` cells to their next-best
    centroid with room, in vectorized rank rounds over each spilled item's
    top ``_SPILL_PREF_RANKS`` cells (a full ranking for the rare leftovers).
    Every item keeps exactly one cell, so exhaustive probing stays exact."""
    assign = assign.copy()
    nlist = len(cent)
    counts = np.bincount(assign, minlength=nlist)
    hot = np.flatnonzero(counts > cap)
    if not len(hot):
        return assign
    # weakest members per hot cell, via one cell-sorted pass
    by_cell = np.argsort(assign, kind="stable")
    offs = np.zeros(nlist + 1, np.int64)
    offs[1:] = np.cumsum(counts)
    own_aff = np.einsum("ij,ij->i", norm, cent[assign])
    spill_parts = []
    for c in hot:
        members = by_cell[offs[c] : offs[c + 1]]
        weakest = np.argsort(own_aff[members], kind="stable")[
            : counts[c] - cap
        ]
        spill_parts.append(members[weakest])
    spill = np.concatenate(spill_parts)
    counts[hot] = cap  # spilled members vacate their source cells
    R = int(min(nlist, _SPILL_PREF_RANKS))
    prefs = np.empty((len(spill), R), np.int64)
    for lo in range(0, len(spill), 65536):
        sc = norm[spill[lo : lo + 65536]] @ cent.T
        part = np.argpartition(-sc, R - 1, axis=1)[:, :R]
        row = np.arange(len(part))[:, None]
        ordr = np.argsort(-sc[row, part], axis=1, kind="stable")
        prefs[lo : lo + 65536] = part[row, ordr]
    placed = _place_rank_rounds(spill, prefs, assign, counts, cap)
    left = np.flatnonzero(~placed)
    if len(left):  # truncated list exhausted: full ranking for the few
        sp = spill[left]
        full = np.argsort(-(norm[sp] @ cent.T), axis=1, kind="stable")
        _place_rank_rounds(sp, full, assign, counts, cap)
    return assign


# ------------------------------------------------------------ search program
def _probe(q, centroids, offsets, nprobe: int):
    """The ``nprobe`` cells nearest each query -> their lists' (Q, nprobe)
    starts and lengths. Row-wise sums, not a matrix product: a query's
    scores then do not depend on how many queries share the call (nor on
    TF32). On equal scores the lower cell wins."""
    cscores = (q[:, None, :] * centroids[None]).sum(-1)  # (Q, nlist)
    probes = desc_order(cscores, nprobe)
    starts = offsets[probes]
    return starts, offsets[probes + 1] - starts


def _to_ids(s, rows, ex, order):
    """Packed rows -> item ids, then the exclusion mask: excluded and empty
    slots come back (-inf, -1)."""
    found = rows >= 0
    ids = torch.where(found, order[rows.clamp(min=0).to(torch.int64)], -1)
    masked = ~found
    if ex.shape[1]:  # excluded ids, by binary search in each sorted exclusion row
        exs = torch.sort(ex.to(ids.dtype), dim=1).values
        pos = torch.searchsorted(exs, ids).clamp(max=exs.shape[1] - 1)
        masked |= torch.gather(exs, 1, pos) == ids
    return torch.where(masked, float("-inf"), s), torch.where(masked, -1, ids)


def _ivf_shortlist(q, ex, centroids, codes, scales, order, offsets, *,
                   nprobe: int, shortlist: int, lpad: int):
    """Probe + gather-then-score + exclusion -> (Q, S) approximate shortlist.

    Returns (approx scores, item ids, candidates scored as a 0-d device
    tensor). The ids are unique per query (cells are disjoint and the
    probes distinct), which the exact re-rank relies on.
    """
    starts, lens = _probe(q, centroids, offsets, nprobe)
    s, rows = ops.ivf_list_topk(q, codes, scales, starts, lens, lpad=lpad,
                                shortlist=shortlist)
    s, ids = _to_ids(s, rows, ex, order)
    return s, ids, lens.clamp(max=lpad).sum()


def _rerank_exact_device(q, s, ids, table, *, k: int):
    """Exact-dot re-rank of the shortlist under the lower-id tie-break:
    survivors re-scored against the exact f32 table, re-sorted by
    ascending id, then a first-occurrence top-k (``repro``'s
    ``_rerank_exact_device``)."""
    masked = torch.isneginf(s) | (ids < 0)
    vecs = table[ids.clamp(min=0).to(torch.int64)]  # (Q, S, d)
    es = (vecs * q[:, None, :]).sum(-1)
    es = torch.where(masked, float("-inf"), es)
    by_id = torch.sort(torch.where(ids >= 0, ids, int(_INT32_MAX)), dim=1, stable=True).indices
    ids2 = torch.gather(ids, 1, by_id)
    es2 = torch.gather(es, 1, by_id)
    pos = desc_order(es2, k)
    best = torch.gather(es2, 1, pos)
    bi = torch.gather(ids2, 1, pos)
    return best, torch.where(torch.isneginf(best), -1, bi)


def _rerank_exact_host(q, s, ids, table, k):
    """Host twin of ``_rerank_exact_device`` for ``keep_exact_device=False``:
    the exact table never leaves host memory; only the (Q, S) shortlist is
    copied back. Same id-ascending pre-sort + tie-stable top-k."""
    masked = np.isneginf(s) | (ids < 0)
    vecs = table[np.maximum(ids, 0)]  # (Q, S, d)
    es = np.einsum("qd,qsd->qs", q, vecs).astype(np.float32)
    es = np.where(masked, -np.inf, es).astype(np.float32)
    by_id = np.argsort(np.where(ids >= 0, ids, _INT32_MAX), axis=1, kind="stable")
    ids2 = np.take_along_axis(ids, by_id, axis=1)
    es2 = np.take_along_axis(es, by_id, axis=1)
    pos = _deterministic_topk_rows(es2, k)  # ascending index == ascending id
    best = np.take_along_axis(es2, pos, axis=1)
    bi = np.take_along_axis(ids2, pos, axis=1)
    return best, np.where(np.isneginf(best), -1, bi)


@dataclasses.dataclass
class IVFIndex:
    """Built coarse index over one item table (ids are row indices), on
    ``device`` (None means CUDA).

    Residency: construction uploads centroids, codes, scales, the CSR
    arrays and (``keep_exact_device``) the exact table once, through
    ``to_device``; ``search()`` only moves queries and exclusions in and
    results out.
    """

    config: IVFConfig
    centroids: np.ndarray  # (nlist, d) float32
    order: np.ndarray  # (I,) int32 — packed row -> original item id
    offsets: np.ndarray  # (nlist + 1,) int32 CSR bounds into packed rows
    codes: np.ndarray  # (I + lpad, d) int8 cell-sorted rows (+ zero pad)
    scales: np.ndarray  # (I + lpad, 1) float32 per-row dequant scales
    items: np.ndarray  # (I, d) float32 — the exact table (host copy)
    lpad: int = 1  # max list length: fixed per-probe slice width
    spilled_items: int = 0  # items moved off their argmax cell by balancing
    device: DeviceLike = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        # per-search telemetry, as repro's index keeps it
        self.last_cells_probed = 0
        self.last_candidates_scored = 0
        dev = self.device
        self._dev = {name: to_device(getattr(self, name), dev) for name in
                     ("centroids", "codes", "scales", "order", "offsets")}
        if self.config.keep_exact_device:
            self._dev["items"] = to_device(self.items, dev)

    @classmethod
    def build(cls, items: np.ndarray, config: IVFConfig = IVFConfig(),
              device: DeviceLike = None) -> "IVFIndex":
        config.validate()
        it = host_array(items, dtype=np.float32)
        I, d = it.shape
        nlist = min(config.nlist, I)
        rng = np.random.default_rng(config.seed)
        norm = it / np.maximum(np.linalg.norm(it, axis=1, keepdims=True), 1e-12)
        train = norm
        if config.train_size and config.train_size < I:
            train = norm[
                rng.choice(I, size=max(config.train_size, nlist), replace=False)
            ]
        cent = train[rng.choice(len(train), size=nlist, replace=False)].copy()
        for _ in range(max(1, config.kmeans_iters)):
            t_assign = _assign_exact(train, cent, config.assign_chunk)
            sums = np.zeros((nlist, d), np.float32)
            np.add.at(sums, t_assign, train)
            counts = np.bincount(t_assign, minlength=nlist)
            nrm = np.linalg.norm(sums, axis=1, keepdims=True)
            ok = (counts > 0) & (nrm[:, 0] > 1e-12)
            cent[ok] = (sums / np.maximum(nrm, 1e-12))[ok]
            dead = np.flatnonzero(counts == 0)
            if len(dead):  # re-seed empty cells so every list stays non-trivial
                cent[dead] = train[rng.integers(0, len(train), size=len(dead))]
        mode = config.assign_mode
        if mode == "auto":
            mode = "hier" if I * nlist > _HIER_AUTO_THRESHOLD else "exact"
        if mode == "hier":
            assign = _assign_hier(norm, cent, config.assign_chunk, rng)
        else:
            assign = _assign_exact(norm, cent, config.assign_chunk)
        spilled = 0
        if config.balance_factor:
            cap = max(1, int(np.ceil(config.balance_factor * I / nlist)))
            before = assign
            assign = _spill_hot_cells(norm, cent, assign, cap)
            spilled = int(np.count_nonzero(assign != before))
        order = np.argsort(assign, kind="stable").astype(np.int32)
        counts = np.bincount(assign, minlength=nlist)
        offsets = np.zeros(nlist + 1, np.int32)
        offsets[1:] = np.cumsum(counts).astype(np.int32)
        lpad = max(1, int(counts.max()))
        codes, scales = _quantize_rows(it[order])
        # lpad zero rows, as repro's fixed-width DMA needs them: the fields
        # stay bitwise repro's (the CUDA kernel reads none of them)
        codes = np.concatenate([codes, np.zeros((lpad, d), np.int8)])
        scales = np.concatenate([scales, np.zeros((lpad, 1), np.float32)])
        return cls(
            config=dataclasses.replace(config, nlist=nlist),
            centroids=cent.astype(np.float32), order=order, offsets=offsets,
            codes=codes, scales=scales, items=it, lpad=lpad,
            spilled_items=spilled, device=device,
        )

    # ------------------------------------------------------------- derived
    @property
    def lists(self) -> np.ndarray:
        """Dense (nlist, lpad) view of the CSR lists, -1 padded (for
        inspection and tests; no search builds it)."""
        lens = np.diff(self.offsets)
        out = np.full((len(lens), self.lpad), -1, np.int32)
        out[np.arange(self.lpad)[None, :] < lens[:, None]] = self.order
        return out

    @property
    def candidates_per_query(self) -> int:
        """Upper bound on candidates scored per query (probe budget)."""
        return min(self.config.nprobe, self.config.nlist) * self.lpad

    # -------------------------------------------------------------- search
    def plan(self, k: int, num_queries: int, exclude_width: int,
             nprobe: Optional[int] = None) -> dict:
        """The search's sizes: probes, shortlist, re-rank depth and the
        queries per device block."""
        if nprobe is not None and nprobe <= 0:
            raise ValueError(f"nprobe must be positive, got {nprobe}")
        nprobe = min(self.config.nlist, self.config.nprobe if nprobe is None else nprobe)
        I = self.items.shape[0]
        if not 0 < k <= I:
            raise ValueError(f"k={k} must be in [1, {I}]")
        budget = nprobe * self.lpad
        if nprobe >= self.config.nlist:
            shortlist = budget  # exhaustive: every candidate survives
        else:
            want = self.config.rerank or max(4 * k, 128)
            shortlist = min(max(want, k) + exclude_width, budget)
        d = self.items.shape[1]
        # shortlist, ids, kernel workspace and re-rank sorts ~64 bytes an
        # entry, plus the re-rank's gathered rows and their products
        per_query = shortlist * (64 + 8 * d * self.config.keep_exact_device)
        block = max(1, min(num_queries, SEARCH_BUDGET_BYTES // per_query))
        return {"nprobe": nprobe, "shortlist": shortlist, "k": min(k, shortlist),
                "block": block}

    def dispatch(self, dq: torch.Tensor, dex: torch.Tensor, plan: dict):
        """One block of device queries and exclusions -> device results:
        ((B, k') scores, (B, k') ids, candidates scored), with k' = plan
        ``k``; under ``keep_exact_device=False`` the (B, S) shortlist and
        no re-rank. Enqueues work only: nothing here waits on the card."""
        dev = self._dev
        s, ids, n_scored = _ivf_shortlist(
            dq, dex, dev["centroids"], dev["codes"], dev["scales"], dev["order"],
            dev["offsets"], nprobe=plan["nprobe"], shortlist=plan["shortlist"],
            lpad=self.lpad)
        if not self.config.keep_exact_device:
            return s, ids, n_scored
        bs, bi = _rerank_exact_device(dq, s, ids, dev["items"], k=plan["k"])
        return bs, bi, n_scored

    def search(
        self,
        queries: np.ndarray,
        k: int,
        exclude: Optional[np.ndarray] = None,
        nprobe: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """((Q, k) f32 scores, (Q, k) int32 ids); unfilled slots are (-inf, -1).

        Scores are exact dots (the quantized scores only pick the
        shortlist); with ``nprobe >= nlist`` the result equals the
        exhaustive oracle's.
        """
        q = host_array(queries, dtype=np.float32)
        Q = q.shape[0]
        if exclude is None:
            ex = np.full((Q, 1), -1, np.int32)
        else:
            ex = host_array(exclude, dtype=np.int32)
        plan = self.plan(k, Q, ex.shape[1], nprobe)
        kk = plan["k"]
        out_s = np.empty((Q, kk), np.float32)
        out_i = np.empty((Q, kk), np.int32)
        scored = []  # each block's count, on the device until the end
        for lo in range(0, Q, plan["block"]):
            hi = min(lo + plan["block"], Q)
            a, b, n = self.dispatch(to_device(q[lo:hi], self.device),
                                    to_device(ex[lo:hi], self.device), plan)
            if self.config.keep_exact_device:
                out_s[lo:hi], out_i[lo:hi] = host_array(a), host_array(b)
            else:
                out_s[lo:hi], out_i[lo:hi] = _rerank_exact_host(
                    q[lo:hi], host_array(a), host_array(b), self.items, kk)
            scored.append(n)
        self.last_cells_probed = Q * plan["nprobe"]
        self.last_candidates_scored = (int(host_array(torch.stack(scored)).sum())
                                       if scored else 0)
        if kk < k:
            out_s = np.pad(out_s, ((0, 0), (0, k - kk)), constant_values=-np.inf)
            out_i = np.pad(out_i, ((0, 0), (0, k - kk)), constant_values=-1)
        return out_s, out_i
