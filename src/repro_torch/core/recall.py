"""Recall strategies and metrics (paper §4.2): ICF, UCF, U2I @ K.

The port of ``repro.core.recall``:

- **ICF**: each interacted item of a user recalls its top-N most similar
  items; the user gets the top-K items most frequent in that pool.
- **UCF**: the user's top-N most similar users vote with their histories.
- **U2I**: items retrieved directly by user · item embedding.

Recall@K, HitRate@K and NDCG@K per strategy, averaged over the evaluated
users. Every similarity search goes through one top-k primitive:

- ``method="device"`` — ``retrieval.chunked_topk`` on ``device``: the CUDA
  ``topk`` kernel on the card (``device=None``), its plain version on the
  CPU;
- ``method="ivf"`` — one ``retrieval.IVFIndex`` over the items and one
  over the users, built on ``device`` (the ``ivf_list_topk`` kernel on the
  card): approximate unless ``nprobe >= nlist``;
- ``method="bruteforce"`` — the numpy full-matrix oracle.

All paths share one tie-break rule (equal scores -> lower id wins), so the
device path, and IVF at full probing, recommend the oracle's ids. The vote aggregation after the
searches is the same numpy code for every method.

With ``telemetry`` (an ``obs.Telemetry``) every search is a
``retrieval.<corpus>`` span and a ``retrieval.search_ns`` histogram
observation, and IVF adds its ``ivf.spill_events``, ``ivf.cells_probed`` and
``ivf.candidates_scored`` counters, as ``repro``'s wrappers do; the searchers
themselves are untouched.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.retrieval.ivf import IVFConfig, IVFIndex
from repro_torch.retrieval.topk import (
    _deterministic_topk_rows, brute_force_topk, chunked_topk, pad_id_rows,
)

STRATEGIES = ("icf", "ucf", "u2i")


def _normalize(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


def _user_histories(train_pairs: np.ndarray, num_users: int) -> Dict[int, np.ndarray]:
    hist: Dict[int, list] = {}
    for u, i in train_pairs:
        hist.setdefault(int(u), []).append(int(i))
    return {u: np.unique(np.array(v, dtype=np.int64)) for u, v in hist.items()}


def ranked_metrics(rec: np.ndarray, truths: Sequence[set], top_k: int) -> Dict[str, float]:
    """Recall/HitRate/NDCG @ top_k for ranked id lists vs held-out sets.

    ``rec``: (B, K) ranked item ids (-1 = unfilled slot, never counts).
    """
    discounts = 1.0 / np.log2(np.arange(top_k) + 2.0)
    recalls, hits, ndcgs = [], [], []
    for r, truth in zip(rec, truths):
        if not truth:
            continue
        r = np.asarray(r[:top_k])
        gain = (
            np.isin(r, np.fromiter(truth, np.int64, len(truth))) & (r >= 0)
        ).astype(np.float64)
        n_hit = gain.sum()
        recalls.append(n_hit / len(truth))
        hits.append(1.0 if n_hit else 0.0)
        ideal = discounts[: min(len(truth), len(r))].sum()
        ndcgs.append(float(gain @ discounts[: len(r)]) / ideal)
    if not recalls:
        return {"recall": 0.0, "hit": 0.0, "ndcg": 0.0}
    return {
        "recall": float(np.mean(recalls)),
        "hit": float(np.mean(hits)),
        "ndcg": float(np.mean(ndcgs)),
    }


def _make_searchers(method: str, ue: np.ndarray, ie: np.ndarray, query_chunk: int,
                    device: DeviceLike, ivf: Optional[IVFConfig],
                    telemetry=None) -> Dict[str, Callable]:
    """One top-k callable per corpus ("item", "user"), each wrapped in a
    span and a latency observation when ``telemetry`` is wired."""
    if method == "bruteforce":
        searchers = {"item": lambda q, k, ex=None: brute_force_topk(q, ie, k, exclude=ex),
                     "user": lambda q, k, ex=None: brute_force_topk(q, ue, k, exclude=ex)}
    elif method == "device":
        dev = resolve_device(device)

        def make(corpus):
            def search(q, k, ex=None):
                return chunked_topk(q, corpus, k, exclude=ex, query_chunk=query_chunk,
                                    device=dev)
            return search

        searchers = {"item": make(ie), "user": make(ue)}
    elif method == "ivf":
        cfg = ivf or IVFConfig()
        idx = {"item": IVFIndex.build(ie, cfg, device=device),
               "user": IVFIndex.build(ue, cfg, device=device)}
        if telemetry is not None:
            # why IVF recall and latency are what they are: cells probed,
            # candidates actually scored, items spilled off their best cell
            m = telemetry.metrics
            m.counter("ivf.spill_events").inc(sum(ix.spilled_items for ix in idx.values()))
            c_cells = m.counter("ivf.cells_probed")
            c_cand = m.counter("ivf.candidates_scored")

            def make_counted(ix):
                def search(q, k, ex=None):
                    res = ix.search(q, k, exclude=ex)
                    c_cells.inc(ix.last_cells_probed)
                    c_cand.inc(ix.last_candidates_scored)
                    return res
                return search

            searchers = {name: make_counted(ix) for name, ix in idx.items()}
        else:
            searchers = {name: (lambda ix: lambda q, k, ex=None: ix.search(q, k, exclude=ex))(ix)
                         for name, ix in idx.items()}
    else:
        raise ValueError(f"unknown recall method {method!r}")
    if telemetry is not None:
        tracer = telemetry.tracer
        hist = telemetry.metrics.histogram("retrieval.search_ns")

        def wrap(corpus_name, inner):
            def traced(q, k, ex=None):
                t0 = time.perf_counter_ns()
                res = inner(q, k, ex)
                dur = time.perf_counter_ns() - t0
                tracer.add_span(f"retrieval.{corpus_name}", "retrieval", t0, dur,
                                {"method": method, "queries": len(q)})
                hist.observe(dur)
                return res
            return traced

        searchers = {name: wrap(name, s) for name, s in searchers.items()}
    return searchers


def evaluate_recall(
    user_emb: np.ndarray,  # (num_users, d)
    item_emb: np.ndarray,  # (num_items, d)
    train_pairs: np.ndarray,  # (Nt, 2) local (user, item) train interactions
    eval_pairs: np.ndarray,  # (Ne, 2) local held-out (user, item)
    top_k: int = 100,
    top_n: int = 20,
    max_users: int = 0,  # 0 -> every held-out user
    seed: int = 0,
    method: str = "device",  # device | ivf | bruteforce
    strategies: Sequence[str] = STRATEGIES,
    user_chunk: int = 512,
    device: DeviceLike = None,
    ivf: Optional[IVFConfig] = None,  # method="ivf"; None -> IVFConfig()
    telemetry=None,  # an obs.Telemetry: traces every retrieval search
) -> Dict[str, float]:
    """Recall/HitRate/NDCG @ top_k per strategy over the held-out pairs.

    Returns ``{"u2i": recall, "u2i_hit": …, "u2i_ndcg": …}`` per strategy.
    ``device`` is where ``method="device"`` and ``method="ivf"`` search
    (None -> CUDA).
    """
    strategies = tuple(strategies)
    unknown = set(strategies) - set(STRATEGIES)
    if unknown:
        raise ValueError(f"unknown recall strategies {sorted(unknown)!r}; "
                         f"expected a subset of {STRATEGIES}")
    num_users, num_items = len(user_emb), len(item_emb)
    ue = _normalize(np.asarray(user_emb, dtype=np.float32))
    ie = _normalize(np.asarray(item_emb, dtype=np.float32))
    top_k = min(top_k, num_items)
    top_n = min(top_n, num_items)
    hist = _user_histories(train_pairs, num_users)
    held: Dict[int, set] = {}
    for u, i in eval_pairs:
        held.setdefault(int(u), set()).add(int(i))
    users = [u for u in held if u in hist]
    if method in ("device", "ivf"):
        device = resolve_device(device)
    if not users:
        out = {}
        for s in strategies:
            out.update({s: 0.0, f"{s}_hit": 0.0, f"{s}_ndcg": 0.0})
        return out
    if max_users and len(users) > max_users:
        rng = np.random.default_rng(seed)
        users = list(rng.choice(np.array(users), size=max_users, replace=False))

    search = _make_searchers(method, ue, ie, user_chunk, device, ivf, telemetry)
    uarr = np.array(users, dtype=np.int64)
    truths = [held[u] for u in users]
    seen_pad = pad_id_rows([hist[u] for u in users])  # (B, E)
    out: Dict[str, float] = {}

    def add(strategy: str, rec: np.ndarray) -> None:
        m = ranked_metrics(rec, truths, top_k)
        out[strategy] = m["recall"]
        out[f"{strategy}_hit"] = m["hit"]
        out[f"{strategy}_ndcg"] = m["ndcg"]

    if "u2i" in strategies:  # direct retrieval, history excluded in-search
        _, rec = search["item"](ue[uarr], top_k, seen_pad)
        add("u2i", rec)

    want_icf = "icf" in strategies
    want_ucf = "ucf" in strategies
    if want_icf:  # item-item neighbours of each history item vote
        seen_items = np.unique(np.concatenate([hist[u] for u in users]))
        _, nbrs = search["item"](
            ie[seen_items], top_n, seen_items[:, None].astype(np.int32)
        )  # (S, top_n), self excluded
        row_of_item = {int(i): r for r, i in enumerate(seen_items)}
        rec_icf = np.empty((len(users), top_k), dtype=np.int64)
    if want_ucf:  # similar users' histories vote, rank-decayed weights
        n_sim = min(top_n + 1, num_users - 1) or 1
        _, sim_users = search["user"](
            ue[uarr], n_sim, uarr[:, None].astype(np.int32)
        )  # (B, n_sim), self excluded
        weights = np.linspace(1.0, 0.5, n_sim)
        rec_ucf = np.empty((len(users), top_k), dtype=np.int64)
    for lo in range(0, len(users), user_chunk) if (want_icf or want_ucf) else ():
        cu = users[lo : lo + user_chunk]
        ui = ue[uarr[lo : lo + len(cu)]] @ ie.T  # tie-break term, shared
        if want_icf:
            votes = np.zeros((len(cu), num_items), dtype=np.float64)
            for r, u in enumerate(cu):
                for i in hist[u]:
                    n = nbrs[row_of_item[int(i)]]
                    np.add.at(votes[r], n[n >= 0], 1.0)
                votes[r, hist[u]] = -np.inf
            rec_icf[lo : lo + len(cu)] = _deterministic_topk_rows(
                votes + 1e-9 * ui, top_k
            )
        if want_ucf:
            votes = np.zeros((len(cu), num_items), dtype=np.float64)
            for rank in range(n_sim):
                for r, _ in enumerate(cu):
                    v = int(sim_users[lo + r, rank])
                    if v < 0:
                        continue
                    hv = hist.get(v)
                    if hv is not None:
                        votes[r, hv] += weights[rank]
            for r, u in enumerate(cu):
                votes[r, hist[u]] = -np.inf
            rec_ucf[lo : lo + len(cu)] = _deterministic_topk_rows(
                votes + 1e-9 * ui, top_k
            )
    if want_icf:
        add("icf", rec_icf)
    if want_ucf:
        add("ucf", rec_ucf)
    return out


def evaluate_recall_bruteforce(*args, **kwargs) -> Dict[str, float]:
    """The numpy full-matrix oracle (``method="bruteforce"``): the device
    and IVF paths are held against it."""
    kwargs["method"] = "bruteforce"
    return evaluate_recall(*args, **kwargs)
