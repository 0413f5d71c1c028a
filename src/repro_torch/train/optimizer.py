"""Minimal optimizers on dicts of tensors: row-wise AdaGrad, Adam, ``masked``.

The port of the parts of ``repro.train.optimizer`` the trainer uses, with
``repro``'s formulas term for term (``torch.optim.Adam`` orders its bias
correction differently, so it would not match). The API mirrors optax as
``repro``'s does: ``opt = adam(lr); state = opt.init(params);
updates, state = opt.update(grads, state, params);
params = apply_updates(params, updates)``. Updates are functional: new
tensors, never in place. The states are NamedTuples and dicts of tensors,
which ``repro_torch.convert`` carries to and from numpy.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

Tree = Dict[str, torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable[[Tree], Any]
    update: Callable[..., Tuple[Tree, Any]]  # (grads, state, params) -> (updates, state)


def apply_updates(params: Tree, updates: Tree) -> Tree:
    return {k: p + updates[k] for k, p in params.items()}


def rowwise_adagrad(lr: float, eps: float = 1e-8, init_accum: float = 0.1) -> Optimizer:
    """PS row-wise AdaGrad, dense application: one (rows, 1) accumulator per
    table, accumulating the per-row mean of squared grads. Untouched rows
    have zero grads, so this equals the scatter form
    (``embedding.optimizer.rowwise_adagrad_scatter_update``) at O(num_rows)."""

    def init(params: Tree):
        return {k: torch.full((p.shape[0], 1), init_accum, dtype=p.dtype, device=p.device)
                for k, p in params.items()}

    def update(grads: Tree, state, params=None):
        new_acc = {k: a + (grads[k] * grads[k]).mean(dim=-1, keepdim=True)
                   for k, a in state.items()}
        upd = {k: -lr * g / (torch.sqrt(new_acc[k]) + eps) for k, g in grads.items()}
        return upd, new_acc

    return Optimizer(init, update)


class AdamState(NamedTuple):
    step: torch.Tensor  # () int32
    mu: Tree
    nu: Tree


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    """Adam; with weight_decay > 0 this is AdamW (decoupled decay)."""

    def init(params: Tree):
        dev = next(iter(params.values())).device if params else torch.device("cpu")
        return AdamState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            mu={k: torch.zeros_like(p) for k, p in params.items()},
            nu={k: torch.zeros_like(p) for k, p in params.items()},
        )

    def update(grads: Tree, state: AdamState, params=None):
        step = state.step + 1
        mu = {k: b1 * m + (1 - b1) * grads[k] for k, m in state.mu.items()}
        nu = {k: b2 * v + (1 - b2) * grads[k] * grads[k] for k, v in state.nu.items()}
        stepf = step.to(torch.float32)
        bc1 = 1 - torch.pow(b1, stepf)
        bc2 = 1 - torch.pow(b2, stepf)
        updates = {}
        for k in mu:
            upd = -lr * (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + eps)
            if weight_decay and params is not None:
                upd = upd - lr * weight_decay * params[k]
            updates[k] = upd
        return updates, AdamState(step=step, mu=mu, nu=nu)

    return Optimizer(init, update)


def masked(opt_a: Optimizer, opt_b: Optimizer, select_a: Callable[[str], bool]) -> Optimizer:
    """Keys where ``select_a(key)`` use ``opt_a``, the rest ``opt_b``: the
    sparse/dense split (row-wise AdaGrad on ``emb/*``, Adam on the GNN)."""

    def _split(tree: Tree):
        return ({k: v for k, v in tree.items() if select_a(k)},
                {k: v for k, v in tree.items() if not select_a(k)})

    def init(params: Tree):
        a, b = _split(params)
        return (opt_a.init(a), opt_b.init(b))

    def update(grads: Tree, state, params=None):
        ga, gb = _split(grads)
        pa, pb = _split(params) if params is not None else (None, None)
        ua, sa = opt_a.update(ga, state[0], pa)
        ub, sb = opt_b.update(gb, state[1], pb)
        return {**ua, **ub}, (sa, sb)

    return Optimizer(init, update)
