"""Minimal optimizers on dicts of tensors: SGD, AdaGrad, row-wise AdaGrad,
Adam, AdamW, ``masked`` and ``clip_by_global_norm``.

The port of ``repro.train.optimizer``, all of it, with ``repro``'s formulas
term for term (``torch.optim.Adam`` orders its bias correction
differently, so it would not match). The API mirrors optax as
``repro``'s does: ``opt = adam(lr); state = opt.init(params);
updates, state = opt.update(grads, state, params);
params = apply_updates(params, updates)``. Updates are functional: new
tensors, never in place. The states are NamedTuples and dicts of tensors,
which ``repro_torch.convert`` carries to and from numpy.

Types follow JAX's rules, not torch's, where the two differ on a bf16 leaf
(``adam`` on an LM; the GNN's leaves are f32, whose bits these rules leave
as they were):
- ``adam`` divides each moment by an f32 0-d bias correction, which JAX
  promotes to f32 whatever the moment's dtype, while torch keeps a
  dimensioned bf16 tensor bf16 against a 0-d f32 one. So a bf16 leaf's
  update is computed in f32, as ``repro``'s is, and ``apply_updates`` turns
  the parameter f32 (ROADMAP C6).
- A Python scalar is weakly typed in JAX: ``0.9 * m`` rounds 0.9 to bf16
  before the product, where torch multiplies by the unrounded scalar in f32.
  ``_weak`` rounds it first, so the bf16 moments are bitwise ``repro``'s;
  so do ``sgd``'s momentum and learning rate and ``adagrad``'s learning
  rate and eps.
- ``clip_by_global_norm`` sums the leaves in ``jax.tree_util.tree_leaves``
  order (sorted keys) and scales each leaf by a strongly typed 0-d scale,
  which JAX promotes with the leaf (a bf16 leaf of a tree with f32 leaves
  turns f32), where torch would keep the leaf's dtype.
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


def _weak(x: float, t: torch.Tensor) -> float:
    """The Python scalar ``x`` as JAX applies it to ``t``: rounded to a bf16
    (or f16) ``t``'s dtype first; unchanged for f32, where torch and JAX
    both take it in f32."""
    if t.dtype in (torch.float32, torch.float64):
        return x
    return float(torch.tensor(x, dtype=t.dtype))


def sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    """Plain SGD (state ``()``), or heavy-ball momentum ``m = momentum * m +
    g``, update ``-lr * m``."""

    def init(params: Tree):
        if momentum == 0.0:
            return ()
        return {k: torch.zeros_like(p) for k, p in params.items()}

    def update(grads: Tree, state, params=None):
        if momentum == 0.0:
            return {k: _weak(-lr, g) * g for k, g in grads.items()}, state
        new_m = {k: _weak(momentum, m) * m + grads[k] for k, m in state.items()}
        return {k: _weak(-lr, m) * m for k, m in new_m.items()}, new_m

    return Optimizer(init, update)


def adagrad(lr: float, eps: float = 1e-8, init_accum: float = 0.1) -> Optimizer:
    """Element-wise AdaGrad: ``a += g * g``, update ``-lr * g / (sqrt(a) +
    eps)``."""

    def init(params: Tree):
        return {k: torch.full_like(p, init_accum) for k, p in params.items()}

    def update(grads: Tree, state, params=None):
        new_acc = {k: a + grads[k] * grads[k] for k, a in state.items()}
        upd = {k: _weak(-lr, g) * g / (torch.sqrt(new_acc[k]) + _weak(eps, new_acc[k]))
               for k, g in grads.items()}
        return upd, new_acc

    return Optimizer(init, update)


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
        mu = {k: _weak(b1, m) * m + _weak(1 - b1, grads[k]) * grads[k]
              for k, m in state.mu.items()}
        nu = {k: _weak(b2, v) * v + _weak(1 - b2, grads[k]) * grads[k] * grads[k]
              for k, v in state.nu.items()}
        stepf = step.to(torch.float32)
        bc1 = 1 - torch.pow(b1, stepf)
        bc2 = 1 - torch.pow(b2, stepf)
        updates = {}
        for k in mu:
            # JAX's promotion of (moment, f32 0-d): bf16 moments give an f32 update
            dt = torch.promote_types(mu[k].dtype, bc1.dtype)
            upd = -lr * (mu[k].to(dt) / bc1) / (torch.sqrt(nu[k].to(dt) / bc2) + eps)
            if weight_decay and params is not None:
                upd = upd - _weak(lr * weight_decay, params[k]) * params[k]
            updates[k] = upd
        return updates, AdamState(step=step, mu=mu, nu=nu)

    return Optimizer(init, update)


def adamw(lr: float, weight_decay: float = 0.01, **kw) -> Optimizer:
    return adam(lr, weight_decay=weight_decay, **kw)


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


def clip_by_global_norm(updates: Tree, max_norm: float) -> Tree:
    """Every leaf scaled by ``min(1, max_norm / (norm + 1e-12))``, ``norm``
    the 2-norm of all leaves together, summed in sorted key order."""
    total: Any = 0
    for k in sorted(updates):
        total = total + (updates[k] * updates[k]).sum()
    norm = torch.sqrt(torch.as_tensor(total))
    ratio = _weak(max_norm, norm) / (norm + _weak(1e-12, norm))
    scale = torch.minimum(torch.ones_like(ratio), ratio)
    return {k: u.to(torch.promote_types(u.dtype, scale.dtype)) * scale
            for k, u in updates.items()}
