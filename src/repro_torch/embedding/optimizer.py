"""Row-wise sparse optimizers for the embedding tables (PS-side updates).

The port of ``repro.embedding.optimizer``. The paper's parameter server
pulls the rows a batch touches and pushes only their gradients back; the
update rule is row-wise AdaGrad, one accumulator per row. Two forms:

- **Scatter form** (``rowwise_adagrad_scatter_update``): gradients arrive as
  (bucket, dim) blocks w.r.t. the gathered sub-table
  (``embedding.table.gather_rows`` over the batch's unique ids), and the
  touched parameter and accumulator rows are stepped IN PLACE through
  ``kernels.ops.rowwise_adagrad_scatter``: the ``row_adagrad`` kernel on the
  card, gather → step → scatter with PAD slots dropped on the CPU.
  O(unique ids) per step whatever the table size.
- **Dense form** (``rowwise_adagrad_update``): the same rule on a full
  (num_rows, dim) gradient; untouched rows have zero grads, so it equals the
  scatter form at O(num_rows) cost. Functional, as in ``repro``.

``RowAdagradState.accum`` maps each table key to its (rows, 1) accumulator
tensor; ``repro_torch.convert`` carries it to and from numpy.
"""
from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Tuple

import torch

from repro_torch.kernels import ops


class RowAdagradState(NamedTuple):
    accum: Dict[str, torch.Tensor]  # per-table (rows, 1) accumulators


def rowwise_adagrad_init(
    params: Mapping[str, torch.Tensor], init_accum: float = 0.0
) -> RowAdagradState:
    return RowAdagradState(
        accum={
            k: torch.full((v.shape[0], 1), init_accum, dtype=v.dtype, device=v.device)
            for k, v in params.items()
        }
    )


def rowwise_adagrad_update(
    params: Mapping[str, torch.Tensor],
    grads: Mapping[str, torch.Tensor],
    state: RowAdagradState,
    lr: float = 0.1,
    eps: float = 1e-8,
) -> Tuple[Dict[str, torch.Tensor], RowAdagradState]:
    """Dense reference form: full-table grads, every row updated."""
    new_params: Dict[str, torch.Tensor] = {}
    new_accum: Dict[str, torch.Tensor] = {}
    for k, p in params.items():
        g = grads[k]
        acc = state.accum[k] + (g * g).mean(dim=-1, keepdim=True)
        new_params[k] = p - lr * g / (torch.sqrt(acc) + eps)
        new_accum[k] = acc
    return new_params, RowAdagradState(accum=new_accum)


def rowwise_adagrad_scatter_update(
    params: Mapping[str, torch.Tensor],
    sub_grads: Mapping[str, torch.Tensor],
    uniq: Mapping[str, torch.Tensor],
    state: RowAdagradState,
    lr: float = 0.1,
    eps: float = 1e-8,
    use_kernel: bool = False,
) -> Tuple[Dict[str, torch.Tensor], RowAdagradState]:
    """Scatter form: step the touched rows only, IN PLACE.

    ``sub_grads[k]``: (bucket, dim) gradient w.r.t.
    ``gather_rows(params[k], uniq[k])``. PAD slots (``uniq[k] < 0``) carry
    zero grads by construction and are skipped. ``params[k]`` and
    ``state.accum[k]`` are updated in place (the port trades ``repro``'s
    functional update for an O(bucket) write) and returned.
    ``use_kernel`` is kept for ``repro``'s signature; the device decides.
    """
    del use_kernel
    new_params: Dict[str, torch.Tensor] = {}
    new_accum: Dict[str, torch.Tensor] = {}
    for k, p in params.items():
        new_params[k], new_accum[k] = ops.rowwise_adagrad_scatter(
            p, state.accum[k], uniq[k], sub_grads[k], lr=lr, eps=eps
        )
    return new_params, RowAdagradState(accum=new_accum)
