"""Weights across the two packages, and ``repro``'s flat-npz checkpoints.

``repro`` keeps parameters as a flat dict of arrays under path-like keys:
``emb/node``, ``emb/slot:<name>``, ``gnn/l{L}/r{R}/<w|w1|w2|eps|a_self|a_nbr>``,
``gnn/att/W`` and ``gnn/att/w``. ``params_from_numpy`` builds a
``Graph4RecModel`` from such a dict (checking every key and shape against
the config) and ``model_to_numpy`` is its inverse. ``load_params`` reads a
``repro.train.checkpoint`` ``.npz``; the save/load rules of that module
(``|``-joined keys for nested dicts, the ``.npz`` suffix) are copied here.

``init_params`` draws fresh parameters from a ``torch.Generator`` for runs
without a checkpoint. It cannot reproduce ``jax.random``'s draws, so every
conformance check starts from parameters ``repro`` made, converted.

An IVF index crosses as its numpy fields: ``ivf_index_from_numpy`` makes
the port's ``IVFIndex`` on a device from ``repro``'s (or any object with
the same fields), so both packages can search the very same index.

Optimizer states cross the same way: ``state_to_numpy`` turns the trainer's
state (``RowAdagradState.accum``, ``AdamState`` step/mu/nu, nested in
tuples and dicts as ``repro`` nests them) into numpy, and
``state_from_numpy`` rebuilds the port's state from such a tree, whichever
package made it: a NamedTuple maps by its field names.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.core.model import Graph4RecConfig, Graph4RecModel, init_model_params
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.retrieval.ivf import IVFConfig, IVFIndex


def expected_shapes(cfg: Graph4RecConfig) -> Dict[str, tuple]:
    """Every parameter key of ``cfg`` with its shape (no draws made)."""
    gen = torch.Generator().manual_seed(0)
    with torch.device("meta"):
        params = init_model_params(gen, cfg)
    return {k: tuple(v.shape) for k, v in params.items()}


def params_from_numpy(
    flat: Mapping[str, np.ndarray], cfg: Graph4RecConfig, device: DeviceLike = None
) -> Graph4RecModel:
    """``repro``-keyed arrays -> a ``Graph4RecModel`` on ``device``."""
    dev = resolve_device(device)
    want = expected_shapes(cfg)
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise KeyError(f"params do not match the config: missing {missing}, "
                       f"unexpected {extra}")
    bad = {k: (tuple(np.shape(flat[k])), s) for k, s in want.items()
           if tuple(np.shape(flat[k])) != s}
    if bad:
        raise ValueError(f"param shapes (got, want) differ from the config: {bad}")
    tensors = {
        k: torch.from_numpy(np.array(flat[k], dtype=np.float32)).to(dev) for k in want
    }
    return Graph4RecModel(cfg, tensors)


def model_to_numpy(model: Graph4RecModel) -> Dict[str, np.ndarray]:
    """The inverse of ``params_from_numpy``: host float32 arrays."""
    return {k: v.detach().cpu().numpy() for k, v in model.params.items()}


def init_params(cfg: Graph4RecConfig, seed: int = 0, device: DeviceLike = None) -> Graph4RecModel:
    """Fresh parameters from ``torch.Generator().manual_seed(seed)``."""
    dev = resolve_device(device)
    params = init_model_params(torch.Generator().manual_seed(int(seed)), cfg)
    return Graph4RecModel(cfg, {k: v.to(dev) for k, v in params.items()})


# ----------------------------------------------------------------- IVF index
def ivf_index_from_numpy(index: Any, device: DeviceLike = None) -> IVFIndex:
    """An IVF index's fields (``config`` with ``IVFConfig``'s fields,
    ``centroids``, ``order``, ``offsets``, ``codes``, ``scales``, ``items``,
    ``lpad``, ``spilled_items``) -> the port's ``IVFIndex`` on ``device``,
    uploaded there once. Takes ``repro.retrieval.IVFIndex`` as it is."""
    cfg = IVFConfig(**{f.name: getattr(index.config, f.name)
                       for f in dataclasses.fields(IVFConfig)})
    cfg.validate()
    arrays = {name: np.array(getattr(index, name), dtype=dtype) for name, dtype in (
        ("centroids", np.float32), ("order", np.int32), ("offsets", np.int32),
        ("codes", np.int8), ("scales", np.float32), ("items", np.float32))}
    return IVFIndex(config=cfg, lpad=int(index.lpad),
                    spilled_items=int(index.spilled_items), device=device, **arrays)


# ------------------------------------------------------- optimizer states
def state_to_numpy(tree: Any) -> Any:
    """An optimizer state (NamedTuples, tuples, dicts of tensors) -> the
    same structure of host numpy arrays."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: state_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(state_to_numpy(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(state_to_numpy(v) for v in tree)
    return tree


def _state_types() -> Dict[tuple, type]:
    from repro_torch.embedding.optimizer import RowAdagradState
    from repro_torch.train.optimizer import AdamState

    return {AdamState._fields: AdamState, RowAdagradState._fields: RowAdagradState}


def state_from_numpy(tree: Any, device: DeviceLike = None) -> Any:
    """The inverse of ``state_to_numpy`` onto ``device``; also takes
    ``repro``'s states (``RowAdagradState``, ``AdamState``) as numpy."""
    dev = resolve_device(device)
    types = _state_types()

    def conv(t):
        if isinstance(t, (np.ndarray, np.generic)):
            return torch.from_numpy(np.array(t)).to(dev)
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            cls = types.get(tuple(t._fields))
            if cls is None:
                raise TypeError(f"no port optimizer state has fields {t._fields}")
            return cls(*(conv(v) for v in t))
        if isinstance(t, (list, tuple)):
            return type(t)(conv(v) for v in t)
        return t

    return conv(tree)


# ------------------------------------------- repro.train.checkpoint's format
def normalize_path(path: str) -> str:
    """np.savez appends ``.npz`` when the suffix is missing."""
    return path if path.endswith(".npz") else path + ".npz"


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}|"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}|"))
    else:
        out[prefix.rstrip("|")] = np.asarray(tree)
    return out


def save(path: str, tree: Any) -> str:
    """Flatten a dict pytree with ``|``-joined keys into one ``.npz``."""
    path = normalize_path(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **_flatten(tree))
    return path


def load_flat(path: str) -> Dict[str, np.ndarray]:
    if not os.path.exists(path):
        path = normalize_path(path)
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def load_dict(path: str) -> Dict[str, Any]:
    """Restore a (possibly nested-by-'|') dict pytree."""
    out: Dict[str, Any] = {}
    for key, val in load_flat(path).items():
        parts = key.split("|")
        cur = out
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = val
    return out


def load_params(path: str) -> Dict[str, np.ndarray]:
    """A ``repro`` params checkpoint (``checkpoint.save(path, params)``) ->
    the flat ``repro``-keyed dict that ``params_from_numpy`` takes."""
    tree = load_dict(path)
    bad = sorted(k for k, v in tree.items() if isinstance(v, dict))
    if bad:
        raise ValueError(f"{path}: nested entries {bad} are not model params")
    return tree
