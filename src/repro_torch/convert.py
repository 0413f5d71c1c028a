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
"""
from __future__ import annotations

import os
from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.core.model import Graph4RecConfig, Graph4RecModel, init_model_params
from repro_torch.device import DeviceLike, resolve_device


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
