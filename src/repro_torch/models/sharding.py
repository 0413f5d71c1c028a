"""Logical-axis sharding rules of the LM substrate: the counterpart of
``repro/models/sharding.py``.

Model code names a tensor's axes logically; a launcher installs rules that
map the names onto mesh axes. The three rule sets are ``repro``'s, copied
as data, and ``spec(*logical)`` gives the tuple of mesh-axis entries that
``repro``'s ``PartitionSpec`` holds under the current rules (the dry run
reports them, and the tests hold them equal to ``repro``'s).

    batch   -> ("pod", "data") on multi-pod, ("data",) on single pod, () on CPU
    heads / kv_heads / ffn / experts / vocab / mamba_heads -> "model"
    seq / d_model / head_dim / state -> replicated

``constrain`` is the identity where the rules are empty or the tensor lives
on one device, which is every tensor the port holds today: placing tensors
over several cards by these rules (DTensor placements) is the multi-card
slice of ROADMAP Queue 1.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Tuple, Union

import torch

Axis = Union[None, str, Tuple[str, ...]]

_STATE = threading.local()

CPU_RULES: Dict[str, Axis] = {}  # everything replicated

SINGLE_POD_RULES: Dict[str, Axis] = {
    "batch": ("data",),
    "fsdp": ("data",),  # weight/optimizer-state sharding over the data axis
    # sequence parallelism: inter-layer activations shard the sequence over
    # the model axis; attention and Mamba2 gather it on entry
    "seq": "model",
    "cache_seq": "model",  # decode KV-cache sequence axis (context-parallel)
    "heads": "model",
    "kv_heads": "model",
    "ffn": "model",
    "experts": "model",
    "vocab": "model",
    "mamba_heads": "model",
    "expert_group": ("data",),  # token groups for the MoE all-to-all
}

MULTI_POD_RULES: Dict[str, Axis] = {
    **SINGLE_POD_RULES,
    "batch": ("pod", "data"),
    "expert_group": ("pod", "data"),
    # weights replicated across pods (data parallel on the pod axis): "fsdp" stays data
}


def decode_rules(base: Dict[str, Axis]) -> Dict[str, Axis]:
    """Rules for tiny-batch decode (long_500k, batch 1): batch replicated,
    state sharded on heads only."""
    r = dict(base)
    r["batch"] = None
    r["expert_group"] = None
    r["seq"] = None  # decode steps have S = 1 (cache_seq stays sharded)
    return r


def current_rules() -> Dict[str, Axis]:
    return getattr(_STATE, "rules", CPU_RULES)


@contextlib.contextmanager
def use_rules(rules: Dict[str, Axis]):
    """Install ``rules`` for this thread; the previous rules come back on
    exit, so the contexts nest."""
    prev = current_rules()
    _STATE.rules = rules
    try:
        yield
    finally:
        _STATE.rules = prev


def _entry(axis: Axis) -> Axis:
    """A one-axis tuple as its axis, as ``PartitionSpec`` normalises it."""
    return axis[0] if isinstance(axis, tuple) and len(axis) == 1 else axis


def spec(*logical: Optional[str]) -> Tuple[Axis, ...]:
    """The mesh-axis entry of each logical axis under the current rules
    (None: replicated), ``repro``'s ``PartitionSpec`` as a tuple."""
    rules = current_rules()
    return tuple(_entry(rules.get(name)) if name else None for name in logical)


def _distributed(x: torch.Tensor) -> bool:
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:  # a build without torch.distributed
        return False
    return isinstance(x, DTensor)


def constrain(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """``x`` itself under empty rules or on one device; a tensor placed over
    several devices raises (its placement by the rules is not ported)."""
    if not current_rules() or not _distributed(x):
        return x
    raise NotImplementedError(
        f"constrain{spec(*logical)}: placing a DTensor by the sharding rules is "
        "the multi-card slice (ROADMAP Queue 1), not ported yet")
