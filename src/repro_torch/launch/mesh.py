"""Meshes of the launch tools: the counterpart of ``repro/launch/mesh.py``.

``repro`` builds its meshes from JAX devices (a 1 x 1 host mesh for its CPU
tests, 16 x 16 and 2 x 16 x 16 TPU v5e pods for its dry run). The port's
are descriptions, and starting one needs no ``torch.distributed``: the host
mesh (1 x 1 over the CPU, axes ``("data", "model")``, as ``repro``'s) and
the one-card mesh ``1xH100`` that the dry run traces for. The pod meshes'
counterparts (several cards, a process group) are the multi-card slice of
ROADMAP Queue 1.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class Mesh:
    name: str
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    device_type: str  # "cpu" or "cuda"

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def axis_sizes(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.shape))


def make_host_mesh() -> Mesh:
    """One CPU device, every axis of size 1 (the CPU tests)."""
    return Mesh("1x1", (1, 1), ("data", "model"), "cpu")


def make_card_mesh() -> Mesh:
    """One H100: the mesh the dry run counts for."""
    return Mesh("1xH100", (1, 1), ("data", "model"), "cuda")
