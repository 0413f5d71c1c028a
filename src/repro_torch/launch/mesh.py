"""Meshes of the launch tools: the counterpart of ``repro/launch/mesh.py``.

``repro`` builds its meshes from JAX devices: a 1 x 1 host mesh for its CPU
tests, and the 16 x 16 ``("data", "model")`` and 2 x 16 x 16 ``("pod",
"data", "model")`` pods its dry run compiles for on 512 placeholder CPU
devices. The port's pod meshes are ``torch.distributed`` ``DeviceMesh``es
of the same shapes and axis names (``make_production_mesh``), built over
the process group the caller started: a fake group of 256 or 512 ranks in
the dry run's own process (``fake_group``; its collectives move nothing,
as ``repro`` sets its placeholder devices only in its dry run), a real one
elsewhere (``make_mesh``: NCCL on the card, gloo on the CPU). The mesh's
device type is ``cuda`` where a CUDA runtime is present and ``cpu`` where it
is not (``mesh_device_type``); no count depends on which.

Two descriptions need no process group: the host mesh (1 x 1 over the CPU,
as ``repro``'s) and the one-card mesh ``1xH100`` that the dry run also
traces for (``make_card_mesh``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple


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
    """One H100: the one-card mesh the dry run counts for."""
    return Mesh("1xH100", (1, 1), ("data", "model"), "cuda")


POD_SHAPES = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def pod_name(multi_pod: bool) -> str:
    """``repro``'s mesh names: ``16x16`` and ``2x16x16``."""
    return "x".join(map(str, POD_SHAPES[multi_pod][0]))


def mesh_device_type() -> str:
    """``cuda`` where a CUDA runtime is present, else ``cpu``."""
    import torch

    return "cuda" if torch.cuda.is_available() else "cpu"


def make_mesh(shape: Sequence[int], axes: Sequence[str], device_type: Optional[str] = None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default process
    group, whose world size must be the mesh's size; ranks row-major, the
    last axis innermost (as ``jax.make_mesh`` lays devices out)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh: start a process group first (fake_group, or "
                           "torch.distributed.init_process_group)")
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"a {tuple(shape)} mesh needs {math.prod(shape)} ranks, the group "
                         f"has {dist.get_world_size()}")
    return init_device_mesh(device_type or mesh_device_type(), tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: Optional[str] = None):
    """``repro``'s pod mesh: (16, 16) ``("data", "model")``, or with
    ``multi_pod`` (2, 16, 16) ``("pod", "data", "model")``, over the process
    group the caller started (``fake_group(256)`` / ``fake_group(512)`` for
    the dry run)."""
    shape, axes = POD_SHAPES[multi_pod]
    return make_mesh(shape, axes, device_type)


@contextlib.contextmanager
def fake_group(world_size: int):
    """A fake process group of ``world_size`` ranks, this process rank 0, for
    the duration of the block: DTensors over it trace every rank's shapes
    and collectives, which move nothing (``torch.testing``'s fake backend).
    The default group is destroyed on exit, so a process can start another;
    one already running raises."""
    import torch.distributed as dist
    import torch.testing._internal.distributed.fake_pg as fake_pg

    if dist.is_initialized():
        raise RuntimeError("fake_group: a process group is running already")
    dist.init_process_group("fake", store=fake_pg.FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
