"""Device-memory accounting: per-phase high-water gauges on one device.

The counterpart of ``repro.obs.memory``. Where ``repro`` walks
``jax.live_arrays()`` and reads ``device.memory_stats()``, the port reads
PyTorch's caching allocator on an explicit device:

- :func:`live_array_bytes` — ``torch.cuda.memory_allocated(device)``: the
  bytes of every tensor alive on the card. A host-side counter of the
  allocator, so reading it never syncs (the trainer may sample it while
  steps are in flight).
- :func:`device_memory_stats` — ``torch.cuda.memory_stats(device)``, the
  allocator's numeric counters (``allocated_bytes.all.peak`` and the rest),
  plus ``max_memory_allocated``.

On a CPU device PyTorch keeps no such counters: both report zeros, and
:meth:`MemoryAccountant.summary` says so in its ``note`` rather than
passing zeros off as a measurement.

:class:`MemoryAccountant` samples at coarse lifecycle boundaries (tables
resident, steady-state loop, eval) into ``memory.<phase>_bytes`` gauges
whose high-water mark is the per-phase peak.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch

from repro_torch.device import DeviceLike, resolve_device

CPU_NOTE = ("cpu device: PyTorch keeps no allocator counters for host tensors; "
            "every byte count here is 0, not a measurement")


def live_array_bytes(device: DeviceLike = None) -> int:
    """Bytes of every live tensor on ``device`` (None -> CUDA); 0 on a CPU
    device, which has no allocator counters."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return 0
    return int(torch.cuda.memory_allocated(dev))


def device_memory_stats(device: DeviceLike = None) -> Dict[str, Dict[str, int]]:
    """The allocator's numeric counters on ``device``, keyed by the device
    name; ``{}`` on a CPU device."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return {}
    stats = {k: int(v) for k, v in torch.cuda.memory_stats(dev).items()
             if isinstance(v, (int, float))}
    stats["max_memory_allocated"] = int(torch.cuda.max_memory_allocated(dev))
    return {str(dev): stats}


def memory_snapshot(device: DeviceLike = None) -> Dict:
    """One point-in-time reading: live bytes + allocator stats."""
    dev = resolve_device(device)
    out: Dict = {"live_array_bytes": live_array_bytes(dev),
                 "device_stats": device_memory_stats(dev)}
    if dev.type != "cuda":
        out["note"] = CPU_NOTE
    return out


class MemoryAccountant:
    """Phase-boundary high-water memory sampling on one device.

    ``sample(phase)`` reads the live bytes, folds them into the phase's
    peak and (with a registry) sets the ``memory.<phase>_bytes`` gauge.
    ``scope(phase)`` samples on exit.
    """

    def __init__(self, metrics=None, device: DeviceLike = None):
        self._metrics = metrics
        self.device = resolve_device(device)
        self.peaks: Dict[str, int] = {}

    def sample(self, phase: str) -> int:
        n = live_array_bytes(self.device)
        if n > self.peaks.get(phase, -1):
            self.peaks[phase] = n
        if self._metrics is not None:
            self._metrics.gauge(f"memory.{phase}_bytes").set(n)
        return n

    @contextlib.contextmanager
    def scope(self, phase: str):
        """Sample at region exit — the footprint once the phase's tensors
        are resident."""
        try:
            yield self
        finally:
            self.sample(phase)

    def summary(self) -> Dict:
        """The ``memory`` section: per-phase peaks + a final snapshot."""
        out: Dict = {"phase_peak_bytes": dict(self.peaks)}
        out.update(memory_snapshot(self.device))
        return out


def sample_scope(accountant: Optional[MemoryAccountant], phase: str):
    """Null-safe ``accountant.scope``: no accountant, no cost."""
    if accountant is None:
        return contextlib.nullcontext()
    return accountant.scope(phase)
