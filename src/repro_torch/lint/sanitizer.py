"""The runtime sync sanitizer and the audited host drains: the counterpart
of ``repro.lint.sanitizer``, with its names.

This is the dynamic half of the H rules: the static pass bans implicit
syncs from the hot-path modules, and this module gives (1) the guard that
makes an implicit sync fail at run time and (2) the one audited place where
a deliberate sync is spelled out.

``transfer_sanitizer`` wraps a scope in
``torch.cuda.set_sync_debug_mode("error")``: a ``.item()``, a blocking copy,
a boolean-mask index, ``nonzero`` or ``unique`` on a CUDA tensor inside it
raises instead of stalling the pipeline. On the CPU, where nothing waits on
a device, it is a ``nullcontext``.

**The mode is process-wide.** ``jax.transfer_guard`` is thread-local; torch's
sync debug mode is one setting of the process, so a guarded scope also
catches a sync made by another thread meanwhile. The port relies on this
only where no other thread touches the card while a guard is up: the
trainer's prefetch producer builds numpy batches (it pins nothing and
copies nothing to the card), the graph service's workers are separate
processes that import no torch, and the serving paths run on the caller's
thread. A thread that must sync while another holds the guard would raise.

The drains below are the hot path's only spelling of a readback: each is an
explicit copy into fresh pinned host memory with ``non_blocking=True``,
then a wait on a CUDA event recorded after it. That is the torch spelling
of ``jax.device_get``: the sync debug mode flags a blocking copy and a
stream or device synchronise, not an event's wait, so the drains pass a
guarded scope. A fresh pinned buffer each time: one reused while a copy
into it is in flight would be overwritten. On the CPU a drain is
``.numpy()`` of the tensor, as ``.cpu().numpy()`` is there.
"""
from __future__ import annotations

import contextlib
from typing import Iterable, List, Optional

import numpy as np
import torch


def _cuda_ready() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


@contextlib.contextmanager
def _sync_debug_error():
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def transfer_sanitizer(enabled: bool = True, device: Optional[torch.device] = None):
    """Context manager: an implicit device<->host sync inside the scope
    raises (CUDA only, process-wide; see the module doc).

    ``device`` names the device the scope works on: a CPU device gives a
    no-op context, as does ``enabled=False``, so call sites can thread a
    config flag without branching. With ``device=None`` the guard is up
    wherever CUDA is in use in the process.
    """
    if not enabled:
        return contextlib.nullcontext()
    if device is not None and torch.device(device).type != "cuda":
        return contextlib.nullcontext()
    if device is None and not _cuda_ready():
        return contextlib.nullcontext()
    return _sync_debug_error()


class _Readback:
    """One tensor's started copy into fresh pinned memory, and its event."""

    def __init__(self, x: torch.Tensor):
        x = x.detach()
        self._event = None
        if x.is_cuda:
            self._host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            self._host.copy_(x, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = x

    def wait(self) -> torch.Tensor:
        if self._event is not None:
            self._event.synchronize()
        return self._host


def host_array(x, dtype=None) -> np.ndarray:
    """Deliberate device->host (or host->host) array materialisation.

    The audited spelling of ``np.asarray`` and ``.cpu().numpy()`` for the
    hot-path modules: a CUDA tensor is drained through pinned memory and an
    event (see the module doc), a CPU tensor is its ``.numpy()``, anything
    else goes through ``np.asarray``. ``dtype`` applies a final cast on the
    host copy.
    """
    if isinstance(x, torch.Tensor):
        x = _Readback(x).wait().numpy()
    return np.asarray(x, dtype=dtype)


def host_scalar(x) -> float:
    """Deliberate single-value device->host sync."""
    return float(host_array(x).reshape(()))


def host_floats(xs: Iterable) -> List[float]:
    """Deliberate batched device->host drain: one copy for the lot."""
    return AsyncFloats(xs).resolve()


class AsyncFloats:
    """A started (non-blocking) device->host drain of scalars, resolved
    later: the scalars stacked on the device, one copy into fresh pinned
    memory and one event. ``resolve`` waits on the event only, which is
    near-free once a window of steps has been dispatched on top of the
    copy. Values and order are those of a blocking drain."""

    def __init__(self, xs: Iterable):
        xs = list(xs)
        self._n = len(xs)
        if xs and all(isinstance(x, torch.Tensor) for x in xs):
            self._read = _Readback(torch.stack([x.reshape(()) for x in xs]))
        else:
            self._read = None
            self._vals = [host_scalar(x) for x in xs]

    def __len__(self) -> int:
        return self._n

    def resolve(self) -> List[float]:
        if self._read is None:
            return list(self._vals)
        return [float(v) for v in self._read.wait().tolist()]


def host_floats_async(xs: Iterable) -> AsyncFloats:
    """Begin a deliberate device->host drain without blocking the loop."""
    return AsyncFloats(xs)


def device_barrier(x=None, device: Optional[torch.device] = None):
    """Deliberate drain point (end of a run, before a timing): waits for the
    work queued so far on the current stream of ``device`` (the current
    device by default) through an event; returns ``x``. A no-op where CUDA
    is not in use."""
    if device is not None and torch.device(device).type != "cuda":
        return x
    if device is None and not _cuda_ready():
        return x
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    event.synchronize()
    return x
