"""CUDA wrapper: row-wise AdaGrad on the touched rows, in place
(``csrc/row_adagrad.cu``).

The Hopper counterpart of ``repro/kernels/row_adagrad.py:row_adagrad_scatter_pallas``:
for each non-PAD id of the bucket, ``accum[id] += mean(g**2)`` and
``table[id] -= lr * g / (sqrt(accum[id]) + eps)``. ``table`` (N, D) and
``accum`` (N, 1) are updated in place; rows no id names are untouched. PAD
slots are skipped, never clamped to row 0 (the source file says why). The
kernel moves 16 bytes a lane where D % 4 == 0 and the table's and
gradients' bases are 16-byte aligned, else 4 bytes.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

# Kernel launches since the last reset (chip_smoke.py reads and resets it).
launches = 0


@functools.lru_cache(maxsize=None)
def kernel_attrs(vec: bool) -> dict:
    """The instantiation (``vec``: 16-byte accesses, else 4-byte): registers
    a thread, local memory bytes (spills and stack), static shared bytes,
    resident blocks an SM, and its grid cap on the current card."""
    out = (ctypes.c_int * 5)()
    build.check(build.library().g4r_row_adagrad_attrs(int(vec), out), "row_adagrad attributes")
    return {"registers": out[0], "local_bytes": out[1], "shared_bytes": out[2],
            "blocks_per_sm": out[3], "grid_cap": out[4]}


def row_adagrad_scatter_cuda(table: torch.Tensor, accum: torch.Tensor, ids: torch.Tensor,
                             grads: torch.Tensor, lr: float = 0.1,
                             eps: float = 1e-8) -> None:
    """In place: (N, D) f32 table, (N, 1) f32 accum, (B,) int64 ids with PADs
    (-1), (B, D) f32 grads, all contiguous on one CUDA device."""
    global launches
    if table.dim() != 2 or tuple(accum.shape) != (table.shape[0], 1):
        raise ValueError(f"row_adagrad wants table (N, D) and accum (N, 1); got "
                         f"{tuple(table.shape)} and {tuple(accum.shape)}")
    if ids.dim() != 1 or tuple(grads.shape) != (ids.shape[0], table.shape[1]):
        raise ValueError(f"row_adagrad wants ids (B,) and grads (B, {table.shape[1]}); "
                         f"got {tuple(ids.shape)} and {tuple(grads.shape)}")
    if (table.dtype, accum.dtype, grads.dtype) != (torch.float32,) * 3 or \
            ids.dtype != torch.int64:
        raise TypeError(f"row_adagrad wants f32 table/accum/grads and int64 ids; got "
                        f"{table.dtype}, {accum.dtype}, {grads.dtype}, {ids.dtype}")
    dev = table.device
    if not (table.is_cuda and accum.device == dev and ids.device == dev
            and grads.device == dev):
        raise ValueError(f"row_adagrad kernel wants every input on one CUDA device; got "
                         f"{table.device}, {accum.device}, {ids.device}, {grads.device}")
    if not all(t.is_contiguous() for t in (table, accum, ids, grads)):
        raise ValueError("row_adagrad kernel wants contiguous table, accum, ids and grads")
    N, D = table.shape
    B = ids.shape[0]
    if B == 0:
        return
    if D == 0 or D >= 2**31:
        raise ValueError(f"row_adagrad kernel wants 1 <= D < 2**31; got {D}")
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.g4r_row_adagrad_f32(table.data_ptr(), accum.data_ptr(), ids.data_ptr(),
                                      grads.data_ptr(), N, B, D, float(lr), float(eps),
                                      stream)
    build.check(err, "row_adagrad")
    launches += 1
