"""Roofline terms of one traced step on one H100: the counterpart of
``repro/launch/roofline.py``.

``repro`` compiles each step with XLA and reads per-device FLOPs and bytes
from ``cost_analysis``, memory from ``memory_analysis`` and collective bytes
from the HLO text, then divides by TPU v5e figures. The port runs the step
eagerly under ``StepCounter``, a ``TorchDispatchMode`` that sees every aten
op and every custom kernel op (``g4r::flash_attention`` and its backward)
as it dispatches, on fake CUDA tensors in the dry run (nothing allocated,
nothing launched) or on real ones on the card:

- **FLOPs**, by the formulas of ``torch.utils.flop_counter`` (matmuls,
  convolutions, attention, and the flash ops' own: 4 hd a (query, key)
  pair of the band forward, 10 hd backward), split by the dtype of the
  op's first tensor operand. As ``FlopCounterMode`` counts, elementwise
  ops and reductions add none;
- **bytes accessed**: each op's tensor operands and outputs at their
  element counts, views and allocations apart (``VIEW_FREE``): XLA's
  "bytes accessed" for an eager program, a custom kernel op's inputs read
  once and outputs written once;
- **live bytes**: every storage alive, from the step's arguments (``track``)
  and each op's new outputs until Python frees them, each rounded up to the
  512 bytes the CUDA caching allocator gives a block; ``peak_bytes`` is the
  counterpart of ``memory_analysis``'s argument + output + temp bytes.

Per step, on one card:

    compute_s    = bf16 FLOPs / 989e12 + f32 FLOPs / 67e12
    memory_s     = bytes accessed / 3.35e12
    collective_s = collective bytes / 450e9     (0 on one card)

MODEL_FLOPS is ``repro``'s 6 N D (train; 2 N D forward only) with N the
active parameters for MoE; MODEL_FLOPS / (counted FLOPs x chips) is the
share of the counted compute that is "useful" (remat's recompute and the
MoE's dispatch einsums count against it).
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import Counter
from typing import Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# H100 SXM5 80GB HBM3 data sheet figures (the card the port runs on, at its
# 700 W power limit); the f32 rate is the CUDA cores' (TF32 off, as the
# port's conformance runs), the link rate NVLink 4's per direction.
BF16_FLOPS = 989e12  # dense bf16 on the tensor cores
F32_FLOPS = 67e12  # f32 on the CUDA cores
HBM_BW = 3.35e12  # bytes/s
LINK_BW = 450e9  # bytes/s per direction, NVLink 4
CARD_BYTES = 80e9  # HBM3 capacity
ALLOC_GRANULE = 512  # bytes: the CUDA caching allocator's block rounding

_TENSOR_CORE = ("bfloat16", "float16")
# allocations and metadata: no bytes read or written
VIEW_FREE = {
    torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
    torch.ops.aten.empty_like.default, torch.ops.aten.new_empty.default,
    torch.ops.aten.new_empty_strided.default, torch.ops.aten.lift_fresh.default,
    torch.ops.aten._local_scalar_dense.default, torch.ops.aten._unsafe_view.default,
}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(xs) -> list:
    """The tensors among an op's arguments or outputs (a list of tensors,
    as ``cat`` takes, one level down)."""
    out = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(t for t in x if isinstance(t, torch.Tensor))
    return out


class StepCounter(TorchDispatchMode):
    """FLOPs by dtype, bytes accessed, op calls and live / peak bytes of the
    ops dispatched while it is entered (enter it after ``FakeTensorMode``
    for a fake trace). ``track(tree)`` counts tensors made before entering
    it (parameters, optimizer state, batch, cache) as live."""

    def __init__(self):
        super().__init__()
        self.flops: Counter = Counter()  # dtype name -> FLOPs
        self.flops_by_op: Counter = Counter()
        self.calls: Counter = Counter()  # op name -> calls
        self.bytes_accessed = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: Dict[int, weakref.ref] = {}

    # ------------------------------------------------------------ live bytes
    def _add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._live:
            return
        nb = -(-st.nbytes() // ALLOC_GRANULE) * ALLOC_GRANULE

        def freed(_, key=key, nb=nb):
            self._live.pop(key, None)
            self.live_bytes -= nb

        self._live[key] = weakref.ref(st, freed)
        self.live_bytes += nb

    def track(self, tree) -> int:
        """Count the tensors of ``tree`` (an ``nn.Module``'s parameters, dicts,
        lists, tuples) as live; returns the bytes added."""
        from repro_torch.utils.pytree import tree_leaves as leaves

        before = self.live_bytes
        for t in leaves(tree):
            if isinstance(t, torch.Tensor):
                self._add(t)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        return self.live_bytes - before

    # ------------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out if isinstance(out, (list, tuple)) else (out,))
        if not outs:  # a metadata query (the fake mode asks for devices): no work
            return out
        name = str(func.overloadpacket)
        self.calls[name] += 1
        packet = func._overloadpacket
        ins = _tensors(args) + _tensors(kwargs.values())
        if packet in flop_registry and ins:
            f = int(flop_registry[packet](*args, **kwargs, out_val=out))
            self.flops[str(ins[0].dtype).replace("torch.", "")] += f
            self.flops_by_op[name] += f
        if not func.is_view and func not in VIEW_FREE:
            self.bytes_accessed += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        for t in outs:
            self._add(t)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        return out

    # ---------------------------------------------------------------- terms
    @property
    def total_flops(self) -> int:
        return int(sum(self.flops.values()))

    def compute_s(self) -> float:
        tc, rest = split_flops(self)
        return tc / BF16_FLOPS + rest / F32_FLOPS

    def memory_s(self) -> float:
        return self.bytes_accessed / HBM_BW


def dominant(compute_s: float, memory_s: float, collective_s: float) -> str:
    """The largest of the three terms, as ``repro`` names it."""
    return max((("compute", compute_s), ("memory", memory_s), ("collective", collective_s)),
               key=lambda kv: kv[1])[0]


def useful_ratio(model_flops: float, flops: float, chips: int) -> float:
    """MODEL_FLOPS / (counted FLOPs x chips); 0 where nothing was counted."""
    return model_flops / (flops * chips) if flops else 0.0


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    collective_breakdown: Dict[str, float]
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    useful_ratio: float  # MODEL_FLOPS / (counted FLOPs x chips)
    n_params: float
    n_params_active: float
    arg_bytes_per_device: float
    temp_bytes_per_device: float

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


def analyze(*, arch: str, shape: str, mesh_name: str, chips: int, counter: StepCounter,
            arg_bytes: float, model_flops: float, n_params: float,
            n_params_active: float) -> Roofline:
    """The roofline of one counted step (``repro``'s takes a compiled
    executable; here the counter of the traced step and the bytes of its
    arguments)."""
    flops = float(counter.total_flops)
    compute_s, memory_s, collective_s = counter.compute_s(), counter.memory_s(), 0.0
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_per_device=flops, bytes_per_device=float(counter.bytes_accessed),
        collective_bytes_per_device=0.0, collective_breakdown={},
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant(compute_s, memory_s, collective_s), model_flops=model_flops,
        useful_ratio=useful_ratio(model_flops, flops, chips),
        n_params=n_params, n_params_active=n_params_active,
        arg_bytes_per_device=float(arg_bytes),
        temp_bytes_per_device=float(max(counter.peak_bytes - arg_bytes, 0)),
    )


def model_flops_estimate(n_params: float, n_active: float, tokens: float, kind: str) -> float:
    """6·N·D train, 2·N·D forward-only (prefill), 2·N_active per decoded token."""
    if kind == "train":
        return 6.0 * n_active * tokens
    return 2.0 * n_active * tokens


def split_flops(counter: StepCounter) -> Tuple[int, int]:
    """(tensor-core FLOPs, the rest) of a counter."""
    tc = sum(f for dt, f in counter.flops.items() if dt in _TENSOR_CORE)
    return int(tc), int(counter.total_flops - tc)
