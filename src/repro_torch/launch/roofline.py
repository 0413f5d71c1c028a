"""Roofline terms of one traced step per H100: the counterpart of
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
  counterpart of ``memory_analysis``'s argument + output + temp bytes;
- **collectives**: every functional collective (``_c10d_functional.*``,
  ``_dtensor.shard_dim_alltoall``) a DTensor step issues: its kind, result
  bytes, group size and the mesh dims the group spans, and its wire bytes
  per device by ``repro``'s ring formulas (b the result's bytes, g the group):
  all-gather b(g-1)/g, all-reduce 2b(g-1)/g, reduce-scatter b(g-1),
  all-to-all b(g-1)/g, permute (and broadcast) b.

On a device mesh (DTensors, ``launch/mesh.py``) every count is **per
device**: a ``TorchDispatchMode`` sees a DTensor op at the DTensor level,
with global shapes, so the counter steps aside for it and counts the ops
DTensor then runs on this rank's local shards (the redistributions'
collectives among them), as ``repro``'s ``cost_analysis`` counts per
partition. DTensor's own bookkeeping is not counted: its sharding
propagation runs each new op once on global-shape fake tensors (the counter
pauses there), and a fake trace runs the rest of it outside the trace's
fake mode, on host values; inside a DTensor op the counter counts only the
ops on the trace's fake tensors (or, on real tensors, the ops on no fake
one).

Per step and device:

    compute_s    = bf16 FLOPs / 989e12 + f32 FLOPs / 67e12
    memory_s     = bytes accessed / 3.35e12
    collective_s = sum over groups of wire bytes / link
                   (450e9 NVLink 4 within an 8-card node, 50e9 a
                    ConnectX-7 NDR port across nodes; 0 on one card)

MODEL_FLOPS is ``repro``'s 6 N D (train; 2 N D forward only) with N the
active parameters for MoE; MODEL_FLOPS / (counted FLOPs x chips) is the
share of the counted compute that is "useful" (remat's recompute and the
MoE's dispatch einsums count against it).
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from collections import Counter
from typing import Dict, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor, unset_fake_temporarily
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# H100 SXM5 80GB HBM3 data sheet figures (the card the port runs on, at its
# 700 W power limit); the f32 rate is the CUDA cores' (TF32 off, as the
# port's conformance runs), the link rates per direction: NVLink 4 inside an
# HGX H100 node of 8 cards, and the one ConnectX-7 NDR InfiniBand port (400
# Gb/s) each card of such a node has to the others (data sheet figures).
BF16_FLOPS = 989e12  # dense bf16 on the tensor cores
F32_FLOPS = 67e12  # f32 on the CUDA cores
HBM_BW = 3.35e12  # bytes/s
LINK_BW = 450e9  # bytes/s per direction, NVLink 4 (a group inside one node)
NET_BW = 50e9  # bytes/s per direction, ConnectX-7 NDR 400 Gb/s (a group across nodes)
NODE_CARDS = 8  # cards an HGX H100 node joins by NVLink
CARD_BYTES = 80e9  # HBM3 capacity
ALLOC_GRANULE = 512  # bytes: the CUDA caching allocator's block rounding

_TENSOR_CORE = ("bfloat16", "float16")
# allocations and metadata: no bytes read or written
VIEW_FREE = {
    torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
    torch.ops.aten.empty_like.default, torch.ops.aten.new_empty.default,
    torch.ops.aten.new_empty_strided.default, torch.ops.aten.lift_fresh.default,
    torch.ops.aten._local_scalar_dense.default, torch.ops.aten._unsafe_view.default,
    torch.ops._c10d_functional.wait_tensor.default,
}

# functional collectives -> (kind, the position of the group name argument)
_COLLECTIVES = {
    "_c10d_functional.all_gather_into_tensor": ("all-gather", 2),
    "_c10d_functional.all_gather_into_tensor_coalesced": ("all-gather", 2),
    "_c10d_functional.all_reduce": ("all-reduce", 2),
    "_c10d_functional.all_reduce_coalesced": ("all-reduce", 2),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", 3),
    "_c10d_functional.reduce_scatter_tensor_coalesced": ("reduce-scatter", 3),
    "_c10d_functional.all_to_all_single": ("all-to-all", 3),
    "_dtensor.shard_dim_alltoall": ("all-to-all", 3),
    "_c10d_functional.broadcast": ("broadcast", 2),
}


def wire_bytes(kind: str, result_bytes: float, group: int) -> float:
    """Bytes each device sends for one collective of ``result_bytes`` over a
    group of ``group`` ranks, by ``repro``'s ring formulas (0 on one rank)."""
    g, b = group, float(result_bytes)
    if g <= 1:
        return 0.0
    if kind in ("all-gather", "all-to-all"):
        return b * (g - 1) / g
    if kind == "all-reduce":
        return b * 2 * (g - 1) / g
    if kind == "reduce-scatter":
        return b * (g - 1)
    return b  # permute, broadcast


def _dtensor_type():
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:  # a build without torch.distributed
        return None
    return DTensor


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (this rank's tensor); any other tensor itself."""
    local = getattr(t, "_local_tensor", None)
    return local if local is not None else t


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
    """FLOPs by dtype, bytes accessed, op calls, live / peak bytes and
    collectives of the ops dispatched while it is entered (enter it after
    ``FakeTensorMode`` for a fake trace), per device on DTensors.
    ``track(tree)`` counts tensors made before entering it (parameters,
    optimizer state, batch, cache; a DTensor's local shard) as live.
    ``mesh``, where given, names the mesh dims a collective's group spans."""

    def __init__(self, mesh=None):
        super().__init__()
        self.flops: Counter = Counter()  # dtype name -> FLOPs
        self.flops_by_op: Counter = Counter()
        self.calls: Counter = Counter()  # op name -> calls
        self.bytes_accessed = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        # (kind, group size, mesh dims, ranks within one node) -> [calls, bytes, wire bytes]
        self.collectives: Dict[Tuple, list] = {}
        self._live: Dict[int, weakref.ref] = {}
        self._dtensor = _dtensor_type()
        self._in_dtensor = False
        self._paused = 0  # inside DTensor's sharding propagation
        self._trace_mode = None  # the fake mode of a fake trace, inside a DTensor op
        self._groups: Dict[str, Tuple[str, ...]] = {}  # group name -> mesh dims
        if mesh is not None:
            names = mesh.mesh_dim_names or tuple(str(i) for i in range(mesh.ndim))
            for i, name in enumerate(names):
                if mesh.size(i) > 1:
                    self._groups[mesh.get_group(i).group_name] = (name,)

    # ------------------------------------------------------------ live bytes
    def _add(self, t: torch.Tensor) -> None:
        st = _local(t).untyped_storage()
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

    # ---------------------------------------------------------- collectives
    def _group(self, group_name: str) -> Tuple[int, Tuple[str, ...], bool]:
        """(size, mesh dims spanned, whether all its ranks share one node)."""
        from torch.distributed import distributed_c10d as c10d

        pg = c10d._resolve_process_group(group_name)
        ranks = c10d.get_process_group_ranks(pg)
        dims = self._groups.get(group_name, ())
        return pg.size(), dims, len({r // NODE_CARDS for r in ranks}) == 1

    def _collective(self, name: str, args, outs) -> None:
        kind, at = _COLLECTIVES[name]
        size, dims, in_node = self._group(args[at])
        nb = sum(map(_nbytes, outs))
        key = (kind, size, dims, in_node)
        rec = self.collectives.setdefault(key, [0, 0, 0.0])
        rec[0] += 1
        rec[1] += nb
        rec[2] += wire_bytes(kind, nb, size)

    def collective_bytes(self) -> float:
        """Wire bytes per device over every collective."""
        return float(sum(r[2] for r in self.collectives.values()))

    def collective_breakdown(self) -> Dict[str, float]:
        """Wire bytes per device by collective kind (``repro``'s breakdown)."""
        out: Counter = Counter()
        for (kind, *_), r in self.collectives.items():
            out[kind] += r[2]
        return dict(out)

    def collective_s(self) -> float:
        """Each group's wire bytes over the link it crosses: NVLink 4 inside
        one node, the node's network port across nodes."""
        return sum(r[2] / (LINK_BW if in_node else NET_BW)
                   for (_, _, _, in_node), r in self.collectives.items())

    def collective_table(self) -> list:
        return [{"kind": k, "group_size": g, "mesh_dims": list(d), "within_node": n,
                 "calls": r[0], "bytes": r[1], "wire_bytes": r[2]}
                for (k, g, d, n), r in sorted(self.collectives.items())]

    # ------------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._dtensor is not None and any(issubclass(t, self._dtensor) for t in types):
            if self._in_dtensor:  # DTensor's own dispatch, under this mode
                return NotImplemented
            # A DTensor op (global shapes): let DTensor run it, with this mode
            # on to count the local ops, and the fake mode off, so that its
            # bookkeeping runs on real host values (the local shards stay
            # fake and dispatch to their own mode).
            self._in_dtensor = True
            try:
                with unset_fake_temporarily() as fake, self, self._pause_in_propagation():
                    self._trace_mode = fake
                    return func(*args, **kwargs)
            finally:
                self._in_dtensor = False
        out = func(*args, **kwargs)
        outs = _tensors(out if isinstance(out, (list, tuple)) else (out,))
        if not outs:  # a metadata query (the fake mode asks for devices): no work
            return out
        ins = _tensors(args) + _tensors(kwargs.values())
        if self._paused or (self._in_dtensor and not self._step_work(ins + outs)):
            return out
        name = str(func.overloadpacket)
        self.calls[name] += 1
        packet = func._overloadpacket
        if name in _COLLECTIVES:
            self._collective(name, args, outs)
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
    @contextlib.contextmanager
    def _pause_in_propagation(self):
        """No counting while DTensor's sharding propagation runs an op on
        global shapes to learn its output's metadata."""
        prop = self._dtensor._op_dispatcher.sharding_propagator
        own = getattr(prop, "_propagate_tensor_meta_non_cached", None)
        if own is None:
            yield
            return

        def paused(*a, **k):
            self._paused += 1
            try:
                return own(*a, **k)
            finally:
                self._paused -= 1

        prop._propagate_tensor_meta_non_cached = paused
        try:
            yield
        finally:
            del prop._propagate_tensor_meta_non_cached

    def _step_work(self, ts) -> bool:
        """Inside a DTensor op: whether an op on ``ts`` is this rank's work,
        not DTensor's bookkeeping (host values, or its sharding
        propagation's global-shape fake tensors)."""
        modes = {t.fake_mode for t in ts if isinstance(t, FakeTensor)}
        if self._trace_mode is None:
            return not modes
        return self._trace_mode in modes

    @property
    def total_flops(self) -> int:
        return int(sum(self.flops.values()))

    def compute_s(self) -> float:
        tc, rest = split_flops(self)
        return tc / BF16_FLOPS + rest / F32_FLOPS

    def memory_s(self) -> float:
        return self.bytes_accessed / HBM_BW


@contextlib.contextmanager
def fake_trace_placement():
    """DTensor's placement, for a fake trace of a pod-mesh step:

    - a Shard-to-Shard redistribution is the all-to-all it is on a CUDA mesh
      also on a CPU one, where DTensor falls back to an all-gather and a
      chunk (gloo has no all-to-all): the all-to-all op on fake shards
      takes its shape function whatever the mesh's device type, so both
      count the same collectives (real shards keep DTensor's own path);
    - where torch prices a candidate placement that holds a strided shard
      (a dim split over two mesh axes and flattened with another, as the
      2 x 16 x 16 mesh's (pod, data) batch is) by a search over every
      placement of every mesh dim, which takes minutes an op, the candidate
      is priced dim by dim with torch's own step costs, on meshes of three
      dims or more (on two the search is quick, and its price steers DTensor
      clear of strided placements it then fails to view). Which placement
      DTensor picks, and so what is counted, may differ from the search's
      pick where the two prices order candidates differently;
    - a redistribution's backward (an autograd function's, run by the engine
      outside any op) plans with the fake mode set aside, as ``constrain``'s
      forward does (``models/sharding.py:redistribute``).

    All are undone on exit."""
    try:
        from torch.distributed.tensor import _collective_utils as cu, placement_types as pt
        from torch.distributed.tensor._ops import utils as ou
        from torch.distributed.tensor._redistribute import Redistribute
    except ImportError:  # a build without torch.distributed
        yield
        return
    own_bwd = Redistribute.__dict__["backward"]

    def backward(ctx, *grads):
        with unset_fake_temporarily():
            return own_bwd.__func__(ctx, *grads)
    own_a2a = getattr(pt, "shard_dim_alltoall", None)
    own_cost = getattr(ou, "redistribute_cost", None)
    step_cost = getattr(cu, "_compute_placement_transition_cost", None)
    strided = getattr(pt, "_StridedShard", None)

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        if not isinstance(input, FakeTensor):
            return own_a2a(input, gather_dim, shard_dim, mesh, mesh_dim)
        group = mesh.get_group(mesh_dim).group_name
        return torch.ops._dtensor.shard_dim_alltoall(input, gather_dim, shard_dim, group)

    def cost(current, target):
        if current.mesh.ndim < 3 or current.mesh != target.mesh or current.is_replicated() \
                or not any(isinstance(p, strided)
                           for p in (*current.placements, *target.placements)):
            return own_cost(current, target)
        topo = cu.MeshTopoInfo.build_from_mesh(current.mesh)
        gb = cu.spec_to_bytes(current) / current.num_shards / 2**30
        total = 0.0
        for dim, (c, t) in enumerate(zip(current.placements, target.placements)):
            if c != t:
                step, gb = step_cost(c, t, topo, dim, gb)
                total += step
        return total

    Redistribute.backward = staticmethod(backward)
    if own_a2a is not None:
        pt.shard_dim_alltoall = alltoall
    if None not in (own_cost, step_cost, strided):
        ou.redistribute_cost = cost
    try:
        yield
    finally:
        Redistribute.backward = own_bwd
        if own_a2a is not None:
            pt.shard_dim_alltoall = own_a2a
        if own_cost is not None:
            ou.redistribute_cost = own_cost


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
    """The roofline of one counted step per device (``repro``'s takes a
    compiled executable; here the counter of the traced step and the bytes
    of its arguments)."""
    flops = float(counter.total_flops)
    compute_s, memory_s = counter.compute_s(), counter.memory_s()
    collective_s = counter.collective_s()
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_per_device=flops, bytes_per_device=float(counter.bytes_accessed),
        collective_bytes_per_device=counter.collective_bytes(),
        collective_breakdown=counter.collective_breakdown(),
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
