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

On a ``torch.distributed`` device mesh (``launch/mesh.py``) the rules
become DTensor placements: ``placements(mesh, spec)`` gives each mesh dim
``Shard(d)`` where tensor dim ``d``'s entry names that mesh axis (a tuple
entry such as ``("pod", "data")`` shards ``d`` over each of its axes, in
order, as GSPMD splits it) and ``Replicate()`` elsewhere. ``constrain``
redistributes a DTensor to its placements under the current rules (the
counterpart of ``with_sharding_constraint``; an op DTensor cannot place
raises there, naming the op) and is the identity on a plain tensor or under
empty rules. ``place_model`` places a model's parameters by
``ArchSpec.param_pspecs()`` (the optimizer state, made from them by
``zeros_like``, follows), ``place_tree`` a batch or cache by its
``input_pspecs`` / ``cache_pspecs``, and ``like`` makes a tensor built
inside a forward (a mask, positions, a zero) a replicated DTensor on the
mesh of the DTensor it meets.
"""
from __future__ import annotations

import contextlib
import types
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

Axis = Union[None, str, Tuple[str, ...]]

# process-wide, not per thread as ``repro``'s: on CUDA the autograd engine
# runs the backward, and so a checkpointed block's recompute (remat), in a
# thread of its own, which must see the rules the forward ran under
_STATE = types.SimpleNamespace(rules=None)

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
    return CPU_RULES if _STATE.rules is None else _STATE.rules


@contextlib.contextmanager
def use_rules(rules: Dict[str, Axis]):
    """Install ``rules`` for the process; the previous rules come back on
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


def _dtensor_type():
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:  # a build without torch.distributed
        return None
    return DTensor


def is_distributed(x) -> bool:
    """Whether ``x`` is a DTensor (placed on a device mesh)."""
    dt = _dtensor_type()
    return dt is not None and isinstance(x, dt)


def placements(mesh, entries: Sequence[Axis]) -> list:
    """DTensor placements on ``mesh`` of a tensor whose dim ``d`` has the
    mesh-axis entry ``entries[d]`` (``spec``'s tuple): ``Shard(d)`` on each
    mesh dim the entry names, ``Replicate()`` on the others. A mesh axis the
    mesh does not have, or one named by two tensor dims, raises."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names or ())
    out = [Replicate()] * mesh.ndim
    for d, entry in enumerate(entries):
        if entry is None:
            continue
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            if ax not in names:
                raise KeyError(f"mesh axis {ax!r} of spec {tuple(entries)} is not in the "
                               f"mesh's {names}")
            i = names.index(ax)
            if isinstance(out[i], Shard):
                raise ValueError(f"spec {tuple(entries)} shards two dims over mesh axis {ax!r}")
            out[i] = Shard(d)
    return out


def redistribute(x: torch.Tensor, mesh, to) -> torch.Tensor:
    """``x.redistribute(mesh, to)``, with any fake mode set aside
    while DTensor plans it (its planning computes on small host tensors;
    the shards, fake or not, run the collectives)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    with unset_fake_temporarily():
        return x.redistribute(mesh, to)


def constrain(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """``with_sharding_constraint`` under the current rules: a DTensor is
    redistributed to the placements of ``spec(*logical)`` on its mesh (no
    collective where it has them already); a plain tensor, or any tensor
    under empty rules, comes back as it is."""
    if not current_rules() or not is_distributed(x):
        return x
    if len(logical) != x.dim():
        raise ValueError(f"constrain{tuple(logical)}: {len(logical)} axes for a "
                         f"{x.dim()}-d tensor")
    want = placements(x.device_mesh, spec(*logical))
    if tuple(x.placements) == tuple(want):
        return x
    return redistribute(x, x.device_mesh, want)


def like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``t``, a tensor built inside a forward, as a replicated DTensor on the
    mesh of ``ref`` where ``ref`` is a DTensor; ``t`` itself where ``ref`` is
    plain (or ``t`` is placed already). Every rank builds the same ``t``, so
    no collective is needed."""
    if not is_distributed(ref) or is_distributed(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate

    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def whole_units(x: torch.Tensor, dim: int, units: int) -> torch.Tensor:
    """A DTensor whose dim ``dim`` is split over mesh dims into shards that
    do not hold whole units (``units`` heads of the flattened head dim, say),
    redistributed with that dim replicated, so that it can be unflattened:
    DTensor refuses the view where GSPMD would reshard. Anything else comes
    back as it is."""
    if not is_distributed(x):
        return x
    from torch.distributed.tensor import Replicate

    dim = dim % x.dim()
    split = [i for i, p in enumerate(x.placements) if p.is_shard(dim)]
    n = 1
    for i in split:
        n *= x.device_mesh.size(i)
    if units % n == 0:
        return x
    want = [Replicate() if i in split else p for i, p in enumerate(x.placements)]
    return redistribute(x, x.device_mesh, want)


def place_as(xs: Sequence[torch.Tensor], refs: Sequence[torch.Tensor]) -> list:
    """Each DTensor of ``xs`` redistributed to the placements of the tensor
    at its place in ``refs`` (a gradient to its parameter's); plain tensors
    and those placed so already come back as they are."""
    out = []
    for x, ref in zip(xs, refs):
        if is_distributed(x) and tuple(x.placements) != tuple(ref.placements):
            x = redistribute(x, ref.device_mesh, ref.placements)
        out.append(x)
    return out


class _Reshape(torch.autograd.Function):
    """A DTensor's reshape whose gradient is first placed as the forward's
    output was, so that the inverse reshape is the legal one DTensor made
    (its autograd does not place a gradient as the forward placed the
    tensor, and a view DTensor cannot place raises)."""

    @staticmethod
    def forward(ctx, x, shape):
        ctx.shape = x.shape
        y = x.reshape(shape)
        ctx.mesh, ctx.placements = y.device_mesh, tuple(y.placements)
        return y

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.placements:
            g = redistribute(g, ctx.mesh, ctx.placements)
        return g.reshape(ctx.shape), None


class _Follow(torch.autograd.Function):
    """The identity, whose gradient is placed as its forward value was
    (partial sums reduced)."""

    @staticmethod
    def forward(ctx, y):
        from torch.distributed.tensor import Replicate

        ctx.mesh = y.device_mesh
        ctx.placements = tuple(Replicate() if p.is_partial() else p for p in y.placements)
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.placements:
            g = redistribute(g, ctx.mesh, ctx.placements)
        return g


def follow(y: torch.Tensor) -> torch.Tensor:
    """``y``, whose gradient arrives placed as ``y`` is (partial sums
    reduced) where ``y`` is a DTensor: DTensor's autograd hands an op's
    backward the gradient in whatever placement the op downstream left it,
    and the backward of a product or an embedding then views or
    redistributes it where DTensor cannot (a flattened sequence shard, a
    partial sum into a masked one). A plain tensor comes back as it is."""
    return _Follow.apply(y) if is_distributed(y) else y


def dense_local(x: torch.Tensor) -> torch.Tensor:
    """A DTensor whose shard is laid out contiguously (copied where it is
    not). DTensor decides whether a reshape is a view from the global
    tensor's strides, and a shard gathered or chunked by a redistribution
    may be laid out otherwise, so an op that views it (an einsum's
    flattening) would fail on the shard. Anything else comes back as it is."""
    if not is_distributed(x):
        return x
    local = x.to_local()
    if local.is_contiguous():
        return x
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local.contiguous(), x.device_mesh, x.placements,
                              run_check=False, shape=x.shape, stride=x.stride())


def copy_into(dst: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``dst.copy_(src)``, a DTensor ``src`` first placed as ``dst`` (DTensor
    refuses an in-place op that would change ``dst``'s placement)."""
    return dst.copy_(place_as([src], [dst])[0])


def reshape(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``x.reshape(shape)``; on a DTensor with its gradient reshaped back
    from the forward's placement."""
    if is_distributed(x):
        return _Reshape.apply(x, tuple(shape))
    return x.reshape(tuple(shape))


def split_dim(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """Dim ``dim`` (n * m) split into (n, m), as ``reshape``: the flattened
    heads (..., H * hd) into (..., H, hd), say. On a DTensor the dim is
    first made to hold whole units of m (``whole_units``): where GSPMD
    reshards, DTensor refuses the view."""
    dim = dim % x.dim()
    sh = list(x.shape)
    return reshape(whole_units(x, dim, n), sh[:dim] + [n, sh[dim] // n] + sh[dim + 1:])


def merge_dims(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Dims ``dim`` and ``dim + 1`` merged into one, ``split_dim``'s inverse
    (on a DTensor the outer dim made to hold whole units first)."""
    dim = dim % x.dim()
    sh = list(x.shape)
    return reshape(whole_units(x, dim, sh[dim]), sh[:dim] + [sh[dim] * sh[dim + 1]] + sh[dim + 2:])


def local_apply(fn, out_axes: Sequence[Optional[str]], args: Sequence[torch.Tensor],
                in_axes: Sequence[Sequence[Optional[str]]]):
    """``fn(*args)``; where the arguments are DTensors, ``fn`` runs on each
    rank's shards (``local_map``), each argument first redistributed to the
    placements of its logical axes under the current rules, and the output
    placed by ``out_axes``. For a function whose sharded axes are batch axes
    only (no sum runs over them), so that each rank's shards make its shard
    of the output. DTensor then never places ``fn``'s inner ops: the SSD's
    einsums flatten a batch and a head dim that are both sharded, which
    torch 2.11 refuses as a view. A logical axis that some argument's shards
    would not split evenly is replicated for the call (``local_map`` infers
    the output's global shape from even shards). Plain tensors run ``fn``
    as they are."""
    if not any(is_distributed(a) for a in args):
        return fn(*args)
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    mesh = next(a for a in args if is_distributed(a)).device_mesh
    uneven = set()
    for a, axes in zip(args, in_axes):
        pl = placements(mesh, spec(*axes))
        for d, name in enumerate(axes):
            n = 1
            for i, p in enumerate(pl):
                if p.is_shard(d):
                    n *= mesh.size(i)
            if a.shape[d] % n:
                uneven.add(name)
    in_axes = [tuple(None if n in uneven else n for n in axes) for axes in in_axes]
    out_axes = tuple(None if n in uneven else n for n in out_axes)
    ins = [placements(mesh, spec(*axes)) for axes in in_axes]
    out = placements(mesh, spec(*out_axes))
    args = [a if tuple(a.placements) == tuple(pl) else redistribute(a, mesh, pl)
            for a, pl in zip(args, ins)]
    # an argument replicated over a mesh dim that shards the output (the
    # SSD's B and C over the heads' dim) meets only this rank's share of
    # the output there: its gradient is this rank's share of a sum
    grads = tuple([Partial() if p.is_replicate() and o.is_shard() else p
                   for p, o in zip(pl, out)] for pl in ins)
    return local_map(fn, out_placements=out, in_placements=tuple(ins),
                     in_grad_placements=grads, device_mesh=mesh)(*args)


def _place(t: torch.Tensor, mesh, entries: Sequence[Axis]) -> torch.Tensor:
    """``t`` (the whole tensor, the same on every rank) as a DTensor on
    ``mesh``: ``distribute_tensor`` on real tensors, ``DTensor.from_local``
    of rank 0's shard on fake ones (nothing is moved, nothing allocated)."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.tensor import DTensor, distribute_tensor

    pl = placements(mesh, entries)
    if not isinstance(t, FakeTensor):
        return distribute_tensor(t, mesh, pl)
    local = list(t.shape)
    for i, p in enumerate(pl):  # rank 0's chunk: torch.chunk's first, mesh dim by mesh dim
        if p.is_shard():
            local[p.dim] = -(-local[p.dim] // mesh.size(i))
    shard = t.new_empty(local)
    return DTensor.from_local(shard, mesh, pl, run_check=False, shape=t.shape,
                              stride=t.stride())


def place_model(model: torch.nn.Module, mesh, pspecs: Dict[str, Tuple[Axis, ...]]):
    """Every parameter of ``model`` replaced, in place, by a DTensor on
    ``mesh`` placed by its entry in ``pspecs`` (``ArchSpec.param_pspecs()``
    under the rules the caller installed); returns ``model``. A parameter
    without an entry raises."""
    missing = [n for n, _ in model.named_parameters() if n not in pspecs]
    if missing:
        raise KeyError(f"no sharding spec for parameters {missing[:5]}")
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        placed = _place(p.detach(), mesh, pspecs[name])
        mod.register_parameter(leaf, torch.nn.Parameter(placed, requires_grad=p.requires_grad))
    return model


def place_tree(tree, mesh, pspecs):
    """A batch or cache (dicts and lists of tensors, host values kept) with
    each tensor placed on ``mesh`` by the entry at its place in ``pspecs``
    (``input_pspecs`` / ``cache_pspecs``)."""
    if isinstance(tree, torch.Tensor):
        return _place(tree, mesh, pspecs)
    if isinstance(tree, dict):
        return {k: place_tree(v, mesh, pspecs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(place_tree(v, mesh, s) for v, s in zip(tree, pspecs))
    return tree
