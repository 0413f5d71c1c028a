"""Host-sync rules (H family), the torch spelling of
``repro.lint.rules_hostsync``.

The trainer overlaps host sampling with device work, and the serving path
keeps its tables on the card; one implicit sync in either serialises the
pipeline. These rules apply only to the hot-path modules
(``core.HOT_PATH_GLOBS``) and only when the module imports torch: the graph
service's workers are numpy-only processes and may sync as they like.

- **H001** implicit device-to-host sync: ``.item()``, ``.tolist()``,
  ``.cpu()``, ``.numpy()``, ``float()`` / ``int()`` / ``bool()`` on a
  value that may be a tensor, ``torch.cuda.synchronize``,
  ``np.asarray`` / ``np.array``. Deliberate syncs go through the audited
  drains of ``repro_torch.lint.sanitizer`` (``host_scalar``,
  ``host_array``, ``host_floats``, ``host_floats_async``,
  ``device_barrier``): an explicit copy into pinned memory and a wait on
  an event.
- **H002** a tensor built from host data on a CUDA device
  (``torch.tensor`` / ``torch.as_tensor`` with ``device=``, or
  ``torch.tensor`` / ``as_tensor`` / ``from_numpy(...)`` followed by
  ``.to(device)``) outside the audited ``to_device`` helpers, which copy
  with ``non_blocking=True``; the sync debug mode does not see a pageable
  copy that a producer thread hides.

``int(x)`` / ``float(x)`` / ``bool(x)`` are not flagged where ``x`` is
host-evident, that is, cannot hold a device value: a constant; a
``.shape`` / ``.ndim`` read or a ``.size()`` / ``.numel()`` / ``.dim()`` /
``.element_size()`` call; a call of a numpy function (``np.*``) or of an
audited drain (``host_array`` / ``host_scalar`` / ``host_floats``); an
attribute, an index or a method call of a host-evident value; ``len``, and
``min`` / ``max`` / ``abs`` / ``round`` / ``sum`` of host-evident values or
of a generator of them; arithmetic of host-evident values; a name that the
enclosing function, or the module, binds only to host-evident values; a
parameter annotated ``int`` / ``float`` / ``bool`` (or ``Optional`` of one).
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from repro_torch.lint.core import Finding, LintModule, Rule, attr_source, call_name, keyword_arg

_ARRAY_CALLS = {"np.asarray", "numpy.asarray", "np.array", "numpy.array"}
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_CASTS = {"float", "int", "bool"}
_SHAPE_ATTRS = {"shape", "ndim"}
_SHAPE_METHODS = {"size", "numel", "dim", "element_size"}
_HOST_BUILTINS = {"min", "max", "abs", "round", "sum"}
_DRAINS = {"host_array", "host_scalar", "host_floats"}
_SCALAR_ANNOTATIONS = {"int", "float", "bool"}
_HOST_BUILDERS = {"torch.tensor", "torch.as_tensor", "torch.from_numpy"}


def _applies(module: LintModule) -> bool:
    return module.is_hot_path and module.imports("torch")


def _host_evident(node: ast.expr, host_names: Set[str]) -> bool:
    """True where ``node`` cannot hold a device value (see the module doc)."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.Name):
        return node.id in host_names
    if isinstance(node, ast.Attribute):
        return node.attr in _SHAPE_ATTRS or _host_evident(node.value, host_names)
    if isinstance(node, ast.Subscript):
        return _host_evident(node.value, host_names)
    if isinstance(node, ast.Call):
        name = call_name(node)
        if name == "len" or name.split(".")[0] in ("np", "numpy") or name in _DRAINS:
            return True
        if isinstance(node.func, ast.Attribute):
            return node.func.attr in _SHAPE_METHODS or _host_evident(node.func.value, host_names)
        if name in _HOST_BUILTINS and not node.keywords:
            return all(_host_evident(a, host_names) for a in node.args)
        return False
    if isinstance(node, (ast.GeneratorExp, ast.ListComp)):
        return _host_evident(node.elt, host_names)
    if isinstance(node, ast.BinOp):
        return _host_evident(node.left, host_names) and _host_evident(node.right, host_names)
    if isinstance(node, ast.UnaryOp):
        return _host_evident(node.operand, host_names)
    return False


def _scalar_annotation(ann: Optional[ast.expr]) -> bool:
    if isinstance(ann, ast.Name):
        return ann.id in _SCALAR_ANNOTATIONS
    if isinstance(ann, ast.Subscript) and attr_source(ann.value) in ("Optional", "typing.Optional"):
        return _scalar_annotation(ann.slice)
    return False


def _host_names(scope: ast.AST, outer: Set[str] = frozenset()) -> Set[str]:
    """Names ``scope`` (a function, or the module) binds only to
    host-evident values, to a fixed point: a function's parameters
    annotated ``int`` / ``float`` / ``bool`` and its locals every
    assignment of which is host-evident, given ``outer`` (the module's)."""
    names: Set[str] = set()
    params: Set[str] = set()
    if isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef)):
        args = scope.args
        for a in args.posonlyargs + args.args + args.kwonlyargs:
            params.add(a.arg)
            if _scalar_annotation(a.annotation):
                names.add(a.arg)
        params.update(a.arg for a in (args.vararg, args.kwarg) if a is not None)
        body = list(ast.walk(scope))
    else:  # the module: its top-level statements only
        body = [n for stmt in scope.body for n in ast.walk(stmt)
                if not isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))]
    assigned: Dict[str, list] = {}
    bad: Set[str] = set()
    for node in body:
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    assigned.setdefault(tgt.id, []).append(node.value)
                else:
                    bad.update(n.id for n in ast.walk(tgt) if isinstance(n, ast.Name))
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)) and isinstance(node.target, ast.Name):
            if node.value is None:
                continue
            value = node.value if isinstance(node, ast.AnnAssign) else ast.BinOp(
                left=node.target, op=node.op, right=node.value)
            assigned.setdefault(node.target.id, []).append(value)
        elif isinstance(node, (ast.For, ast.comprehension, ast.NamedExpr)):
            bad.update(n.id for n in ast.walk(node.target) if isinstance(n, ast.Name))
        elif isinstance(node, ast.With):
            for item in node.items:
                if item.optional_vars is not None:
                    bad.update(n.id for n in ast.walk(item.optional_vars)
                               if isinstance(n, ast.Name))
    cands = {n for n in assigned if n not in bad and (n not in params or n in names)}
    known = set(outer) - params - set(assigned) - bad
    changed = True
    while changed:
        changed = False
        for n in sorted(cands - names):
            if all(_host_evident(v, known | names | {n}) for v in assigned[n]):
                names.add(n)
                changed = True
    return known | names


def _check_h001(module: LintModule) -> List[Finding]:
    if not _applies(module):
        return []
    out = []
    module_names = _host_names(module.tree)
    host_cache = {None: module_names}
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Call):
            continue
        name = call_name(node)
        if name in _CASTS and node.args:
            func = module.enclosing_function(node)
            if func not in host_cache:
                host_cache[func] = _host_names(func, module_names)
            if not _host_evident(node.args[0], host_cache[func]):
                out.append(
                    module.finding(
                        H001, node,
                        f"{name}() on a value that may be a tensor blocks until the "
                        "device queue drains",
                        "use repro_torch.lint.sanitizer.host_scalar(x) for a "
                        "deliberate sync",
                    )
                )
        elif name in _ARRAY_CALLS:
            out.append(
                module.finding(
                    H001, node,
                    f"{name}() on a tensor is an implicit device-to-host copy",
                    "use repro_torch.lint.sanitizer.host_array(x), or build the "
                    "host array outside the hot path",
                )
            )
        elif name in ("torch.cuda.synchronize", "cuda.synchronize"):
            out.append(
                module.finding(
                    H001, node,
                    "torch.cuda.synchronize stalls the dispatch pipeline",
                    "use repro_torch.lint.sanitizer.device_barrier() at the one "
                    "audited drain point",
                )
            )
        elif isinstance(node.func, ast.Attribute) and node.func.attr in _SYNC_METHODS \
                and not node.args and not node.keywords:
            out.append(
                module.finding(
                    H001, node,
                    f".{node.func.attr}() on a CUDA tensor waits for the device and "
                    "copies to pageable memory",
                    "use repro_torch.lint.sanitizer.host_array / host_scalar / "
                    "host_floats",
                )
            )
    return out


def _is_host_builder(node: ast.AST) -> bool:
    return isinstance(node, ast.Call) and call_name(node) in _HOST_BUILDERS


def _moves_device(node: ast.Call) -> bool:
    """A ``.to(...)`` call that names a device (not a dtype alone)."""
    if keyword_arg(node, "device") is not None:
        return True
    return any(not attr_source(a).startswith("torch.") for a in node.args)


def _check_h002(module: LintModule) -> List[Finding]:
    if not _applies(module):
        return []
    out = []
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Call):
            continue
        func = module.enclosing_function(node)
        if func is not None and func.name == "to_device":
            continue
        name = call_name(node)
        built = None
        if name in ("torch.tensor", "torch.as_tensor") and keyword_arg(node, "device") is not None:
            built = name
        elif (isinstance(node.func, ast.Attribute) and node.func.attr == "to"
              and _is_host_builder(node.func.value) and _moves_device(node)):
            built = call_name(node.func.value) + "(...).to"
        if built:
            out.append(
                module.finding(
                    H002, node,
                    f"{built}(device) builds a device tensor from host data outside "
                    "the audited to_device helpers",
                )
            )
    return out


H001 = Rule(
    "H001", "implicit-host-sync", "hostsync",
    "implicit device->host sync in a hot-path module",
    "route deliberate syncs through repro_torch.lint.sanitizer "
    "(host_scalar/host_array/host_floats/device_barrier)",
    _check_h001,
)
H002 = Rule(
    "H002", "implicit-h2d-transfer", "hostsync",
    "a device tensor built from host data outside to_device in a hot-path module",
    "copy through the module's to_device helper (pinned or contiguous host "
    "memory, non_blocking=True)",
    _check_h002,
)

RULES = (H001, H002)
