"""Kernel rules (K family), over ``src/repro_torch/kernels/`` and its
``csrc/*.cu``: the port's counterpart of ``repro``'s Pallas rules (P).

Every kernel of the port comes as a triad (ROADMAP, standing contracts):
the CUDA source and its wrapper, a plain-torch oracle in ``kernels/ref.py``
and a dispatcher in ``kernels/ops.py`` that runs the kernel on CUDA and the
oracle on the CPU. The entry points are bound with ``ctypes`` from one
table, ``kernels/build.py``'s ``_SIGNATURES``.

- **K001** (triad, P003's counterpart) every kernel entry point of
  ``_SIGNATURES`` is called by a wrapper function of a ``kernels/*.py``
  module, some function of ``ops.py`` calls that wrapper, and that
  dispatcher also calls an oracle ``ref.<name>`` defined in ``ref.py``. The
  ``*_attrs``, ``*_plan`` and ``*_probe`` entries, ``g4r_empty`` and
  ``g4r_error_string`` are diagnostics (attributes, plans, a probe tile,
  the launch floor, error text) and need no triad.
- **K002** (arity, P002's counterpart) each ``_SIGNATURES`` entry matches
  its ``extern "C"`` prototype in ``csrc/*.cu`` in parameter count and in
  each parameter's class: pointer, ``int``, ``long long``, ``float``. ctypes
  converts by the table, not by the prototype, so a mismatch corrupts the
  arguments silently.
- **K003** (P004's counterpart) the library's ``g4r_*`` symbols are
  called only under ``kernels/`` (tests excepted), where the wrappers check
  shapes, strides and devices and count launches.

``repro``'s P001 (a floor-divided Pallas grid) has no counterpart: the
port's grids are sized in each ``.cu`` file's host code, in C, which this
pass does not parse.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.lint.core import Finding, LintModule, Rule, attr_source, call_name

SIGNATURES = "_SIGNATURES"
_DIAGNOSTIC_SUFFIXES = ("_attrs", "_plan", "_probe")
_DIAGNOSTIC_NAMES = {"g4r_empty", "g4r_error_string"}
_CTYPES_CLASS = {
    "c_void_p": "pointer", "c_char_p": "pointer", "c_int": "int", "c_int32": "int",
    "c_longlong": "long long", "c_int64": "long long", "c_float": "float",
    "c_double": "double",
}
_EXTERN_RE = re.compile(r'extern\s+"C"\s+[\w\s\*]*?\b(g4r_\w+)\s*\(([^)]*)\)\s*\{')
_COMMENT_RE = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)


def is_diagnostic(entry: str) -> bool:
    """Entries that are not kernels: attributes, plans, probes, the launch
    floor's empty kernel and the error text."""
    return entry in _DIAGNOSTIC_NAMES or entry.endswith(_DIAGNOSTIC_SUFFIXES)


def _signatures(module: LintModule) -> Optional[ast.Dict]:
    """The module's top-level ``_SIGNATURES = {...}`` table, if any."""
    for stmt in module.tree.body:
        if isinstance(stmt, ast.Assign) and isinstance(stmt.value, ast.Dict) and any(
                isinstance(t, ast.Name) and t.id == SIGNATURES for t in stmt.targets):
            return stmt.value
    return None


def _entries(table: ast.Dict) -> List[Tuple[str, ast.expr, ast.expr]]:
    return [(k.value, k, v) for k, v in zip(table.keys, table.values)
            if isinstance(k, ast.Constant) and isinstance(k.value, str)]


def _parse(path: Path) -> Optional[ast.Module]:
    try:
        return ast.parse(path.read_text(), filename=str(path))
    except (OSError, SyntaxError, UnicodeDecodeError):
        return None


def _top_defs(tree: ast.Module) -> List[ast.AST]:
    """Top-level functions, and the methods of top-level classes."""
    out: List[ast.AST] = []
    for stmt in tree.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.append(stmt)
        elif isinstance(stmt, ast.ClassDef):
            out.extend(s for s in stmt.body if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)))
    return out


def _calls(fn: ast.AST) -> Set[str]:
    """Dotted names (and bare last parts) of every call in ``fn``."""
    out: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            name = call_name(node)
            if name:
                out.add(name)
                out.add(name.rsplit(".", 1)[-1])
    return out


# ------------------------------------------------------------------- K001
def _wrappers(kdir: Path) -> Dict[str, Set[str]]:
    """symbol -> the top-level functions of ``kernels/*.py`` (but build,
    ops and ref) whose bodies name it, or call (in the same module, at any
    depth) a function that does."""
    out: Dict[str, Set[str]] = {}
    for f in sorted(kdir.glob("*.py")):
        if f.name in ("build.py", "ops.py", "ref.py", "__init__.py"):
            continue
        tree = _parse(f)
        if tree is None:
            continue
        fns = _top_defs(tree)
        calls = {fn.name: _calls(fn) for fn in fns}
        for fn in fns:
            for node in ast.walk(fn):
                if isinstance(node, ast.Attribute) and node.attr.startswith("g4r_"):
                    names = {fn.name}
                    grew = True
                    while grew:
                        more = {n for n, c in calls.items() if c & names} - names
                        names |= more
                        grew = bool(more)
                    out.setdefault(node.attr, set()).update(names)
    return out


def _ref_names(kdir: Path) -> Set[str]:
    tree = _parse(kdir / "ref.py")
    if tree is None:
        return set()
    names: Set[str] = set()
    for stmt in tree.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(stmt.name)
        elif isinstance(stmt, ast.Assign):
            names.update(t.id for t in stmt.targets if isinstance(t, ast.Name))
    return names


def _check_k001(module: LintModule) -> List[Finding]:
    if not module.is_kernel:
        return []
    table = _signatures(module)
    if table is None:
        return []
    kdir = module.path.parent
    wrappers = _wrappers(kdir)
    ops = _parse(kdir / "ops.py")
    dispatchers = [(fn, _calls(fn)) for fn in (_top_defs(ops) if ops is not None else [])]
    refs = _ref_names(kdir)
    out = []
    for entry, key, _ in _entries(table):
        if is_diagnostic(entry):
            continue
        wrap = wrappers.get(entry, set())
        if not wrap:
            out.append(module.finding(
                K001, key, f"kernel entry point '{entry}' has no wrapper: no function of "
                "a kernels/*.py module calls it"))
            continue
        disp = [(fn, calls) for fn, calls in dispatchers if calls & wrap]
        if not disp:
            out.append(module.finding(
                K001, key, f"kernel entry point '{entry}' has no dispatcher: no function "
                f"of kernels/ops.py calls its wrapper {sorted(wrap)}"))
            continue
        oracles = {c[4:] for _, calls in disp for c in calls
                   if c.startswith("ref.") and c[4:] in refs}
        if not oracles:
            out.append(module.finding(
                K001, key, f"kernel entry point '{entry}' has no oracle: its dispatcher "
                f"{sorted(fn.name for fn, _ in disp)} calls no ref.<name> defined in "
                "kernels/ref.py"))
    return out


# ------------------------------------------------------------------- K002
def _param_class(param: str) -> str:
    p = " ".join(param.replace("const", " ").split())
    if "*" in p or "[" in p:
        return "pointer"
    words = p.split()
    typ = " ".join(words[:-1]) if len(words) > 1 else p
    typ = {"int64_t": "long long", "int32_t": "int", "long long int": "long long"}.get(typ, typ)
    return typ


def prototypes(csrc: Path) -> Dict[str, Tuple[str, List[str]]]:
    """symbol -> (file name, parameter classes) of every ``extern "C"``
    function defined in ``csrc/*.cu``."""
    out: Dict[str, Tuple[str, List[str]]] = {}
    for f in sorted(csrc.glob("*.cu")):
        text = _COMMENT_RE.sub(" ", f.read_text())
        for m in _EXTERN_RE.finditer(text):
            params = [p for p in m.group(2).split(",") if p.strip() and p.strip() != "void"]
            out[m.group(1)] = (f.name, [_param_class(p) for p in params])
    return out


def _aliases(module: LintModule) -> Dict[str, str]:
    """Module-level ``_X = ctypes.c_...`` names -> their ctypes class."""
    out: Dict[str, str] = {}
    for stmt in module.tree.body:
        if isinstance(stmt, ast.Assign) and isinstance(stmt.value, ast.Attribute):
            cls = _CTYPES_CLASS.get(stmt.value.attr)
            if cls and attr_source(stmt.value).startswith("ctypes."):
                out.update({t.id: cls for t in stmt.targets if isinstance(t, ast.Name)})
    return out


def _table_classes(value: ast.expr, aliases: Dict[str, str]) -> Optional[List[str]]:
    """An entry's argument classes, with ``*(_X,) * n`` expanded; None where
    the entry is not a literal this pass can read."""
    if not isinstance(value, (ast.Tuple, ast.List)):
        return None
    out: List[str] = []
    for elt in value.elts:
        if isinstance(elt, ast.Starred):
            inner, n = elt.value, 1
            if isinstance(inner, ast.BinOp) and isinstance(inner.op, ast.Mult) and \
                    isinstance(inner.right, ast.Constant) and isinstance(inner.right.value, int):
                inner, n = inner.left, inner.right.value
            part = _table_classes(inner, aliases)
            if part is None:
                return None
            out.extend(part * n)
            continue
        if isinstance(elt, ast.Name) and elt.id in aliases:
            out.append(aliases[elt.id])
            continue
        src = attr_source(elt)
        if src.startswith("ctypes.") and src[7:] in _CTYPES_CLASS:
            out.append(_CTYPES_CLASS[src[7:]])
            continue
        if isinstance(elt, ast.Call) and call_name(elt) in ("ctypes.POINTER", "POINTER"):
            out.append("pointer")
            continue
        return None
    return out


def _check_k002(module: LintModule) -> List[Finding]:
    if not module.is_kernel:
        return []
    table = _signatures(module)
    if table is None:
        return []
    protos = prototypes(module.path.parent / "csrc")
    aliases = _aliases(module)
    out = []
    for entry, key, value in _entries(table):
        got = _table_classes(value, aliases)
        if got is None:
            out.append(module.finding(
                K002, key, f"'{entry}': the argument types are not a literal tuple of "
                "ctypes names this pass can read"))
            continue
        if entry not in protos:
            out.append(module.finding(
                K002, key, f"'{entry}' has no extern \"C\" definition in csrc/*.cu"))
            continue
        fname, want = protos[entry]
        if len(got) != len(want):
            out.append(module.finding(
                K002, key, f"'{entry}': {len(got)} argument types in {SIGNATURES}, "
                f"{len(want)} parameters in csrc/{fname}"))
            continue
        for i, (g, w) in enumerate(zip(got, want)):
            if g != w:
                out.append(module.finding(
                    K002, key, f"'{entry}': argument {i} is {g} in {SIGNATURES} but "
                    f"{w} in csrc/{fname}"))
                break
    return out


# ------------------------------------------------------------------- K003
def _check_k003(module: LintModule) -> List[Finding]:
    if module.is_kernel or module.is_test:
        return []
    out = []
    for node in ast.walk(module.tree):
        sym = None
        if isinstance(node, ast.Attribute) and node.attr.startswith("g4r_"):
            sym = node.attr
        elif isinstance(node, ast.Call) and call_name(node) == "getattr" and \
                len(node.args) > 1 and isinstance(node.args[1], ast.Constant) and \
                str(node.args[1].value).startswith("g4r_"):
            sym = node.args[1].value
        if sym:
            out.append(module.finding(
                K003, node, f"the kernel library's '{sym}' is reached outside "
                "src/repro_torch/kernels/, past the wrappers' checks and launch counts"))
    return out


K001 = Rule(
    "K001", "kernel-triad", "kernels",
    "a kernel entry point without a wrapper, a dispatcher in ops.py or an oracle in ref.py",
    "add the kernels/<name>.py wrapper, the plain-torch <name>_ref in kernels/ref.py "
    "and the ops.py dispatcher that routes CUDA to the one and the CPU to the other",
    _check_k001,
)
K002 = Rule(
    "K002", "ctypes-arity", "kernels",
    "a _SIGNATURES entry that differs from its extern \"C\" prototype",
    "make the ctypes tuple match the prototype: pointer -> c_void_p, int -> c_int, "
    "long long -> c_longlong, float -> c_float",
    _check_k002,
)
K003 = Rule(
    "K003", "kernel-symbol-outside-kernels", "kernels",
    "a g4r_* library symbol used outside src/repro_torch/kernels/",
    "call the kernel through its kernels/ wrapper (or add one there)",
    _check_k003,
)

RULES = (K001, K002, K003)
