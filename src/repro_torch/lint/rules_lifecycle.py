"""Thread/process lifecycle rules (L family), a copy of
``repro.lint.rules_lifecycle``.

The trainer's prefetch thread and the graph service's worker fleet are
long-lived background actors; the failure mode is never a crash but a
silent leak — an unjoined producer sampling into a dead queue, a lock held
across an exception, an shm segment outliving the run. These rules pin the
conventions the port's graph/service and train/trainer follow:

- **L001** every ``threading.Thread`` / ``Process`` spawn carries a
  ``name=`` (leak warnings and ``py-spy`` dumps are useless without one).
- **L002** a timed ``join(timeout=...)`` is always followed by handling for
  the not-dead case — ``is_alive()`` (warn/escalate) or ``terminate()`` /
  ``kill()`` — in the same function. A bare timed join that falls through
  silently leaks a live thread into the caller.
- **L003** ``threading.Lock``/``RLock``/``Condition`` objects are acquired
  only via ``with`` — manual acquire/release pairs leak the lock on any
  exception between them.
- **L004** a module that creates ``SharedMemory(create=True)`` segments
  registers a ``weakref.finalize`` unlink backstop, so segments cannot
  outlive the interpreter when explicit shutdown is skipped.
"""
from __future__ import annotations

import ast
from typing import List, Optional, Set

from repro_torch.lint.core import (
    Finding,
    LintModule,
    Rule,
    attr_source,
    call_name,
    expr_source,
    keyword_arg,
)

_SPAWN_CALLS = ("threading.Thread", "Thread", "Process")
_LOCK_FACTORIES = {
    "threading.Lock", "threading.RLock", "threading.Condition",
    "Lock", "RLock", "Condition",
}


def _check_l001(module: LintModule) -> List[Finding]:
    out = []
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Call):
            continue
        name = call_name(node)
        if not (name in _SPAWN_CALLS or name.endswith(".Thread") or name.endswith(".Process")):
            continue
        if keyword_arg(node, "name") is None:
            out.append(
                module.finding(
                    L001, node,
                    f"{name}(...) spawned without name= — aliveness warnings "
                    "and stack dumps cannot identify it",
                )
            )
    return out


def _check_l002(module: LintModule) -> List[Finding]:
    out = []
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Call):
            continue
        if not (isinstance(node.func, ast.Attribute) and node.func.attr == "join"):
            continue
        if keyword_arg(node, "timeout") is None:
            continue  # untimed join blocks until death — nothing to leak
        receiver = expr_source(module, node.func.value)
        scope: Optional[ast.AST] = module.enclosing_function(node) or module.tree
        handled = False
        for other in ast.walk(scope):
            if not (
                isinstance(other, ast.Attribute)
                and other.attr in ("is_alive", "terminate", "kill")
                and expr_source(module, other.value) == receiver
            ):
                continue
            if other.lineno >= node.lineno:
                handled = True
                break
        if not handled:
            out.append(
                module.finding(
                    L002, node,
                    f"timed join on '{receiver}' with no aliveness handling "
                    "afterwards — a thread outliving the timeout leaks "
                    "silently into the caller",
                )
            )
    return out


def _lock_names(module: LintModule) -> Set[str]:
    """Terminal names (attr or variable) assigned from a Lock factory."""
    names: Set[str] = set()
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Assign):
            continue
        if not (isinstance(node.value, ast.Call) and call_name(node.value) in _LOCK_FACTORIES):
            continue
        for tgt in node.targets:
            if isinstance(tgt, ast.Name):
                names.add(tgt.id)
            elif isinstance(tgt, ast.Attribute):
                names.add(tgt.attr)
    return names


def _check_l003(module: LintModule) -> List[Finding]:
    locks = _lock_names(module)
    if not locks:
        return []
    out = []
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        if not (isinstance(func, ast.Attribute) and func.attr in ("acquire", "release")):
            continue
        base = func.value
        terminal = base.attr if isinstance(base, ast.Attribute) else (
            base.id if isinstance(base, ast.Name) else ""
        )
        if terminal in locks:
            out.append(
                module.finding(
                    L003, node,
                    f"manual .{func.attr}() on lock "
                    f"'{expr_source(module, base)}' — an exception between "
                    "acquire and release leaks the lock",
                )
            )
    return out


def _check_l004(module: LintModule) -> List[Finding]:
    creates = []
    has_finalize = False
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Call):
            continue
        name = call_name(node)
        if name.endswith("SharedMemory"):
            create = keyword_arg(node, "create")
            if isinstance(create, ast.Constant) and create.value is True:
                creates.append(node)
        elif name.endswith("finalize") and "weakref" in name or name == "finalize":
            has_finalize = True
    if has_finalize:
        return []
    return [
        module.finding(
            L004, node,
            "SharedMemory(create=True) without a weakref.finalize unlink "
            "backstop in this module — a skipped shutdown leaks the segment "
            "past interpreter exit",
        )
        for node in creates
    ]


L001 = Rule(
    "L001", "unnamed-thread", "lifecycle",
    "Thread/Process spawned without a name",
    "pass name='repro-torch-<role>' so leak warnings identify the actor",
    _check_l001,
)
L002 = Rule(
    "L002", "join-no-aliveness", "lifecycle",
    "timed join without aliveness handling on the same receiver",
    "after join(timeout=...), check is_alive() and warn (threads) or "
    "terminate()/kill() (processes)",
    _check_l002,
)
L003 = Rule(
    "L003", "lock-not-with", "lifecycle",
    "manual acquire/release on a threading lock",
    "acquire via 'with lock:' so every exit path releases",
    _check_l003,
)
L004 = Rule(
    "L004", "shm-no-finalizer", "lifecycle",
    "shm segment created without a finalizer unlink backstop",
    "register weakref.finalize(seg, <unlink-by-name>, seg.name) at creation",
    _check_l004,
)

RULES = (L001, L002, L003, L004)
