"""Observability / timing-hygiene rules (O family), a copy of
``repro.lint.rules_obs`` over the port's instrumented modules.

The telemetry layer (``repro_torch.obs``) correlates spans across threads and
processes on the ``time.perf_counter_ns`` timebase (CLOCK_MONOTONIC on
Linux), and every latency metric the registry aggregates assumes a
monotonic source. ``time.time()`` is wall-clock: NTP slews and steps it,
so intervals measured with it can be negative or wildly wrong, and spans
stamped with it land on a different timeline than everything else in the
exported trace.

- **O001** ``time.time()`` in an instrumented module (the hot-path globs
  plus every module the telemetry layer instruments or implements). Use
  ``time.perf_counter_ns()`` / ``time.perf_counter()`` for intervals and
  spans, ``time.monotonic()`` for deadlines; ``time.time()`` is only for
  actual wall-clock timestamps (log records, file names) — which do not
  belong in these modules.
"""
from __future__ import annotations

import ast
import fnmatch
from typing import List

from repro_torch.lint.core import HOT_PATH_GLOBS, Finding, LintModule, Rule, call_name

# The hot-path modules plus everything the telemetry layer touches: the obs
# package itself (health watchdog included — its stall deadlines MUST be
# monotonic), the attribution timer it backs, and the instrumented
# sampling/retrieval/serving call sites.
INSTRUMENTED_GLOBS = HOT_PATH_GLOBS + (
    "src/repro_torch/obs/*.py",
    "src/repro_torch/train/attribution.py",
    "src/repro_torch/sampling/*.py",
    "src/repro_torch/retrieval/*.py",
    "src/repro_torch/core/recall.py",
    "src/repro_torch/serve/*.py",
)


def _applies(module: LintModule) -> bool:
    return any(fnmatch.fnmatch(module.rel, g) for g in INSTRUMENTED_GLOBS)


def _check_o001(module: LintModule) -> List[Finding]:
    if not _applies(module):
        return []
    out = []
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Call):
            continue
        if call_name(node) == "time.time":
            out.append(
                module.finding(
                    O001, node,
                    "time.time() is wall-clock (NTP can slew/step it): "
                    "intervals measured with it are unreliable and spans "
                    "stamped with it misalign with the perf_counter_ns "
                    "trace timeline",
                )
            )
    return out


O001 = Rule(
    "O001", "wall-clock-in-instrumented-module", "obs",
    "time.time() used in a hot-path or telemetry-instrumented module",
    "time.perf_counter_ns()/perf_counter() for intervals and spans, "
    "time.monotonic() for deadlines",
    _check_o001,
)

RULES = (O001,)
