"""The port's contract checker: an AST static pass over the port's files
that turns its standing contracts (per-seed determinism, no hidden host
sync on the hot path, the kernel triad) into machine-checked rules, plus
the lifecycle and timing families. The counterpart of ``repro.lint``; see
docs/lint_torch.md.

Import surface: the static pass (``core`` and the rule modules) is stdlib
only and imports neither torch nor ``repro``; the runtime sync sanitizer,
``repro_torch.lint.sanitizer``, imports torch and is loaded only by its
users (the trainer, retrieval, inference, ``chip_smoke.py``, tests).
"""
from repro_torch.lint.core import (  # noqa: F401
    BASELINE_FILE,
    DEFAULT_PATHS,
    Finding,
    LintModule,
    Rule,
    all_rules,
    load_baseline,
    new_findings,
    run_lint,
    write_baseline,
)
