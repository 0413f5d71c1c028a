"""``python -m repro_torch.lint``: run the static pass and gate on the
baseline.

Exit status 0 when every finding is covered by ``lint_baseline_torch.json``
(the committed baseline is empty: the port lints clean); 1 when new
findings appear. ``--write-baseline`` writes the current findings as the
baseline. The flags are ``python -m repro.lint``'s.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from repro_torch.lint.core import (
    BASELINE_FILE,
    DEFAULT_PATHS,
    all_rules,
    load_baseline,
    new_findings,
    run_lint,
    write_baseline,
)


def _find_root(start: Path) -> Path:
    """Repo root = nearest ancestor holding src/repro_torch (falls back to cwd)."""
    for cand in (start, *start.parents):
        if (cand / "src" / "repro_torch").is_dir():
            return cand
    return start


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.lint")
    ap.add_argument(
        "paths", nargs="*", default=list(DEFAULT_PATHS),
        help="files, directories or globs to lint, relative to --root "
             f"(default: {' '.join(DEFAULT_PATHS)})",
    )
    ap.add_argument("--root", type=Path, default=None,
                    help="repo root (default: auto-detect from cwd)")
    ap.add_argument("--baseline", type=Path, default=None,
                    help=f"baseline file (default: <root>/{BASELINE_FILE})")
    ap.add_argument("--no-baseline", action="store_true",
                    help="fail on every finding, ignoring the baseline")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write current findings as the new baseline and exit 0")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    rules = all_rules()
    if args.list_rules:
        for r in rules:
            print(f"{r.id} [{r.name}] ({r.family}): {r.description}")
        return 0

    root = (args.root or _find_root(Path.cwd())).resolve()
    baseline_path = args.baseline or (root / BASELINE_FILE)
    findings = run_lint(root, args.paths, rules)

    if args.write_baseline:
        write_baseline(baseline_path, findings)
        print(f"wrote {len(findings)} finding(s) to {baseline_path}")
        return 0

    baseline = {} if args.no_baseline else load_baseline(baseline_path)
    fresh = new_findings(findings, baseline)
    for f in fresh:
        print(f.render())
    known = len(findings) - len(fresh)
    print(
        f"repro_torch.lint: {len(findings)} finding(s), {len(fresh)} new"
        + (f" ({known} baselined)" if known else "")
    )
    return 1 if fresh else 0


if __name__ == "__main__":
    sys.exit(main())
