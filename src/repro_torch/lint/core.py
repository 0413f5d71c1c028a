"""The port's contract checker: file walking, suppressions, findings,
baseline. The counterpart of ``repro.lint.core``, a copy of it, kept apart
so that the port imports nothing of ``repro``.

What differs from ``repro``'s:

- **paths.** The default run lints ``src/repro_torch``,
  ``tests/test_torch_*.py``, ``examples/*_torch.py`` and ``chip_smoke.py``
  (a path may be a glob); the hot-path, kernel and source globs name the
  port's files.
- **suppressions** read ``# repro_torch: lint-ignore[RULE]`` (comma
  separated ids, or ``*``), on the offending line or alone on the line
  above it, so neither linter reads the other's tags.
- **baseline** is ``lint_baseline_torch.json``, committed empty.

The static pass is stdlib only (``ast``, ``json``, ``fnmatch``, ``re``,
``pathlib``): it imports neither ``torch`` nor ``repro``. The runtime half,
``repro_torch.lint.sanitizer``, imports torch and is loaded only by its
users.
"""
from __future__ import annotations

import ast
import dataclasses
import fnmatch
import json
import re
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Set, Tuple

# Modules where an implicit host sync or H2D transfer is a performance bug:
# the training step loop, the fused sampler, the graph service and the
# serving path. Repo-relative posix globs.
HOT_PATH_GLOBS = (
    "src/repro_torch/train/trainer.py",
    "src/repro_torch/sampling/fused.py",
    "src/repro_torch/graph/service/*.py",
    "src/repro_torch/retrieval/*.py",
    "src/repro_torch/infer/*.py",
)
KERNEL_GLOB = "src/repro_torch/kernels/*.py"
TEST_GLOB = "tests/*.py"
SRC_GLOB = "src/*"
DEFAULT_PATHS = ("src/repro_torch", "tests/test_torch_*.py", "examples/*_torch.py",
                 "chip_smoke.py")

_SUPPRESS_RE = re.compile(r"#\s*repro_torch:\s*lint-ignore\[([A-Za-z0-9*,\s]+)\]")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str  # e.g. "D002"
    name: str  # short rule slug, e.g. "rng-underived-seed"
    path: str  # repo-relative posix path
    line: int
    col: int
    message: str
    hint: str  # how to fix it
    context: str  # enclosing class/def chain, "<module>" at top level
    snippet: str  # stripped source line (fingerprint component)

    def fingerprint(self) -> Tuple[str, str, str, str]:
        """Line-number-free identity used for baseline matching."""
        return (self.rule, self.path, self.context, self.snippet)

    def render(self) -> str:
        return (
            f"{self.path}:{self.line}:{self.col}: {self.rule} [{self.name}] "
            f"{self.message}\n    hint: {self.hint}"
        )


class LintModule:
    """One parsed source file plus the per-file context every rule needs."""

    def __init__(self, path: Path, rel: str, source: str):
        self.path = path
        self.rel = rel  # repo-relative posix path
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=rel)
        self.suppressions = _parse_suppressions(self.lines)
        self._parents: Dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                self._parents[child] = parent

    # ------------------------------------------------------------ classifiers
    @property
    def is_test(self) -> bool:
        return fnmatch.fnmatch(self.rel, TEST_GLOB)

    @property
    def is_hot_path(self) -> bool:
        return any(fnmatch.fnmatch(self.rel, g) for g in HOT_PATH_GLOBS)

    @property
    def is_kernel(self) -> bool:
        return fnmatch.fnmatch(self.rel, KERNEL_GLOB)

    @property
    def is_src(self) -> bool:
        return fnmatch.fnmatch(self.rel, SRC_GLOB)

    def imports(self, mod: str) -> bool:
        """True if the module imports ``mod`` (or a submodule of it)."""
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                if any(a.name == mod or a.name.startswith(mod + ".") for a in node.names):
                    return True
            elif isinstance(node, ast.ImportFrom) and node.module:
                if node.module == mod or node.module.startswith(mod + "."):
                    return True
        return False

    # --------------------------------------------------------------- helpers
    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self._parents.get(node)

    def ancestors(self, node: ast.AST) -> Iterator[ast.AST]:
        cur = self._parents.get(node)
        while cur is not None:
            yield cur
            cur = self._parents.get(cur)

    def context_of(self, node: ast.AST) -> str:
        chain = [
            a.name
            for a in self.ancestors(node)
            if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
        ]
        return ".".join(reversed(chain)) or "<module>"

    def enclosing_function(self, node: ast.AST) -> Optional[ast.AST]:
        for a in self.ancestors(node):
            if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return a
        return None

    def snippet_at(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""

    def finding(
        self, rule: "Rule", node: ast.AST, message: str, hint: Optional[str] = None
    ) -> Finding:
        return Finding(
            rule=rule.id,
            name=rule.name,
            path=self.rel,
            line=node.lineno,
            col=node.col_offset,
            message=message,
            hint=hint if hint is not None else rule.hint,
            context=self.context_of(node),
            snippet=self.snippet_at(node.lineno),
        )


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str  # "D002"
    name: str  # "rng-underived-seed"
    family: str  # "determinism" | "hostsync" | "kernels" | "lifecycle" | "obs"
    description: str
    hint: str
    check: Callable[[LintModule], List[Finding]]


# ------------------------------------------------------------- suppressions
def _parse_suppressions(lines: Sequence[str]) -> Dict[int, Set[str]]:
    """line number -> suppressed rule ids ("*" = all).

    A ``# repro_torch: lint-ignore[...]`` comment suppresses its own line;
    when the line holds nothing but the comment, it suppresses the next
    line instead (for statements too long to carry a trailing comment).
    """
    out: Dict[int, Set[str]] = {}
    for i, text in enumerate(lines, start=1):
        m = _SUPPRESS_RE.search(text)
        if not m:
            continue
        ids = {t.strip() for t in m.group(1).split(",") if t.strip()}
        target = i + 1 if text.strip().startswith("#") else i
        out.setdefault(target, set()).update(ids)
    return out


def is_suppressed(module: LintModule, finding: Finding) -> bool:
    ids = module.suppressions.get(finding.line, ())
    return "*" in ids or finding.rule in ids


# ------------------------------------------------------------------ AST utils
def attr_source(node: ast.AST) -> str:
    """Dotted source of a Name/Attribute chain ('' for anything else)."""
    parts: List[str] = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
        return ".".join(reversed(parts))
    return ""


def call_name(node: ast.Call) -> str:
    """Dotted name of a call's callee ('' when not a plain name chain)."""
    return attr_source(node.func)


def expr_source(module: LintModule, node: ast.AST) -> str:
    try:
        return ast.get_source_segment(module.source, node) or ast.dump(node)
    except Exception:  # pragma: no cover - defensive
        return ast.dump(node)


def keyword_arg(node: ast.Call, name: str) -> Optional[ast.expr]:
    for kw in node.keywords:
        if kw.arg == name:
            return kw.value
    return None


# ------------------------------------------------------------------- runner
def iter_py_files(root: Path, paths: Sequence[str]) -> Iterator[Path]:
    """The .py files under ``paths`` (files, directories or globs relative
    to ``root``), each once, in order."""
    seen: Set[Path] = set()
    for p in paths:
        base = (root / p) if not Path(p).is_absolute() else Path(p)
        if any(c in p for c in "*?["):
            cands = sorted(f for f in root.glob(p) if f.is_file() and f.suffix == ".py")
        elif base.is_file() and base.suffix == ".py":
            cands = [base]
        elif base.is_dir():
            cands = [f for f in sorted(base.rglob("*.py")) if "__pycache__" not in f.parts]
        else:
            cands = []
        for f in cands:
            if f not in seen:
                seen.add(f)
                yield f


def run_lint(
    root: Path,
    paths: Sequence[str] = DEFAULT_PATHS,
    rules: Optional[Sequence[Rule]] = None,
) -> List[Finding]:
    """Lint every .py file under ``paths`` (repo-relative); returns findings
    sorted by (path, line), with inline suppressions already filtered."""
    if rules is None:
        rules = all_rules()
    root = Path(root).resolve()
    findings: List[Finding] = []
    for f in iter_py_files(root, paths):
        try:
            rel = f.resolve().relative_to(root).as_posix()
        except ValueError:
            rel = f.as_posix()
        try:
            module = LintModule(f, rel, f.read_text())
        except (SyntaxError, UnicodeDecodeError) as e:
            raise RuntimeError(f"lint: cannot parse {rel}: {e}") from e
        for rule in rules:
            for finding in rule.check(module):
                if not is_suppressed(module, finding):
                    findings.append(finding)
    findings.sort(key=lambda x: (x.path, x.line, x.rule))
    return findings


def all_rules() -> List[Rule]:
    from repro_torch.lint import (
        rules_determinism,
        rules_hostsync,
        rules_kernels,
        rules_lifecycle,
        rules_obs,
    )

    return (
        list(rules_determinism.RULES)
        + list(rules_hostsync.RULES)
        + list(rules_kernels.RULES)
        + list(rules_lifecycle.RULES)
        + list(rules_obs.RULES)
    )


# ------------------------------------------------------------------ baseline
BASELINE_FILE = "lint_baseline_torch.json"


def load_baseline(path: Path) -> Dict[Tuple[str, str, str, str], int]:
    """Baseline as a fingerprint multiset (fingerprint -> count)."""
    if not path.exists():
        return {}
    data = json.loads(path.read_text())
    out: Dict[Tuple[str, str, str, str], int] = {}
    for item in data.get("findings", []):
        fp = (item["rule"], item["path"], item["context"], item["snippet"])
        out[fp] = out.get(fp, 0) + 1
    return out


def write_baseline(path: Path, findings: Sequence[Finding]) -> None:
    data = {
        "version": 1,
        "findings": [
            {
                "rule": f.rule,
                "path": f.path,
                "context": f.context,
                "snippet": f.snippet,
            }
            for f in findings
        ],
    }
    path.write_text(json.dumps(data, indent=2, sort_keys=True) + "\n")


def new_findings(
    findings: Sequence[Finding],
    baseline: Dict[Tuple[str, str, str, str], int],
) -> List[Finding]:
    """Findings beyond the baseline's per-fingerprint counts."""
    remaining = dict(baseline)
    out: List[Finding] = []
    for f in findings:
        fp = f.fingerprint()
        if remaining.get(fp, 0) > 0:
            remaining[fp] -= 1
        else:
            out.append(f)
    return out
