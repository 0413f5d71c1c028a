"""Determinism rules (D family), the counterpart of
``repro.lint.rules_determinism``.

The per-seed determinism contract: every stochastic component is keyed by
an explicit caller seed, derived the way ``graph.engine.partition_rng``
does (``np.random.default_rng([seed, ...])``), so the same seed reproduces
a run bitwise. D001–D003 are ``repro``'s numpy rules, unchanged in meaning.
D004 and D005 are the torch spelling of ``repro``'s constant-PRNGKey and
key-reuse rules: torch has no keys, so its counterpart of a key consumed
twice is a draw from the process-wide generator, whose state every caller
and thread shares.
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.lint.core import Finding, LintModule, Rule, call_name, keyword_arg

# substrings that mark an identifier as carrying caller-derived randomness
_SEEDY = ("seed", "rng", "key", "entropy")

# numpy legacy global-state API (np.random.<fn> without a Generator)
_NP_GLOBAL = {
    "seed", "rand", "randn", "randint", "random", "choice", "shuffle",
    "permutation", "uniform", "normal", "standard_normal", "binomial",
    "poisson", "beta", "gamma", "exponential", "bytes", "sample", "ranf",
    "random_sample", "get_state", "set_state",
}

# torch functions that draw from a generator (the global one without
# ``generator=``), called as ``torch.<fn>``
_TORCH_DRAWS = {
    "rand", "randn", "rand_like", "randn_like", "randint", "randint_like",
    "randperm", "multinomial", "bernoulli", "normal", "poisson",
}
# in-place tensor methods that draw, called as ``x.<fn>(...)``
_INPLACE_DRAWS = {
    "uniform_", "normal_", "random_", "bernoulli_", "exponential_", "cauchy_",
    "log_normal_", "geometric_",
}
# ``nn.init`` functions that draw nothing
_INIT_NODRAW = {"calculate_gain", "constant_", "ones_", "zeros_", "eye_", "dirac_"}


def _is_default_rng(node: ast.Call) -> bool:
    name = call_name(node)
    return name == "default_rng" or name.endswith(".default_rng")


def _seed_like(identifier: str) -> bool:
    low = identifier.lower()
    return any(t in low for t in _SEEDY)


def _derives_seed(node: ast.expr) -> bool:
    """True when the expression visibly carries a caller seed: a constant, a
    seed-named variable/attribute, or any compound expression with such a
    leaf (``self.cfg.seed + 7``, ``[int(seed), int(part)]``'s head, ...)."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.Name):
        return _seed_like(node.id)
    if isinstance(node, ast.Attribute):
        return _seed_like(node.attr)
    if isinstance(node, ast.Call):
        return any(_derives_seed(a) for a in node.args) or any(
            kw.value is not None and _derives_seed(kw.value) for kw in node.keywords
        )
    if isinstance(node, ast.BinOp):
        return _derives_seed(node.left) or _derives_seed(node.right)
    if isinstance(node, ast.UnaryOp):
        return _derives_seed(node.operand)
    if isinstance(node, ast.Subscript):
        return _derives_seed(node.value)
    return False


def _check_d001(module: LintModule) -> List[Finding]:
    out = []
    for node in ast.walk(module.tree):
        if (
            isinstance(node, ast.Call)
            and _is_default_rng(node)
            and not node.args
            and not node.keywords
        ):
            out.append(
                module.finding(
                    D001, node,
                    "np.random.default_rng() with no seed draws OS entropy — "
                    "every run differs",
                )
            )
    return out


def _check_d002(module: LintModule) -> List[Finding]:
    if module.is_test:  # test seeds come from fixed parametrize values
        return []
    out = []
    for node in ast.walk(module.tree):
        if not (isinstance(node, ast.Call) and _is_default_rng(node) and node.args):
            continue
        arg = node.args[0]
        if isinstance(arg, (ast.List, ast.Tuple)):
            # the [seed, ...] spawn-key idiom: the head must carry the seed
            ok = bool(arg.elts) and _derives_seed(arg.elts[0])
        else:
            ok = _derives_seed(arg)
        if not ok:
            out.append(
                module.finding(
                    D002, node,
                    "default_rng seed is not derived from a caller seed "
                    "(no seed-carrying term in the expression)",
                )
            )
    return out


def _check_d003(module: LintModule) -> List[Finding]:
    out = []
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Call):
            continue
        name = call_name(node)
        if name.startswith("np.random.") or name.startswith("numpy.random."):
            fn = name.rsplit(".", 1)[1]
            if fn in _NP_GLOBAL:
                out.append(
                    module.finding(
                        D003, node,
                        f"legacy global-state RNG np.random.{fn}() — shared "
                        "mutable state across every caller and thread",
                    )
                )
    return out


def _check_d004(module: LintModule) -> List[Finding]:
    if module.is_test:  # constant seeds are the norm in tests
        return []
    out = []
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Call):
            continue
        name = call_name(node)
        is_seed = name.endswith("manual_seed") or name.endswith("manual_seed_all") or (
            isinstance(node.func, ast.Attribute) and node.func.attr == "manual_seed")
        if is_seed and node.args and isinstance(node.args[0], ast.Constant):
            out.append(
                module.finding(
                    D004, node,
                    f"constant manual_seed({node.args[0].value!r}) outside tests "
                    "pins the run to one stream regardless of the caller's seed",
                )
            )
    return out


def _draw_name(node: ast.Call) -> str:
    """The drawing function this call names ('' when it draws nothing)."""
    name = call_name(node)
    if name.startswith("torch.") and name.count(".") == 1 and name[6:] in _TORCH_DRAWS:
        return name
    for prefix in ("torch.nn.init.", "nn.init.", "init."):
        if name.startswith(prefix) and name.count(".") == prefix.count("."):
            fn = name[len(prefix):]
            return "" if fn in _INIT_NODRAW else name
    if isinstance(node.func, ast.Attribute) and node.func.attr in _INPLACE_DRAWS:
        return "." + node.func.attr
    return ""


def _check_d005(module: LintModule) -> List[Finding]:
    if not module.is_src or not module.imports("torch"):
        return []
    out = []
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Call) or keyword_arg(node, "generator") is not None:
            continue
        name = _draw_name(node)
        if name:
            out.append(
                module.finding(
                    D005, node,
                    f"{name}() with no generator= draws from torch's global "
                    "generator, whose state every caller and thread shares",
                )
            )
    return out


D001 = Rule(
    "D001", "rng-entropy-seed", "determinism",
    "np.random.default_rng() without a seed argument",
    "pass an explicit seed: default_rng(seed) or default_rng([seed, part])",
    _check_d001,
)
D002 = Rule(
    "D002", "rng-underived-seed", "determinism",
    "default_rng seeded by something that does not carry a caller seed",
    "derive the seed like graph.engine.partition_rng: "
    "np.random.default_rng([seed, local_id])",
    _check_d002,
)
D003 = Rule(
    "D003", "np-global-random", "determinism",
    "legacy np.random.* global-state use",
    "create a Generator: rng = np.random.default_rng(seed); rng.<fn>(...)",
    _check_d003,
)
D004 = Rule(
    "D004", "constant-manual-seed", "determinism",
    "constant torch.manual_seed(...) / Generator.manual_seed(...) outside tests",
    "thread a seed parameter: torch.Generator(device).manual_seed(cfg.seed)",
    _check_d004,
)
D005 = Rule(
    "D005", "torch-global-generator", "determinism",
    "a torch draw from the global generator (no generator=) in src",
    "pass generator=gen, a torch.Generator seeded from the caller's seed",
    _check_d005,
)

RULES = (D001, D002, D003, D004, D005)
