"""The port's public surface against ``repro``'s: every public name of
``repro`` has its counterpart in ``repro_torch``, or a stated reason.

An ``ast`` walk over ``src/repro/**.py`` and ``src/repro_torch/**.py``; the
test reads the files and imports neither package. For each module of
``repro`` the port's module of the same path must bind every public
top-level name (functions, classes, assignments; in a package
``__init__`` also every imported name and ``__all__`` entry), and each of
its classes every public method and field. The exceptions are ``ALLOWED``:
names that exist only for JAX, XLA or the TPU, each with the counterpart
that takes its place in the port.

    PYTHONPATH=src python -m pytest -q tests/test_torch_surface.py
"""
import ast
from pathlib import Path
from typing import Dict, Iterator, Set

import pytest

pytestmark = pytest.mark.quick

SRC = Path(__file__).resolve().parents[1] / "src"
REF, PORT = SRC / "repro", SRC / "repro_torch"

_KERNEL = ("the port's wrapper of its CUDA kernel, `kernels/{}.py:{}_cuda`, dispatched by "
           "`kernels/ops.py`")
_NEG_INF = ("the Pallas kernel's masking constant; the port's plain versions hold it as "
            "`kernels/ref.py:NEG_INF` and its CUDA source as a literal")
_PARAMS = ("a JAX pytree alias (dict of jnp arrays); the port's models are `nn.Module`s "
           "(`models/transformer.py:LM`, `models/whisper.py:Whisper`)")

# "module:name" -> why the name has no place in a PyTorch package, and what
# takes its place. "module:*" is a whole module; "module:Class.name" a member.
ALLOWED: Dict[str, str] = {
    # the seven Pallas kernels and their modules' constants
    "kernels.seg_aggr:seg_aggr_pallas": _KERNEL.format("seg_aggr", "seg_aggr"),
    "kernels.topk:chunked_topk_pallas": _KERNEL.format("topk", "streaming_topk"),
    "kernels.inbatch_loss:inbatch_loss_rows_pallas": _KERNEL.format("inbatch_loss",
                                                                    "inbatch_loss_rows"),
    "kernels.row_adagrad:row_adagrad_scatter_pallas": _KERNEL.format("row_adagrad",
                                                                     "row_adagrad_scatter"),
    "kernels.window_pairs:window_pair_ids_pallas": _KERNEL.format("window_pairs",
                                                                  "window_pair_ids"),
    "kernels.ivf:ivf_list_topk_pallas": _KERNEL.format("ivf", "ivf_list_topk"),
    "kernels.flash_attn:flash_attention_pallas": _KERNEL.format("flash_attn", "flash_attention"),
    "kernels:row_adagrad_scatter_pallas": _KERNEL.format("row_adagrad", "row_adagrad_scatter"),
    "kernels.seg_aggr:NEG_INF": _NEG_INF,
    "kernels.topk:NEG_INF": _NEG_INF,
    "kernels.ivf:NEG_INF": _NEG_INF,
    "kernels.flash_attn:NEG_INF": _NEG_INF,
    "kernels.window_pairs:PAD": ("the Pallas kernel's PAD id; the port's is "
                                 "`sampling/pairs.py:PAD`, and the CUDA source's a literal"),
    # the lint's Pallas rules
    "lint.rules_pallas:*": ("rules over `pl.pallas_call` sites; the port's kernel triad rules "
                            "K001-K003 are `lint/rules_kernels.py`"),
    # JAX's device walkers
    "walk.metapath:jax_walk": ("walks from a `jax.random` key inside `jit`; the port walks from "
                               "the key's drawn bits, `walk/metapath.py:walk_from_bits`"),
    "walk.metapath:jax_walk_multi": ("as `jax_walk`; the port's counterpart is "
                                     "`walk/metapath.py:walk_multi_from_bits`"),
    "walk:jax_walk": "exported `jax_walk`; the port exports `walk_from_bits`",
    "walk:jax_walk_multi": "exported `jax_walk_multi`; the port exports `walk_multi_from_bits`",
    # the npz checkpoint module
    "train.checkpoint:*": ("`repro`'s npz pytree format over jnp arrays; the port reads and "
                           "writes the same files with `convert.py:save`, `load_flat`, "
                           "`load_dict` and `load_params`"),
    "train:checkpoint": "exported `train.checkpoint`; the port's is `repro_torch.convert`",
    # XLA-only paths and the TPU's figures
    "models.layers:Params": _PARAMS,
    "models.moe:Params": _PARAMS,
    "models.mamba2:Params": _PARAMS,
    "models.transformer:Params": _PARAMS,
    "models.whisper:Params": _PARAMS,
    "models.layers:chunked_gqa_attention": (
        "XLA's memory-bounded prefill attention; the port's prefill runs the flash kernel "
        "(`kernels/ops.py:flash_attention`), on the CPU its plain `kernels/ref.py:attention_ref`"),
    "launch.dryrun:compile_spec": (
        "lowers and compiles a step with XLA; the port counts a step traced on fake tensors, "
        "`launch/dryrun.py:count_step`"),
    "launch.roofline:collective_bytes": (
        "parses the collectives of XLA's compiled HLO text; the port counts them as traced, "
        "`launch/roofline.py:StepCounter.collective_bytes`"),
    "launch.roofline:PEAK_FLOPS": ("the TPU v5e's bf16 peak; the port's H100 figures are "
                                   "`launch/roofline.py:BF16_FLOPS` and `F32_FLOPS`"),
    "launch.logparse:PEAK_FLOPS": ("the TPU v5e's bf16 peak; the port's logparse imports the "
                                   "H100's `launch/roofline.py:BF16_FLOPS`"),
    # loggers of JAX-only failure paths
    "obs.memory:log": ("logs failures of `jax.live_arrays` and `Device.memory_stats`; the port "
                       "reads `torch.cuda`'s allocator counters, which have no such path "
                       "(`obs/memory.py:live_array_bytes`, `device_memory_stats`)"),
    # per-arch parameter inits under JAX keys
    "models.transformer:init_lm_params": (
        "draws a JAX pytree from a `PRNGKey`; the port draws `models/transformer.py:init_lm` "
        "(`ArchSpec.init_params`) and loads `repro`'s draws with `convert.lm_params_from_numpy`"),
    "models.transformer:abstract_params": (
        "`jax.eval_shape` of `init_lm_params`; the port's is `configs/base.py:"
        "ArchSpec.abstract_params` (meta tensors)"),
    "models.whisper:init_whisper_params": (
        "draws a JAX pytree from a `PRNGKey`; the port draws `models/whisper.py:init_whisper` "
        "and loads `repro`'s draws with `convert.whisper_params_from_numpy`"),
    "models.whisper:abstract_params": (
        "`jax.eval_shape` of `init_whisper_params`; the port's is `configs/base.py:"
        "ArchSpec.abstract_params` (meta tensors)"),
}


# ------------------------------------------------------------------ the walk
def _statements(body) -> Iterator[ast.stmt]:
    """Top-level statements, those inside top-level ``if`` / ``try`` too."""
    for s in body:
        if isinstance(s, ast.If):
            yield from _statements(s.body)
            yield from _statements(s.orelse)
        elif isinstance(s, ast.Try):
            for part in (s.body, s.orelse, s.finalbody, *(h.body for h in s.handlers)):
                yield from _statements(part)
        else:
            yield s


def _assigned(s: ast.stmt) -> Set[str]:
    targets = s.targets if isinstance(s, ast.Assign) else \
        [s.target] if isinstance(s, ast.AnnAssign) else []
    return {n.id for t in targets for n in ast.walk(t) if isinstance(n, ast.Name)}


def _all_entries(s: ast.stmt) -> Set[str]:
    if isinstance(s, ast.Assign) and "__all__" in _assigned(s) and \
            isinstance(s.value, (ast.List, ast.Tuple)):
        return {e.value for e in s.value.elts if isinstance(e, ast.Constant)}
    return set()


def bound_names(tree: ast.Module, exports: bool) -> Set[str]:
    """The names a module binds at top level: definitions and assignments,
    and with ``exports`` its imports and ``__all__`` too."""
    out: Set[str] = set()
    for s in _statements(tree.body):
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(s.name)
        elif isinstance(s, (ast.Assign, ast.AnnAssign)):
            out |= _assigned(s) | (_all_entries(s) if exports else set())
        elif exports and isinstance(s, ast.Import):
            out |= {(a.asname or a.name).split(".")[0] for a in s.names}
        elif exports and isinstance(s, ast.ImportFrom):
            out |= {a.asname or a.name for a in s.names}
    return out


def members(cls: ast.ClassDef) -> Set[str]:
    """A class's methods, fields and class attributes."""
    out: Set[str] = set()
    for s in cls.body:
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.add(s.name)
        elif isinstance(s, (ast.Assign, ast.AnnAssign)):
            out |= _assigned(s)
    return out


def public(names: Set[str]) -> Set[str]:
    return {n for n in names if not n.startswith("_")}


def surface_gaps(ref: ast.Module, port: ast.Module, is_init: bool) -> Set[str]:
    """The public names of ``ref`` that ``port`` lacks: ``name`` or
    ``Class.member``."""
    gaps = public(bound_names(ref, is_init)) - bound_names(port, True)
    port_classes = {s.name: s for s in _statements(port.body) if isinstance(s, ast.ClassDef)}
    for s in _statements(ref.body):
        if isinstance(s, ast.ClassDef) and not s.name.startswith("_") and s.name in port_classes:
            gaps |= {f"{s.name}.{m}" for m in public(members(s)) - members(port_classes[s.name])}
    return gaps


def module_name(rel: Path) -> str:
    parts = rel.with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def module_gaps(rel: Path) -> Set[str]:
    """``module:name`` keys of everything ``repro``'s module ``rel`` has and
    the port's lacks (``module:*`` where the port has no such module)."""
    mod = module_name(rel)
    port = PORT / rel
    if not port.exists():
        return {f"{mod}:*"}
    gaps = surface_gaps(ast.parse((REF / rel).read_text()), ast.parse(port.read_text()),
                        rel.name == "__init__.py")
    return {f"{mod}:{g}" for g in gaps}


REF_MODULES = sorted(p.relative_to(REF) for p in REF.rglob("*.py"))


# ------------------------------------------------------------------- checks
@pytest.mark.parametrize("rel", REF_MODULES, ids=str)
def test_every_public_name_has_its_counterpart(rel):
    missing = module_gaps(rel) - ALLOWED.keys()
    assert not missing, (f"repro's {rel} has public names the port lacks: {sorted(missing)}; "
                         "port them, or allow them in ALLOWED with the counterpart")


def test_every_allowed_entry_is_still_missing():
    """A stale entry would hide a name the port later removes: each key
    must name a real gap, in a module ``repro`` has."""
    gaps = set().union(*(module_gaps(rel) for rel in REF_MODULES))
    assert sorted(ALLOWED.keys() - gaps) == []


def test_every_allowed_entry_names_its_counterpart():
    for key, why in ALLOWED.items():
        assert ":" in key and why.strip(), key
        assert "`" in why, f"{key}: the reason names no counterpart or source"


def test_the_walk_reports_planted_gaps():
    ref = ast.parse(
        "import os\nfrom a import exported\n__all__ = ['listed']\nX = 1\n_private = 2\n"
        "def f(): pass\nclass C:\n    field: int = 0\n    def m(self): pass\n"
        "    def _h(self): pass\nif True:\n    def g(): pass\n")
    port = ast.parse("from b import f\nclass C:\n    field: int = 0\n")
    assert surface_gaps(ref, port, False) == {"X", "g", "C.m"}
    assert surface_gaps(ref, port, True) == {"X", "g", "os", "exported", "listed", "C.m"}
    assert module_name(Path("walk/__init__.py")) == "walk"
    assert module_name(Path("walk/metapath.py")) == "walk.metapath"


def test_the_walk_imports_neither_package():
    tree = ast.parse(Path(__file__).read_text())
    imported = {a.name.split(".")[0] for s in ast.walk(tree)
                if isinstance(s, ast.Import) for a in s.names}
    imported |= {s.module.split(".")[0] for s in ast.walk(tree)
                 if isinstance(s, ast.ImportFrom) and s.module}
    assert not imported & {"repro", "repro_torch", "jax", "torch"}
