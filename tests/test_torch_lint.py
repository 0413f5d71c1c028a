"""The port's contract checker, ``repro_torch.lint``: the families copied
from ``repro.lint`` give ``repro.lint``'s findings on the same snippets;
golden fixtures of the torch rules (D004, D005, H001, H002) and of the
kernel rules (K001-K003); suppression and baseline mechanics; the port's
tree lints clean; the static pass imports neither torch nor jax; and the
runtime sync sanitizer's CPU behaviour (on the card, the guard raises on
``.item()`` and lets the drains through).

Fixtures are written under ``tmp_path`` at their repo-relative paths (e.g.
``src/repro_torch/train/trainer.py``) so the hot-path, kernel and test
globs classify them as they classify the real tree. ``repro.lint``'s
static pass is stdlib only, so this file imports no jax.
"""
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.lint import core
from repro_torch.lint.core import load_baseline, new_findings, run_lint, write_baseline

pytestmark = pytest.mark.quick

REPO = pathlib.Path(__file__).resolve().parents[1]
COPIED = ("D001", "D002", "D003", "L001", "L002", "L003", "L004", "O001")


def lint_snippet(tmp_path, rel, source, extra=None):
    """Write ``source`` (and ``extra``: rel -> source) under ``tmp_path``
    and lint ``rel`` with the port's rules."""
    for r, src in {rel: source, **(extra or {})}.items():
        p = tmp_path / r
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    return run_lint(tmp_path, paths=(rel,))


def rule_ids(findings):
    return sorted(f.rule for f in findings)


# --------------------------------------------- the copied families vs repro
PARITY = {
    "d001_entropy_seed": ("foo.py", """\
        import numpy as np
        rng = np.random.default_rng()
        """),
    "d002_id_only_seed": ("foo.py", """\
        import numpy as np

        def subsample(v):
            return np.random.default_rng(v).integers(0, 10)
        """),
    "d002_spawn_key_clean": ("foo.py", """\
        import numpy as np

        def subsample(seed, v):
            return np.random.default_rng([seed, int(v)]).integers(0, 10)
        """),
    "d002_skipped_in_tests": ("tests/test_foo.py", """\
        import numpy as np

        def test_x(v):
            return np.random.default_rng(v)
        """),
    "d003_global_state": ("foo.py", """\
        import numpy as np

        class A:
            def f(self, x):
                np.random.shuffle(x)
                return np.random.rand(3)
        """),
    "l001_unnamed_spawn": ("foo.py", """\
        import threading
        from multiprocessing import Process

        def start(fn):
            t = threading.Thread(target=fn, daemon=True)
            p = Process(target=fn)
            return t, p
        """),
    "l002_join_without_aliveness": ("foo.py", """\
        class Prefetcher:
            def close(self):
                self._thread.join(timeout=5.0)
        """),
    "l002_aliveness_clean": ("foo.py", """\
        class Prefetcher:
            def close(self):
                self._thread.join(timeout=5.0)
                if self._thread.is_alive():
                    print("producer still running")
        """),
    "l003_bare_acquire_release": ("foo.py", """\
        import threading

        _lock = threading.Lock()

        def f():
            _lock.acquire()
            try:
                pass
            finally:
                _lock.release()
        """),
    "l003_with_clean": ("foo.py", """\
        import threading

        _lock = threading.Lock()

        def f():
            with _lock:
                pass
        """),
    "l004_shm_without_finalizer": ("foo.py", """\
        from multiprocessing import shared_memory

        def build():
            return shared_memory.SharedMemory(create=True, size=64)
        """),
    "l004_finalizer_clean": ("foo.py", """\
        import weakref
        from multiprocessing import shared_memory

        def _unlink(name):
            pass

        def build():
            seg = shared_memory.SharedMemory(create=True, size=64)
            weakref.finalize(seg, _unlink, seg.name)
            return seg
        """),
    "o001_hot_path": ("train/trainer.py", """\
        import time

        def measure():
            t0 = time.time()
            return time.time() - t0
        """),
    "o001_telemetry_layer": ("obs/trace.py", "import time\nt = time.time()\n"),
    "o001_graph_service": ("graph/service/worker.py", "import time\nt = time.time()\n"),
    "o001_recall": ("core/recall.py", "import time\nt = time.time()\n"),
    "o001_silent_elsewhere": ("launch/report.py", """\
        import time

        def measure():
            return time.time()
        """),
    "o001_monotonic_clean": ("train/trainer.py", """\
        import time

        def measure():
            t0 = time.perf_counter_ns()
            deadline = time.monotonic() + 5.0
            return time.perf_counter_ns() - t0, deadline
        """),
    "mixed": ("sampling/pipeline.py", """\
        import threading
        import time
        import numpy as np

        class Producer:
            def start(self, seed, node):
                self.rng = np.random.default_rng(node)
                self.t = threading.Thread(target=self.run)
                self.t0 = time.time()
                np.random.seed(seed)

            def stop(self):
                self.t.join(timeout=1.0)
        """),
}


def _parity_rel(package: str, rel: str) -> str:
    return rel if rel.startswith("tests/") else f"src/{package}/{rel}"


@pytest.mark.parametrize("case", sorted(PARITY))
def test_copied_families_match_repro_lint(tmp_path, case):
    """D001-D003, L001-L004 and O001 give ``repro.lint``'s findings (rule,
    line, column, context) on the same snippet, its path moved from
    ``src/repro/`` to ``src/repro_torch/``."""
    from repro.lint import core as rcore

    rel, src = PARITY[case]
    got = {}
    for package, mod in (("repro", rcore), ("repro_torch", core)):
        root = tmp_path / package
        path = _parity_rel(package, rel)
        p = root / path
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
        rules = [r for r in mod.all_rules() if r.id in COPIED]
        got[package] = [(f.rule, f.line, f.col, f.context)
                        for f in mod.run_lint(root, paths=(path,), rules=rules)]
    assert got["repro_torch"] == got["repro"]
    if not case.endswith(("clean", "skipped_in_tests", "silent_elsewhere")):
        assert got["repro_torch"], case


# ------------------------------------------------------------- determinism
class TestTorchDeterminismRules:
    def test_d004_constant_manual_seed(self, tmp_path):
        src = """\
            import torch

            def init():
                torch.manual_seed(0)
                return torch.Generator().manual_seed(1)
            """
        got = lint_snippet(tmp_path, "src/repro_torch/foo.py", src)
        assert rule_ids(got) == ["D004", "D004"]
        assert [f.line for f in got] == [4, 5]
        assert lint_snippet(tmp_path, "tests/test_foo.py", src) == []

    def test_d004_derived_seed_clean(self, tmp_path):
        got = lint_snippet(tmp_path, "src/repro_torch/foo.py", """\
            import torch

            def init(cfg):
                return torch.Generator("cpu").manual_seed(cfg.seed + 1)
            """)
        assert got == []

    def test_d005_global_generator_draws(self, tmp_path):
        got = lint_snippet(tmp_path, "src/repro_torch/foo.py", """\
            import torch
            from torch import nn

            def init(w, n):
                a = torch.randn(3)
                b = torch.randint(0, 5, (2,))
                w.normal_(0.0, 0.02)
                nn.init.xavier_uniform_(w)
                return a, b, torch.randperm(n)
            """)
        assert rule_ids(got) == ["D005"] * 5
        assert "generator=" in got[0].hint

    def test_d005_explicit_generator_clean(self, tmp_path):
        src = """\
            import torch
            from torch import nn

            def init(gen, w):
                a = torch.randn(3, generator=gen)
                w.uniform_(-1, 1, generator=gen)
                nn.init.zeros_(w)
                return a, torch.multinomial(w.abs(), 2, generator=gen)
            """
        assert lint_snippet(tmp_path, "src/repro_torch/foo.py", src) == []
        # tests, and modules without torch, are outside the rule
        assert lint_snippet(tmp_path, "tests/test_foo.py",
                            "import torch\nx = torch.randn(3)\n") == []


# ---------------------------------------------------------------- host sync
_HOT_TORCH = """\
    import numpy as np
    import torch

    def step(loss, xs, flag, n):
        a = float(loss)
        b = loss.item()
        c = xs.tolist()
        d = xs.cpu().numpy()
        e = int(n) + bool(flag)
        torch.cuda.synchronize()
        return a, b, c, d, e, np.asarray(xs)
    """


class TestHostSyncRules:
    def test_hot_path_module_flagged(self, tmp_path):
        got = lint_snippet(tmp_path, "src/repro_torch/train/trainer.py", _HOT_TORCH)
        assert rule_ids(got) == ["H001"] * 9
        assert {f.line for f in got} == {5, 6, 7, 8, 9, 10, 11}

    @pytest.mark.parametrize("rel", ["src/repro_torch/retrieval/myindex.py",
                                     "src/repro_torch/infer/myserve.py",
                                     "src/repro_torch/sampling/fused.py",
                                     "src/repro_torch/graph/service/client.py"])
    def test_every_hot_glob(self, tmp_path, rel):
        assert rule_ids(lint_snippet(tmp_path, rel, _HOT_TORCH)) == ["H001"] * 9

    def test_cold_or_torch_free_modules_clean(self, tmp_path):
        assert lint_snippet(tmp_path, "src/repro_torch/models/foo.py", _HOT_TORCH) == []
        numpy_only = _HOT_TORCH.replace("import torch\n", "")
        numpy_only = numpy_only.replace("torch.cuda.synchronize()", "pass")
        assert lint_snippet(tmp_path, "src/repro_torch/graph/service/worker.py",
                            numpy_only) == []

    def test_host_evident_casts_and_drains_clean(self, tmp_path):
        got = lint_snippet(tmp_path, "src/repro_torch/retrieval/topk.py", """\
            import numpy as np
            import torch

            from repro_torch.lint.sanitizer import host_array, host_scalar

            LIMIT = np.iinfo(np.int32).max

            def plan(x, rows, k: int, budget: float, counts):
                width = max(1, int(len(rows)))
                bytes_ = int(sum(t.numel() * t.element_size() for t in rows))
                cap = int(np.ceil(budget * k / x.shape[0]))
                top = int(np.max(counts)) + int(LIMIT)
                got = host_array(x)
                return width, bytes_, cap, top, int(host_array(x).sum()), host_scalar(x), got
            """)
        assert got == []

    def test_h002_device_tensors_from_host_data(self, tmp_path):
        got = lint_snippet(tmp_path, "src/repro_torch/retrieval/ivf.py", """\
            import numpy as np
            import torch

            def upload(a, dev):
                x = torch.tensor(a, device=dev)
                y = torch.from_numpy(a).to(dev)
                z = torch.as_tensor(a, device="cuda")
                return x, y, z
            """)
        assert rule_ids(got) == ["H002"] * 3
        assert "to_device" in got[0].hint

    def test_h002_to_device_and_dtype_casts_clean(self, tmp_path):
        got = lint_snippet(tmp_path, "src/repro_torch/retrieval/ivf.py", """\
            import numpy as np
            import torch

            def to_device(a, device):
                return torch.from_numpy(np.ascontiguousarray(a)).to(device, non_blocking=True)

            def host(a):
                return torch.from_numpy(a).to(torch.float32), torch.tensor(a)
            """)
        assert got == []


# ------------------------------------------------------------------ kernels
_CU = """\
    #include <cuda_runtime.h>
    // a comment that names g4r_nothing(int) is not a prototype
    extern "C" int g4r_foo_f32(const float* x, float* out, int n, long long m,
                               float scale, void* stream) {
      return 0;
    }
    extern "C" int g4r_foo_attrs(int vec, int* out) { return 0; }
    """
_BUILD = """\
    import ctypes

    _P = ctypes.c_void_p
    _I = ctypes.c_int
    _LL = ctypes.c_longlong
    _F = ctypes.c_float
    _SIGNATURES = {
        "g4r_foo_f32": %s,
        "g4r_foo_attrs": (_I, _P),
    }
    """
_WRAPPER = """\
    from repro_torch.kernels import build

    def _launch(lib, x, out):
        return lib.g4r_foo_f32(x, out, 1, 1, 1.0, 0)

    def foo_cuda(x):
        return _launch(build.library(), x, x)
    """
_OPS = """\
    from repro_torch.kernels import ref
    from repro_torch.kernels.foo import foo_cuda

    def foo(x):
        if x.is_cuda:
            return foo_cuda(x)
        return ref.foo_ref(x)
    """
_REF = "def foo_ref(x):\n    return x\n"
_GOOD_SIG = "(_P, _P, _I, _LL, _F, _P)"


def _kernel_tree(sig=_GOOD_SIG, **over):
    files = {"src/repro_torch/kernels/csrc/foo.cu": _CU,
             "src/repro_torch/kernels/foo.py": _WRAPPER,
             "src/repro_torch/kernels/ops.py": _OPS,
             "src/repro_torch/kernels/ref.py": _REF}
    files.update(over)
    return {k: v for k, v in files.items() if v is not None}, textwrap.dedent(_BUILD) % sig


class TestKernelRules:
    def lint_build(self, tmp_path, sig=_GOOD_SIG, **over):
        extra, build = _kernel_tree(sig, **over)
        return lint_snippet(tmp_path, "src/repro_torch/kernels/build.py", build, extra)

    def test_whole_triad_and_matching_prototype_clean(self, tmp_path):
        assert self.lint_build(tmp_path) == []

    @pytest.mark.parametrize("part,what", [
        ("src/repro_torch/kernels/foo.py", "no wrapper"),
        ("src/repro_torch/kernels/ops.py", "no dispatcher"),
        ("src/repro_torch/kernels/ref.py", "no oracle"),
    ])
    def test_k001_triad_part_missing(self, tmp_path, part, what):
        got = self.lint_build(tmp_path, **{part: None})
        assert rule_ids(got) == ["K001"], got
        assert what in got[0].message and "g4r_foo_f32" in got[0].message

    def test_k001_diagnostics_need_no_triad(self):
        from repro_torch.lint.rules_kernels import is_diagnostic

        for name in ("g4r_foo_attrs", "g4r_flash_attn_bwd_plan", "g4r_flash_wgmma_probe",
                     "g4r_empty", "g4r_error_string"):
            assert is_diagnostic(name)
        assert not is_diagnostic("g4r_foo_f32")

    def test_k002_one_type_differs(self, tmp_path):
        got = self.lint_build(tmp_path, sig="(_P, _P, _I, _I, _F, _P)")
        assert rule_ids(got) == ["K002"]
        assert "argument 3 is int" in got[0].message and "long long" in got[0].message

    def test_k002_count_and_missing_prototype(self, tmp_path):
        got = self.lint_build(tmp_path, sig="(_P, _P, _I, _LL, _F)")
        assert rule_ids(got) == ["K002"] and "5 argument types" in got[0].message
        cu = _CU.replace("g4r_foo_attrs", "g4r_bar_attrs")
        got = self.lint_build(tmp_path, **{"src/repro_torch/kernels/csrc/foo.cu": cu})
        assert rule_ids(got) == ["K002"] and "g4r_foo_attrs" in got[0].message

    def test_k002_starred_runs_expand(self, tmp_path):
        assert self.lint_build(tmp_path, sig="(*(_P,) * 2, _I, _LL, _F, _P)") == []

    def test_k003_symbol_outside_kernels(self, tmp_path):
        src = """\
            from repro_torch.kernels import build

            def floor():
                return build.library().g4r_empty(1, 32, 0)
            """
        got = lint_snippet(tmp_path, "src/repro_torch/models/foo.py", src)
        assert rule_ids(got) == ["K003"]
        assert lint_snippet(tmp_path, "chip_smoke.py", src) != []
        assert lint_snippet(tmp_path, "tests/test_foo.py", src) == []
        assert lint_snippet(tmp_path, "src/repro_torch/kernels/foo.py", src) == []

    def test_the_ports_table_matches_its_sources(self):
        """Every _SIGNATURES entry of the real tree has its prototype."""
        from repro_torch.kernels import build
        from repro_torch.lint.rules_kernels import prototypes

        protos = prototypes(build.CSRC)
        assert set(build._SIGNATURES) <= set(protos)
        for name, argtypes in build._SIGNATURES.items():
            assert len(argtypes) == len(protos[name][1]), name


# ------------------------------------------------- suppression and baseline
class TestSuppressionAndBaseline:
    def test_inline_and_next_line_suppression(self, tmp_path):
        assert lint_snippet(tmp_path, "src/repro_torch/foo.py", """\
            import numpy as np
            rng = np.random.default_rng()  # repro_torch: lint-ignore[D001]
            # repro_torch: lint-ignore[D001]
            rng2 = np.random.default_rng()
            """) == []

    def test_suppression_is_rule_scoped_and_wildcard(self, tmp_path):
        got = lint_snippet(tmp_path, "src/repro_torch/foo.py", """\
            import numpy as np
            rng = np.random.default_rng()  # repro_torch: lint-ignore[D003]
            rng2 = np.random.default_rng()  # repro_torch: lint-ignore[*]
            """)
        assert rule_ids(got) == ["D001"] and got[0].line == 2

    def test_neither_linter_reads_the_others_tag(self, tmp_path):
        from repro.lint import core as rcore

        src = textwrap.dedent("""\
            import numpy as np
            a = np.random.default_rng()  # repro: lint-ignore[D001]
            b = np.random.default_rng()  # repro_torch: lint-ignore[D001]
            """)
        for package, mod, line in (("repro_torch", core, 2), ("repro", rcore, 3)):
            p = tmp_path / package / f"src/{package}/foo.py"
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_text(src)
            got = mod.run_lint(tmp_path / package, paths=(f"src/{package}/foo.py",))
            assert [(f.rule, f.line) for f in got] == [("D001", line)], package

    def test_baseline_masks_only_recorded_findings(self, tmp_path):
        rel = "src/repro_torch/foo.py"
        findings = lint_snippet(tmp_path, rel, """\
            import numpy as np
            rng = np.random.default_rng()
            """)
        bl_path = tmp_path / core.BASELINE_FILE
        write_baseline(bl_path, findings)
        assert new_findings(findings, load_baseline(bl_path)) == []
        moved = lint_snippet(tmp_path, rel, """\
            import numpy as np

            # an unrelated edit above the finding
            rng = np.random.default_rng()
            """)
        assert new_findings(moved, load_baseline(bl_path)) == []
        more = lint_snippet(tmp_path, rel, """\
            import numpy as np
            rng = np.random.default_rng()
            other = np.random.default_rng()
            """)
        assert rule_ids(new_findings(more, load_baseline(bl_path))) == ["D001"]

    def test_default_paths_take_globs(self, tmp_path):
        for rel in ("src/repro_torch/a.py", "tests/test_torch_b.py", "tests/test_c.py",
                    "examples/d_torch.py", "examples/e.py", "chip_smoke.py"):
            p = tmp_path / rel
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_text("import numpy as np\nrng = np.random.default_rng()\n")
        got = run_lint(tmp_path)
        assert sorted(f.path for f in got) == [
            "chip_smoke.py", "examples/d_torch.py", "src/repro_torch/a.py",
            "tests/test_torch_b.py"]


# ------------------------------------------------------------- repo status
class TestRepoIsClean:
    def test_no_findings_and_an_empty_baseline(self):
        assert load_baseline(REPO / core.BASELINE_FILE) == {}
        findings = run_lint(REPO)
        assert findings == [], "\n".join(f.render() for f in findings)

    def test_hot_path_and_kernel_modules_carry_no_suppression(self):
        guarded = core.HOT_PATH_GLOBS + (core.KERNEL_GLOB, "src/repro_torch/kernels/csrc/*")
        for g in guarded:
            for f in REPO.glob(g):
                assert "lint-ignore" not in f.read_text(), f"suppression in {f}"

    def test_cli_exits_zero(self):
        env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
        res = subprocess.run([sys.executable, "-m", "repro_torch.lint"], cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stdout + res.stderr
        assert "repro_torch.lint: 0 finding(s), 0 new" in res.stdout
        res = subprocess.run([sys.executable, "-m", "repro_torch.lint", "--list-rules"],
                             cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
        ids = [line.split()[0] for line in res.stdout.splitlines()]
        assert ids == ["D001", "D002", "D003", "D004", "D005", "H001", "H002", "K001",
                       "K002", "K003", "L001", "L002", "L003", "L004", "O001"]

    def test_static_pass_imports_no_torch_jax_or_repro(self, tmp_path):
        (tmp_path / "src" / "repro_torch").mkdir(parents=True)
        (tmp_path / "src" / "repro_torch" / "a.py").write_text("import torch\nx = 1\n")
        code = (
            "import sys\n"
            "import repro_torch.lint, repro_torch.lint.__main__ as m\n"
            f"assert m.main(['--root', {str(tmp_path)!r}, 'src/repro_torch']) == 0\n"
            "bad = sorted(n for n in sys.modules\n"
            "             if n.split('.')[0] in ('torch', 'jax', 'jaxlib', 'repro', 'numpy'))\n"
            "assert not bad, bad\n"
        )
        res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                             env=dict(os.environ, PYTHONPATH=str(REPO / "src")), timeout=120)
        assert res.returncode == 0, res.stdout + res.stderr


# ------------------------------------------------------- runtime sanitizer
class TestSanitizerOnTheCpu:
    def test_guard_is_a_noop(self):
        from repro_torch.lint.sanitizer import transfer_sanitizer

        x = torch.arange(4.0)
        for guard in (transfer_sanitizer(True, torch.device("cpu")), transfer_sanitizer(False),
                      transfer_sanitizer(True)):
            with guard:
                assert x.sum().item() == 6.0 and x[x > 1].numel() == 2

    def test_drains_equal_cpu_numpy(self):
        from repro_torch.lint.sanitizer import (device_barrier, host_array, host_floats,
                                                host_floats_async, host_scalar)

        x = torch.randn(5, 3, generator=torch.Generator().manual_seed(0))
        np.testing.assert_array_equal(host_array(x), x.cpu().numpy())
        assert host_array(x, dtype=np.float64).dtype == np.float64
        np.testing.assert_array_equal(host_array([1, 2]), np.array([1, 2]))
        assert host_scalar(x[0, 0]) == float(x[0, 0])
        losses = [x[i, 0] for i in range(5)]
        want = [float(v) for v in losses]
        assert host_floats(losses) == want
        pending = host_floats_async(losses)
        assert len(pending) == 5 and pending.resolve() == want
        assert host_floats([1.5, np.float32(2.0)]) == [1.5, 2.0]
        assert device_barrier(x) is x and device_barrier(device="cpu") is None


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sync debug mode watches CUDA work only")
    return torch.device("cuda")


@pytest.mark.cuda
def test_guard_raises_on_item_and_passes_the_drains(cuda):
    from repro_torch.lint.sanitizer import (host_array, host_floats, host_floats_async,
                                            host_scalar, transfer_sanitizer)

    x = torch.arange(1, 5, dtype=torch.float32, device=cuda)
    with pytest.raises(RuntimeError):
        with transfer_sanitizer(True):
            x.sum().item()
    with transfer_sanitizer(True):
        arr = host_array(x)
        s = host_scalar(x.sum())
        fl = host_floats([x[0], x[1]])
        later = host_floats_async([x[2], x[3]])
    np.testing.assert_array_equal(arr, [1, 2, 3, 4])
    assert (s, fl, later.resolve()) == (10.0, [1.0, 2.0], [3.0, 4.0])
