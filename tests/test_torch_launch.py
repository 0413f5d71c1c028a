"""The port's launch tools (``repro_torch.launch``: dryrun, roofline, perf,
report, logparse, mesh; ``utils.log`` and ``utils.pytree``) and the abstract
arch specs, held against ``repro``'s.

Full size, all ten archs, on the meta device (nothing allocated): the
parameter and active counts equal ``repro``'s ``_count`` / ``_count_active``
over ``jax.eval_shape``; ``supports`` for every shape; the input shapes; the
decode caches' bytes. Reduced configs of every block kind dry-run on fake
tensors (the sandbox has no CUDA runtime, so ``trace_device`` is ``meta``)
with the flash attention's shape function taken and no launch attempted.
The counted FLOPs of a prefill equal a closed form. The flash custom op on
CPU tensors is bitwise the autograd function it replaced.

``repro.launch.dryrun`` and ``repro.launch.perf`` set ``XLA_FLAGS`` (512
host devices) when imported; they are imported with the variable restored
at once, so that JAX, if this process starts it later, keeps one device.
"""
import importlib
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs.registry import ARCH_IDS
from repro.configs.registry import get_arch as repro_arch
from repro.launch import logparse as repro_logparse
from repro.launch import report as repro_report
from repro.launch import roofline as repro_roofline
from repro_torch.configs.base import SHAPES, ShapeSpec
from repro_torch.configs.registry import get_arch
from repro_torch.kernels import flash_attn as fa_mod
from repro_torch.kernels import ops, ref
from repro_torch.launch import dryrun, logparse, perf, report, roofline
from repro_torch.launch.mesh import make_card_mesh, make_host_mesh
from repro_torch.utils import tree_num_params, tree_size_bytes

pytestmark = pytest.mark.quick

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _import_keeping_xla_flags(name):
    saved = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module(name)
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved


repro_dryrun = _import_keeping_xla_flags("repro.launch.dryrun")
repro_perf = _import_keeping_xla_flags("repro.launch.perf")


def _jax_bytes(tree) -> int:
    return int(sum(np.prod(l.shape) * np.dtype(l.dtype).itemsize
                   for l in jax.tree_util.tree_leaves(tree)))


# ------------------------------------------------------- full-size abstracts
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_counts_equal_repro(arch):
    """Parameter and active counts equal ``repro``'s exactly. The layouts
    differ (``repro`` stacks each layer kind on a leading axis per offset
    of the block pattern; the port holds one module per layer), which moves
    no count: each stacked leaf is the port's layers' leaves end to end."""
    rspec, spec = repro_arch(arch), get_arch(arch)
    aparams = rspec.abstract_params()
    model = spec.abstract_params()
    assert all(p.device.type == "meta" for p in model.parameters())
    assert tree_num_params(model) == repro_dryrun._count(aparams)
    assert dryrun.count_active(spec, model) == repro_dryrun._count_active(rspec, aparams)
    assert tree_size_bytes(model) == _jax_bytes(aparams)
    assert (spec.depth_reps, spec.period_layers) == (rspec.depth_reps, rspec.period_layers)
    assert spec.unrolled() is spec


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_supports_inputs_and_caches_equal_repro(arch):
    """``supports`` for every shape; ``input_specs`` shapes (token ids int64
    in the port, whose embeddings and launchers take int64; int32 in
    ``repro``), other dtypes equal; the decode caches' bytes, less
    ``repro``'s 4-byte int32 position ``t``, which the port keeps as a host
    int."""
    rspec, spec = repro_arch(arch), get_arch(arch)
    for shape in SHAPES:
        assert spec.supports(shape) == rspec.supports(shape)
        ok, _ = spec.supports(shape)
        if not ok:
            continue
        want = rspec.input_specs(shape)
        got = spec.input_specs(shape)
        assert list(got) == list(want)
        for name, t in got.items():
            assert tuple(t.shape) == tuple(want[name].shape), name
            assert t.device.type == "meta"
            if want[name].dtype == np.int32:
                assert t.dtype == torch.int64
            else:
                assert str(t.dtype)[6:] == str(want[name].dtype)
        if SHAPES[shape].kind == "decode":
            cache = spec.abstract_cache(shape)
            assert tree_size_bytes(cache) == _jax_bytes(rspec.abstract_cache(shape)) - 4
            assert cache["t"] == 0


# ----------------------------------------------------------- reduced traces
KINDS = ["smollm-135m", "olmoe-1b-7b", "mamba2-1.3b", "jamba-v0.1-52b", "qwen2-vl-7b",
         "whisper-tiny"]
# the dry run's steps at a size whose trace is short: the chunked SSD is a
# Python loop over chunks, so a short sequence keeps the Mamba2 trace small
SMALL = {"train": ShapeSpec("train_s", 128, 4, "train"),
         "prefill": ShapeSpec("prefill_s", 128, 2, "prefill"),
         "decode": ShapeSpec("decode_s", 256, 4, "decode")}


def test_reduced_dry_run_every_kind_takes_the_fake_route(monkeypatch):
    """Every block kind's reduced config, train / prefill / decode, through
    the dry run's own step on fake tensors: status ok, the flash attention's
    custom ops counted (forward with LSE twice a layer under remat, its
    backward once; the prefill's forward once), and no launch attempted."""
    def no_launch(*a, **k):
        raise AssertionError("a fake trace launched a kernel")

    monkeypatch.setattr(ops, "flash_attention_cuda", no_launch)
    monkeypatch.setattr(ops, "flash_attention_bwd_cuda", no_launch)
    fa_mod.launches = fa_mod.bwd_launches = 0
    mesh = make_card_mesh()
    assert (mesh.name, mesh.size, make_host_mesh().axis_sizes()) == (
        "1xH100", 1, {"data": 1, "model": 1})
    for arch in KINDS:
        spec = get_arch(arch, reduced=True)
        n_attn = (2 * spec.whisper.n_layers if spec.kind == "whisper"
                  else sum(m == "attn" for m, _ in spec.lm.block_list()))
        remat = spec.whisper.remat if spec.kind == "whisper" else spec.lm.remat
        for kind, shape in SMALL.items():
            res = dryrun._fake_step(spec, shape)
            row = dryrun.row_of(spec, arch, shape, res, 0.0, 1.0, 1.0, mesh.name, mesh.size)
            assert row["status"] == "ok" and row["flops_per_device"] > 0, (arch, kind)
            calls = row["flash_calls"]
            if kind == "train":
                assert calls == ({"g4r.flash_attention_lse": n_attn * (1 + remat),
                                  "g4r.flash_attention_bwd": n_attn} if n_attn else {})
            elif kind == "prefill":
                assert calls == ({"g4r.flash_attention": n_attn} if n_attn else {})
            else:
                assert calls == {}
            assert row["memory"]["peak_bytes"] >= row["memory"]["argument_bytes"] > 0
    assert fa_mod.launches == fa_mod.bwd_launches == 0


@pytest.mark.parametrize("arch,shape", [("smollm-135m", "train_4k"),
                                        ("whisper-tiny", "decode_32k"),
                                        ("mamba2-1.3b", "long_500k"),
                                        ("qwen2-0.5b", "long_500k")])
def test_run_one_rows(arch, shape):
    """``run_one`` on ``repro``'s shapes of reduced configs: the row schema
    (``repro``'s keys plus the port's), ``skipped`` where ``supports`` says
    so, and the terms from the H100 constants."""
    row = dryrun.run_one(arch, shape, reduced=True)
    if not get_arch(arch).supports(shape)[0]:
        assert row["status"] == "skipped"
        return
    assert row["status"] == "ok", row.get("error")
    for key in ("chips", "kind", "compile_s", "memory", "n_params", "n_params_active",
                "flops_per_device", "bytes_per_device", "collective_bytes_per_device",
                "collective_breakdown", "raw_scan_counts", "compute_s", "memory_s",
                "collective_s", "dominant", "model_flops", "useful_ratio", "fits_one_card",
                "traced_dtype", "traced_device"):
        assert key in row, key
    tc, f32 = row["tensor_core_flops"], row["other_flops"]
    assert tc + f32 == row["flops_per_device"]
    assert row["compute_s"] == pytest.approx(tc / 989e12 + f32 / 67e12, rel=1e-12)
    assert row["memory_s"] == pytest.approx(row["bytes_per_device"] / 3.35e12, rel=1e-12)
    assert row["collective_s"] == 0.0 and row["mesh"] == "1xH100"
    assert "nothing was measured" in row["counted_on"]


def test_prefill_flops_closed_form():
    """The counted FLOPs of the reduced smollm's prefill: 2 x the matmul
    parameters x tokens (q, k, v, o and the SwiGLU's three), the tied head
    on the last position of each row, and 4 hd FLOPs a (query, key) pair
    of the causal band in each head."""
    spec = get_arch("smollm-135m", reduced=True)
    cfg = spec.lm
    B, S = 3, 96
    res = dryrun._fake_step(spec, ShapeSpec("p", S, B, "prefill"))
    d, H, K, hd, f = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim, cfg.d_ff
    per_layer = d * H * hd + 2 * d * K * hd + H * hd * d + 3 * d * f
    band = S * (S + 1) // 2
    want = (2 * per_layer * B * S * cfg.n_layers + 2 * d * cfg.vocab_padded * B
            + 4 * hd * B * H * band * cfg.n_layers)
    assert res["counter"].total_flops == want
    assert fa_mod.band_pairs(S, S, True, None) == band
    assert fa_mod.band_pairs(S, S, True, 8) == sum(min(i + 1, 8) for i in range(S))
    assert fa_mod.band_pairs(5, 7, False, None) == 35


def test_counter_matches_flop_counter_mode_on_cpu():
    """On real CPU tensors the step counter's FLOPs equal
    ``FlopCounterMode``'s (its formulas, the flash ops' included), and its
    peak live bytes cover the arguments."""
    from torch.utils.flop_counter import FlopCounterMode

    spec = get_arch("qwen2-0.5b", reduced=True)
    model = spec.init_params(torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, spec.lm.vocab, (2, 64), generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tokens, "labels": tokens}
    res = dryrun.count_step(spec, ShapeSpec("t", 64, 2, "train"), model, batch)
    fc = FlopCounterMode(display=False)
    model2 = spec.init_params(torch.Generator().manual_seed(0), device="cpu")
    with fc:
        dryrun.count_step(spec, ShapeSpec("t", 64, 2, "train"), model2, batch)
    assert res["counter"].total_flops == fc.get_total_flops()
    c = res["counter"]
    assert c.calls["g4r.flash_attention_bwd"] == spec.lm.n_layers
    assert c.peak_bytes >= res["arg_bytes"] > 0 and c.bytes_accessed > 0


# ---------------------------------------------------------- flash on the CPU
class _TodaysFlash(torch.autograd.Function):
    """The autograd function the custom op replaced, as it ran on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        if not any(ctx.needs_input_grad[:3]):
            return ref.attention_ref(q, k, v, causal, window)
        out, lse = ref.attention_fwd_ref(q, k, v, causal, window)
        ctx.causal, ctx.window = causal, window
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        return (*ref.attention_bwd_ref(q, k, v, out, lse, g, ctx.causal, ctx.window), None,
                None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 7), (False, None)])
def test_flash_custom_op_bitwise_todays_path_on_cpu(dtype, causal, window):
    rng = np.random.default_rng(3)
    B, Sq, H, K, hd = 2, 33, 6, 2, 32
    q0, k0, v0 = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dtype)
                  for s in ((B, Sq, H, hd), (B, Sq, K, hd), (B, Sq, K, hd)))
    g = torch.from_numpy(rng.standard_normal((B, Sq, H, hd)).astype(np.float32)).to(dtype)

    def run(fn):
        q, k, v = (t.clone().requires_grad_() for t in (q0, k0, v0))
        out = fn(q, k, v, causal, window)
        out.backward(g)
        with torch.no_grad():
            nograd = fn(q0, k0, v0, causal, window)
        return out.detach(), q.grad, k.grad, v.grad, nograd

    want = run(_TodaysFlash.apply)
    for _ in range(2):  # and re-runs bitwise
        got = run(ops.flash_attention)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_flash_fake_route_shapes_and_checks():
    with FakeTensorMode():
        q = torch.empty((2, 16, 6, 32), device="meta")
        k = torch.empty((2, 16, 2, 32), device="meta")
        out = ops.flash_attention(q, k, k)
        o, lse = torch.ops.g4r.flash_attention_lse(q, k, k, True, None)
        dq, dk, dv = ops.flash_attention_bwd(q, k, k, o, lse, o)
    assert tuple(out.shape) == (2, 16, 6, 32) and tuple(lse.shape) == (2, 6, 16)
    assert lse.dtype == torch.float32 and tuple(dk.shape) == tuple(k.shape)
    with pytest.raises(ValueError, match="device"):  # a plain meta tensor: as before
        ops.flash_attention(torch.empty((1, 4, 2, 32), device="meta"),
                            torch.empty((1, 4, 1, 32), device="meta"),
                            torch.empty((1, 4, 1, 32), device="meta"))


# ----------------------------------------------------------- pure functions
def test_pure_functions_equal_repro():
    for args in ((1e9, 2e8, 4096, "train"), (7e9, 7e9, 1, "fwd"), (1.0, 0.5, 3.0, "x")):
        assert roofline.model_flops_estimate(*args) == repro_roofline.model_flops_estimate(*args)
    for x in (0, 1e-7, 3.2e-4, 1e-3, 0.5, 1.0, 12.3456):
        assert report.fmt_s(x) == repro_report.fmt_s(x)
    for x in (0, 999, 1e3, 2.5e6, 3e9, 7.7e12):
        assert report.fmt_b(x) == repro_report.fmt_b(x)
    assert set(f.name for f in __import__("dataclasses").fields(roofline.Roofline)) == set(
        f.name for f in __import__("dataclasses").fields(repro_roofline.Roofline))
    assert roofline.dominant(1.0, 2.0, 0.5) == "memory"
    assert roofline.useful_ratio(6.0, 3.0, 2) == 1.0 and roofline.useful_ratio(1.0, 0.0, 1) == 0


def _rows():
    ok = {"arch": "smollm-135m", "shape": "train_4k", "mesh": "1xH100", "status": "ok",
          "compile_s": 1.5, "memory": {"total_gb": 3.25, "argument_bytes": 10**9,
                                       "temp_bytes": 2 * 10**9, "output_bytes": 0,
                                       "peak_bytes": 3.25e9},
          "compute_s": 0.0123, "memory_s": 4.5e-4, "collective_s": 0.0, "dominant": "compute",
          "model_flops": 1.2e15, "useful_ratio": 0.73, "flops_per_device": 2.2e15,
          "collective_bytes_per_device": 0.0, "fits_one_card": True,
          "traced_dtype": "bfloat16"}
    mem = dict(ok, shape="decode_32k", dominant="memory", compute_s=2e-6, memory_s=0.3)
    skip = {"arch": "smollm-135m", "shape": "long_500k", "mesh": "1xH100", "status": "skipped",
            "reason": "full-attention arch: long_500k skipped (see DESIGN.md)"}
    err = {"arch": "qwen2-0.5b", "shape": "prefill_32k", "mesh": "1xH100", "status": "error",
           "error": "RuntimeError: boom"}
    return [ok, mem, skip, err]


def _drop_hints(table: str) -> list:
    return ["|".join(line.split("|")[:-2]) for line in table.splitlines()]


def test_report_tables_equal_repro_outside_the_hints():
    rows = _rows()
    assert report.dryrun_table(rows) == repro_report.dryrun_table(rows)
    assert _drop_hints(report.roofline_table(rows)) == _drop_hints(
        repro_report.roofline_table(rows))
    assert "MXU" not in report.roofline_table(rows) and "tensor-core" in report.roofline_table(
        rows)
    assert "| yes | compute | bfloat16 |" in report.card_table(rows)


def test_logparse_round_trips_a_dry_run_line(tmp_path, caplog):
    """A row's log line from ``run_one`` rebuilt by ``logparse`` with the
    H100 constants; ``repro``'s parser reads the same line."""
    import logging

    with caplog.at_level(logging.INFO, logger="repro_torch.dryrun"):
        row = dryrun.run_one("qwen2-0.5b", "prefill_32k", reduced=True)
    line = next(r.getMessage() for r in caplog.records if r.getMessage().startswith("OK "))
    path = tmp_path / "sweep.log"
    path.write_text("12:00:00 INFO repro_torch.dryrun | " + line + "\n")
    (got,) = logparse.parse(str(path))
    (theirs,) = repro_logparse.parse(str(path))
    for key in ("arch", "shape", "mesh", "dominant"):
        assert got[key] == row[key] == theirs[key]
    assert got["chips"] == 1 and got["compute_s"] == pytest.approx(row["compute_s"], rel=1e-2)
    assert got["flops_per_device"] == pytest.approx(row["compute_s"] * 989e12, rel=1e-2)
    assert got["bytes_per_device"] == pytest.approx(row["bytes_per_device"], rel=1e-2)
    out = tmp_path / "rows.json"
    sys.argv, saved = ["logparse", str(path), str(out)], sys.argv
    try:
        logparse.main()
    finally:
        sys.argv = saved
    assert json.loads(out.read_text())[0]["reconstructed_from_log"] is True


# --------------------------------------------------------------------- perf
def test_perf_variants_equal_repro():
    assert perf.VARIANTS == repro_perf.VARIANTS
    rspec, spec = repro_arch("qwen2-0.5b"), get_arch("qwen2-0.5b")
    for name, over in perf.VARIANTS.items():
        a, b = perf.apply_variant(spec, over), repro_perf.apply_variant(rspec, over)
        assert a.microbatches == b.microbatches
        for field in ("gather_head", "block_q", "remat_policy", "shard_cache_seq", "pad_heads"):
            assert getattr(a.lm, field) == getattr(b.lm, field), (name, field)


@pytest.mark.parametrize("shape", ["prefill_32k", "train_4k"])
def test_perf_knobs_that_select_nothing_give_baseline_rows(shape):
    keys = ("flops_per_device", "bytes_per_device", "memory", "flash_calls")
    spec = get_arch("qwen2-0.5b", reduced=True)
    rows = {n: dryrun.run_one("qwen2-0.5b", shape, spec=perf.apply_variant(spec, perf.VARIANTS[n]))
            for n in ("baseline", "block_q_512", "gather_head", "remat_dots", "cache_seq",
                      "pad_heads", "mb_2")}
    for n in ("block_q_512", "gather_head", "remat_dots", "cache_seq"):
        assert all(rows[n][k] == rows["baseline"][k] for k in keys), n
    assert rows["pad_heads"]["flops_per_device"] > rows["baseline"]["flops_per_device"]
    if shape == "train_4k":  # gradient accumulation: two half batches, summed
        assert rows["mb_2"]["flash_calls"]["g4r.flash_attention_bwd"] == 2 * rows[
            "baseline"]["flash_calls"]["g4r.flash_attention_bwd"]


# ------------------------------------------------------------------ the CLI
def test_dryrun_cli_writes_rows(tmp_path):
    out = tmp_path / "dr.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), REPRO_LOG_LEVEL="WARNING")
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                          "whisper-tiny", "--shape", "prefill_32k,long_500k", "--reduced",
                          "--no-probes", "--out", str(out)],
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "nothing was measured" in res.stdout and "1 ok, 1 skipped, 0 errors" in res.stdout
    rows = {r["shape"]: r for r in json.loads(out.read_text())}
    assert rows["long_500k"]["status"] == "skipped" and rows["prefill_32k"]["status"] == "ok"


def test_get_logger_honours_repro_log_level():
    code = ("import logging\nfrom repro_torch.utils import get_logger\n"
            "log = get_logger('x')\nprint(logging.getLogger().level)\n")
    for level, want in (("DEBUG", logging_level("DEBUG")), ("error", logging_level("ERROR")),
                        ("nonsense", logging_level("INFO"))):
        env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), REPRO_LOG_LEVEL=level)
        res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                             text=True, timeout=120)
        assert res.returncode == 0, res.stderr
        assert int(res.stdout.strip()) == want


def logging_level(name: str) -> int:
    import logging

    return getattr(logging, name)

