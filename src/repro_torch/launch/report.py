"""Render the dry run's JSON rows as markdown tables: a copy of
``repro/launch/report.py`` whose hints speak of the H100, with a table of
the one-card rows (compute, memory, peak, fits, dominant) and one of the
pod-mesh rows (per device: dominant term, peak, the collective term's share
and its wire bytes by kind).

    PYTHONPATH=src python -m repro_torch.launch.report build/dryrun/dryrun.json
"""
from __future__ import annotations

import json
import sys
from typing import Dict, List

ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]

HINTS = {
    ("compute",): "larger per-card batch or fused kernels (tensor-core use)",
    ("memory",): "flash/fused attention (cut S² HBM traffic), bf16 end-to-end",
    ("collective",): "overlap weight-gathers with compute; reduce "
                     "context-parallel AR via ring attention",
}


def fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x * 1e6:.1f}µs"
    if x < 1:
        return f"{x * 1e3:.2f}ms"
    return f"{x:.2f}s"


def fmt_b(x: float) -> str:
    if x >= 1e12:
        return f"{x / 1e12:.2f}TB"
    if x >= 1e9:
        return f"{x / 1e9:.2f}GB"
    if x >= 1e6:
        return f"{x / 1e6:.1f}MB"
    return f"{x / 1e3:.0f}KB"


def _sorted(rows: List[Dict]) -> List[Dict]:
    return sorted(rows, key=lambda r: (r["arch"], ORDER.index(r["shape"])))


def roofline_table(rows: List[Dict]) -> str:
    out = [
        "| arch | shape | mem/dev | compute | memory | collective | dominant"
        " | MODEL_FLOPS | useful | what moves the dominant term |",
        "|---|---|---|---|---|---|---|---|---|---|"[:-4] + "|",
    ]
    for r in _sorted(rows):
        if r["status"] == "skipped":
            out.append(f"| {r['arch']} | {r['shape']} | — | — | — | — | skipped |"
                       f" — | — | {r['reason'][:48]} |")
            continue
        if r["status"] != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | ERROR {r['error'][:60]} |")
            continue
        hint = HINTS[(r["dominant"],)]
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['memory']['total_gb']:.2f}GB "
            f"| {fmt_s(r['compute_s'])} | {fmt_s(r['memory_s'])} "
            f"| {fmt_s(r['collective_s'])} | **{r['dominant']}** "
            f"| {r['model_flops']:.2e} | {r['useful_ratio']:.2f} | {hint} |"
        )
    return "\n".join(out)


def dryrun_table(rows: List[Dict]) -> str:
    out = [
        "| arch | shape | mesh | status | compile | bytes/dev | FLOPs/dev |"
        " collective bytes/dev |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in _sorted(rows):
        if r["status"] == "skipped":
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | skipped "
                       f"({r['reason'][:40]}…) | — | — | — | — |")
        elif r["status"] == "ok":
            mem = r['memory']['argument_bytes'] + r['memory']['temp_bytes']
            out.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok "
                f"| {r['compile_s']:.1f}s | {fmt_b(mem)} "
                f"| {r.get('flops_per_device', 0):.2e} "
                f"| {fmt_b(r.get('collective_bytes_per_device', 0))} |"
            )
        else:
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | ERROR |"
                       f" {r['error'][:70]} | | | |")
    return "\n".join(out)


def card_table(rows: List[Dict]) -> str:
    """The one-card rows: compute, memory, peak live bytes, whether the peak
    fits the card's 80 GB, the dominant term and the traced dtype."""
    out = ["| arch | shape | compute | memory | peak | fits one card | dominant | traced |",
           "|---|---|---|---|---|---|---|---|"]
    for r in _sorted(rows):
        if r["status"] != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | — | — | — | — | {r['status']} "
                       "| — |")
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(r['compute_s'])} | {fmt_s(r['memory_s'])} "
            f"| {fmt_b(r['memory']['peak_bytes'])} | {'yes' if r['fits_one_card'] else 'no'} "
            f"| {r['dominant']} | {r['traced_dtype']} |")
    return "\n".join(out)


def _gb(x: float) -> str:
    return f"{x / 1e9:.3g}"


def pod_table(rows: List[Dict]) -> str:
    """The 16 x 16 and 2 x 16 x 16 rows, per device: the dominant term, peak
    live GB (✗ over one card's 80 GB), the collective term's share of the
    three terms' sum and its wire GB by kind (all-gather, reduce-scatter,
    all-reduce, all-to-all)."""
    kinds = (("all-gather", "AG"), ("reduce-scatter", "RS"), ("all-reduce", "AR"),
             ("all-to-all", "A2A"))
    out = ["| arch | shape | mesh | dominant | peak GB | collective share | wire GB by kind |",
           "|---|---|---|---|---|---|---|"]
    pods = [r for r in rows if r["mesh"] in ("16x16", "2x16x16")]
    for r in sorted(pods, key=lambda r: (r["arch"], ORDER.index(r["shape"]), r["mesh"])):
        if r["status"] != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['status']} | — | — | — |")
            continue
        terms = r["compute_s"] + r["memory_s"] + r["collective_s"]
        br = r["collective_breakdown"]
        wire = " ".join(f"{k} {_gb(br[n])}" for n, k in kinds if br.get(n))
        fits = "" if r["fits_one_card"] else " ✗"
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['dominant']} "
            f"| {_gb(r['memory']['peak_bytes'])}{fits} | {r['collective_s'] / terms:.2f} "
            f"| {wire or '—'} |")
    return "\n".join(out)


def main() -> None:
    with open(sys.argv[1]) as f:
        rows = json.load(f)
    print("## Roofline (one H100)\n")
    print(roofline_table(rows))
    print("\n## One card: peak and fit\n")
    print(card_table(rows))
    print("\n## Dry-run matrix\n")
    print(dryrun_table(rows))
    if any(r["mesh"] in ("16x16", "2x16x16") for r in rows):
        print("\n## Pod meshes, per device\n")
        print(pod_table(rows))


if __name__ == "__main__":
    main()
