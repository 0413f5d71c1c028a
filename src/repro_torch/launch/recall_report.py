"""Render eval_torch JSON results as the paper-style comparison table.

A copy of ``repro.launch.recall_report`` (stdlib only): the same markdown
for the same records, so a sweep of either package renders alike.

Graph4Rec's experimental story (§4.2, Tables 2-4) is a systematic model ×
dataset × recall-strategy comparison. ``examples/eval_torch.py`` writes one
JSON record per scenario; this module turns that list into a markdown
report: one table per dataset, one row per model, Recall/Hit/NDCG columns
per strategy, plus a serving-throughput appendix (embed + retrieval time).

    PYTHONPATH=src python -m repro_torch.launch.recall_report results.json > REPORT.md
"""
from __future__ import annotations

import json
import sys
from typing import Dict, List

METRICS = ("", "_hit", "_ndcg")
METRIC_NAMES = ("R", "Hit", "NDCG")


def _fmt(x: float) -> str:
    return f"{x:.4f}"


def render_recall_report(results: List[Dict]) -> str:
    """``results``: records with keys dataset, model, method, top_k,
    metrics (flat strategy dict), num_users, num_items, embed_s, eval_s."""
    out: List[str] = ["# Recall evaluation report", ""]
    datasets = sorted({r["dataset"] for r in results})
    for ds_name in datasets:
        rows = [r for r in results if r["dataset"] == ds_name]
        strategies = sorted(
            {k for r in rows for k in r["metrics"] if "_" not in k}
        )
        r0 = rows[0]
        out.append(
            f"## {ds_name} ({r0['num_users']} users, {r0['num_items']} items, "
            f"@K={r0['top_k']})"
        )
        out.append("")
        header = ["model", "method"]
        for s in strategies:
            header += [f"{s} {m}" for m in METRIC_NAMES]
        header += ["embed s", "eval s"]
        out.append("| " + " | ".join(header) + " |")
        out.append("|" + "---|" * len(header))
        for r in sorted(rows, key=lambda r: (r["model"], r["method"])):
            cells = [r["model"], r["method"]]
            for s in strategies:
                cells += [_fmt(r["metrics"].get(s + m, 0.0)) for m in METRICS]
            cells += [f"{r['embed_s']:.2f}", f"{r['eval_s']:.2f}"]
            out.append("| " + " | ".join(cells) + " |")
        out.append("")
    return "\n".join(out)


def main(argv: List[str]) -> None:
    with open(argv[0]) as f:
        payload = json.load(f)
    print(render_recall_report(payload["results"]))


if __name__ == "__main__":
    main(sys.argv[1:])
