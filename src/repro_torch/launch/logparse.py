"""Rebuild dry-run JSON rows from its log lines (a sweep cut short): a copy
of ``repro/launch/logparse.py`` that rebuilds FLOPs and bytes with the H100
figures of ``launch/roofline.py``.

The dry run writes its JSON at the end; the per-row log lines carry every
roofline field it prints. The compute term is rebuilt as bf16 FLOPs (the
log line does not split it by dtype); the chips come from the mesh's name
(``1xH100``, ``16x16``, ``2x16x16``), and a pod mesh's collective term is
rebuilt over the network link (every pod group spans nodes).
"""
from __future__ import annotations

import json
import math
import re
import sys
from typing import Dict, List

from repro_torch.launch.roofline import BF16_FLOPS, HBM_BW, LINK_BW, NET_BW

LINE = re.compile(
    r"OK (\S+)\s+(\S+)\s+(\S+)\s+compile=\s*([\d.]+)s mem=\s*([\d.]+)GB "
    r"comp=([\d.e+-]+)s mem=([\d.e+-]+)s coll=([\d.e+-]+)s dom=(\S+)\s+useful=([\d.]+)"
)

def parse(path: str) -> List[Dict]:
    rows = []
    with open(path) as f:
        for line in f:
            m = LINE.search(line)
            if not m:
                continue
            arch, shape, mesh, comp_s, mem_gb, c, b, co, dom, useful = m.groups()
            compute_s, memory_s, collective_s = float(c), float(b), float(co)
            pod = mesh != "1xH100"
            chips = math.prod(int(n) for n in mesh.split("x")) if pod else 1
            rows.append({
                "arch": arch, "shape": shape, "mesh": mesh, "status": "ok",
                "chips": chips, "compile_s": float(comp_s),
                "memory": {"total_gb": float(mem_gb), "argument_bytes": 0,
                           "temp_bytes": int(float(mem_gb) * 1e9), "output_bytes": 0},
                "compute_s": compute_s, "memory_s": memory_s,
                "collective_s": collective_s, "dominant": dom,
                "useful_ratio": float(useful),
                "flops_per_device": compute_s * BF16_FLOPS,
                "bytes_per_device": memory_s * HBM_BW,
                "collective_bytes_per_device": collective_s * (NET_BW if pod else LINK_BW),
                "model_flops": float(useful) * compute_s * BF16_FLOPS * chips,
                "reconstructed_from_log": True,
            })
    return rows


def main() -> None:
    log_path, out_path = sys.argv[1], sys.argv[2]
    rows = parse(log_path)
    existing = {}
    try:
        with open(out_path) as f:
            for r in json.load(f):
                existing[(r["arch"], r["shape"], r["mesh"])] = r
    except FileNotFoundError:
        pass
    for r in rows:
        existing.setdefault((r["arch"], r["shape"], r["mesh"]), r)
    with open(out_path, "w") as f:
        json.dump(list(existing.values()), f, indent=1)
    print(f"{len(rows)} parsed; {len(existing)} total -> {out_path}")


if __name__ == "__main__":
    main()
