"""Figure 14: memory requests per warp instruction (paper: ~4 baseline ->
~3 with IRU; 1.32x coalescing improvement).

The IRU traces behind these numbers run through the streaming reorder API
(``reorder_frontier`` with the paper's 1024x32 geometry and an 8k-element
lookahead window: kernel B3's windowed body on the card); ``quick`` caps
frontier sizes for CI runs.
"""
from __future__ import annotations

import numpy as np

from repro_torch.figures import common
from repro_torch.figures.common import all_cells, geomean, parse_args


def run(force: bool = False, quick: bool = False, *, engine: str = "hash",
        device=None):
    if quick:
        common.set_quick(True)
    rows = []
    for cell in all_cells(force, engine=engine, device=device):
        b = cell["baseline_accesses_per_warp"]
        i = cell["iru_accesses_per_warp"]
        rows.append({
            "algo": cell["algo"], "dataset": cell["dataset"],
            "baseline_acc_per_warp": round(b, 3),
            "iru_acc_per_warp": round(i, 3),
            "improvement": round(b / max(i, 1e-9), 3),
        })
    rows.append({
        "algo": "MEAN", "dataset": "-",
        "baseline_acc_per_warp": round(float(np.mean(
            [r["baseline_acc_per_warp"] for r in rows])), 3),
        "iru_acc_per_warp": round(float(np.mean(
            [r["iru_acc_per_warp"] for r in rows])), 3),
        "improvement": round(geomean([r["improvement"] for r in rows]), 3),
    })
    return rows


def main(argv=None):
    a = parse_args(argv)
    print("algo,dataset,baseline_acc_per_warp,iru_acc_per_warp,improvement")
    for r in run(a.force, engine=a.engine, device=a.device):
        print(f"{r['algo']},{r['dataset']},{r['baseline_acc_per_warp']},"
              f"{r['iru_acc_per_warp']},{r['improvement']}")


if __name__ == "__main__":
    main()
