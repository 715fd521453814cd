"""Figure 15: fraction of elements filtered/merged by the IRU (paper
average: 48.5% over SSSP + PR).

Filtering happens inside the streaming reorder (``reorder_frontier``): the
merge datapath only coalesces duplicates that meet within one lookahead
window, so these fractions are window-bounded like the hardware's.
``quick`` caps frontier sizes for CI runs.
"""
from __future__ import annotations

import numpy as np

from repro_torch.figures import common
from repro_torch.figures.common import DATASET_KW, parse_args, run_pair


def run(force: bool = False, quick: bool = False, *, engine: str = "hash",
        device=None):
    if quick:
        common.set_quick(True)
    rows = []
    for algo in ("sssp", "pr"):        # filtering applies to SSSP + PR (§6.2)
        for ds in DATASET_KW:
            cell = run_pair(algo, ds, force=force, engine=engine,
                            device=device)
            rows.append({"algo": algo, "dataset": ds,
                         "filtered_frac": round(cell.get("filtered_frac",
                                                         0.0), 3)})
    rows.append({"algo": "MEAN", "dataset": "-",
                 "filtered_frac": round(float(np.mean(
                     [r["filtered_frac"] for r in rows])), 3)})
    return rows


def main(argv=None):
    a = parse_args(argv)
    print("algo,dataset,filtered_frac")
    for r in run(a.force, engine=a.engine, device=a.device):
        print(f"{r['algo']},{r['dataset']},{r['filtered_frac']}")


if __name__ == "__main__":
    main()
