"""Figure 11: normalized L1/L2 accesses, IRU vs baseline (paper: 67%/56%)."""
from __future__ import annotations

from repro_torch.figures.common import all_cells, geomean, parse_args


def run(force: bool = False, *, engine: str = "hash", device=None):
    rows = []
    for cell in all_cells(force, engine=engine, device=device):
        r = cell["report"]
        rows.append({
            "algo": cell["algo"], "dataset": cell["dataset"],
            "l1_ratio": round(r["l1_ratio"], 3),
            "l2_ratio": round(r["l2_ratio"], 3),
        })
    rows.append({
        "algo": "MEAN", "dataset": "-",
        "l1_ratio": round(geomean([r["l1_ratio"] for r in rows]), 3),
        "l2_ratio": round(geomean([r["l2_ratio"] for r in rows]), 3),
    })
    return rows


def main(argv=None):
    a = parse_args(argv)
    print("algo,dataset,l1_ratio,l2_ratio")
    for r in run(a.force, engine=a.engine, device=a.device):
        print(f"{r['algo']},{r['dataset']},{r['l1_ratio']},{r['l2_ratio']}")


if __name__ == "__main__":
    main()
