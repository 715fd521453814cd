"""Figure 12: normalized SM<->MP interconnect traffic (paper mean: 54%)."""
from __future__ import annotations

from repro_torch.figures.common import all_cells, geomean, parse_args


def run(force: bool = False, *, engine: str = "hash", device=None):
    rows = []
    for cell in all_cells(force, engine=engine, device=device):
        rows.append({
            "algo": cell["algo"], "dataset": cell["dataset"],
            "noc_ratio": round(cell["report"]["noc_ratio"], 3),
        })
    rows.append({"algo": "MEAN", "dataset": "-",
                 "noc_ratio": round(geomean([r["noc_ratio"] for r in rows]),
                                    3)})
    return rows


def main(argv=None):
    a = parse_args(argv)
    print("algo,dataset,noc_ratio")
    for r in run(a.force, engine=a.engine, device=a.device):
        print(f"{r['algo']},{r['dataset']},{r['noc_ratio']}")


if __name__ == "__main__":
    main()
