"""Figure 13: speedup + energy, IRU vs baseline (paper: 1.33x, -13%;
per-algo speedups BFS 1.16x / SSSP 1.14x / PR 1.40x), in the cost model's
GTX 980 cycles and picojoules."""
from __future__ import annotations

from repro_torch.figures.common import ALGOS, all_cells, geomean, parse_args


def run(force: bool = False, *, engine: str = "hash", device=None):
    rows = []
    for cell in all_cells(force, engine=engine, device=device):
        r = cell["report"]
        rows.append({
            "algo": cell["algo"], "dataset": cell["dataset"],
            "speedup": round(r["speedup"], 3),
            "energy_ratio": round(r["energy_ratio"], 3),
        })
    for algo in ALGOS:
        sub = [r for r in rows if r["algo"] == algo]
        rows.append({"algo": f"MEAN-{algo}", "dataset": "-",
                     "speedup": round(geomean([r["speedup"] for r in sub]), 3),
                     "energy_ratio": round(geomean(
                         [r["energy_ratio"] for r in sub]), 3)})
    base = [r for r in rows if not r["algo"].startswith("MEAN")]
    rows.append({"algo": "MEAN", "dataset": "-",
                 "speedup": round(geomean([r["speedup"] for r in base]), 3),
                 "energy_ratio": round(geomean(
                     [r["energy_ratio"] for r in base]), 3)})
    return rows


def main(argv=None):
    a = parse_args(argv)
    print("algo,dataset,speedup,energy_ratio")
    for r in run(a.force, engine=a.engine, device=a.device):
        print(f"{r['algo']},{r['dataset']},{r['speedup']},{r['energy_ratio']}")


if __name__ == "__main__":
    main()
