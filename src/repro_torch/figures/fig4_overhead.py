"""Figure 4 analogue: the IRU service overhead vs its downstream win.

The paper's Fig. 4 splits warp execution into 'until the IRU-serviced load
returns' (the overhead) and 'service to completion' (where coalescing pays
off).  Cost-model analogue: cycles attributed to IRU element processing vs
total cycles, against the baseline's total -- the overhead must be more
than offset (IRU total < baseline total) for the mechanism to win.
"""
from __future__ import annotations

from repro_torch.core.costmodel import GPUConfig, TrafficCounts, cycles
from repro_torch.figures.common import all_cells, geomean, parse_args


def run(force: bool = False, *, engine: str = "hash", device=None):
    gpu = GPUConfig()
    rows = []
    for cell in all_cells(force, engine=engine, device=device):
        base = cycles(TrafficCounts(**cell["baseline"]), gpu)
        iru_counts = TrafficCounts(**cell["iru"])
        iru_total = cycles(iru_counts, gpu)
        service = gpu.cyc_iru_element * iru_counts.iru_elements
        rows.append({
            "algo": cell["algo"], "dataset": cell["dataset"],
            "iru_service_frac": round(service / max(iru_total, 1e-9), 3),
            "normalized_total": round(iru_total / max(base, 1e-9), 3),
        })
    rows.append({"algo": "MEAN", "dataset": "-",
                 "iru_service_frac": round(geomean(
                     [max(r["iru_service_frac"], 1e-9) for r in rows]), 3),
                 "normalized_total": round(geomean(
                     [r["normalized_total"] for r in rows]), 3)})
    return rows


def main(argv=None):
    a = parse_args(argv)
    print("algo,dataset,iru_service_frac,normalized_total")
    for r in run(a.force, engine=a.engine, device=a.device):
        print(f"{r['algo']},{r['dataset']},{r['iru_service_frac']},"
              f"{r['normalized_total']}")


if __name__ == "__main__":
    main()
