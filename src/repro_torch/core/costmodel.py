"""Analytical GPU memory-hierarchy model used to reproduce Figures 11-13.

A numpy copy, code for code, of ``repro.core.costmodel``: a host model of
the paper's GPU, not a kernel.  The paper evaluates the IRU inside
GPGPU-Sim (GTX 980: 16 SMs, 32 KB L1 per SM, 2 MB shared L2, 128 B lines,
4 memory partitions).  This is not a cycle simulator; it re-creates the
*counted quantities* the paper reports:

* L1 accesses   = coalesced requests per warp (32-lane groups, 128 B blocks)
* L2 accesses   = L1 misses + atomic requests (atomics bypass L1, §6.1)
* NoC traffic   = request+reply flits between SMs and memory partitions
* DRAM accesses = L2 misses

Caches are modelled as per-SM (L1) and shared (L2) LRU sets of 128 B lines;
warps are assigned round-robin to SMs, close enough to GPGPU-Sim's
greedy-then-oldest scheduler for *relative* traffic numbers (the paper's
figures are all normalized to baseline, as are these).

Timing and energy are linear models over those counts; constants are
order-of-magnitude CACTI/GPUWattch-class values and are documented inline.
Absolute numbers are not meaningful -- normalized ratios (Fig. 13) are.
The counts describe the GTX 980 model, whichever device took the trace.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Iterable, Sequence

import numpy as np

BLOCK_BYTES = 128
GROUP = 32


@dataclasses.dataclass(frozen=True)
class GPUConfig:
    """GTX 980-like configuration (paper Table 2)."""

    num_sms: int = 16
    l1_bytes: int = 32 * 1024          # per SM
    l2_bytes: int = 2 * 1024 * 1024    # shared
    line_bytes: int = BLOCK_BYTES
    # timing weights (cycles per event) — relative costs only
    cyc_warp_inst: float = 1.0
    cyc_l1_access: float = 4.0
    cyc_l2_access: float = 30.0
    cyc_dram_access: float = 180.0
    cyc_iru_element: float = 0.20      # IRU pipeline is 1 elem/cycle/partition x4
    # regular (non-irregular-access) work per processed element: frontier
    # generation, compaction, ALU — the denominator the paper's end-to-end
    # speedups are diluted by.  THE one calibrated constant: 5.5 sets the BFS
    # mean speedup to the paper's 1.16x; SSSP/PR/energy then become
    # predictions.
    cyc_regular_per_elem: float = 5.5
    # energy weights (pJ per event) — CACTI-32nm-class ratios
    pj_l1: float = 30.0
    pj_l2: float = 90.0
    pj_dram: float = 1600.0
    pj_iru_element: float = 6.0        # small SRAM hash read+write
    pj_static_per_cycle: float = 45.0  # whole-GPU static power share


class _LRU:
    __slots__ = ("cap", "d", "hits", "misses")

    def __init__(self, lines: int):
        self.cap = max(int(lines), 1)
        self.d: OrderedDict[int, None] = OrderedDict()
        self.hits = 0
        self.misses = 0

    def access(self, line: int) -> bool:
        d = self.d
        if line in d:
            d.move_to_end(line)
            self.hits += 1
            return True
        self.misses += 1
        d[line] = None
        if len(d) > self.cap:
            d.popitem(last=False)
        return False


@dataclasses.dataclass
class TrafficCounts:
    elements: int = 0
    warp_insts: int = 0
    l1_accesses: int = 0
    l2_accesses: int = 0
    dram_accesses: int = 0
    noc_flits: int = 0
    iru_elements: int = 0

    def __add__(self, o: "TrafficCounts") -> "TrafficCounts":
        return TrafficCounts(*[a + b for a, b in zip(dataclasses.astuple(self), dataclasses.astuple(o))])


def _coalesce_rows(blocks: np.ndarray) -> list[np.ndarray]:
    """Unique block ids per 32-lane group. ``blocks`` < 0 marks inactive."""
    n = blocks.shape[0]
    pad = (-n) % GROUP
    if pad:
        blocks = np.concatenate([blocks, np.full(pad, -1, blocks.dtype)])
    rows = blocks.reshape(-1, GROUP)
    return [np.unique(r[r >= 0]) for r in rows]


def simulate_trace(
    index_traces: Iterable[tuple[np.ndarray, np.ndarray | None, bool]],
    *,
    elem_bytes: int = 4,
    gpu: GPUConfig = GPUConfig(),
    iru_processed: int = 0,
) -> TrafficCounts:
    """Run the memory-hierarchy count model over irregular-access traces.

    ``index_traces`` yields ``(indices, active_or_None, is_atomic)`` — one
    entry per irregular memory instruction stream (e.g. one BFS iteration's
    frontier gather).  Warps are dealt round-robin to SMs.
    """
    epb = gpu.line_bytes // elem_bytes
    l1 = [_LRU(gpu.l1_bytes // gpu.line_bytes) for _ in range(gpu.num_sms)]
    l2 = _LRU(gpu.l2_bytes // gpu.line_bytes)
    c = TrafficCounts(iru_elements=iru_processed)
    warp_rr = 0
    for indices, active, is_atomic in index_traces:
        idx = np.asarray(indices, np.int64)
        c.elements += int(idx.size)
        blocks = idx // epb
        if active is not None:
            blocks = np.where(np.asarray(active, bool), blocks, -1)
        for uniq in _coalesce_rows(blocks):
            if uniq.size == 0:
                continue
            c.warp_insts += 1
            sm = warp_rr % gpu.num_sms
            warp_rr += 1
            for line in uniq:
                if is_atomic:
                    # atomics bypass L1; serviced at the L2 partition (§6.1)
                    c.noc_flits += 2
                    c.l2_accesses += 1
                    if not l2.access(int(line)):
                        c.dram_accesses += 1
                else:
                    c.l1_accesses += 1
                    if not l1[sm].access(int(line)):
                        c.noc_flits += 2
                        c.l2_accesses += 1
                        if not l2.access(int(line)):
                            c.dram_accesses += 1
    return c


def cycles(c: TrafficCounts, gpu: GPUConfig = GPUConfig()) -> float:
    return (
        gpu.cyc_regular_per_elem * c.elements
        + gpu.cyc_warp_inst * c.warp_insts
        + gpu.cyc_l1_access * c.l1_accesses
        + gpu.cyc_l2_access * c.l2_accesses
        + gpu.cyc_dram_access * c.dram_accesses
        + gpu.cyc_iru_element * c.iru_elements
    )


def energy_pj(c: TrafficCounts, gpu: GPUConfig = GPUConfig()) -> float:
    return (
        gpu.pj_l1 * c.l1_accesses
        + gpu.pj_l2 * c.l2_accesses
        + gpu.pj_dram * c.dram_accesses
        + gpu.pj_iru_element * c.iru_elements
        + gpu.pj_static_per_cycle * cycles(c, gpu)
    )


@dataclasses.dataclass
class Comparison:
    name: str
    base: TrafficCounts
    iru: TrafficCounts

    def report(self, gpu: GPUConfig = GPUConfig()) -> dict[str, float]:
        cb, ci = self.base, self.iru
        return {
            "l1_ratio": _ratio(ci.l1_accesses, cb.l1_accesses),
            "l2_ratio": _ratio(ci.l2_accesses, cb.l2_accesses),
            "noc_ratio": _ratio(ci.noc_flits, cb.noc_flits),
            "dram_ratio": _ratio(ci.dram_accesses, cb.dram_accesses),
            "speedup": cycles(cb, gpu) / max(cycles(ci, gpu), 1e-9),
            "energy_ratio": energy_pj(ci, gpu) / max(energy_pj(cb, gpu), 1e-9),
        }


def _ratio(a: float, b: float) -> float:
    return a / b if b else 1.0
