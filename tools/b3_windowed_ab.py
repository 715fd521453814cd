#!/usr/bin/env python3
"""Kernel B3's bodies from several source trees, side by side on one card.

Each tree (``--tree NAME=PATH``, a checkout of this repository, e.g. the
parent commit unpacked with ``git archive``) has its
``src/repro_torch/kernels/iru_reorder/iru_reorder.cu`` built with ``nvcc``
(all trees at once, the port's flags) and loaded with ``ctypes``; the
input is kron-20's PageRank stream (every edge's destination in CSR order,
carrying ``rank[src] / deg[src]``), built once by the port of the tree
this script lives in.  For each variant every tree's result must equal
the first tree's bit for bit; then each tree's CUDA-event mean of 10 calls
is taken twice, in the order first..last, last..first.  Variants: the
windowed body at the paper's geometry (1024 x 32 sets, 4 partitions,
8192-lane windows, round cap 64, f32 add), the sweep of chip_smoke's
phase 3 (w = 1024, 2048, 4096; no merge; one partition) and the stream's
first 6144 and 49152 lanes (one partial window, six windows: a
high-diameter traversal's levels, where a window's latency counts) and,
tagged (families ``(idx >> 17) & 1``), the paper's geometry; the
whole-stream body (add), its tagged fold, its banked layout (4
partitions, add) and the tagged fold on a padded serving tick (the stream
padded with dead lanes to 251,212,640 lanes, the top rung of the 12-query
serving mix, ``n_live`` on the device); and the whole-stream round-cap
fallback (round cap 64, every partition of this stream past it: one
partition add, four partitions add and tagged) beside ``torch.sort``
(stable) of the same keys.  The tagged windows and the round cap need a
library whose ``iru_reorder_abi`` is 2 or more; older trees sit those
variants out.  A tree whose library has the stamped build also gives the
windowed body's time by phase (clock64 cycles a window) and its CTAs
resident per SM (add, and tagged where it has them).  With ``--profile``
each tree's whole-stream variants are also split by kernel
(``torch.profiler`` device time of one call, after a warm-up).

    python3 tools/b3_windowed_ab.py --tree parent=build/parent --tree change=.

Prints one line per measurement and the card's name and power limit; with
``--out FILE`` also writes the numbers as JSON.  Needs a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
GEO = dict(num_sets=1024, slots=32, epb=32, round_cap=64)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 peak (NVIDIA data sheet)
WINDOWED = {  # label -> (window, partitions, op, lanes: None for all)
    "IRU_HASH add": (8192, 4, 1, None),
    "IRU_HASH tagged": (8192, 4, 4, None),
    "w=1024": (1024, 4, 1, None),
    "w=2048": (2048, 4, 1, None),
    "w=4096": (4096, 4, 1, None),
    "no merge": (8192, 4, 0, None),
    "1 partition": (8192, 1, 1, None),
    # a high-diameter traversal's levels: one partial window, a few windows
    "6144 lanes": (8192, 4, 1, 6144),
    "49152 lanes": (8192, 4, 1, 49152),
}
WHOLE = {  # label -> (partitions, op, padded, round cap: 0 for none)
    "whole-stream add": (1, 1, False, 0),
    "tagged fold": (1, 4, False, 0),
    "banked layout": (4, 1, False, 0),
    "serving tick": (1, 4, True, 0),
    "round-cap add": (1, 1, False, 64),
    "round-cap banked": (4, 1, False, 64),
    "round-cap tagged": (4, 4, False, 64),
}
NEW_ABI = 2  # a library that takes the round cap and tagged windows
TICK_LANES = 251_212_640  # a top-rung tick of the serving mix (tile_csr(kron-20, 8))


def build(trees: dict) -> dict:
    """Every tree's iru_reorder.cu compiled at once; name -> CDLL."""
    out_dir = ROOT / "build" / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, path in trees.items():
        src = Path(path) / "src/repro_torch/kernels/iru_reorder/iru_reorder.cu"
        lib = out_dir / f"libiru_reorder_{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        entry = ""
        for ln in log.splitlines():  # ptxas -v: each entry, then its use
            if "Compiling entry function" in ln:
                entry = ln.split("'")[1]
            elif ("Used" in ln or "spill" in ln) and any(
                    k in entry for k in ("win_reorder", "chain", "fold_emit",
                                         "mark_scan", "copy_dead", "walk")):
                print(f"built {name}: {entry[-40:]}: "
                      f"{ln.split('info    : ')[-1].strip()}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def pagerank_stream(dev):
    from repro_torch.graphs.csr import from_edges
    from repro_torch.graphs.generators import kron_edges

    src, dst, n = kron_edges(20, 16)
    w = np.random.default_rng(0).uniform(1.0, 64.0, src.shape[0])
    g = from_edges(src, dst, n, w.astype(np.float32), symmetrize=True,
                   device=dev)
    deg = g.degrees().clamp(min=1).float()
    ids = torch.arange(g.n_nodes + 1, device=dev)
    tags = ((ids >> 17) & 1).bool()
    tags[-1] = False
    return (g.col_idx.to(torch.int32).contiguous(),
            (1.0 / g.n_nodes / deg)[g.edge_sources().long()].contiguous(),
            tags.contiguous())


def outputs(idx, val):
    n = idx.numel()
    return (torch.empty_like(idx), torch.empty_like(val),
            torch.empty_like(idx), torch.empty(n, dtype=torch.bool,
                                               device=idx.device))


def abi(lib) -> int:
    try:
        fn = lib.iru_reorder_abi
    except AttributeError:
        return 1
    fn.restype = _I
    return fn()


def windowed_call(lib, idx, val, w, parts, op, stamps=None, tags=None):
    out = outputs(idx, val)
    st = torch.cuda.current_stream().cuda_stream
    tagged = [tags.data_ptr() if op == 4 else None,
              tags.numel() if op == 4 else 0] if abi(lib) >= NEW_ABI else []
    head = [_P] * 3 + ([_P, _I] if tagged else []) + [_P] * 4 + [_LL] \
        + [_I] * 8
    args = [idx.data_ptr(), val.data_ptr(), None, *tagged,
            *(o.data_ptr() for o in out), idx.numel(), w, GEO["num_sets"],
            GEO["slots"], GEO["epb"], parts, GEO["round_cap"], 0, op]
    if stamps is None:
        fn = lib.iru_win_reorder
        fn.argtypes = head + [_P]
        code = fn(*args, st)
    else:
        fn = lib.iru_win_reorder_stamped
        fn.argtypes = head + [_P, _P]
        code = fn(*args, stamps.data_ptr(), st)
    if code:
        raise RuntimeError(f"windowed launch failed: CUDA error {code}")
    return out


def padded(idx, val, lanes):
    """The stream followed by dead lanes up to ``lanes`` (the padding index
    one past the last node, payload 0), and its live count on the device."""
    pad = lanes - idx.numel()
    sentinel = int(idx.max()) + 1
    return (torch.cat([idx, idx.new_full((pad,), sentinel)]),
            torch.cat([val, val.new_zeros(pad)]),
            torch.tensor(idx.numel(), dtype=torch.int32, device=idx.device))


def whole_call(lib, idx, val, tags, parts, op, n_live=None, cap=0):
    new = abi(lib) >= NEW_ABI
    if cap and not new:
        raise ValueError("this library has no whole-stream round cap")
    lib.iru_hash_reorder_workspace.argtypes = [_LL, _I, _I] + (
        [_I] if new else [])
    lib.iru_hash_reorder_workspace.restype = _LL
    n = idx.numel()
    work = torch.empty(lib.iru_hash_reorder_workspace(
        n, GEO["num_sets"], parts, *([cap] if new else [])),
        dtype=torch.uint8, device=idx.device)
    out = outputs(idx, val)
    fn = lib.iru_hash_reorder
    fn.argtypes = [_P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _LL] \
        + [_I] * (7 if new else 6) + [_P]
    tagged = op == 4
    code = fn(idx.data_ptr(), val.data_ptr(),
              None if n_live is None else n_live.data_ptr(),
              tags.data_ptr() if tagged else None,
              tags.numel() if tagged else 0, *(o.data_ptr() for o in out),
              work.data_ptr(), n, GEO["num_sets"], GEO["slots"], GEO["epb"],
              parts, *([cap] if new else []), 0, op,
              torch.cuda.current_stream().cuda_stream)
    if code:
        raise RuntimeError(f"whole-stream launch failed: CUDA error {code}")
    return out


def same(a, b) -> bool:
    return all(torch.equal(x.view(torch.int32) if x.is_floating_point()
                           else x, y.view(torch.int32)
                           if y.is_floating_point() else y)
               for x, y in zip(a, b))


def event_ms(fn, reps=10) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_split(call) -> list:
    """(kernel, device ms) of one call, largest first (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    rows = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or getattr(
            e, "self_cuda_time_total", 0)
        if us > 0:
            name = e.key.replace("(anonymous namespace)::", "").replace(
                "void ", "").split("(")[0]
            rows[name] = rows.get(name, 0.0) + us / 1e3
    return sorted(rows.items(), key=lambda r: -r[1])


def phase_split(lib, idx, val):
    """(cycles a window by phase, share of all windows' cycles) of the
    stamped build at the paper's geometry, or None without one."""
    try:
        phases = lib.iru_win_reorder_phases()
    except AttributeError:
        return None
    w, parts, op, _ = WINDOWED["IRU_HASH add"]
    stamps = torch.zeros(-(-idx.numel() // w), phases + 1, dtype=torch.int64,
                         device=idx.device)
    windowed_call(lib, idx, val, w, parts, op, stamps)  # warm-up
    windowed_call(lib, idx, val, w, parts, op, stamps)
    torch.cuda.synchronize()
    d = stamps.diff(dim=1).double()
    total = d.sum()
    return ([round(x, 1) for x in d.mean(0).tolist()],
            [round(x, 4) for x in (d.sum(0) / total).tolist()])


def occupancy(lib):
    """(CTAs resident per SM, add; the same tagged or None; shared memory
    a window), or None without the query."""
    try:
        fn = lib.iru_win_reorder_occupancy
    except AttributeError:
        return None
    fn.argtypes = [_I, _I, _I, _I, _I, _P]
    got = []
    for op in (1, 4) if abi(lib) >= NEW_ABI else (1,):
        blocks = ctypes.c_int(0)
        code = fn(8192, GEO["num_sets"], 4, 0, op, ctypes.addressof(blocks))
        if code:
            raise RuntimeError(f"occupancy query failed: CUDA error {code}")
        got.append(blocks.value)
    smem = lib.iru_win_reorder_smem
    smem.argtypes = [_I, _I, _I]
    smem.restype = _LL
    return got[0], got[1] if len(got) > 1 else None, smem(8192,
                                                          GEO["num_sets"], 4)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", required=True,
                    help="NAME=PATH of a source tree (the first is the "
                         "reference of the equality checks)")
    ap.add_argument("--out", help="write the numbers as JSON here")
    ap.add_argument("--profile", action="store_true",
                    help="split each tree's whole-stream variants by kernel")
    ap.add_argument("--only", action="append",
                    help="run only the variants whose label contains this")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("b3_windowed_ab: no CUDA device", file=sys.stderr)
        return 2
    trees = dict(t.split("=", 1) for t in args.tree)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "-i", "0"],
                          capture_output=True, text=True,
                          check=True).stdout.strip()
    print(f"card: {card}")
    t0 = time.perf_counter()
    libs = build(trees)
    print(f"build {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda", 0)
    idx, val, tags = pagerank_stream(dev)
    print(f"kron-20 PageRank stream: {idx.numel()} lanes")
    calls = {label: (lambda lib, w=w, p=p, op=op, k=k:
                     windowed_call(lib, idx[:k], val[:k], w, p, op,
                                   tags=tags))
             for label, (w, p, op, k) in WINDOWED.items()}
    tick = padded(idx, val, TICK_LANES)
    print(f"serving tick: {TICK_LANES} lanes, {idx.numel()} live")
    calls.update({label: (lambda lib, p=p, op=op, pad=pad, cap=cap:
                          whole_call(lib, *(tick[:2] if pad else (idx, val)),
                                     tags, p, op,
                                     tick[2] if pad else None, cap))
                  for label, (p, op, pad, cap) in WHOLE.items()})
    needs_new = {label for label, v in WINDOWED.items() if v[2] == 4} | {
        label for label, v in WHOLE.items() if v[3]}
    if args.only:
        calls = {k: v for k, v in calls.items()
                 if any(o in k for o in args.only)}
    record = {"card": card, "trees": trees, "ms": {}, "phases": {},
              "occupancy": {}, "kernels": {}, "sort_ms": None}
    if any(label.startswith("round-cap") for label in calls):
        # the fallback's sort stage against the library's stable sort of the
        # same keys (the index, its stream position the tie-break)
        record["sort_ms"] = event_ms(
            lambda: torch.sort(idx, stable=True))
        print(f"torch.sort(stable=True) of the {idx.numel()} int32 keys: "
              f"{record['sort_ms']:.4f} ms")
    for label, call in calls.items():
        names = [name for name in libs
                 if label not in needs_new or abi(libs[name]) >= NEW_ABI]
        if not names:
            print(f"{label}: no tree has it")
            continue
        ref = call(libs[names[0]])
        if label in WHOLE:  # B3's bytes: 8 read and 13 written a lane
            lanes = ref[0].numel()
            live = idx.numel()
            print(f"{label}: {int(ref[3].sum())} survivors; bound "
                  f"{21 * lanes / HBM_BYTES_PER_S * 1e3:.4f} ms, of which "
                  f"the dead lanes' {21 * (lanes - live) / HBM_BYTES_PER_S * 1e3:.4f}")
        for name in names[1:]:
            if not same(call(libs[name]), ref):
                raise RuntimeError(f"{label}: {name} differs from "
                                   f"{names[0]}")
        times = {name: [] for name in names}
        for name in names + names[::-1]:
            times[name].append(event_ms(lambda: call(libs[name])))
        record["ms"][label] = times
        print(f"{label:16s}: " + ", ".join(
            f"{name} {np.mean(t):.4f} ms ({t[0]:.4f}, {t[1]:.4f})"
            for name, t in times.items())
            + f"; all equal to {names[0]} bit for bit")
        if args.profile and label in WHOLE:
            for name in names:
                split = kernel_split(lambda: call(libs[name]))
                record["kernels"].setdefault(label, {})[name] = split
                print(f"  kernels {name}: " + ", ".join(
                    f"{k} {ms:.4f}" for k, ms in split))
    for name, lib in libs.items():
        split = phase_split(lib, idx, val)
        occ = occupancy(lib)
        if split is not None:
            record["phases"][name] = split
            print(f"phases {name} (clock64 cycles a window, share): "
                  + ", ".join(f"{c} ({s})" for c, s in zip(*split)))
        if occ is not None:
            record["occupancy"][name] = occ
            tagged = "" if occ[1] is None else f" ({occ[1]} tagged)"
            print(f"occupancy {name}: {occ[0]} CTAs per SM{tagged}, "
                  f"{occ[2]} bytes of shared memory a window")
    print(f"card: {card}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
