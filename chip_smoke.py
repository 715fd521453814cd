#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on a CUDA card (an H100).

Run from the repo root with no arguments:  python3 chip_smoke.py

Phases, in order (any failure exits non-zero and prints no result line):
  1. build   -- compiles every kernel of the port (nvcc, sm_90a) into
               build/kernels/ while kron-20 and delaunay-1024 are built on
               the card, and prints the seconds and each kernel's
               register / shared-memory report;
  2. kernels -- holds each kernel against its plain PyTorch version on the
               card at full size: B1 (block-reuse gather) on kron-20's edge
               arrays with real expansions' monotone offsets (half the nodes,
               and a gappy quarter of them) and a shuffled stream, at
               (group, window) = (8, 128) and (256, 256), exactly;
               B2 (segment merge) on kron-20's sorted destination stream with
               an active prefix, for add (f32, rtol 1e-5), min (f32, int32)
               and max, survivors and min/max exactly, and B2's tagged body
               (the fused min+add merge, tags (idx >> 17) & 1: min-family
               lanes exactly, add-family lanes within rtol 1e-5), and two
               calls of B2 add and tagged on the same stream, which must be
               bit-identical (their largest difference is printed); B3 (IRU hash) on
               kron-20's PageRank destination stream (add, f32), a half-graph
               expansion stream with its live prefix (min on int32 and f32,
               and no merge) and a stream that hammers eight sets (max, many
               rounds): indices, positions, active and min/max exactly, add
               within rtol 1e-5; and B3's tagged fold on the PageRank stream
               with the same tags;
  3. banked/windowed -- the paper's IRU geometry (IRU_HASH: 1024 x 32 sets
               over 4 partitions x 2 banks, 8192-lane windows, round cap 64).
               B3's windowed body (one launch) on kron-20's PageRank stream
               equals the numpy oracle, bit for bit, and the plain window
               loop (add on every window, within rtol 1e-5 of plain; min on
               its first 512 windows, exactly; max abs and relative error
               printed); two 1M-lane
               streams built to trip the
               round-cap fallback and the bank bypass are held the same way,
               and each prints how many windows took its branch (each count
               must be non-zero).  Whole-stream B3 with the banked layout (4
               partitions, no window) equals the banked plain version at
               PageRank's shape (add, rtol 1e-5) and, without a merge,
               hash_reorder_ref_banked exactly.  The windowed body tagged
               (families (idx >> 17) & 1) on the PageRank stream equals the
               oracle per family (layout and add lanes on every window, min
               lanes on the first 512) and plain there, and on a padded
               serving tick (251,212,640 lanes, the stream live) its live
               windows equal the unpadded call, the 128 windows around the
               live count plain and the oracle, the rest the identity.
               Whole-stream B3 under ROUND_CAP_4X2's cap (round cap 64, no
               window; each call under set_sync_debug_mode("error")) on the
               PageRank stream flat and in 4 partitions, add and tagged, the
               half-graph expansion with its live prefix (min, int32), a
               stream with partition 0 past the cap and the others under
               it, and those others alone (which must equal the uncapped
               call) equals the plain version and ragged_oracle(
               hash_reorder_ref_banked, round_cap=64) bit for bit (tagged:
               per family); each prints how many partitions took the
               fallback (host numpy), non-zero where built to.  Then BFS,
               SSSP and PageRank (20 iterations) on kron-20 and
               delaunay-1024 through FrontierPipeline(mode="hash",
               iru_config=IRUConfig(**IRU_HASH)) and through
               IRUConfig(**ROUND_CAP_4X2) (the reference's examples' 4 x 2
               geometry with round cap 64, no window) against the host
               oracles (BFS/SSSP exactly, PageRank rtol 1e-4), and
               reorder_frontier with IRU_HASH and with 4 partitions and no
               window, each run with its launch counts zeroed before and
               read after (the IRU_HASH runs must launch the windowed body,
               the 4 x 2 runs the round-cap body); then both bodies'
               CUDA-event times, the windowed body's by window size,
               without a merge, in one partition and tagged (also on the
               padded tick), its time by phase (one call of its stamped
               build: clock64 cycles a window and each phase's share) with
               its CTAs resident per SM (add and tagged: two each), and a
               profile of one call of each body;
  4. apps    -- BFS and SSSP from node 0 on kron-20 and delaunay-1024, and
               PageRank on kron-20, through the kernels (kernels=True,
               3-bucket CapacityPolicy), once with mode="sort" (B1, B2) and
               once with mode="hash" (B1, B3).  Each run is held against the
               same run through the plain path (kernels=False) -- exactly for
               BFS/SSSP, rtol 1e-5 for PageRank; the plain runs of hash-mode
               PageRank, BFS and SSSP on kron-20 and the delaunay-1024
               traversals but sort BFS are cut to 1, 3, 2 and 100 iterations
               (PLAIN_DEPTH), beside a kernel run of that depth -- and
               against the port's
               numpy host oracle (PageRank at rtol 1e-4: the oracle sums each
               hub's ~1e5 contributions sequentially in f32).  PageRank runs
               20 iterations.  The launch counts of each run are zeroed before
               it and read after it; a kernel of the path with no launch
               fails the run;
  5. figures -- the paper's evaluation path.  (a) The figure harness
               (repro_torch.figures) at its own scale (DATASET_KW): all 18
               cells (BFS, SSSP, PageRank x six datasets) with the IRU traces
               taken by the host apps through reorder_frontier with IRU_HASH
               on the card (kernel B3's windowed body, one launch a
               reorder), each held against the same cell through the numpy
               oracle (engine="hash_ref"): every event's indices, active
               mask and atomic flag and iru_elements equal, BFS/SSSP results
               equal, PageRank bit for bit (else its largest difference is
               printed and rtol 1e-6 holds); then the six figure drivers'
               rows (Figs. 4, 11-15), per cell and MEAN: cost-model counts
               of a GTX 980 model over traces taken on this card.  (b)
               Figs. 14 and 15 at the size of the graphs the datasets
               imitate (ca 1024^2, cond 40k, delaunay-1024, human 22k,
               kron-20, msdoor 75^3), BFS/SSSP/PageRank (5 iterations)
               through FrontierPipeline.run_instrumented in baseline and
               with IRU_HASH (B1, B3 windowed; at least one launch a step,
               B3 exactly one), each event reduced on the card as it
               arrives: accesses per warp, improvement, filtered fraction,
               trace wall seconds; each run equals the same pipeline's run()
               (PageRank rtol 1e-5), the two modes agree, and on kron-20 and
               delaunay-1024 BFS/SSSP equal the host oracles.  (c) bfs_jit
               on both graphs against the BFS oracle exactly, and
               pagerank_jit(use_iru=True) on kron-20 (20 iterations, B2
               once an iteration) within rtol 1e-4, atol 1e-7 of it;
  6. serving -- 12 queries (4 BFS, 4 SSSP, 4 PPR of 20 iterations, seeded
               sources of nonzero degree) through GraphServingEngine on
               tile_csr(kron-20, 8) with the default GraphServeConfig (8
               slots, so four queries wait): fused baseline (B1 and the
               tagged scatter), fused sort (B1, B2 tagged), fused hash (B1,
               B3 tagged), split hash (B1, B3) and fused sort through the
               plain versions.  Every query must end done; BFS and SSSP
               equal their solo pipeline runs bit for bit (one of each also
               the host oracles), PPR within rtol 1e-5 of solo; fused sort
               equals its plain twin.  Each run prints its wall time,
               queries/s, ticks, overflow and quarantine counts, launch
               counts and peak device memory.  Two more fused hash runs
               serve the mix under the paper's geometries: IRU_HASH (B3's
               windowed body, tagged) and ROUND_CAP_4X2 (B3's round-cap
               body, tagged); BFS/SSSP equal their solo runs (solo
               pipelines of the same geometry) bit for bit, PPR within rtol
               1e-5 of them.  Then one more fused sort
               run (untimed, its launches not counted) keeps two of its
               ticks at the top rung (8 m lanes): B2's tagged body is held
               against its plain version on the sorted stream of the tick
               with the most live lanes, B3's tagged fold on the expansion
               stream and n_live of the tick with the fewest (B3's plain
               version takes time in proportion to live lanes times width),
               and B2's call on that tick is profiled kernel by kernel;
  7. partitioned -- the edge-partitioned pipeline (repro_torch.dist): four
               shards of one graph held on the card and stepped in turn,
               kernels B1, B2 and B3 launched per shard, the boundary
               exchange between scatter and update.  On partition_csr(
               kron-20, 4), BFS, SSSP and PageRank (20 iterations) in
               baseline, sort and hash mode, each with the exact codec and
               with compress=True (BFS: flag, PageRank: int8_ef, SSSP stays
               exact), and PageRank once with IRU_HASH (B3's windowed body
               per shard): BFS and SSSP equal the single-device pipeline of
               the same mode and the host oracle bit for bit, PageRank is
               within rtol = atol = 1e-4 of single-device with the exact
               codec (and rtol 1e-4 with atol 0) and 2e-3 with int8_ef (the
               reference's tolerances; max abs, max relative and L1 relative
               errors printed).  BFS on partition_csr(delaunay-1024, 4) in
               hash mode with compress=True under a 3-rung CapacityPolicy,
               bit-identical, hopping rungs.  Then the 12-query serving mix
               through the engine on partition_csr(tile_csr(kron-20, 8), 4)
               in fused hash and fused sort, and on the same composite at
               P=3 in fused hash (P=4 puts whole tenants on each shard, P=3
               cuts two of them, so the tagged exchange runs): BFS/SSSP
               equal phase 6's single-device run of the same mode, PPR
               within rtol 1e-5 of it.  Each line prints supersteps, bucket
               hops, wall seconds beside single-device, boundary bytes per
               superstep (raw and on the wire) and each shard's launches,
               every one of which must include the kernels its mode needs;
               each partition's build seconds and device bytes are printed;
  8. moe     -- MoE expert dispatch (repro_torch.moe, plain torch: the path
               reaches no hand-written kernel) at deepseek-v2-lite's width
               (DEEPSEEK_V2_LITE_MOE: d_model 2048, 64 experts, top-6, expert
               d_ff 1408, 2 shared experts, swiglu, capacity factor 1.25;
               random init from a seeded generator).  (a) In f32 with TF32
               off at T = 4096: plan_dispatch equals moe_dispatch_ref bit
               for bit at capacity factors 1.25 and 0.5 (which must drop
               lanes); moe_sorted and moe_dense agree with moe_hash at rtol
               1e-4 and an atol of 1e-5 of the output's largest magnitude,
               with equal aux losses, at both factors; moe_hash with
               n_live = 3000 (a device tensor) runs under
               set_sync_debug_mode("error"), gives zero rows past it and
               its live prefix equals the truncated run at the same
               capacity (rtol 1e-5, atol 1e-6 of the largest); moe_hash_ep
               at 4 shards and 8 partitions equals moe_hash exact (rtol
               1e-5, atol 1e-6 of the largest) and within 0.05 max|y| +
               1e-3 with the int8 combine; one backward of sum(y^2) +
               0.01 aux is finite with nonzero router and wi gradients.  Each
               comparison also prints its verdict at the plain absolute
               atol.  (b) In bf16 (f32 router): the CUDA-event median of 10
               calls of moe_hash, moe_sorted and moe_dense at T = 4096 and
               of moe_hash and moe_sorted at 16384 (the dense engine's (T,
               k, E, C) f32 tensor would be 48 GB there), plan_dispatch
               alone at both, moe_hash_ep (4 shards, int8 and exact) at
               4096: ms, tokens/s, peak memory, dropped share, the expert
               FFN's flop; a profile of moe_hash and of plan_dispatch at
               16384 and the planner's share of moe_hash;
  8b. group  -- one shard per process over torch.distributed, the ranks
               started by python -m repro_torch.launch.partitioned.  (a)
               Four gloo ranks on the one card (the exchange crosses host
               memory and loopback TCP, not NVLink), one shard of
               partition_csr(kron-20, 4) each, hash mode (B1 and B3 on every
               rank): BFS with the flag codec and SSSP equal phase 7's
               stacked runs bit for bit, PageRank (20 iterations) within
               rtol 1e-5 (atol 0) of stacked with the exact codec and within
               an L1 relative error of 1e-3 with int8_ef (the stacked exact
               run, what a wire that skipped the codec would give, must lie
               beyond that limit); every rank's supersteps and
               boundary traffic equal stacked, the bytes handed to
               all_to_all_single equal the codec's wire bytes, the ranks'
               shards add up to the stacked partition, and every rank
               launched B1 and B3.  moe_hash_ep over the four ranks (16 of
               deepseek-v2-lite's 64 experts each, phase 8's f32 layer at T
               = 4096, 8 partitions) equals phase 8's stacked 4-shard result
               (exact: rtol 1e-5, atol 1e-6 of the largest; int8: within 4
               quanta of each 128-block), aux equal.  In the same launch,
               partitioned serving over the four ranks: the 12-query mix
               of phase 6 through the fused hash engine on one shard of
               partition_csr(tile_csr(kron-20, 6), 4) a rank (6 slots over
               4 shards cut tenants, so lane_cap > 0 and the tagged
               exchange crosses ranks; B1 and B3's tagged fold on every
               rank): BFS and SSSP equal phase 6's fused hash results bit
               for bit and PPR within rtol 1e-5 (atol 0), and every query
               equals the same engine's stacked run here (every shard in
               this process) in as many ticks; and the banked rows over
               the four ranks: kron-20's PageRank stream (add, 1024 x 32, 4
               partitions), one partition a rank through B3's whole-stream
               body (exactly one iru_reorder launch a rank, so the plain
               rows did not run), equals B3's single-card banked layout
               bit for bit.  (b) A group of one
               over NCCL runs BFS at P = 1 equal to the single-device
               pipeline.  Each line prints the wall seconds (the slowest
               rank's run, and the launcher's with its process starts),
               launches and partition bytes per rank, and wire bytes a
               superstep (serving: each rank's wall, ticks, lane_cap,
               bytes through all_to_all_single, launches and peak memory);
  9. lm      -- the LM substrate's model half (repro_torch.configs and
               repro_torch.models: the IRU embedding, GQA/MLA attention,
               Mamba-2, the stack's forward_train, prefill and decode_step;
               plain torch, the path reaches no hand-written kernel).  (a)
               In f32 with TF32 off at full width: deepseek-v2-lite-16b and
               qwen3-32b cut to 2 layers (deepseek: the dense layer 0 and
               one MoE layer, at capacity factor E / k so that no lane is
               dropped; qwen3: GQA with qk-norm) and mamba2-130m whole
               (SSD): a 300-token prompt (ragged over the 128-token attention
               chunk) through prefill then 3 decode_steps at B = 2 match
               forward_train's softmax at the same positions within atol
               2e-3 (the reference's own check) and its logits within 1e-3
               of the largest, and embed(iru=True) equals embed(iru=False)
               bit for bit.  (b) In bf16: deepseek-v2-lite-16b whole (27
               layers, full width, dispatch "iru_sorted"), built on the card
               from a seeded generator: its parameter count (abstract_params
               on meta) beside params_billions(), the build seconds and GiB
               held; prefill at B = 2, S = 4096 (CUDA-event median of 5, ms,
               prompt tokens/s, peak memory); 32 greedy decode steps at B =
               8 after a 4096-token prompt (cache 4128; ms a step, tokens/s;
               one more step under set_sync_debug_mode("error"));
               one profiled prefill and one profiled decode step, split by
               layer kind (attention, MoE, dense FFN, norms, embedding,
               logits: the profiler's device time under a range around each
               call, and CUDA-event spans) with the top 10 ops; then
               mamba2-130m whole the same way
               (prefill at B = 8, S = 4096).
               The shapes are cut from LM_SHAPES: prefill_32k (S 32768, B
               32) to B = 2, S = 4096 and decode_32k to B = 8 on a 4128
               cache.  Then LM serving (repro_torch.serve.ServingEngine and
               repro_torch.launch.serve; `lm serve` lines): (a) in f32 with
               TF32 off, deepseek-v2-lite-16b at full width cut to 2 layers
               (capacity factor E / k) serves 10 requests on 4 slots
               (prompts of 2-12 tokens, 4-8 new tokens, one eos_id equal to
               its request's solo first token): every request done with its
               token count, the EOS request stopped after one token and its
               slot taken at the next tick, and three probes' tokens equal
               to theirs served alone on a 1-slot engine; (b) in bf16 with
               deepseek-v2-lite-16b whole, after the decode timing, 16 of
               the launcher's requests (16 new tokens each) on 8 slots over
               the decode cache (4128): wall s, ticks, decode steps split
               into prompt replays and ticks, mean ms a step beside the
               decode_step median, generated tokens/s, peak GiB; (c) the
               serve launcher once on the card (qwen3-32b smoke, 16
               requests, 4 slots) prints its summary.  Every line carries
               the card's name and power limit;
  10. train  -- LM training (repro_torch.optim, .train, .data, .ckpt, .ft
               and .launch.train; plain torch, the path reaches no
               hand-written kernel).  (a) In f32 with TF32 off at full
               width: deepseek-v2-lite-16b cut to 2 layers (iru_hash, at
               capacity factor E / k so no lane drops; B = 2, S = 512,
               aux_weight 0): the grads and loss of make_grad_fn with remat
               "full" equal remat "none", and microbatches 2 equal 1, the
               loss within 1e-6 relative and every grad within 1e-5 of its
               leaf's largest; mamba2-130m whole, 8 steps uninterrupted
               against a Supervisor run that dies at step 6 and resumes
               from the step-4 checkpoint (under build/, with torch's
               deterministic algorithms): losses within rtol 1e-5, one
               restart, the last checkpoint restoring bit for bit; 20 steps
               on one batch with int8 moments within rtol 0.5 of fp32's,
               both falling.  (b) In bf16, remat full, on the Zipf stream:
               deepseek-v2-lite-16b at its published widths cut to 4
               layers (iru_hash, capacity factor 1.25, B = 2, S = 4096) and
               mamba2-130m whole (B = 8, S = 4096), each with fp32 then
               int8 moments: the parameter count (abstract_state on meta),
               build seconds, GiB held (params, moments), the step's
               CUDA-event median over steps 3-5 of 5, tokens/s, peak
               memory, the 5 losses (which must fall), the MoE drop rate
               and load imbalance; one profiled deepseek step split into
               forward, loss, backward (with the remat recompute) and
               optimizer by CUDA-event spans, with the device busy share.
               (c) python -m repro_torch.launch.train --arch mamba2-130m
               --steps 15 --batch 8 --seq 1024 --ckpt build/train_smoke
               --ckpt-every 5 --inject-faults as a subprocess: exit 0 and a
               train_summary.json of 15 steps, 1 restart, 1 NaN event;
  11. timings -- CUDA-event times after a warm-up for each kernel, its plain
               version (B3's plain versions: the wall seconds of their calls
               in phases 2 and 3) and one library call computing the same
               function (B2 tagged and B3 have none), the bound (bytes over
               the card's 3.35 TB/s), at PageRank's shape; B1 also at a BFS
               level's shape (the gappy quarter-node expansion) beside
               index_select; B3's round-cap body (4 partitions, add) also
               tagged and flat, beside torch.sort(stable=True) of the same
               keys (its sort stage's library counterpart);
  12. profile -- device time by kernel and the device's busy share over short
               windows of PageRank on kron-20 (sort and hash), SSSP on
               delaunay-1024, three serving ticks (fused sort and fused
               hash), and B2's and B3's kernels in one call each at
               PageRank's shape (add, and the tagged bodies);
  13. dryrun -- the LM dry run (repro_torch.launch.dryrun on the meta
               device, with the sharding layer, the meshes and the state
               shardings; plain torch, no kernel).  (a) Every shape of
               deepseek-v2-lite-16b and mamba2-130m at the 16x16 production
               mesh, and decode_32k and train_4k at 2x16x16 too (abstract
               meshes; a 2x16x16 cell's FLOPs and bytes a device must be
               half the 16x16 cell's): each cell ok or skipped, with
               its FLOPs and bytes a device, the roofline's compute and
               memory terms on the H100's data-sheet peaks, the bottleneck,
               the useful-FLOPs ratio, the analytic memory a device,
               fits_80gb and the argument bytes.  (b) The card holds the
               count: deepseek-v2-lite-16b whole in bf16 at decode (B = 8,
               cache 4128) and prefill (B = 2, S = 4096), and cut to 4
               layers for a train step (iru_hash at capacity factor 1.25,
               B = 2, S = 4096, fp32 moments, remat full): each step counted
               on meta at the host mesh, then run once on the card on real
               tensors under the same count, must give the same FLOPs and
               bytes; the arguments' bytes at the host mesh must equal the
               growth of torch.cuda.memory_allocated() while they are built,
               within 1%; each step's CUDA-event median of 5 is printed
               beside its roofline terms and the share max(t_compute,
               t_memory) / measured.  (c) deepseek-v2-lite-16b's decode
               logits under use_mesh(make_host_mesh()) equal those without a
               mesh bit for bit (deterministic algorithms on).

Each phase ends with a line of its wall seconds (``phase NAME: s``).  The
host (numpy) oracles of phases 3 and 4 run in a pool of spawned processes
from the moment the graphs exist, while the kernels compile, and phase 13
(a) (meta device, no card work) runs in a child process from the end of
phase 3; the run stops both before it ends.  It prints
the card's name and power limit, one JSON line naming the kernels with
their numbers, and last {"ok": true, "device": {...}}.  It needs one
CUDA card and exits non-zero without one, or when run outside a checkout of
the repo.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 peak (NVIDIA data sheet)
SEED = 0


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def event_ms(fn, reps: int = 10) -> float:
    """Mean CUDA-event time of ``fn`` over ``reps`` calls, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_s(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_build(dev, pool):
    """Phase 1 with the graphs: the sources compile (one nvcc each, started
    from a thread) while the graphs are built on the card, which needs no
    kernel, and then the host oracles start in ``pool``
    (``start_host_work``).  Returns the graphs and the started work."""
    import concurrent.futures

    from repro_torch.kernels import _build

    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        compiling = ex.submit(_build.build)
        graphs = make_graphs(dev)
        work = start_host_work(pool, graphs)
        seconds = compiling.result()
    print(f"build: {seconds:.3f} s ({len(_build.SOURCES)} sources, parallel "
          f"nvcc) into {_build.BUILD_DIR.relative_to(ROOT)}")
    for name in _build.SOURCES:
        log = (_build.BUILD_DIR / f"lib{name}.log")
        used = [ln.split("info    : ")[-1] for ln in log.read_text().splitlines()
                if "Used" in ln] if log.exists() else []
        print(f"  {name}: {len(used)} entry points; " + "; ".join(
            sorted(set(used))))
    return graphs, work


def make_graphs(dev):
    from repro_torch.graphs.csr import from_edges
    from repro_torch.graphs.generators import delaunay_edges, kron_edges

    graphs = {}
    for name, edges in (("kron20", lambda: kron_edges(20, 16)),
                        ("delaunay1024", lambda: delaunay_edges(1024))):
        t0 = time.perf_counter()
        src, dst, n = edges()
        w = np.random.default_rng(SEED).uniform(1.0, 64.0, src.shape[0])
        graphs[name] = from_edges(src, dst, n, w.astype(np.float32),
                                  symmetrize=True, device=dev)
        g = graphs[name]
        print(f"graph {name}: {g.n_nodes} nodes, {g.n_edges} edges, max "
              f"degree {int(g.degrees().max())}, built in "
              f"{time.perf_counter() - t0:.1f} s")
    return graphs


def phase_kernels(g):
    """Each kernel against its plain version at the main path's shapes."""
    from repro_torch.graphs.csr import expand_frontier, frontier_from_mask
    from repro_torch.kernels.coalesced_gather import ops as gather_ops
    from repro_torch.kernels.coalesced_gather.ref import (
        coalesced_gather_ref, window_contract_ok)
    from repro_torch.kernels.segment_merge import ops as merge_ops
    from repro_torch.kernels.segment_merge.ref import segment_merge_ref

    dev = g.device
    gen = torch.Generator(device=dev).manual_seed(SEED)
    # B1: real expansions' offsets (half the nodes, and a quarter: a BFS
    # level's gappy offsets) and a shuffled stream
    mask = torch.rand(g.n_nodes, generator=gen, device=dev) < 0.5
    ef = expand_frontier(g, frontier_from_mask(mask), gather="torch")
    mono = ef.eids[:int(ef.n_valid)]
    shuffled = mono[torch.randperm(mono.numel(), generator=gen, device=dev)]
    quarter = torch.rand(g.n_nodes, generator=gen, device=dev) < 0.25
    eq = expand_frontier(g, frontier_from_mask(quarter), gather="torch")
    sparse = eq.eids[:int(eq.n_valid)]
    gerr = 0.0
    for name, off in (("monotone", mono), ("sparse", sparse),
                      ("shuffled", shuffled)):
        for group, window in ((8, 128), (256, 256)):
            ok = bool(window_contract_ok(off, group=group, window=window))
            m = off.numel() // group * group
            grp = off[:m].reshape(-1, group)
            share = ((grp.max(1).values < (grp.min(1).values // window + 2)
                      * window).float().mean().item())
            d, w = gather_ops.csr_edge_gather(g.col_idx, off, g.weights,
                                              group=group, window=window)
            d1 = gather_ops.csr_edge_gather(g.col_idx, off, group=group,
                                            window=window)
            want_d = coalesced_gather_ref(g.col_idx, off)
            want_w = coalesced_gather_ref(g.weights, off)
            torch.cuda.synchronize()
            check(torch.equal(d, want_d) and torch.equal(d1, want_d)
                  and torch.equal(w, want_w),
                  f"B1 {name} ({group},{window}) equals the plain gather")
            gerr = max(gerr, (w - want_w).abs().max().item(),
                       (d.long() - want_d.long()).abs().max().item())
            print(f"B1 {name:8s} group={group:3d} window={window:3d}: "
                  f"{off.numel()} lanes, contract holds in {share:.4f} of "
                  f"groups (everywhere: {ok}), equal to plain")

    # B2: the sorted destination stream of the full expansion + active prefix
    dsts, order = torch.sort(g.col_idx, stable=True)
    srcs = g.edge_sources()[order]
    deg = g.degrees().clamp(min=1).float()
    n = dsts.numel()
    active = torch.arange(n, device=dev) < (n * 7) // 10
    contrib = (1.0 / g.n_nodes / deg)[srcs.long()]   # PageRank's payload
    relax = g.weights[order]                         # SSSP-like payload
    depth = torch.randint(0, 64, (n,), generator=gen, device=dev,
                          dtype=torch.int32)         # BFS-like payload
    merr = 0.0
    for op, vals in (("add", contrib), ("min", relax), ("min", depth),
                     ("max", relax)):
        for act in (None, active):
            got_v, got_s = merge_ops.segment_merge(dsts, vals, op=op,
                                                   active=act)
            want_v, want_s = segment_merge_ref(dsts, vals, op, act)
            torch.cuda.synchronize()
            check(torch.equal(got_s, want_s), f"B2 {op} survivors")
            if op == "add":
                check(torch.allclose(got_v, want_v, rtol=1e-5, atol=0.0),
                      "B2 add within rtol 1e-5")
            else:
                check(torch.equal(got_v, want_v), f"B2 {op} exact")
            merr = max(merr, (got_v.double() - want_v.double()).abs().max()
                       .item())
            print(f"B2 {op} {str(vals.dtype):13s} active="
                  f"{'all' if act is None else '70% prefix'}: {n} lanes, "
                  f"{int(got_s.sum())} survivors, matches plain")
    # B2's tagged body: a per-node family table, so every run is uniform-tag
    table = family_table(g)
    tags = table[dsts.long()]
    terr = 0.0
    for vals in (contrib, depth):
        for act in (None, active):
            got_v, got_s = merge_ops.segment_merge(dsts, vals, op="tagged",
                                                   active=act, tags=tags)
            want_v, want_s = segment_merge_ref(dsts, vals, "tagged", act,
                                               tags)
            torch.cuda.synchronize()
            check_tagged(got_v, want_v, tags, f"B2 tagged {vals.dtype}")
            check(torch.equal(got_s, want_s), "B2 tagged survivors")
            terr = max(terr, (got_v.double() - want_v.double()).abs().max()
                       .item())
            print(f"B2 tagged {str(vals.dtype):13s} active="
                  f"{'all' if act is None else '70% prefix'}: {n} lanes, "
                  f"{int(tags.sum())} add-family lanes, matches plain")
    # repeated calls on the hub-heavy stream: the f32 sums are deterministic
    for op, kw in (("add", {}), ("tagged", {"tags": tags})):
        first, _ = merge_ops.segment_merge(dsts, contrib, op=op, **kw)
        again, _ = merge_ops.segment_merge(dsts, contrib, op=op, **kw)
        torch.cuda.synchronize()
        diff = max_abs_err(first, again)
        print(f"B2 {op} f32, two calls on the same {n} lanes: max abs "
              f"difference {diff:.3g}")
        check(torch.equal(first, again),
              f"B2 {op}: repeated calls bit-identical")
    herr, herr_tagged, plain_s = phase_hash_kernel(g, ef, gen)
    return dsts, contrib, sparse, plain_s, {
        "coalesced_gather": gerr, "segment_merge": merr,
        "segment_merge_tagged": terr, "iru_reorder": herr,
        "iru_reorder_tagged": herr_tagged}


def family_table(g):
    """A per-node merge family for the tagged kernels' checks: node ids in
    alternate 2^17-blocks are the add family; the padding entry is min."""
    ids = torch.arange(g.n_nodes + 1, device=g.device)
    table = ((ids >> 17) & 1).bool()
    table[-1] = False
    return table


def check_tagged(got, want, tags, what):
    """Min-family lanes exactly, add-family lanes within rtol 1e-5."""
    check(torch.equal(got[~tags], want[~tags]),
          f"{what}: min-family lanes exact")
    if got.dtype.is_floating_point:
        check(torch.allclose(got[tags], want[tags], rtol=1e-5, atol=0.0),
              f"{what}: add-family lanes within rtol 1e-5")
    else:
        check(torch.equal(got[tags], want[tags]),
              f"{what}: add-family lanes exact")


def pagerank_stream(g):
    """PageRank's reorder input on ``g``: every edge's destination in CSR
    order, carrying ``rank[src] / deg[src]`` at the uniform start rank."""
    deg = g.degrees().clamp(min=1).float()
    return g.col_idx, (1.0 / g.n_nodes / deg)[g.edge_sources().long()]


def phase_hash_kernel(g, ef, gen):
    """B3 against its plain version (``kernels=False``) at full size."""
    from repro_torch.kernels.iru_reorder import ops as hash_ops

    dev = g.device
    pr_idx, pr_vals = pagerank_stream(g)
    lanes = ef.dsts.numel()
    depth = torch.randint(0, 64, (lanes,), generator=gen, device=dev,
                          dtype=torch.int32)               # BFS-like payload
    relax = torch.rand(lanes, generator=gen, device=dev) * 64  # SSSP-like
    hot = 1 << 20  # eight 32-index blocks: at most eight busy sets
    hot_idx = (torch.randint(0, 8, (hot,), generator=gen, device=dev)
               * 4096 + torch.randint(0, 32, (hot,), generator=gen,
                                      device=dev)).to(torch.int32)
    hot_vals = torch.rand(hot, generator=gen, device=dev)
    cases = [("pagerank add", pr_idx, pr_vals, "add", None),
             ("expansion min int32", ef.dsts, depth, "min", ef.n_valid),
             ("expansion min f32", ef.dsts, relax, "min", ef.n_valid),
             ("expansion no merge", ef.dsts, relax, None, ef.n_valid),
             ("eight hot sets max", hot_idx, hot_vals, "max", None)]
    herr, plain_s = 0.0, {}
    for label, idx, vals, op, n_live in cases:
        got = hash_ops.hash_reorder(idx, vals, filter_op=op, n_live=n_live)
        want, secs = wall_s(lambda: hash_ops.hash_reorder(
            idx, vals, filter_op=op, n_live=n_live, kernels=False))
        if label == "pagerank add":
            plain_s["iru_reorder"] = secs
        for field in ("indices", "positions", "active"):
            check(torch.equal(getattr(got, field), getattr(want, field)),
                  f"B3 {label}: {field} equal to plain")
        if op == "add":
            check(torch.allclose(got.secondary, want.secondary, rtol=1e-5,
                                 atol=0.0), f"B3 {label} within rtol 1e-5")
        else:
            check(torch.equal(got.secondary, want.secondary),
                  f"B3 {label} exact")
        err = (got.secondary.double() - want.secondary.double()).abs().max()
        herr = max(herr, err.item())
        live = idx.numel() if n_live is None else int(n_live)
        print(f"B3 {label:20s}: {idx.numel()} lanes ({live} live), "
              f"{int(got.active.sum())} survivors, max abs err "
              f"{err.item():.3g}, matches plain")
    # B3's tagged fold on the PageRank stream, each lane's family from the
    # per-node table; one plain call (it peels about a thousand rounds)
    table = family_table(g)
    got = hash_ops.hash_reorder(pr_idx, pr_vals, filter_op="tagged",
                                tag_table=table)
    want, plain_s["iru_reorder_tagged"] = wall_s(
        lambda: hash_ops.hash_reorder(pr_idx, pr_vals, filter_op="tagged",
                                      tag_table=table, kernels=False))
    for field in ("indices", "positions", "active"):
        check(torch.equal(getattr(got, field), getattr(want, field)),
              f"B3 tagged: {field} equal to plain")
    check_tagged(got.secondary, want.secondary, table[got.indices.long()],
                 "B3 tagged")
    terr = (got.secondary.double() - want.secondary.double()).abs().max()
    print(f"B3 tagged pagerank   : {pr_idx.numel()} lanes, "
          f"{int(got.active.sum())} survivors, max abs err {terr.item():.3g},"
          f" matches plain")
    return herr, terr.item(), plain_s


def _app_oracle(name: str, g, iters=None) -> np.ndarray:
    from repro_torch.apps import bfs, pagerank, sssp

    return (pagerank(g, iters=iters) if name == "pagerank"
            else {"bfs": bfs, "sssp": sssp}[name](g, 0))


def _app_oracle_piece(name, row_ptr, col_idx, weights, iters):
    """``_app_oracle`` in a pool worker, on a CPU copy of the graph."""
    from repro_torch.graphs.csr import CSRGraph

    g = CSRGraph(torch.from_numpy(row_ptr), torch.from_numpy(col_idx),
                 torch.from_numpy(weights))
    return _app_oracle(name, g, iters)


def host_oracle(cache: dict, name: str, gname: str, g, iters=None):
    """The host (numpy) oracle of app ``name`` on graph ``gname``, computed
    once a run (PageRank at ``iters`` iterations) and kept in ``cache``
    (where ``start_host_work`` may have started it in the pool)."""
    key = (name, gname, iters)
    if key not in cache:
        cache[key] = _app_oracle(name, g, iters)
    elif hasattr(cache[key], "result"):
        cache[key] = cache[key].result()
    return torch.from_numpy(cache[key]).to(g.device)


# the plain hash engine peels about a thousand occupancy rounds a call at
# PageRank's shape (6.5 s an iteration) and the plain paths of the
# delaunay-1024 traversals run a thousand levels or more: their plain-path
# comparison is cut to these depths (the kernel path runs the same depth
# for it, and in full against the host oracle), which keeps the whole
# script well inside its 1200 s on a slow host
PLAIN_DEPTH = {("hash", "pagerank", "kron20"): 1,
               ("hash", "bfs", "kron20"): 3,
               ("hash", "sssp", "kron20"): 2,
               ("hash", "bfs", "delaunay1024"): 100,
               ("hash", "sssp", "delaunay1024"): 100,
               ("sort", "sssp", "delaunay1024"): 100}


def phase_apps(graphs, oracles):
    from repro_torch.apps.bfs import BFS_APP
    from repro_torch.apps.pagerank import pagerank_app
    from repro_torch.apps.sssp import SSSP_APP
    from repro_torch.core import CapacityPolicy, FrontierPipeline
    from repro_torch.kernels import launch_counts, reset_launch_counts

    policy = CapacityPolicy(n_buckets=3)
    path = {"sort": ("coalesced_gather", "segment_merge"),
            "hash": ("coalesced_gather", "iru_reorder")}
    runs = [(mode, name, gname, app)
            for mode in ("sort", "hash")
            for name, gname, app in (
                ("bfs", "kron20", BFS_APP),
                ("sssp", "kron20", SSSP_APP),
                ("bfs", "delaunay1024", BFS_APP),
                ("sssp", "delaunay1024", SSSP_APP),
                ("pagerank", "kron20", None))]
    # warm-up: first launches load the libraries and CUDA modules
    for mode in path:
        FrontierPipeline(graphs["kron20"], BFS_APP, mode=mode,
                         capacity_policy=policy, max_iters=2).run(0)
    totals = {"coalesced_gather": 0, "segment_merge": 0, "iru_reorder": 0}
    for mode, name, gname, app in runs:
        g = graphs[gname]
        iters = None
        if name == "pagerank":
            iters = 20
            app = pagerank_app(iters)
        kernel_pipe = FrontierPipeline(g, app, mode=mode,
                                       capacity_policy=policy,
                                       max_iters=iters)
        reset_launch_counts()
        got, t_kernel = wall_s(lambda: kernel_pipe.run(0))
        counts = {k: launch_counts[k] for k in totals}
        for k in path[mode]:
            check(counts[k] > 0, f"{mode} {name} on {gname} launched {k}")
        for k, v in counts.items():
            totals[k] += v
        depth = PLAIN_DEPTH.get((mode, name, gname))
        plain_pipe = FrontierPipeline(g, app, mode=mode,
                                      capacity_policy=policy,
                                      max_iters=depth or iters, kernels=False)
        want, t_plain = wall_s(lambda: plain_pipe.run(0))
        mine = got
        if depth:  # the kernel path at the plain path's depth
            mine = FrontierPipeline(g, app, mode=mode, capacity_policy=policy,
                                    max_iters=depth).run(0)
        host = host_oracle(oracles, name, gname, g, iters)
        if name == "pagerank":
            check(torch.allclose(mine, want, rtol=1e-5, atol=0.0),
                  f"{mode} pagerank kernel path within rtol 1e-5 of the "
                  f"plain path")
            check(torch.allclose(got, host, rtol=1e-4, atol=0.0),
                  f"{mode} pagerank within rtol 1e-4 of the host oracle")
            check(bool(torch.isfinite(got).all()), "finite ranks")
        else:
            check(torch.equal(mine, want),
                  f"{mode} {name} equals the plain path")
            check(torch.equal(got, host),
                  f"{mode} {name} equals the host oracle")
        edges = g.n_edges * (iters if name == "pagerank" else 1)
        print(f"app {mode} {name:8s} {gname:12s}"
              f"{f' ({iters} iterations)' if iters else ''}: kernel path "
              f"{t_kernel:.3f} s ({edges / t_kernel:.4g} edges/s), plain "
              f"path {t_plain:.3f} s"
              f"{f' (first {depth} iterations)' if depth else ''}, launches "
              f"{counts}, {kernel_pipe.n_hops} bucket hops, host oracle "
              f"agrees")
    return totals


# The paper's evaluation at the size users run: each generator at the size
# of the graph it imitates (a name: that graph of make_graphs).
FULL_SIZE = (("ca", dict(scale=1024), "roadNet-CA"),
             ("cond", dict(n=40_000), "cond-mat-2005"),
             ("delaunay", "delaunay1024", "delaunay_n20"),
             ("human", dict(n=22_000), "human_gene1"),
             ("kron", "kron20", "kron_g500-logn20"),
             ("msdoor", dict(scale=75), "msdoor"))
FIG_ROWS = {  # figure module -> the per-cell keys it prints
    "fig4_overhead": ("iru_service_frac", "normalized_total"),
    "fig11_accesses": ("l1_ratio", "l2_ratio"),
    "fig12_noc": ("noc_ratio",),
    "fig13_perf_energy": ("speedup", "energy_ratio"),
    "fig14_coalescing": ("baseline_acc_per_warp", "iru_acc_per_warp",
                         "improvement"),
    "fig15_filter": ("filtered_frac",),
}


def same_trace(got, want) -> bool:
    """Two TraceRecorders hold the same events and IRU element count."""
    if got.iru_elements != want.iru_elements or len(got.events) != len(
            want.events):
        return False
    for (gi, ga, gat), (wi, wa, wat) in zip(got.events, want.events):
        if not (gi.dtype == wi.dtype and np.array_equal(gi, wi)
                and np.array_equal(ga, wa) and gat == wat):
            return False
    return True


def figures_at_harness_scale(dev):
    """Part (a): all 18 cells of the figure harness (DATASET_KW) with the IRU
    traces taken through kernel B3's windowed body (engine="hash"), each
    held against the same cell through the numpy oracle (engine="hash_ref"),
    then the six figures' rows.  Returns the launch counts."""
    import importlib
    import tempfile

    from repro_torch.apps.trace import TraceRecorder
    from repro_torch.figures import common
    from repro_torch.kernels import launch_counts, reset_launch_counts

    totals = {}
    t0 = time.perf_counter()
    for algo in common.ALGOS:
        for ds in common.DATASET_KW:
            g = common.make_dataset(ds, device=dev, **common.dataset_kw(ds))
            rec, ref = TraceRecorder(), TraceRecorder()
            reset_launch_counts()
            got, secs = wall_s(lambda: common._run(algo, g, "iru", rec,
                                                   engine="hash", device=dev))
            counts = dict(launch_counts)
            want = common._run(algo, g, "iru", ref, engine="hash_ref",
                               device=dev)
            check(counts.get("iru_reorder_windowed", 0) == len(rec.events),
                  f"figure cell {algo}/{ds}: one B3 windowed launch a "
                  f"reorder ({counts} for {len(rec.events)} events)")
            for k, v in counts.items():
                totals[k] = totals.get(k, 0) + v
            check(same_trace(rec, ref), f"figure cell {algo}/{ds}: the B3 "
                  f"trace equals the oracle's (events, active, atomic, "
                  f"iru_elements)")
            note = "equal"
            if algo == "pr" and not np.array_equal(got.view(np.int32),
                                                   want.view(np.int32)):
                diff = float(np.abs(got.astype(np.float64) - want).max())
                note = f"max abs diff {diff:.3g} (rtol 1e-6)"
                check(np.allclose(got, want, rtol=1e-6, atol=0.0),
                      f"figure cell pr/{ds}: within rtol 1e-6 of the oracle")
            elif algo != "pr":
                check(np.array_equal(got, want),
                      f"figure cell {algo}/{ds}: result equals the oracle's")
            lanes = sum(len(i) for i, _, _ in rec.events)
            print(f"figure cell {algo:4s} {ds:8s}: {g.n_nodes} nodes, "
                  f"{g.n_edges} edges; B3 trace {len(rec.events)} events, "
                  f"{lanes} lanes, {secs:.3f} s, launches {counts}; equal "
                  f"to the hash_ref trace, result {note}")
    t_traces = time.perf_counter() - t0
    kept = common.RESULTS
    with tempfile.TemporaryDirectory() as cache:
        common.RESULTS = cache  # a fresh cache: every cell runs on the card
        reset_launch_counts()
        t0 = time.perf_counter()
        try:
            rows = {fig: importlib.import_module(
                f"repro_torch.figures.{fig}").run(engine="hash", device=dev)
                for fig in FIG_ROWS}
        finally:
            common.RESULTS = kept
        t_rows = time.perf_counter() - t0
    for k, v in launch_counts.items():
        totals[k] = totals.get(k, 0) + v
    check(launch_counts.get("iru_reorder_windowed", 0) > 0,
          "the figure drivers' IRU traces launched B3's windowed body")
    cells = {}
    for fig, keys in FIG_ROWS.items():
        for r in rows[fig]:
            if not r["algo"].startswith("MEAN"):
                cells.setdefault((r["algo"], r["dataset"]), []).append(
                    f"{fig.split('_')[0]} " + " ".join(
                        f"{k} {r[k]}" for k in keys))
    for (algo, ds), parts in cells.items():
        print(f"figure row {algo:4s} {ds:8s}: " + "; ".join(parts))
    for fig, keys in FIG_ROWS.items():
        for r in rows[fig]:
            if r["algo"].startswith("MEAN"):
                print(f"figure {fig} {r['algo']}: " + ", ".join(
                    f"{k} {r[k]}" for k in keys))
    print(f"figures (a): cost-model counts of a GTX 980 model over traces "
          f"taken on this card, not measurements of it; traces and oracle "
          f"checks {t_traces:.1f} s, the six drivers {t_rows:.1f} s")
    return totals


class CountingRecorder:
    """A TraceRecorder that reduces each event on the card as it arrives
    (Fig. 14's requests and warps, Fig. 15's lanes and active lanes) and
    drops it: a full-size trace kept whole would not fit the host."""

    def __init__(self):
        self.requests = self.warps = self.lanes = self.active = 0
        self.events = self.iru_elements = 0

    def access(self, indices, active=None, atomic: bool = False) -> None:
        from repro_torch.core.coalescing import accesses_per_group

        per = accesses_per_group(indices, active)
        act = (torch.ones_like(indices, dtype=torch.bool) if active is None
               else active)
        req, warps, live = torch.stack([per.sum(), (per > 0).sum(),
                                        act.sum()]).tolist()
        self.requests += req
        self.warps += warps
        self.active += live
        self.lanes += indices.numel()
        self.events += 1

    def processed(self, n: int) -> None:
        self.iru_elements += int(n)

    @property
    def per_warp(self) -> float:
        return self.requests / max(self.warps, 1)


def figures_at_full_size(graphs, oracles, dev):
    """Part (b): Figs. 14 and 15 on the six datasets at the size of the
    graphs they imitate, traced through FrontierPipeline.run_instrumented
    (B1, and with IRU_HASH B3's windowed body) and counted on the card.
    Returns the launch counts."""
    from repro_torch.apps.bfs import BFS_APP
    from repro_torch.apps.pagerank import pagerank_app
    from repro_torch.apps.sssp import SSSP_APP
    from repro_torch.core import CapacityPolicy, FrontierPipeline, IRUConfig
    from repro_torch.figures.common import geomean
    from repro_torch.graphs.generators import make_dataset
    from repro_torch.kernels import launch_counts, reset_launch_counts

    policy = CapacityPolicy(n_buckets=3)
    cfg = IRUConfig(**IRU_HASH)
    apps = (("bfs", lambda: BFS_APP, None), ("sssp", lambda: SSSP_APP, None),
            ("pr", lambda: pagerank_app(5), 5))
    totals, improvement, filtered = {}, {}, {}
    for ds, kw, imitates in FULL_SIZE:
        t0 = time.perf_counter()
        own = isinstance(kw, str)
        g = graphs[kw] if own else make_dataset(ds, device=dev, **kw)
        t_gen = time.perf_counter() - t0
        for algo, app, iters in apps:
            recs, res, walls, launched = {}, {}, {}, {}
            for mode in ("baseline", "hash"):
                pipe = FrontierPipeline(g, app(), mode=mode,
                                        iru_config=cfg if mode == "hash"
                                        else None, capacity_policy=policy,
                                        max_iters=iters, device=dev)
                rec = CountingRecorder()
                reset_launch_counts()
                res[mode], walls[mode] = wall_s(
                    lambda: pipe.run_instrumented(0, recorder=rec))
                counts = dict(launch_counts)
                for k, v in counts.items():
                    totals[k] = totals.get(k, 0) + v
                path = ("coalesced_gather",) + (
                    ("iru_reorder_windowed",) if mode == "hash" else ())
                for k in path:
                    check(counts.get(k, 0) >= rec.events,
                          f"figure {algo}/{ds} {mode}: {k} launched at least "
                          f"once a step ({counts}, {rec.events} steps)")
                if mode == "hash":
                    check(counts.get("iru_reorder_windowed", 0) == rec.events,
                          f"figure {algo}/{ds}: one B3 windowed launch a step")
                    check(rec.iru_elements == rec.lanes,
                          f"figure {algo}/{ds}: iru_elements equals the "
                          f"steps' live edges")
                whole = pipe.run(0)
                if algo == "pr":
                    check(torch.allclose(res[mode], whole, rtol=1e-5,
                                         atol=0.0),
                          f"figure pr/{ds} {mode}: instrumented within rtol "
                          f"1e-5 of run()")
                else:
                    check(torch.equal(res[mode], whole),
                          f"figure {algo}/{ds} {mode}: instrumented equals "
                          f"run()")
                recs[mode], launched[mode] = rec, counts
            base, iru = recs["baseline"], recs["hash"]
            check(base.lanes == iru.lanes and base.events == iru.events,
                  f"figure {algo}/{ds}: the IRU trace has the baseline's "
                  f"steps and lanes")
            agree = "hash equals baseline"
            if algo == "pr":
                err = rel_err(res["hash"].cpu().numpy(),
                              res["baseline"].cpu().numpy())
                agree = f"hash against baseline max rel err {err:.3g}"
                check(torch.allclose(res["hash"], res["baseline"], rtol=1e-5,
                                     atol=0.0),
                      f"figure pr/{ds}: hash within rtol 1e-5 of baseline "
                      f"(max relative error {err:.3g})")
            else:
                check(torch.equal(res["hash"], res["baseline"]),
                      f"figure {algo}/{ds}: hash equals baseline")
                if own:
                    host = host_oracle(oracles, algo, kw, g)
                    check(torch.equal(res["hash"], host),
                          f"figure {algo}/{ds}: equals the host oracle")
            imp = base.per_warp / max(iru.per_warp, 1e-9)
            frac = 1.0 - iru.active / max(iru.lanes, 1)
            improvement[algo, ds], filtered[algo, ds] = imp, frac
            print(f"figure full {algo:4s} {ds:8s} ({imitates}): "
                  f"{g.n_nodes} nodes, {g.n_edges} edges, {iru.events} "
                  f"iterations; accesses per warp baseline "
                  f"{base.per_warp:.4f}, IRU {iru.per_warp:.4f}, improvement"
                  f" {imp:.4f}, filtered {frac:.4f}; trace wall baseline "
                  f"{walls['baseline']:.3f} s, IRU {walls['hash']:.3f} s; "
                  f"launches baseline {launched['baseline']}, IRU "
                  f"{launched['hash']}; {agree}"
                  + (f"; graph built in {t_gen:.1f} s" if algo == "bfs"
                     else ""))
    merged = [v for (a, _), v in improvement.items() if a != "bfs"]
    print(f"figure full fig14 MEAN: improvement geomean "
          f"{geomean(list(improvement.values())):.4f} over all 18 cells, "
          f"{geomean(merged):.4f} over SSSP and PageRank")
    print(f"figure full fig15 MEAN: filtered "
          f"{np.mean([v for (a, _), v in filtered.items() if a != 'bfs']):.4f}"
          f" over SSSP and PageRank")
    print("figures (b): measured from traces taken on this card; the "
          "pipeline's BFS merges duplicate destinations (filter_op='min'), "
          "the harness's host BFS does not, so (b)'s BFS rows are not "
          "comparable cell by cell with (a)'s")
    return totals


def phase_figures(graphs, oracles):
    """The paper's evaluation path: (a) the six figure drivers at their own
    scale with B3's traces held against the oracle's, (b) Figs. 14 and 15
    at full size through the instrumented pipeline, (c) the dense
    whole-run apps.  Returns the launch counts."""
    from repro_torch.apps.bfs import bfs_jit
    from repro_torch.apps.pagerank import pagerank_jit
    from repro_torch.kernels import launch_counts, reset_launch_counts

    dev = graphs["kron20"].device
    t0 = time.perf_counter()
    totals = figures_at_harness_scale(dev)
    t_a = time.perf_counter() - t0
    for k, v in figures_at_full_size(graphs, oracles, dev).items():
        totals[k] = totals.get(k, 0) + v
    t_b = time.perf_counter() - t0 - t_a
    for gname in ("kron20", "delaunay1024"):
        g = graphs[gname]
        label, secs = wall_s(lambda: bfs_jit(g, 0, device=dev))
        check(torch.equal(label, host_oracle(oracles, "bfs", gname, g)),
              f"bfs_jit on {gname} equals the host oracle")
        print(f"bfs_jit {gname}: {secs:.3f} s, equals the host oracle")
    g = graphs["kron20"]
    reset_launch_counts()
    rank, secs = wall_s(lambda: pagerank_jit(
        g.edge_sources(), g.col_idx, g.degrees(), g.n_nodes, iters=20,
        use_iru=True, device=dev))
    counts = dict(launch_counts)
    check(counts.get("segment_merge", 0) >= 20,
          f"pagerank_jit launched B2 once an iteration ({counts})")
    for k, v in counts.items():
        totals[k] = totals.get(k, 0) + v
    host = host_oracle(oracles, "pagerank", "kron20", g, 20)
    check(torch.allclose(rank, host, rtol=1e-4, atol=1e-7),
          "pagerank_jit (use_iru) within rtol 1e-4, atol 1e-7 of the host "
          "oracle")
    print(f"pagerank_jit kron20 (20 iterations, use_iru): {secs:.3f} s, "
          f"launches {counts}, max abs diff from the host oracle "
          f"{max_abs_err(rank, host):.3g}")
    print(f"phase figures: (a) {t_a:.1f} s, (b) {t_b:.1f} s, total "
          f"{time.perf_counter() - t0:.1f} s")
    return totals


SERVING_RUNS = (  # label, fused, mode, kernels, kernels the run must launch,
    # the IRU geometry (None: the default config's)
    ("fused baseline", True, "baseline", True, ("coalesced_gather",), None),
    ("fused sort", True, "sort", True,
     ("coalesced_gather", "segment_merge_tagged"), None),
    ("fused hash", True, "hash", True,
     ("coalesced_gather", "iru_reorder_tagged"), None),
    ("split hash", False, "hash", True, ("coalesced_gather", "iru_reorder"),
     None),
    ("fused sort plain", True, "sort", False, (), None),
    # the paper's geometries, served tagged
    ("fused hash IRU_HASH", True, "hash", True,
     ("coalesced_gather", "iru_reorder_windowed"), "IRU_HASH"),
    ("fused hash 4x2 cap", True, "hash", True,
     ("coalesced_gather", "iru_reorder_round_cap"), "ROUND_CAP_4X2"),
)


def rel_err(got: np.ndarray, want: np.ndarray) -> float:
    """Largest |got - want| / |want| over the entries where want != 0."""
    nz = want != 0
    if not nz.any():
        return 0.0
    return float(np.max(np.abs(got[nz].astype(np.float64) - want[nz])
                        / np.abs(want[nz].astype(np.float64))))


def serving_queries(g):
    """The serving mix: 4 BFS, 4 SSSP and 4 PPR (20 iterations, damping
    0.85) from seeded sources of nonzero degree, interleaved."""
    from repro_torch.serve import GraphQuery

    nonzero = np.flatnonzero(g.degrees().cpu().numpy() > 0)
    srcs = np.random.default_rng(SEED).choice(nonzero, 12, replace=False)
    kinds = ("bfs", "sssp", "ppr") * 4
    return [GraphQuery(kind, int(src), iters=20, damping=0.85)
            for kind, src in zip(kinds, srcs)]


def serving_streams(view, g):
    """One extra fused sort run of the serving mix with the reorder stage
    wrapped (untimed, its launches not counted).  Of its top-rung ticks it
    keeps the one with the most live lanes (the sorted stream that B2's
    tagged body merged) and the one with the fewest (the expansion stream
    and ``n_live`` that B3's tagged fold takes in hash mode: B3's plain
    version takes time in proportion to live lanes times width)."""
    from repro_torch.core import filter as filt
    from repro_torch.core import pipeline
    from repro_torch.serve import GraphServeConfig, GraphServingEngine

    most, least = {"live": -1}, {"live": view.n_edges + 1}
    merged = {}
    reorder, merge = pipeline.iru_reorder, filt.merge_sorted

    def merge_spy(*args):
        merged["args"] = args
        return merge(*args)

    def reorder_spy(indices, secondary, **kw):
        out = reorder(indices, secondary, **kw)
        sorted_args, live = merged.pop("args"), int(kw["n_live"])
        if indices.numel() == view.n_edges:
            if live > most["live"]:
                most.update(live=live, stream=sorted_args)
            if live < least["live"]:
                least.update(live=live, stream=(
                    indices, secondary, kw["n_live"], kw["tag_table"]))
        return out

    pipeline.iru_reorder, filt.merge_sorted = reorder_spy, merge_spy
    try:
        eng = GraphServingEngine(view, GraphServeConfig(mode="sort"))
        for q in serving_queries(g):
            eng.submit(q)
        eng.run_to_completion(1000)
    finally:
        pipeline.iru_reorder, filt.merge_sorted = reorder, merge
    del eng
    check(most["live"] >= 0, "a serving tick ran at the top rung")
    return most, least


def max_abs_err(got, want) -> float:
    """Largest |got - want|, equal entries (infinities too) counting 0."""
    return torch.where(got == want, 0.0, got.double() - want.double()
                       ).abs().max().item()


def phase_serving_kernels(view, g):
    """B2's tagged body and B3's tagged fold on serving ticks at the top
    rung (8 m lanes), against their plain versions: the lane and offset
    arithmetic at the size the serving path runs."""
    from repro_torch.kernels.iru_reorder import ops as hash_ops
    from repro_torch.kernels.segment_merge import ops as merge_ops
    from repro_torch.kernels.segment_merge.ref import segment_merge_ref

    most, least = serving_streams(view, g)
    idx, vals, _, live_s, tags = most.pop("stream")
    lanes = idx.numel()
    got_v, got_s = merge_ops.segment_merge(idx, vals, op="tagged",
                                           active=live_s, tags=tags)
    want_v, want_s = segment_merge_ref(idx, vals, "tagged", live_s, tags)
    torch.cuda.synchronize()
    check_tagged(got_v, want_v, tags, "B2 tagged serving tick")
    check(torch.equal(got_s, want_s), "B2 tagged serving tick survivors")
    b2_err = max_abs_err(got_v, want_v)
    b2_ms = event_ms(lambda: merge_ops.segment_merge(
        idx, vals, op="tagged", active=live_s, tags=tags), reps=3)
    print(f"B2 tagged serving tick: {lanes} lanes ({most['live']} live), "
          f"{int(got_s.sum())} survivors, max abs err {b2_err:.3g}, matches "
          f"plain; kernel {b2_ms:.4f} ms")
    profile_window("B2 tagged on the serving tick, one call",
                   lambda: merge_ops.segment_merge(
                       idx, vals, op="tagged", active=live_s, tags=tags))
    del idx, vals, live_s, tags, got_v, got_s, want_v, want_s
    torch.cuda.empty_cache()
    idx, vals, n_live, table = least.pop("stream")
    got = hash_ops.hash_reorder(idx, vals, filter_op="tagged",
                                tag_table=table, n_live=n_live)
    b3_ms = event_ms(lambda: hash_ops.hash_reorder(
        idx, vals, filter_op="tagged", tag_table=table, n_live=n_live),
        reps=3)
    want, t_plain = wall_s(lambda: hash_ops.hash_reorder(
        idx, vals, filter_op="tagged", tag_table=table, n_live=n_live,
        kernels=False))
    for field in ("indices", "positions", "active"):
        check(torch.equal(getattr(got, field), getattr(want, field)),
              f"B3 tagged serving tick: {field} equal to plain")
    check_tagged(got.secondary, want.secondary, table[got.indices.long()],
                 "B3 tagged serving tick")
    b3_err = max_abs_err(got.secondary, want.secondary)
    # every lane's 8 B read and 13 B written, and the tag table read once
    bound_ms = (21 * idx.numel() + table.numel()) / HBM_BYTES_PER_S * 1e3
    print(f"B3 tagged serving tick: {lanes} lanes ({least['live']} live), "
          f"{int(got.active.sum())} survivors, max abs err {b3_err:.3g}, "
          f"matches plain; kernel {b3_ms:.4f} ms, bound {bound_ms:.4f} ms, "
          f"plain {t_plain:.1f} s")
    return {"segment_merge_tagged": b2_err, "iru_reorder_tagged": b3_err}


def phase_serving(g):
    """Multi-tenant serving on tile_csr(kron-20, 8) in seven runs (see the
    module docstring), then the tagged kernels on a serving tick's streams.
    Returns the launch counts summed over the seven runs, the tagged
    kernels' largest errors there and the fused sort and hash runs'
    queries."""
    from repro_torch.apps import bfs, sssp
    from repro_torch.core.iru import IRUConfig
    from repro_torch.graphs.csr import tile_csr
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import GraphServeConfig, GraphServingEngine

    cfg = GraphServeConfig()
    view, t_tile = wall_s(lambda: tile_csr(g, cfg.query_slots))
    print(f"serving graph tile_csr(kron20, {cfg.query_slots}): "
          f"{view.n_nodes} nodes, {view.n_edges} edges, tiled in "
          f"{t_tile:.3f} s; edge budget {cfg.query_slots * g.n_edges} lanes")
    totals = {}
    results = {}
    for label, fused, mode, kernels, path, geo in SERVING_RUNS:
        iru_config = (None if geo is None else
                      IRUConfig(mode="hash", **globals()[geo]))
        eng = GraphServingEngine(view, GraphServeConfig(
            fused=fused, mode=mode, kernels=kernels, iru_config=iru_config))
        qs = serving_queries(g)
        for q in qs:
            eng.submit(q)
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        _, wall = wall_s(lambda: eng.run_to_completion(1000))
        counts = dict(launch_counts)
        peak = torch.cuda.max_memory_allocated()
        for k in path:
            check(counts.get(k, 0) > 0, f"serving {label} launched {k}")
        if not kernels:
            check(not any(counts.values()),
                  f"serving {label} launched no kernel")
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        for q in qs:
            check(q.status == "done", f"serving {label}: query {q.qid} "
                  f"({q.kind}) done, got {q.status} ({q.error})")
        print(f"serving {label:16s}: {len(qs)} queries in {wall:.3f} s "
              f"({len(qs) / wall:.4g} queries/s), {eng.tick_no} ticks, "
              f"{eng.overflow_events} overflow events, {eng.quarantines} "
              f"quarantines, launches {counts}, peak device memory "
              f"{peak / 2**30:.2f} GiB")
        if kernels:
            worst = 0.0
            for q in qs:
                solo = eng.solo_reference(q)
                if q.kind == "ppr":
                    worst = max(worst, rel_err(q.result, solo))
                    check(np.allclose(q.result, solo, rtol=1e-5, atol=0.0),
                          f"serving {label}: ppr {q.qid} within rtol 1e-5 "
                          f"of solo (max relative error "
                          f"{rel_err(q.result, solo):.3g})")
                else:
                    check(np.array_equal(q.result, solo),
                          f"serving {label}: {q.kind} {q.qid} equals solo")
            print(f"  BFS/SSSP equal their solo runs; PPR max relative error "
                  f"against solo {worst:.3g}")
        results[label] = qs
        del eng
        torch.cuda.empty_cache()
    for a, b in zip(results["fused sort"], results["fused sort plain"]):
        if a.kind == "ppr":
            print(f"  ppr {a.qid}: fused sort against its plain twin, max "
                  f"relative error {rel_err(a.result, b.result):.3g}")
            check(np.allclose(a.result, b.result, rtol=1e-5, atol=0.0),
                  f"serving ppr {a.qid}: kernels within rtol 1e-5 of plain")
        else:
            check(np.array_equal(a.result, b.result),
                  f"serving {a.kind} {a.qid}: kernels equal plain")
    qs = results["fused hash"]
    first_bfs = next(q for q in qs if q.kind == "bfs")
    first_sssp = next(q for q in qs if q.kind == "sssp")
    check(np.array_equal(first_bfs.result, bfs(g, first_bfs.source)),
          "serving bfs equals the host oracle")
    check(np.array_equal(first_sssp.result, sssp(g, first_sssp.source)),
          "serving sssp equals the host oracle")
    print("serving: every query done; BFS/SSSP equal solo runs (and the "
          "host oracles), PPR within rtol 1e-5 of solo; fused sort equals "
          "its plain twin")
    fused = {k: results[k] for k in ("fused sort", "fused hash")}
    del results, qs
    torch.cuda.empty_cache()
    errors = phase_serving_kernels(view, g)
    del view
    torch.cuda.empty_cache()
    return totals, errors, fused


# the kernels a partitioned run must launch on every shard, by mode
SHARD_PATH = {"baseline": ("coalesced_gather",),
              "sort": ("coalesced_gather", "segment_merge"),
              "hash": ("coalesced_gather", "iru_reorder"),
              "IRU_HASH": ("coalesced_gather", "iru_reorder_windowed"),
              "fused sort": ("coalesced_gather", "segment_merge_tagged"),
              "fused hash": ("coalesced_gather", "iru_reorder_tagged")}


class ShardLaunches:
    """Launch counts split by shard: wraps the partitioned superstep's
    per-shard ``frontier_scatter`` and charges each call's new launches to
    its shard (shards numbered in the order first seen)."""

    def __init__(self):
        from repro_torch.dist import graph_partition
        from repro_torch.kernels import launch_counts

        self.module, self.counts = graph_partition, launch_counts
        self.scatter = graph_partition.frontier_scatter
        self.shard: dict[int, int] = {}
        self.per_shard: list[dict] = []

    def __enter__(self):
        def spy(g, *args, **kw):
            before = dict(self.counts)
            out = self.scatter(g, *args, **kw)
            if id(g) not in self.shard:
                self.shard[id(g)] = len(self.per_shard)
                self.per_shard.append({})
            mine = self.per_shard[self.shard[id(g)]]
            for k, v in self.counts.items():
                if v != before.get(k, 0):
                    mine[k] = mine.get(k, 0) + v - before.get(k, 0)
            return out

        self.module.frontier_scatter = spy
        return self

    def __exit__(self, *exc):
        self.module.frontier_scatter = self.scatter

    def check(self, need, n_parts: int, what: str) -> list[dict]:
        check(len(self.per_shard) == n_parts,
              f"{what}: {len(self.per_shard)} of {n_parts} shards stepped")
        for p, counts in enumerate(self.per_shard):
            for k in need:
                check(counts.get(k, 0) > 0,
                      f"{what}: shard {p} launched {k}")
        return self.per_shard


def build_partition(g, n_parts: int, label: str):
    from repro_torch.graphs.csr import partition_csr

    out, t_build = wall_s(lambda: partition_csr(g, n_parts))
    part = getattr(out, "part", out)
    print(f"partition {label} P={n_parts}: built on the card in "
          f"{t_build:.3f} s, {part.nbytes() / 2**30:.3f} GiB on the device; "
          f"block {part.block}, ghost_cap {part.ghost_cap}, lane_cap "
          f"{part.lane_cap}, edge_cap {part.edge_cap}")
    return out


def phase_partitioned(graphs, oracles, served):
    """The edge-partitioned pipeline and partitioned serving, every shard on
    the card, stepped in turn (see the module docstring).  ``served`` maps
    phase 6's fused serving labels to their queries, the single-device
    results partitioned serving must equal.  Returns the launch counts and
    the kron-20 hash-mode runs (result on the host, supersteps, traffic,
    wall seconds by (app, compress); and the single-device BFS), which the
    group phase holds its ranks against."""
    from repro_torch.apps.bfs import BFS_APP
    from repro_torch.apps.pagerank import pagerank_app
    from repro_torch.apps.sssp import SSSP_APP
    from repro_torch.core import CapacityPolicy, FrontierPipeline, IRUConfig
    from repro_torch.dist import (PartitionedFrontierPipeline,
                                  partitioned_bfs_app,
                                  partitioned_pagerank_app,
                                  partitioned_sssp_app)
    from repro_torch.kernels import launch_counts, reset_launch_counts

    totals: dict = {}

    def count(what, shards, need, n_parts):
        counts = shards.check(need, n_parts, what)
        for k, v in launch_counts.items():
            totals[k] = totals.get(k, 0) + v
        return counts

    g = graphs["kron20"]
    part = build_partition(g, 4, "kron20")
    apps = {"bfs": (BFS_APP, partitioned_bfs_app, {}),
            "sssp": (SSSP_APP, partitioned_sssp_app, {}),
            "pagerank": (pagerank_app(20), partitioned_pagerank_app,
                         {"iters": 20})}
    runs = [(name, mode, compress) for name in apps
            for mode in ("baseline", "sort", "hash")
            for compress in (False, True)] + [("pagerank", "IRU_HASH", False)]
    single, kept = {}, {"partition bytes": part.nbytes()}
    for name, mode, compress in runs:
        app, make, kw = apps[name]
        cfg = IRUConfig(**IRU_HASH) if mode == "IRU_HASH" else None
        pmode = "hash" if mode == "IRU_HASH" else mode
        iters = kw.get("iters")
        if (name, mode) not in single:
            single[(name, mode)] = wall_s(lambda: FrontierPipeline(
                g, app, mode=pmode, iru_config=cfg, max_iters=iters).run(0))
        want, t_single = single[(name, mode)]
        pipe = PartitionedFrontierPipeline(
            part, make(part, **kw), mode=pmode, iru_config=cfg,
            compress=compress, max_iters=iters)
        reset_launch_counts()
        with ShardLaunches() as shards:
            got, wall = wall_s(lambda: pipe.run(0))
        what = (f"partitioned kron20 {name} {mode} compress={compress} "
                f"(codec {pipe.codec})")
        shard_counts = count(what, shards, SHARD_PATH[mode], 4)
        extra = ""
        if name == "pagerank":
            tol = 2e-3 if pipe.codec == "int8_ef" else 1e-4
            err = (got - want).abs()
            rel = rel_err(got.cpu().numpy(), want.cpu().numpy())
            l1 = (err.sum() / want.abs().sum()).item()
            check(torch.allclose(got, want, rtol=tol, atol=tol),
                  f"{what}: within rtol = atol = {tol} of single-device")
            if pipe.codec == "exact":
                check(torch.allclose(got, want, rtol=tol, atol=0.0),
                      f"{what}: within rtol {tol} (atol 0) of single-device")
            check(bool(torch.isfinite(got).all()), f"{what}: finite ranks")
            extra = (f"; against single-device max abs err "
                     f"{err.max().item():.3g}, max rel err {rel:.3g}, L1 "
                     f"rel err {l1:.3g} (mean rank {1 / g.n_nodes:.3g})")
        else:
            check(torch.equal(got, want), f"{what}: equals single-device")
            check(torch.equal(got, host_oracle(oracles, name, "kron20", g)),
                  f"{what}: equals the host oracle")
            extra = "; equals single-device and the host oracle"
        traffic = pipe.boundary_traffic()
        if mode == "hash":
            kept[(name, compress)] = (got.cpu(), pipe.supersteps, traffic,
                                      wall)
        print(f"{what}: {pipe.supersteps} supersteps, {pipe.n_hops} hops, "
              f"{wall:.3f} s (single-device {t_single:.3f} s), boundary "
              f"raw {traffic['raw_bytes_per_superstep']} B / wire "
              f"{traffic['wire_bytes_per_superstep']} B per superstep, "
              f"launches per shard {shard_counts}{extra}")
    kept["single bfs"] = single[("bfs", "hash")][0].cpu()
    del single
    torch.cuda.empty_cache()

    # delaunay-1024: a thousand supersteps hopping the rungs
    gd = graphs["delaunay1024"]
    dpart = build_partition(gd, 4, "delaunay1024")
    policy = CapacityPolicy(n_buckets=3)
    want, t_single = wall_s(lambda: FrontierPipeline(
        gd, BFS_APP, mode="hash", capacity_policy=policy).run(0))
    pipe = PartitionedFrontierPipeline(
        dpart, partitioned_bfs_app(dpart), mode="hash", compress=True,
        capacity_policy=policy)
    reset_launch_counts()
    with ShardLaunches() as shards:
        got, wall = wall_s(lambda: pipe.run(0))
    what = "partitioned delaunay1024 bfs hash compress=True (codec flag)"
    shard_counts = count(what, shards, SHARD_PATH["hash"], 4)
    check(torch.equal(got, want), f"{what}: equals single-device")
    check(torch.equal(got, host_oracle(oracles, "bfs", "delaunay1024", gd)),
          f"{what}: equals the host oracle")
    check(pipe.n_hops > 1, f"{what}: hopped rungs ({pipe.n_hops} hops)")
    traffic = pipe.boundary_traffic()
    print(f"{what} (3-rung CapacityPolicy): {pipe.supersteps} supersteps, "
          f"{pipe.n_hops} hops, {wall:.3f} s (single-device "
          f"{t_single:.3f} s), boundary raw "
          f"{traffic['raw_bytes_per_superstep']} B / wire "
          f"{traffic['wire_bytes_per_superstep']} B per superstep, "
          f"launches per shard {shard_counts}; equals single-device and the "
          f"host oracle")
    del dpart, pipe, got, want
    torch.cuda.empty_cache()

    # P = 4 puts two whole tenants on each shard (no boundary lanes); P = 3
    # cuts tenants 2 and 5, so the tagged exchange runs as well
    from repro_torch.graphs.csr import tile_csr

    view = tile_csr(g, 8)
    for n_parts, labels in ((4, ("fused hash", "fused sort")),
                            (3, ("fused hash",))):
        pview = build_partition(view, n_parts, "tile_csr(kron20, 8)")
        for label in labels:
            for k, v in phase_partitioned_serving(
                    g, pview, label, served[label]).items():
                totals[k] = totals.get(k, 0) + v
        del pview
        torch.cuda.empty_cache()
    return totals, kept


def phase_partitioned_serving(g, pview, label, solo_qs):
    """The 12-query mix through the engine on ``pview``, a partitioned
    ``tile_csr(kron-20, 8)``, held against phase 6's single-device run of
    the same fused mode (``solo_qs``).  Returns the run's launch counts."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import GraphServeConfig, GraphServingEngine

    n_parts = pview.n_parts
    eng = GraphServingEngine(pview, GraphServeConfig(
        mode=label.split()[-1]))
    qs = serving_queries(g)
    for q in qs:
        eng.submit(q)
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with ShardLaunches() as shards:
        _, wall = wall_s(lambda: eng.run_to_completion(1000))
    what = f"partitioned serving {label} P={n_parts}"
    shard_counts = shards.check(SHARD_PATH[label], n_parts, what)
    counts = dict(launch_counts)
    peak = torch.cuda.max_memory_allocated()
    worst = 0.0
    for q, solo in zip(qs, solo_qs):
        check(q.status == "done", f"{what}: query {q.qid} ({q.kind}) done, "
              f"got {q.status} ({q.error})")
        if q.kind == "ppr":
            worst = max(worst, rel_err(q.result, solo.result))
            check(np.allclose(q.result, solo.result, rtol=1e-5, atol=0.0),
                  f"{what}: ppr {q.qid} within rtol 1e-5 of single-device "
                  f"(max relative error {rel_err(q.result, solo.result):.3g})")
        else:
            check(np.array_equal(q.result, solo.result),
                  f"{what}: {q.kind} {q.qid} equals single-device")
    print(f"{what}: {len(qs)} queries in {wall:.3f} s ({len(qs) / wall:.4g} "
          f"queries/s), {eng.tick_no} ticks, {eng.overflow_events} overflow "
          f"events, lane_cap {pview.part.lane_cap}, launches per shard "
          f"{shard_counts}, peak device memory {peak / 2**30:.2f} GiB; "
          f"BFS/SSSP equal single-device, PPR max relative error {worst:.3g}")
    del eng
    torch.cuda.empty_cache()
    return counts


# the paper's IRU geometry (benchmarks/common.py's IRU_HASH): 1024 x 32 sets
# over 4 partitions x 2 banks, 8192-lane windows, round cap 64
IRU_HASH = dict(num_sets=1024, slots=32, window_elems=8192, n_partitions=4,
                n_banks=2, round_cap=64)
# the reference's examples' geometry (examples/quickstart.py:44,
# examples/graph_analytics.py:41): 4 x 2 banks and a round cap, no window
ROUND_CAP_4X2 = dict(num_sets=1024, slots=32, n_partitions=4, n_banks=2,
                     round_cap=64)
FIELDS = ("indices", "secondary", "positions", "active")


def capped_partitions(idx: np.ndarray, n_live, parts: int,
                      geo=ROUND_CAP_4X2) -> int:
    """How many partitions of the layout (after the bank bypass) take the
    round-cap fallback on the live prefix, by the oracle's rules (host
    numpy): a partition one of whose sets holds more than round_cap *
    slots live lanes."""
    from repro_torch.kernels.iru_reorder.ref import hash_set, partition_capacity

    x = idx[:idx.size if n_live is None else int(n_live)]
    sets = hash_set(x // np.int32(32), geo["num_sets"])
    if parts > 1 and np.bincount(sets % parts, minlength=parts).max() > \
            partition_capacity(x.size, parts):
        parts = 1  # the bank bypass
    hot = np.flatnonzero(np.bincount(sets, minlength=geo["num_sets"])
                         > geo["round_cap"] * geo["slots"])
    return int(np.unique(hot % parts).size)


def _capped_oracle(idx, vals, m, op, parts):
    """ragged_oracle(hash_reorder_ref_banked, ..., round_cap=64) of one
    round-cap case (in a pool worker)."""
    from repro_torch.kernels.iru_reorder.ref import (hash_reorder_ref_banked,
                                                     ragged_oracle)

    return ragged_oracle(hash_reorder_ref_banked, idx, vals, m,
                         num_sets=1024, slots=32, filter_op=op,
                         n_partitions=parts, round_cap=64)


def round_cap_cases(g, pr_idx, pr_vals):
    """The whole-stream round-cap cases of phase 3 (a), as (label, indices,
    payload, op, n_live, partitions, built to trip): kron-20's PageRank
    stream flat and in 4 partitions, add and tagged; the half-graph
    expansion (phase 2's first, rebuilt from the same seed) with its live
    prefix, min on int32; a stream whose partition 0 keeps every PageRank
    lane (its hub sets past the cap) while the other partitions keep one
    lane in 64 (under it); and those thin partitions alone (no set reaches
    the cap)."""
    from repro_torch.graphs.csr import expand_frontier, frontier_from_mask
    from repro_torch.kernels.iru_reorder.ref import hash_set

    dev = g.device
    gen = torch.Generator(device=dev).manual_seed(SEED)
    mask = torch.rand(g.n_nodes, generator=gen, device=dev) < 0.5
    ef = expand_frontier(g, frontier_from_mask(mask), gather="torch")
    depth = torch.randint(0, 64, (ef.dsts.numel(),), device=dev,
                          dtype=torch.int32, generator=torch.Generator(
                              device=dev).manual_seed(SEED + 1))
    part = torch.from_numpy(hash_set(pr_idx.cpu().numpy() // np.int32(32),
                                     1024) % 4).to(dev)
    thin = torch.rand(pr_idx.numel(), generator=gen, device=dev) < 1 / 64
    mixed = (part == 0) | thin
    under = (part != 0) & thin
    return [("pagerank add, flat", pr_idx, pr_vals, "add", None, 1, True),
            ("pagerank tagged, flat", pr_idx, pr_vals, "tagged", None, 1,
             True),
            ("pagerank add, 4 partitions", pr_idx, pr_vals, "add", None, 4,
             True),
            ("pagerank tagged, 4 parts", pr_idx, pr_vals, "tagged", None,
             4, True),
            ("expansion min int32, 4 parts", ef.dsts, depth, "min",
             ef.n_valid, 4, True),
            ("mixed add, 4 partitions", pr_idx[mixed], pr_vals[mixed], "add",
             None, 4, True),
            ("under the cap add, 4 parts", pr_idx[under], pr_vals[under],
             "add", None, 4, False)]


def window_branches(idx: np.ndarray, n_live, geo=IRU_HASH):
    """How many windows bypass the banks and how many take the round-cap
    fallback in a partition, by the oracle's rules (host numpy)."""
    from repro_torch.kernels.iru_reorder.ref import hash_set

    w, sets_n, parts = geo["window_elems"], geo["num_sets"], geo["n_partitions"]
    n = idx.size
    windows = -(-n // w)
    lane = np.arange(n)
    live = lane < (n if n_live is None else int(n_live))
    sets = hash_set(idx // np.int32(32), sets_n)
    cnt = np.bincount((lane // w * sets_n + sets)[live],
                      minlength=windows * sets_n).reshape(windows, sets_n)
    m = cnt.sum(1)
    per = -(-m // parts)
    capacity = np.minimum(m, per + np.maximum(64, per // 4))
    by_part = cnt.reshape(windows, sets_n // parts, parts)  # set r*P + p
    bypass = by_part.sum(1).max(1) > capacity
    hot = cnt > geo["round_cap"] * geo["slots"]
    dense = np.where(bypass, hot.any(1),
                     hot.reshape(windows, sets_n // parts, parts).any(1)
                     .any(1))
    return int(bypass.sum()), int(dense.sum())


def _oracle_piece(args):
    from repro_torch.core import iru

    return iru._hash_ref_host(*args)


# the worker processes (spawned; two cores stay free for this process and
# the compiler) that compute the host oracles of phases 3 and 4
ORACLE_WORKERS = max(min((os.cpu_count() or 3) - 2, 8), 1)
BANKED = dict(num_sets=1024, slots=32, n_partitions=4)


def oracle_pool():
    import concurrent.futures
    import multiprocessing

    return concurrent.futures.ProcessPoolExecutor(
        ORACLE_WORKERS, mp_context=multiprocessing.get_context("spawn"))


def start_host_work(pool, graphs) -> dict:
    """Start in ``pool`` the numpy work that phases 3 and 4 check against,
    while the kernels still compile: the apps' host oracles on kron-20 and
    delaunay-1024 (the ``oracles`` cache, as futures), hash_reorder_ref_
    banked on kron-20's PageRank stream, and the windowed oracle of each
    stream phase 3 holds (the PageRank stream with add and min, and the two
    trip streams).  The largest jobs go first."""
    from repro_torch.core.iru import IRUConfig
    from repro_torch.kernels.iru_reorder.ref import hash_reorder_ref_banked

    g = graphs["kron20"]
    oracles = {}
    for gname in ("delaunay1024", "kron20"):
        gr = graphs[gname]
        arrays = [t.cpu().numpy() for t in (gr.row_ptr, gr.col_idx,
                                            gr.weights)]
        for name, iters in (("sssp", None), ("pagerank", 20), ("bfs", None)):
            oracles[(name, gname, iters)] = pool.submit(
                _app_oracle_piece, name, *arrays, iters)
    pr_idx, pr_vals = pagerank_stream(g)
    idx_np, vals_np = pr_idx.cpu().numpy(), pr_vals.cpu().numpy()
    banked = pool.submit(hash_reorder_ref_banked, idx_np, vals_np, **BANKED)
    cap_idx, bypass_idx, vals, live = trip_streams(g.device)
    vals_t = vals.cpu().numpy()
    held = [("pagerank add", pr_idx, pr_vals, "add", None, None),
            # min on its first 512 windows: add holds every window against
            # both, and the plain loop's whole-stream time is add's
            ("pagerank min", pr_idx, pr_vals, "min", None,
             512 * IRU_HASH["window_elems"]),
            ("round-cap trip add", cap_idx, vals, "add", live, None),
            ("bypass trip min", bypass_idx, vals, "min", live, None)]
    windowed = [windowed_oracle(
        pool, (idx_np if a is pr_idx else a.cpu().numpy())[:cut],
        (vals_np if a is pr_idx else vals_t)[:cut],
        IRUConfig(mode="hash", filter_op=op, **IRU_HASH),
        None if n_live is None else int(n_live))
        for _, a, _, op, n_live, cut in held]
    # the whole-stream round-cap cases: tagged ones per family (add, min)
    capped = round_cap_cases(g, pr_idx, pr_vals)
    capped_oracles = []
    for _, a, v, op, n_live, parts, _ in capped:
        a_np = idx_np if a is pr_idx else a.cpu().numpy()
        v_np = vals_np if v is pr_vals else v.cpu().numpy()
        m = a_np.size if n_live is None else int(n_live)
        capped_oracles.append({f: pool.submit(_capped_oracle, a_np, v_np, m,
                                              f, parts)
                               for f in (("add", "min") if op == "tagged"
                                         else (op,))})
    return {"oracles": oracles, "banked": banked, "held": held,
            "windowed": windowed, "pr": (pr_idx, pr_vals, idx_np, vals_np),
            "capped": capped, "capped_oracles": capped_oracles}


def windowed_oracle(pool, idx_np, vals_np, cfg, live):
    """Start ``iru._hash_ref_host`` over a stream in ``pool``, its windows
    split into one piece a worker (windows are independent, so the pieces
    join with their positions offset by the piece's start).  Returns a
    function that waits for the pieces and returns the four arrays."""
    n, w = len(idx_np), cfg.window_elems
    per = -(-(-(-n // w)) // ORACLE_WORKERS) * w  # whole windows a piece
    starts = range(0, n, per)
    futures = [pool.submit(_oracle_piece, (
        idx_np[s0:s0 + per], vals_np[s0:s0 + per], cfg,
        None if live is None else max(live - s0, 0))) for s0 in starts]

    def wait():
        pieces = [f.result() for f in futures]
        for s0, piece in zip(starts, pieces):
            piece[2][:] += np.int32(s0)
        return tuple(np.concatenate([p[i] for p in pieces])
                     for i in range(4))

    return wait


def hold_windowed(label, idx, vals, op, oracle, n_live=None,
                  cut_lanes=None):
    """B3's windowed body (IRU_HASH, one launch) against the plain window
    loop (kernels=False), exact but for f32 add (rtol 1e-5, another
    addition order), and then against the numpy oracle (``oracle()``,
    started earlier in the pool) on every window, bit for bit: on the whole
    stream, or on its first ``cut_lanes`` lanes (whole windows; the plain
    loop on a second kernel call on them).  Returns (max abs error against
    plain, the plain call's seconds, windows that bypass, windows that fall
    back, the oracle's four arrays)."""
    from repro_torch.core import iru

    cfg = iru.IRUConfig(mode="hash", filter_op=op, **IRU_HASH)
    got = iru.iru_reorder(idx, vals, config=cfg, n_live=n_live)
    torch.cuda.synchronize()
    got_np = [getattr(got, field).cpu().numpy() for field in FIELDS]
    idx_np = idx.cpu().numpy()
    live = None if n_live is None else int(n_live)
    w = cfg.window_elems
    windows = -(-idx.numel() // w)
    cut, survivors, held = "", int(got.active.sum()), windows
    if cut_lanes is not None:  # the plain loop takes about 2 s a million
        idx, vals = idx[:cut_lanes], vals[:cut_lanes]
        got = iru.iru_reorder(idx, vals, config=cfg, n_live=n_live)
        got_np = [a[:cut_lanes] for a in got_np]
        cut = f" on the first {cut_lanes} lanes"
        held = -(-min(windows * w, cut_lanes) // w)
    want, t_plain = wall_s(lambda: iru.iru_reorder(
        idx, vals, config=cfg, n_live=n_live, kernels=False))
    for field in ("indices", "positions", "active"):
        check(torch.equal(getattr(got, field), getattr(want, field)),
              f"{label}: {field} equal to plain")
    err = max_abs_err(got.secondary, want.secondary)
    nz = want.secondary != 0
    rel = ((got.secondary[nz].double() - want.secondary[nz].double()).abs()
           / want.secondary[nz].double().abs()).max().item() if nz.any() \
        else 0.0
    if op == "add":
        check(torch.allclose(got.secondary, want.secondary, rtol=1e-5,
                             atol=0.0), f"{label}: add within rtol 1e-5")
    else:
        check(torch.equal(got.secondary, want.secondary),
              f"{label}: exact against plain")
    t0 = time.perf_counter()
    want_np = oracle()
    t_oracle = time.perf_counter() - t0
    bad = set()
    for a, b in zip(got_np, want_np):
        if a.dtype == np.float32:  # bit for bit
            a, b = a.view(np.int32), b.view(np.int32)
        bad |= set((np.flatnonzero(a != b) // w).tolist())
    check(not bad, f"{label}: equal to the numpy oracle on every window "
          f"held ({len(bad)} of {held} differ, first {sorted(bad)[:5]})")
    bypass, dense = window_branches(idx_np, n_live)
    print(f"B3 windowed {label:22s}: {len(idx_np)} lanes "
          f"({len(idx_np) if live is None else live} live), {windows} "
          f"windows, {bypass} bypass the banks, {dense} take the round-cap "
          f"fallback in a partition; {survivors} survivors; equal to the "
          f"numpy oracle on {held} windows (waited {t_oracle:.1f} s for it) "
          f"and to plain{cut}: max abs err {err:.3g}, max rel err "
          f"{rel:.3g} (plain {t_plain:.1f} s)")
    return err, t_plain, bypass, dense, want_np


def family_oracle(table_np, add, low):
    """The tagged oracle from the add and the min oracles: their layout
    (it does not depend on the op), the add payloads on add-family lanes
    and the min payloads on min-family lanes."""
    fam = table_np[np.clip(add[0], 0, table_np.size - 1)]
    return add[0], np.where(fam, add[1], low[1]), add[2], add[3]


def equal_bits(got_np, want, what: str, w=None) -> None:
    """Every field bit for bit (f32 payloads by their bits); with ``w``,
    the differing windows are named."""
    bad = set()
    for field, a, b in zip(FIELDS, got_np, want):
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        diff = np.flatnonzero(a != b)
        if diff.size:
            bad.add(field if w is None else
                    f"{field} in windows {sorted(set(diff // w))[:5]}")
    check(not bad, f"{what}: equal to the numpy oracle ({sorted(bad)})")


def hold_capped(case, oracles, table):
    """One whole-stream round-cap case of phase 3 (a): B3 under
    ROUND_CAP_4X2's cap (one launch, counted under
    iru_reorder_round_cap, under set_sync_debug_mode("error")) against the
    plain version (exact but for f32 add, rtol 1e-5) and the numpy oracle
    (started in the pool; tagged: per family), bit for bit; the partitions
    past the cap counted on the host.  A case built not to trip must equal
    the uncapped call.  Returns (max abs error against plain, the plain
    call's seconds)."""
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.iru_reorder import ops as hash_ops

    label, idx, vals, op, n_live, parts, trips = case
    kw = dict(num_sets=ROUND_CAP_4X2["num_sets"], slots=ROUND_CAP_4X2["slots"],
              round_cap=ROUND_CAP_4X2["round_cap"], filter_op=op,
              n_partitions=parts, n_live=n_live,
              tag_table=table if op == "tagged" else None)
    before = launch_counts["iru_reorder_round_cap"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = hash_ops.hash_reorder(idx, vals, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    check(launch_counts["iru_reorder_round_cap"] == before + 1,
          f"B3 round cap {label}: one launch of the capped body")
    want, t_plain = wall_s(lambda: hash_ops.hash_reorder(
        idx, vals, kernels=False, **kw))
    for field in ("indices", "positions", "active"):
        check(torch.equal(getattr(got, field), getattr(want, field)),
              f"B3 round cap {label}: {field} equal to plain")
    if op == "tagged":
        check_tagged(got.secondary, want.secondary, table[got.indices.long()],
                     f"B3 round cap {label}")
    elif op == "add":
        check(torch.allclose(got.secondary, want.secondary, rtol=1e-5,
                             atol=0.0), f"B3 round cap {label}: rtol 1e-5")
    else:
        check(torch.equal(got.secondary, want.secondary),
              f"B3 round cap {label}: exact against plain")
    err = max_abs_err(got.secondary, want.secondary)
    got_np = [getattr(got, field).cpu().numpy() for field in FIELDS]
    t0 = time.perf_counter()
    res = {f: fut.result() for f, fut in oracles.items()}
    t_oracle = time.perf_counter() - t0
    oracle = (family_oracle(table.cpu().numpy(), res["add"], res["min"])
              if op == "tagged" else res[op])
    equal_bits(got_np, oracle, f"B3 round cap {label}")
    idx_np = idx.cpu().numpy()
    dense = capped_partitions(idx_np, n_live, parts)
    if trips:
        check(dense > 0, f"B3 round cap {label}: a partition takes the "
              f"fallback")
    else:
        check(dense == 0, f"B3 round cap {label}: no set reaches the cap")
        plain_call = hash_ops.hash_reorder(idx, vals,
                                           **dict(kw, round_cap=None))
        check(all(torch.equal(a, b) for a, b in zip(got, plain_call)),
              f"B3 round cap {label}: equal to the uncapped call")
    live = idx.numel() if n_live is None else int(n_live)
    print(f"B3 round cap {label:28s}: {idx.numel()} lanes ({live} live), "
          f"{parts} partition(s), {dense} take the fallback; "
          f"{int(got.active.sum())} survivors; equal to the numpy oracle "
          f"(waited {t_oracle:.1f} s for it) and to plain: max abs err "
          f"{err:.3g} (plain {t_plain:.2f} s)"
          + ("" if trips else "; equal to the uncapped call"))
    return err, t_plain


def tick_of(idx, vals, lanes: int):
    """``idx`` and ``vals`` padded with dead lanes to ``lanes`` (index one
    past the largest, payload 0), as a top-rung serving tick pads its
    stream, and the live count on the device."""
    pad = lanes - idx.numel()
    return (torch.cat([idx, idx.new_full((pad,), int(idx.max()) + 1)]),
            torch.cat([vals, vals.new_zeros(pad)]),
            torch.tensor(idx.numel(), dtype=torch.int32, device=idx.device))


TICK_LANES = 251_212_640  # a top-rung tick of the serving mix (phase 6)
TICK_SLICE = 64  # windows on each side of the tick's live count held in full
TAGGED_PLAIN_WINDOWS = 128  # windows of the tagged stream held against plain


def hold_windowed_tagged(pr_idx, pr_vals, table, add_oracle, min_oracle,
                         min_lanes: int):
    """Phase 3 (c): B3's windowed body tagged at the paper's geometry, one
    launch.  On kron-20's PageRank stream (families (idx >> 17) & 1): its
    layout and add-family payloads equal the add oracle on every window,
    its min-family payloads the min oracle on the first ``min_lanes``
    lanes, and a second call on the first TAGGED_PLAIN_WINDOWS windows
    equals the plain window loop.
    On a padded serving tick (TICK_LANES, the same stream live): every
    fully live window equals the unpadded call, the TICK_SLICE windows on
    each side of the live count equal the plain loop and the oracle per
    family on that slice, and every window past them is the identity
    layout.  Returns
    (max abs error against plain, the tagged call's ms on the stream, the
    tick's ms)."""
    from repro_torch.core import iru

    cfg = iru.IRUConfig(mode="hash", filter_op="tagged", **IRU_HASH)
    w = cfg.window_elems
    table_np = table.cpu().numpy()
    got = iru.iru_reorder(pr_idx, pr_vals, config=cfg, tag_table=table)
    torch.cuda.synchronize()
    got_np = [getattr(got, field).cpu().numpy() for field in FIELDS]
    fam = table_np[np.clip(got_np[0], 0, table_np.size - 1)]
    for k in (0, 2, 3):
        check(np.array_equal(got_np[k], add_oracle[k]),
              f"B3 windowed tagged: {FIELDS[k]} equal to the oracle")
    check(np.array_equal(got_np[1][fam].view(np.int32),
                         add_oracle[1][fam].view(np.int32)),
          "B3 windowed tagged: add-family payloads equal the add oracle")
    head = slice(0, min_lanes)
    low = ~fam[head]
    check(np.array_equal(got_np[1][head][low].view(np.int32),
                         min_oracle[1][head][low].view(np.int32)),
          "B3 windowed tagged: min-family payloads equal the min oracle")
    cut = TAGGED_PLAIN_WINDOWS * w
    idx_c, vals_c = pr_idx[:cut], pr_vals[:cut]
    got_c = iru.iru_reorder(idx_c, vals_c, config=cfg, tag_table=table)
    want_c, t_plain = wall_s(lambda: iru.iru_reorder(
        idx_c, vals_c, config=cfg, tag_table=table, kernels=False))
    for field in ("indices", "positions", "active"):
        check(torch.equal(getattr(got_c, field), getattr(want_c, field)),
              f"B3 windowed tagged: {field} equal to plain")
    check_tagged(got_c.secondary, want_c.secondary,
                 table[got_c.indices.long()], "B3 windowed tagged")
    err = max_abs_err(got_c.secondary, want_c.secondary)
    ms = event_ms(lambda: iru.iru_reorder(pr_idx, pr_vals, config=cfg,
                                          tag_table=table))
    # the padded tick
    t_idx, t_vals, t_live = tick_of(pr_idx, pr_vals, TICK_LANES)
    n = pr_idx.numel()
    tick = iru.iru_reorder(t_idx, t_vals, config=cfg, n_live=t_live,
                           tag_table=table)
    full = n // w * w  # the fully live windows
    for field in FIELDS:
        check(torch.equal(getattr(tick, field)[:full],
                          getattr(got, field)[:full]),
              f"B3 windowed tagged tick: live windows' {field} equal the "
              f"unpadded call")
    s0, s1 = full - TICK_SLICE * w, full + TICK_SLICE * w
    sl_idx, sl_vals = t_idx[s0:s1], t_vals[s0:s1]
    sl_live = torch.tensor(n - s0, dtype=torch.int32, device=t_idx.device)
    got_s = iru.iru_reorder(sl_idx, sl_vals, config=cfg, n_live=sl_live,
                            tag_table=table)
    for field in FIELDS:
        a = getattr(tick, field)[s0:s1]
        b = getattr(got_s, field)
        if field == "positions":
            b = b + s0
        check(torch.equal(a, b), f"B3 windowed tagged tick: {field} of the "
              f"slice equal to the slice's own call")
    want_s = iru.iru_reorder(sl_idx, sl_vals, config=cfg, n_live=sl_live,
                             tag_table=table, kernels=False)
    for field in ("indices", "positions", "active"):
        check(torch.equal(getattr(got_s, field), getattr(want_s, field)),
              f"B3 windowed tagged tick: {field} equal to plain")
    check_tagged(got_s.secondary, want_s.secondary,
                 table[got_s.indices.long()], "B3 windowed tagged tick")
    err = max(err, max_abs_err(got_s.secondary, want_s.secondary))
    sl_np = (sl_idx.cpu().numpy(), sl_vals.cpu().numpy())
    oracle = family_oracle(table_np, *(iru._hash_ref_host(
        *sl_np, dataclasses.replace(cfg, filter_op=f), n - s0)
        for f in ("add", "min")))
    equal_bits([getattr(got_s, field).cpu().numpy() for field in FIELDS],
               oracle, "B3 windowed tagged tick slice", w)
    rest = torch.arange(s1, TICK_LANES, device=t_idx.device,
                        dtype=torch.int32)
    check(torch.equal(tick.positions[s1:], rest)
          and not bool(tick.active[s1:].any())
          and torch.equal(tick.indices[s1:], t_idx[s1:]),
          "B3 windowed tagged tick: the dead windows are the identity")
    tick_ms = event_ms(lambda: iru.iru_reorder(
        t_idx, t_vals, config=cfg, n_live=t_live, tag_table=table), reps=3)
    print(f"B3 windowed tagged pagerank: {n} lanes, "
          f"{int(got.active.sum())} survivors; equal to the add oracle on "
          f"every window (layout, add-family payloads) and the min oracle "
          f"on the first {min_lanes} lanes; equal to plain on the first "
          f"{cut} (plain "
          f"{t_plain:.1f} s), max abs err {err:.3g}; kernel {ms:.4f} ms; "
          f"padded tick ({TICK_LANES} lanes, {n} live): live windows equal "
          f"the unpadded call, the {2 * TICK_SLICE} windows around the live "
          f"count equal plain and the oracle per family, dead windows the "
          f"identity; "
          f"kernel {tick_ms:.4f} ms")
    del t_idx, t_vals, tick
    torch.cuda.empty_cache()
    return err, ms, tick_ms


def trip_streams(dev):
    """Two 1M-lane streams (seeded, last windows ragged): one whose windows
    put about 2200 arrivals in one set of one partition (past the round
    cap's 64 x 32, under the partition's capacity), one whose windows put
    45% of their lanes into one partition's sets (past its capacity, no set
    past the cap)."""
    from repro_torch.kernels.iru_reorder.ref import hash_set

    rng = np.random.default_rng(SEED)
    n = 1 << 20
    blocks = np.arange(1 << 16)
    bset = hash_set(blocks, 1024)

    def pick(pool):  # n indices of the blocks in pool
        return (pool[rng.integers(0, pool.size, n)] * 32
                + rng.integers(0, 32, n))

    hot = rng.random(n) < 2200 / 8192
    cap_idx = np.where(hot, pick(blocks[bset == 3][:4]),
                       pick(blocks[bset % 4 != 3]))
    heavy = rng.random(n) < 0.45
    bypass_idx = np.where(heavy, pick(blocks[bset % 4 == 0]),
                          pick(blocks[bset % 4 != 0]))
    vals = rng.uniform(0.0, 1.0, n).astype(np.float32)
    live = torch.tensor(n - 25810, dtype=torch.int32, device=dev)
    as_t = lambda a: torch.from_numpy(a.astype(np.int32)).to(dev)
    return as_t(cap_idx), as_t(bypass_idx), torch.from_numpy(vals).to(dev), \
        live


def window_phases(idx, vals):
    """Where a window's time goes: one call of B3's windowed body's stamped
    build at the paper's geometry (add), each window's clock64() cycles by
    phase; prints the mean cycles a window and each phase's share of all
    windows' cycles, with the CTAs resident per SM and the shared memory a
    window takes."""
    from repro_torch.kernels.iru_reorder import ops as hash_ops

    kw = {k: IRU_HASH[k] for k in ("num_sets", "slots", "window_elems",
                                    "n_partitions", "round_cap")}
    hash_ops.windowed_phase_stamps(idx, vals, filter_op="add", **kw)  # warm
    _, stamps = hash_ops.windowed_phase_stamps(idx, vals, filter_op="add",
                                               **kw)
    torch.cuda.synchronize()
    cycles = stamps.diff(dim=1).double()
    share = cycles.sum(0) / cycles.sum()
    per = cycles.mean(0)
    smem = hash_ops._lib().iru_win_reorder_smem(
        kw["window_elems"], kw["num_sets"], kw["n_partitions"])
    resident = {op: hash_ops.windowed_occupancy(
        kw["window_elems"], kw["num_sets"], kw["n_partitions"], op)
        for op in ("add", "tagged")}
    for op, blocks in resident.items():
        check(blocks == 2, f"two windows of the windowed body ({op}) reside "
              f"on an SM, got {blocks}")
    print(f"time iru_reorder_windowed by phase at pagerank's shape (stamped "
          f"build, one call, {stamps.shape[0]} windows; clock64 cycles a "
          f"window, share): " + ", ".join(
              f"{name} {c:.1f} ({f:.4f})" for name, c, f in zip(
                  hash_ops.WINDOW_PHASES, per.tolist(), share.tolist()))
          + f"; total {per.sum().item():.1f} cycles a window; "
          f"{resident['add']} CTAs resident per SM ({resident['tagged']} "
          f"tagged), {smem} bytes of shared memory a window")


def phase_windowed(graphs, oracles, work, pool):
    """The paper's geometry on the card: B3's windowed body and its banked
    whole-stream layout held against the plain versions and the numpy
    oracles (started in ``pool`` by ``start_host_work``: ``work``), the
    apps through FrontierPipeline with IRU_HASH and the host entry point
    reorder_frontier (the launch counts zeroed before each run and read
    after it), then the two bodies' times and a profile.  Shuts ``pool``
    down.  Returns (launches, errors, timing rows)."""
    from repro_torch.apps.bfs import BFS_APP
    from repro_torch.apps.pagerank import pagerank_app
    from repro_torch.apps.sssp import SSSP_APP
    from repro_torch.core import CapacityPolicy, FrontierPipeline
    from repro_torch.core.iru import IRUConfig, reorder_frontier
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.iru_reorder import ops as hash_ops
    from repro_torch.kernels.iru_reorder.ref import hash_set, partition_capacity

    g = graphs["kron20"]
    pr_idx, pr_vals, idx_np, vals_np = work["pr"]
    n = pr_idx.numel()
    res = [hold_windowed(label, a, v, op, oracle, n_live, cut_lanes)
           for (label, a, v, op, n_live, cut_lanes), oracle
           in zip(work["held"], work["windowed"])]
    err_w, t_plain_w = res[0][:2]
    err_min, err_cap, err_by = (r[0] for r in res[1:])
    dense, bypass = res[2][3], res[3][2]
    check(dense > 0, "the round-cap trip stream takes the fallback")
    check(bypass > 0, "the bypass trip stream bypasses the banks")
    print(f"B3 windowed: {dense} windows took the round-cap fallback, "
          f"{bypass} bypassed the banks")
    # (c) the windowed body tagged, on the same stream and a padded tick
    table = family_table(g)
    err_tag, tagged_ms, tick_ms = hold_windowed_tagged(
        pr_idx, pr_vals, table, res[0][4], res[1][4],
        work["held"][1][5])
    del res

    # whole-stream B3, banked layout (4 partitions, no window)
    kw = BANKED
    got = hash_ops.hash_reorder(pr_idx, pr_vals, filter_op="add", **kw)
    want, t_plain_b = wall_s(lambda: hash_ops.hash_reorder(
        pr_idx, pr_vals, filter_op="add", kernels=False, **kw))
    for field in ("indices", "positions", "active"):
        check(torch.equal(getattr(got, field), getattr(want, field)),
              f"B3 banked: {field} equal to plain")
    check(torch.allclose(got.secondary, want.secondary, rtol=1e-5, atol=0.0),
          "B3 banked add within rtol 1e-5 of plain")
    err_b = max_abs_err(got.secondary, want.secondary)
    # the oracle's round peeling for add takes minutes of host time at this
    # size; without a merge it is a closed form, and the layout (banks,
    # bypass, partition-major emission) is the same
    got0 = hash_ops.hash_reorder(pr_idx, pr_vals, **kw)
    t0 = time.perf_counter()
    oracle0 = work["banked"].result()
    t_oracle = time.perf_counter() - t0
    for k, field in enumerate(FIELDS):
        check(np.array_equal(getattr(got0, field).cpu().numpy(), oracle0[k]),
              f"B3 banked, no merge: {field} equal to the numpy oracle")
    counts = np.bincount(hash_set(idx_np // np.int32(32), 1024) % 4,
                         minlength=4)
    print(f"B3 banked pagerank add  : {n} lanes, partitions hold "
          f"{counts.tolist()} (capacity {partition_capacity(n, 4)}), "
          f"{int(got.active.sum())} survivors, max abs err {err_b:.3g} "
          f"against plain (plain {t_plain_b:.1f} s); without a merge equal "
          f"to hash_reorder_ref_banked (waited {t_oracle:.1f} s for it)")
    # (a) whole-stream B3 under the round cap, against plain and oracle
    capped_errs, capped_plain = [], {}
    for case, oracle in zip(work["capped"], work["capped_oracles"]):
        err, t_plain_c = hold_capped(case, oracle, table)
        capped_errs.append(err)
        capped_plain[case[0]] = t_plain_c
    t0 = time.perf_counter()
    for key in work["oracles"]:  # the apps' host oracles, here and phase 4
        host_oracle(oracles, *key[:2], graphs[key[1]], key[2])
    pool.shutdown()
    print(f"host oracles: waited {time.perf_counter() - t0:.1f} s for the "
          f"rest of the pool's work")

    # the main path: the apps with IRU_HASH and (b) with the 4 x 2 round-cap
    # geometry (no window), and reorder_frontier
    policy = CapacityPolicy(n_buckets=3)
    totals = {}
    for label, cfg, key in (
            ("IRU_HASH", IRUConfig(mode="hash", **IRU_HASH),
             "iru_reorder_windowed"),
            ("4x2 round cap", IRUConfig(mode="hash", **ROUND_CAP_4X2),
             "iru_reorder_round_cap")):
        FrontierPipeline(g, BFS_APP, mode="hash", iru_config=cfg,
                         capacity_policy=policy, max_iters=2).run(0)  # warm
        for gname in ("kron20", "delaunay1024"):
            gr = graphs[gname]
            for name, app, iters in (("bfs", BFS_APP, None),
                                     ("sssp", SSSP_APP, None),
                                     ("pagerank", pagerank_app(20), 20)):
                pipe = FrontierPipeline(gr, app, mode="hash", iru_config=cfg,
                                        capacity_policy=policy,
                                        max_iters=iters)
                reset_launch_counts()
                out, secs = wall_s(lambda: pipe.run(0))
                counts_run = dict(launch_counts)
                for k in ("coalesced_gather", key):
                    check(counts_run.get(k, 0) > 0,
                          f"{label} {name} on {gname} launched {k}")
                for k, v in counts_run.items():
                    totals[k] = totals.get(k, 0) + v
                host = host_oracle(oracles, name, gname, gr, iters)
                if iters:
                    check(torch.allclose(out, host, rtol=1e-4, atol=0.0),
                          f"{label} pagerank on {gname} within rtol 1e-4 of "
                          f"the host oracle")
                else:
                    check(torch.equal(out, host),
                          f"{label} {name} on {gname} equals the host "
                          f"oracle")
                edges = gr.n_edges * (iters or 1)
                print(f"app {label} {name:8s} {gname:12s}"
                      f"{f' ({iters} iterations)' if iters else ''}: "
                      f"{secs:.3f} s ({edges / secs:.4g} edges/s), launches "
                      f"{counts_run}, {pipe.n_hops} bucket hops, host oracle "
                      f"agrees")
    for label, fcfg, key in (
            ("IRU_HASH", IRUConfig(mode="hash", filter_op="add", **IRU_HASH),
             "iru_reorder_windowed"),
            ("4 partitions, no window",
             IRUConfig(mode="hash", filter_op="add", n_partitions=4),
             "iru_reorder_banked")):
        reset_launch_counts()
        out, secs = wall_s(lambda: reorder_frontier(idx_np, vals_np,
                                                    config=fcfg))
        counts_run = dict(launch_counts)
        check(counts_run.get(key, 0) == 1,
              f"reorder_frontier ({label}) launched {key} once")
        check(isinstance(out[0], np.ndarray)
              and np.array_equal(np.sort(out[2]), np.arange(n)),
              f"reorder_frontier ({label}): numpy, a permutation")
        for k, v in counts_run.items():
            totals[k] = totals.get(k, 0) + v
        print(f"reorder_frontier {label}: {n} lanes in {secs:.3f} s (host "
              f"copies included), {int(out[3].sum())} survivors, launches "
              f"{counts_run}")

    # times at PageRank's shape: CUDA events, bound = bytes over 3.35 TB/s
    add_cfg = IRUConfig(mode="hash", filter_op="add", **IRU_HASH)
    from repro_torch.core.iru import iru_reorder

    nbytes = n * (4 + 4) + n * (4 + 4 + 4 + 1)
    rows = {
        "iru_reorder_windowed": {
            "ms": event_ms(lambda: iru_reorder(pr_idx, pr_vals,
                                               config=add_cfg)),
            "plain_ms": t_plain_w * 1e3, "library_ms": None,
            "bytes": nbytes},
        "iru_reorder_banked": {
            "ms": event_ms(lambda: hash_ops.hash_reorder(
                pr_idx, pr_vals, filter_op="add", **kw)),
            "plain_ms": t_plain_b * 1e3, "library_ms": None,
            "bytes": nbytes},
    }
    for name, row in rows.items():
        row["bound_ms"] = row["bytes"] / HBM_BYTES_PER_S * 1e3
        print(f"time {name}: kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.1f} ms (one call), library none, bound "
              f"{row['bound_ms']:.4f} ms ({row['bytes']} bytes, {n} lanes)")
    # where the windowed body's time goes: the same stream by window size,
    # without a merge, and in one partition
    sweep = {f"w={w}": dict(IRU_HASH, window_elems=w, filter_op="add")
             for w in (1024, 2048, 4096)}
    sweep["no merge"] = dict(IRU_HASH)
    sweep["1 partition"] = dict(IRU_HASH, filter_op="add", n_partitions=1)
    parts = []
    for label, kw_v in sweep.items():
        cfg_v = IRUConfig(mode="hash", **kw_v)
        ms = event_ms(lambda: iru_reorder(pr_idx, pr_vals, config=cfg_v))
        parts.append(f"{label} {ms:.4f} ms")
    print("time iru_reorder_windowed by variant at pagerank's shape: "
          + ", ".join(parts) + f", tagged {tagged_ms:.4f} ms (families "
          f"(idx >> 17) & 1), tagged on the padded tick ({TICK_LANES} lanes, "
          f"{n} live) {tick_ms:.4f} ms")
    window_phases(pr_idx, pr_vals)
    profile_window("B3 windowed at pagerank's shape, one call",
                   lambda: iru_reorder(pr_idx, pr_vals, config=add_cfg))
    profile_window("B3 banked at pagerank's shape, one call",
                   lambda: hash_ops.hash_reorder(pr_idx, pr_vals,
                                                 filter_op="add", **kw))
    errors = {"iru_reorder_windowed": max(err_w, err_min, err_cap, err_by,
                                          err_tag),
              "iru_reorder_banked": err_b,
              "iru_reorder_round_cap": max(capped_errs)}
    plain = {"iru_reorder_round_cap":
             capped_plain["pagerank add, 4 partitions"],
             "iru_reorder_round_cap tagged":
             capped_plain["pagerank tagged, 4 parts"]}
    return totals, errors, rows, plain


# deepseek-v2-lite's MoE layer (src/repro/configs/deepseek_v2_lite_16b.py:9,
# 19-26) at full width; random init.  Capacity is 512 at T = 4096 and 1920 at
# T = 16384.
DEEPSEEK_V2_LITE_MOE = dict(d_model=2048, ffn_type="swiglu", n_experts=64,
                            top_k=6, d_ff=1408, n_shared_experts=2,
                            capacity_factor=1.25)
MOE_TOKENS = (4096, 16384)


def event_median_ms(fn, reps: int = 10) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` calls, after a
    warm-up; the calls are queued back to back and read after one sync."""
    fn()
    torch.cuda.synchronize()
    marks = [[torch.cuda.Event(enable_timing=True) for _ in range(2)]
             for _ in range(reps)]
    for start, end in marks:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in marks]))


def moe_close(got, want, what: str, rtol: float, atol: float) -> None:
    """Check ``got`` against ``want`` at ``rtol`` and an atol of ``atol``
    times ``want``'s largest magnitude, and print the largest error beside
    the verdict at the plain ``atol``.  On the card the engines' f32 sums
    differ in order (atomics, cuBLAS kernels) by about an ulp of the
    output's largest terms (|y| reaches about 3e2 at this width), so an
    absolute atol would fail on entries near zero whatever the engine
    does."""
    got, want = got.float(), want.float()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    ok = torch.allclose(got, want, rtol=rtol, atol=atol * scale)
    plain = torch.allclose(got, want, rtol=rtol, atol=atol)
    print(f"  {what}: max abs error {err:.3e} (max |y| {scale:.4g}); "
          f"rtol {rtol:g}, atol {atol:g} x max|y|: {ok}; "
          f"with atol {atol:g} alone: {plain}")
    check(ok, f"{what} within rtol {rtol:g}, atol {atol:g} x max|y|")


def phase_moe(layer_dir: Path):
    """Phase 8: MoE expert dispatch at deepseek-v2-lite's width (plain
    torch; the path reaches no hand-written kernel).  (a) in f32 with TF32
    off: plans equal the numpy oracle, the three engines agree, the ragged
    planned path runs with no host sync, the expert-parallel executor agrees
    with the planner, one backward is finite; (b) in bf16 (f32 router):
    each engine's CUDA-event median, the planner alone, and a profile of
    the planned engine at T = 16384.  The f32 layer and tokens of (a) go to
    ``layer_dir`` for the group phase's ranks; returns the stacked
    expert-parallel outputs there (exact, int8) and the aux loss."""
    import dataclasses

    from repro_torch.configs.base import MoEConfig
    from repro_torch.kernels.iru_reorder.ref import moe_dispatch_ref
    from repro_torch.models.common import Initializer
    from repro_torch.models.moe import init_moe, moe_ffn
    from repro_torch.moe import (capacity, moe_dense, moe_hash, moe_hash_ep,
                                 moe_sorted, plan_dispatch)
    from repro_torch.moe.dispatch import _route, execute_plan

    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    cfg = DEEPSEEK_V2_LITE_MOE
    D, ffn = cfg["d_model"], cfg["ffn_type"]
    moe = MoEConfig(**{k: v for k, v in cfg.items()
                       if k not in ("d_model", "ffn_type")},
                    dispatch="iru_hash")
    E, k, F = moe.n_experts, moe.top_k, moe.d_ff
    check([capacity(t, moe) for t in MOE_TOKENS] == [512, 1920],
          "deepseek-v2-lite capacities 512 and 1920")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    T = MOE_TOKENS[0]

    # (a) checks, f32, TF32 off
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        it = Initializer(gen, torch.float32, dev)
        init_moe(it, D, moe, ffn)
        p32 = it.params
        x = torch.randn(T, D, generator=gen, device=dev)
        gates, experts, _ = _route(p32, x, moe)
        experts_np = experts.cpu().numpy()
        for cf in (1.25, 0.5):
            C = capacity(T, dataclasses.replace(moe, capacity_factor=cf))
            plan = plan_dispatch(experts, gates, C, E)
            want = moe_dispatch_ref(experts_np, C, E)
            got = (plan.rank, plan.keep, plan.counts, plan.dropped)
            check(all(np.array_equal(g.cpu().numpy(), w)
                      for g, w in zip(got, want)),
                  f"moe plan at cf {cf} equals moe_dispatch_ref")
            n_drop = int(want[3].sum())
            if cf == 0.5:
                check(n_drop > 0, "capacity binds at cf 0.5")
            print(f"moe plan T={T} cf {cf}: C {C}, {n_drop} of {T * k} "
                  f"lanes dropped; rank, keep, counts, dropped equal "
                  f"moe_dispatch_ref bit for bit")
        for cf in (1.25, 0.5):
            m_cf = dataclasses.replace(moe, capacity_factor=cf)
            y0, a0 = moe_hash(p32, x, m_cf, ffn)
            for name, fn in (("moe_sorted", moe_sorted),
                             ("moe_dense", moe_dense)):
                y, a = fn(p32, x, m_cf, ffn)
                moe_close(y, y0, f"{name} vs moe_hash, cf {cf}",
                          1e-4, 1e-5)
                check(torch.equal(a, a0), f"{name} aux equals moe_hash's")
            del y, y0
        # ragged: the live prefix through the planned path, no host sync
        m = 3000
        n_live = torch.tensor(m, device=dev)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            yr, _ = moe_hash(p32, x, moe, ffn, n_live=n_live)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        check(not bool(yr[m:].any()), "ragged moe_hash: rows past n_live "
              "are zero")
        C = capacity(T, moe)
        g_m, e_m, _ = _route(p32, x[:m], moe)
        y_m = execute_plan(p32, x[:m], plan_dispatch(e_m, g_m, C, E), C, ffn)
        moe_close(yr[:m], y_m, f"ragged moe_hash (n_live {m}, no host "
                  f"sync) vs the truncated run at C {C}", 1e-5, 1e-6)
        # expert parallel: 4 shards, 8 partitions
        yh, ah = moe_hash(p32, x, moe, ffn)
        ye, ae = moe_hash_ep(p32, x, moe, ffn, n_shards=4, n_partitions=8,
                             compress=False)
        moe_close(ye, yh, "moe_hash_ep n_shards 4, exact, vs moe_hash",
                  1e-5, 1e-6)
        check(torch.equal(ae, ah), "moe_hash_ep aux equals moe_hash's")
        yc, _ = moe_hash_ep(p32, x, moe, ffn, n_shards=4, n_partitions=8)
        err = float((yc - yh).abs().max())
        bound = 0.05 * float(yh.abs().max()) + 1e-3
        print(f"  moe_hash_ep n_shards 4, int8-compressed: max abs error "
              f"{err:.4g} against 0.05 max|y| + 1e-3 = {bound:.4g}")
        check(err <= bound, "compressed expert-parallel combine within "
              "0.05 max|y| + 1e-3")
        stacked_ep = {"exact": ye.cpu(), "int8": yc.cpu(), "aux": ae.cpu()}
        write_layer(layer_dir, p32, x, moe, ffn, n_partitions=8)
        del yr, y_m, yh, ye, yc
        # one backward
        pg = {key: v.detach().clone().requires_grad_()
              for key, v in p32.items()}
        y, aux = moe_ffn(pg, x, moe, ffn)
        ((y ** 2).sum() + 0.01 * aux).backward()
        finite = all(bool(torch.isfinite(v.grad).all()) for v in pg.values())
        gmax = {key: float(pg[key].grad.abs().max()) for key in ("router",
                                                                 "wi")}
        print(f"  backward of sum(y^2) + 0.01 aux: finite {finite}, max "
              f"|grad| router {gmax['router']:.4g}, wi {gmax['wi']:.4g}")
        check(finite and gmax["router"] > 0 and gmax["wi"] > 0,
              "finite gradients, nonzero for router and wi")
        del pg, y, aux, p32, it, x
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.cuda.empty_cache()
    print(f"moe checks: {time.perf_counter() - t0:.1f} s")

    # (b) timings, bf16 with an f32 router
    it = Initializer(gen, torch.bfloat16, dev)
    init_moe(it, D, moe, ffn)
    pb = it.params
    medians = {}
    for T in MOE_TOKENS:
        x = torch.randn(T, D, generator=gen, device=dev,
                        dtype=torch.bfloat16)
        C = capacity(T, moe)
        gates, experts, _ = _route(pb, x, moe)
        plan = plan_dispatch(experts, gates, C, E)
        dropped = int(plan.dropped.sum()) / (T * k)
        expert_flop = 2 * E * C * D * F * 3
        shared_flop = 2 * T * D * moe.n_shared_experts * F * 3
        runs = [("moe_hash", lambda: moe_hash(pb, x, moe, ffn)),
                ("moe_sorted", lambda: moe_sorted(pb, x, moe, ffn))]
        if T == MOE_TOKENS[0]:  # (T, k, E, C) f32 is 48 GB at T = 16384
            runs.append(("moe_dense", lambda: moe_dense(pb, x, moe, ffn)))
        runs.append(("plan_dispatch",
                     lambda: plan_dispatch(experts, gates, C, E)))
        if T == MOE_TOKENS[0]:
            runs += [("moe_hash_ep n_shards=4 int8",
                      lambda: moe_hash_ep(pb, x, moe, ffn, n_shards=4)),
                     ("moe_hash_ep n_shards=4 exact",
                      lambda: moe_hash_ep(pb, x, moe, ffn, n_shards=4,
                                          compress=False))]
        for name, fn in runs:
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ms = event_median_ms(fn)
            peak = torch.cuda.max_memory_allocated() - held
            medians[(name, T)] = ms
            rate = ("" if name == "plan_dispatch" else
                    f" ({expert_flop / ms / 1e9:.1f} TFLOP/s of it)")
            print(f"moe {name} T={T} C={C} bf16: {ms:.4f} ms (median of "
                  f"10), {T / ms * 1e3:.0f} tokens/s, peak "
                  f"{peak / 2**30:.3f} GiB above {held / 2**30:.3f} held, "
                  f"dropped share {dropped:.6f}, expert FFN "
                  f"{expert_flop:.4g} flop{rate}, shared experts "
                  f"{shared_flop:.4g} flop (not in this call)")
        if T == MOE_TOKENS[-1]:
            profile_window(f"moe_hash T={T} bf16, one call",
                           lambda: moe_hash(pb, x, moe, ffn), top=14)
            profile_window(f"plan_dispatch T={T}, one call",
                           lambda: plan_dispatch(experts, gates, C, E),
                           top=14)
        del x, gates, experts, plan
    for T in MOE_TOKENS:
        share = medians[("plan_dispatch", T)] / medians[("moe_hash", T)]
        print(f"moe planner share T={T}: plan_dispatch "
              f"{medians[('plan_dispatch', T)]:.4f} ms of moe_hash "
              f"{medians[('moe_hash', T)]:.4f} ms ({share:.3f})")
    del pb, it
    torch.cuda.empty_cache()
    print(f"moe phase: {time.perf_counter() - t0:.1f} s")
    return stacked_ep


# The group phase (8b): one shard per process over torch.distributed, the
# ranks started by the partitioned launcher.  Four gloo ranks share the one
# card, so the exchange crosses host memory and loopback TCP, not NVLink.
GROUP_DIR = ROOT / "build" / "group"
GROUP_RUNS = {  # the launcher's --app -> phase 7's stacked run (app, compress)
    "bfs:compress": ("bfs", True), "sssp": ("sssp", False),
    "pagerank:iters=20:compress": ("pagerank", True),
    "pagerank:iters=20": ("pagerank", False)}
GROUP_TIMEOUT = 300  # seconds for one launcher run, process starts included
GROUP_SLOTS = 6  # serving over four ranks: 6 tenants over 4 shards cut two
GROUP_BANKED = "pagerank:sets=1024:slots=32:parts=4:op=add:label=banked"
EF_L1_LIMIT = 1e-3  # int8_ef PageRank, four ranks against stacked


def l1_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().sum() / want.abs().sum())


def write_layer(path: Path, params: dict, x, moe, ffn: str,
                n_partitions: int) -> None:
    """A MoE layer as the partitioned launcher's ``--moe`` reads it."""
    import dataclasses

    path.mkdir(parents=True, exist_ok=True)
    for k in ("router", "wi", "wg", "wo"):
        np.save(path / f"{k}.npy", params[k].cpu().numpy())
    np.save(path / "x.npy", x.cpu().numpy())
    (path / "config.json").write_text(json.dumps({
        "moe": dataclasses.asdict(moe), "ffn_type": ffn,
        "n_partitions": n_partitions}))


def launch_group(what: str, args: list) -> tuple[list, float]:
    """Run the partitioned launcher; returns every rank's records and the
    wall seconds (process starts included).  A failed or hung rank fails
    the phase."""
    cmd = [sys.executable, "-m", "repro_torch.launch.partitioned", *args]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    try:
        r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                           text=True, timeout=GROUP_TIMEOUT)
    except subprocess.TimeoutExpired as e:
        raise RuntimeError(f"check failed: {what}: the launcher ran past "
                           f"{GROUP_TIMEOUT} s") from e
    wall = time.perf_counter() - t0
    for line in r.stdout.splitlines():
        print(f"  rank 0 | {line}")
    check(r.returncode == 0, f"{what}: launcher exit {r.returncode}\n"
          f"{r.stderr[-4000:]}")
    out = Path(args[args.index("--out") + 1])
    return json.loads((out / "summary.json").read_text()), wall


def group_records(summary: list, label: str) -> list:
    return [next(r for r in recs if r["label"] == label) for recs in summary]


def stacked_group_serving(g, served: list) -> dict:
    """The fused hash engine with every shard of partition_csr(tile_csr(g,
    GROUP_SLOTS), 4) in this process, on fresh copies of phase 6's queries
    (``served``, in their order): what the four ranks' serving run is held
    against beside phase 6.  Returns its queries, wall seconds, ticks,
    launches and lane_cap."""
    from repro_torch.graphs.csr import partition_csr, tile_csr
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import (GraphQuery, GraphServeConfig,
                                   GraphServingEngine)

    pview = partition_csr(tile_csr(g, GROUP_SLOTS), 4)
    eng = GraphServingEngine(pview, GraphServeConfig(
        query_slots=GROUP_SLOTS, mode="hash"))
    qs = [GraphQuery(q.kind, q.source, iters=q.iters, damping=q.damping)
          for q in served]
    for q in qs:
        eng.submit(q)
    reset_launch_counts()
    _, wall = wall_s(lambda: eng.run_to_completion(1000))
    out = {"queries": qs, "wall": wall, "ticks": eng.tick_no,
           "launches": dict(launch_counts), "lane_cap": pview.part.lane_cap}
    for k in SHARD_PATH["fused hash"]:
        check(out["launches"].get(k, 0) > 0,
              f"group serving's stacked twin launched {k}")
    del eng, pview
    torch.cuda.empty_cache()
    return out


def group_serving(summary, out: Path, served: list, stacked: dict,
                  count, card: str) -> None:
    """The four ranks' serving run against phase 6's fused hash results
    and its stacked twin (see the module docstring)."""
    recs = group_records(summary, "serve_hash")
    count(recs)
    what = (f"group serving fused hash tile_csr(kron20, {GROUP_SLOTS}) P=4, "
            f"4 gloo ranks")
    for p, r in enumerate(recs):
        for k in SHARD_PATH["fused hash"]:
            check(r["launches"].get(k, 0) > 0,
                  f"{what}: rank {p} launched {k}")
        check((r["ticks"], r["overflow_events"], r["quarantines"]) == (
            stacked["ticks"], 0, 0), f"{what}: rank {p} took the stacked "
              f"run's {stacked['ticks']} ticks, no overflow, no quarantine")
        check(r["lane_cap"] == stacked["lane_cap"] > 0,
              f"{what}: rank {p}'s lane_cap {r['lane_cap']} > 0, the "
              f"stacked run's")
    worst = 0.0
    for i, (q, twin) in enumerate(zip(served, stacked["queries"])):
        got = np.load(out / f"serve_hash.q{i}.npy")
        for want, against in ((q.result, "phase 6"), (twin.result,
                                                      "stacked")):
            if q.kind == "ppr":
                worst = max(worst, rel_err(got, want))
                check(np.allclose(got, want, rtol=1e-5, atol=0.0),
                      f"{what}: ppr {i} within rtol 1e-5 of {against} (max "
                      f"relative error {rel_err(got, want):.3g})")
            else:
                check(got.dtype == want.dtype and np.array_equal(got, want),
                      f"{what}: {q.kind} {i} equals {against}")
    sent = sum(r["sent_bytes"] for r in recs)
    check(sent > 0, f"{what}: the tagged exchange crossed ranks")
    print(f"{what}: 12 queries, {recs[0]['ticks']} ticks, lane_cap "
          f"{recs[0]['lane_cap']}; walls per rank (second runs) "
          f"{[round(r['wall_s'], 4) for r in recs]} s (first runs "
          f"{[round(r['first_wall_s'], 4) for r in recs]}; stacked "
          f"{stacked['wall']:.4f} s, {stacked['ticks']} ticks, launches "
          f"{stacked['launches']}), bytes through all_to_all_single per "
          f"rank {[r['sent_bytes'] for r in recs]} ({sent} in all), "
          f"launches per rank {[r['launches'] for r in recs]}, peak memory "
          f"per rank {[round(r['peak_bytes'] / 2**30, 2) for r in recs]} "
          f"GiB; BFS/SSSP equal phase 6 and stacked bit for bit, PPR max "
          f"relative error {worst:.3g} [{card}]")


def group_banked(g, summary, out: Path, count, card: str) -> None:
    """The four ranks' banked rows against B3's single-card banked layout
    on the same stream (see the module docstring)."""
    from repro_torch.kernels.iru_reorder import ops as hash_ops

    recs = group_records(summary, "banked")
    count(recs)
    what = "group banked rows kron20 pagerank add 1024 x 32 P=4, 4 gloo ranks"
    for p, r in enumerate(recs):
        check(r["partitions"] == [p], f"{what}: rank {p} holds partition {p}")
        check(r["launches"] == {"iru_reorder": 1},
              f"{what}: rank {p} launched iru_reorder once and nothing "
              f"else, got {r['launches']}")
    idx, vals = pagerank_stream(g)
    want = hash_ops.hash_reorder(idx, vals, filter_op="add", n_partitions=4)
    for field in FIELDS:
        ref = getattr(want, field)
        got = torch.from_numpy(np.load(out / f"banked.{field}.npy"))
        check(torch.equal(got.to(ref.device), ref),
              f"{what}: {field} equal to B3's single-card banked layout")
    ms = event_ms(lambda: hash_ops.hash_reorder(idx, vals, filter_op="add",
                                                n_partitions=4), reps=3)
    print(f"{what}: {idx.numel()} lanes, "
          f"{int(want.active.sum())} survivors, equal to B3's single-card "
          f"banked layout bit for bit; walls per rank (second runs) "
          f"{[round(r['wall_s'], 4) for r in recs]} s (first runs "
          f"{[round(r['first_wall_s'], 4) for r in recs]}; the single-card "
          f"banked layout {ms:.4f} ms), launches per rank "
          f"{[r['launches'] for r in recs]} [{card}]")
    del want, idx, vals
    torch.cuda.empty_cache()


def phase_group(g, stacked: dict, stacked_ep: dict, served: list,
                card: str) -> dict:
    """Phase 8b: (a) four gloo ranks on the one card, one kron-20 shard
    each (hash mode: B1 and B3 on every rank), held against phase 7's
    stacked runs, moe_hash_ep over four ranks against phase 8's stacked
    result, partitioned serving over the ranks against phase 6's fused
    hash queries (``served``) and the stacked engine, and the banked rows
    over the ranks against B3's single-card banked layout; (b) a group of
    one over NCCL against the single-device BFS.  Returns the launches of
    the ranks' timed runs and the stacked serving run, summed."""
    from repro_torch.launch.partitioned import parse_app

    t0 = time.perf_counter()
    totals: dict = {}

    def count(recs):
        for r in recs:
            for k, v in r["launches"].items():
                totals[k] = totals.get(k, 0) + v

    graph = GROUP_DIR / "kron20.npz"
    np.savez(graph, row_ptr=g.row_ptr.cpu().numpy(),
             col_idx=g.col_idx.cpu().numpy(),
             weights=g.weights.cpu().numpy())
    stacked_serving = stacked_group_serving(g, served)
    count([stacked_serving])
    serve_spec = GROUP_DIR / "serve_hash.json"
    serve_spec.write_text(json.dumps({
        "queries": [{"kind": q.kind, "source": q.source, "iters": q.iters,
                     "damping": q.damping} for q in served],
        "slots": GROUP_SLOTS, "mode": "hash", "max_ticks": 1000}))
    stacked_bytes = stacked["partition bytes"]
    runs = [a for spec in GROUP_RUNS for a in ("--app", spec)]
    out = GROUP_DIR / "gloo"
    summary, wall = launch_group("group gloo x4", [
        "--nproc", "4", "--backend", "gloo", "--graph", str(graph),
        "--mode", "hash", "--timeout", "120", "--out", str(out),
        "--moe", str(GROUP_DIR / "moe"), *runs, "--serve", str(serve_spec),
        "--reorder", GROUP_BANKED])
    print(f"group gloo x4 on one card: the launcher took {wall:.1f} s "
          f"(four process starts, each rank's graph load and partition, "
          f"the runs below) [{card}]")
    group_serving(summary, out, served, stacked_serving, count, card)
    group_banked(g, summary, out, count, card)
    for spec, key in GROUP_RUNS.items():
        label = parse_app(spec)["label"]
        want, steps, traffic, t_stacked = stacked[key]
        got = torch.from_numpy(np.load(out / f"{label}.npy"))
        recs = group_records(summary, label)
        count(recs)
        what = f"group kron20 {label} (codec {traffic['codec']}) 4 gloo ranks"
        check(all(r["supersteps"] == steps and r["traffic"] == traffic
                  for r in recs), f"{what}: every rank's supersteps and "
              f"boundary traffic equal the stacked run's")
        for p, r in enumerate(recs):
            for k in SHARD_PATH["hash"]:
                check(r["launches"].get(k, 0) > 0,
                      f"{what}: rank {p} launched {k}")
        sent = sum(r["sent_bytes"] for r in recs)
        check(sent == traffic["wire_bytes_total"],
              f"{what}: {sent} B through all_to_all_single, the codec's "
              f"wire {traffic['wire_bytes_total']} B")
        part_bytes = [r["partition_bytes"] for r in recs]
        check(sum(part_bytes) == stacked_bytes,
              f"{what}: the ranks' shards add up to the stacked partition")
        if key == ("pagerank", False):
            rel = rel_err(got.numpy(), want.numpy())
            check(torch.allclose(got, want, rtol=1e-5, atol=0.0),
                  f"{what}: within rtol 1e-5, atol 0 of stacked (max "
                  f"relative error {rel:.3g})")
            verdict = (f"against stacked max relative error {rel:.3g} (rtol "
                       f"1e-5, atol 0)")
        elif key[0] == "pagerank":
            # int8_ef: an ulp of the leak's sum order flips a code, and error
            # feedback carries the flip on, so a small rank can move far
            # from the stacked one; the whole vector stays close.  The L1
            # limit lies between the sound group runs' readings (PERF.md)
            # and that of a wire that skips the codec (exact payloads), read
            # here from the stacked exact run
            l1 = l1_rel(got, want)
            skip = l1_rel(stacked[("pagerank", False)][0], want)
            check(skip > EF_L1_LIMIT, f"{what}: the stacked exact run is "
                  f"{skip:.3g} from the stacked int8_ef run (L1), above the "
                  f"limit {EF_L1_LIMIT}")
            check(l1 <= EF_L1_LIMIT, f"{what}: L1 relative error {l1:.3g} "
                  f"against stacked, limit {EF_L1_LIMIT}")
            verdict = (f"against stacked L1 relative error {l1:.3g} (limit "
                       f"{EF_L1_LIMIT}; exact payloads would give {skip:.3g}"
                       f"), max relative error "
                       f"{rel_err(got.numpy(), want.numpy()):.3g}")
        else:
            check(torch.equal(got, want), f"{what}: equals stacked")
            verdict = "equals stacked bit for bit"
        first = max(r["first_wall_s"] for r in recs)
        print(f"{what}: {steps} supersteps, wall "
              f"{max(r['wall_s'] for r in recs):.4f} s (slowest rank, its "
              f"second run; the first {first:.4f} s; stacked "
              f"{t_stacked:.4f} s), wire "
              f"{traffic['wire_bytes_per_superstep']} B a superstep "
              f"({sent} B through all_to_all_single in all), launches per "
              f"rank {[r['launches'] for r in recs]}, partition bytes per "
              f"rank {part_bytes} (stacked {stacked_bytes}); {verdict} "
              f"[{card}]")
    recs = group_records(summary, "moe_exact")
    check(all(r["held"]["wi"][0] == 16 for r in recs),
          "group moe: each rank holds 16 of the 64 experts")
    ye = torch.from_numpy(np.load(out / "moe_exact.npy"))
    moe_close(ye, stacked_ep["exact"], "group moe_hash_ep 4 gloo ranks, "
              "exact, vs stacked 4 shards", 1e-5, 1e-6)
    for label in ("moe_exact", "moe_int8"):
        aux = torch.from_numpy(np.load(out / f"{label}_aux.npy"))
        check(torch.equal(aux, stacked_ep["aux"]),
              f"group {label}: aux equals stacked")
    yc = np.load(out / "moe_int8.npy")
    want = stacked_ep["int8"].numpy()
    blocks = np.pad(np.abs(want).reshape(-1), (0, (-want.size) % 128))
    quantum = blocks.reshape(-1, 128).max(1) / 127.0
    diff = np.pad(np.abs(yc - want).reshape(-1), (0, (-want.size) % 128))
    worst = float((diff.reshape(-1, 128).max(1) / np.maximum(
        quantum, 1e-30)).max())
    print(f"  group moe_hash_ep 4 gloo ranks, int8: max abs error "
          f"{float(np.abs(yc - want).max()):.4g} against stacked, worst "
          f"block {worst:.3g} quanta (bound 4)")
    check(worst <= 4, "group int8 combine within 4 quanta of stacked")
    walls = {label: [round(r["wall_s"], 4)
                     for r in group_records(summary, label)]
             for label in ("moe_exact", "moe_int8")}
    print(f"  group moe_hash_ep walls per rank (second runs), exact: "
          f"{walls['moe_exact']} s, int8: {walls['moe_int8']} s [{card}]")
    del summary

    # (b) a group of one over NCCL
    out = GROUP_DIR / "nccl"
    summary, wall = launch_group("group nccl x1", [
        "--nproc", "1", "--backend", "nccl", "--graph", str(graph),
        "--mode", "hash", "--timeout", "120", "--out", str(out),
        "--app", "bfs"])
    got = torch.from_numpy(np.load(out / "bfs.npy"))
    rec = summary[0][0]
    count([rec])
    check(torch.equal(got, stacked["single bfs"]),
          "group nccl x1 bfs: equals the single-device pipeline")
    for k in SHARD_PATH["hash"]:
        check(rec["launches"].get(k, 0) > 0, f"group nccl x1 bfs: {k}")
    print(f"group kron20 bfs 1 NCCL rank: {rec['supersteps']} supersteps, "
          f"wall {rec['wall_s']:.4f} s (its first run "
          f"{rec['first_wall_s']:.4f} s; the launcher {wall:.1f} s), launches "
          f"{rec['launches']}, partition bytes {rec['partition_bytes']}; "
          f"equals the single-device pipeline [{card}]")
    print(f"group phase: {time.perf_counter() - t0:.1f} s")
    return totals


# The LM substrate's model half (phase 9).  (a) checks at full width in f32:
# deepseek-v2-lite-16b and qwen3-32b cut to 2 layers (deepseek's dense layer
# 0 and one MoE layer), mamba2-130m whole.  (b) timings in bf16 with
# deepseek-v2-lite-16b whole (27 layers, full width) and mamba2-130m whole.
# The shapes are cut from the configs' own LM_SHAPES to keep the phase near
# two minutes: prefill_32k (S 32768, B 32) to B = 2, S = 4096; decode_32k
# (B 128 on a 32k cache) to B = 8 on a 4128-long cache (a 4096-token prompt
# and 32 steps).
LM_CHECKS = (("deepseek-v2-lite-16b", 2), ("qwen3-32b", 2),
             ("mamba2-130m", None))
LM_CHECK_TOKENS = (2, 300, 3)      # B, prompt (ragged over the 128 chunk), steps
LM_PREFILL = {"deepseek-v2-lite-16b": (2, 4096),  # B, S
              "mamba2-130m": (8, 4096)}
LM_DECODE = (8, 4096, 32)          # B, prompt, steps (cache 4096 + 32)
# LM serving: (a) f32 checks at 2 layers; (b) bf16 timing over LM_DECODE's
# cache with the launcher's prompts; (c) the launcher itself
SERVE_CHECK = (4, 10, (2, 12), (4, 8), (3, 6, 9), 1)  # slots, requests,
#   prompt tokens, new tokens (inclusive ranges), probes, the EOS request
SERVE_TIMED = (8, 16, 16)          # slots, requests, new tokens
SERVE_LAUNCH = ("--arch", "qwen3-32b", "--smoke", "--requests", "16",
                "--slots", "4")
LM_GROUPS = (  # profile group -> (module, functions the stack calls)
    ("attention", "repro_torch.models.transformer",
     ("mla_forward", "gqa_forward")),
    ("mamba", "repro_torch.models.transformer", ("mamba_forward",)),
    ("moe", "repro_torch.models.transformer", ("moe_ffn",)),
    ("dense ffn", "repro_torch.models.transformer", ("ffn",)),
    ("norms", "repro_torch.models.transformer", ("rms_norm",)),
    ("embedding", "repro_torch.models.embedding", ("embed",)),
    ("logits", "repro_torch.models.embedding", ("logits",)),
)


def lm_check_arch(arch: str, depth, card: str) -> None:
    """Prefill then decode steps against the full forward (the reference's
    own check, tests/test_models.py:66-88), f32, at full width."""
    import dataclasses

    from repro_torch.configs import ParallelConfig, get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.embedding import embed

    dev = torch.device("cuda", 0)
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=depth or cfg.n_layers,
                              dtype=torch.float32)
    if cfg.moe is not None:
        # capacity factor E / k: C >= T, so no lane is dropped and the full
        # forward and a 2-token decode step route alike (at 1.25 the
        # 606-token forward drops lanes a decode step keeps: capacity
        # semantics, not an error)
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    pcfg = ParallelConfig(attn_chunk=128)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    B, S, extra = LM_CHECK_TOKENS
    with torch.inference_mode():
        params, _ = T.init_params(cfg, pcfg, gen, dev)
        toks = torch.randint(0, cfg.vocab_size, (B, S + extra), generator=gen,
                             device=dev)
        full, _ = T.forward_train(params, cfg, pcfg, {"tokens": toks})
        cache = T.init_cache(cfg, pcfg, B, S + extra, device=dev)
        lg, cache = T.prefill(params, cfg, pcfg, {"tokens": toks[:, :S]},
                              cache)
        steps = [(lg[:, -1], full[:, S - 1])]
        for t in range(extra):
            lg, cache = T.decode_step(params, cfg, pcfg,
                                      toks[:, S + t:S + t + 1], cache, S + t)
            steps.append((lg[:, 0], full[:, S + t]))
        scale = float(full.abs().max())
        soft = max(float((torch.softmax(a, -1) - torch.softmax(b, -1))
                         .abs().max()) for a, b in steps)
        err = max(float((a - b).abs().max()) for a, b in steps)
        same = torch.equal(embed(params["embed"], toks, iru=True),
                           embed(params["embed"], toks, iru=False))
    print(f"lm check {arch} ({cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"f32, TF32 off): prefill {S} + {extra} decode steps at B={B} vs "
          f"forward_train: max softmax diff {soft:.3e} (atol 2e-3), max "
          f"logit diff {err:.3e} of max |logit| {scale:.4g} "
          f"({err / scale:.3e}, limit 1e-3); embed iru == plain bit for "
          f"bit: {same}  [{card}]")
    check(soft <= 2e-3, f"{arch}: prefill/decode softmax within 2e-3")
    check(err <= 1e-3 * scale, f"{arch}: prefill/decode logits within 1e-3 "
          "of max |logit|")
    check(same, f"{arch}: embed(iru=True) equals embed(iru=False)")


class _Ranges:
    """Wrap the calls of ``groups`` (group, module, function names) in a
    profiler range and a pair of CUDA events each, to split a run's device
    time by group (the stack's layer kinds, or a train step's phases); the
    functions are restored on exit."""

    def __init__(self, groups=LM_GROUPS):
        self.groups = groups
        self.spans: dict[str, list] = {g: [] for g, _, _ in groups}
        self.saved = []

    def __enter__(self):
        import importlib

        from torch.profiler import record_function

        for group, mod, names in self.groups:
            m = importlib.import_module(mod)
            for name in names:
                fn = getattr(m, name)
                self.saved.append((m, name, fn))

                def wrapped(*a, _fn=fn, _g=group, **kw):
                    ev = [torch.cuda.Event(enable_timing=True)
                          for _ in range(2)]
                    with record_function(f"lm::{_g}"):
                        ev[0].record()
                        out = _fn(*a, **kw)
                        ev[1].record()
                    self.spans[_g].append(ev)
                    return out

                setattr(m, name, wrapped)
        return self

    def __exit__(self, *exc):
        for m, name, fn in self.saved:
            setattr(m, name, fn)

    def span_ms(self) -> dict[str, float]:
        torch.cuda.synchronize()
        return {g: sum(s.elapsed_time(e) for s, e in ev)
                for g, ev in self.spans.items()}


def lm_profile(label: str, fn, card: str, top: int = 10,
               groups=LM_GROUPS) -> None:
    """One torch.profiler pass of ``fn`` (after a warm-up, as
    ``profile_window``): device time by layer kind (the profiler's device
    total under each ``lm::`` range, and the CUDA-event spans of the same
    calls) and the top ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()  # warm-up
    for _ in range(3):  # a session sometimes records no device event
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            wall_s(fn)
            prof.step()
            with _Ranges(groups) as ranges:
                _, wall = wall_s(fn)
            spans = ranges.span_ms()
        rows = []  # device-side events only (kernels, copies, memsets)
        for e in prof.key_averages():
            if (e.device_type == DeviceType.CUDA
                    and e.self_device_time_total > 0
                    and not e.key.startswith(("lm::", "ProfilerStep"))):
                rows.append((e.self_device_time_total, e.count, e.key))
        if rows:
            break
    totals = {g: 0.0 for g, _, _ in groups}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name.startswith("lm::"):
            totals[e.name[4:]] += e.device_time_total / 1e3
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e3
    print(f"lm profile {label}: wall {wall * 1e3:.1f} ms, device busy "
          f"{busy:.3f} ms ({busy / (wall * 1e3):.3f} of wall)  [{card}]")
    for g, _, _ in groups:
        if spans[g] or totals[g]:
            print(f"  {g:<10} profiler {totals[g]:9.3f} ms "
                  f"({totals[g] / max(busy, 1e-9):.3f} of busy), event "
                  f"spans {spans[g]:9.3f} ms")
    print(f"  other      profiler {busy - sum(totals.values()):9.3f} ms")
    for dev_us, count, key in rows[:top]:
        print(f"  {dev_us / 1e3:9.4f} ms  x{count:<6d} {key[:100]}")


def lm_timings(arch: str, card: str, profile: bool,
               serve: bool = False) -> None:
    """Build ``arch`` whole in bf16 on the card, then time prefill
    (``LM_PREFILL[arch]``), decode (``LM_DECODE``) and profile one
    prefill; with ``serve``, then serve ``SERVE_TIMED`` on the same
    params."""
    from repro_torch.configs import ParallelConfig, get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.measure import tree_leaves

    dev = torch.device("cuda", 0)
    cfg, pcfg = get_config(arch), ParallelConfig()
    meta, _ = T.abstract_params(cfg, pcfg)
    count = sum(v.numel() for v in tree_leaves(meta))
    print(f"lm {arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"vocab {pcfg.padded_vocab(cfg.vocab_size)}: "
          f"{count / 1e9:.4f} B params (abstract_params on meta) against "
          f"params_billions() {cfg.params_billions():.4f} B")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.synchronize()
    held0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        (params, _), build = wall_s(lambda: T.init_params(cfg, pcfg, gen, dev))
        held = torch.cuda.memory_allocated() - held0
        peak = torch.cuda.max_memory_allocated() - held0
        print(f"lm {arch} build: {build:.3f} s, {held / 2**30:.3f} GiB held "
              f"(peak {peak / 2**30:.3f} GiB while building), bf16  [{card}]")
        check(count == sum(v.numel() for v in tree_leaves(params)),
              f"{arch}: built params match abstract_params")

        B, S = LM_PREFILL[arch]
        toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                             device=dev)
        cache = T.init_cache(cfg, pcfg, B, S, device=dev)
        run = lambda: T.prefill(params, cfg, pcfg, {"tokens": toks}, cache)  # noqa: E731
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms = event_median_ms(run, reps=5)
        peak = torch.cuda.max_memory_allocated() - base
        lg, _ = run()
        check(lg.shape == (B, 1, pcfg.padded_vocab(cfg.vocab_size))
              and bool(torch.isfinite(lg).all()), f"{arch}: finite prefill")
        print(f"lm {arch} prefill B={B} S={S} bf16: {ms:.4f} ms (median of "
              f"5), {B * S / ms * 1e3:.0f} prompt tokens/s, peak "
              f"{peak / 2**30:.3f} GiB above {base / 2**30:.3f} held  "
              f"[{card}]")
        if profile:
            lm_profile(f"{arch} prefill B={B} S={S} bf16, one call", run,
                       card)
        del cache, run, lg

        B, S, steps = LM_DECODE
        cache = T.init_cache(cfg, pcfg, B, S + steps, device=dev)
        toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                             device=dev)
        lg, cache = T.prefill(params, cfg, pcfg, {"tokens": toks}, cache)
        tok = lg[:, -1].argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        marks = []
        pos = torch.full((), S, dtype=torch.int32, device=dev)
        for _ in range(steps):  # greedy: each step feeds the last argmax
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            lg, cache = T.decode_step(params, cfg, pcfg, tok, cache, pos)
            tok = lg[:, 0].argmax(-1, keepdim=True)
            pos = pos + 1  # on the card: no host copy a step
            ev[1].record()
            marks.append(ev)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        step_ms = [s.elapsed_time(e) for s, e in marks]
        med = float(np.median(step_ms[1:]))  # the first step warms up
        check(bool(torch.isfinite(lg).all()), f"{arch}: finite decode")
        print(f"lm {arch} decode B={B} cache {S + steps} bf16: {med:.4f} ms "
              f"a step (median of steps 2-{steps}; first {step_ms[0]:.4f}), "
              f"{B / med * 1e3:.0f} tokens/s, peak {peak / 2**30:.3f} GiB "
              f"above {base / 2**30:.3f} held  [{card}]")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:  # the step reads nothing on the host with a device pos
            T.decode_step(params, cfg, pcfg, tok, cache, pos)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        print(f"lm {arch} decode_step with a device pos ran under "
              f"set_sync_debug_mode('error'): no host sync")
        if profile:
            lm_profile(f"{arch} decode step B={B} cache {S + steps} bf16",
                       lambda: T.decode_step(params, cfg, pcfg, tok, cache,
                                             pos), card)
        del cache, lg, tok, toks
        if serve:
            lm_serve_timing(cfg, pcfg, params, S + steps, med, card)
        del params
    torch.cuda.empty_cache()


def _serving_engine(cfg, pcfg, params, slots: int, max_seq: int):
    from repro_torch.serve import ServeConfig, ServingEngine

    return ServingEngine(cfg, pcfg, params, ServeConfig(batch_slots=slots,
                                                        max_seq=max_seq))


def lm_serve_checks(card: str) -> None:
    """LM serving (a), f32: the continuous-batching engine at
    deepseek-v2-lite-16b's width cut to 2 layers; crowd against solo (the
    reference's tests/test_serving.py:37 at full width), EOS, slot reuse."""
    import dataclasses

    from repro_torch.configs import ParallelConfig, get_config
    from repro_torch.models import transformer as T
    from repro_torch.serve import Request

    dev = torch.device("cuda", 0)
    cfg = get_config("deepseek-v2-lite-16b")
    cfg = dataclasses.replace(cfg, n_layers=2, dtype=torch.float32)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    pcfg = ParallelConfig(remat="none", attn_chunk=128)
    slots, n_req, (p_lo, p_hi), (m_lo, m_hi), probes, eos_at = SERVE_CHECK
    max_seq = p_hi + m_hi + 1
    t0 = time.perf_counter()
    with torch.inference_mode():
        params, _ = T.init_params(cfg, pcfg,
                                  torch.Generator(device=dev).manual_seed(SEED),
                                  dev)
        rng = np.random.default_rng(SEED)
        spec = [(rng.integers(0, cfg.vocab_size, int(rng.integers(
                    p_lo, p_hi + 1))).astype(np.int32),
                 int(rng.integers(m_lo, m_hi + 1))) for _ in range(n_req)]

        def solo(prompt, max_new):
            eng = _serving_engine(cfg, pcfg, params, 1, max_seq)
            req = Request(prompt=prompt.copy(), max_new_tokens=max_new)
            eng.submit(req)
            eng.run_to_completion()
            return req.generated

        eos_id = solo(spec[eos_at][0], 1)[0]
        alone = {i: solo(*spec[i]) for i in probes}
        eng = _serving_engine(cfg, pcfg, params, slots, max_seq)
        reqs = [Request(prompt=p.copy(), max_new_tokens=m,
                        eos_id=eos_id if i == eos_at else None)
                for i, (p, m) in enumerate(spec)]
        for r in reqs:
            eng.submit(r)
        admitted, ticks = [], [0]  # (tick, slot, rid) of each admission
        admit, tick = eng._admit, eng.tick

        def counted_admit(slot, req):
            admitted.append((ticks[0], slot, req.rid))
            admit(slot, req)

        def counted_tick():
            left = tick()
            ticks[0] += 1
            return left

        eng._admit, eng.tick = counted_admit, counted_tick
        eng.run_to_completion()
    secs = time.perf_counter() - t0
    counts_ok = all(r.done and len(r.generated)
                    == (1 if i == eos_at else spec[i][1])
                    for i, r in enumerate(reqs))
    eos_tick, eos_slot = next((t, s) for t, s, rid in admitted
                              if rid == reqs[eos_at].rid)
    reused = [(t, rid) for t, s, rid in admitted
              if s == eos_slot and t > eos_tick]
    same = {i: reqs[i].generated == alone[i] for i in probes}
    print(f"lm serve check deepseek-v2-lite-16b ({cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, f32, TF32 off): {n_req} requests on "
          f"{slots} slots in {ticks[0]} ticks, {secs:.1f} s with "
          f"{1 + len(probes)} solo runs; tokens {[len(r.generated) for r in reqs]}; EOS request "
          f"{eos_at} (eos_id {eos_id}) admitted at tick {eos_tick} into slot "
          f"{eos_slot}, generated {reqs[eos_at].generated}, slot next taken "
          f"by {reused[:1]} (tick, rid); probes crowd == solo: {same}  "
          f"[{card}]")
    check(counts_ok, "lm serve: every request done with its token count")
    check(len(reqs[eos_at].generated) == 1,
          "lm serve: the EOS request stops after one token")
    check(bool(reused) and reused[0][0] == eos_tick + 1,
          "lm serve: the EOS request's slot is taken at the next tick")
    check(all(same.values()), "lm serve: crowd tokens equal solo tokens")
    del eng, params
    torch.cuda.empty_cache()


def lm_serve_timing(cfg, pcfg, params, max_seq: int, decode_ms: float,
                    card: str) -> None:
    """LM serving (b), bf16: the launcher's requests on ``SERVE_TIMED``'s
    slots over the decode cache, with the model of ``lm_timings``."""
    from repro_torch.launch.serve import make_requests

    slots, n_req, max_new = SERVE_TIMED
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    eng = _serving_engine(cfg, pcfg, params, slots, max_seq)
    reqs = make_requests(n_req, cfg.vocab_size, max_new, SEED)
    for r in reqs:
        eng.submit(r)
    steps = {"replay": 0, "tick": 0}
    raw = eng._step_raw

    def counted(batch_tok, update_only=None):
        steps["tick" if update_only is None else "replay"] += 1
        return raw(batch_tok, update_only)

    eng._step_raw = counted
    _, secs = wall_s(eng.run_to_completion)
    peak = torch.cuda.max_memory_allocated() - base
    n_steps = steps["replay"] + steps["tick"]
    toks = sum(len(r.generated) for r in reqs)
    replay = sum(len(r.prompt) - 1 for r in reqs)
    print(f"lm serve {cfg.name} whole ({cfg.n_layers} layers) bf16: {n_req} "
          f"requests (prompts {min(len(r.prompt) for r in reqs)}-"
          f"{max(len(r.prompt) for r in reqs)} tokens, {max_new} new) on "
          f"{slots} slots, cache {max_seq}: {secs:.3f} s wall, "
          f"{steps['tick']} ticks, {n_steps} decode steps ({steps['replay']} "
          f"admission replays + {steps['tick']} ticks), "
          f"{secs / n_steps * 1e3:.4f} ms a step (decode_step median "
          f"{decode_ms:.4f}), {toks} tokens, {toks / secs:.2f} generated "
          f"tokens/s, peak {peak / 2**30:.3f} GiB above {base / 2**30:.3f} "
          f"held  [{card}]")
    check(all(r.done and len(r.generated) == max_new for r in reqs),
          "lm serve: every timed request done with its token count")
    check(steps["replay"] == replay, "lm serve: one replay step a prompt "
          "token but the last")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated),
          "lm serve: tokens in the vocabulary")
    del eng


def lm_serve_launcher(card: str) -> None:
    """LM serving (c): the serve launcher once on the card, in process."""
    import contextlib
    import io

    from repro_torch.launch import serve as launch_serve

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        reqs = launch_serve.main(list(SERVE_LAUNCH))
    secs = time.perf_counter() - t0
    line = out.getvalue().strip().splitlines()[-1]
    print(f"lm serve launcher ({' '.join(SERVE_LAUNCH)}): {line}; "
          f"{secs:.1f} s with the model's build  [{card}]")
    check(line.startswith(f"served {len(reqs)} requests / ")
          and line.endswith("continuous batching)"),
          "lm serve launcher prints its summary")
    check(all(r.done and len(r.generated) == 16 for r in reqs),  # --max-new
          "lm serve launcher: every request done")
    torch.cuda.empty_cache()


def phase_lm(card: str) -> None:
    """Phase 9 (``lm`` lines): the LM's model half (configs, the IRU embedding, GQA/MLA
    attention, Mamba-2, the stack's forward, prefill and decode) and LM
    serving (the continuous-batching engine, the serve launcher); plain
    torch, no hand-written kernel.  (a) f32 checks at full width; (b) bf16
    timings with deepseek-v2-lite-16b whole and mamba2-130m whole; (c) the
    serve launcher."""
    t0 = time.perf_counter()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for arch, depth in LM_CHECKS:
            lm_check_arch(arch, depth, card)
            torch.cuda.empty_cache()
        lm_serve_checks(card)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    print(f"lm checks: {time.perf_counter() - t0:.1f} s")
    lm_timings("deepseek-v2-lite-16b", card, profile=True, serve=True)
    lm_timings("mamba2-130m", card, profile=True)
    lm_serve_launcher(card)
    print(f"lm phase: {time.perf_counter() - t0:.1f} s")


# LM training (phase 10).  The deepseek cut to 4 layers is forced by the
# card: 27 layers hold 15.7 B params, whose bf16 params and grads alone are
# 63 GB before any moment; 4 layers (the dense layer 0 and 3 MoE layers)
# hold 2.2550 B.  B = 2 of train_4k's 256 at its S = 4096.
TRAIN_CHECK = ("deepseek-v2-lite-16b", 2, 2, 512)  # arch, layers, B, S (f32)
TRAIN_SMALL = (2, 512)              # B, S of mamba2-130m's f32 checks
TRAIN_RESUME = (8, 6, 4)            # steps, die_at, ckpt_every
TRAIN_TRACK_STEPS = 20              # int8 against fp32 on a fixed batch
TRAIN_TIMED = {"deepseek-v2-lite-16b": (4, 2, 4096),  # layers, B, S (bf16)
               "mamba2-130m": (None, 8, 4096)}
TRAIN_STEPS = (2, 3, 5)             # warm-up, timed (median), steps in all
TRAIN_GROUPS = (  # profile group -> (module, functions a train step calls)
    ("forward", "repro_torch.models.transformer", ("forward_train",)),
    ("loss", "repro_torch.train.trainer", ("softmax_xent",)),
    ("backward", "torch.autograd", ("grad",)),
    ("optimizer", "repro_torch.train.trainer", ("adamw_update",)),
)
TRAIN_LAUNCH = ("--arch", "mamba2-130m", "--steps", "15", "--batch", "8",
                "--seq", "1024", "--ckpt", "build/train_smoke",
                "--ckpt-every", "5", "--inject-faults")


def _train_cfg(arch: str, layers=None, *, dtype=None, no_drop=False):
    """``arch`` at its published widths, cut to ``layers``, with the
    planned dispatch (whose stats the trainer logs)."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=layers or cfg.n_layers,
                              dtype=dtype or cfg.dtype)
    if cfg.moe is not None:
        cf = cfg.moe.n_experts / cfg.moe.top_k if no_drop else 1.25
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch="iru_hash", capacity_factor=cf))
    return cfg


def _max_leaf_err(got: dict, want: dict) -> float:
    """Largest |got - want| over the leaves, each over its leaf's largest
    |want|."""
    from repro_torch.models.measure import tree_leaves

    return max(float((g.float() - w.float()).abs().max())
               / max(float(w.float().abs().max()), 1e-30)
               for g, w in zip(tree_leaves(got), tree_leaves(want)))


def train_checks(card: str) -> None:
    """Phase 10 (a): f32 checks at full width, TF32 off."""
    from repro_torch.configs import ParallelConfig
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import make_batch
    from repro_torch.train import TrainConfig, init_state, make_grad_fn

    dev = torch.device("cuda", 0)
    arch, layers, B, S = TRAIN_CHECK
    cfg = _train_cfg(arch, layers, dtype=torch.float32, no_drop=True)
    # aux_weight 0: the load-balance loss of a microbatch is not the mean
    # of the whole batch's, so only the cross-entropy's grads split exactly
    tc = TrainConfig(aux_weight=0.0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    state = init_state(cfg, ParallelConfig(), tc, gen, dev)
    batch = make_batch(cfg, ShapeConfig("check", S, B, "train"), 0,
                       device=dev)
    runs = {}
    for remat, mb in (("none", 1), ("full", 1), ("none", 2)):
        pcfg = ParallelConfig(remat=remat, microbatches=mb)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        grads, loss, _, moem = make_grad_fn(cfg, pcfg, tc)(state["params"],
                                                          batch)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        runs[remat, mb] = (grads, float(loss), moem, peak)
    g1, l1, m1, p1 = runs["none", 1]
    for key, what in ((("full", 1), "remat full vs none"),
                      (("none", 2), "microbatches 2 vs 1")):
        g, l, m, p = runs[key]
        err, lrel = _max_leaf_err(g, g1), abs(l - l1) / abs(l1)
        print(f"train check {arch} ({layers} layers, f32, TF32 off, B={B} "
              f"S={S}): {what}: loss {l:.7f} vs {l1:.7f} (rel {lrel:.3e}, "
              f"limit 1e-6), largest grad error {err:.3e} of its leaf's "
              f"largest (limit 1e-5); step peak {p / 2**30:.3f} vs "
              f"{p1 / 2**30:.3f} GiB; drop rate "
              f"{float(m['moe_drop_rate'].max()):.4f}  [{card}]")
        check(lrel <= 1e-6, f"train {what}: loss within 1e-6")
        check(err <= 1e-5, f"train {what}: grads within 1e-5 of the leaf")
    check(float(m1["moe_drop_rate"].max()) == 0.0,
          "train check: no lane dropped at capacity factor E / k")
    del state, runs, g1, g, grads, batch
    torch.cuda.empty_cache()

    # mamba2-130m whole: an uninterrupted run against a supervised one
    # that dies at step 6 and resumes from the step-4 checkpoint.  Both run
    # with torch's deterministic algorithms: the embedding backward's float
    # index_add otherwise sums in atomics' order, and Adam's first steps
    # (m / sqrt(v), about sign(g)) turn a last-bit difference in a grad
    # near zero into a whole lr step (1.7e-4 of the loss after 8 steps on
    # an H100)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        train_resume(card)
    finally:
        torch.use_deterministic_algorithms(False)
    train_track(card)
    torch.cuda.empty_cache()


def train_resume(card: str) -> None:
    """mamba2-130m whole, f32: an uninterrupted run against a supervised
    one that dies and resumes from a checkpoint."""
    import shutil

    from repro_torch.ckpt import CheckpointManager, restore_checkpoint
    from repro_torch.configs import ParallelConfig
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import make_batch
    from repro_torch.ft import (FaultInjector, FaultPlan, Supervisor,
                                SupervisorConfig)
    from repro_torch.models.measure import tree_leaves
    from repro_torch.train import TrainConfig, init_state, make_train_step

    dev = torch.device("cuda", 0)
    cfg = _train_cfg("mamba2-130m", dtype=torch.float32)
    pcfg = ParallelConfig()
    B, S = TRAIN_SMALL
    steps, die_at, every = TRAIN_RESUME
    tc = TrainConfig(warmup_steps=1, total_steps=steps)
    shape = ShapeConfig("check", S, B, "train")
    step_fn = make_train_step(cfg, pcfg, tc)

    def batch_fn(s):
        return make_batch(cfg, shape, s, device=dev)

    state = init_state(cfg, pcfg, tc, torch.Generator(device=dev)
                       .manual_seed(SEED), dev)
    base = []
    for s in range(steps):
        state, m = step_fn(state, batch_fn(s))
        base.append(float(m["loss"]))
    del state
    ckpt = ROOT / "build" / "train_resume"
    shutil.rmtree(ckpt, ignore_errors=True)
    sup = Supervisor(CheckpointManager(str(ckpt)),
                     SupervisorConfig(ckpt_every=every),
                     injector=FaultInjector(FaultPlan(die_at=(die_at,))))
    state = init_state(cfg, pcfg, tc, torch.Generator(device=dev)
                       .manual_seed(SEED), dev)
    (state, last), secs = wall_s(lambda: sup.run(state, step_fn, batch_fn,
                                                 0, steps))
    by_step = {h["step"]: h["loss"] for h in sup.history}
    rel = max(abs(by_step[s] - base[s]) / abs(base[s]) for s in range(steps))
    exact = all(by_step[s] == base[s] for s in range(steps))
    saved = restore_checkpoint(str(ckpt), state, device=dev)
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(saved),
                                                  tree_leaves(state)))
    print(f"train check mamba2-130m (whole, f32, B={B} S={S}): {steps} "
          f"steps uninterrupted vs Supervisor with die_at={die_at}, "
          f"ckpt_every={every}: restarts {sup.restarts}, history steps "
          f"{[h['step'] for h in sup.history]}, largest loss rel diff "
          f"{rel:.3e} (limit 1e-5; equal: {exact}), deterministic "
          f"algorithms; last checkpoint restores bit for bit: "
          f"{same}; {secs:.1f} s with the checkpoints  [{card}]")
    check(last == steps and sup.restarts == 1, "train resume: one restart")
    check(rel <= 1e-5, "train resume: trajectories within rtol 1e-5")
    check(same, "train resume: checkpoint restores bit for bit")
    shutil.rmtree(ckpt, ignore_errors=True)


def train_track(card: str) -> None:
    """int8 moments track fp32 on a fixed batch (mamba2-130m, f32)."""
    from repro_torch.configs import ParallelConfig
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import make_batch
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, init_state, make_train_step

    dev = torch.device("cuda", 0)
    cfg, pcfg = _train_cfg("mamba2-130m", dtype=torch.float32), ParallelConfig()
    B, S = TRAIN_SMALL
    batch = make_batch(cfg, ShapeConfig("check", S, B, "train"), 0,
                       device=dev)
    tracks = {}
    for sd in ("fp32", "int8"):
        tc = TrainConfig(adam=AdamWConfig(state_dtype=sd), warmup_steps=1,
                         total_steps=TRAIN_TRACK_STEPS)
        state = init_state(cfg, pcfg, tc, torch.Generator(device=dev)
                           .manual_seed(SEED), dev)
        step_fn = make_train_step(cfg, pcfg, tc)
        losses = []
        for _ in range(TRAIN_TRACK_STEPS):
            state, m = step_fn(state, batch)
            losses.append(m["loss"])
        tracks[sd] = [float(x) for x in losses]
        del state
    a, b = tracks["fp32"], tracks["int8"]
    rel = abs(b[-1] - a[-1]) / abs(a[-1])
    print(f"train check mamba2-130m int8 vs fp32 moments, "
          f"{TRAIN_TRACK_STEPS} steps on one batch: loss {a[0]:.4f} -> "
          f"fp32 {a[-1]:.4f}, int8 {b[-1]:.4f} (rel {rel:.3f}, limit 0.5)"
          f"  [{card}]")
    check(rel <= 0.5 and a[-1] < a[0] and b[-1] < b[0],
          "train: int8 moments track fp32")


def _gib(tree) -> float:
    from repro_torch.models.measure import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)) / 2**30


def train_timings(arch: str, card: str, profile: bool) -> None:
    """Phase 10 (b): ``arch`` in bf16 at ``TRAIN_TIMED[arch]``, remat
    full, on the Zipf stream; fp32 moments, then int8."""
    from repro_torch.configs import ParallelConfig
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import make_batch
    from repro_torch.models.measure import tree_leaves
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import (TrainConfig, abstract_state, init_state,
                                   make_train_step)

    dev = torch.device("cuda", 0)
    layers, B, S = TRAIN_TIMED[arch]
    cfg, pcfg = _train_cfg(arch, layers), ParallelConfig(remat="full")
    shape = ShapeConfig("train", S, B, "train")
    warm, timed, total = TRAIN_STEPS
    for sd in ("fp32", "int8"):
        tc = TrainConfig(adam=AdamWConfig(state_dtype=sd), warmup_steps=2,
                         total_steps=total)
        meta, _ = abstract_state(cfg, pcfg, tc)
        count = sum(v.numel() for v in tree_leaves(meta["params"]))
        torch.cuda.synchronize()
        held0 = torch.cuda.memory_allocated()
        state, build = wall_s(lambda: init_state(
            cfg, pcfg, tc, torch.Generator(device=dev).manual_seed(SEED),
            dev))
        held = torch.cuda.memory_allocated() - held0
        print(f"train {arch} ({cfg.n_layers} layers, d_model {cfg.d_model}, "
              f"bf16, {sd} moments): {count / 1e9:.4f} B params "
              f"(abstract_state on meta); build {build:.3f} s; "
              f"{held / 2**30:.3f} GiB held: params "
              f"{_gib(state['params']):.3f}, moments "
              f"{_gib(state['opt']):.3f}; grads {_gib(meta['params']):.3f} "
              f"GiB while a step runs  [{card}]")
        step_fn = make_train_step(cfg, pcfg, tc)
        batches = [make_batch(cfg, shape, s, device=dev)
                   for s in range(total)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        marks, metrics = [], []
        for s in range(total):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            state, m = step_fn(state, batches[s])
            ev[1].record()
            marks.append(ev)
            metrics.append(m)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - held0
        ms = [a.elapsed_time(b) for a, b in marks]
        med = float(np.median(ms[warm:warm + timed]))
        losses = [float(m["loss"]) for m in metrics]
        line = (f"train {arch} {sd} moments, B={B} S={S}, remat full: "
                f"{med:.4f} ms a step (median of steps {warm + 1}-"
                f"{warm + timed}; first {ms[0]:.1f}), "
                f"{B * S / med * 1e3:.0f} tokens/s, peak "
                f"{peak / 2**30:.3f} GiB; loss over {total} steps "
                f"{[round(x, 4) for x in losses]}")
        if "moe_drop_rate" in metrics[-1]:
            drop = torch.stack([m["moe_drop_rate"] for m in metrics])
            imb = torch.stack([m["moe_load_imbalance"] for m in metrics])
            line += (f"; moe_drop_rate mean {float(drop.mean()):.4f} max "
                     f"{float(drop.max()):.4f}, moe_load_imbalance mean "
                     f"{float(imb.mean()):.3f} max {float(imb.max()):.3f}")
        print(line + f"  [{card}]")
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"train {arch} {sd}: finite loss that falls")
        if profile and sd == "fp32":
            batch = batches[-1]
            lm_profile(f"train {arch} one step (B={B} S={S}, fp32 moments)",
                       lambda: step_fn(state, batch), card,
                       groups=TRAIN_GROUPS)
        del state, batches, metrics, marks
        torch.cuda.empty_cache()


def train_launcher(card: str) -> None:
    """Phase 10 (c): the launcher as a user runs it, in a subprocess."""
    import os
    import shutil

    ckpt = ROOT / "build" / "train_smoke"
    shutil.rmtree(ckpt, ignore_errors=True)  # the launcher resumes LATEST
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        *TRAIN_LAUNCH], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    tail = r.stdout.strip().splitlines()[-4:]
    print(f"train launcher ({' '.join(TRAIN_LAUNCH)}): exit "
          f"{r.returncode} in {secs:.1f} s; " + " | ".join(tail)
          + f"  [{card}]")
    check(r.returncode == 0, f"train launcher exits 0: {r.stderr[-2000:]}")
    with open(ckpt / "train_summary.json") as f:
        summary = json.load(f)
    print(f"train launcher summary: {summary}")
    check(summary["steps"] == 15 and summary["restarts"] == 1
          and summary["nan_events"] == 1, "train launcher summary")
    shutil.rmtree(ckpt, ignore_errors=True)


def phase_train(card: str) -> None:
    """Phase 10 (``train`` lines): LM training (AdamW in three moment
    precisions, the schedule, the z-loss cross-entropy, the train step with
    microbatches and remat, the Zipf stream, checkpoints, the supervisor
    and the launcher; plain torch, no hand-written kernel)."""
    t0 = time.perf_counter()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        train_checks(card)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    print(f"train checks: {time.perf_counter() - t0:.1f} s")
    train_timings("deepseek-v2-lite-16b", card, profile=True)
    train_timings("mamba2-130m", card, profile=False)
    train_launcher(card)
    print(f"train phase: {time.perf_counter() - t0:.1f} s")


def phase_timings(g, dsts, contrib, sparse, plain_s):
    """CUDA-event times of the kernels at PageRank's shape beside their
    plain versions, library calls and bounds.  B3's plain versions peel
    about a thousand rounds a call: their times are the wall seconds of
    phase 2's calls on the same inputs (``plain_s``)."""
    from repro_torch.kernels.coalesced_gather import ops as gather_ops
    from repro_torch.kernels.coalesced_gather.ref import coalesced_gather_ref
    from repro_torch.kernels.segment_merge import ops as merge_ops
    from repro_torch.kernels.segment_merge.ref import segment_merge_ref

    dev = g.device
    n = g.n_edges
    # B1 at PageRank's shape: the all-nodes expansion's offsets, D = 1
    eids = torch.arange(n, dtype=torch.int32, device=dev)
    b1 = {
        "ms": event_ms(lambda: gather_ops.csr_edge_gather(g.col_idx, eids)),
        "plain_ms": event_ms(lambda: coalesced_gather_ref(g.col_idx, eids)),
        "library_ms": event_ms(lambda: torch.index_select(g.col_idx, 0,
                                                          eids)),
        "gpu_setting_ms": event_ms(lambda: gather_ops.csr_edge_gather(
            g.col_idx, eids, group=256, window=256)),
        # indices in, rows out, and each table row the stream touches once
        "bytes": n * 4 + n * 4 + int(torch.unique(eids).numel()) * 4,
    }
    # B2 at PageRank's shape: the sorted full stream, f32 add, all live
    active = torch.ones(n, dtype=torch.bool, device=dev)
    b2 = {
        "ms": event_ms(lambda: merge_ops.segment_merge(dsts, contrib, op="add",
                                                       active=active)),
        "plain_ms": event_ms(lambda: segment_merge_ref(dsts, contrib, "add",
                                                       active)),
        "library_ms": event_ms(lambda: torch.zeros(
            g.n_nodes, device=dev).scatter_reduce_(
                0, dsts.long(), contrib, reduce="sum")),
        # idx 4 + vals 4 + active 1 read, merged 4 + survivor 1 written
        "bytes": n * (4 + 4 + 1) + n * (4 + 1),
    }
    # B3 at PageRank's shape: every edge's destination, f32 add, all live.
    # No single PyTorch call computes the IRU hash, so there is no library
    # time.
    from repro_torch.kernels.iru_reorder import ops as hash_ops

    pr_idx, pr_vals = pagerank_stream(g)
    b3 = {
        "ms": event_ms(lambda: hash_ops.hash_reorder(pr_idx, pr_vals,
                                                     filter_op="add")),
        "plain_ms": plain_s["iru_reorder"] * 1e3,
        "library_ms": None,
        # idx 4 + vals 4 read; idx 4 + vals 4 + pos 4 + active 1 written
        "bytes": n * (4 + 4) + n * (4 + 4 + 4 + 1),
    }
    # the tagged bodies at the same shapes, tags from the per-node table.
    # No single PyTorch call computes either function.
    table = family_table(g)
    tags = table[dsts.long()]
    b2t = {
        "ms": event_ms(lambda: merge_ops.segment_merge(
            dsts, contrib, op="tagged", active=active, tags=tags)),
        "plain_ms": event_ms(lambda: segment_merge_ref(dsts, contrib,
                                                       "tagged", active,
                                                       tags)),
        "library_ms": None,
        # idx 4 + vals 4 + active 1 + tag 1 read, merged 4 + survivor 1
        "bytes": n * (4 + 4 + 1 + 1) + n * (4 + 1),
    }
    b3t = {
        "ms": event_ms(lambda: hash_ops.hash_reorder(
            pr_idx, pr_vals, filter_op="tagged", tag_table=table)),
        "plain_ms": plain_s["iru_reorder_tagged"] * 1e3,
        "library_ms": None,
        # B3's bytes and the tag table read once
        "bytes": n * (4 + 4) + table.numel() + n * (4 + 4 + 4 + 1),
    }
    # B3 under the 4 x 2 round-cap geometry (no window): every partition of
    # this stream is past the cap, so all of it takes the fallback (its own
    # sort by index, the runs' firsts ranked, each run folded).  No PyTorch
    # call computes the function; its sort stage is set beside
    # torch.sort(stable=True) of the same keys.
    cap_kw = dict(num_sets=1024, slots=32, n_partitions=4, round_cap=64)
    b3c = {
        "ms": event_ms(lambda: hash_ops.hash_reorder(
            pr_idx, pr_vals, filter_op="add", **cap_kw)),
        "plain_ms": plain_s["iru_reorder_round_cap"] * 1e3,
        "library_ms": None,
        "bytes": n * (4 + 4) + n * (4 + 4 + 4 + 1),
    }
    sort_ms = event_ms(lambda: torch.sort(pr_idx, stable=True))
    variants = {
        "tagged, 4 partitions": (dict(filter_op="tagged", tag_table=table,
                                      **cap_kw),
                                 plain_s["iru_reorder_round_cap tagged"]),
        "add, flat": (dict(cap_kw, filter_op="add", n_partitions=1), None)}
    parts = []
    for label, (kw, plain) in variants.items():
        ms = event_ms(lambda: hash_ops.hash_reorder(pr_idx, pr_vals, **kw))
        parts.append(f"{label} {ms:.4f} ms" + (
            "" if plain is None else f" (plain {plain * 1e3:.1f} ms)"))
    print("time iru_reorder_round_cap variants at pagerank's shape: "
          + ", ".join(parts) + f"; torch.sort(stable=True) of the same {n} "
          f"int32 keys {sort_ms:.4f} ms")
    # B1 at a BFS level's shape: the gappy quarter-node expansion, D = 1
    ns = sparse.numel()
    sparse_bytes = ns * 4 * 2 + int(torch.unique(sparse).numel()) * 4
    kernel_ms = event_ms(lambda: gather_ops.csr_edge_gather(g.col_idx, sparse))
    library_ms = event_ms(lambda: torch.index_select(g.col_idx, 0, sparse))
    print(f"time coalesced_gather at a BFS level's shape (a quarter of the "
          f"nodes, {ns} lanes): kernel {kernel_ms:.4f} ms, library "
          f"{library_ms:.4f} ms (index_select), bound "
          f"{sparse_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms ({sparse_bytes} "
          f"bytes)")
    rows = {"coalesced_gather": b1, "segment_merge": b2,
            "segment_merge_tagged": b2t, "iru_reorder": b3,
            "iru_reorder_tagged": b3t, "iru_reorder_round_cap": b3c}
    for name, row in rows.items():
        row["bound_ms"] = row["bytes"] / HBM_BYTES_PER_S * 1e3
        lib = ("none" if row["library_ms"] is None
               else f"{row['library_ms']:.4f} ms")
        print(f"time {name}: kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, library {lib}, "
              f"bound {row['bound_ms']:.4f} ms ({row['bytes']} bytes, "
              f"{n} lanes)" + (f", group=window=256 "
                               f"{row['gpu_setting_ms']:.4f} ms"
                               if "gpu_setting_ms" in row else ""))
    return rows


def phase_profile(graphs, dsts, contrib):
    """Device time by kernel over short windows (torch.profiler over CUPTI),
    and the device's busy share of the window's wall time: PageRank on
    kron-20 in sort and hash mode, SSSP on delaunay-1024, and one B2 call
    (add and tagged) and one B3 call (add and tagged) at PageRank's shape,
    their kernels one by one.  Profiling adds host overhead, so the share is
    a lower bound."""
    from repro_torch.apps.pagerank import pagerank_app
    from repro_torch.apps.sssp import SSSP_APP
    from repro_torch.core import CapacityPolicy, FrontierPipeline
    from repro_torch.kernels.iru_reorder import ops as hash_ops
    from repro_torch.kernels.segment_merge import ops as merge_ops

    windows = []
    for label, mode, gname, app, iters in (
            ("pagerank kron20, 2 iterations", "sort", "kron20",
             pagerank_app(2), 2),
            ("pagerank kron20, 2 iterations", "hash", "kron20",
             pagerank_app(2), 2),
            ("sssp delaunay1024, first 200 rounds", "sort", "delaunay1024",
             SSSP_APP, 200)):
        pipe = FrontierPipeline(graphs[gname], app, mode=mode,
                                capacity_policy=CapacityPolicy(n_buckets=3),
                                max_iters=iters)
        windows.append((f"{mode} {label}", lambda pipe=pipe: pipe.run(0)))
    from repro_torch.graphs.csr import tile_csr
    from repro_torch.serve import GraphServeConfig, GraphServingEngine

    view = tile_csr(graphs["kron20"], GraphServeConfig().query_slots)
    for mode in ("sort", "hash"):
        def serve_ticks(mode=mode):
            eng = GraphServingEngine(view, GraphServeConfig(mode=mode))
            for q in serving_queries(graphs["kron20"]):
                eng.submit(q)
            for _ in range(3):
                eng.tick()
        windows.append((f"serving fused {mode}, first 3 ticks", serve_ticks))
    table = family_table(graphs["kron20"])
    tags = table[dsts.long()]
    windows.append(("B2 add at pagerank's shape, one call",
                    lambda: merge_ops.segment_merge(dsts, contrib, op="add")))
    windows.append(("B2 tagged at pagerank's shape, one call",
                    lambda: merge_ops.segment_merge(dsts, contrib,
                                                    op="tagged", tags=tags)))
    pr_idx, pr_vals = pagerank_stream(graphs["kron20"])
    windows.append(("B3 at pagerank's shape, one call",
                    lambda: hash_ops.hash_reorder(pr_idx, pr_vals,
                                                  filter_op="add")))
    windows.append(("B3 tagged at pagerank's shape, one call",
                    lambda: hash_ops.hash_reorder(pr_idx, pr_vals,
                                                  filter_op="tagged",
                                                  tag_table=table)))
    for label, fn in windows:
        profile_window(label, fn)


def profile_window(label, fn, top: int = 8):
    """Print the device time by kernel of one call of ``fn`` (after a
    warm-up call), its ``top`` rows, and the device's busy share of its
    wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()  # warm-up
    for _ in range(3):  # a session sometimes records no device event
        # the profiler's own warm-up step: without it the first kernels of
        # a session can go unrecorded
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            wall_s(fn)
            prof.step()  # the recorded step ends with the session
            _, wall = wall_s(fn)
        rows = []  # device-side events only (kernels, copies, memsets)
        for e in prof.key_averages():
            dev_us = getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0))
            # the step's own span is not device work
            if (e.device_type == DeviceType.CUDA and dev_us > 0
                    and not e.key.startswith("ProfilerStep")):
                rows.append((dev_us, e.count, e.key))
        if rows:
            break
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    share = busy_ms / (wall * 1e3)
    print(f"profile {label}: wall {wall * 1e3:.1f} ms, device busy "
          f"{busy_ms:.3f} ms ({share:.3f} of wall)")
    for dev_us, count, key in rows[:top]:
        print(f"  {dev_us / 1e3:9.4f} ms  x{count:<6d} {key[:100]}")


# The LM dry run (phase 13).  (a) sweeps the two archs the card runs whole;
# (b) holds the meta count against the card at phase 9's and 10's cuts.
DRYRUN_ARCHS = ("deepseek-v2-lite-16b", "mamba2-130m")
DRYRUN_STEPS = (  # kind, layers (None: whole), B, S (decode: the cache)
    ("decode", None, 8, 4128), ("prefill", None, 2, 4096),
    ("train", 4, 2, 4096))
DRYRUN_POS = 4096  # decode writes the cache's row 4096
# the shapes also swept at 2x16x16: the decode cache and the training state
# under the pod axis (the sweep's time goes to deepseek's prefill)
DRYRUN_MULTI = ("decode_32k", "train_4k")


def dryrun_sweep(card: str) -> None:
    """Phase 13 (a): every shape of ``DRYRUN_ARCHS`` at the 16x16
    production mesh, and ``DRYRUN_MULTI``'s at 2x16x16 too, counted on
    meta.  A 2x16x16 cell's FLOPs and bytes a device are half the 16x16
    cell's (the same global step over twice the devices); its state and
    cache shardings are its own."""
    from repro_torch.configs import LM_SHAPES
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    for arch in DRYRUN_ARCHS:
        for shape in LM_SHAPES:
            single = None
            for mesh in ("single", "multi"):
                if mesh == "multi" and (shape not in DRYRUN_MULTI
                                        or single is None):
                    continue
                rec = dryrun.run_cell(arch, shape, mesh, save=False)
                check(rec["status"] in ("ok", "skipped"),
                      f"dryrun {arch} {shape} {mesh}: {rec['status']} "
                      f"{rec.get('error')}")
                if rec["status"] == "skipped":
                    print(f"dryrun {arch} {shape} {mesh}: skipped "
                          f"({rec['reason']})  [{card}]")
                    continue
                cost, roof = rec["cost_analysis"], rec["roofline"]
                mem = rec["analytic_memory"]
                if mesh == "single":
                    single = cost
                else:
                    check(all(2 * cost[k] == single[k]
                              for k in ("flops", "bytes_accessed")),
                          f"dryrun {arch} {shape}: 2x16x16's FLOPs and "
                          f"bytes a device are half of 16x16's")
                print(f"dryrun {arch} {shape} {mesh}: ok, a device "
                      f"{cost['flops']:.4e} FLOPs, "
                      f"{cost['bytes_accessed']:.4e} bytes; t_compute "
                      f"{roof['t_compute_s']:.4e} s, t_memory "
                      f"{roof['t_memory_s']:.4e} s, bound "
                      f"{roof['bottleneck']}; useful-FLOPs ratio "
                      f"{rec['useful_flops_ratio']:.4f}; per device "
                      f"{mem['total_per_dev_gb']} GB, fits_80gb "
                      f"{mem['fits_80gb']}; arguments "
                      f"{rec['memory_analysis']['argument_size_in_bytes']} "
                      f"B; counted in {rec['count_s']} s  [{card}]")
    print(f"dryrun sweep: {time.perf_counter() - t0:.1f} s (meta, no card "
          f"work)  [{card}]")


def _dryrun_step(kind: str, layers, B: int, S: int):
    """(cfg, pcfg, shape) of one of ``DRYRUN_STEPS``: phase 9's whole
    model, phase 10's 4-layer training cut."""
    from repro_torch.configs import ParallelConfig, get_config
    from repro_torch.configs.base import ShapeConfig

    if kind == "train":
        return (_train_cfg("deepseek-v2-lite-16b", layers),
                ParallelConfig(remat="full"), ShapeConfig(kind, S, B, kind))
    return (get_config("deepseek-v2-lite-16b"), ParallelConfig(),
            ShapeConfig(kind, S, B, kind))


def _dryrun_args(kind: str, cfg, pcfg, shape, params, dev):
    """The step's arguments on the card, in ``dryrun.LOWERERS``' order."""
    from repro_torch.data import make_batch
    from repro_torch.models import transformer as T
    from repro_torch.train import TrainConfig, init_state

    gen = torch.Generator(device=dev).manual_seed(SEED)
    B, S = shape.global_batch, shape.seq_len
    if kind == "train":
        state = init_state(cfg, pcfg, TrainConfig(), gen, dev)
        return state, make_batch(cfg, shape, 0, device=dev)
    cache = T.init_cache(cfg, pcfg, B, S, device=dev)
    if kind == "prefill":
        toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                             device=dev, dtype=torch.int32)
        return params, {"tokens": toks}, cache
    tok = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen, device=dev,
                        dtype=torch.int32)
    pos = torch.full((), DRYRUN_POS, dtype=torch.int32, device=dev)
    return params, tok, cache, pos


def dryrun_on_the_card(card: str) -> None:
    """Phase 13 (b) and (c)."""
    import dataclasses

    from repro_torch.dist.sharding import use_mesh
    from repro_torch.launch import dryrun, hlo_stats
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.measure import measure_mode

    dev = torch.device("cuda", 0)
    mesh = make_host_mesh()
    params, params_bytes = None, 0
    for kind, layers, B, S in DRYRUN_STEPS:
        cfg, pcfg, shape = _dryrun_step(kind, layers, B, S)
        meta = dryrun._measure(cfg, pcfg, shape, mesh, mesh.size)
        lowered = dryrun.LOWERERS[kind](
            cfg, dataclasses.replace(pcfg, microbatches=1), shape, mesh)
        if kind != "train" and params is None:  # the decode and prefill
            torch.cuda.synchronize()             # steps share the weights
            held0 = torch.cuda.memory_allocated()
            params, _ = T.init_params(
                cfg, pcfg, torch.Generator(device=dev).manual_seed(SEED), dev)
            torch.cuda.synchronize()
            params_bytes = torch.cuda.memory_allocated() - held0
        if kind == "train":
            params, params_bytes = None, 0
            torch.cuda.empty_cache()
        torch.cuda.synchronize()
        held0 = torch.cuda.memory_allocated()
        args = _dryrun_args(kind, cfg, pcfg, shape, params, dev)
        torch.cuda.synchronize()
        grown = torch.cuda.memory_allocated() - held0 + params_bytes
        want = meta["memory_analysis"]["argument_size_in_bytes"]
        with use_mesh(mesh), measure_mode():
            card_counts = hlo_stats.count_step(lowered.fn, *args)
        ms = event_median_ms(lambda: lowered.fn(*args), reps=5)
        roof = hlo_stats.Roofline(meta["flops"], meta["bytes_accessed"], None,
                                  mesh.size)
        bound = max(roof.t_compute, roof.t_memory) * 1e3
        where = f"cache {S}" if kind == "decode" else f"S={S}"
        label = (f"deepseek-v2-lite-16b {cfg.n_layers} layers {kind} "
                 f"B={B} {where}")
        print(f"dryrun card {label}: meta {meta['flops_global']:.6e} FLOPs "
              f"{meta['bytes_global']:.6e} bytes, card "
              f"{card_counts['flops']:.6e} FLOPs "
              f"{card_counts['bytes_accessed']:.6e} bytes; arguments "
              f"{want} bytes (shard_shape at the host mesh) against "
              f"{grown} allocated ({grown / want - 1:+.4%}); measured "
              f"{ms:.4f} ms (CUDA-event median of 5) against t_compute "
              f"{roof.t_compute * 1e3:.4f} ms, t_memory "
              f"{roof.t_memory * 1e3:.4f} ms (bound {roof.bottleneck}): "
              f"share {bound / ms:.4f}; the arguments read once "
              f"{want / hlo_stats.HBM_BW * 1e3:.4f} ms; model_flops "
              f"{hlo_stats.model_flops(cfg, shape):.6e}  [{card}]")
        check(card_counts["flops"] == meta["flops_global"]
              and card_counts["bytes_accessed"] == meta["bytes_global"],
              f"dryrun {label}: the card's count equals the meta count")
        check(abs(grown / want - 1) <= 0.01,
              f"dryrun {label}: argument bytes within 1% of the growth")
        if kind == "decode":
            dryrun_constraints_change_nothing(lowered.fn, args, mesh, card)
        del args, lowered
        torch.cuda.empty_cache()


def dryrun_constraints_change_nothing(step, args, mesh, card: str) -> None:
    """Phase 13 (c): decode logits with and without the host mesh."""
    from repro_torch.dist.sharding import use_mesh

    det = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        plain = step(*args)[0].clone()
        again = step(*args)[0].clone()
        with use_mesh(mesh):
            meshed = step(*args)[0].clone()
    finally:
        torch.use_deterministic_algorithms(det)
    same = torch.equal(meshed, plain)
    print(f"dryrun card decode logits under use_mesh(make_host_mesh()) equal "
          f"the plain step's bit for bit: {same} (plain against plain: "
          f"{torch.equal(again, plain)}; {tuple(plain.shape)} f32)  [{card}]")
    check(same and bool(torch.isfinite(plain).all()),
          "dryrun: constraints change nothing")


SWEEP_LOG = ROOT / "build" / "dryrun_sweep.log"


def start_dryrun_sweep(card: str) -> subprocess.Popen:
    """Phase 13 (a) counts on the meta device and does no card work: it
    runs in a child process (no card visible to it) beside the phases
    before it, its lines in ``SWEEP_LOG``."""
    SWEEP_LOG.parent.mkdir(parents=True, exist_ok=True)
    with open(SWEEP_LOG, "w") as log:
        return subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--dryrun-sweep",
             card], cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
            env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def phase_dryrun(card: str, sweep: subprocess.Popen | None = None) -> None:
    """Phase 13 (``dryrun`` lines): (a) the sweep (its lines from the child
    process ``sweep`` when given, else run here), then (b) on the card."""
    t0 = time.perf_counter()
    if sweep is None:
        dryrun_sweep(card)
    else:
        rc = sweep.wait(timeout=600)
        print(SWEEP_LOG.read_text().rstrip())
        check(rc == 0, f"dryrun sweep exits 0, got {rc}")
        print(f"dryrun sweep: waited {time.perf_counter() - t0:.1f} s for "
              f"its child  [{card}]")
    dryrun_on_the_card(card)
    print(f"dryrun phase: {time.perf_counter() - t0:.1f} s  [{card}]")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs only on a card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True)
    card = smi.stdout.strip()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    t_start = time.perf_counter()
    pool, started = oracle_pool(), []  # stopped on every way out
    try:
        return run_phases(dev, card, pool, started, t_start)
    finally:
        pool.shutdown(cancel_futures=True)
        for proc in started:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def timed(name: str, fn, *args):
    """``fn(*args)``, then a line with the phase's wall seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    return out


def run_phases(dev, card: str, pool, started: list, t_start: float) -> int:
    graphs, work = timed("build and graphs", phase_build, dev, pool)
    dsts, contrib, sparse, plain_s, errors = timed(
        "kernels", phase_kernels, graphs["kron20"])
    oracles = work["oracles"]
    win_launches, win_errors, win_rows, win_plain = timed(
        "windowed", phase_windowed, graphs, oracles, work, pool)
    plain_s.update(win_plain)
    del work
    # phase 13 (a) runs beside phases 4-12, once the pool's work is done
    sweep = start_dryrun_sweep(card)
    started.append(sweep)
    launches = timed("apps", phase_apps, graphs, oracles)
    for k, v in timed("figures", phase_figures, graphs, oracles).items():
        launches[k] = launches.get(k, 0) + v
    served, serving_errors, fused = timed("serving", phase_serving,
                                          graphs["kron20"])
    for k, v in served.items():
        launches[k] = launches.get(k, 0) + v
    part_launches, stacked = timed("partitioned", phase_partitioned, graphs,
                                   oracles, fused)
    for k, v in part_launches.items():
        launches[k] = launches.get(k, 0) + v
    served = fused["fused hash"]
    del fused
    shutil.rmtree(GROUP_DIR, ignore_errors=True)
    GROUP_DIR.mkdir(parents=True)
    stacked_ep = timed("moe", phase_moe, GROUP_DIR / "moe")
    for k, v in timed("group", phase_group, graphs["kron20"], stacked,
                      stacked_ep, served, card).items():
        launches[k] = launches.get(k, 0) + v
    del stacked, stacked_ep, served
    timed("lm", phase_lm, card)
    timed("train", phase_train, card)
    for k, v in serving_errors.items():
        errors[k] = max(errors[k], v)
    timings = timed("timings", phase_timings, graphs["kron20"], dsts,
                    contrib, sparse, plain_s)
    timed("profile", phase_profile, graphs, dsts, contrib)
    timed("dryrun", phase_dryrun, card, sweep)
    for k, v in win_launches.items():
        launches[k] = launches.get(k, 0) + v
    errors.update(win_errors)
    timings.update(win_rows)

    sources = {
        "coalesced_gather": (
            "src/repro_torch/kernels/coalesced_gather/coalesced_gather.cu",
            "src/repro/kernels/coalesced_gather/coalesced_gather.py:43"),
        "segment_merge": (  # _kernel, add/min/max
            "src/repro_torch/kernels/segment_merge/segment_merge.cu",
            "src/repro/kernels/segment_merge/segment_merge.py:43"),
        "segment_merge_tagged": (  # _kernel_tagged, the fused families
            "src/repro_torch/kernels/segment_merge/segment_merge.cu",
            "src/repro/kernels/segment_merge/segment_merge.py:74"),
        "iru_reorder": (
            "src/repro_torch/kernels/iru_reorder/iru_reorder.cu",
            "src/repro/kernels/iru_reorder/iru_reorder.py:168"),
        "iru_reorder_tagged": (  # B3's tagged fold (the batched engine's)
            "src/repro_torch/kernels/iru_reorder/iru_reorder.cu",
            "src/repro/kernels/iru_reorder/iru_reorder.py:168"),
        "iru_reorder_banked": (  # B3, the banked layout (banked.py's)
            "src/repro_torch/kernels/iru_reorder/iru_reorder.cu",
            "src/repro/kernels/iru_reorder/iru_reorder.py:168"),
        "iru_reorder_windowed": (  # B3's windowed body (the paper's geometry)
            "src/repro_torch/kernels/iru_reorder/iru_reorder.cu",
            "src/repro/kernels/iru_reorder/iru_reorder.py:168"),
        "iru_reorder_round_cap": (  # B3's whole-stream round-cap fallback
            "src/repro_torch/kernels/iru_reorder/iru_reorder.cu",
            "src/repro/kernels/iru_reorder/iru_reorder.py:168"),
    }
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches.get(name, 0),
                "max_abs_err": errors[name], "ms": timings[name]["ms"],
                "plain_ms": timings[name]["plain_ms"],
                "bound_ms": timings[name]["bound_ms"], "bound_by": "bytes",
                "library_ms": timings[name]["library_ms"]}
               for name, (src, replaces) in sources.items()]
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def dryrun_child(card: str) -> int:
    """The child process of ``start_dryrun_sweep``."""
    sys.path.insert(0, str(ROOT / "src"))
    dryrun_sweep(card)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dryrun-sweep"]:
        sys.exit(dryrun_child(sys.argv[2]))
    sys.exit(main())
