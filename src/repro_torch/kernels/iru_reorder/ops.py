"""Wrapper of kernel B3 (the IRU reordering hash): CUDA tensors launch the
kernel, CPU tensors take the plain versions (``batched.py``, ``banked.py``
and the window loop ``core.iru._windowed_reorder``).

Counterpart of ``repro.kernels.iru_reorder.ops.hash_reorder``.  The kernel
has two bodies:

* the whole-stream body: ``filter_op`` in {None, add, min, max, tagged}
  (tagged with a bool ``tag_table``, the fused min+add fold of the batched
  engine), an f32 or int32 ``[n]`` payload, ``slots <= 32``, ``n_live``,
  ``n_partitions >= 1`` (the banked layout, its capacity bypass decided on
  the device) and ``round_cap`` (each capped partition takes the dense
  fallback, decided on the device after the bypass: the body's own sort,
  no host read).  Launches count under ``iru_reorder_round_cap`` with a
  round cap and a merge, else ``iru_reorder_tagged`` when tagged, else
  ``iru_reorder_banked`` with ``n_partitions > 1``, else ``iru_reorder``;
* the windowed body (``window_elems=w``): every window of ``w`` lanes in one
  launch, one CTA a window, with ``n_partitions``, ``round_cap`` and
  ``n_live``, for ``filter_op`` in {None, add, min, max, tagged}, f32 or
  int32 ``[n]`` payloads and ``slots <= 32``; ``w`` is bounded by the body's
  shared memory, half an SM's so that two windows reside on an SM
  (``_window_limit``).  Launches count under ``iru_reorder_windowed``.
  ``windowed_phase_stamps`` runs its stamped build (each window's clock
  at its phase boundaries) and ``windowed_occupancy`` reads its CTAs
  resident per SM: measurements, not the main path.

Over a group mesh (``mesh=``, ``launch.mesh.make_iru_mesh(P, group=...)``)
each rank reorders its own block of the banked layout's partitions: on CUDA
tensors, one launch of the whole-stream body a partition on that
partition's sub-stream (its lanes in stream order: the definition of
``ref.hash_reorder_ref_banked``, and B3 folds in stream order, so the
result equals the single-card banked layout bit for bit), on CPU tensors
the plain rows (``banked.py``); one ``all_gather`` then feeds the
partition-major combine on every rank.

On a CUDA tensor with ``kernels=True`` every other option raises, naming
the slice that brings it; nothing quietly runs the plain version instead.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, launch_counts
from repro_torch.kernels.iru_reorder.banked import (
    bank_rows, banks, emit_partition_major, gather_rows, hash_reorder_banked)
from repro_torch.kernels.iru_reorder.batched import hash_reorder_batched
from repro_torch.kernels.iru_reorder.ref import partition_capacity

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_OPS = {None: 0, "add": 1, "min": 2, "max": 3, "tagged": 4}
_DTYPES = {torch.float32: 0, torch.int32: 1}
_WARP = 32


def _lib() -> ctypes.CDLL:
    lib = _build.load("iru_reorder")
    fn = lib.iru_hash_reorder
    fn.argtypes = [_P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _LL, _I, _I, _I,
                   _I, _I, _I, _I, _P]
    fn.restype = _I
    lib.iru_hash_reorder_workspace.argtypes = [_LL, _I, _I, _I]
    lib.iru_hash_reorder_workspace.restype = _LL
    lib.iru_hash_reorder_max_sets.restype = _I
    win = lib.iru_win_reorder
    win.argtypes = [_P, _P, _P, _P, _I, _P, _P, _P, _P, _LL, _I, _I, _I, _I,
                    _I, _I, _I, _I, _P]
    win.restype = _I
    lib.iru_win_reorder_smem.argtypes = [_I, _I, _I]
    lib.iru_win_reorder_smem.restype = _LL
    lib.iru_win_reorder_smem_limit.restype = _LL
    lib.iru_win_reorder_max_window.argtypes = [_I, _I]
    lib.iru_win_reorder_max_window.restype = _I
    stamped = lib.iru_win_reorder_stamped
    stamped.argtypes = list(win.argtypes[:-1]) + [_P, _P]
    stamped.restype = _I
    lib.iru_win_reorder_phases.restype = _I
    lib.iru_win_reorder_occupancy.argtypes = [_I, _I, _I, _I, _I, _P]
    lib.iru_win_reorder_occupancy.restype = _I
    return lib


def _window_limit(num_sets: int, n_partitions: int) -> tuple[int, int, int]:
    """``(largest window, bytes of shared memory a window of it takes, bytes
    a window's CTA may take)`` of B3's windowed body at this geometry."""
    lib = _lib()
    w = lib.iru_win_reorder_max_window(num_sets, n_partitions)
    return (w, lib.iru_win_reorder_smem(w, num_sets, n_partitions),
            lib.iru_win_reorder_smem_limit())


def _refuse(secondary, *, num_sets, slots, epb, n_partitions, window_elems,
            n_live, tag_table, device) -> None:
    """What kernel B3 does not carry yet raises on CUDA."""
    body = "B3's windowed body" if window_elems is not None else "kernel B3"
    if secondary.dim() != 1:
        raise NotImplementedError(
            f"{body} carries [n] payloads only; [n, k] payloads come with a "
            f"later slice of the port (ROADMAP §B); pass kernels=False for "
            f"the plain version")
    if slots > _WARP:
        raise NotImplementedError(
            f"kernel B3 keeps one slot per warp lane: slots={slots} > 32; "
            f"more slots come with a later slice of the port (ROADMAP §B); "
            f"pass kernels=False for the plain version")
    if epb < 1:
        raise ValueError(f"block_bytes // elem_bytes must be >= 1, got {epb}")
    if secondary.dtype not in _DTYPES:
        raise ValueError(f"kernel B3 takes float32 or int32 payloads, got "
                         f"{secondary.dtype}")
    if n_partitions < 1 or num_sets % n_partitions != 0:
        raise ValueError(f"num_sets={num_sets} must divide evenly into "
                         f"n_partitions={n_partitions}")
    if window_elems is not None:
        w_max, smem, limit = _window_limit(num_sets, n_partitions)
        if not 1 <= window_elems <= w_max:
            raise NotImplementedError(
                f"window_elems={window_elems} is past B3's windowed body: at "
                f"{num_sets} sets and {n_partitions} partitions a window "
                f"holds at most {w_max} lanes ({smem} bytes of shared "
                f"memory of the {limit} a block may use); larger windows "
                f"come with a later slice of the port (ROADMAP §B); pass "
                f"kernels=False for the plain version")
    else:
        max_sets = _lib().iru_hash_reorder_max_sets()
        if not 1 <= num_sets <= max_sets:
            raise ValueError(
                f"kernel B3 takes 1 <= num_sets <= {max_sets}, got "
                f"{num_sets}; more sets come with a later slice of the port "
                f"(ROADMAP §B); pass kernels=False for the plain version")
    if tag_table is not None and (tag_table.dim() != 1
                                  or tag_table.dtype != torch.bool
                                  or not 1 <= tag_table.numel() < 2**31):
        raise ValueError(f"tag_table must be a non-empty bool [T], got "
                         f"{tag_table.dtype} {tuple(tag_table.shape)}")
    if any(isinstance(x, torch.Tensor) and x.device != device
           for x in (secondary, n_live, tag_table)):
        raise ValueError("all operands must be on one device")


def hash_reorder(
    indices: torch.Tensor,
    secondary: torch.Tensor | None = None,
    *,
    num_sets: int = 1024,
    slots: int = 32,
    elem_bytes: int = 4,
    block_bytes: int = 128,
    filter_op: Optional[str] = None,
    round_cap: Optional[int] = None,
    n_partitions: int = 1,
    window_elems: Optional[int] = None,
    n_live: torch.Tensor | int | None = None,
    tag_table: Optional[torch.Tensor] = None,
    kernels: bool = True,
    mesh=None,
):
    """Paper-faithful O(n) bounded reorder.  Returns an ``IRUStream``.

    ``n_partitions > 1`` is the banked geometry (partition-major emission),
    ``window_elems`` reorders independent windows of that many lanes (the
    last one ragged).  ``n_live`` (a 0-d tensor or int, never a shape)
    selects ragged execution; the kernel reads it from device memory, so no
    host sync.  ``kernels=False`` runs the plain version on any device (the
    plain path a card run is held against).  ``mesh`` (a group mesh over
    ranks that divide ``n_partitions``) shards the banked layout's rows,
    one block of partitions a rank; every rank of the group calls with the
    same stream and gets the whole result.  It takes no window.
    """
    from repro_torch.core.iru import IRUStream  # late: core imports us

    if filter_op not in _OPS:
        raise ValueError(f"unknown filter op {filter_op!r}")
    if (filter_op == "tagged") != (tag_table is not None):
        raise ValueError("filter_op='tagged' and tag_table go together")
    if mesh is not None and window_elems is not None:
        raise ValueError(
            "a mesh shards the banked layout's rows of the whole stream; "
            "windows take no mesh (the reference's hash_reorder has no "
            "window): drop window_elems or mesh")
    indices = indices.to(torch.int32)
    n = indices.shape[0]
    if secondary is None:
        secondary = torch.zeros(n, dtype=torch.float32, device=indices.device)
    if not (kernels and indices.is_cuda):
        kw = dict(num_sets=num_sets, slots=slots, filter_op=filter_op,
                  round_cap=round_cap)
        if window_elems is not None:
            from repro_torch.core.iru import IRUConfig, _windowed_reorder

            cfg = IRUConfig(mode="hash", target_elem_bytes=elem_bytes,
                            block_bytes=block_bytes, n_partitions=n_partitions,
                            n_banks=1, window_elems=window_elems, **kw)
            return _windowed_reorder(indices, secondary, cfg, n_live,
                                     tag_table, kernels=False)
        kw.update(elem_bytes=elem_bytes, block_bytes=block_bytes,
                  n_live=n_live, tag_table=tag_table)
        if n_partitions > 1 or mesh is not None:
            return IRUStream(*hash_reorder_banked(
                indices, secondary, n_partitions=n_partitions, mesh=mesh,
                **kw))
        return IRUStream(*hash_reorder_batched(indices, secondary, **kw))
    epb = block_bytes // elem_bytes
    _refuse(secondary, num_sets=num_sets, slots=slots, epb=epb,
            n_partitions=n_partitions, window_elems=window_elems,
            n_live=n_live, tag_table=tag_table, device=indices.device)
    if window_elems is not None:
        return IRUStream(*_launch_windowed(
            indices, secondary, window_elems, num_sets, slots, epb,
            n_partitions, round_cap, filter_op, n_live, tag_table))
    if mesh is not None:
        return IRUStream(*_launch_rows(
            indices, secondary, num_sets, slots, epb, n_partitions,
            round_cap, filter_op, n_live, tag_table, mesh))
    return IRUStream(*_launch(indices, secondary, num_sets, slots, epb,
                              n_partitions, round_cap, filter_op, n_live,
                              tag_table))


def _outputs(indices, sec):
    n = indices.shape[0]
    dev = indices.device
    return (torch.empty(n, dtype=torch.int32, device=dev),
            torch.empty_like(sec),
            torch.empty(n, dtype=torch.int32, device=dev),
            torch.empty(n, dtype=torch.bool, device=dev))


def _live(n_live, dev):
    if n_live is None:
        return None
    return torch.as_tensor(n_live, device=dev).to(torch.int32).reshape(())


def _cap(round_cap, filter_op) -> int:
    """The C interface's round cap: 0 for none (a cap without a merge is
    none, as in ``ref.hash_reorder_ref_flat``)."""
    if round_cap is None or filter_op is None:
        return 0
    return min(round_cap, 2**31 - 1)


def _tags(tag_table):
    """(the tag table, contiguous, or None; its length)."""
    if tag_table is None:
        return None, 0
    tags = tag_table.contiguous()
    return tags, tags.numel()


def _launch_windowed(indices, secondary, w, num_sets, slots, epb,
                     n_partitions, round_cap, filter_op, n_live, tag_table,
                     stamps=None):
    """One launch of the windowed body; with ``stamps`` (int64 ``[windows,
    len(WINDOW_PHASES) + 1]`` on the device) its stamped build."""
    dev = indices.device
    n = indices.shape[0]
    idx = indices.contiguous()
    sec = secondary.contiguous()
    out = _outputs(idx, sec)
    if n == 0:
        return out
    live = _live(n_live, dev)
    tags, ntags = _tags(tag_table)
    lib = _lib()
    args = [idx.data_ptr(), sec.data_ptr(),
            None if live is None else live.data_ptr(),
            None if tags is None else tags.data_ptr(), ntags,
            *(o.data_ptr() for o in out), n, w, num_sets, slots, epb,
            n_partitions, _cap(round_cap, filter_op), _DTYPES[sec.dtype],
            _OPS[filter_op]]
    stream = torch.cuda.current_stream(dev).cuda_stream
    if stamps is None:
        code = lib.iru_win_reorder(*args, stream)
        key = "iru_reorder_windowed"
    else:
        code = lib.iru_win_reorder_stamped(*args, stamps.data_ptr(), stream)
        key = "iru_reorder_windowed_stamped"
    _build.check(lib, code, key)
    launch_counts[key] += 1
    return out


# the stamped build's phases, in order (iru_reorder.cu: kWinPhases)
WINDOW_PHASES = ("load+histogram", "binning", "small-set walk",
                 "hot-set walk", "fallback", "scans", "emission")


def windowed_phase_stamps(indices, secondary, *, window_elems, num_sets=1024,
                          slots=32, elem_bytes=4, block_bytes=128,
                          filter_op=None, round_cap=None, n_partitions=1,
                          n_live=None, tag_table=None):
    """One launch of B3's windowed body in its stamped build (CUDA
    tensors only): the same result as ``hash_reorder(window_elems=...)``
    and, per window, each CTA's ``clock64()`` at the start and after each
    of ``WINDOW_PHASES`` (an int64 ``[windows, len(WINDOW_PHASES) + 1]``
    tensor on the device).  A measurement of where a window's time goes;
    launches count under ``iru_reorder_windowed_stamped``."""
    if not indices.is_cuda:
        raise ValueError("the stamped build runs on a CUDA tensor only")
    epb = block_bytes // elem_bytes
    if (filter_op == "tagged") != (tag_table is not None):
        raise ValueError("filter_op='tagged' and tag_table go together")
    _refuse(secondary, num_sets=num_sets, slots=slots, epb=epb,
            n_partitions=n_partitions, window_elems=window_elems,
            n_live=n_live, tag_table=tag_table, device=indices.device)
    if _lib().iru_win_reorder_phases() != len(WINDOW_PHASES):
        raise RuntimeError("the stamped build's phases differ from "
                           "WINDOW_PHASES: the library is stale")
    stamps = torch.zeros(-(-indices.shape[0] // window_elems),
                         len(WINDOW_PHASES) + 1, dtype=torch.int64,
                         device=indices.device)
    out = _launch_windowed(indices.to(torch.int32), secondary, window_elems,
                           num_sets, slots, epb, n_partitions, round_cap,
                           filter_op, n_live, tag_table, stamps)
    return out, stamps


def windowed_occupancy(window_elems, num_sets, n_partitions,
                       filter_op="add") -> int:
    """CTAs (windows) of B3's windowed body resident on one SM at this
    geometry (f32, ``filter_op``), as
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` gives them; needs a
    card."""
    lib = _lib()
    blocks = ctypes.c_int(0)
    code = lib.iru_win_reorder_occupancy(window_elems, num_sets, n_partitions,
                                         _DTYPES[torch.float32],
                                         _OPS[filter_op],
                                         ctypes.addressof(blocks))
    _build.check(lib, code, "iru_reorder windowed occupancy")
    return blocks.value


def _launch(indices, secondary, num_sets, slots, epb, n_partitions,
            round_cap, filter_op, n_live, tag_table):
    dev = indices.device
    n = indices.shape[0]
    idx = indices.contiguous()
    sec = secondary.contiguous()
    out = _outputs(idx, sec)
    if n == 0:
        return out
    live = _live(n_live, dev)
    tags, ntags = _tags(tag_table)
    cap = _cap(round_cap, filter_op)
    lib = _lib()
    work = torch.empty(lib.iru_hash_reorder_workspace(n, num_sets,
                                                      n_partitions, cap),
                       dtype=torch.uint8, device=dev)
    code = lib.iru_hash_reorder(
        idx.data_ptr(), sec.data_ptr(), None if live is None else
        live.data_ptr(), None if tags is None else tags.data_ptr(), ntags,
        *(o.data_ptr() for o in out), work.data_ptr(), n, num_sets, slots,
        epb, n_partitions, cap, _DTYPES[sec.dtype], _OPS[filter_op],
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, code, "iru_reorder")
    launch_counts["iru_reorder_round_cap" if cap else
                  "iru_reorder_tagged" if filter_op == "tagged" else
                  "iru_reorder_banked" if n_partitions > 1 else
                  "iru_reorder"] += 1
    return out


def _launch_rows(indices, secondary, num_sets, slots, epb, n_partitions,
                 round_cap, filter_op, n_live, tag_table, mesh):
    """The banked layout over a group mesh: the stream's partition counts
    (one host read) decide the bypass, as on one card; past the capacity
    every rank reorders the whole stream flat (under the round cap).  Else
    each of this rank's partitions goes through the whole-stream body on
    its sub-stream, its own round cap decided there (as the reference's
    banked engine caps each partition), its local positions map back to
    stream positions, and its output lands in a bank row (survivors at the
    front, the filtered tail at the back); the rows of every rank are
    gathered and emitted partition-major."""
    shards, held = bank_rows(mesh, n_partitions)
    n, dev = indices.shape[0], indices.device
    if n == 0:
        return _outputs(indices, secondary)
    _, part, _, m_live, cnt, cap_eff = banks(
        indices, num_sets=num_sets, n_partitions=n_partitions, epb=epb,
        n_live=n_live)
    counts = cnt.tolist()
    if max(counts) > cap_eff:
        return _launch(indices, secondary, num_sets, slots, epb, 1,
                       round_cap, filter_op, n_live, tag_table)
    C = partition_capacity(n, n_partitions)
    order = torch.argsort(part, stable=True)  # dead lanes (partition P) last
    rows = []
    for p in held:
        c, lo = counts[p], sum(counts[:p])
        sel = order[lo:lo + c]
        oi, osec, opos, oact = _launch(indices[sel], secondary[sel], num_sets,
                                       slots, epb, 1, round_cap, filter_op,
                                       None, tag_table)
        m = oact.sum(dtype=torch.int32)
        col = torch.arange(c, device=dev)
        col = torch.where(col < m, col, col + (C - c))

        def row(x):
            buf = x.new_zeros(C)
            buf[col] = x
            return buf

        rows.append((row(oi), row(osec), row(sel[opos.long()].to(torch.int32)),
                     row(oact), m, c - m))
    out_rows = [torch.stack([r[k] for r in rows]) for k in range(6)]
    return emit_partition_major(indices, secondary,
                                gather_rows(shards, *out_rows), m_live)
