"""Wrappers of kernel B1 (block-reuse gather): CUDA tensors launch the
kernel, CPU tensors take the plain version.

Counterpart of ``repro.kernels.coalesced_gather.ops``.  The reference checks
the window contract for the whole stream and falls back to a plain take;
the kernel checks it per group on the device and serves a violating group
from global memory, so the result is ``table[indices]`` in every case.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, launch_counts
from repro_torch.kernels.coalesced_gather.ref import coalesced_gather_ref

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _lib() -> ctypes.CDLL:
    lib = _build.load("coalesced_gather")
    fn = lib.iru_coalesced_gather
    fn.argtypes = [_P, _P, _I, _LL, _P, _LL, _P, _P, _I, _I, _I, _P]
    fn.restype = _I
    return lib


def _check_inputs(cols, indices, group, window):
    if group < 1 or window < 1:
        raise ValueError(f"group={group} and window={window} must be >= 1")
    if indices.dim() != 1 or indices.dtype != torch.int32:
        raise ValueError(f"indices must be int32 [n], got {indices.dtype} "
                         f"{tuple(indices.shape)}")
    dev = indices.device
    for c in cols:
        if c.device != dev:
            raise ValueError(f"table on {c.device}, indices on {dev}")
        if c.dtype not in (torch.float32, torch.int32):
            raise ValueError(f"table columns must be 32-bit, got {c.dtype}")
        if not c.is_contiguous():
            raise ValueError("table must be contiguous")
    if indices.numel() and cols[0].shape[0] == 0:
        raise ValueError("gather from an empty table")


def _launch(cols, in_stride, outs, out_stride, indices, group, window):
    """One kernel launch; ``cols``/``outs`` are (tensor, byte offset) pairs."""
    lib = _lib()
    indices = indices.contiguous()
    n = indices.numel()
    if n == 0:
        return
    v = cols[0][0].shape[0]
    ptr = lambda pair: None if pair is None else pair[0].data_ptr() + pair[1]
    code = lib.iru_coalesced_gather(
        ptr(cols[0]), ptr(cols[1]), in_stride, v, indices.data_ptr(), n,
        ptr(outs[0]), ptr(outs[1]), out_stride, group, window,
        torch.cuda.current_stream(indices.device).cuda_stream)
    _build.check(lib, code, "coalesced_gather")
    launch_counts["coalesced_gather"] += 1


def coalesced_gather(table: torch.Tensor, indices: torch.Tensor, *,
                     group: int = 8, window: int = 128) -> torch.Tensor:
    """``table[indices]`` for a 32-bit ``[V, D]`` table, ``D`` in {1, 2}."""
    if not indices.is_cuda:
        return coalesced_gather_ref(table, indices)
    if table.dim() != 2 or table.shape[1] not in (1, 2):
        raise ValueError(f"table must be [V, 1] or [V, 2], got "
                         f"{tuple(table.shape)}")
    _check_inputs([table], indices, group, window)
    d = table.shape[1]
    out = torch.empty((indices.shape[0], d), dtype=table.dtype,
                      device=table.device)
    second = lambda t: (t, 4) if d == 2 else None
    _launch([(table, 0), second(table)], d, [(out, 0), second(out)], d,
            indices, group, window)
    return out


def csr_edge_gather(col_idx: torch.Tensor, offsets: torch.Tensor,
                    weights: torch.Tensor | None = None, *, group: int = 8,
                    window: int = 128):
    """``col_idx[offsets]`` (and ``weights[offsets]``) in one kernel pass.

    The expansion path of ``graphs.csr.expand_frontier(gather="kernel")``:
    an ascending frontier makes the offsets monotone, the kernel's window
    contract.  Both edge arrays are served from the same staged windows.
    """
    if not offsets.is_cuda:
        dsts = coalesced_gather_ref(col_idx, offsets)
        return dsts if weights is None else (
            dsts, coalesced_gather_ref(weights, offsets))
    cols = [col_idx] if weights is None else [col_idx, weights]
    _check_inputs(cols, offsets, group, window)
    if weights is not None and weights.shape != col_idx.shape:
        raise ValueError("col_idx and weights must have one shape")
    n = offsets.shape[0]
    dsts = torch.empty(n, dtype=col_idx.dtype, device=col_idx.device)
    w = None if weights is None else torch.empty(n, dtype=weights.dtype,
                                                 device=weights.device)
    _launch([(col_idx, 0), None if w is None else (weights, 0)], 1,
            [(dsts, 0), None if w is None else (w, 0)], 1, offsets, group,
            window)
    return dsts if w is None else (dsts, w)
