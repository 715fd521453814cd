"""Wrapper of kernel B3 (the IRU reordering hash): CUDA tensors launch the
kernel, CPU tensors take the plain version (``batched.py``).

Counterpart of ``repro.kernels.iru_reorder.ops.hash_reorder``.  The kernel
carries the single-partition contract with ``n_live``: ``filter_op`` in
{None, add, min, max, tagged} (tagged with a bool ``tag_table``, the fused
min+add fold of the batched engine), an f32 or int32 ``[n]`` payload,
``slots <= 32``.  On a CUDA tensor with ``kernels=True`` every other option
raises, naming the slice that brings it; nothing quietly runs the plain
version instead.  Launches count under ``iru_reorder`` or, tagged,
``iru_reorder_tagged``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, launch_counts
from repro_torch.kernels.iru_reorder.batched import hash_reorder_batched

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_OPS = {None: 0, "add": 1, "min": 2, "max": 3, "tagged": 4}
_DTYPES = {torch.float32: 0, torch.int32: 1}
_WARP = 32


def _lib() -> ctypes.CDLL:
    lib = _build.load("iru_reorder")
    fn = lib.iru_hash_reorder
    fn.argtypes = [_P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _LL, _I, _I, _I,
                   _I, _I, _P]
    fn.restype = _I
    lib.iru_hash_reorder_workspace.argtypes = [_LL, _I]
    lib.iru_hash_reorder_workspace.restype = _LL
    lib.iru_hash_reorder_max_sets.restype = _I
    return lib


def _refuse(secondary, *, num_sets, slots, epb, round_cap, n_live, tag_table,
            device) -> None:
    """What kernel B3 does not carry yet raises on CUDA."""
    if secondary.dim() != 1:
        raise NotImplementedError(
            "kernel B3 carries [n] payloads only; [n, k] payloads come with "
            "a later slice of the port; pass kernels=False for the plain "
            "version")
    if round_cap is not None:
        raise NotImplementedError(
            "kernel B3 has no round_cap fallback yet (a later slice of the "
            "port); pass kernels=False for the plain version")
    if slots > _WARP:
        raise NotImplementedError(
            f"kernel B3 keeps one slot per warp lane: slots={slots} > 32")
    if epb < 1:
        raise ValueError(f"block_bytes // elem_bytes must be >= 1, got {epb}")
    if secondary.dtype not in _DTYPES:
        raise ValueError(f"kernel B3 takes float32 or int32 payloads, got "
                         f"{secondary.dtype}")
    max_sets = _lib().iru_hash_reorder_max_sets()
    if not 1 <= num_sets <= max_sets:
        raise ValueError(f"kernel B3 takes 1 <= num_sets <= {max_sets}, "
                         f"got {num_sets}")
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
    n_live: torch.Tensor | int | None = None,
    tag_table: Optional[torch.Tensor] = None,
    kernels: bool = True,
):
    """Paper-faithful O(n) bounded reorder.  Returns an ``IRUStream``.

    ``n_live`` (a 0-d tensor or int, never a shape) selects ragged
    execution; the kernel reads it from device memory, so no host sync.
    ``kernels=False`` runs the plain version on any device (the plain path
    a card run is held against).
    """
    from repro_torch.core.iru import IRUStream  # late: core imports us

    if n_partitions > 1:
        raise NotImplementedError(
            "n_partitions > 1 (the banked hash engine) comes with a later "
            "slice of the port")
    if filter_op not in _OPS:
        raise ValueError(f"unknown filter op {filter_op!r}")
    if (filter_op == "tagged") != (tag_table is not None):
        raise ValueError("filter_op='tagged' and tag_table go together")
    indices = indices.to(torch.int32)
    n = indices.shape[0]
    if secondary is None:
        secondary = torch.zeros(n, dtype=torch.float32, device=indices.device)
    if not (kernels and indices.is_cuda):
        return IRUStream(*hash_reorder_batched(
            indices, secondary, num_sets=num_sets, slots=slots,
            elem_bytes=elem_bytes, block_bytes=block_bytes,
            filter_op=filter_op, round_cap=round_cap, n_live=n_live,
            tag_table=tag_table))
    epb = block_bytes // elem_bytes
    _refuse(secondary, num_sets=num_sets, slots=slots, epb=epb,
            round_cap=round_cap, n_live=n_live, tag_table=tag_table,
            device=indices.device)
    return IRUStream(*_launch(indices, secondary, num_sets, slots, epb,
                              filter_op, n_live, tag_table))


def _launch(indices, secondary, num_sets, slots, epb, filter_op, n_live,
            tag_table):
    dev = indices.device
    n = indices.shape[0]
    idx = indices.contiguous()
    sec = secondary.contiguous()
    out_idx = torch.empty(n, dtype=torch.int32, device=dev)
    out_sec = torch.empty_like(sec)
    out_pos = torch.empty(n, dtype=torch.int32, device=dev)
    out_act = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return out_idx, out_sec, out_pos, out_act
    live = None
    if n_live is not None:
        live = torch.as_tensor(n_live, device=dev).to(torch.int32).reshape(())
    tags = None if tag_table is None else tag_table.contiguous()
    lib = _lib()
    work = torch.empty(lib.iru_hash_reorder_workspace(n, num_sets),
                       dtype=torch.uint8, device=dev)
    code = lib.iru_hash_reorder(
        idx.data_ptr(), sec.data_ptr(), None if live is None else
        live.data_ptr(), None if tags is None else tags.data_ptr(),
        0 if tags is None else tags.numel(), out_idx.data_ptr(),
        out_sec.data_ptr(), out_pos.data_ptr(), out_act.data_ptr(),
        work.data_ptr(), n, num_sets,
        slots, epb, _DTYPES[sec.dtype], _OPS[filter_op],
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, code, "iru_reorder")
    launch_counts["iru_reorder_tagged" if filter_op == "tagged"
                  else "iru_reorder"] += 1
    return out_idx, out_sec, out_pos, out_act
