"""Wrapper of kernel B2 (segment merge): CUDA tensors launch the kernel, CPU
tensors take the plain version.

Counterpart of ``repro.kernels.segment_merge.ops``; the contract is
``core.filter.merge_sorted`` for ``op`` in {add, min, max, tagged} with the
sort engine's ``active`` prefix (``tagged``: per-lane ``tags``, True = the
add family).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, launch_counts
from repro_torch.kernels.segment_merge.ref import segment_merge_ref

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_OPS = {"add": 0, "min": 1, "max": 2, "tagged": 3}
_DTYPES = {torch.float32: 0, torch.int32: 1}


def _lib() -> ctypes.CDLL:
    lib = _build.load("segment_merge")
    fn = lib.iru_segment_merge
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _P]
    fn.restype = _I
    lib.iru_segment_merge_tile.restype = _I
    return lib


def segment_merge(sorted_indices: torch.Tensor, values: torch.Tensor, *,
                  op: str = "add", active: torch.Tensor | None = None,
                  tags: torch.Tensor | None = None):
    """Merge duplicate adjacent indices -> ``(merged, survivor_mask)``.

    Launches count under ``segment_merge`` (add/min/max, the reference's
    ``_kernel``) or ``segment_merge_tagged`` (its ``_kernel_tagged``).  On
    CUDA it is one launch (and one memset of the per-tile status words), and
    repeated calls give bit-identical results, f32 sums included.
    """
    if op not in _OPS:
        raise ValueError(f"unknown filter op {op!r}")
    if (op == "tagged") != (tags is not None):
        raise ValueError("op='tagged' requires per-lane tags, and only it")
    if not values.is_cuda:
        return segment_merge_ref(sorted_indices, values, op, active, tags)
    n = values.shape[0]
    if values.dim() != 1 or values.dtype not in _DTYPES:
        raise ValueError(f"the kernel takes float32 or int32 [n] payloads, "
                         f"got {values.dtype} {tuple(values.shape)}")
    if sorted_indices.shape != (n,) or sorted_indices.dtype != torch.int32:
        raise ValueError("sorted_indices must be int32 [n]")
    for name, mask in (("active", active), ("tags", tags)):
        if mask is not None and (mask.shape != (n,)
                                 or mask.dtype != torch.bool):
            raise ValueError(f"{name} must be bool [n]")
    for x in (sorted_indices, active, tags):
        if x is not None and x.device != values.device:
            raise ValueError("all operands must be on one device")
    idx = sorted_indices.contiguous()
    vals = values.contiguous()
    act = None if active is None else active.contiguous()
    tag = None if tags is None else tags.contiguous()
    out = torch.empty_like(vals)
    surv = torch.empty(n, dtype=torch.bool, device=vals.device)
    if n == 0:
        return out, surv
    lib = _lib()
    tiles = -(-n // lib.iru_segment_merge_tile())
    # one status word a tile and the tile ticket, zeroed on the stream
    # before the launch
    status = torch.empty(tiles + 1, dtype=torch.int64, device=vals.device)
    code = lib.iru_segment_merge(
        idx.data_ptr(), None if act is None else act.data_ptr(),
        None if tag is None else tag.data_ptr(), vals.data_ptr(),
        out.data_ptr(), surv.data_ptr(), status.data_ptr(), n,
        _DTYPES[vals.dtype], _OPS[op],
        torch.cuda.current_stream(vals.device).cuda_stream)
    _build.check(lib, code, "segment_merge")
    launch_counts["segment_merge_tagged" if op == "tagged"
                  else "segment_merge"] += 1
    return out, surv
