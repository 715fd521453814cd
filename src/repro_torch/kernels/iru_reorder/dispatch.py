"""Hash-engine dispatch planner: the occupancy plan without the emission.

Counterpart of ``repro.kernels.iru_reorder.dispatch``.  Expert dispatch
(MoE token routing) wants the hash engine's occupancy bookkeeping, not the
reordered stream:

* the within-set insertion rank of every lane (for MoE, the token's row
  inside its expert's capacity buffer);
* the occupancy generation ``rank // slots`` (generation 0 is the resident
  set before the first flush, so with ``slots`` = expert capacity,
  "survives generation 0" is the capacity rule);
* per-set arrival counts (the expert load histogram).

It is computed with the plain hash engine's own machinery
(``batched.py``): a set-major stable sort, then :func:`_segment_fields` for
the ranks.  Ragged streams use the engine's sentinel-set trick: dead lanes
take set ``num_sets``, so they sort to an inert tail segment and drop out
of every live rank and count.  Nothing here reads the device from the host,
so a ragged ``n_live`` on the card costs no sync.

The set key is the identity: an expert id is a set id, so the block hash
would only scramble a perfect key.  Callers supply ``sets`` in
``[0, num_sets)``.  This is plain torch on every device; no kernel carries
it (B3 keeps one slot per warp lane, and capacities exceed 32).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.iru_reorder.batched import (_permute_set,
                                                     _segment_fields)


def hash_dispatch(
    sets: torch.Tensor,
    *,
    num_sets: int,
    slots: int,
    n_live: Optional[torch.Tensor | int] = None,
):
    """Occupancy plan for a direct-mapped (identity-keyed) stream.

    ``sets``: int[n] dense set ids in ``[0, num_sets)`` (e.g. expert ids).
    ``slots``: the per-set residency bound (e.g. expert capacity).
    ``n_live`` (a 0-d tensor or int, never a shape): only the first
    ``n_live`` lanes are real; dead lanes report ``live=False`` and drop out
    of every rank and count.

    Returns ``(rank, generation, live, counts)``: int32[n] within-set
    insertion rank in stream order, int32[n] ``rank // slots``, bool[n]
    live, int32[num_sets] live arrivals per set.  Dead lanes carry the
    sentinel segment's rank and generation; consumers gate on ``live``.
    """
    sets = sets.to(torch.int32)
    n = sets.shape[0]
    dev = sets.device
    if n_live is None:
        live = torch.ones(n, dtype=torch.bool, device=dev)
        sets_l = sets
    else:
        m = torch.as_tensor(n_live, device=dev).to(torch.int32).clamp(0, n)
        live = torch.arange(n, dtype=torch.int32, device=dev) < m
        sets_l = torch.where(live, sets, num_sets)

    # the plain engine's first stage: set-major stable sort, then segmented
    # within-set ranks over the sorted layout
    order = torch.sort(sets_l, stable=True).indices
    _, _, _, rank_sorted, _, _, _ = _segment_fields(sets_l[order])
    rank = _permute_set(order, rank_sorted)
    generation = rank // max(slots, 1)
    # the sentinel set's arrivals land in the extra bin and are sliced off
    counts = torch.zeros(num_sets + 1, dtype=torch.int32, device=dev)
    counts.index_add_(0, sets_l.long(),
                      torch.ones(n, dtype=torch.int32, device=dev))
    return rank, generation, live, counts[:num_sets]
