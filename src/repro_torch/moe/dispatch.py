"""Expert-dispatch subsystem: planner/executor split over the hash engine.

Counterpart of ``repro.moe.dispatch``.  MoE token routing is the paper's
irregular access in an LM stack: every token issues
``expert_buffer[route[i]] <- x[i]``, with duplicate destinations and no
locality.  Dispatch is split into a *plan* (where every lane goes, what is
dropped, what each expert receives: integer bookkeeping) and an *executor*
(scatter, expert matmuls, combine), so the engines, the expert-parallel
path (``moe/ep.py``) and the stats (``moe/stats.py``) read one routing
decision.

Three engines:

* ``moe_hash``   -- the plan comes from the hash engine's occupancy
  machinery (``kernels/iru_reorder/dispatch.hash_dispatch``): expert id is
  the set key, expert capacity the per-set ``slots`` bound, so capacity is
  generation-0 residency and overflow drops are flushes.  Takes ``n_live``
  (a 0-d tensor or int) for ragged microbatches, with no host read.
* ``moe_sorted`` -- the sort engine (``core.iru.iru_reorder(mode="sort")``)
  reorders the (token, expert) stream; ranks come from a running max.
* ``moe_dense``  -- the GShard one-hot-einsum baseline, O(T·E·C·D).

All three give the same arrival-order rank, so their drop sets are equal
where capacity binds.  The expert matmuls are plain batched products, as in
the reference, which computes them outside any Pallas kernel.

Divergences from the reference, by design: ``jax.lax.top_k`` becomes a
stable descending sort sliced to ``k`` (JAX puts the lower index first on
ties; ``torch.topk`` promises no order), ``jax.nn.one_hot`` becomes a
comparison with ``arange`` (an out-of-range value gives a zero row), and
``mode="drop"`` scatters write to a sink row at ``E*C`` that is sliced off.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.core.iru import IRUConfig, iru_reorder
from repro_torch.kernels.iru_reorder.dispatch import hash_dispatch


def capacity(n_tokens: int, moe: MoEConfig) -> int:
    c = int(n_tokens * moe.top_k * moe.capacity_factor / moe.n_experts)
    return max(((c + 127) // 128) * 128, 128)  # 128-row aligned


def _live_rows(n_live, T: int, device) -> torch.Tensor:
    """``clip(n_live, 0, T)`` as an int32 0-d tensor on ``device``."""
    return torch.as_tensor(n_live, device=device).to(torch.int32).clamp(0, T)


def _route(params: dict, x: torch.Tensor, moe: MoEConfig, *,
           n_live=None, return_probs: bool = False):
    """f32 router: returns (gates (T,k), experts (T,k), aux_loss[, probs]).

    ``n_live`` masks the aux loss to the live token prefix; gates and
    experts are still computed for every row (the planner drops dead lanes).
    """
    logits = (x.float() @ params["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    # top_k with JAX's tie rule: the lower expert index first
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals = top.values[:, :moe.top_k]
    experts = top.indices[:, :moe.top_k].to(torch.int32)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)
    # Switch aux loss: E * sum_e (fraction_tokens_e * mean_prob_e)
    T = x.shape[0]
    ar_e = torch.arange(moe.n_experts, device=x.device)
    onehot = (experts[:, :1] == ar_e).float()
    if n_live is None:
        me = probs.mean(0)
        ce = onehot.mean(0)
    else:
        m = _live_rows(n_live, T, x.device)
        lm = (torch.arange(T, dtype=torch.int32, device=x.device)
              < m).float()[:, None]
        denom = m.float().clamp(min=1.0)
        me = (probs * lm).sum(0) / denom
        ce = (onehot * lm).sum(0) / denom
    aux = moe.n_experts * (me * ce).sum()
    if return_probs:
        return gate_vals, experts, aux, probs
    return gate_vals, experts, aux


def _experts_ffn(params: dict, buf: torch.Tensor,
                 ffn_type: str) -> torch.Tensor:
    """buf: (E, C, D) -> (E, C, D), segment-contiguous expert matmuls."""
    if ffn_type == "swiglu":
        h = F.silu(torch.einsum("ecd,edf->ecf", buf, params["wg"]))
        h = h * torch.einsum("ecd,edf->ecf", buf, params["wi"])
    else:
        h = F.gelu(torch.einsum("ecd,edf->ecf", buf, params["wi"]),
                   approximate="tanh")
    return torch.einsum("ecf,efd->ecd", h, params["wo"])


def _scatter_rows(rows: torch.Tensor, slot: torch.Tensor,
                  n_slots: int) -> torch.Tensor:
    """``zeros(n_slots, D).at[slot].set(rows, mode="drop")``: the sentinel
    slot ``n_slots`` is a sink row, sliced off.  Out of place, so autograd
    reaches ``rows``."""
    buf = rows.new_zeros((n_slots + 1, rows.shape[1]))
    return buf.index_copy(0, slot.long(), rows)[:n_slots]


def _combine(out: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor,
             gate: torch.Tensor, dst: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Gather each kept lane's expert row, weight it by its gate and sum it
    into ``dst`` of an f32 ``(n_rows, D)`` output; dropped lanes add 0."""
    g = out.index_select(0, slot.long().clamp(max=out.shape[0] - 1))
    g = torch.where(keep[:, None], g, 0)
    y = torch.zeros((n_rows, out.shape[1]), dtype=torch.float32,
                    device=out.device)
    return y.index_add(0, dst.long(), g.float() * gate[:, None])


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DispatchPlan:
    """Routing decision for one (token, expert) stream: bookkeeping only.

    Lane tensors have length ``L = T * top_k`` in stream order (token-major,
    k minor); per-expert tensors have length ``E``.  Executors receive the
    capacity ``C`` explicitly.
    """

    slot: torch.Tensor        # int32[L] expert*C + rank for kept lanes, E*C sentinel
    keep: torch.Tensor        # bool[L]  survives capacity (live & generation 0)
    expert: torch.Tensor      # int32[L] routed expert id (set key)
    rank: torch.Tensor        # int32[L] within-expert arrival rank (hash-set slot)
    generation: torch.Tensor  # int32[L] occupancy generation (0 = resident)
    live: torch.Tensor        # bool[L]  lane belongs to the live token prefix
    src_tok: torch.Tensor     # int32[L] source token row (lane // top_k)
    gate: torch.Tensor        # f32[L]   combine weight of the lane
    counts: torch.Tensor      # int32[E] live arrivals per expert (load histogram)
    kept: torch.Tensor        # int32[E] min(counts, C): tokens served
    dropped: torch.Tensor     # int32[E] counts - kept: overflow drops
    partition: torch.Tensor   # int32[L] banked-geometry home: expert % n_partitions


def plan_dispatch(experts: torch.Tensor, gates: torch.Tensor, cap: int,
                  n_experts: int, *, n_partitions: int = 1,
                  n_live=None) -> DispatchPlan:
    """Route the (token, expert) stream through the hash engine's planner.

    ``experts``: int (T, k) routed expert ids; ``gates``: f32 (T, k) combine
    weights; ``cap``: per-expert capacity; ``n_live``: live *token* count (a
    0-d tensor or int) -- the live lane prefix is ``n_live * k``.
    """
    T, k = experts.shape
    # the nominal engine geometry this plan instantiates (a check only):
    # expert id as the set key, capacity as the occupancy bound, partitions
    # striped by the banked engine's set % nP rule
    IRUConfig(mode="hash",
              num_sets=-(-n_experts // n_partitions) * n_partitions,
              slots=cap, n_partitions=n_partitions, n_banks=1)

    flat_e = experts.reshape(-1).to(torch.int32)
    lanes = flat_e.shape[0]
    dev = flat_e.device
    live_lanes = (None if n_live is None
                  else _live_rows(n_live, T, dev) * k)
    rank, generation, live, counts = hash_dispatch(
        flat_e, num_sets=n_experts, slots=cap, n_live=live_lanes)
    keep = live & (generation == 0)                          # the capacity rule
    slot = torch.where(keep, flat_e * cap + rank, n_experts * cap)
    kept = counts.clamp(max=cap)
    return DispatchPlan(
        slot=slot,
        keep=keep,
        expert=flat_e,
        rank=rank,
        generation=generation,
        live=live,
        src_tok=torch.arange(lanes, dtype=torch.int32, device=dev) // k,
        gate=gates.reshape(-1).float(),
        counts=counts,
        kept=kept,
        dropped=counts - kept,
        partition=flat_e % max(n_partitions, 1),
    )


# ---------------------------------------------------------------------------
# The executor
# ---------------------------------------------------------------------------

def execute_plan(params: dict, x: torch.Tensor, plan: DispatchPlan, cap: int,
                 ffn_type: str) -> torch.Tensor:
    """Scatter, expert matmuls, combine, all off the plan's bookkeeping.

    ``x``: (T, D) token rows.  Each kept lane owns a unique slot
    ``expert*C + rank``, so the capacity buffer is the materialized
    reorder; dropped lanes hit the ``E*C`` sink row.
    """
    T, D = x.shape
    E = plan.counts.shape[0]
    buf = _scatter_rows(x.index_select(0, plan.src_tok.long()), plan.slot,
                        E * cap)
    out = _experts_ffn(params, buf.reshape(E, cap, D), ffn_type)
    y = _combine(out.reshape(E * cap, D), plan.slot, plan.keep, plan.gate,
                 plan.src_tok, T)
    return y.to(x.dtype)


def moe_hash(params: dict, x: torch.Tensor, moe: MoEConfig, ffn_type: str, *,
             n_live=None, return_stats: bool = False):
    """x: (T, D) -> (T, D). Hash-engine planned dispatch (plan + execute)."""
    T, _ = x.shape
    C = capacity(T, moe)
    gates, experts, aux, probs = _route(params, x, moe, n_live=n_live,
                                        return_probs=True)
    plan = plan_dispatch(experts, gates, C, moe.n_experts, n_live=n_live)
    y = execute_plan(params, x, plan, C, ffn_type)
    if return_stats:
        from repro_torch.moe.stats import dispatch_stats

        return y, aux, dispatch_stats(plan, probs=probs, n_live=n_live)
    return y, aux


# ---------------------------------------------------------------------------
# IRU-sorted dispatch (the emission-ordered reference engine)
# ---------------------------------------------------------------------------

def moe_sorted(params: dict, x: torch.Tensor, moe: MoEConfig, ffn_type: str):
    """x: (T, D) -> (T, D). Sorted-dispatch MoE."""
    T, D = x.shape
    C = capacity(T, moe)
    E = moe.n_experts
    gates, experts, aux = _route(params, x, moe)

    flat_e = experts.reshape(-1)                             # the index stream
    stream = iru_reorder(flat_e, config=IRUConfig(mode="sort"))
    se = stream.indices                                      # sorted expert ids
    spos = stream.positions.long()                           # original lanes
    # rank within an expert's run = slot in the reorder-hash set
    ar = torch.arange(se.shape[0], dtype=torch.int32, device=se.device)
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=se.device),
                       se[1:] != se[:-1]])
    run_start = torch.cummax(torch.where(first, ar, -1), 0).values
    rank = ar - run_start
    keep = rank < C                                          # overflow drops
    slot = torch.where(keep, se * C + rank, E * C)           # sentinel: dropped

    src_tok = spos // moe.top_k
    buf = _scatter_rows(x.index_select(0, src_tok), slot, E * C)
    out = _experts_ffn(params, buf.reshape(E, C, D), ffn_type)
    # combine: service the reordered reply back to the original lanes
    w = gates.reshape(-1)[spos]                              # sorted lanes' gates
    y = _combine(out.reshape(E * C, D), slot, keep, w, src_tok, T)
    return y.to(x.dtype), aux


# ---------------------------------------------------------------------------
# Dense one-hot dispatch (baseline)
# ---------------------------------------------------------------------------

def moe_dense(params: dict, x: torch.Tensor, moe: MoEConfig, ffn_type: str):
    """GShard-style einsum dispatch. O(T*E*C*D): the baseline."""
    T, D = x.shape
    C = capacity(T, moe)
    E = moe.n_experts
    gates, experts, aux = _route(params, x, moe)
    # position of each (t, k) within its expert, via cumsum over the lanes
    oh = (experts[..., None] == torch.arange(E, device=x.device)).float()
    ohf = oh.reshape(T * moe.top_k, E)                       # k-minor in token
    pos_in_e = torch.cumsum(ohf, 0) - ohf                    # (T*k, E)
    rank = (pos_in_e * ohf).sum(-1).reshape(T, moe.top_k)
    keep = rank < C
    # one_hot(rank, C): a rank past C (a dropped lane) gives a zero row
    rank_oh = (rank[..., None]
               == torch.arange(C, device=x.device, dtype=torch.float32)
               ).float()                                     # (T, k, C)
    disp = (oh * keep[..., None])[..., None] * rank_oh[:, :, None, :]
    dispatch = disp.sum(1)                                   # (T, E, C) 0/1
    combine = (disp * gates[..., None, None]).sum(1)         # (T, E, C)
    buf = torch.einsum("tec,td->ecd", dispatch, x.float()).to(x.dtype)
    out = _experts_ffn(params, buf, ffn_type)
    y = torch.einsum("tec,ecd->td", combine, out.float())
    return y.to(x.dtype), aux
