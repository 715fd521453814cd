"""Attention mixers: GQA (RoPE, qk-norm, sliding window), MLA,
cross-attention (counterpart of ``repro.models.attention``).

All softmax statistics are computed in f32.  Long sequences use blockwise
(flash-style) attention -- an outer loop over query chunks with an inner
loop over KV chunks carrying running (max, denominator, accumulator) -- so
no (S, S) score tensor is ever materialized.  The reference computes this
in jnp, outside any Pallas kernel; so does the port, in plain torch, with
the reference's chunks in the reference's order (a fused library attention
would sum in another order).

Causal block skipping: the inner KV loop runs over all blocks and masks.
Sliding-window attention restricts the inner loop to exactly
``window // kv_chunk + 1`` blocks ending at the query chunk's block.

Masked scores are ``NEG_INF = -1e30``, finite on purpose: a block with no
admitted key (a window's ``kj < 0``) adds ``exp(0)`` junk to the running
sums, which a later real block's ``exp(m - new_m) = 0`` wipes out; with
``-inf`` it would give NaN.

Decode: single-token queries against a preallocated cache.  GQA caches
(K, V); MLA caches the compressed c_kv only and uses the *absorbed* form
(q folded through W_uk; the context through W_uv).  ``cache_write`` writes
into the cache tensor in place and returns it (the reference returns a new
array; the values are the same).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.common import Initializer, constrain, rms_norm
from repro_torch.models.measure import mscan

NEG_INF = -1e30


def _inv_sqrt(d: int) -> float:
    """``1 / sqrt(d)`` rounded as the reference's f32 arithmetic rounds it."""
    return float(np.float32(1.0) / np.sqrt(np.float32(d)))


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def step_positions(pos, S: int, device=None) -> torch.Tensor:
    """Positions for an S-token slice starting at ``pos``.

    ``pos`` may be None (0), a scalar (int or 0-d tensor), or a per-batch
    (B,) vector (the continuous-batching engine leases slots at independent
    offsets).  Returns int32 (S,) or (B, S)."""
    ar = torch.arange(S, dtype=torch.int32, device=device)
    if pos is None:
        return ar
    base = torch.as_tensor(pos, dtype=torch.int32, device=device)
    if base.ndim == 0:
        return base + ar
    return base[:, None] + ar[None, :]


def cache_write(cache: torch.Tensor, new: torch.Tensor, pos) -> torch.Tensor:
    """Write ``new`` (B, S, ...) into ``cache`` (B, S_max, ...) at ``pos``
    (scalar) or per-batch offsets (B,) when S == 1, in place; returns
    ``cache``.

    A scalar start counts from the end when negative and is then clamped
    into ``[0, S_max - S]``, as ``lax.dynamic_update_slice`` does; torch
    slicing would fail or drop the write instead.  Per-batch offsets follow
    ``.at[arange(B), pos].set``: a negative offset counts from the end and
    an offset still out of range drops that row's write.  Neither reads
    ``pos`` on the host."""
    new = new.to(cache.dtype)
    S_max, S = cache.shape[1], new.shape[1]
    pos = torch.as_tensor(pos, device=cache.device)
    p = pos.to(torch.int64)
    p = torch.where(p < 0, p + S_max, p)
    if pos.ndim == 0:
        start = p.clamp(0, S_max - S)
        idx = start + torch.arange(S, device=cache.device)
        return cache.index_copy_(1, idx, new)
    B = cache.shape[0]
    assert S == 1, "vector pos requires single-step writes"
    ok = ((p >= 0) & (p < S_max)).reshape((B,) + (1,) * (cache.ndim - 2))
    p = p.clamp(0, S_max - 1)
    rows = torch.arange(B, device=cache.device)
    cache[rows, p] = torch.where(ok, new[:, 0], cache[rows, p])
    return cache


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, hd), positions: (S,) or (B, S).  Split halves (not
    interleaved), computed in f32."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    ang = positions[..., None].float() * freqs  # (S, hd/2) or (B, S, hd/2)
    if ang.ndim == 2:  # (S, hd/2) -> broadcast over batch
        ang = ang[None]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Parameter initialization
# ---------------------------------------------------------------------------

def init_gqa(it: Initializer, d_model: int, n_heads: int, n_kv: int,
             head_dim: int, *, qk_norm: bool = False) -> None:
    it.weight("wq", (d_model, n_heads, head_dim), ("embed", "heads", None))
    it.weight("wk", (d_model, n_kv, head_dim), ("embed", "kv_heads", None))
    it.weight("wv", (d_model, n_kv, head_dim), ("embed", "kv_heads", None))
    it.weight("wo", (n_heads, head_dim, d_model), ("heads", None, "embed"))
    if qk_norm:
        it.weight("q_norm", (head_dim,), (None,), init="ones")
        it.weight("k_norm", (head_dim,), (None,), init="ones")


def init_mla(it: Initializer, d_model: int, n_heads: int, head_dim: int,
             kv_lora: int, rope_dim: int) -> None:
    it.weight("w_dkv", (d_model, kv_lora + rope_dim), ("embed", "lora"))
    it.weight("kv_norm", (kv_lora,), (None,), init="ones")
    it.weight("w_uk", (kv_lora, n_heads, head_dim), ("lora", "heads", None))
    it.weight("w_uv", (kv_lora, n_heads, head_dim), ("lora", "heads", None))
    it.weight("wq", (d_model, n_heads, head_dim + rope_dim),
              ("embed", "heads", None))
    it.weight("wo", (n_heads, head_dim, d_model), ("heads", None, "embed"))


# ---------------------------------------------------------------------------
# Blockwise (flash-style) attention core
# ---------------------------------------------------------------------------

def _attend_block(q, k, v, mask, scale):
    """One (q-chunk, kv-chunk) tile. q: (B,Sq,KV,G,hd) k/v: (B,Sk,KV,hd)."""
    s = torch.einsum("bqkgh,bskh->bkgqs", q.float(), k.float()) * scale
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1)                                        # (B,KV,G,Sq)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bkgqs,bskh->bkgqh", p, v.float())
    return m, l, o


def blockwise_attn(
    q: torch.Tensor,            # (B, Sq, H, hd)
    k: torch.Tensor,            # (B, Sk, KV, hd)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
    q_offset: int = 0,
) -> torch.Tensor:
    """Memory-bounded exact attention. Returns (B, Sq, H, vd) in q.dtype."""
    B, Sq0, H, hd = q.shape
    Sk0, KV = k.shape[1], k.shape[2]
    vd = v.shape[-1]                 # may differ from hd (MLA packs rope into q/k)
    G = H // KV
    scale = _inv_sqrt(hd)
    q_chunk = min(q_chunk, Sq0)
    kv_chunk = min(kv_chunk, Sk0)
    # pad ragged sequence tails; padded kv positions are masked out below
    qpad, kpad = (-Sq0) % q_chunk, (-Sk0) % kv_chunk
    if qpad:
        q = F.pad(q, (0, 0, 0, 0, 0, qpad))
    if kpad:
        k = F.pad(k, (0, 0, 0, 0, 0, kpad))
        v = F.pad(v, (0, 0, 0, 0, 0, kpad))
    Sq, Sk = Sq0 + qpad, Sk0 + kpad
    nq, nk = Sq // q_chunk, Sk // kv_chunk
    qg = q.reshape(B, nq, q_chunk, KV, G, hd)
    kg = k.reshape(B, nk, kv_chunk, KV, hd)
    vg = v.reshape(B, nk, kv_chunk, KV, vd)
    # sliding window: each q chunk needs at most w_blocks trailing kv chunks
    w_blocks = nk if window is None else min(nk, window // kv_chunk + 1)

    q_pos_base = torch.arange(q_chunk, device=q.device)
    k_pos_base = torch.arange(kv_chunk, device=q.device)

    def q_body(_, qi):
        qc = qg[:, qi]                                        # (B,qc,KV,G,hd)
        q_pos = q_offset + qi * q_chunk + q_pos_base

        def kv_body(carry, kj):
            m, l, acc = carry
            kj_safe = min(max(kj, 0), nk - 1)
            kc = kg[:, kj_safe]
            vc = vg[:, kj_safe]
            k_pos = kj_safe * kv_chunk + k_pos_base
            mask = (k_pos[None, :] < Sk0).expand(q_chunk, kv_chunk)
            if causal:
                mask = mask & (q_pos[:, None] >= k_pos[None, :])
            if window is not None:
                mask = mask & ((q_pos[:, None] - k_pos[None, :]) < window)
            if not 0 <= kj < nk:
                mask = torch.zeros_like(mask)
            bm, bl, bo = _attend_block(qc, kc, vc, mask, scale)
            new_m = torch.maximum(m, bm)
            c1 = torch.exp(m - new_m)
            c2 = torch.exp(bm - new_m)
            l = l * c1 + bl * c2
            acc = acc * c1[..., None] + bo * c2[..., None]
            return (new_m, l, acc), None

        m0 = torch.full((B, KV, G, q_chunk), NEG_INF, dtype=torch.float32,
                        device=q.device)
        l0 = torch.zeros((B, KV, G, q_chunk), dtype=torch.float32,
                         device=q.device)
        a0 = torch.zeros((B, KV, G, q_chunk, vd), dtype=torch.float32,
                         device=q.device)
        if window is None:
            kjs = range(nk)
        else:
            # last w_blocks ending at this q chunk's block
            end = (q_offset // kv_chunk) + (qi * q_chunk) // kv_chunk
            kjs = range(end - w_blocks + 1, end + 1)
        (m, l, acc), _ = mscan(kv_body, (m0, l0, a0), kjs)
        out = acc / torch.clamp(l, min=1e-30)[..., None]      # (B,KV,G,qc,vd)
        return None, out.permute(0, 3, 1, 2, 4)               # (B,qc,KV,G,vd)

    _, outs = mscan(q_body, None, range(nq))                  # (nq,B,qc,KV,G,vd)
    out = outs.permute(1, 0, 2, 3, 4, 5).reshape(B, Sq, H, vd)
    return out[:, :Sq0].to(q.dtype)


# ---------------------------------------------------------------------------
# GQA layer
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnSpec:
    n_heads: int
    n_kv: int
    head_dim: int
    rope_theta: float
    qk_norm: bool = False
    window: Optional[int] = None
    causal: bool = True
    norm_eps: float = 1e-6
    q_chunk: int = 1024
    kv_chunk: int = 1024


def gqa_forward(
    params: dict,
    x: torch.Tensor,                  # (B, S, D)
    spec: AttnSpec,
    *,
    positions: torch.Tensor | None = None,
    kv_cache: dict | None = None,     # {"k": (B,S_max,KV,hd), "v": ...}
    pos=None,                         # decode write offset (scalar or (B,))
    cross_kv: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, dict | None]:
    B, S, _ = x.shape
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    if cross_kv is None:
        k = torch.einsum("bsd,dhk->bshk", x, params["wk"])
        v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
    else:
        k, v = cross_kv
    if spec.qk_norm:
        q = rms_norm(q, params["q_norm"], spec.norm_eps)
        k = rms_norm(k, params["k_norm"], spec.norm_eps) if cross_kv is None else k
    if positions is None:
        positions = step_positions(pos, S, x.device)
    if cross_kv is None:  # rope only for self-attention (encoder stand-in too)
        q = apply_rope(q, positions, spec.rope_theta)
        k = apply_rope(k, positions, spec.rope_theta)
    q = constrain(q, ("batch", "seq", "heads", None))

    if kv_cache is not None and pos is not None and S == 1:
        # ---- decode: write one step, attend against the whole cache -------
        kc = cache_write(kv_cache["k"], k, pos)
        vc = cache_write(kv_cache["v"], v, pos)
        out = decode_attn(q, kc, vc, pos, window=spec.window)
        new_cache = {"k": kc, "v": vc}
    elif kv_cache is not None and pos is not None:
        # ---- prefill: fill cache, blockwise self-attention ---------------
        kc = cache_write(kv_cache["k"], k, pos)
        vc = cache_write(kv_cache["v"], v, pos)
        out = blockwise_attn(q, k, v, causal=spec.causal, window=spec.window,
                             q_chunk=spec.q_chunk, kv_chunk=spec.kv_chunk)
        new_cache = {"k": kc, "v": vc}
    else:
        out = blockwise_attn(q, k, v, causal=spec.causal and cross_kv is None,
                             window=spec.window,
                             q_chunk=spec.q_chunk, kv_chunk=spec.kv_chunk)
        new_cache = None
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"])
    return constrain(y, ("batch", "seq", "embed")), new_cache


def _length_mask(pos, S: int, device, window: Optional[int] = None):
    """(B or 1, S) admitted cache positions: ``<= pos``, and within
    ``window`` of it."""
    ks = torch.arange(S, device=device)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=device)
    pb = pos if pos.ndim else pos[None]          # (B,) or broadcastable (1,)
    ok = ks[None, :] <= pb[:, None]
    if window is not None:
        ok = ok & ((pb[:, None] - ks[None, :]) < window)
    return ok


def decode_attn(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor, pos,
                *, window: Optional[int] = None) -> torch.Tensor:
    """One-token attention against a cache.

    q: (B,1,H,hd), kc/vc: (B,S,KV,hd).  The length mask admits positions
    <= pos; a sliding window additionally drops positions older than
    ``window``.
    """
    B, S, KV, hd = kc.shape
    H = q.shape[2]
    G = H // KV
    qf = q.reshape(B, KV, G, hd).float()
    s = torch.einsum("bkgh,bskh->bkgs", qf, kc.float())
    s = s / torch.sqrt(torch.tensor(hd, dtype=torch.float32, device=s.device))
    ok = _length_mask(pos, S, kc.device, window)
    s = torch.where(ok[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", p, vc.float())
    return o.reshape(B, 1, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# MLA layer (DeepSeek-V2)
# ---------------------------------------------------------------------------

def mla_forward(
    params: dict,
    x: torch.Tensor,
    spec: AttnSpec,
    kv_lora: int,
    rope_dim: int,
    *,
    kv_cache: dict | None = None,     # {"ckv": (B, S_max, kv_lora + rope_dim)}
    pos=None,
    norm_eps: float = 1e-6,
) -> tuple[torch.Tensor, dict | None]:
    B, S, _ = x.shape
    H, hd = spec.n_heads, spec.head_dim
    ckv = torch.einsum("bsd,dr->bsr", x, params["w_dkv"])     # (B,S,r+rope)
    c, k_rope = ckv[..., :kv_lora], ckv[..., kv_lora:]
    c = rms_norm(c, params["kv_norm"], norm_eps)
    q_full = torch.einsum("bsd,dhk->bshk", x, params["wq"])   # (B,S,H,hd+rope)
    q_nope, q_rope = q_full[..., :hd], q_full[..., hd:]
    positions = step_positions(pos, S, x.device)
    q_rope = apply_rope(q_rope, positions, spec.rope_theta)
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        spec.rope_theta)[:, :, 0, :]
    ckv_post = torch.cat([c, k_rope], dim=-1).to(x.dtype)
    scale = _inv_sqrt(hd + rope_dim)

    if kv_cache is not None and pos is not None and S == 1:
        # ---- absorbed decode: scores/context live in the compressed space --
        cc = cache_write(kv_cache["ckv"], ckv_post, pos)
        c_cache, kr_cache = cc[..., :kv_lora], cc[..., kv_lora:]
        q_abs = torch.einsum("bshk,rhk->bshr", q_nope, params["w_uk"])
        s = torch.einsum("bshr,btr->bhst", q_abs.float(), c_cache.float())
        s = s + torch.einsum("bshk,btk->bhst", q_rope.float(),
                             kr_cache.float())
        s = s * scale
        ok = _length_mask(pos, cc.shape[1], cc.device)
        s = torch.where(ok[:, None, None, :], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        ctx = torch.einsum("bhst,btr->bshr", p, c_cache.float())  # (B,1,H,r)
        out = torch.einsum("bshr,rhk->bshk", ctx.to(x.dtype), params["w_uv"])
        new_cache = {"ckv": cc}
    else:
        # ---- train / prefill: expand K,V then blockwise attention ---------
        k_nope = torch.einsum("bsr,rhk->bshk", c, params["w_uk"])
        vv = torch.einsum("bsr,rhk->bshk", c, params["w_uv"])
        kk = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, rope_dim)],
                       dim=-1)
        qq = torch.cat([q_nope, q_rope], dim=-1)
        # v keeps head_dim; q and k carry hd + rope (scale 1/sqrt(hd + rope))
        out = blockwise_attn(qq, kk.to(x.dtype), vv.to(x.dtype), causal=True,
                             q_chunk=spec.q_chunk, kv_chunk=spec.kv_chunk)
        new_cache = None
        if kv_cache is not None and pos is not None:
            new_cache = {"ckv": cache_write(kv_cache["ckv"], ckv_post, pos)}
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"])
    return constrain(y, ("batch", "seq", "embed")), new_cache
