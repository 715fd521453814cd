"""Composable transformer assembly for all assigned architectures
(counterpart of ``repro.models.transformer``).

One code path serves dense / MoE / hybrid / SSM / enc-dec / embeds-frontend
models.  Layers are grouped into *stages* -- maximal runs of a repeating
unit -- and each stage's parameters are stacked on a leading axis and run
by ``measure.mscan``, a loop over that axis.  Heterogeneous prefixes
(DeepSeek's first dense layer) become their own 1-repeat stage.  The param
tree, its logical-axis specs and the cache tree have the reference's keys,
shapes and dtypes.

Public surface:
  init_params / abstract_params   -- (params, logical-axis specs)
  forward_train                   -- full-sequence causal logits (+ aux loss)
  init_cache / cache_axes         -- decode cache (concrete or on ``meta``)
  prefill / decode_step           -- fill the cache from a prompt; one serve step
  encode                          -- whisper encoder

Decode caches are updated in place (each stage's stacked tensors), and
``prefill`` / ``decode_step`` return the same tensors.  Training honours
``pcfg.remat``: with ``"full"`` and grad enabled, each unit of a stage (and
of the encoder) runs under ``torch.utils.checkpoint``, as the reference
wraps it in ``jax.checkpoint``; serving runs under
``torch.inference_mode`` and is not wrapped.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.device import resolve_device
from repro_torch.models import embedding
from repro_torch.models.attention import (AttnSpec, gqa_forward, init_gqa,
                                          init_mla, mla_forward)
from repro_torch.models.common import (Initializer, constrain, ffn, init_ffn,
                                       rms_norm)
from repro_torch.models.mamba2 import init_mamba, mamba_forward
from repro_torch.models.measure import mscan, tree_leaves
from repro_torch.models.moe import init_moe, moe_ffn


# ---------------------------------------------------------------------------
# Stage plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str                 # "attn" | "mamba"
    is_moe: bool
    has_ffn: bool
    cross: bool = False


def _layer_spec(cfg: ModelConfig, i: int, *, cross: bool = False) -> LayerSpec:
    kind = cfg.layer_kinds()[i]
    return LayerSpec(
        kind=kind,
        is_moe=cfg.is_moe_layer(i),
        has_ffn=cfg.d_ff > 0 or cfg.is_moe_layer(i),
        cross=cross,
    )


def stage_plan(cfg: ModelConfig) -> list[tuple[int, tuple[LayerSpec, ...]]]:
    """[(repeat, unit-specs)] covering the decoder stack."""
    cross = cfg.encoder_layers > 0
    lead = cfg.moe.first_dense_layers if cfg.moe else 0
    stages: list[tuple[int, tuple[LayerSpec, ...]]] = []
    if lead:
        stages.append((1, tuple(_layer_spec(cfg, i, cross=cross)
                                for i in range(lead))))
    unit = cfg.unit_len() if not lead else 1
    body = cfg.n_layers - lead
    assert body % unit == 0, (cfg.name, body, unit)
    unit_specs = tuple(_layer_spec(cfg, lead + j, cross=cross)
                       for j in range(unit))
    stages.append((body // unit, unit_specs))
    return stages


def _attn_spec(cfg: ModelConfig, pcfg: ParallelConfig, *,
               causal: bool = True) -> AttnSpec:
    return AttnSpec(
        n_heads=pcfg.padded_heads(cfg.n_heads),
        n_kv=cfg.n_kv_heads,
        head_dim=cfg.head_dim,
        rope_theta=cfg.rope_theta,
        qk_norm=cfg.qk_norm,
        window=cfg.attn_window,
        causal=causal,
        norm_eps=cfg.norm_eps,
        q_chunk=pcfg.attn_chunk,
        kv_chunk=pcfg.attn_chunk,
    )


# ---------------------------------------------------------------------------
# Parameter construction
# ---------------------------------------------------------------------------

def _init_layer(it: Initializer, cfg: ModelConfig, pcfg: ParallelConfig,
                ls: LayerSpec) -> None:
    d = cfg.d_model
    it.weight("ln1", (d,), ("embed",), init="ones")
    if ls.kind == "attn":
        sub = it.sub("attn")
        h_pad = pcfg.padded_heads(cfg.n_heads)
        if cfg.attention == "mla":
            init_mla(sub, d, h_pad, cfg.head_dim, cfg.kv_lora_rank,
                     cfg.qk_rope_dim)
        else:
            init_gqa(sub, d, h_pad, cfg.n_kv_heads, cfg.head_dim,
                     qk_norm=cfg.qk_norm)
    else:
        init_mamba(it.sub("mamba"), d, cfg.mamba)
    if ls.cross:
        it.weight("ln_x", (d,), ("embed",), init="ones")
        init_gqa(it.sub("cross"), d, pcfg.padded_heads(cfg.n_heads),
                 cfg.n_kv_heads, cfg.head_dim, qk_norm=False)
    if ls.has_ffn:
        it.weight("ln2", (d,), ("embed",), init="ones")
        if ls.is_moe:
            init_moe(it.sub("moe"), d, cfg.moe, cfg.ffn_type)
        else:
            init_ffn(it.sub("ffn"), d, cfg.d_ff, cfg.ffn_type)


def _init_unit(it: Initializer, cfg: ModelConfig, pcfg: ParallelConfig,
               specs: tuple[LayerSpec, ...]) -> None:
    for j, ls in enumerate(specs):
        _init_layer(it.sub(f"l{j}"), cfg, pcfg, ls)


def init_params(cfg: ModelConfig, pcfg: ParallelConfig,
                generator: Optional[torch.Generator],
                device: str | torch.device | None = None):
    """Returns (params, logical-axis specs) in lockstep.  Weights are drawn
    from ``generator`` (the reference takes a JAX key: the same seed gives
    other numbers); ``device=None`` is the card."""
    it = Initializer(generator, cfg.dtype, device)
    vocab = pcfg.padded_vocab(cfg.vocab_size)
    embedding.init_embedding(it.sub("embed"), vocab, cfg.d_model)
    if cfg.encoder_layers:
        enc = it.sub("enc")
        enc_specs = (LayerSpec(kind="attn", is_moe=False, has_ffn=True),)
        enc.vmap_unit("stage0", cfg.encoder_layers,
                      functools.partial(_init_unit, cfg=cfg, pcfg=pcfg,
                                        specs=enc_specs))
        enc.weight("norm", (cfg.d_model,), ("embed",), init="ones")
    dec = it.sub("dec")
    for si, (rep, specs) in enumerate(stage_plan(cfg)):
        dec.vmap_unit(f"stage{si}", rep,
                      functools.partial(_init_unit, cfg=cfg, pcfg=pcfg,
                                        specs=specs))
    it.weight("norm", (cfg.d_model,), ("embed",), init="ones")
    if not cfg.tie_embeddings:
        it.weight("head", (cfg.d_model, vocab), ("embed", "vocab"))
    return it.params, it.specs


def abstract_params(cfg: ModelConfig, pcfg: ParallelConfig):
    """(params on the ``meta`` device, logical-axis specs): shapes and
    dtypes without allocation."""
    return init_params(cfg, pcfg, None, device="meta")


# ---------------------------------------------------------------------------
# Layer / stage execution
# ---------------------------------------------------------------------------

def _run_layer(p: dict, x: torch.Tensor, ls: LayerSpec, cfg: ModelConfig,
               pcfg: ParallelConfig, *, cache: dict | None, pos, enc_out,
               want_stats: bool = False):
    aux = x.new_zeros((), dtype=torch.float32)
    stats = None
    new_cache: dict = {}
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if ls.kind == "attn":
        spec = _attn_spec(cfg, pcfg)
        if cfg.attention == "mla":
            y, ac = mla_forward(p["attn"], h, spec, cfg.kv_lora_rank,
                                cfg.qk_rope_dim,
                                kv_cache=None if cache is None else cache.get("attn"),
                                pos=pos, norm_eps=cfg.norm_eps)
        else:
            y, ac = gqa_forward(p["attn"], h, spec,
                                kv_cache=None if cache is None else cache.get("attn"),
                                pos=pos)
        if ac is not None:
            new_cache["attn"] = ac
    else:
        y, ms = mamba_forward(p["mamba"], h, cfg.mamba, cfg.d_model,
                              state=None if cache is None else cache.get("mamba"),
                              norm_eps=cfg.norm_eps)
        if ms is not None:
            new_cache["mamba"] = ms
    x = x + y
    if ls.cross:
        h = rms_norm(x, p["ln_x"], cfg.norm_eps)
        if enc_out is not None:
            # train / prefill: project encoder output fresh (and cache it)
            ck = torch.einsum("bfd,dhk->bfhk", enc_out, p["cross"]["wk"])
            cv = torch.einsum("bfd,dhk->bfhk", enc_out, p["cross"]["wv"])
            ckv = (ck, cv)
            if cache is not None:
                new_cache["cross"] = {"ck": ck.to(cfg.dtype),
                                      "cv": cv.to(cfg.dtype)}
        else:
            ckv = (cache["cross"]["ck"], cache["cross"]["cv"])
            new_cache["cross"] = cache["cross"]
        y, _ = gqa_forward(p["cross"], h, _attn_spec(cfg, pcfg, causal=False),
                           cross_kv=ckv)
        x = x + y
    if ls.has_ffn:
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        if ls.is_moe:
            if want_stats and cfg.moe.dispatch == "iru_hash":
                y, a, stats = moe_ffn(p["moe"], h, cfg.moe, cfg.ffn_type,
                                      return_stats=True)
            else:
                y, a = moe_ffn(p["moe"], h, cfg.moe, cfg.ffn_type)
            aux = aux + a
        else:
            y = ffn(p["ffn"], h, cfg.ffn_type)
        x = x + y
    return constrain(x, ("batch", "seq", "embed")), new_cache, aux, stats


def _write_back(cache: dict, new: dict) -> None:
    """Store a layer's new cache leaves into its slice of the stacked cache
    (attention leaves were written in place and are the same tensors)."""
    for k, v in new.items():
        if isinstance(v, dict):
            _write_back(cache[k], v)
        elif v is not cache[k]:
            cache[k].copy_(v)


def _checkpointed(unit_body):
    """``unit_body`` under activation checkpointing where grad is enabled.

    The recompute must save the same tensors as the first run: the units'
    sorts are stable and the MoE planner's counts are integers, so a MoE
    unit drops the same lanes both times.  No unit draws random numbers,
    so the RNG state is not stashed."""

    def body(carry, inputs):
        if not torch.is_grad_enabled():
            return unit_body(carry, inputs)
        return torch.utils.checkpoint.checkpoint(
            unit_body, carry, inputs, use_reentrant=False,
            preserve_rng_state=False)

    return body


def _run_stage(stacked: dict, x: torch.Tensor, specs: tuple[LayerSpec, ...],
               cfg: ModelConfig, pcfg: ParallelConfig, *,
               caches=None, pos=None, enc_out=None, remat: bool = False,
               want_stats: bool = False):
    """Run a stacked stage, one unit at a time.

    Returns ``(x, caches, aux_sum, stats)``: ``caches`` is the stage's
    stacked cache, updated in place; ``stats`` is a per-unit-layer tuple of
    ``DispatchStats`` stacked over the repeats ([rep, ...] leaves) for MoE
    layers under ``want_stats``, None entries otherwise.  ``remat`` (with
    ``pcfg.remat != "none"``) recomputes each unit in the backward pass
    instead of keeping its activations; it applies only where grad is
    enabled.
    """

    def unit_body(xx, inputs):
        p, c = inputs
        aux = xx.new_zeros((), dtype=torch.float32)
        sts = []
        for j, ls in enumerate(specs):
            cj = None if c is None else c[j]
            xx, nc, a, st = _run_layer(p[f"l{j}"], xx, ls, cfg, pcfg,
                                       cache=cj, pos=pos, enc_out=enc_out,
                                       want_stats=want_stats)
            if cj is not None:
                _write_back(cj, nc)
            sts.append(st)
            aux = aux + a
        return xx, (aux, tuple(sts))

    body = unit_body
    if remat and pcfg.remat != "none":
        body = _checkpointed(unit_body)
    n_rep = tree_leaves(stacked)[0].shape[0]
    x, (auxs, stats) = mscan(body, x, (stacked, caches), length=n_rep)
    return x, caches, auxs.sum(), stats


# ---------------------------------------------------------------------------
# Embedding of model inputs (token / embeds / vlm frontends)
# ---------------------------------------------------------------------------

N_PATCHES = 576  # llava-next anyres stub: one base 24x24 grid of patch embeds


def _embed_inputs(params: dict, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    iru = cfg.iru_embedding
    if cfg.family == "vlm":
        tok = embedding.embed(params["embed"], batch["tokens"], iru=iru)
        x = torch.cat([batch["patches"].to(tok.dtype), tok], dim=1)
    elif cfg.frontend == "embeds" and "embeds" in batch:
        x = batch["embeds"]
    else:
        x = embedding.embed(params["embed"], batch["tokens"], iru=iru)
    return constrain(x, ("batch", "seq", "embed"))


# ---------------------------------------------------------------------------
# Whisper encoder
# ---------------------------------------------------------------------------

def encode(params: dict, cfg: ModelConfig, pcfg: ParallelConfig,
           frames: torch.Tensor, *, remat: bool = False) -> torch.Tensor:
    """frames: (B, F, D) precomputed frame embeddings (conv frontend stub)."""
    enc_cfg = dataclasses.replace(cfg, attn_window=None)
    spec = _attn_spec(enc_cfg, pcfg, causal=False)

    def unit_body(xx, p):
        h = rms_norm(xx, p["l0"]["ln1"], cfg.norm_eps)
        y, _ = gqa_forward(p["l0"]["attn"], h, spec)
        xx = xx + y
        h = rms_norm(xx, p["l0"]["ln2"], cfg.norm_eps)
        xx = xx + ffn(p["l0"]["ffn"], h, cfg.ffn_type)
        return xx, None

    body = _checkpointed(unit_body) if remat else unit_body
    x, _ = mscan(body, frames, params["enc"]["stage0"])
    return rms_norm(x, params["enc"]["norm"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# Training forward
# ---------------------------------------------------------------------------

def forward_train(params: dict, cfg: ModelConfig, pcfg: ParallelConfig,
                  batch: dict, *, return_stats: bool = False):
    """Full-sequence causal logits. Returns (logits f32, aux_loss), plus a
    flat per-MoE-layer list of stacked ``DispatchStats`` when
    ``return_stats`` (planned ``iru_hash`` dispatch only; empty list
    otherwise)."""
    want_stats = (return_stats and cfg.moe is not None
                  and cfg.moe.dispatch == "iru_hash")
    x = _embed_inputs(params, cfg, batch)
    enc_out = None
    if cfg.encoder_layers:
        enc_out = encode(params, cfg, pcfg, batch["frames"],
                         remat=pcfg.remat == "full")
    aux = x.new_zeros((), dtype=torch.float32)
    all_stats = []
    for si, (rep, specs) in enumerate(stage_plan(cfg)):
        x, _, a, stats = _run_stage(params["dec"][f"stage{si}"], x, specs,
                                    cfg, pcfg, enc_out=enc_out,
                                    remat=pcfg.remat == "full",
                                    want_stats=want_stats)
        aux = aux + a
        all_stats.extend(st for st in stats if st is not None)
    x = rms_norm(x, params["norm"], cfg.norm_eps)
    lg = embedding.logits(params["embed"], x, params.get("head"))
    if return_stats:
        return lg, aux, all_stats
    return lg, aux


# ---------------------------------------------------------------------------
# Decode cache
# ---------------------------------------------------------------------------

def _layer_cache(cfg: ModelConfig, pcfg: ParallelConfig, ls: LayerSpec,
                 batch: int, max_seq: int):
    """Returns ({kind: {name: (shape, dtype)}}, {kind: {name: axes}}) for
    one layer."""
    dt = cfg.dtype
    c: dict = {}
    a: dict = {}
    if ls.kind == "attn":
        if cfg.attention == "mla":
            c["attn"] = {"ckv": ((batch, max_seq,
                                  cfg.kv_lora_rank + cfg.qk_rope_dim), dt)}
            a["attn"] = {"ckv": ("batch", "kv_seq", None)}
        else:
            kv = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
            c["attn"] = {"k": (kv, dt), "v": (kv, dt)}
            a["attn"] = {"k": ("batch", "kv_seq", "kv_heads", None),
                         "v": ("batch", "kv_seq", "kv_heads", None)}
    else:
        mc = cfg.mamba
        d_in = mc.d_inner(cfg.d_model)
        nh = mc.n_heads(cfg.d_model)
        c["mamba"] = {
            "conv": ((batch, mc.d_conv - 1, d_in + 2 * mc.d_state), dt),
            "ssm": ((batch, nh, mc.head_dim, mc.d_state), torch.float32),
        }
        a["mamba"] = {"conv": ("batch", None, "ffn"),
                      "ssm": ("batch", "ssm_heads", None, "state")}
    if ls.cross:
        kvf = (batch, cfg.encoder_frames, cfg.n_kv_heads, cfg.head_dim)
        c["cross"] = {"ck": (kvf, dt), "cv": (kvf, dt)}
        a["cross"] = {"ck": ("batch", "frames", "kv_heads", None),
                      "cv": ("batch", "frames", "kv_heads", None)}
    return c, a


def _map2(tree: dict, fn) -> dict:
    """Map the leaves of a two-level {kind: {name: leaf}} dict."""
    return {kind: {name: fn(leaf) for name, leaf in leaves.items()}
            for kind, leaves in tree.items()}


def cache_struct(cfg: ModelConfig, pcfg: ParallelConfig, batch: int,
                 max_seq: int):
    """((shape, dtype) tree, logical-axes tree), stacked per stage: a list
    per stage of a tuple per unit layer of {kind: {name: leaf}}."""
    shapes, axes = [], []
    for rep, specs in stage_plan(cfg):
        cs, as_ = [], []
        for ls in specs:
            c, a = _layer_cache(cfg, pcfg, ls, batch, max_seq)
            cs.append(_map2(c, lambda sd: ((rep,) + sd[0], sd[1])))
            as_.append(_map2(a, lambda ax: (None,) + ax))
        shapes.append(tuple(cs))
        axes.append(tuple(as_))
    return shapes, axes


def init_cache(cfg: ModelConfig, pcfg: ParallelConfig, batch: int,
               max_seq: int, *, abstract: bool = False,
               device: str | torch.device | None = None):
    """Zero decode cache; ``abstract`` puts it on the ``meta`` device.
    ``device=None`` is the card."""
    dev = torch.device("meta") if abstract else resolve_device(device)
    shapes, _ = cache_struct(cfg, pcfg, batch, max_seq)
    return [tuple(_map2(c, lambda sd: torch.zeros(sd[0], dtype=sd[1],
                                                  device=dev))
                  for c in stage)
            for stage in shapes]


def cache_axes(cfg: ModelConfig, pcfg: ParallelConfig):
    _, axes = cache_struct(cfg, pcfg, 1, 1)
    return axes


# ---------------------------------------------------------------------------
# Decode step (serve)
# ---------------------------------------------------------------------------

def _device_pos(pos, device) -> torch.Tensor:
    """``pos`` as an int32 tensor on ``device``.  A Python int is made there
    by ``torch.full``: a host-to-device copy would wait for every queued
    kernel, once a layer."""
    if isinstance(pos, torch.Tensor):
        return pos.to(device=device, dtype=torch.int32)
    return torch.full((), pos, dtype=torch.int32, device=device)


def decode_step(params: dict, cfg: ModelConfig, pcfg: ParallelConfig,
                tokens: torch.Tensor, cache, pos):
    """One serve step. tokens: (B, 1) int; pos: the cache length, an int or
    a 0-d tensor, or a per-batch (B,) tensor.

    Returns (logits (B, 1, V) f32, cache) -- the cache updated in place."""
    x = embedding.embed(params["embed"], tokens, iru=False)
    pos = _device_pos(pos, x.device)
    new_caches = []
    for si, (rep, specs) in enumerate(stage_plan(cfg)):
        x, nc, _, _ = _run_stage(params["dec"][f"stage{si}"], x, specs, cfg,
                                 pcfg, caches=cache[si], pos=pos)
        new_caches.append(nc)
    x = rms_norm(x, params["norm"], cfg.norm_eps)
    lg = embedding.logits(params["embed"], x, params.get("head"))
    return lg, new_caches


def prefill(params: dict, cfg: ModelConfig, pcfg: ParallelConfig,
            batch: dict, cache):
    """Process a full prompt, filling the cache from position 0. Returns
    (last-token logits (B, 1, V) f32, cache)."""
    x = _embed_inputs(params, cfg, batch)
    enc_out = None
    if cfg.encoder_layers:
        enc_out = encode(params, cfg, pcfg, batch["frames"])
    pos = _device_pos(0, x.device)
    new_caches = []
    for si, (rep, specs) in enumerate(stage_plan(cfg)):
        x, nc, _, _ = _run_stage(params["dec"][f"stage{si}"], x, specs, cfg,
                                 pcfg, caches=cache[si], pos=pos,
                                 enc_out=enc_out)
        new_caches.append(nc)
    x = rms_norm(x[:, -1:], params["norm"], cfg.norm_eps)
    lg = embedding.logits(params["embed"], x, params.get("head"))
    return lg, new_caches
