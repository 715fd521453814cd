"""Config system (counterpart of ``repro.configs.base``): architecture,
shape and parallelism descriptors, with the reference's fields, defaults
and helpers.

One ``<arch>.py`` per architecture defines ``CONFIG`` (full size); the
registry in ``configs/__init__`` exposes ``get_config(name)`` and
``smoke_config(name)`` (a structurally identical reduced model for CPU
tests).  ``ModelConfig.dtype`` is a torch dtype (``torch.bfloat16`` by
default) where the reference's is a jnp one.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden dim
    n_shared_experts: int = 0
    layer_period: int = 1          # MoE every k-th layer
    layer_offset: int = 0
    first_dense_layers: int = 0    # leading layers keep dense FFN (deepseek)
    capacity_factor: float = 1.25
    dispatch: str = "iru_sorted"   # "iru_sorted" | "iru_hash" | "dense" (baseline)


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256
    # SSD einsum precision: "f32" (reference) or "bf16" (halves the 5-D
    # intra-chunk/state tensors; exp/cumsum stay f32)
    ssd_dtype: str = "f32"

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    ffn_type: str = "swiglu"       # swiglu | gelu
    qk_norm: bool = False
    attn_window: Optional[int] = None  # sliding-window attention (starcoder2: 4096)
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    attention: str = "gqa"         # gqa | mla | none
    # MLA (deepseek)
    kv_lora_rank: int = 0
    qk_rope_dim: int = 64
    # layer pattern, cycled: e.g. jamba = 1 attn : 7 mamba
    layer_pattern: tuple[str, ...] = ("attn",)
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    # enc-dec (whisper): encoder_layers > 0 enables cross-attention decoder
    encoder_layers: int = 0
    encoder_frames: int = 1500     # stub frontend sequence length
    # frontend stub: "none" -> token ids in; "embeds" -> precomputed embeddings
    frontend: str = "none"
    # IRU integration
    iru_embedding: bool = True
    dtype: torch.dtype = torch.bfloat16
    notes: str = ""

    # ------------------------------------------------------------------
    def layer_kinds(self) -> list[str]:
        """Mixer kind per decoder layer."""
        pat = self.layer_pattern
        return [pat[i % len(pat)] for i in range(self.n_layers)]

    def is_moe_layer(self, i: int) -> bool:
        m = self.moe
        if m is None:
            return False
        if i < m.first_dense_layers:
            return False
        return (i % m.layer_period) == m.layer_offset

    def unit_len(self) -> int:
        """Length of the homogeneous repeating unit (for the layer loop)."""
        base = len(self.layer_pattern)
        if self.moe is not None:
            base = math.lcm(base, self.moe.layer_period)
        # leading dense layers (deepseek) break homogeneity -> unit 1
        if self.moe is not None and self.moe.first_dense_layers:
            return 1
        return base

    def params_billions(self) -> float:
        """Analytic parameter count (embedding + blocks), in billions."""
        total = self.vocab_size * self.d_model * (1 if self.tie_embeddings else 2)
        for i, kind in enumerate(self.layer_kinds()):
            if kind == "attn":
                total += self._attn_params()
            elif kind == "mamba":
                total += self._mamba_params()
            total += self._ffn_params(i)
            total += 2 * self.d_model  # norms
        if self.encoder_layers:
            total += self.encoder_layers * (
                self._attn_params() + self._ffn_params(-1) + 2 * self.d_model
            )
            total += self.n_layers * self._attn_params()  # cross-attention
        return total / 1e9

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.head_dim
        if self.attention == "mla":
            r = self.kv_lora_rank
            return d * (r + self.qk_rope_dim) + r * self.n_heads * 2 * hd + d * self.n_heads * hd * 2
        q = d * self.n_heads * hd
        kv = d * self.n_kv_heads * hd * 2
        o = self.n_heads * hd * d
        return q + kv + o

    def _ffn_params(self, layer: int) -> int:
        mats = 3 if self.ffn_type == "swiglu" else 2
        if layer >= 0 and self.is_moe_layer(layer):
            m = self.moe
            per = mats * self.d_model * m.d_ff
            return (m.n_experts + m.n_shared_experts) * per + self.d_model * m.n_experts
        return mats * self.d_model * self.d_ff

    def _mamba_params(self) -> int:
        mc = self.mamba
        d_in = mc.d_inner(self.d_model)
        nh = mc.n_heads(self.d_model)
        # in_proj -> [z, x, B, C, dt], conv over (x,B,C), out_proj
        conv_dim = d_in + 2 * mc.d_state
        in_proj = self.d_model * (2 * d_in + 2 * mc.d_state + nh)
        return in_proj + conv_dim * mc.d_conv + nh * 2 + d_in * self.d_model


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


LM_SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

# long_500k needs sub-quadratic sequence mixing: only ssm/hybrid run it.
SUBQUADRATIC_FAMILIES = {"ssm", "hybrid"}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    if (
        shape.name == "long_500k"
        and cfg.family not in SUBQUADRATIC_FAMILIES
        and cfg.attn_window is None
    ):
        return False, "pure full-attention arch: 512k decode skipped per spec (DESIGN.md §5)"
    return True, ""


def pad_to_multiple(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Static parallelism knobs (the reference resolves them against a
    mesh; one process here has none, so ``model_axis`` only pads)."""

    model_axis: int = 1            # TP degree (size of mesh "model" axis)
    pad_vocab_multiple: int = 256
    remat: str = "full"            # full | none
    microbatches: int = 1          # grad-accumulation steps
    sequence_parallel: bool = False
    attn_chunk: int = 1024         # flash-style KV chunk
    opt_state_dtype: str = "fp32"  # fp32 | bf16 | int8
    # FSDP: additionally shard parameters over the data axes
    fsdp_params: bool = False

    def padded_heads(self, n_heads: int) -> int:
        return pad_to_multiple(n_heads, self.model_axis)

    def padded_vocab(self, vocab: int) -> int:
        m = self.pad_vocab_multiple
        if self.model_axis > 1:
            m = math.lcm(m, self.model_axis)
        return pad_to_multiple(vocab, m)
