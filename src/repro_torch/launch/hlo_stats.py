"""Roofline terms of one step (counterpart of ``repro.launch.hlo_stats``).

The module keeps the reference's name so a reader finds its counterpart,
but the port has no HLO: eager torch compiles nothing.  What the reference
reads from ``compiled.cost_analysis()`` the port counts by running the step
under two dispatch modes (:func:`count_step`):

* **FLOPs** from ``torch.utils.flop_counter.FlopCounterMode`` (matrix
  products, batched products and convolutions; elementwise work is not
  counted, as XLA's ``flops`` counts it apart from transcendentals);
* **bytes** from :class:`ByteCounter`, which adds up each non-view aten
  op's tensor inputs and outputs, counting a mutated tensor once read and
  once written; a copy into a tensor (``copy_``, ``fill_``, an ``out=``)
  only writes it, and an indexed write (``index_copy_``, ``index_add_``,
  ``scatter_``) moves the rows its index names, not the whole tensor.
  This is an eager op-by-op count with no fusion: every intermediate goes
  to memory and back, as it does when the step runs eagerly.

Both modes see shapes only, so a step on the ``meta`` device counts what
the same step on the card does.  The reference's ``collective_stats``
parses XLA HLO, which the port never produces, and one process issues no
collective: :class:`Roofline` takes ``wire_bytes=None`` and then has no
collective term.

The constants are an NVIDIA H100 SXM5 80GB's data-sheet peaks (the
reference's are a TPU v5e's).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

# --- NVIDIA H100 SXM5 80GB (per card, data sheet) ---------------------------
PEAK_FLOPS = 989e12          # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12             # HBM3 bytes/s
NVLINK_BW = 450e9            # NVLink 4 bytes/s per direction

# allocation without a write: no bytes move
_NO_DATA = frozenset(("empty", "empty_strided", "empty_like", "new_empty",
                      "new_empty_strided"))
# in-place ops that write their mutated argument without reading it
_WRITE_ONLY = frozenset(("copy_", "fill_", "zero_"))
# indexed in-place writes: (the argument whose element count is the number
# of elements written, whether each is read first to accumulate into it)
_INDEXED = {"index_copy_": ("source", False), "index_add_": ("source", True),
            "scatter_": ("index", False), "scatter_add_": ("index", True),
            "scatter_reduce_": ("index", True)}


def _tensors(v) -> list:
    if isinstance(v, torch.Tensor):
        return [v]
    if isinstance(v, (list, tuple)):
        return [t for t in v if isinstance(t, torch.Tensor)]
    return []


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def op_bytes(func, args, kwargs, out) -> int:
    """Bytes one aten op reads and writes: every tensor argument once and
    every fresh output once.  A mutated argument counts once read and once
    written, except that a copy into it (or an ``out=``) only writes it and
    an indexed write moves only the elements its index names (read too
    where it accumulates).  A view, and an allocation that writes nothing,
    move nothing."""
    schema = func._schema
    rets = schema.returns
    if rets and all(r.alias_info is not None and not r.alias_info.is_write
                    for r in rets):
        return 0  # a view of an input
    name = func._opname
    if name in _NO_DATA:
        return 0
    named = {arg.name: args[i] if i < len(args) else kwargs.get(arg.name)
             for i, arg in enumerate(schema.arguments)}
    total = 0
    for arg in schema.arguments:
        ts = _tensors(named[arg.name])
        if arg.alias_info is None or not arg.alias_info.is_write:
            total += _nbytes(ts)
        elif name in _INDEXED:
            key, accumulates = _INDEXED[name]
            rows = named[key].numel() * ts[0].element_size()
            accumulates = accumulates or named.get("reduce") is not None
            total += 2 * rows if accumulates else rows
        elif name in _WRITE_ONLY or arg.name == "out":
            total += _nbytes(ts)
        else:
            total += 2 * _nbytes(ts)
    outs = out if isinstance(out, tuple) else (out,)
    for r, o in zip(rets, outs):
        if r.alias_info is None:
            total += _nbytes(_tensors(o))
    return total


class ByteCounter(TorchDispatchMode):
    """Adds up :func:`op_bytes` over every aten op run inside it (the
    autograd engine's backward included)."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.total += op_bytes(func, args, kwargs, out)
        return out


def count_step(fn, *args) -> dict:
    """Run ``fn(*args)`` once and return ``{"flops", "bytes_accessed"}``:
    the port's counterpart of ``compiled.cost_analysis()``, for the whole
    step as one process runs it."""
    flops = FlopCounterMode(display=False)
    nbytes = ByteCounter()
    with flops, nbytes:
        fn(*args)
    return {"flops": float(flops.get_total_flops()),
            "bytes_accessed": float(nbytes.total)}


@dataclasses.dataclass
class Roofline:
    """Roofline terms per device, from per-device ``flops`` and
    ``hbm_bytes`` (the dry run splits the counted step evenly over the
    mesh) and, where there are any, per-device collective wire bytes.
    ``wire_bytes=None``: no collective term.  The dict keeps the
    reference's keys."""

    flops: float
    hbm_bytes: float
    wire_bytes: Optional[float]
    n_devices: int

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> Optional[float]:
        return None if self.wire_bytes is None else self.wire_bytes / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        terms = {k: v for k, v in terms.items() if v is not None}
        return max(terms, key=terms.get)

    def as_dict(self) -> dict:
        return {
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "hlo_flops": self.flops,
            "hlo_bytes": self.hbm_bytes,
            "wire_bytes_per_device": self.wire_bytes,
            "n_devices": self.n_devices,
        }


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N_active·D (train) or 2·N_active·D (fwd) per token,
    plus the attention score/value flops against the live KV length (which
    6·N·D famously omits -- dominant for decode against a 32k cache)."""
    n_active = active_params(cfg)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    total = mult * n_active * tokens
    # attention qk^T + av flops per token: 4 * H * hd * kv_len per attn layer
    n_attn = sum(1 for k in cfg.layer_kinds() if k == "attn")
    if n_attn and cfg.n_heads:
        if shape.kind == "decode":
            kv = shape.seq_len
        else:
            kv = shape.seq_len / 2.0          # causal average
        if cfg.attn_window is not None:
            kv = min(kv, cfg.attn_window)
        per_tok = 4.0 * cfg.n_heads * cfg.head_dim * kv * n_attn
        total += (mult / 2.0) * per_tok * tokens
    return total


def active_params(cfg) -> float:
    """Per-token active parameter count (MoE counts top_k + shared only)."""
    total = cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    for i, kind in enumerate(cfg.layer_kinds()):
        if kind == "attn":
            total += cfg._attn_params()
        else:
            total += cfg._mamba_params()
        if cfg.is_moe_layer(i):
            m = cfg.moe
            mats = 3 if cfg.ffn_type == "swiglu" else 2
            per = mats * cfg.d_model * m.d_ff
            total += (m.top_k + m.n_shared_experts) * per + cfg.d_model * m.n_experts
        elif cfg.d_ff:
            mats = 3 if cfg.ffn_type == "swiglu" else 2
            total += mats * cfg.d_model * cfg.d_ff
        total += 2 * cfg.d_model
    if cfg.encoder_layers:
        mats = 3 if cfg.ffn_type == "swiglu" else 2
        total += cfg.encoder_layers * (cfg._attn_params() + mats * cfg.d_model * cfg.d_ff)
        total += cfg.n_layers * cfg._attn_params()
    return float(total)
