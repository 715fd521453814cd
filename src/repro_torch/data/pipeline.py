"""Deterministic, stateless-resumable data pipeline (counterpart of
``repro.data.pipeline``).

``make_batch(cfg, shape, step)`` is a pure function of (config, step): a
restart at step k replays the identical stream with no loader state in the
checkpoint.  Batches are synthetic token streams with a Zipfian unigram
distribution (duplicate-heavy index streams, which is what the IRU
embedding's gather sees).  The draws are the reference's, made with numpy
in the same order, then moved to the device: tokens and labels equal the
reference's bit for bit, and the float fields round to bf16 to nearest
even, as ``jnp.asarray(..., bfloat16)`` does.

``batch_specs`` returns ``meta`` tensors and logical axes, as
``models.transformer.abstract_params`` does for the params.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    zipf_a: float = 1.2          # unigram skew; a -> 1 = heavier duplicates


N_PATCHES = 576  # keep in sync with models.transformer.N_PATCHES


def _zipf_tokens(rng: np.random.Generator, vocab: int, shape,
                 a: float) -> np.ndarray:
    z = rng.zipf(a, size=shape).astype(np.int64)
    return ((z - 1) % vocab).astype(np.int32)


def batch_fields(cfg: ModelConfig, shape: ShapeConfig
                 ) -> dict[str, tuple[tuple[int, ...], torch.dtype, tuple]]:
    """name -> (shape, dtype, logical_axes) for a training batch."""
    B, S = shape.global_batch, shape.seq_len
    fields: dict = {}
    if cfg.family == "vlm":
        n_p = min(N_PATCHES, S // 2)  # reduced smoke shapes keep text room
        fields["patches"] = ((B, n_p, cfg.d_model), cfg.dtype,
                             ("batch", "seq", "embed"))
        fields["tokens"] = ((B, S - n_p), torch.int32, ("batch", "seq"))
        fields["labels"] = ((B, S), torch.int32, ("batch", "seq"))
    elif cfg.frontend == "embeds" and not cfg.encoder_layers:
        fields["embeds"] = ((B, S, cfg.d_model), cfg.dtype,
                            ("batch", "seq", "embed"))
        fields["labels"] = ((B, S), torch.int32, ("batch", "seq"))
    else:
        fields["tokens"] = ((B, S), torch.int32, ("batch", "seq"))
        fields["labels"] = ((B, S), torch.int32, ("batch", "seq"))
    if cfg.encoder_layers:
        fields["frames"] = ((B, cfg.encoder_frames, cfg.d_model), cfg.dtype,
                            ("batch", "frames", "embed"))
    return fields


def batch_specs(cfg: ModelConfig, shape: ShapeConfig):
    """(``meta`` tensor tree, logical-axes tree)."""
    fields = batch_fields(cfg, shape)
    structs = {k: torch.empty(s, dtype=d, device="meta")
               for k, (s, d, _) in fields.items()}
    return structs, {k: a for k, (_, _, a) in fields.items()}


def make_batch(cfg: ModelConfig, shape: ShapeConfig, step: int,
               data: DataConfig = DataConfig(),
               device: str | torch.device | None = None) -> dict:
    """Pure (config, step) -> batch on ``device`` (``None``: the card)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(np.random.SeedSequence([data.seed, step]))
    out = {}
    for k, (shp, dt, _) in batch_fields(cfg, shape).items():
        if k in ("tokens", "labels"):
            a = _zipf_tokens(rng, cfg.vocab_size, shp, data.zipf_a)
        else:
            a = rng.standard_normal(shp, np.float32) * 0.02
        out[k] = torch.from_numpy(a).to(dev).to(dt)
    # make labels the shifted tokens where both exist (teacher forcing)
    if ("tokens" in out and "labels" in out
            and out["tokens"].shape == out["labels"].shape):
        out["labels"] = torch.cat([out["tokens"][:, 1:],
                                   out["tokens"][:, :1]], dim=1)
    return out


def synthetic_stream(cfg: ModelConfig, shape: ShapeConfig,
                     start_step: int = 0, data: DataConfig = DataConfig(),
                     device: str | torch.device | None = None):
    """Infinite batch iterator starting at ``start_step`` (resume point);
    the device is resolved here, not at the first batch."""
    dev = resolve_device(device)

    def stream():
        step = start_step
        while True:
            yield step, make_batch(cfg, shape, step, data, dev)
            step += 1

    return stream()
