"""AdamW with selectable moment precision (fp32 / bf16 / int8).

Counterpart of ``repro.optim.adamw``.  ``state_dtype="int8"`` stores the
first moment as signed linear int8 and the second as log-domain int8, each
with per-block f32 scales (block = 128 consecutive elements of the
flattened leaf); ``dist.collectives`` reuses the linear quantizer for its
compressed traffic.  ``torch.round`` rounds half to even, as ``jnp.round``
does, so the codes equal the reference's.

The state trees mirror the param tree: ``{"m", "v", "step"}`` with one
moment leaf (a tensor, or an int8 dict ``{"q", "scale"}`` /
``{"q", "lo", "hi"}``) per parameter.

Where the reference's update is one fused XLA loop, eager torch would make
five or six f32 temporaries the size of each leaf (19 GB each for
deepseek-v2-lite's stacked expert weight).  :func:`adamw_update` therefore
walks each leaf in flat chunks of ``_CHUNK`` elements (a multiple of the
int8 block, so the chunks cut no block) and writes params and moments back
in place: the same arithmetic in the same order, element for element, with
temporaries the size of a chunk.  ``lr_scale`` and ``step`` stay device
tensors, so the update reads nothing on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models.measure import tree_leaves, tree_map

_BLOCK = 128
_CHUNK = 1 << 24  # elements a leaf is updated in; a multiple of _BLOCK


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "fp32"   # fp32 | bf16 | int8


# ---------------------------------------------------------------------------
# int8 block quantization
# ---------------------------------------------------------------------------

def _blocked(x: torch.Tensor):
    """Flatten into (blocks, _BLOCK) rows, zero-padding a ragged tail."""
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % _BLOCK
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat.reshape(-1, _BLOCK), pad


def quantize_i8(x: torch.Tensor) -> dict:
    """Signed linear int8 per 128-block (the first moment m):
    q = round(x / (blockmax / 127)).

    -> {"q": int8 (blocks, 128), "scale": f32 (blocks, 1)}; the target
    shape is supplied again at dequantize time."""
    b, _ = _blocked(x)
    scale = b.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.round(b / scale.clamp(min=1e-20)).to(torch.int8)
    return {"q": q, "scale": scale.float()}


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def dequantize_i8(s: dict, shape) -> torch.Tensor:
    flat = (s["q"].float() * s["scale"]).reshape(-1)
    return flat[:_numel(shape)].reshape(shape)


_V_FLOOR = 2.0 ** -60  # well below any useful second moment


def quantize_i8_log(x: torch.Tensor) -> dict:
    """Log-domain int8 per 128-block, for the non-negative second moment v.

    Linear max-scaled int8 loses the lanes far below the block max, and
    1/sqrt(v) + eps then explodes the update; quantizing log2(v) bounds the
    relative error by (hi - lo) ln2 / 255 per block."""
    b, _ = _blocked(x.clamp(min=0.0))
    e = torch.log2(b + _V_FLOOR)
    lo = e.amin(dim=1, keepdim=True)
    hi = e.amax(dim=1, keepdim=True)
    span = (hi - lo).clamp(min=1e-6)
    q = torch.round((e - lo) / span * 255.0 - 128.0).to(torch.int8)
    return {"q": q, "lo": lo.float(), "hi": hi.float()}


def dequantize_i8_log(s: dict, shape) -> torch.Tensor:
    span = (s["hi"] - s["lo"]).clamp(min=1e-6)
    e = s["lo"] + (s["q"].float() + 128.0) / 255.0 * span
    flat = (torch.exp2(e) - _V_FLOOR).reshape(-1)
    return flat[:_numel(shape)].reshape(shape).clamp(min=0.0)


def _encode(x: torch.Tensor, dtype: str, *, nonneg: bool = False):
    if dtype == "fp32":
        return x.float()
    if dtype == "bf16":
        return x.to(torch.bfloat16)
    if dtype == "int8":
        return quantize_i8_log(x) if nonneg else quantize_i8(x)
    raise ValueError(dtype)


def _decode(s: Any, shape) -> torch.Tensor:
    if isinstance(s, dict) and "lo" in s:
        return dequantize_i8_log(s, shape)
    if isinstance(s, dict) and "q" in s:
        return dequantize_i8(s, shape)
    return s.float()


# ---------------------------------------------------------------------------
# init / update
# ---------------------------------------------------------------------------

def adamw_init(params, cfg: AdamWConfig) -> dict:
    """Zero moments on each parameter's device; ``step`` a 0-d int32."""
    def zeros(p, nonneg):
        return _encode(torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device), cfg.state_dtype,
                       nonneg=nonneg)

    return {"m": tree_map(lambda p: zeros(p, False), params),
            "v": tree_map(lambda p: zeros(p, True), params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=tree_leaves(params)[0].device)}


def _sq_sum(x: torch.Tensor) -> torch.Tensor:
    """sum(x.float() ** 2), in chunks (no f32 copy of a whole bf16 leaf)."""
    flat = x.detach().reshape(-1)
    return torch.stack([flat[lo:lo + _CHUNK].float().square().sum()
                        for lo in range(0, max(flat.numel(), 1), _CHUNK)]
                       ).sum()


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(torch.stack([_sq_sum(x) for x in tree_leaves(tree)])
                      .sum())


def _moment_chunk(s, lo: int, hi: int) -> torch.Tensor:
    """Elements [lo, hi) of a flattened moment leaf, decoded to f32."""
    if isinstance(s, dict):
        rows = slice(lo // _BLOCK, -(-hi // _BLOCK))
        return _decode({k: v[rows] for k, v in s.items()}, (hi - lo,))
    return s.view(-1)[lo:hi].float()


def _store_chunk(s, lo: int, hi: int, x: torch.Tensor, dtype: str,
                 nonneg: bool) -> None:
    """Encode f32 ``x`` and write it over elements [lo, hi) of ``s``."""
    if isinstance(s, dict):
        rows = slice(lo // _BLOCK, -(-hi // _BLOCK))
        for k, v in _encode(x, dtype, nonneg=nonneg).items():
            s[k][rows].copy_(v)
    else:
        s.view(-1)[lo:hi].copy_(x)  # copy_ rounds to bf16 as .to() does


def adamw_update(params, grads, state: dict, cfg: AdamWConfig,
                 lr_scale: torch.Tensor | float = 1.0):
    """One AdamW step, in place.  Returns ``(params, state)``: the same
    dicts, with every parameter, moment and ``step`` overwritten."""
    with torch.no_grad():
        step = state["step"].add_(1)
        gn = global_norm(grads)
        clip = torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-12),
                           max=1.0)
        stepf = step.float()
        b1c = 1.0 - cfg.b1 ** stepf
        b2c = 1.0 - cfg.b2 ** stepf
        lr = cfg.lr * lr_scale
        # walk every tree by the params' keys (a moment leaf is a tensor or
        # an int8 dict); dict insertion order may differ between trees
        p_leaves = tree_leaves(params)
        g_leaves = _leaves_upto(grads, params)
        m_leaves = _leaves_upto(state["m"], params)
        v_leaves = _leaves_upto(state["v"], params)
        for p, g, m_s, v_s in zip(p_leaves, g_leaves, m_leaves, v_leaves):
            # view(-1) raises for a non-contiguous leaf: in place needs one
            pf, gf, n = p.view(-1), g.reshape(-1), p.numel()
            for lo in range(0, n, _CHUNK):
                hi = min(lo + _CHUNK, n)
                pc = pf[lo:hi]
                gc = gf[lo:hi].float() * clip
                m = cfg.b1 * _moment_chunk(m_s, lo, hi) + (1 - cfg.b1) * gc
                v = (cfg.b2 * _moment_chunk(v_s, lo, hi)
                     + (1 - cfg.b2) * gc * gc)
                mhat = m / b1c
                vhat = v / b2c
                upd = (mhat / (torch.sqrt(vhat) + cfg.eps)
                       + cfg.weight_decay * pc.float())
                pc.copy_(pc.float() - lr * upd)
                _store_chunk(m_s, lo, hi, m, cfg.state_dtype, False)
                _store_chunk(v_s, lo, hi, v, cfg.state_dtype, True)
    return params, state


def _leaves_upto(tree, like) -> list:
    """The subtrees of ``tree`` at the leaf positions of ``like``."""
    if isinstance(like, dict):
        return [x for k in like for x in _leaves_upto(tree[k], like[k])]
    if isinstance(like, (list, tuple)):
        return [x for a, b in zip(tree, like) for x in _leaves_upto(a, b)]
    return [tree]
