"""Mamba-2 block (state-space duality, arXiv:2405.21060), chunked SSD scan
(counterpart of ``repro.models.mamba2``).

Attention-free sequence mixer used by mamba2-130m and the Jamba hybrid.
The SSD scan is a *regular* computation -- dense, sequential accesses, no
index stream to reorder -- and the reference computes it in jnp, so the
port computes it in plain torch.

Train/prefill: the chunked SSD algorithm -- O(S*L) within-chunk quadratic
work plus an O(S/L) inter-chunk state recurrence (a loop carrying the
(heads, head_dim, state) tensor).  Decode: single-step SSM state update.

Layout: single B/C group (n_groups=1, as in the released 130m config).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MambaConfig
from repro_torch.device import resolve_device
from repro_torch.models.common import Initializer, constrain, rms_norm
from repro_torch.models.measure import mscan


def init_mamba(it: Initializer, d_model: int, mc: MambaConfig) -> None:
    d_in = mc.d_inner(d_model)
    nh = mc.n_heads(d_model)
    conv_dim = d_in + 2 * mc.d_state
    it.weight("wz", (d_model, d_in), ("embed", "ffn"))
    it.weight("wx", (d_model, d_in), ("embed", "ffn"))
    it.weight("wbc", (d_model, 2 * mc.d_state), ("embed", None))
    it.weight("wdt", (d_model, nh), ("embed", "ssm_heads"))
    it.weight("conv_w", (mc.d_conv, conv_dim), (None, "ffn"))
    it.weight("conv_b", (conv_dim,), ("ffn",), init="zeros")
    it.weight("a_log", (nh,), ("ssm_heads",), init="ones")
    it.weight("d_skip", (nh,), ("ssm_heads",), init="ones")
    it.weight("dt_bias", (nh,), ("ssm_heads",), init="zeros")
    it.weight("out_norm", (d_in,), ("ffn",), init="ones")
    it.weight("wout", (d_in, d_model), ("ffn", "embed"))


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None):
    """Depthwise causal conv, width K.  xbc: (B, S, C); state: (B, K-1, C)."""
    K = w.shape[0]
    if state is None:
        pad = xbc.new_zeros((xbc.shape[0], K - 1, xbc.shape[2]))
    else:
        pad = state.to(xbc.dtype)
    full = torch.cat([pad, xbc], dim=1)
    out = sum(full[:, i: i + xbc.shape[1]] * w[i] for i in range(K))
    new_state = full[:, -(K - 1):] if K > 1 else pad
    return F.silu(out + b), new_state


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """Lower-triangular pairwise cumulative sums:
    out[..., i, j] = sum_{j<k<=i} x[k]; -inf above the diagonal (its
    ``exp`` is 0)."""
    L = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    return torch.where(mask, out, float("-inf"))


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             bmat: torch.Tensor, cmat: torch.Tensor, chunk: int,
             h0: torch.Tensor | None = None, ssd_dtype: str = "f32"):
    """Chunked SSD. x: (B,S,nh,hd), dt: (B,S,nh) (post-softplus), a: (nh,)
    bmat/cmat: (B,S,N).  Returns (y (B,S,nh,hd) f32, h_final (B,nh,hd,N))."""
    B, S0, nh, hd = x.shape
    N = bmat.shape[-1]
    L = min(chunk, S0)
    pad = (-S0) % L
    if pad:
        # zero-pad tail: dt=0 -> decay exp(0)=1 and update dt*B*x = 0, so the
        # final state is untouched; padded outputs are sliced off below.
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, pad))
    S = S0 + pad
    nc = S // L
    dA = (dt * (-torch.exp(a.float()))).float()                # (B,S,nh)

    xc = x.reshape(B, nc, L, nh, hd)
    dtc = dt.reshape(B, nc, L, nh)
    dAc = dA.reshape(B, nc, L, nh).permute(0, 1, 3, 2)         # (B,nc,nh,L)
    bc = bmat.reshape(B, nc, L, N)
    cc = cmat.reshape(B, nc, L, N)

    # --- intra-chunk (quadratic within L) -------------------------------
    # ed: einsum dtype.  The decay factors (exp/cumsum) stay f32; the large
    # 5-D attention/state tensors may run bf16 (MambaConfig.ssd_dtype).
    ed = torch.float32 if ssd_dtype == "f32" else torch.bfloat16
    Lmat = torch.exp(_segsum(dAc)).to(ed)                      # (B,nc,nh,L,L)
    att = torch.einsum("bcln,bcsn->bcls", cc.to(ed), bc.to(ed))[:, :, None] * Lmat
    att = att * dtc.permute(0, 1, 3, 2)[:, :, :, None, :].to(ed)  # weight by dt[j]
    y_diag = torch.einsum("bchls,bcshd->bclhd", att, xc.to(ed)).float()

    # --- chunk states ----------------------------------------------------
    cum = torch.cumsum(dAc, dim=-1)                            # (B,nc,nh,L)
    decay_to_end = torch.exp(cum[..., -1:] - cum)              # (B,nc,nh,L)
    ws = (dtc.permute(0, 1, 3, 2) * decay_to_end).to(ed)       # (B,nc,nh,L)
    states = torch.einsum("bchl,bcln,bclhd->bchdn", ws, bc.to(ed),
                          xc.to(ed)).float()

    # --- inter-chunk recurrence ------------------------------------------
    chunk_decay = torch.exp(dAc.sum(dim=-1))                   # (B,nc,nh)

    def step(h, inp):
        st, dec = inp                                          # (B,nh,hd,N), (B,nh)
        h_new = h * dec[..., None, None] + st
        return h_new, h

    h_init = (x.new_zeros((B, nh, hd, N), dtype=torch.float32) if h0 is None
              else h0.float())
    h_last, h_prev = mscan(
        step,
        h_init,
        (states.permute(1, 0, 2, 3, 4), chunk_decay.permute(1, 0, 2)),
    )
    h_prev = h_prev.permute(1, 0, 2, 3, 4)                     # (B,nc,nh,hd,N)

    # --- contribution of carried-in state --------------------------------
    instate_decay = torch.exp(cum)                             # decay from chunk start
    # the reference promotes cc to f32 here (it meets f32 operands)
    y_off = torch.einsum("bcln,bchdn,bchl->bclhd", cc.float(), h_prev,
                         instate_decay)

    y = (y_diag + y_off).reshape(B, S, nh, hd)
    return y[:, :S0], h_last


def mamba_forward(
    params: dict,
    x: torch.Tensor,                 # (B, S, D)
    mc: MambaConfig,
    d_model: int,
    *,
    state: dict | None = None,       # {"conv": (B,K-1,C), "ssm": (B,nh,hd,N)}
    norm_eps: float = 1e-6,
) -> tuple[torch.Tensor, dict | None]:
    B, S, _ = x.shape
    d_in = mc.d_inner(d_model)
    nh = mc.n_heads(d_model)
    z = x @ params["wz"]
    xr = x @ params["wx"]
    bcr = x @ params["wbc"]
    dt_raw = x @ params["wdt"]
    xbc = torch.cat([xr, bcr], dim=-1)

    conv_state = None if state is None else state["conv"]
    xbc, new_conv = _causal_conv(xbc, params["conv_w"], params["conv_b"],
                                 conv_state)
    xr, bmat, cmat = torch.split(xbc, [d_in, mc.d_state, mc.d_state], dim=-1)
    xr = constrain(xr, ("batch", "seq", "ffn"))
    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())

    xh = xr.reshape(B, S, nh, mc.head_dim)
    if state is not None and S == 1:
        # ---- decode: one recurrent step ---------------------------------
        a = -torch.exp(params["a_log"].float())
        dA = torch.exp(dt[:, 0] * a)                           # (B,nh)
        h = state["ssm"].float()
        upd = torch.einsum("bh,bn,bhd->bhdn", dt[:, 0], bmat[:, 0].float(),
                           xh[:, 0].float())
        h = h * dA[..., None, None] + upd
        y = torch.einsum("bn,bhdn->bhd", cmat[:, 0].float(), h)
        y = y[:, None]                                         # (B,1,nh,hd)
        new_state = {"conv": new_conv, "ssm": h.to(state["ssm"].dtype)}
    else:
        h0 = None if state is None else state["ssm"]
        y, h_last = ssd_scan(xh, dt, params["a_log"], bmat, cmat, mc.chunk,
                             h0, ssd_dtype=mc.ssd_dtype)
        new_state = None
        if state is not None:
            new_state = {"conv": new_conv,
                         "ssm": h_last.to(state["ssm"].dtype)}
    y = y + params["d_skip"].float()[None, None, :, None] * xh.float()
    y = y.reshape(B, S, d_in).to(x.dtype)
    y = constrain(y, ("batch", "seq", "ffn"))
    z = constrain(z, ("batch", "seq", "ffn"))
    y = rms_norm(y * F.silu(z), params["out_norm"], norm_eps)
    out = y @ params["wout"]
    return constrain(out, ("batch", "seq", "embed")), new_state


def init_mamba_state(cfg_d_model: int, mc: MambaConfig, batch: int, dtype,
                     device=None) -> dict:
    """Zero conv and SSM state; ``device=None`` is the card."""
    device = resolve_device(device)
    d_in = mc.d_inner(cfg_d_model)
    nh = mc.n_heads(cfg_d_model)
    conv_dim = d_in + 2 * mc.d_state
    return {
        "conv": torch.zeros((batch, mc.d_conv - 1, conv_dim), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, nh, mc.head_dim, mc.d_state), dtype=dtype,
                           device=device),
    }
