"""Mamba2 SSD (state-space duality) block — chunked parallel form for
prefill, O(1) recurrent form for decode: the counterpart of
``repro.models.mamba2``.

Chunked SSD (Dao & Gu 2024, §6): split the sequence into chunks of Q
tokens; within a chunk the output is an attention-like quadratic term
(intra), across chunks a (P,N)-state recurrence (inter), here a Python
loop over the chunks in place of ``lax.scan``.  All of it in f32.

Shapes: x (B,S,H,P) head inputs, dt (B,S,H) softplus'd step sizes,
A (H,) negative decay rates, Bm/Cm (B,S,G,N) input/output projections
(G groups broadcast over H heads), state (B,H,P,N).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.modules import rms_norm
from repro_torch.parallel.constrain import (
    constrain,
    constrain_ssd,
    gather_data_axes,
    split_dim,
)


def _repeat_groups(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(..., G, N) -> (..., heads, N), group g repeated over its
    heads // G consecutive heads (``jnp.repeat`` on the group axis).
    Written as a broadcast, not ``repeat_interleave``: its backward on
    the card adds through atomics in no fixed order, a broadcast's
    backward is a sum, so a train step on the card gives the same bits
    run after run."""
    *lead, G, N = t.shape
    return t[..., None, :].expand(*lead, G, heads // G, N).reshape(
        *lead, heads, N)


def _intra_decay(diff: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """exp(diff) on and below the diagonal, 0 above it.  The mask is
    applied before ``exp``: above the diagonal ``diff`` is positive and
    reaches dt * |A| * Q, past f32's ``exp`` range at the full configs'
    chunk of 128, and the reference's ``where(mask, exp(diff), 0)``
    then differentiates to 0 * inf = NaN.  exp(-inf) is the 0 the
    reference selects, so the forward is the same bit for bit."""
    return torch.exp(torch.where(mask, diff, float("-inf")))


def ssd_chunked(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    *,
    chunk: int,
    h0: torch.Tensor | None = None,
):
    """Returns (y (B,S,H,P), final_state (B,H,P,N))."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = min(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S
    if pad:   # zeros after the sequence along S
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))

    xc = x.reshape(Bsz, nc, Q, H, P).float()
    dtc = dt.reshape(Bsz, nc, Q, H).float()
    Bc = _repeat_groups(Bm.reshape(Bsz, nc, Q, G, N).float(), H)
    Cc = _repeat_groups(Cm.reshape(Bsz, nc, Q, G, N).float(), H)

    dA = dtc * A.float()                         # (B,nc,Q,H), negative
    cum = torch.cumsum(dA, dim=2)                # inclusive cumsum

    # --- intra-chunk (quadratic within Q) ---
    CB = torch.einsum("bcqhn,bckhn->bchqk", Cc, Bc)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B,nc,Q,K,H)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    M = _intra_decay(diff, mask[None, None, :, :, None]).permute(
        0, 1, 4, 2, 3)                           # (B,nc,H,Q,K)
    scores = CB * M * dtc.permute(0, 1, 3, 2)[:, :, :, None, :]
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", scores, xc)

    # --- chunk-end states ---
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)     # (B,nc,Q,H)
    S_chunk = torch.einsum(
        "bcqhn,bcqh,bcqhp->bchpn", Bc, decay_to_end * dtc, xc
    )                                            # (B,nc,H,P,N)
    chunk_decay = torch.exp(cum[:, :, -1, :])    # (B,nc,H)

    # --- inter-chunk recurrence over nc, the state emitted BEFORE each
    # chunk ---
    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    states_before = []
    for c in range(nc):
        states_before.append(h)
        h = chunk_decay[:, c, :, None, None] * h + S_chunk[:, c]
    states_before = torch.stack(states_before, dim=1)   # (B,nc,H,P,N)

    y_inter = torch.einsum(
        "bcqhn,bchpn->bcqhp", Cc * torch.exp(cum)[..., None], states_before
    )

    y = (y_intra + y_inter).reshape(Bsz, nc * Q, H, P)[:, :S]
    return y.to(x.dtype), h


def ssd_decode_step(
    x: torch.Tensor,        # (B,H,P) single token
    dt: torch.Tensor,       # (B,H)
    A: torch.Tensor,        # (H,)
    Bm: torch.Tensor,       # (B,G,N)
    Cm: torch.Tensor,       # (B,G,N)
    h: torch.Tensor,        # (B,H,P,N)
):
    """O(1) recurrent update. Returns (y (B,H,P), new_h)."""
    G = Bm.shape[1]
    H = x.shape[1]
    rep = H // G
    Bh = Bm.float().repeat_interleave(rep, dim=1)   # (B,H,N)
    Ch = Cm.float().repeat_interleave(rep, dim=1)
    dA = torch.exp(dt.float() * A.float())          # (B,H)
    upd = torch.einsum("bh,bhp,bhn->bhpn", dt.float(), x.float(), Bh)
    h_new = dA[..., None, None] * h.float() + upd
    y = torch.einsum("bhpn,bhn->bhp", h_new, Ch)
    return y.to(x.dtype), h_new


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """Depthwise causal conv via shift-add (kernel K small).
    x (B,S,C); w (K,C); b (C,)."""
    K = w.shape[0]
    S = x.shape[1]
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(K):
        shift = K - 1 - i
        xi = F.pad(x, (0, 0, shift, 0))[:, :S]
        y = y + xi.float() * w[i].float()
    return (y + b.float()).to(x.dtype)


def conv_decode_step(x: torch.Tensor, conv_buf: torch.Tensor, w, b):
    """x (B,C) new input; conv_buf (B,K,C) ring of the last K inputs
    (oldest first). Returns (y (B,C), new_buf)."""
    new_buf = torch.cat([conv_buf[:, 1:], x[:, None, :]], dim=1)
    y = torch.einsum("bkc,kc->bc", new_buf.float(), w.float()) + b.float()
    return y.to(x.dtype), new_buf


def mamba_block(
    cfg: ModelConfig,
    x: torch.Tensor,       # (B,S,d)
    p: dict,
    *,
    cache: dict | None = None,
):
    """Full Mamba2 block. With cache (decode): S must be 1; returns
    (out, new_cache). Without: returns (out, final_cache_state) where
    the final state seeds a decode cache (prefill handoff).  Projections
    are separate tensors (z / x / BC / dt), as the JAX package keeps
    them."""
    s = cfg.ssm
    B, S, d = x.shape
    din = cfg.d_inner
    H = cfg.ssm_heads
    P = s.head_dim
    G, N = s.n_groups, s.d_state
    gn = G * N

    # under ZeRO-3 the in-projections are gathered over the data axes
    # first, so the heads stay split over 'model' only
    z = x @ gather_data_axes(p["in_z"])          # (B,S,din)
    xi_raw = x @ gather_data_axes(p["in_x"])     # (B,S,din)
    bc_raw = x @ gather_data_axes(p["in_bc"])    # (B,S,2gn)
    dt = x @ gather_data_axes(p["in_dt"])        # (B,S,H)
    A = -torch.exp(p["A_log"].float())

    if cache is None:
        xi = F.silu(causal_conv1d(xi_raw, p["conv_x_w"], p["conv_x_b"]))
        bc = F.silu(causal_conv1d(bc_raw, p["conv_bc_w"], p["conv_bc_b"]))
        Bm, Cm = bc[..., :gn], bc[..., gn:]
        dt_sp = F.softplus(dt.float() + p["dt_bias"].float())
        xh = split_dim(xi, 2, H, P)
        y, h_final = ssd_chunked(
            xh,
            dt_sp,
            A,
            split_dim(Bm, 2, G, N),
            split_dim(Cm, 2, G, N),
            chunk=s.chunk,
        )
        y = y + p["D"].to(y.dtype)[None, None, :, None] * xh
        y = y.reshape(B, S, din)
        y = rms_norm(y * F.silu(z.float()).to(y.dtype), p["gnorm"])
        out = y @ p["out_proj"]
        # conv tails for decode handoff: the K most recent raw inputs,
        # left-padded with zeros when S < K
        K = s.conv_kernel

        def tail(r):
            t = r[:, -K:, :] if S >= K else F.pad(r, (0, 0, K - S, 0))
            return constrain(t, ("pod", "data"), None, "model")

        return out, {
            "conv_x": tail(xi_raw), "conv_bc": tail(bc_raw),
            "ssd": constrain_ssd(h_final),
        }

    # ---- decode: S == 1 ----
    if S != 1:
        raise ValueError(f"mamba_block decodes one token at a time, got "
                         f"S = {S}")
    xi_t, new_conv_x = conv_decode_step(
        xi_raw[:, 0], cache["conv_x"], p["conv_x_w"], p["conv_x_b"])
    bc_t, new_conv_bc = conv_decode_step(
        bc_raw[:, 0], cache["conv_bc"], p["conv_bc_w"], p["conv_bc_b"])
    xi_t = F.silu(xi_t)
    bc_t = F.silu(bc_t)
    Bm, Cm = bc_t[..., :gn], bc_t[..., gn:]
    dt_t = F.softplus(dt[:, 0].float() + p["dt_bias"].float())
    xh = split_dim(xi_t, 1, H, P)
    y, h_new = ssd_decode_step(
        xh, dt_t, A,
        split_dim(Bm, 1, G, N), split_dim(Cm, 1, G, N),
        cache["ssd"],
    )
    y = y + p["D"].to(y.dtype)[None, :, None] * xh
    y = y.reshape(B, 1, din)
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), p["gnorm"])
    out = y @ p["out_proj"]
    return out, {"conv_x": new_conv_x, "conv_bc": new_conv_bc, "ssd": h_new}
