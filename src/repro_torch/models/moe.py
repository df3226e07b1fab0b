"""Mixture-of-Experts layer: shared + routed experts with top-k routing
and grouped capacity-based dispatch — the counterpart of
``repro.models.moe``.

Dispatch is computed independently per token group (group = one batch
row), exactly as the JAX package does it, so the set of dropped choices
is the reference's:

  1. router logits (f32) -> softmax -> top-k (expert_id, gate), the k
     gates renormalised;
  2. a choice's position within its expert is the exclusive cumulative
     one-hot count over the group's ``Tg * k`` choices, token-major;
  3. choices at position >= C go to a trash column C; an accumulating
     ``index_put_`` scatters the tokens into an (E, C + 1, d) buffer
     whose trash column is then cut off;
  4. the expert FFN is three batched products over (G, E, C, d);
  5. each choice's output is gathered back and combined with its gate.

The JAX package ``vmap``s steps 2-3 and 5 over the groups; here the
group axis is written out.  Its sharding constraints on the buffers
(``parallel.constrain``) leave plain tensors as they are.  Shared
experts are fused into one wider gated MLP by the caller
(``transformer.attn_block_apply``).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.parallel.constrain import batch_local, constrain


@contextlib.contextmanager
def _full_f32(x: torch.Tensor):
    """f32 matrix products in full f32 on the card for the block (TF32
    would keep 10 mantissa bits and move the router's top-k), the
    caller's setting restored after."""
    if x.device.type != "cuda":
        yield
        return
    matmul = torch.backends.cuda.matmul
    prev = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32 = prev


def capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    m = cfg.moe
    c = int(tokens_per_group * m.top_k * m.capacity_factor / m.n_experts)
    return max(4, -(-c // 4) * 4)


def route(router_logits: torch.Tensor, top_k: int):
    """(T, E) -> normalized gates (T, k) + expert ids (T, k)."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    gates, ids = torch.topk(probs, top_k, dim=-1)
    gates = gates / gates.sum(dim=-1, keepdim=True)
    return gates, ids


def _dispatch_group(x: torch.Tensor, ids: torch.Tensor, C: int, E: int):
    """x (G, Tg, d); ids (G, Tg, k).  Returns (buf (G, E, C, d), keep
    (G, Tg*k), safe_e, safe_c): the reference's per-group dispatch with
    the group axis written out."""
    G, Tg, d = x.shape
    k = ids.shape[2]
    flat_ids = ids.reshape(G, Tg * k)                 # token-major
    onehot = F.one_hot(flat_ids, E)                   # (G, Tg*k, E)
    pos = torch.gather(onehot.cumsum(dim=1) - onehot, 2,
                       flat_ids[..., None])[..., 0]
    keep = pos < C
    safe_e = torch.where(keep, flat_ids, 0)
    safe_c = torch.where(keep, pos, C)                # C = trash column
    xk = x.repeat_interleave(k, dim=1)                # (G, Tg*k, d)
    g_idx = torch.arange(G, device=x.device)[:, None].expand(G, Tg * k)
    buf = torch.zeros((G, E, C + 1, d), dtype=x.dtype, device=x.device)
    buf.index_put_((g_idx, safe_e, safe_c), xk, accumulate=True)
    return buf[:, :, :C], keep, safe_e, safe_c


def _dense(h: torch.Tensor) -> torch.Tensor:
    """A DTensor made contiguous, a plain tensor as it is.  A
    redistribution leaves a DTensor's local shard dense in its logical
    order while its global strides keep the layout it had before; the
    einsum then takes a view the local shard cannot give.  A clone makes
    the two agree."""
    from torch.distributed.tensor import DTensor

    return h.contiguous() if isinstance(h, DTensor) else h


def _combine_group(y, keep, safe_e, safe_c, gates, C: int):
    """y (G, E, C, d) expert outputs -> (G, Tg, d): each kept choice's
    output gathered back, weighted by its gate and summed over the k."""
    G, Tg, k = gates.shape
    g_idx = torch.arange(G, device=y.device)[:, None]
    yk = y[g_idx, safe_e, torch.clamp(safe_c, max=C - 1)]   # (G,Tg*k,d)
    yk = torch.where(keep[..., None], yk, 0.0)
    yk = yk.reshape(G, Tg, k, y.shape[-1]) * gates[..., None].to(yk.dtype)
    return yk.sum(dim=2)


def moe_ffn(
    x: torch.Tensor,        # (G, Tg, d) grouped tokens (G = batch rows)
    p: dict,                # router (d,E); wg/wu (E,d,Fe); wd (E,Fe,d)
    cfg: ModelConfig,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (out (G, Tg, d), aux load-balance loss)."""
    m = cfg.moe
    G, Tg, d = x.shape
    E, k = m.n_experts, m.top_k
    C = capacity(cfg, Tg)

    with _full_f32(x):
        logits = x.float() @ p["router"].float()
    gates, ids = route(logits.reshape(G * Tg, E), k)
    gates = gates.reshape(G, Tg, k)
    ids = ids.reshape(G, Tg, k)

    buf, keep, safe_e, safe_c = batch_local(
        lambda x, ids: _dispatch_group(x, ids, C, E), x, ids)
    buf = constrain(buf, ("pod", "data"), "model", None, None)

    g = F.silu(torch.einsum("gecd,edf->gecf", buf, p["wg"]))
    u = torch.einsum("gecd,edf->gecf", buf, p["wu"])
    y = torch.einsum("gecf,efd->gecd", _dense(g * u), p["wd"])  # (G,E,C,d)
    y = constrain(y, ("pod", "data"), None, None, None)
    out = batch_local(lambda *a: _combine_group(*a, C), y, keep, safe_e,
                      safe_c, gates)

    # load-balance aux (Switch-style): E * sum_e f_e * P_e
    probs_mean = torch.softmax(logits.reshape(G * Tg, E), dim=-1).mean(0)
    frac = F.one_hot(ids.reshape(G * Tg, k), E).float().sum(1).mean(0) / k
    aux = E * torch.sum(frac * probs_mean)
    return out.to(x.dtype), aux
