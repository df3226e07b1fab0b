"""The six attention configurations ``chip_smoke.py`` phase 4e serves at
full width on the card (olmo-1b, minitron-8b, qwen2.5-14b,
musicgen-medium, llava-next-mistral-7b, grok-1), held to the JAX
package on the CPU at a "mini" of each full config: what the card's
path depends on is kept (head dim, GQA group, ``mlp_type``, ``norm``,
``tie_embeddings``, ``qkv_bias``, ``rope_theta``, the MoE's experts and
top-k, and frontend embeds, their count scaled from a 2,048-token
prompt to this file's), the rest cut (2 layers, 2 KV heads, d_model 128
with d_ff in the full config's ratio, vocab 512, attention chunks of
32 / 64 so that prefills with embeds cross chunk boundaries).  The same
parameters (JAX ``init_params(PRNGKey(0))`` carried across with
``params_from_jax``) and the same NumPy inputs go through both.

Tolerances are ``tests/test_torch_lm.py``'s: f32 throughout, so the two
differ only in the order of sums; logits and caches are held to a
relative max error of 1e-5 (max |a - b| over max |a|).  Greedy tokens
must be equal."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import configs as R_C  # noqa: E402
from repro.models import steps as R_S  # noqa: E402
from repro.models import transformer as R_T  # noqa: E402
from repro_torch import configs as T_C  # noqa: E402
from repro_torch.models import steps as T_S  # noqa: E402
from repro_torch.models import transformer as T_T  # noqa: E402

ARCHS = ("olmo_1b", "minitron_8b", "qwen2_5_14b", "musicgen_medium",
         "llava_next_mistral_7b", "grok_1_314b")
REL = 1e-5
D_MODEL, KV_HEADS, VOCAB = 128, 2, 512
PROMPT, FULL_PROMPT = 64, 2048
GEN = 6


def mini(full):
    """The mini of a full config (either package's ModelConfig)."""
    group = full.n_heads // full.n_kv_heads
    nf = full.n_frontend_embeds
    changes = dict(
        name=f"{full.name}-mini", n_layers=2, d_model=D_MODEL,
        n_heads=group * KV_HEADS, n_kv_heads=KV_HEADS, head_dim=full.hd,
        d_ff=full.d_ff * D_MODEL // full.d_model, vocab=VOCAB,
        n_frontend_embeds=-(-nf * PROMPT // FULL_PROMPT), dtype="float32",
        attn_q_chunk=32, attn_kv_chunk=64)
    if full.moe:
        changes["moe"] = dataclasses.replace(
            full.moe, d_expert=full.moe.d_expert * D_MODEL // full.d_model)
    return dataclasses.replace(full, **changes)


_PAIRS: dict = {}


def _pair(arch):
    """(cfg_r, cfg_t, params_r, params_t), cached per arch."""
    if arch not in _PAIRS:
        cfg_r, cfg_t = mini(R_C.get(arch)), mini(T_C.get(arch))
        p_r = R_T.init_params(cfg_r, jax.random.PRNGKey(0))
        p_t = T_T.params_from_jax(cfg_t, jax.tree.map(np.asarray, p_r),
                                  device="cpu")
        _PAIRS[arch] = (cfg_r, cfg_t, p_r, p_t)
    return _PAIRS[arch]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-12))


def _inputs(cfg, b, seed):
    """(tokens (b, PROMPT) int32, frontend embeds (b, nf, d) or None)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, PROMPT), dtype=np.int32)
    nf = cfg.n_frontend_embeds
    fe = rng.standard_normal((b, nf, cfg.d_model)).astype(np.float32) \
        if nf else None
    return toks, fe


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.from_numpy(x)


def test_minis_keep_what_the_card_path_depends_on():
    for arch in ARCHS:
        full, m = T_C.get(arch), mini(T_C.get(arch))
        assert dataclasses.asdict(m) == dataclasses.asdict(mini(R_C.get(arch)))
        assert m.hd == full.hd and m.n_kv_heads == KV_HEADS
        assert m.n_heads // m.n_kv_heads == full.n_heads // full.n_kv_heads
        for key in ("mlp_type", "norm", "tie_embeddings", "qkv_bias",
                    "rope_theta", "family"):
            assert getattr(m, key) == getattr(full, key), (arch, key)
        assert bool(m.n_frontend_embeds) == bool(full.n_frontend_embeds)
        if full.moe:
            assert (m.moe.n_experts, m.moe.top_k) == (full.moe.n_experts,
                                                      full.moe.top_k)
    groups = {a: T_C.get(a).n_heads // T_C.get(a).n_kv_heads for a in ARCHS}
    assert groups == {"olmo_1b": 1, "minitron_8b": 4, "qwen2_5_14b": 5,
                      "musicgen_medium": 1, "llava_next_mistral_7b": 4,
                      "grok_1_314b": 6}
    assert {a: mini(T_C.get(a)).n_frontend_embeds for a in ARCHS
            if T_C.get(a).n_frontend_embeds} == {
        "musicgen_medium": 2, "llava_next_mistral_7b": 18}


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_prefill_match_jax(arch):
    """Logits at every position (frontend embeds first where the arch
    has them), the prefill step's last logits and KV cache."""
    cfg_r, cfg_t, p_r, p_t = _pair(arch)
    toks, fe = _inputs(cfg_r, 2, 1)
    fwd = jax.jit(lambda p, t, f: R_T.forward(cfg_r, p, t,
                                              frontend_embeds=f))
    lg_r, _, aux_r = fwd(p_r, jnp.asarray(toks), _j(fe))
    lg_t, _, aux_t = T_T.forward(cfg_t, p_t, torch.from_numpy(toks),
                                 frontend_embeds=_t(fe))
    assert tuple(lg_t.shape) == lg_r.shape == (
        2, cfg_r.n_frontend_embeds + PROMPT, VOCAB)
    assert _rel(lg_r, lg_t.numpy()) < REL
    assert abs(float(aux_r) - float(aux_t)) <= REL * abs(float(aux_r))
    last_r, c_r = jax.jit(R_S.make_prefill_step(cfg_r))(
        p_r, jnp.asarray(toks), _j(fe))
    last_t, c_t = T_S.make_prefill_step(cfg_t)(p_t, torch.from_numpy(toks),
                                               _t(fe))
    assert _rel(last_r, last_t.numpy()) < REL
    assert c_t["len"] == int(c_r["len"]) == cfg_r.n_frontend_embeds + PROMPT
    for key in ("k", "v"):
        assert tuple(c_t[key].shape) == c_r[key].shape
        assert _rel(c_r[key], c_t[key].numpy()) < REL


def _jax_greedy(cfg, params, toks, fe, max_len):
    """The reference's greedy loop (``repro.models.steps.greedy_decode``)
    with its steps jitted and the frontend embeds prefilled ahead of the
    prompt, which its own loop does not take."""
    prefill = jax.jit(R_S.make_prefill_step(cfg))
    serve = jax.jit(R_S.make_serve_step(cfg))
    logits, cache = prefill(params, jnp.asarray(toks), _j(fe))
    full = R_T.init_cache(cfg, toks.shape[0], max_len)
    for k in ("k", "v"):
        full[k] = jax.lax.dynamic_update_slice(
            full[k], cache[k].astype(full[k].dtype), (0, 0, 0, 0, 0))
    full["len"] = cache["len"]
    out = [jnp.argmax(logits, -1)[:, None]]
    for _ in range(GEN - 1):
        logits, full = serve(params, full, out[-1])
        out.append(jnp.argmax(logits, -1)[:, None])
    return np.asarray(jnp.concatenate(out, axis=1))


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_decode_tokens_equal_jax(arch):
    cfg_r, cfg_t, p_r, p_t = _pair(arch)
    toks, fe = _inputs(cfg_r, 2, 3)
    max_len = cfg_r.n_frontend_embeds + PROMPT + GEN
    want = _jax_greedy(cfg_r, p_r, toks, fe, max_len)
    got = T_S.greedy_decode(cfg_t, p_t, toks, n_steps=GEN, max_len=max_len,
                            device="cpu", frontend_embeds=_t(fe))
    assert got.shape == (2, GEN) and got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_step_after_a_prefill_matches_jax(arch):
    """Two decode steps against the cache of a prefill (embeds and
    tokens): the decode positions count the embeds in both."""
    cfg_r, cfg_t, p_r, p_t = _pair(arch)
    toks, fe = _inputs(cfg_r, 2, 4)
    nxt = np.random.default_rng(5).integers(0, VOCAB, (2, 2), dtype=np.int32)
    S = cfg_r.n_frontend_embeds + PROMPT
    _, c_r = jax.jit(R_S.make_prefill_step(cfg_r))(p_r, jnp.asarray(toks),
                                                   _j(fe))
    _, c_t = T_S.make_prefill_step(cfg_t)(p_t, torch.from_numpy(toks),
                                          _t(fe))
    full_r = R_T.init_cache(cfg_r, 2, S + 4)
    for k in ("k", "v"):
        full_r[k] = full_r[k].at[:, :, :S].set(c_r[k])
    full_r["len"] = jnp.asarray(S, jnp.int32)
    full_t = T_S.decode_cache(cfg_t, c_t, S + 4, device="cpu")
    serve_r = jax.jit(R_S.make_serve_step(cfg_r))
    serve_t = T_S.make_serve_step(cfg_t)
    for i in range(2):
        lg_r, full_r = serve_r(p_r, full_r, jnp.asarray(nxt[:, i:i + 1]))
        lg_t, full_t = serve_t(p_t, full_t, torch.from_numpy(nxt[:, i:i + 1]))
        assert _rel(lg_r, lg_t.numpy()) < REL
    assert full_t["len"] == int(full_r["len"]) == S + 2
    for k in ("k", "v"):
        assert _rel(full_r[k], full_t[k].numpy()) < REL
