"""The port's MoE layer (``repro_torch.models.moe``) and the MoE decoders
(deepseek-moe-16b, grok-1-314b smoke configs) against the JAX package
on the CPU: the same parameters (JAX ``init_params(PRNGKey(0))``
carried across with ``params_from_jax``) and the same NumPy inputs
through both.

Tolerances: f32 throughout, so the two differ only in the order of sums
(XLA's dot vs PyTorch's); outputs, aux losses, logits and caches are held
to a relative max error of 1e-5 (max |a - b| over max |a|).  Expert ids,
keep masks, capacities and greedy tokens must be equal."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import configs as R_C  # noqa: E402
from repro.models import moe as R_MOE  # noqa: E402
from repro.models import steps as R_S  # noqa: E402
from repro.models import transformer as R_T  # noqa: E402
from repro_torch import configs as T_C  # noqa: E402
from repro_torch.models import moe as T_MOE  # noqa: E402
from repro_torch.models import steps as T_S  # noqa: E402
from repro_torch.models import transformer as T_T  # noqa: E402

MOE_ARCHS = ("deepseek_moe_16b", "grok_1_314b")
REL = 1e-5


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-12))


def _with_cf(cfg, cf: float):
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


_PAIRS: dict = {}


def _pair(arch, cf=None):
    """(cfg_r, cfg_t, params_r, params_t) of the smoke config, the JAX
    init carried across (cached per arch: the configs differ only in
    ``capacity_factor``, which no parameter depends on)."""
    if arch not in _PAIRS:
        cfg_r = R_C.get_smoke(arch)
        p_r = R_T.init_params(cfg_r, jax.random.PRNGKey(0))
        p_t = T_T.params_from_jax(T_C.get_smoke(arch),
                                  jax.tree.map(np.asarray, p_r),
                                  device="cpu")
        _PAIRS[arch] = (p_r, p_t)
    cfg_r, cfg_t = R_C.get_smoke(arch), T_C.get_smoke(arch)
    if cf is not None:
        cfg_r, cfg_t = _with_cf(cfg_r, cf), _with_cf(cfg_t, cf)
    return (cfg_r, cfg_t, *_PAIRS[arch])


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s),
                                                dtype=np.int32)


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cf", [0.25, 0.5, 1.0, 1.25, 2.0, 16.0])
def test_capacity_equals_jax(cf):
    for arch in MOE_ARCHS:
        cfg_r = _with_cf(R_C.get(arch), cf)
        cfg_t = _with_cf(T_C.get(arch), cf)
        for tokens in (1, 2, 3, 7, 12, 13, 64, 100, 511, 512, 2048, 8192):
            assert T_MOE.capacity(cfg_t, tokens) == \
                R_MOE.capacity(cfg_r, tokens), (arch, tokens)


@pytest.mark.parametrize("T,E,k", [(37, 8, 2), (64, 64, 6), (5, 8, 8)])
def test_route_gates_and_ids_equal_jax(T, E, k):
    logits = np.random.default_rng(T + E).standard_normal(
        (T, E)).astype(np.float32) * 3
    g_r, i_r = R_MOE.route(jnp.asarray(logits), k)
    g_t, i_t = T_MOE.route(torch.from_numpy(logits), k)
    assert np.array_equal(np.asarray(i_r), i_t.numpy())
    assert _rel(g_r, g_t.numpy()) < REL
    assert torch.allclose(g_t.sum(-1), torch.ones(T), atol=1e-6)


def _layer0_moe(arch, cf):
    cfg_r, cfg_t, p_r, p_t = _pair(arch, cf)
    pr = jax.tree.map(lambda a: a[0], p_r["blocks"]["moe"])
    pt = {k: v[0] for k, v in p_t["blocks"]["moe"].items()}
    return cfg_r, cfg_t, pr, pt


def _drops_r(cfg_r, p, x):
    """The reference's keep mask (G, Tg*k) for x (G, Tg, d)."""
    G, Tg, _ = x.shape
    E, k = cfg_r.moe.n_experts, cfg_r.moe.top_k
    logits = x.astype(jnp.float32) @ p["router"].astype(jnp.float32)
    _, ids = R_MOE.route(logits.reshape(G * Tg, E), k)
    C = R_MOE.capacity(cfg_r, Tg)
    _, keep, se, sc = jax.vmap(
        lambda xg, ig: R_MOE._dispatch_group(xg, ig, C, E)
    )(x, ids.reshape(G, Tg, k))
    return np.asarray(keep), np.asarray(se), np.asarray(sc)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("cf", [0.5, 16.0])
def test_moe_ffn_out_aux_and_drop_set_equal_jax(arch, cf):
    """cf 0.5 overflows the experts (C = 4 for 24 tokens x 2 choices over
    8 experts): the dropped choices must be the reference's exactly;
    cf 16 drops nothing."""
    cfg_r, cfg_t, pr, pt = _layer0_moe(arch, cf)
    x = np.random.default_rng(7).standard_normal(
        (3, 24, cfg_r.d_model)).astype(np.float32)
    out_r, aux_r = R_MOE.moe_ffn(jnp.asarray(x), pr, cfg_r)
    out_t, aux_t = T_MOE.moe_ffn(torch.from_numpy(x), pt, cfg_t)
    assert out_t.dtype == torch.float32 and tuple(out_t.shape) == x.shape
    assert _rel(out_r, out_t.numpy()) < REL
    assert abs(float(aux_r) - float(aux_t)) <= REL * abs(float(aux_r))

    keep_r, se_r, sc_r = _drops_r(cfg_r, pr, jnp.asarray(x))
    logits = torch.from_numpy(x) @ pt["router"]
    _, ids = T_MOE.route(logits.reshape(-1, cfg_t.moe.n_experts),
                         cfg_t.moe.top_k)
    C = T_MOE.capacity(cfg_t, 24)
    buf, keep_t, se_t, sc_t = T_MOE._dispatch_group(
        torch.from_numpy(x), ids.reshape(3, 24, -1), C,
        cfg_t.moe.n_experts)
    assert np.array_equal(keep_r, keep_t.numpy())
    assert np.array_equal(se_r, se_t.numpy())
    assert np.array_equal(sc_r, sc_t.numpy())
    assert tuple(buf.shape) == (3, cfg_t.moe.n_experts, C, cfg_t.d_model)
    dropped = int((~keep_t).sum())
    if cf < 1:
        assert dropped > 0
    else:
        assert dropped == 0


def test_dispatch_scatters_each_kept_choice_to_its_slot():
    """The buffer row of a kept choice holds its token; overflow lands in
    the trash column, which is cut off."""
    rng = np.random.default_rng(3)
    G, Tg, k, E, d, C = 2, 10, 2, 4, 5, 4
    x = torch.from_numpy(rng.standard_normal((G, Tg, d)).astype(np.float32))
    ids = torch.from_numpy(np.stack([
        np.stack([rng.permutation(E)[:k] for _ in range(Tg)])
        for _ in range(G)]))
    buf, keep, se, sc = T_MOE._dispatch_group(x, ids, C, E)
    filled = torch.zeros((G, E, C), dtype=torch.bool)
    for g in range(G):
        for c in range(Tg * k):
            if keep[g, c]:
                assert torch.equal(buf[g, se[g, c], sc[g, c]], x[g, c // k])
                filled[g, se[g, c], sc[g, c]] = True
            else:
                assert sc[g, c] == C and se[g, c] == 0
    assert torch.equal(buf[~filled], torch.zeros_like(buf[~filled]))


# ---------------------------------------------------------------------------
# whole decoders
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("cf", [None, 0.5])
def test_forward_logits_caches_and_aux_equal_jax(arch, cf):
    """The smoke config as published (cf 1.25) and under overflow (cf
    0.5, where the logits agree only if every layer drops the same
    choices)."""
    cfg_r, cfg_t, p_r, p_t = _pair(arch, cf)
    toks = _tokens(cfg_r, 2, 13, 1)
    lg_r, c_r, aux_r = R_T.forward(cfg_r, p_r, jnp.asarray(toks),
                                   return_cache=True)
    lg_t, c_t, aux_t = T_T.forward(cfg_t, p_t, torch.from_numpy(toks),
                                   return_cache=True)
    assert lg_t.dtype == torch.float32 and tuple(lg_t.shape) == lg_r.shape
    assert _rel(lg_r, lg_t.numpy()) < REL
    assert aux_t.dtype == torch.float32 and aux_t.dim() == 0
    assert float(aux_r) > 0
    assert abs(float(aux_r) - float(aux_t)) <= REL * float(aux_r)
    assert c_t["len"] == int(c_r["len"]) == 13
    assert set(c_t) == set(c_r)
    for key in ("k", "v"):
        assert tuple(c_t[key].shape) == c_r[key].shape
        assert _rel(c_r[key], c_t[key].numpy()) < REL


def _jit_steps(monkeypatch):
    """The reference's greedy loop with its prefill and serve steps
    jitted (compiled once each, not op by op on every step)."""
    prefill, serve = R_S.make_prefill_step, R_S.make_serve_step
    monkeypatch.setattr(R_S, "make_prefill_step",
                        lambda cfg: jax.jit(prefill(cfg)))
    monkeypatch.setattr(R_S, "make_serve_step",
                        lambda cfg: jax.jit(serve(cfg)))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_greedy_decode_tokens_equal_jax(arch, monkeypatch):
    cfg_r, cfg_t, p_r, p_t = _pair(arch)
    prompt = _tokens(cfg_r, 2, 9, 3)
    _jit_steps(monkeypatch)
    want = R_S.greedy_decode(cfg_r, p_r, jnp.asarray(prompt), n_steps=6,
                             max_len=16)
    got = T_S.greedy_decode(cfg_t, p_t, prompt, n_steps=6, max_len=16,
                            device="cpu")
    assert got.shape == (2, 6)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_step_logits_and_aux_equal_jax(arch):
    """One decode step against the same pre-filled cache in both (C = 4
    for a single token per group)."""
    cfg_r, cfg_t, p_r, p_t = _pair(arch)
    toks = _tokens(cfg_r, 2, 8, 4)
    _, c_r = R_S.make_prefill_step(cfg_r)(p_r, jnp.asarray(toks[:, :7]))
    _, c_t = T_S.make_prefill_step(cfg_t)(p_t, torch.from_numpy(toks[:, :7]))
    full_r = R_T.init_cache(cfg_r, 2, 12)
    full_t = T_T.init_cache(cfg_t, 2, 12, device="cpu")
    for k in ("k", "v"):
        full_r[k] = full_r[k].at[:, :, :7].set(c_r[k])
        full_t[k][:, :, :7] = c_t[k]
    full_r["len"] = jnp.asarray(7, jnp.int32)
    full_t["len"] = 7
    lg_r, _, aux_r = R_T.forward(cfg_r, p_r, jnp.asarray(toks[:, 7:8]),
                                 cache=full_r)
    lg_t, n_t, aux_t = T_T.forward(cfg_t, p_t, torch.from_numpy(toks[:, 7:8]),
                                   cache=full_t)
    assert _rel(lg_r, lg_t.numpy()) < REL
    assert abs(float(aux_r) - float(aux_t)) <= REL * float(aux_r)
    assert n_t["len"] == 8 and n_t["k"] is full_t["k"]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_matches_full_forward(arch):
    """Single-token decode == teacher-forced full forward at the same
    position, under capacity_factor 16 so that neither drops a choice
    (tests/test_arch_smoke.py's property, on the port's own init)."""
    cfg = _with_cf(T_C.get_smoke(arch), 16.0)
    params = T_T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    B, S = 2, 12
    toks = torch.from_numpy(_tokens(cfg, B, S, 5))
    logits_full, _, _ = T_T.forward(cfg, params, toks)
    _, cache, _ = T_T.forward(cfg, params, toks[:, : S - 1],
                              return_cache=True)
    full = T_S.decode_cache(cfg, cache, S + 4, device="cpu")
    dec, _, _ = T_T.forward(cfg, params, toks[:, S - 1:S], cache=full)
    assert _rel(logits_full[:, S - 1].numpy(), dec[:, 0].numpy()) < 1e-4


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_params_round_trip_carries_the_moe_leaves(arch):
    cfg_r, cfg_t, p_r, p_t = _pair(arch)
    back = T_T.params_to_numpy(p_t)
    flat_r = jax.tree_util.tree_leaves_with_path(p_r)
    assert len(flat_r) == len(jax.tree.leaves(back))
    names = set()
    for path, leaf in flat_r:
        node = back
        for k in path:
            node = node[k.key]
        assert np.array_equal(node, np.asarray(leaf))
        names.add("/".join(k.key for k in path))
    assert {"blocks/moe/router", "blocks/moe/wg", "blocks/moe/wu",
            "blocks/moe/wd"} <= names
    assert ("blocks/mlp/wg" in names) == bool(cfg_t.moe.n_shared)
    E, fe = cfg_t.moe.n_experts, cfg_t.moe.d_expert or cfg_t.d_ff
    assert tuple(p_t["blocks"]["moe"]["wd"].shape) == (
        cfg_t.n_layers, E, fe, cfg_t.d_model)


def test_init_params_draws_the_moe_leaves_in_slices():
    """Stacked leaves are drawn one layer slice at a time: the scaled
    normal still has its recipe's spread, and every layer differs."""
    cfg = T_C.get_smoke("deepseek_moe_16b")
    p = T_T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    wg = p["blocks"]["moe"]["wg"]
    assert wg.dtype == torch.float32
    assert abs(float(wg.std()) - cfg.d_model ** -0.5) < 0.05 * cfg.d_model ** -0.5
    assert not torch.equal(wg[0], wg[1])
    assert torch.equal(p["blocks"]["ln1"], torch.ones_like(p["blocks"]["ln1"]))
