"""The port's Mamba2 SSD block (``repro_torch.models.mamba2``) and the SSM
and hybrid decoders (mamba2-130m, zamba2-7b smoke configs) against the
JAX package on the CPU: the same parameters (JAX
``init_params(PRNGKey(0))`` carried across with ``params_from_jax``) and
the same NumPy inputs through both.

Tolerances: f32 throughout, so the two differ only in the order of sums;
outputs, states, logits and caches are held to a relative max error of
1e-5 (max |a - b| over max |a|).  Greedy tokens must be equal."""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import configs as R_C  # noqa: E402
from repro.models import mamba2 as R_M2  # noqa: E402
from repro.models import steps as R_S  # noqa: E402
from repro.models import transformer as R_T  # noqa: E402
from repro_torch import configs as T_C  # noqa: E402
from repro_torch.models import mamba2 as T_M2  # noqa: E402
from repro_torch.models import steps as T_S  # noqa: E402
from repro_torch.models import transformer as T_T  # noqa: E402

SSM_ARCHS = ("mamba2_130m", "zamba2_7b")
SSM_KEYS = ("conv_x", "conv_bc", "ssd")
REL = 1e-5


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-12))


_PAIRS: dict = {}


def _pair(arch):
    if arch not in _PAIRS:
        cfg_r, cfg_t = R_C.get_smoke(arch), T_C.get_smoke(arch)
        p_r = R_T.init_params(cfg_r, jax.random.PRNGKey(0))
        p_t = T_T.params_from_jax(cfg_t, jax.tree.map(np.asarray, p_r),
                                  device="cpu")
        _PAIRS[arch] = (cfg_r, cfg_t, p_r, p_t)
    return _PAIRS[arch]


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s),
                                                dtype=np.int32)


def _both(*arrays):
    """Each NumPy array as (jax array, torch tensor)."""
    return [(jnp.asarray(a), torch.from_numpy(a)) for a in arrays]


def _ssd_inputs(rng, B, S, H, P, G, N):
    f = np.float32
    x = rng.standard_normal((B, S, H, P)).astype(f)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(f) * 0.3
    A = -rng.uniform(0.5, 4.0, (H,)).astype(f)
    Bm = rng.standard_normal((B, S, G, N)).astype(f)
    Cm = rng.standard_normal((B, S, G, N)).astype(f)
    return x, dt, A, Bm, Cm


# ---------------------------------------------------------------------------
# the SSD and conv pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S,chunk,with_h0", [
    (13, 4, True), (13, 4, False), (16, 8, True), (3, 8, False),
    (1, 4, True)])
def test_ssd_chunked_equals_jax(S, chunk, with_h0):
    """S not a multiple of the chunk (padded to whole chunks), S below
    one chunk, and a carried-in state."""
    rng = np.random.default_rng(S * 10 + chunk)
    B, H, P, G, N = 2, 4, 8, 2, 6
    ins = _ssd_inputs(rng, B, S, H, P, G, N)
    h0 = rng.standard_normal((B, H, P, N)).astype(np.float32)
    (x, xt), (dt, dtt), (A, At), (Bm, Bt), (Cm, Ct) = _both(*ins)
    ssd_r = jax.jit(R_M2.ssd_chunked, static_argnames="chunk")
    y_r, h_r = ssd_r(x, dt, A, Bm, Cm, chunk=chunk,
                     h0=jnp.asarray(h0) if with_h0 else None)
    y_t, h_t = T_M2.ssd_chunked(xt, dtt, At, Bt, Ct, chunk=chunk,
                                h0=torch.from_numpy(h0) if with_h0 else None)
    assert tuple(y_t.shape) == (B, S, H, P) and y_t.dtype == torch.float32
    assert tuple(h_t.shape) == (B, H, P, N)
    assert _rel(y_r, y_t.numpy()) < REL
    assert _rel(h_r, h_t.numpy()) < REL


def test_ssd_chunked_agrees_with_its_own_recurrence():
    """The chunked form against S single-token decode steps from the same
    state: two algorithms for one recurrence."""
    rng = np.random.default_rng(11)
    B, S, H, P, G, N = 2, 11, 4, 8, 1, 6
    x, dt, A, Bm, Cm = (torch.from_numpy(a)
                        for a in _ssd_inputs(rng, B, S, H, P, G, N))
    h = torch.from_numpy(rng.standard_normal((B, H, P, N)).astype(np.float32))
    y, h_end = T_M2.ssd_chunked(x, dt, A, Bm, Cm, chunk=4, h0=h)
    ys = []
    for t in range(S):
        yt, h = T_M2.ssd_decode_step(x[:, t], dt[:, t], A, Bm[:, t],
                                     Cm[:, t], h)
        ys.append(yt)
    assert _rel(torch.stack(ys, 1).numpy(), y.numpy()) < 1e-5
    assert _rel(h.numpy(), h_end.numpy()) < 1e-5


@pytest.mark.parametrize("G", [1, 2])
def test_ssd_decode_step_equals_jax(G):
    rng = np.random.default_rng(G)
    B, H, P, N = 3, 4, 8, 6
    x, dt, A, Bm, Cm = _ssd_inputs(rng, B, 1, H, P, G, N)
    h = rng.standard_normal((B, H, P, N)).astype(np.float32)
    (x, xt), (dt, dtt), (Bm, Bt), (Cm, Ct), (h, ht), (A, At) = _both(
        x[:, 0], dt[:, 0], Bm[:, 0], Cm[:, 0], h, A)
    y_r, h_r = R_M2.ssd_decode_step(x, dt, A, Bm, Cm, h)
    y_t, h_t = T_M2.ssd_decode_step(xt, dtt, At, Bt, Ct, ht)
    assert _rel(y_r, y_t.numpy()) < REL
    assert _rel(h_r, h_t.numpy()) < REL


@pytest.mark.parametrize("S", [1, 3, 9])
def test_causal_conv1d_equals_jax(S):
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal((12,)).astype(np.float32)
    (x, xt), (w, wt), (b, bt) = _both(x, w, b)
    y_r = R_M2.causal_conv1d(x, w, b)
    y_t = T_M2.causal_conv1d(xt, wt, bt)
    assert _rel(y_r, y_t.numpy()) < REL


def test_conv_decode_step_equals_jax_and_the_causal_conv():
    rng = np.random.default_rng(5)
    S, K, Cch = 9, 4, 12
    xs = rng.standard_normal((2, S, Cch)).astype(np.float32)
    w = rng.standard_normal((K, Cch)).astype(np.float32)
    b = rng.standard_normal((Cch,)).astype(np.float32)
    buf_r = jnp.zeros((2, K, Cch), jnp.float32)
    buf_t = torch.zeros((2, K, Cch))
    wt, bt = torch.from_numpy(w), torch.from_numpy(b)
    ys = []
    for t in range(S):
        y_r, buf_r = R_M2.conv_decode_step(jnp.asarray(xs[:, t]), buf_r,
                                           jnp.asarray(w), jnp.asarray(b))
        y_t, buf_t = T_M2.conv_decode_step(torch.from_numpy(xs[:, t]), buf_t,
                                           wt, bt)
        assert _rel(y_r, y_t.numpy()) < REL
        assert np.array_equal(np.asarray(buf_r), buf_t.numpy())
        ys.append(y_t)
    full = T_M2.causal_conv1d(torch.from_numpy(xs), wt, bt)
    assert _rel(full.numpy(), torch.stack(ys, 1).numpy()) < REL


_BLOCK: list = []


def _jit_block():
    """The reference's ``mamba_block``, jitted once for the file (op by
    op it compiles every einsum anew for each shape)."""
    if not _BLOCK:
        _BLOCK.append(jax.jit(R_M2.mamba_block, static_argnums=0))
    return _BLOCK[0]


def _layer0(arch):
    cfg_r, cfg_t, p_r, p_t = _pair(arch)
    pr = jax.tree.map(lambda a: a[0], p_r["blocks"]["mamba"])
    pt = {k: v[0] for k, v in p_t["blocks"]["mamba"].items()}
    return cfg_r, cfg_t, pr, pt


@pytest.mark.parametrize("arch", SSM_ARCHS)
@pytest.mark.parametrize("S", [2, 4, 13])
def test_mamba_block_prefill_and_decode_equal_jax(arch, S):
    """Prefill: the output and the three handoff entries (the conv tails
    left-padded when S < K = 4); then one decode step from that state."""
    cfg_r, cfg_t, pr, pt = _layer0(arch)
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S + 1, cfg_r.d_model)).astype(np.float32)
    block_r = _jit_block()
    out_r, c_r = block_r(cfg_r, jnp.asarray(x[:, :S]), pr)
    out_t, c_t = T_M2.mamba_block(cfg_t, torch.from_numpy(x[:, :S]), pt)
    assert _rel(out_r, out_t.numpy()) < REL
    for key in SSM_KEYS:
        assert tuple(c_t[key].shape) == c_r[key].shape, key
        assert _rel(c_r[key], c_t[key].numpy()) < REL, key
    assert c_t["ssd"].dtype == torch.float32
    if S < cfg_t.ssm.conv_kernel:   # zero rows before the S real inputs
        pad = cfg_t.ssm.conv_kernel - S
        assert not c_t["conv_x"][:, :pad].any()
    d_r, n_r = block_r(cfg_r, jnp.asarray(x[:, S:]), pr, cache=c_r)
    d_t, n_t = T_M2.mamba_block(cfg_t, torch.from_numpy(x[:, S:]), pt,
                                cache=c_t)
    assert _rel(d_r, d_t.numpy()) < REL
    for key in SSM_KEYS:
        assert _rel(n_r[key], n_t[key].numpy()) < REL, key
    # the decode step continues the prefill: the S+1-token prefill's last
    # output
    whole, _ = T_M2.mamba_block(cfg_t, torch.from_numpy(x), pt)
    assert _rel(whole[:, -1].numpy(), d_t[:, 0].numpy()) < 1e-4


# ---------------------------------------------------------------------------
# whole decoders
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_forward_logits_and_caches_equal_jax(arch):
    cfg_r, cfg_t, p_r, p_t = _pair(arch)
    toks = _tokens(cfg_r, 2, 13, 1)
    lg_r, c_r, aux_r = R_T.forward(cfg_r, p_r, jnp.asarray(toks),
                                   return_cache=True)
    lg_t, c_t, aux_t = T_T.forward(cfg_t, p_t, torch.from_numpy(toks),
                                   return_cache=True)
    assert tuple(lg_t.shape) == lg_r.shape and lg_t.dtype == torch.float32
    assert _rel(lg_r, lg_t.numpy()) < REL
    assert float(aux_t) == float(aux_r) == 0.0
    assert set(c_t) == set(c_r) and c_t["len"] == int(c_r["len"]) == 13
    for key in c_r:
        if key == "len":
            continue
        assert tuple(c_t[key].shape) == c_r[key].shape, key
        assert _rel(c_r[key], c_t[key].numpy()) < REL, key
    if cfg_t.family == "hybrid":   # one KV entry per shared-block use
        assert c_t["k"].shape[0] == T_T._hybrid_split(cfg_t)[1] == 2


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_init_cache_equals_jax(arch):
    cfg_r, cfg_t, _, _ = _pair(arch)
    c_r = R_T.init_cache(cfg_r, 3, 20)
    c_t = T_T.init_cache(cfg_t, 3, 20, device="cpu")
    assert set(c_r) == set(c_t) and c_t["len"] == 0
    for key in c_r:
        if key != "len":
            assert tuple(c_t[key].shape) == c_r[key].shape
            assert str(c_t[key].dtype).split(".")[-1] == str(c_r[key].dtype)


def _jit_steps(monkeypatch):
    """The reference's greedy loop with its prefill and serve steps
    jitted (compiled once each, not op by op on every step)."""
    prefill, serve = R_S.make_prefill_step, R_S.make_serve_step
    monkeypatch.setattr(R_S, "make_prefill_step",
                        lambda cfg: jax.jit(prefill(cfg)))
    monkeypatch.setattr(R_S, "make_serve_step",
                        lambda cfg: jax.jit(serve(cfg)))


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_greedy_decode_tokens_equal_jax(arch, monkeypatch):
    """The prefill's conv rings and SSD states are handed to the decode
    cache, as the reference's ``greedy_decode`` does."""
    cfg_r, cfg_t, p_r, p_t = _pair(arch)
    prompt = _tokens(cfg_r, 2, 9, 3)
    _jit_steps(monkeypatch)
    want = R_S.greedy_decode(cfg_r, p_r, jnp.asarray(prompt), n_steps=6,
                             max_len=16)
    got = T_S.greedy_decode(cfg_t, p_t, prompt, n_steps=6, max_len=16,
                            device="cpu")
    assert got.shape == (2, 6)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_decode_cache_equals_the_reference_handoff(arch):
    """``steps.decode_cache`` seeds a max_len cache from a prefill as the
    reference's ``greedy_decode`` does (`repro/models/steps.py`): kv
    into the first S positions, conv rings and SSD states whole."""
    cfg_r, cfg_t, p_r, p_t = _pair(arch)
    toks = _tokens(cfg_r, 2, 7, 6)
    _, c_r = jax.jit(R_S.make_prefill_step(cfg_r))(p_r, jnp.asarray(toks))
    _, c_t = T_S.make_prefill_step(cfg_t)(p_t, torch.from_numpy(toks))
    full_r = R_T.init_cache(cfg_r, 2, 12)
    for k in ("k", "v"):
        if k in full_r:
            full_r[k] = full_r[k].at[:, :, :7].set(c_r[k])
    for k in SSM_KEYS:
        full_r[k] = c_r[k].astype(full_r[k].dtype)
    full_t = T_S.decode_cache(cfg_t, c_t, 12, device="cpu")
    assert full_t["len"] == 7 and set(full_t) == set(full_r)
    for k in full_r:
        if k != "len":
            assert tuple(full_t[k].shape) == full_r[k].shape, k
            assert _rel(full_r[k], full_t[k].numpy()) < REL, k


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_serve_step_logits_and_states_equal_jax(arch):
    """One decode step against the same pre-filled cache in both; the
    port writes the new states into the cache in place."""
    cfg_r, cfg_t, p_r, p_t = _pair(arch)
    toks = _tokens(cfg_r, 2, 8, 4)
    _, c_r = jax.jit(R_S.make_prefill_step(cfg_r))(
        p_r, jnp.asarray(toks[:, :7]))
    _, c_t = T_S.make_prefill_step(cfg_t)(p_t, torch.from_numpy(toks[:, :7]))
    full_r = R_T.init_cache(cfg_r, 2, 12)
    full_t = T_T.init_cache(cfg_t, 2, 12, device="cpu")
    for k in full_r:
        if k in ("k", "v"):
            full_r[k] = full_r[k].at[:, :, :7].set(c_r[k])
            full_t[k][:, :, :7] = c_t[k]
        elif k != "len":
            full_r[k] = c_r[k]
            full_t[k] = c_t[k].clone()
    full_r["len"] = jnp.asarray(7, jnp.int32)
    full_t["len"] = 7
    d_r, n_r = jax.jit(R_S.make_serve_step(cfg_r))(
        p_r, full_r, jnp.asarray(toks[:, 7:8]))
    d_t, n_t = T_S.make_serve_step(cfg_t)(p_t, full_t,
                                          torch.from_numpy(toks[:, 7:8]))
    assert _rel(d_r, d_t.numpy()) < REL
    assert n_t["len"] == 8 and n_t["ssd"] is full_t["ssd"]
    for k in n_r:
        if k != "len":
            assert _rel(n_r[k], n_t[k].numpy()) < REL, k


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_decode_matches_full_forward(arch):
    """Recurrent decode == the chunked prefill's logits at the same
    position (tests/test_arch_smoke.py's property, on the port's own
    init)."""
    cfg = T_C.get_smoke(arch)
    params = T_T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    B, S = 2, 12
    toks = torch.from_numpy(_tokens(cfg, B, S, 5))
    logits_full, _, _ = T_T.forward(cfg, params, toks)
    _, cache, _ = T_T.forward(cfg, params, toks[:, : S - 1],
                              return_cache=True)
    full = T_S.decode_cache(cfg, cache, S + 4, device="cpu")
    dec, _, _ = T_T.forward(cfg, params, toks[:, S - 1:S], cache=full)
    assert _rel(logits_full[:, S - 1].numpy(), dec[:, 0].numpy()) < 1e-4


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_params_round_trip_carries_the_ssd_leaves(arch):
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
    ssd = {f"blocks/mamba/{n}" for n in (
        "in_z", "in_x", "in_bc", "in_dt", "conv_x_w", "conv_x_b",
        "conv_bc_w", "conv_bc_b", "A_log", "D", "dt_bias", "gnorm",
        "out_proj")}
    assert ssd <= names
    assert ("shared/attn/wq" in names) == (cfg_t.family == "hybrid")
    assert ("lm_head" in names) == (not cfg_t.tie_embeddings)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_init_params_follows_the_ssd_recipe(arch):
    """gnorm and D ones, A = exp(A_log) in [1, 16), softplus(dt_bias) in
    [1e-3, 1e-1), and the conv biases scaled-normal draws (the JAX
    package's "conv_b" names no leaf)."""
    cfg = T_C.get_smoke(arch)
    p = T_T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    m = p["blocks"]["mamba"]
    assert torch.equal(m["gnorm"], torch.ones_like(m["gnorm"]))
    assert torch.equal(m["D"], torch.ones_like(m["D"]))
    A = torch.exp(m["A_log"])
    assert bool(((A >= 1 - 1e-5) & (A < 16 + 1e-4)).all())
    dt = torch.nn.functional.softplus(m["dt_bias"])
    assert bool(((dt > 1e-3 - 1e-6) & (dt < 1e-1 + 1e-6)).all())
    assert m["conv_x_b"].std() > 0 and m["conv_bc_b"].std() > 0


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_launch_serve_runs_the_smoke_config_on_cpu(arch, capsys):
    from repro_torch.launch import serve

    out = serve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                      "--prompt-len", "9", "--gen", "4"])
    assert out["tokens"].shape == (2, 4)
    assert out["decode_steps"] == 3
    assert "decode" in capsys.readouterr().out
