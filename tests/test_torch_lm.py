"""The port's LM substrate (``repro_torch.configs``, ``repro_torch.models``)
against the JAX package on the smoke configs (f32, CPU): the same
parameters (JAX ``init_params(PRNGKey(0))`` carried across with
``params_from_jax``) and the same NumPy tokens through both.

Tolerances: f32 throughout, so forwards differ only in the order of
sums (XLA's dot vs PyTorch's); logits and caches are held to a relative
max error of 1e-5 (max |a - b| over max |a|).  Greedy tokens must be
equal."""

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
from repro_torch.models.config import ModelConfig  # noqa: E402

ATTN_ARCHS = ("qwen2_0_5b", "olmo_1b", "minitron_8b", "qwen2_5_14b",
              "llava_next_mistral_7b", "musicgen_medium")
REL = 1e-5


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-12))


def _pair(arch):
    cfg_r = R_C.get_smoke(arch)
    cfg_t = T_C.get_smoke(arch)
    p_r = R_T.init_params(cfg_r, jax.random.PRNGKey(0))
    p_t = T_T.params_from_jax(cfg_t, jax.tree.map(np.asarray, p_r),
                              device="cpu")
    return cfg_r, cfg_t, p_r, p_t


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s),
                                                dtype=np.int32)


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_forward_and_prefill_cache_match_jax(arch):
    cfg_r, cfg_t, p_r, p_t = _pair(arch)
    toks = _tokens(cfg_r, 2, 13, 1)
    fe = None
    if cfg_r.n_frontend_embeds:
        fe = np.random.default_rng(2).standard_normal(
            (2, cfg_r.n_frontend_embeds, cfg_r.d_model)).astype(np.float32)
    lg_r, c_r, _ = R_T.forward(
        cfg_r, p_r, jnp.asarray(toks), return_cache=True,
        frontend_embeds=None if fe is None else jnp.asarray(fe))
    lg_t, c_t, aux = T_T.forward(
        cfg_t, p_t, torch.from_numpy(toks), return_cache=True,
        frontend_embeds=None if fe is None else torch.from_numpy(fe))
    assert lg_t.dtype == torch.float32 and float(aux) == 0.0
    assert tuple(lg_t.shape) == lg_r.shape
    assert _rel(lg_r, lg_t.numpy()) < REL
    assert c_t["len"] == int(c_r["len"])
    for key in ("k", "v"):
        assert tuple(c_t[key].shape) == c_r[key].shape
        assert _rel(c_r[key], c_t[key].numpy()) < REL
    # last_only unembeds the final position only
    last, _, _ = T_T.forward(
        cfg_t, p_t, torch.from_numpy(toks), last_only=True,
        frontend_embeds=None if fe is None else torch.from_numpy(fe))
    assert torch.allclose(last[:, 0], lg_t[:, -1], rtol=0, atol=1e-6)


def test_greedy_decode_tokens_equal_jax():
    cfg_r, cfg_t, p_r, p_t = _pair("qwen2_0_5b")
    prompt = _tokens(cfg_r, 2, 9, 3)
    want = R_S.greedy_decode(cfg_r, p_r, jnp.asarray(prompt), n_steps=6,
                             max_len=16)
    stats: dict = {}
    got = T_S.greedy_decode(cfg_t, p_t, prompt, n_steps=6, max_len=16,
                            device="cpu", stats=stats)
    assert got.shape == (2, 6) and got.dtype == torch.int64
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert stats["decode_steps"] == 5 and stats["prefill_s"] > 0


def test_serve_step_logits_match_jax():
    """One decode step against the same pre-filled cache in both."""
    cfg_r, cfg_t, p_r, p_t = _pair("qwen2_0_5b")
    toks = _tokens(cfg_r, 2, 8, 4)
    lg_r, c_r = R_S.make_prefill_step(cfg_r)(p_r, jnp.asarray(toks[:, :7]))
    lg_t, c_t = T_S.make_prefill_step(cfg_t)(p_t, torch.from_numpy(
        toks[:, :7]))
    assert _rel(lg_r, lg_t.numpy()) < REL
    full_r = R_T.init_cache(cfg_r, 2, 12)
    full_t = T_T.init_cache(cfg_t, 2, 12, device="cpu")
    for k in ("k", "v"):
        full_r[k] = full_r[k].at[:, :, :7].set(c_r[k])
        full_t[k][:, :, :7] = c_t[k]
    full_r["len"] = jnp.asarray(7, jnp.int32)
    full_t["len"] = 7
    d_r, n_r = R_S.make_serve_step(cfg_r)(p_r, full_r,
                                          jnp.asarray(toks[:, 7:8]))
    d_t, n_t = T_S.make_serve_step(cfg_t)(p_t, full_t,
                                          torch.from_numpy(toks[:, 7:8]))
    assert _rel(d_r, d_t.numpy()) < REL
    assert n_t["len"] == 8 and n_t["k"] is full_t["k"]   # in place
    for k in ("k", "v"):
        assert _rel(n_r[k], n_t[k].numpy()) < REL


@pytest.mark.parametrize("arch", ["qwen2_0_5b", "musicgen_medium"])
def test_decode_matches_full(arch):
    """Single-token decode == teacher-forced full forward at the same
    position (mirrors tests/test_arch_smoke.py's property)."""
    cfg = T_C.get_smoke(arch)
    params = T_T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    B, S = 2, 12
    toks = torch.from_numpy(_tokens(cfg, B, S, 5))
    logits_full, _, _ = T_T.forward(cfg, params, toks)
    _, cache, _ = T_T.forward(cfg, params, toks[:, : S - 1],
                              return_cache=True)
    full = T_T.init_cache(cfg, B, S + 4, device="cpu")
    for k in ("k", "v"):
        full[k][:, :, : S - 1] = cache[k]
    full["len"] = S - 1
    dec, _, _ = T_T.forward(cfg, params, toks[:, S - 1:S], cache=full)
    a = logits_full[:, S - 1, :].numpy()
    b = dec[:, 0, :].numpy()
    assert _rel(a, b) < 1e-4


def test_params_round_trip_and_shape_checks():
    cfg_r, cfg_t, p_r, p_t = _pair("qwen2_0_5b")
    back = T_T.params_to_numpy(p_t)
    flat_r = jax.tree_util.tree_leaves_with_path(p_r)
    assert len(flat_r) == len(jax.tree.leaves(back))
    for path, leaf in flat_r:
        node = back
        for k in path:
            node = node[k.key]
        assert np.array_equal(node, np.asarray(leaf))
    tree = jax.tree.map(np.asarray, p_r)
    tree["blocks"]["attn"]["wq"] = tree["blocks"]["attn"]["wq"][:, :3]
    with pytest.raises(ValueError, match="wq"):
        T_T.params_from_jax(cfg_t, tree, device="cpu")
    tree = jax.tree.map(np.asarray, p_r)
    tree["extra"] = np.zeros(3)
    with pytest.raises(ValueError, match="extra"):
        T_T.params_from_jax(cfg_t, tree, device="cpu")
    # bf16 configs carry across too, widened back to f32 by the reverse
    cfg16 = dataclasses.replace(cfg_t, dtype="bfloat16")
    p16 = T_T.params_from_jax(cfg16, jax.tree.map(np.asarray, p_r),
                              device="cpu")
    assert p16["embed"].dtype == torch.bfloat16
    assert T_T.params_to_numpy(p16)["embed"].dtype == np.float32


@pytest.mark.parametrize("arch", T_C.ARCH_NAMES)
def test_configs_equal_jax(arch):
    for get_r, get_t in ((R_C.get, T_C.get), (R_C.get_smoke, T_C.get_smoke)):
        cfg_r, cfg_t = get_r(arch), get_t(arch)
        assert isinstance(cfg_t, ModelConfig)
        assert dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_r)
        assert cfg_t.n_params() == cfg_r.n_params()
        assert cfg_t.n_active_params() == cfg_r.n_active_params()
        assert cfg_t.hd == cfg_r.hd
    for shape in T_C.SHAPES:
        assert T_C.cell_supported(T_C.get(arch), shape) == \
            R_C.cell_supported(R_C.get(arch), shape)


def test_registry_tables_equal_jax():
    assert T_C.ARCH_NAMES == R_C.ARCH_NAMES
    assert {k: dataclasses.asdict(v) for k, v in T_C.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in R_C.SHAPES.items()}
    assert T_C.canonical("qwen2-0.5b") == "qwen2_0_5b"
    with pytest.raises(KeyError):
        T_C.get("no-such-arch")


@pytest.mark.parametrize("arch", T_C.ARCH_NAMES)
def test_every_config_serves_on_cpu(arch):
    """Every family builds params and a cache, forwards and greedy-decodes
    at its smoke size: none is left unported."""
    cfg = T_C.get_smoke(arch)
    params = T_T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(_tokens(cfg, 2, 6, 7))
    fe = None
    if cfg.n_frontend_embeds:
        fe = torch.zeros((2, cfg.n_frontend_embeds, cfg.d_model))
    logits, cache, aux = T_T.forward(cfg, params, toks, frontend_embeds=fe,
                                     return_cache=True)
    assert logits.shape == (2, 6 + cfg.n_frontend_embeds, cfg.vocab)
    assert bool(torch.isfinite(logits).all()) and aux.dim() == 0
    assert (float(aux) > 0) == (cfg.moe is not None)
    assert set(T_T.init_cache(cfg, 2, 8, device="cpu")) == set(cache)
    toks_out = T_S.greedy_decode(cfg, params, toks.numpy(), n_steps=3,
                                 max_len=9, device="cpu")
    assert toks_out.shape == (2, 3)
    assert bool(((toks_out >= 0) & (toks_out < cfg.vocab)).all())


def test_launch_serve_runs_the_smoke_config_on_cpu(capsys):
    from repro_torch.launch import serve

    out = serve.main(["--arch", "qwen2_0_5b", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8", "--gen", "4"])
    assert out["tokens"].shape == (2, 4)
    assert "decode" in capsys.readouterr().out
