"""The port's context-parallel attention
(``models.modules.chunked_attention_kv_parallel``) against the JAX
package's (``repro.models.modules.chunked_attention_kv_parallel``) on
the same NumPy-seeded inputs, on CPU tensors, where the port computes
its plain body; the kernel-per-part path is held to the plain body on
the card (``tests/test_torch_cuda.py``).

Tolerances, f32 (only the order of sums differs): forward outputs
within ``atol = rtol = 2e-5`` (``tests/test_kernels_attention.py``'s);
gradients against ``jax.grad`` within 1e-4 of the largest magnitude;
the LM path under ``scheme_context(ShardScheme(attn_kv_parallel=True))``
by ``tests/_torch_lm_train.py``'s rules (metrics 1e-5, gradient leaves
1e-4).  Also here: the plain flash attention's log-sum-exp against
``torch.logsumexp`` of the scores."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import _torch_lm_train as LT  # noqa: E402
from repro import configs as R_C  # noqa: E402
from repro.models import modules as R_M  # noqa: E402
from repro.models import transformer as R_T  # noqa: E402
from repro.parallel import constrain as R_CON  # noqa: E402
from repro.parallel.sharding import ShardScheme as R_Scheme  # noqa: E402
from repro_torch import configs as T_C  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_plain  # noqa: E402
from repro_torch.models import modules as T_M  # noqa: E402
from repro_torch.models import transformer as T_T  # noqa: E402
from repro_torch.parallel import constrain as T_CON  # noqa: E402
from repro_torch.parallel.sharding import ShardScheme as T_Scheme  # noqa: E402

ATOL = RTOL = 2e-5
REL_GRAD = 1e-4

# name: (B, Sq, Sk, H, Hkv, D, causal, q_chunk, n_kv_parts)
CASES = {
    "causal-gqa-parts16": (2, 64, 64, 4, 2, 16, True, 16, 16),
    "full-gqa-parts16": (2, 64, 64, 4, 2, 16, False, 16, 16),
    "causal-mha-parts4": (1, 48, 48, 2, 2, 32, True, 32, 4),
    "causal-mqa-parts1": (2, 40, 40, 4, 1, 16, True, 16, 1),
    "full-parts1": (1, 33, 33, 2, 1, 16, False, 8, 1),
    # ragged Sq: fewer queries than keys (suffix aligned) and a last
    # query chunk that is cut short
    "ragged-sq-causal-parts4": (2, 37, 64, 4, 2, 16, True, 16, 4),
    "ragged-sq-full-parts16": (1, 21, 32, 6, 2, 16, False, 8, 16),
    "ragged-sq-causal-parts16": (1, 50, 96, 4, 4, 16, True, 32, 16),
}


def _inputs(name):
    B, Sq, Sk, H, Hkv, D, *_ = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    return (rng.standard_normal((B, Sq, H, D), dtype=np.float32),
            rng.standard_normal((B, Sk, Hkv, D), dtype=np.float32),
            rng.standard_normal((B, Sk, Hkv, D), dtype=np.float32),
            rng.standard_normal((B, Sq, H, D), dtype=np.float32))


_JAX: dict = {}


def _reference(name):
    """(out, (dq, dk, dv)) of the JAX package's function, once a case."""
    if name not in _JAX:
        *_, causal, q_chunk, parts = CASES[name]
        q, k, v, w = _inputs(name)

        def f(q, k, v):
            return R_M.chunked_attention_kv_parallel(
                q, k, v, causal=causal, q_chunk=q_chunk, n_kv_parts=parts)

        out = jax.jit(f)(q, k, v)
        grads = jax.jit(jax.grad(lambda q, k, v: jnp.sum(f(q, k, v) * w),
                                 argnums=(0, 1, 2)))(q, k, v)
        _JAX[name] = (np.asarray(out), [np.asarray(g) for g in grads])
    return _JAX[name]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_kv_parallel_forward_matches_reference(name):
    *_, causal, q_chunk, parts = CASES[name]
    q, k, v, _ = _inputs(name)
    want, _ = _reference(name)
    got = T_M.chunked_attention_kv_parallel(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, q_chunk=q_chunk, n_kv_parts=parts)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "autograd"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_kv_parallel_gradient_matches_jax_grad(name, remat):
    """``remat``: the entry point, ``KVParallelAttentionFn`` (the plain
    forward, the chunk-recompute backward); ``autograd``: plain autograd
    of the plain body, ``chunked_attention_kv_parallel_plain``."""
    *_, causal, q_chunk, parts = CASES[name]
    q, k, v, w = _inputs(name)
    _, want = _reference(name)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    attend = (T_M.chunked_attention_kv_parallel if remat
              else T_M.chunked_attention_kv_parallel_plain)
    out = attend(tq, tk, tv, causal=causal, q_chunk=q_chunk,
                 n_kv_parts=parts)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                              (tq, tk, tv))
    for label, g, r in zip("qkv", got, want):
        assert _rel(g.numpy(), r) <= REL_GRAD, (label, _rel(g.numpy(), r))


def test_kv_parallel_refuses_parts_that_do_not_divide_the_keys():
    q = torch.zeros((1, 8, 2, 16))
    k = torch.zeros((1, 10, 2, 16))
    with pytest.raises(AssertionError):
        T_M.chunked_attention_kv_parallel(q, k, k, causal=True, q_chunk=8,
                                          n_kv_parts=4)


def test_kv_parallel_plain_body_equals_its_remat_forward():
    """The two CPU forwards (the autograd Function's and the plain body)
    are one computation: equal bits."""
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs("causal-gqa-parts16"))
    a = T_M.chunked_attention_kv_parallel(q, k, v, causal=True, q_chunk=16)
    b = T_M.chunked_attention_kv_parallel_plain(q, k, v, causal=True,
                                                q_chunk=16)
    assert torch.equal(a, b)


# (Sq, Sk, kv_offset): aligned, a positive and a negative offset (a KV
# part's, where early queries see nothing), and keys past every query
LSE_CASES = ((37, 50, 13), (64, 64, 0), (64, 32, -40), (20, 100, -25),
             (1, 70, 69))


@pytest.mark.parametrize("sq,sk,off", LSE_CASES)
@pytest.mark.parametrize("causal", [True, False])
def test_plain_lse_is_logsumexp_of_the_scores(sq, sk, off, causal):
    rng = np.random.default_rng(sq + sk)
    B, H, Hkv, D = 2, 4, 2, 16
    q = torch.from_numpy(rng.standard_normal((B, H, sq, D), dtype=np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((B, Hkv, sk, D),
                                                 dtype=np.float32))
            for _ in range(2))
    out, lse = flash_attention_plain(q, k, v, causal=causal, kv_offset=off,
                                     q_blk=16, k_blk=32, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, sq)
    s = torch.einsum("bkgqd,bkjd->bkgqj", q.reshape(B, Hkv, 2, sq, D),
                     k) * D ** -0.5
    if causal:
        ok = torch.arange(sk)[None, :] <= torch.arange(sq)[:, None] + off
        s = torch.where(ok, s, -math.inf)
    want = torch.logsumexp(s, dim=-1).reshape(B, H, sq)
    dead = torch.isinf(want)
    assert torch.equal(torch.isinf(lse), dead)
    assert bool((lse[dead] < 0).all())
    assert float(out[dead].abs().sum()) == 0
    torch.testing.assert_close(lse[~dead], want[~dead], atol=1e-5, rtol=1e-5)
    alone = flash_attention_plain(q, k, v, causal=causal, kv_offset=off,
                                  q_blk=16, k_blk=32)
    assert torch.equal(alone, out)


# ---------------------------------------------------------------------------
# the LM path under the scheme
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,n_tok,q_chunk", [
    ("qwen2_0_5b", 32, 8), ("olmo_1b", 48, 512),
    ("llava_next_mistral_7b", 8, 4)])
def test_forward_under_kv_parallel_scheme_matches_reference(arch, n_tok,
                                                            q_chunk):
    """A smoke config's logits with the context-parallel attention in
    every layer: the JAX package's forward under its ``scheme_context``
    against the port's under the port's (llava: 8 front-end embeds + 8
    tokens, 16 keys in 16 parts)."""
    r_cfg = dataclasses.replace(R_C.get_smoke(arch), attn_q_chunk=q_chunk)
    t_cfg = dataclasses.replace(T_C.get_smoke(arch), attn_q_chunk=q_chunk)
    nf = r_cfg.n_frontend_embeds
    rng = np.random.default_rng(7)
    toks = rng.integers(0, r_cfg.vocab, (2, n_tok), dtype=np.int32)
    fe = (rng.standard_normal((2, nf, r_cfg.d_model)).astype(np.float32)
          if nf else None)
    params = R_T.init_params(r_cfg, jax.random.PRNGKey(0))
    with R_CON.scheme_context(R_Scheme(attn_kv_parallel=True)):
        want = np.asarray(jax.jit(lambda p, t, f: R_T.forward(
            r_cfg, p, t, frontend_embeds=f)[0])(params, toks, fe))
    tp = T_T.params_from_jax(t_cfg, jax.tree.map(np.asarray, params),
                             device="cpu")
    calls = []
    real = T_M.chunked_attention_kv_parallel

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    T_M.chunked_attention_kv_parallel = counted
    try:
        with T_CON.scheme_context(T_Scheme(attn_kv_parallel=True)):
            got, _, _ = T_T.forward(
                t_cfg, tp, torch.from_numpy(toks),
                frontend_embeds=None if fe is None else torch.from_numpy(fe))
    finally:
        T_M.chunked_attention_kv_parallel = real
    assert len(calls) == t_cfg.n_layers
    assert _rel(got.numpy(), want) <= LT.REL_METRIC
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def kv_parallel_ref():
    """The JAX package's qwen2 smoke train step, traced under its
    ``scheme_context(ShardScheme(attn_kv_parallel=True))``."""
    with R_CON.scheme_context(R_Scheme(attn_kv_parallel=True)):
        return LT.jax_reference("qwen2_0_5b", n_steps=1)


def test_loss_and_grads_under_kv_parallel_scheme_match_reference(
        kv_parallel_ref):
    with T_CON.scheme_context(T_Scheme(attn_kv_parallel=True)):
        LT.check_loss_and_grads(kv_parallel_ref)


def test_train_step_under_kv_parallel_scheme_matches_reference(
        kv_parallel_ref):
    with T_CON.scheme_context(T_Scheme(attn_kv_parallel=True)):
        LT.check_train_steps(kv_parallel_ref)


def test_kv_parallel_scheme_takes_the_kv_parallel_branch_only_inside():
    """``attn_full`` reads the scheme when it runs: inside the context
    the context-parallel attention, outside it the ``attention`` hook."""
    cfg = T_C.get_smoke("qwen2_0_5b")
    params = T_T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.zeros((1, 16), dtype=torch.int64)
    seen = []

    def hook(*a, **kw):
        seen.append("hook")
        return T_M.chunked_attention_plain(*a, **kw)

    T_T.forward(cfg, params, toks, attention=hook)
    assert seen == ["hook"] * cfg.n_layers
    seen.clear()
    with T_CON.scheme_context(T_Scheme(attn_kv_parallel=True)):
        T_T.forward(cfg, params, toks, attention=hook)
    assert seen == []
    assert not T_CON.attn_kv_parallel_enabled()
