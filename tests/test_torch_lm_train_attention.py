"""The gradient through attention on the CPU: the port's
``chunked_attention`` (``kernels.flash_attention.FlashAttentionFn``,
whose backward recomputes the plain body one query chunk at a time)
against ``jax.vjp`` of the reference's pure-XLA ``chunked_attention``
(``jax.checkpoint`` of each query chunk), on NumPy inputs from a seed:
causal and full, GQA and MQA, ragged S, Sq < Sk with an offset.
``chunked_attention_plain`` with and without ``remat_chunks`` must give
the same gradients.  f32, so only the order of sums differs: each of
dq, dk, dv within a relative 1e-5 (max |a - b| over max |b|)."""

from __future__ import annotations

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.models import modules as R_M  # noqa: E402
from repro_torch.kernels import flash_attention_cuda  # noqa: E402
from repro_torch.models import modules as T_M  # noqa: E402

# the module, not ``kernels.flash_attention`` (the ops entry point)
T_FA = importlib.import_module("repro_torch.kernels.flash_attention")
REL = 1e-5
# name: (b, sq, sk, h, hkv, d, causal, kv_offset, q_chunk, kv_chunk)
CASES = {
    "gqa2-causal-ragged": (2, 37, 37, 4, 2, 16, True, 0, 16, 8),
    "gqa2-full-ragged": (2, 37, 37, 4, 2, 16, False, 0, 16, 8),
    "mqa6-causal": (1, 24, 24, 6, 1, 8, True, 0, 8, 16),
    "mha-full-one-chunk": (2, 20, 20, 3, 3, 32, False, 0, 32, 32),
    "sq-lt-sk-offset": (1, 10, 30, 4, 4, 16, True, 20, 4, 8),
    "gqa7-causal": (1, 29, 29, 14, 2, 8, True, 0, 8, 8),
}


def _inputs(name):
    b, sq, sk, h, hkv, d, *_ = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    f = np.float32
    return (rng.standard_normal((b, sq, h, d)).astype(f),
            rng.standard_normal((b, sk, hkv, d)).astype(f),
            rng.standard_normal((b, sk, hkv, d)).astype(f),
            rng.standard_normal((b, sq, h, d)).astype(f))


def _kw(name, **extra):
    *_, causal, off, qc, kc = CASES[name]
    return dict(causal=causal, kv_offset=off, q_chunk=qc, kv_chunk=kc,
                **extra)


def _port_grads(fn, name):
    q, k, v, w = (torch.from_numpy(a) for a in _inputs(name))
    for t in (q, k, v):
        t.requires_grad_()
    out = fn(q, k, v, **_kw(name))
    return out, torch.autograd.grad((out * w).sum(), (q, k, v))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_chunked_attention_gradient_equals_jax_vjp(name):
    q, k, v, w = _inputs(name)
    out_r, vjp = jax.vjp(
        lambda q, k, v: R_M.chunked_attention(q, k, v, **_kw(name)),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(w))
    out, got = _port_grads(T_M.chunked_attention, name)
    assert out.grad_fn is not None
    assert _rel(out.detach().numpy(), out_r) <= REL
    for label, a, b in zip("qkv", got, want):
        assert _rel(a.numpy(), b) <= REL, (label, _rel(a.numpy(), b))


@pytest.mark.parametrize("name", ["gqa2-causal-ragged", "sq-lt-sk-offset"])
def test_plain_attention_gradient_with_and_without_remat(name):
    _, remat = _port_grads(T_M.chunked_attention_plain, name)
    _, whole = _port_grads(
        lambda *a, **kw: T_M.chunked_attention_plain(
            *a, remat_chunks=False, **kw), name)
    _, kernel_path = _port_grads(T_M.chunked_attention, name)
    for a, b, c in zip(remat, whole, kernel_path):
        assert _rel(a.numpy(), b.numpy()) <= REL
        assert torch.equal(a, c)


def test_backward_recomputes_one_query_chunk_at_a_time(monkeypatch):
    """The backward's recomputations each see at most q_chunk queries
    (one chunk's scores, never (B, H, Sq, Sk)), cover every query once,
    and launch no kernel."""
    name = "gqa2-causal-ragged"
    seen = []
    rows = T_FA.attention_rows

    def recording(q, *args, **kwargs):
        seen.append(q.shape[2])
        return rows(q, *args, **kwargs)

    q, k, v, w = (torch.from_numpy(a) for a in _inputs(name))
    q.requires_grad_()
    out = T_M.chunked_attention(q, k, v, **_kw(name))
    monkeypatch.setattr(T_FA, "attention_rows", recording)
    before = flash_attention_cuda.launches
    torch.autograd.grad((out * w).sum(), q)
    qc = CASES[name][-2]
    assert seen and max(seen) <= qc and sum(seen) == q.shape[1]
    assert flash_attention_cuda.launches == before
