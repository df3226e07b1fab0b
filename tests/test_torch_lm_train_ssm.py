"""LM training on the port against the JAX package on the CPU in f32:
mamba2-130m's smoke config, loss and every gradient leaf through the
chunked SSD, then two AdamW steps (the hybrid zamba2-7b is in
``test_torch_lm_train_hybrid.py``); and the SSD's gradient at the full
configs' chunk of 128.

The port takes ``exp`` of the intra-chunk decay after the causal mask
(``mamba2._intra_decay``), the reference before it
(``src/repro/models/mamba2.py:58-61``).  The forward is the same bit for
bit; the reference's dt gradient overflows to NaN once dt * |A| * 127
passes float32's ``exp`` range (about 88), the port's stays finite and
equals ``jax.grad`` of the masked-before-exp form written here.  SSD
gradients are held to a relative 1e-4 (f32 cumulative sums and exps in
other orders)."""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import _torch_lm_train as H  # noqa: E402

from repro.models import mamba2 as R_M2  # noqa: E402
from repro_torch.models import mamba2 as T_M2  # noqa: E402

SSD_REL = 1e-4
# B, S, H, P, N, chunk: two full chunks of 128
SSD_SHAPE = (1, 256, 4, 8, 16, 128)


@pytest.fixture(scope="module")
def ref():
    return H.jax_reference("mamba2_130m")


def test_loss_and_grads_match_jax(ref):
    H.check_loss_and_grads(ref)


def test_two_adamw_steps_match_jax(ref):
    H.check_train_steps(ref)


def _exp_then_mask(diff, mask):
    """The reference's intra-chunk decay: exp first, then the mask."""
    return torch.where(mask, torch.exp(diff), 0.0)


def _ssd_inputs(dt_value):
    B, S, H, P, N, _ = SSD_SHAPE
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.full((B, S, H), dt_value, np.float32)
    A = -np.linspace(1.0, 16.0, H, dtype=np.float32)
    Bm = rng.standard_normal((B, S, 1, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, 1, N)).astype(np.float32)
    wy = rng.standard_normal((B, S, H, P)).astype(np.float32)
    wh = rng.standard_normal((B, H, P, N)).astype(np.float32)
    return (x, dt, A, Bm, Cm), (wy, wh)


def _port_dt_grad(inputs, weights):
    x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in inputs)
    dt.requires_grad_()
    y, h = T_M2.ssd_chunked(x, dt, A, Bm, Cm, chunk=SSD_SHAPE[-1])
    wy, wh = (torch.from_numpy(a) for a in weights)
    (g,) = torch.autograd.grad((y * wy).sum() + (h * wh).sum(), dt)
    return g.numpy()


def _jax_dt_grad(ssd, inputs, weights):
    x, dt, A, Bm, Cm = (jnp.asarray(a) for a in inputs)
    wy, wh = (jnp.asarray(a) for a in weights)

    def f(d):
        y, h = ssd(x, d, A, Bm, Cm, chunk=SSD_SHAPE[-1])
        return jnp.sum(y * wy) + jnp.sum(h * wh)

    return np.asarray(jax.jit(jax.grad(f))(dt))


def _ssd_masked_before_exp(x, dt, A, Bm, Cm, *, chunk):
    """``repro.models.mamba2.ssd_chunked`` with exp taken after the
    causal mask (S a multiple of the chunk, no h0): the port's form in
    JAX."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q, nc = chunk, S // chunk
    xc = x.reshape(Bsz, nc, Q, H, P)
    dtc = dt.reshape(Bsz, nc, Q, H)
    Bc = jnp.repeat(Bm.reshape(Bsz, nc, Q, G, N), H // G, axis=3)
    Cc = jnp.repeat(Cm.reshape(Bsz, nc, Q, G, N), H // G, axis=3)
    cum = jnp.cumsum(dtc * A, axis=2)
    CB = jnp.einsum("bcqhn,bckhn->bchqk", Cc, Bc)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    mask = jnp.tril(jnp.ones((Q, Q), bool))[None, None, :, :, None]
    M = jnp.exp(jnp.where(mask, diff, -jnp.inf)).transpose(0, 1, 4, 2, 3)
    scores = CB * M * dtc.transpose(0, 1, 3, 2)[:, :, :, None, :]
    y_intra = jnp.einsum("bchqk,bckhp->bcqhp", scores, xc)
    decay_to_end = jnp.exp(cum[:, :, -1:, :] - cum)
    S_chunk = jnp.einsum("bcqhn,bcqh,bcqhp->bchpn", Bc, decay_to_end * dtc,
                         xc)
    chunk_decay = jnp.exp(cum[:, :, -1, :])
    h = jnp.zeros((Bsz, H, P, N), jnp.float32)
    before = []
    for c in range(nc):
        before.append(h)
        h = chunk_decay[:, c, :, None, None] * h + S_chunk[:, c]
    y_inter = jnp.einsum("bcqhn,bchpn->bcqhp",
                         Cc * jnp.exp(cum)[..., None],
                         jnp.stack(before, axis=1))
    return (y_intra + y_inter).reshape(Bsz, S, H, P), h


@pytest.mark.parametrize("dt_value", [0.01, 0.05, 0.5])
def test_ssd_forward_unchanged_bit_for_bit(dt_value, monkeypatch):
    """Masking before ``exp`` gives the same outputs and final state as
    the reference's exp-then-mask, to the bit, also where exp overflows
    above the diagonal."""
    x, dt, A, Bm, Cm = (torch.from_numpy(a)
                        for a in _ssd_inputs(dt_value)[0])
    y, h = T_M2.ssd_chunked(x, dt, A, Bm, Cm, chunk=SSD_SHAPE[-1])
    monkeypatch.setattr(T_M2, "_intra_decay", _exp_then_mask)
    y_old, h_old = T_M2.ssd_chunked(x, dt, A, Bm, Cm, chunk=SSD_SHAPE[-1])
    assert torch.equal(y, y_old) and torch.equal(h, h_old)


def test_ssd_dt_gradient_equals_jax_where_finite():
    inputs, weights = _ssd_inputs(0.01)
    got = _port_dt_grad(inputs, weights)
    want = _jax_dt_grad(R_M2.ssd_chunked, inputs, weights)
    assert np.isfinite(want).all() and np.isfinite(got).all()
    assert H.leaf_rel(got, want) <= SSD_REL


@pytest.mark.parametrize("dt_value", [0.05, 0.5])
def test_ssd_dt_gradient_finite_where_the_reference_overflows(
        dt_value, monkeypatch):
    inputs, weights = _ssd_inputs(dt_value)
    assert not np.isfinite(
        _jax_dt_grad(R_M2.ssd_chunked, inputs, weights)).all()
    got = _port_dt_grad(inputs, weights)
    assert np.isfinite(got).all()
    want = _jax_dt_grad(_ssd_masked_before_exp, inputs, weights)
    assert np.isfinite(want).all()
    assert H.leaf_rel(got, want) <= SSD_REL
    # the port with the reference's order overflows as the reference does
    monkeypatch.setattr(T_M2, "_intra_decay", _exp_then_mask)
    assert not np.isfinite(_port_dt_grad(inputs, weights)).all()
