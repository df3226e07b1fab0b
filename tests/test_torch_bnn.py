"""Packed BNN inference in the port against the JAX package: bit
packing, popcount, fold_bn, pack_params and forward_packed, on the same
NumPy inputs, compared with ``np.array_equal`` (all arithmetic is
integer)."""

from __future__ import annotations

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from _hypothesis_compat import given, settings, st  # noqa: E402

from repro.bnn import fold_bn as R_fold  # noqa: E402
from repro.bnn import layers as R_L  # noqa: E402
from repro.bnn import models as R_M  # noqa: E402
from repro_torch.bnn import binarize as T_B  # noqa: E402
from repro_torch.bnn import fold_bn as T_fold  # noqa: E402
from repro_torch.bnn import layers as T_L  # noqa: E402
from repro_torch.bnn import models as T_M  # noqa: E402

# `repro.bnn` re-exports a function named `binarize`, which shadows the
# submodule as an attribute
R_B = importlib.import_module("repro.bnn.binarize")

ARCHS = ("cifar10", "fashion_mnist")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _pm1(rng, shape):
    return np.where(rng.random(shape) < 0.5, -1.0, 1.0).astype(np.float32)


# ---------------------------------------------------------------------------
# binarize
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 5, 31, 32, 33, 64, 70, 97])
@pytest.mark.parametrize("pad_bit", [0, 1])
def test_pack_bits_matches_reference(n, pad_bit):
    x = np.random.default_rng(n).standard_normal((3, 2, n)).astype(np.float32)
    want = np.asarray(R_B.pack_bits(jnp.asarray(x), pad_bit))
    got = T_B.pack_bits(_t(x), pad_bit)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(T_B.np_pack_bits(x, pad_bit), want)
    bits = x >= 0
    assert np.array_equal(T_B.pack_bits(_t(bits), pad_bit).numpy(), want)


@pytest.mark.parametrize("n", [1, 31, 32, 45, 96])
def test_unpack_and_popcount_match_reference(n):
    rng = np.random.default_rng(100 + n)
    words = rng.integers(-2**31, 2**31, (4, T_B.packed_len(n)),
                         dtype=np.int64).astype(np.int32)
    assert np.array_equal(
        T_B.unpack_bits(_t(words), n).numpy(),
        np.asarray(R_B.unpack_bits(jnp.asarray(words), n)),
    )
    assert np.array_equal(
        T_B.popcount(_t(words)).numpy(),
        np.asarray(R_B.popcount(jnp.asarray(words))),
    )


def test_popcount_extremes():
    w = np.array([0, -1, 1, -2**31, 2**31 - 1, 0x55555555], np.int32)
    assert T_B.popcount(_t(w)).tolist() == [0, 32, 1, 1, 31, 16]


@settings(max_examples=25, deadline=None)
@given(n=st.integers(1, 130), seed=st.integers(0, 2**31 - 1))
def test_pack_unpack_roundtrip(n, seed):
    x = _pm1(np.random.default_rng(seed), (3, n))
    words = T_B.pack_bits(_t(x))
    assert words.shape[-1] == T_B.packed_len(n)
    assert np.array_equal(T_B.unpack_bits(words, n).numpy(), x)


@settings(max_examples=25, deadline=None)
@given(k_bits=st.integers(1, 97), seed=st.integers(0, 2**31 - 1))
def test_xnor_dot_exact_vs_float(k_bits, seed):
    """The tail-lane convention makes the packed dot exact for any K
    (K not a multiple of 32 included), in both packages."""
    rng = np.random.default_rng(seed)
    a, w = _pm1(rng, (2, k_bits)), _pm1(rng, (2, k_bits))
    want = (a * w).sum(-1).astype(np.int64)
    aw, ww = T_B.pack_bits(_t(a), 0), T_B.pack_bits(_t(w), 1)
    got = T_B.xnor_dot_words(aw, ww, k_bits)
    assert np.array_equal(got.numpy(), want)
    ref = R_B.xnor_dot_words(
        R_B.pack_bits(jnp.asarray(a), 0), R_B.pack_bits(jnp.asarray(w), 1),
        k_bits)
    assert np.array_equal(got.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# specs, fold_bn, pack_params
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("scale", [0.25, 1.0])
def test_build_model_specs_match_reference(arch, scale):
    t, r = T_M.build_model(arch, scale=scale), R_M.build_model(arch, scale=scale)
    assert (t.name, t.input_hw, t.in_channels, t.n_classes) == (
        r.name, r.input_hw, r.in_channels, r.n_classes)
    assert [s.__dict__ for s in t.specs] == [s.__dict__ for s in r.specs]
    assert [s.reduce_dim for s in t.specs] == [s.reduce_dim for s in r.specs]


def test_parse_notation_rejects_what_the_reference_rejects():
    for bad in (("C32", "MP15", "FC10"), ("C32", "X", "FC10")):
        with pytest.raises(ValueError):
            R_L.parse_notation(bad, (8, 8), 1, 10)
        with pytest.raises(ValueError):
            T_L.parse_notation(bad, (8, 8), 1, 10)


def test_fold_bn_matches_reference_all_sign_cases():
    rng = np.random.default_rng(3)
    c = 64
    gamma = rng.normal(size=c).astype(np.float32)
    gamma[:6] = 0.0                       # gamma == 0 branch, both betas
    beta = rng.normal(size=c).astype(np.float32)
    beta[:3] = -np.abs(beta[:3])
    mean = rng.normal(0, 20, c).astype(np.float32)
    var = rng.uniform(0.1, 50, c).astype(np.float32)
    t_want, f_want = R_fold.fold_bn(gamma, beta, mean, var)
    t_got, f_got = T_fold.fold_bn(gamma, beta, mean, var)
    assert t_got.dtype == np.int32 and f_got.dtype == bool
    assert np.array_equal(t_got, t_want) and np.array_equal(f_got, f_want)
    assert T_fold._BIG == R_fold._BIG == 2**30


@pytest.mark.parametrize("arch", ARCHS)
def test_pack_params_matches_reference(arch):
    m = T_M.build_model(arch, scale=0.25)
    fp = T_M.random_fp_params(m.specs, 0)
    want = R_M.pack_params(R_M.build_model(arch, scale=0.25).specs, fp)
    got = T_M.pack_params(m.specs, fp, device="cpu")
    assert len(got) == len(want)
    flips = 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if k == "k_true":
                assert g[k] == int(w[k])
            else:
                assert g[k].is_contiguous()
                assert np.array_equal(g[k].numpy(), np.asarray(w[k]))
        flips += int(g["flip"].sum()) if "flip" in g else 0
    assert flips > 0      # negative gammas reach the flip path


@pytest.mark.parametrize("arch", ARCHS)
def test_packed_params_cross_from_the_reference(arch):
    """The JAX package's packed params, as NumPy, load as the port's
    tensors unchanged."""
    r = R_M.build_model(arch, scale=0.25)
    want = R_M.pack_params(r.specs, T_M.random_fp_params(r.specs, 1))
    got = T_M.packed_params_from_numpy(
        [{k: np.asarray(v) for k, v in p.items()} for p in want], "cpu")
    for g, w in zip(got, want):
        for k in w:
            gv = g[k] if k == "k_true" else g[k].numpy()
            assert np.array_equal(gv, np.asarray(w[k]))
    assert all(g["flip"].dtype == torch.bool for g in got if "flip" in g)


# ---------------------------------------------------------------------------
# packed layer ops and the whole forward
# ---------------------------------------------------------------------------


def _x01(m, batch, seed):
    return np.random.default_rng(seed).random(
        (batch, *m.input_hw, m.in_channels), dtype=np.float32)


def test_packed_layer_ops_match_reference():
    rng = np.random.default_rng(5)
    x = rng.integers(-2**31, 2**31, (2, 6, 6, 2), dtype=np.int64).astype(np.int32)
    w = rng.integers(-2**31, 2**31, (5, 18), dtype=np.int64).astype(np.int32)
    assert np.array_equal(
        T_L.extract_patch_words(_t(x)).numpy(),
        np.asarray(R_L.extract_patch_words(jnp.asarray(x))))
    assert np.array_equal(
        T_L.conv_packed(_t(x), _t(w), 50).numpy(),
        np.asarray(R_L.conv_packed(jnp.asarray(x), jnp.asarray(w), 50)))
    y = rng.integers(-40, 40, (2, 6, 6, 40)).astype(np.int32)
    assert np.array_equal(
        T_L.maxpool_packed(_t(y)).numpy(),
        np.asarray(R_L.maxpool_packed(jnp.asarray(y))))
    t = rng.integers(-5, 5, 40).astype(np.int32)
    f = rng.random(40) < 0.5
    assert np.array_equal(
        T_L.step_packed(_t(y), _t(t), _t(f)).numpy(),
        np.asarray(R_L.step_packed(jnp.asarray(y), jnp.asarray(t),
                                   jnp.asarray(f))))
    xf = rng.integers(-2**31, 2**31, (3, 7), dtype=np.int64).astype(np.int32)
    wf = rng.integers(-2**31, 2**31, (9, 7), dtype=np.int64).astype(np.int32)
    assert np.array_equal(
        T_L.fc_packed(_t(xf), _t(wf), 200).numpy(),
        np.asarray(R_L.fc_packed(jnp.asarray(xf), jnp.asarray(wf), 200)))
    with pytest.raises(ValueError):
        T_L.flat_packed(_t(x), 40)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_packed_matches_reference(arch):
    m = T_M.build_model(arch, scale=0.25)
    r = R_M.build_model(arch, scale=0.25)
    fp = T_M.random_fp_params(m.specs, 0)
    x01 = _x01(m, 2, 7)
    xr = R_M.prepare_input_packed(jnp.asarray(x01))
    xt = T_M.prepare_input_packed(_t(x01))
    assert np.array_equal(xt.numpy(), np.asarray(xr))
    want = np.asarray(R_M.forward_packed(r.specs, R_M.pack_params(r.specs, fp), xr))
    got = T_M.forward_packed(m.specs, T_M.pack_params(m.specs, fp, device="cpu"), xt)
    assert got.dtype == torch.int32 and got.shape == (2, m.n_classes)
    assert np.array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 2     # the scores are not degenerate
