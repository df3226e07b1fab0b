"""BNN training in the port against the JAX package: the STE, the fp-sim
layers with their gradients, whole train steps from one carried-across
``TrainState``, and the trained net packed and served by the packed
reference.  Inputs are NumPy-seeded and given to both packages.

Tolerances: conv / fc outputs on +-1 operands are exact integers in
float32 and are held ``np.array_equal``; so are signs, STE masks and
max-pool gradients (a split among 1, 2, 3 or 4 tied maxima is one
float32 division in both packages).  Float results that sum in another
order (gradients through batch statistics, BN running variances, the
optimizer's moments) are held to a relative 1e-5 with an absolute floor
of 1e-5 times the largest magnitude of the reference's tensor (a sum
reordered in f32 errs relative to its largest terms, not to a result
that cancels to near zero); the train-state comparison states its own
floors."""

from __future__ import annotations

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from _hypothesis_compat import given, settings, st  # noqa: E402

from repro.bnn import layers as R_L  # noqa: E402
from repro.bnn import models as R_M  # noqa: E402
from repro.bnn import train as R_T  # noqa: E402
from repro.data import ShardedBatcher as R_Batcher  # noqa: E402
from repro.data import make_image_dataset as R_images  # noqa: E402
from repro_torch.bnn import binarize as T_B  # noqa: E402
from repro_torch.bnn import layers as T_L  # noqa: E402
from repro_torch.bnn import models as T_M  # noqa: E402
from repro_torch.bnn import train as T_T  # noqa: E402
from repro_torch.data import ShardedBatcher, make_image_dataset  # noqa: E402
from repro_torch.tree import leaves, paths  # noqa: E402

R_B = importlib.import_module("repro.bnn.binarize")

# f32 results summed in another order: relative tolerance, and the
# absolute floor as a fraction of the reference's largest magnitude
RTOL = 1e-5


# a batch variance is a mean of up to 64 x 14 x 14 = 12,544 squares,
# summed in f32 in another order (worst case n * eps ~ 7e-4): the BN
# running variance is held to a relative 1e-4
VAR_RTOL = 1e-4
# AdamW's moments after k steps: sums of k gradients (m) and of their
# squares (v), each gradient an f32 sum in another order
MOMENT_RTOL = 1e-4


def _close(got, want, err_msg="", rtol=RTOL):
    want = np.asarray(want)
    floor = rtol * float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=floor,
                               err_msg=err_msg)


def _t(x, grad=False):
    t = torch.from_numpy(np.array(x, np.float32))
    return t.requires_grad_(True) if grad else t


def _pm1(rng, shape):
    return np.where(rng.random(shape) < 0.5, -1.0, 1.0).astype(np.float32)


# ---------------------------------------------------------------------------
# binarize / STE
# ---------------------------------------------------------------------------


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), n=st.integers(1, 64))
def test_binarize_and_ste_mask_equal_reference(seed, n):
    """Forward sign (ties to +1) and the clipped STE's gradient mask
    ``|x| <= 1`` — inclusive at exactly +-1 — equal to the reference's
    ``jax.vjp``."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * 1.5).astype(np.float32)
    planted = rng.random(n) < 0.3
    x[planted] = rng.choice(np.array([-1.0, 1.0, 0.0, -0.0], np.float32),
                            int(planted.sum()))
    g = rng.standard_normal(n).astype(np.float32)
    want_y, vjp = jax.vjp(R_B.binarize_ste, jnp.asarray(x))
    (want_g,) = vjp(jnp.asarray(g))
    xt = _t(x, grad=True)
    y = T_B.binarize_ste(xt)
    (got_g,) = torch.autograd.grad(y, xt, _t(g))
    assert np.array_equal(y.detach().numpy(), np.asarray(want_y))
    assert np.array_equal(T_B.binarize(_t(x)).numpy(),
                          np.asarray(R_B.binarize(jnp.asarray(x))))
    assert np.array_equal(got_g.numpy(), np.asarray(want_g))


def test_ste_passes_at_exactly_one_and_blocks_beyond():
    x = _t([-1.0000001, -1.0, -0.5, 0.0, 1.0, 1.0000001], grad=True)
    (g,) = torch.autograd.grad(T_B.binarize_ste(x).sum(), x)
    assert g.tolist() == [0.0, 1.0, 1.0, 1.0, 1.0, 0.0]
    assert T_B.binarize(x).tolist() == [-1.0, -1.0, -1.0, 1.0, 1.0, 1.0]


# ---------------------------------------------------------------------------
# fp-sim layers: outputs and gradients against jax.grad
# ---------------------------------------------------------------------------


def _jax_vjp(fn, args, cot):
    out, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in args])
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(cot))]


def _torch_vjp(fn, args, cot):
    ts = [_t(a, grad=True) for a in args]
    out = fn(*ts)
    grads = torch.autograd.grad(out, ts, _t(cot))
    return out.detach().numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("cin,cout,hw", [(1, 8, 6), (3, 16, 5), (40, 33, 4)])
def test_conv_fp_and_gradients_equal_reference(cin, cout, hw):
    rng = np.random.default_rng(cin * 100 + cout)
    x = _pm1(rng, (2, hw, hw, cin))
    w = (rng.uniform(-1.3, 1.3, (3, 3, cin, cout))).astype(np.float32)
    cot = rng.standard_normal((2, hw, hw, cout)).astype(np.float32)
    want, (wgx, wgw) = _jax_vjp(R_L.conv_fp, (x, w), cot)
    got, (ggx, ggw) = _torch_vjp(T_L.conv_fp, (x, w), cot)
    assert np.array_equal(got, want)             # exact integers
    assert np.all(got == np.round(got))
    _close(ggx, wgx)
    _close(ggw, wgw)
    # the STE zeroes the weight gradient where |w| > 1
    assert np.all(ggw[np.abs(w) > 1] == 0)


def test_conv_fp_pads_with_minus_one():
    x = np.ones((1, 3, 3, 1), np.float32)
    w = np.ones((3, 3, 1, 1), np.float32)
    got = T_L.conv_fp(_t(x), _t(w)).numpy()[0, :, :, 0]
    # a corner sees 4 of +1 and 5 pad values of -1
    assert got[0, 0] == -1.0 and got[1, 1] == 9.0 and got[0, 1] == 3.0
    assert np.array_equal(got, np.asarray(R_L.conv_fp(x, w))[0, :, :, 0])


def test_maxpool_fp_splits_the_gradient_among_tied_maxima():
    x = np.array([[1.0, 3.0], [3.0, 0.0]], np.float32).reshape(1, 2, 2, 1)
    cot = np.ones((1, 1, 1, 1), np.float32)
    want, (wg,) = _jax_vjp(R_L.maxpool_fp, (x,), cot)
    got, (gg,) = _torch_vjp(T_L.maxpool_fp, (x,), cot)
    assert got.ravel().tolist() == [3.0] and np.array_equal(got, want)
    assert gg.ravel().tolist() == [0.0, 0.5, 0.5, 0.0]
    assert np.array_equal(gg, wg)
    # F.max_pool2d would route it all to one maximum
    xt = _t(x, grad=True)
    (mp,) = torch.autograd.grad(
        torch.nn.functional.max_pool2d(xt.permute(0, 3, 1, 2), 2).sum(), xt)
    assert mp.ravel().tolist() != gg.ravel().tolist()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_maxpool_fp_with_planted_ties_equals_reference(seed):
    """Integer-valued inputs from {-2..2}: most windows hold ties of 2,
    3 or 4 maxima."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-2, 3, (3, 6, 8, 5)).astype(np.float32)
    x[0, :2, :2, 0] = 1.0                                # a 4-way tie
    cot = rng.standard_normal((3, 3, 4, 5)).astype(np.float32)
    want, (wg,) = _jax_vjp(R_L.maxpool_fp, (x,), cot)
    got, (gg,) = _torch_vjp(T_L.maxpool_fp, (x,), cot)
    assert np.array_equal(got, want)
    assert np.array_equal(gg, wg)
    assert np.allclose(gg[0, :2, :2, 0], cot[0, 0, 0, 0] / 4)


def _bn_params(rng, c):
    return {
        "gamma": rng.uniform(-1.5, 1.5, c).astype(np.float32),
        "beta": rng.normal(0, 0.5, c).astype(np.float32),
        "mean": rng.normal(0, 2, c).astype(np.float32),
        "var": rng.uniform(4, 40, c).astype(np.float32),
    }


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("shape", [(4, 3, 3, 8), (16, 40)])
def test_step_fp_and_gradients_equal_reference(train, shape):
    rng = np.random.default_rng(len(shape) * 10 + train)
    c = shape[-1]
    x = rng.integers(-20, 21, shape).astype(np.float32)   # conv-like ints
    p = _bn_params(rng, c)
    cot = rng.standard_normal(shape).astype(np.float32)
    keys = ("gamma", "beta")

    def r_fn(x, gamma, beta):
        return R_L.step_fp(x, {**p, "gamma": gamma, "beta": beta},
                           train=train)[0]

    def t_fn(x, gamma, beta):
        tp = {k: _t(v) for k, v in p.items()}
        return T_L.step_fp(x, {**tp, "gamma": gamma, "beta": beta},
                           train=train)[0]

    args = (x, *(p[k] for k in keys))
    want, wgs = _jax_vjp(r_fn, args, cot)
    got, ggs = _torch_vjp(t_fn, args, cot)
    assert np.array_equal(got, want)
    for gg, wg in zip(ggs, wgs):
        _close(gg, wg)
    _, r_state = R_L.step_fp(jnp.asarray(x), p, train=train)
    _, t_state = T_L.step_fp(_t(x), {k: _t(v) for k, v in p.items()},
                             train=train)
    for k in ("mean", "var"):
        _close(t_state[k].numpy(), r_state[k],
               rtol=VAR_RTOL if k == "var" else RTOL)
        assert not t_state[k].requires_grad


def test_step_fp_uses_the_population_variance():
    x = _t(np.arange(8, dtype=np.float32).reshape(8, 1))
    p = {"gamma": _t([1.0]), "beta": _t([0.0]), "mean": _t([0.0]),
         "var": _t([0.0])}
    _, st_ = T_L.step_fp(x, p, train=True)
    assert st_["var"].item() == pytest.approx(0.1 * np.var(np.arange(8)))
    assert st_["mean"].item() == pytest.approx(0.1 * 3.5)


def test_fc_fp_and_gradients_equal_reference():
    rng = np.random.default_rng(5)
    x = _pm1(rng, (6, 70))
    w = rng.uniform(-1.2, 1.2, (70, 33)).astype(np.float32)
    cot = rng.standard_normal((6, 33)).astype(np.float32)
    want, (wgx, wgw) = _jax_vjp(R_L.fc_fp, (x, w), cot)
    got, (ggx, ggw) = _torch_vjp(T_L.fc_fp, (x, w), cot)
    assert np.array_equal(got, want)
    _close(ggx, wgx)
    _close(ggw, wgw)


def _np_params(params):
    return [{k: np.asarray(v) for k, v in p.items()} for p in params]


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("arch,scale", [("fashion_mnist", 0.25),
                                        ("cifar10", 0.125)])
def test_forward_fp_and_gradients_equal_reference(arch, scale, train):
    """Whole fp-sim forwards from the same params and images: equal
    integer logits, equal BN state, the loss gradient of every trainable
    leaf within the f32 tolerance."""
    rm = R_M.build_model(arch, scale=scale)
    tm = T_M.build_model(arch, scale=scale)
    params = _np_params(rm.init(jax.random.PRNGKey(3)))
    rng = np.random.default_rng(7)
    x01 = rng.random((8, *rm.input_hw, rm.in_channels)).astype(np.float32)
    labels = rng.integers(0, 10, 8).astype(np.int32)

    def r_loss(train_p, bn):
        logits, new = rm.apply_fp(R_L.merge_params(train_p, bn), x01,
                                  train=train)
        return R_T.cross_entropy(logits, labels), (logits, new)

    r_train, r_bn = R_L.split_trainable(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in params])
    (r_l, (r_logits, r_new)), r_g = jax.jit(jax.value_and_grad(
        r_loss, has_aux=True))(r_train, r_bn)

    tp = T_M.fp_params_from_numpy(params, device="cpu")
    t_train, t_bn = T_L.split_trainable(tp)
    flat = [t.requires_grad_(True) for t in leaves(t_train)]
    t_logits, t_new = tm.apply_fp(T_L.merge_params(t_train, t_bn),
                                  torch.from_numpy(x01), train=train)
    t_l = T_T.cross_entropy(t_logits, torch.from_numpy(labels))
    t_g = torch.autograd.grad(t_l, flat)

    assert np.array_equal(t_logits.detach().numpy(), np.asarray(r_logits))
    assert t_l.item() == pytest.approx(float(r_l), rel=RTOL)
    for a, b in zip(t_g, jax.tree.leaves(r_g)):
        _close(a.numpy(), b)
    assert paths(t_new) == paths([{k: 0 for k in p} for p in params])
    for name, a, b in zip(paths(t_new), leaves(t_new),
                          jax.tree.leaves(r_new)):
        _close(a.detach().numpy(), b, name,
               rtol=VAR_RTOL if name.endswith("var") else RTOL)


def test_binarize_input_equals_reference():
    x = np.random.default_rng(0).random((2, 5, 5, 3)).astype(np.float32)
    x[0, 0, 0, 0] = 0.5
    assert np.array_equal(T_L.binarize_input(_t(x)).numpy(),
                          np.asarray(R_L.binarize_input(jnp.asarray(x))))


def test_init_bnn_params_layout_and_ranges():
    m = T_M.build_model("cifar10", scale=0.125)
    gen = torch.Generator().manual_seed(0)
    params = m.init(gen, "cpu")
    ref = R_M.build_model("cifar10", scale=0.125).init(jax.random.PRNGKey(0))
    assert jax.tree.structure(ref) == jax.tree.structure(
        [{k: 0 for k in p} for p in params])
    for p, r in zip(params, ref):
        for k, v in p.items():
            assert tuple(v.shape) == r[k].shape and v.dtype == torch.float32
            if k == "w":
                bound = float(np.abs(np.asarray(r[k])).max())
                assert float(v.abs().max()) <= 1.0001 * bound + 1e-3
    again = m.init(torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(a, b) for a, b in zip(leaves(params),
                                                 leaves(again)))
    t_train, t_state = T_L.split_trainable(params)
    assert T_L.merge_params(t_train, t_state) == params


# ---------------------------------------------------------------------------
# whole train steps from one carried-across TrainState
# ---------------------------------------------------------------------------


def _compare_states(t_state, r_state, lr):
    """Every leaf of the two TrainStates.  Latent weights may differ by
    up to 5 % of one AdamW step (0.05 lr): an element whose gradient is
    rounding noise gets an Adam step of either sign."""
    assert paths(t_state) == _ref_paths(r_state)
    for name, a, b in zip(paths(t_state), leaves(t_state),
                          jax.tree.leaves(r_state)):
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype, name
        if name.endswith("step"):
            assert np.array_equal(a, b), name
        elif name.startswith(".params") and name.endswith("/w"):
            np.testing.assert_allclose(a, b, rtol=0, atol=0.05 * lr,
                                       err_msg=name)
        elif "/m/" in name or "/v/" in name:
            # v squares a gradient: twice the gradient's relative error
            _close(a, b, name, rtol=MOMENT_RTOL)
        else:   # gamma, beta, running mean / var
            _close(a, b, name, rtol=VAR_RTOL if name.endswith("var")
                   else RTOL)


def _ref_paths(tree):
    from repro.ckpt.checkpoint import _tree_paths

    return _tree_paths(tree)


def test_train_steps_equal_reference_after_1_and_5_steps():
    lr = 2e-3
    rm = R_M.build_model("fashion_mnist", scale=0.25)
    tm = T_M.build_model("fashion_mnist", scale=0.25)
    r_state, r_opt = R_T.init_train_state(rm, jax.random.PRNGKey(0), lr=lr)
    t_state = T_T.train_state_from_numpy(r_state, device="cpu")
    t_opt = T_T.adamw(lr)
    _compare_states(t_state, r_state, lr)
    w0 = [p["w"].clone() for p in t_state.params if "w" in p]
    ds = make_image_dataset(0, 512, (28, 28), 1)
    bt = ShardedBatcher(n=512, global_batch=64, seed=0)
    for step in range(5):
        x, y = bt.batch((ds.x, ds.y), step)
        r_state, r_m = R_T.train_step(rm, r_opt, r_state, x, y)
        t_state, t_m = T_T.train_step(tm, t_opt, t_state, x, y)
        for k in ("loss", "grad_norm"):
            assert t_m[k].item() == pytest.approx(float(r_m[k]), rel=RTOL)
        assert t_m["acc"].item() == float(r_m["acc"])
        if step in (0, 4):
            _compare_states(t_state, r_state, lr)
    flips = sum(int((torch.sign(a) != torch.sign(p["w"])).sum())
                for a, p in zip(w0, [p for p in t_state.params if "w" in p]))
    total = sum(a.numel() for a in w0)
    print(f"latent weights that changed sign over 5 steps: {flips} of {total}")
    assert flips > 0


def test_train_state_from_numpy_keeps_paths_dtypes_and_values():
    rm = R_M.build_model("fashion_mnist", scale=0.25)
    r_state, _ = R_T.init_train_state(rm, jax.random.PRNGKey(1))
    t_state = T_T.train_state_from_numpy(r_state, device="cpu")
    assert paths(t_state) == _ref_paths(r_state)
    assert _ref_paths(r_state)[:2] == [".params/0/w", ".params/2/beta"]
    for a, b in zip(leaves(t_state), jax.tree.leaves(r_state)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert t_state.step.dtype == torch.int32 and t_state.step.ndim == 0


def test_training_learns():
    m = T_M.build_model("fashion_mnist", scale=0.25)
    ds = make_image_dataset(0, 512, (28, 28), 1)
    state, opt = T_T.init_train_state(m, torch.Generator().manual_seed(0),
                                      lr=2e-3, device="cpu")
    bt = ShardedBatcher(n=512, global_batch=64, seed=0)
    for step in range(40):
        x, y = bt.batch((ds.x, ds.y), step)
        state, metrics = T_T.train_step(m, opt, state, x, y)
        assert np.isfinite(metrics["loss"].item())
    xe, ye = bt.batch((ds.x, ds.y), 10_001)
    acc = T_T.eval_step(m, state.params, xe, ye).item()
    assert acc > 0.5, f"BNN failed to learn (acc={acc})"
    assert int(state.step) == 40 and int(state.opt.step) == 40


def test_trained_model_packs_and_agrees():
    """Train a few steps, quantize, verify packed inference == fp eval;
    the packed words equal the JAX package's ``pack_params`` of the same
    trained weights."""
    m = T_M.build_model("fashion_mnist", scale=0.25)
    ds = make_image_dataset(1, 256, (28, 28), 1)
    state, opt = T_T.init_train_state(m, torch.Generator().manual_seed(2),
                                      lr=1e-3, device="cpu")
    bt = ShardedBatcher(n=256, global_batch=32, seed=1)
    for step in range(10):
        x, y = bt.batch((ds.x, ds.y), step)
        state, _ = T_T.train_step(m, opt, state, x, y)
    x, _ = bt.batch((ds.x, ds.y), 99)
    with torch.no_grad():
        logits_fp, _ = m.apply_fp(state.params, torch.from_numpy(x),
                                  train=False)
    packed = T_M.pack_params(m.specs, state.params, device="cpu")
    scores = T_M.forward_packed(m.specs, packed,
                                T_M.prepare_input_packed(torch.from_numpy(x)))
    assert np.array_equal(scores.numpy(),
                          logits_fp.numpy().astype(np.int64))
    ref = R_M.pack_params(R_M.build_model("fashion_mnist", scale=0.25).specs,
                          _np_params(state.params))
    for t, r in zip(packed, ref):
        assert t.keys() == r.keys()
        for k in t:
            got = t[k].numpy() if isinstance(t[k], torch.Tensor) else t[k]
            assert np.array_equal(got, np.asarray(r[k])), k


def test_eval_step_equals_reference_on_equal_params():
    rm = R_M.build_model("fashion_mnist", scale=0.25)
    tm = T_M.build_model("fashion_mnist", scale=0.25)
    params = _np_params(rm.init(jax.random.PRNGKey(4)))
    ds = R_images(3, 64, (28, 28), 1)
    x, y = R_Batcher(n=64, global_batch=32, seed=2).batch((ds.x, ds.y), 0)
    want = float(R_T.eval_step(rm, params, x, y))
    got = T_T.eval_step(tm, T_M.fp_params_from_numpy(params, "cpu"), x, y)
    assert got.item() == want


def test_cross_entropy_equals_reference():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((9, 10)) * 30).astype(np.float32)
    labels = rng.integers(0, 10, 9).astype(np.int32)
    want = float(R_T.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    got = T_T.cross_entropy(_t(logits), torch.from_numpy(labels)).item()
    assert got == pytest.approx(want, rel=1e-6)
