"""The port's training substrate against the JAX package: optimizers,
schedules, gradient clipping and compression, checkpoints (written by
either package, restored by the other), the fault-tolerant loop and the
synthetic data.  Inputs are NumPy-seeded and given to both packages.

Tolerances: the optimizers and schedules are elementwise float32
arithmetic in the same order as the reference, except for ``pow`` and
``cos``, whose last bit may differ between libraries: relative 1e-6.
Global norms sum in another order: relative 1e-6.  Casts to bfloat16
and int8 round half to even in both packages and are held bit-equal;
so are data arrays, batch indices and checkpoint bytes."""

from __future__ import annotations

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from _hypothesis_compat import given, settings, st  # noqa: E402

from repro import ckpt as R_ckpt  # noqa: E402
from repro import optim as R_optim  # noqa: E402
from repro.bnn import models as R_M  # noqa: E402
from repro.bnn import train as R_T  # noqa: E402
from repro.ckpt.checkpoint import _tree_paths  # noqa: E402
from repro.data import ShardedBatcher as R_Batcher  # noqa: E402
from repro.data import make_image_dataset as R_images  # noqa: E402
from repro_torch import ckpt as T_ckpt  # noqa: E402
from repro_torch import optim as T_optim  # noqa: E402
from repro_torch.bnn import models as T_M  # noqa: E402
from repro_torch.bnn import train as T_T  # noqa: E402
from repro_torch.data import (  # noqa: E402
    ShardedBatcher,
    make_image_dataset,
    make_token_stream,
)
from repro_torch.runtime import (  # noqa: E402
    InjectedFailure,
    LoopConfig,
    TrainLoop,
)
from repro_torch.tree import (  # noqa: E402
    flatten,
    from_numpy,
    leaves,
    paths,
    to_numpy,
    tree_map,
    unflatten,
)

RTOL = 1e-6


def _np_tree(shapes, rng):
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _assert_trees_close(t_tree, r_tree, rtol=RTOL, exact=False):
    assert paths(t_tree) == _tree_paths(r_tree)
    for name, a, b in zip(paths(t_tree), leaves(t_tree),
                          jax.tree.leaves(r_tree)):
        a, b = to_numpy(a), np.asarray(b)
        assert a.shape == b.shape, name
        if exact:
            assert a.tobytes() == b.tobytes(), name
        else:
            np.testing.assert_allclose(a.astype(np.float64),
                                       b.astype(np.float64), rtol=rtol,
                                       atol=rtol * float(np.abs(b).max()),
                                       err_msg=name)


# --------------------------- trees ----------------------------------------


def test_tree_paths_and_order_follow_jax():
    tree = {"b": [np.zeros(2), None, {}], "a": (np.ones(1), {"z": 1, "y": 2}),
            "c": T_optim.OptState(step=np.int32(3), inner={"m": [np.ones(3)]})}
    assert paths(tree) == _tree_paths(tree)
    flat, tdef = flatten(tree)
    assert [np.asarray(x).tolist() for x in flat] == [
        np.asarray(x).tolist() for x in jax.tree.leaves(tree)]
    back = unflatten(tdef, flat)
    assert paths(back) == paths(tree) and back["b"][1] is None
    assert isinstance(back["c"], T_optim.OptState)
    with pytest.raises(ValueError, match="structures differ"):
        tree_map(lambda a, b: a, {"a": 1}, {"b": 1})


def test_tree_paths_of_a_bnn_train_state_equal_reference():
    rm = R_M.build_model("fashion_mnist", scale=0.25)
    r_state, _ = R_T.init_train_state(rm, jax.random.PRNGKey(0))
    t_state, _ = T_T.init_train_state(
        T_M.build_model("fashion_mnist", scale=0.25),
        torch.Generator().manual_seed(0), device="cpu")
    got = paths(t_state)
    assert got == _tree_paths(r_state)
    for p in (".params/0/w", ".params/2/gamma", ".params/2/mean",
              ".opt/.step", ".opt/.inner/m/0/w", ".opt/.inner/v/0/w",
              ".step"):
        assert p in got
    assert got.index(".opt/.step") < got.index(".opt/.inner/m/0/w")


# --------------------------- optimizers -----------------------------------


OPTIMIZERS = {
    "adamw": lambda O: O.adamw(0.05),
    "adamw_wd": lambda O: O.adamw(0.05, weight_decay=0.1),
    "adamw_cosine": lambda O: O.adamw(O.cosine_schedule(0.05, 6)),
    "sgd": lambda O: O.sgd(0.1),
    "sgd_momentum": lambda O: O.sgd(0.1, momentum=0.9),
    "sgd_nesterov": lambda O: O.sgd(0.1, momentum=0.9, nesterov=True),
    "lion": lambda O: O.lion(0.02),
    "lion_wd": lambda O: O.lion(0.02, weight_decay=0.5),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_steps_equal_reference(name):
    make = OPTIMIZERS[name]
    rng = np.random.default_rng(len(name))
    params = {"w": rng.standard_normal((3, 4)).astype(np.float32),
              "layers": [{"b": rng.standard_normal(5).astype(np.float32)},
                         {}]}
    r_opt, t_opt = make(R_optim), make(T_optim)
    r_p, t_p = _j(params), _t(params)
    r_s, t_s = r_opt.init(r_p), t_opt.init(t_p)
    _assert_trees_close(t_s, r_s, exact=True)
    for _ in range(6):
        g = {"w": rng.standard_normal((3, 4)).astype(np.float32),
             "layers": [{"b": rng.standard_normal(5).astype(np.float32)}, {}]}
        r_p, r_s = r_opt.update(_j(g), r_s, r_p)
        t_p, t_s = t_opt.update(_t(g), t_s, t_p)
        _assert_trees_close(t_p, r_p)
        _assert_trees_close(t_s, r_s)
    assert int(t_s.step) == 6 and t_s.step.dtype == torch.int32


def test_adamw_bf16_state_equals_reference():
    rng = np.random.default_rng(0)
    r_opt = R_optim.adamw(0.1, state_dtype=jnp.bfloat16)
    t_opt = T_optim.adamw(0.1, state_dtype=torch.bfloat16)
    params = {"w": rng.standard_normal(64).astype(np.float32)}
    r_p, t_p = _j(params), _t(params)
    r_s, t_s = r_opt.init(r_p), t_opt.init(t_p)
    assert t_s.inner["m"]["w"].dtype == torch.bfloat16
    for _ in range(4):
        g = {"w": rng.standard_normal(64).astype(np.float32)}
        r_p, r_s = r_opt.update(_j(g), r_s, r_p)
        t_p, t_s = t_opt.update(_t(g), t_s, t_p)
        assert t_s.inner["v"]["w"].dtype == torch.bfloat16
        # bf16 moments: the same f32 values rounded half to even
        _assert_trees_close(t_s.inner, r_s.inner, exact=True)
        _assert_trees_close(t_p, r_p)


@pytest.mark.parametrize("name", ["adamw", "sgd_momentum", "sgd_nesterov",
                                  "lion"])
def test_optimizers_converge(name):
    """The reference's own property on the port: 300 steps on a
    quadratic reach its minimum."""
    opt = {"adamw": lambda: T_optim.adamw(0.1),
           "sgd_momentum": lambda: T_optim.sgd(0.1, momentum=0.9),
           "sgd_nesterov": lambda: T_optim.sgd(0.1, momentum=0.9,
                                               nesterov=True),
           "lion": lambda: T_optim.lion(0.02)}[name]()
    target = torch.tensor([1.5, -2.0, 0.5])
    params = {"w": torch.zeros(3)}
    state = opt.init(params)
    for _ in range(300):
        w = params["w"].clone().requires_grad_(True)
        (g,) = torch.autograd.grad(torch.sum((w - target) ** 2), w)
        params, state = opt.update({"w": g}, state, params)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(), atol=0.05)


@pytest.mark.parametrize("scale", [10.0, 0.01])
def test_clip_by_global_norm_equals_reference(scale):
    rng = np.random.default_rng(int(scale * 100))
    g = {"a": (rng.standard_normal((3, 7)) * scale).astype(np.float32),
         "b": [(rng.standard_normal(5) * scale).astype(np.float32)]}
    r_c, r_n = R_optim.clip_by_global_norm(_j(g), 1.0)
    t_c, t_n = T_optim.clip_by_global_norm(_t(g), 1.0)
    assert t_n.item() == pytest.approx(float(r_n), rel=RTOL)
    _assert_trees_close(t_c, r_c)
    total = torch.sqrt(sum((x ** 2).sum() for x in leaves(t_c)))
    assert total.item() <= 1.0 + 1e-5


def test_clip_by_global_norm_promotes_bf16_like_reference():
    """A bfloat16 gradient times the float32 scale is float32 in JAX;
    the port's clip returns the same dtype and the same bits."""
    g = np.random.default_rng(3).standard_normal(64).astype(np.float32) * 3
    r_c, r_n = R_optim.clip_by_global_norm(
        {"a": jnp.asarray(g, jnp.bfloat16)}, 1.0)
    t_c, t_n = T_optim.clip_by_global_norm(
        {"a": torch.from_numpy(g).to(torch.bfloat16)}, 1.0)
    assert r_c["a"].dtype == jnp.float32 and t_c["a"].dtype == torch.float32
    assert t_n.item() == pytest.approx(float(r_n), rel=RTOL)
    np.testing.assert_allclose(t_c["a"].numpy(), np.asarray(r_c["a"]),
                               rtol=RTOL)


def test_schedules_equal_reference():
    pairs = [
        (R_optim.constant_schedule(0.3), T_optim.constant_schedule(0.3)),
        (R_optim.cosine_schedule(1.0, 100), T_optim.cosine_schedule(1.0, 100)),
        (R_optim.cosine_schedule(2e-3, 37, 0.2),
         T_optim.cosine_schedule(2e-3, 37, 0.2)),
        (R_optim.linear_warmup_cosine(1.0, 10, 110),
         T_optim.linear_warmup_cosine(1.0, 10, 110)),
    ]
    for r, t in pairs:
        for s in (0, 1, 5, 9, 10, 11, 36, 37, 50, 100, 110, 150):
            want = float(r(jnp.asarray(s, jnp.int32)))
            got = t(torch.tensor(s, dtype=torch.int32))
            assert got.dtype == torch.float32
            assert got.item() == pytest.approx(want, rel=RTOL, abs=1e-9)


# --------------------------- compression ----------------------------------


def test_bf16_compression_rounds_half_to_even_like_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(256).astype(np.float32)
    # plant exact halfway cases: low 16 bits 0x8000, both parities above
    bits = x.view(np.uint32)
    bits[:64] = (bits[:64] & 0xFFFF0000) | 0x8000
    g = {"w": bits.view(np.float32)}
    r_c, t_c = R_optim.compress_bf16(_j(g)), T_optim.compress_bf16(_t(g))
    assert t_c["w"].dtype == torch.bfloat16
    _assert_trees_close(t_c, r_c, exact=True)
    r_d, t_d = R_optim.decompress_bf16(r_c), T_optim.decompress_bf16(t_c)
    assert t_d["w"].dtype == torch.float32
    _assert_trees_close(t_d, r_d, exact=True)


def test_int8_error_feedback_equals_reference():
    rng = np.random.default_rng(1)
    shapes = {"w": (4, 9), "b": (7,)}
    g0 = _np_tree(shapes, rng)
    r_ef, t_ef = (R_optim.Int8ErrorFeedback.init(_j(g0)),
                  T_optim.Int8ErrorFeedback.init(_t(g0)))
    for _ in range(5):
        g = _np_tree(shapes, rng)
        r_q, r_s, r_ef = r_ef.compress(_j(g))
        t_q, t_s, t_ef = t_ef.compress(_t(g))
        assert t_q["w"].dtype == torch.int8
        _assert_trees_close(t_q, r_q, exact=True)
        _assert_trees_close(t_s, r_s)
        _assert_trees_close(t_ef.residual, r_ef.residual)
        _assert_trees_close(T_optim.Int8ErrorFeedback.decompress(t_q, t_s),
                            R_optim.Int8ErrorFeedback.decompress(r_q, r_s))


def test_int8_error_feedback_unbiased_over_steps():
    g = {"w": torch.tensor([0.3, -0.7, 1.1, 0.01])}
    ef = T_optim.Int8ErrorFeedback.init(g)
    acc = torch.zeros(4)
    n = 200
    for _ in range(n):
        payload, scales, ef = ef.compress(g)
        acc = acc + T_optim.Int8ErrorFeedback.decompress(payload, scales)["w"]
    np.testing.assert_allclose((acc / n).numpy(), g["w"].numpy(), atol=1e-2)


# --------------------------- checkpointing --------------------------------


def _mixed_tree(rng):
    return {
        "a": rng.standard_normal((3, 4)).astype(np.float32),
        "nested": {"b": np.arange(6, dtype=np.int32).reshape(2, 3),
                   "h": rng.standard_normal(5).astype(np.float32)},
        "list": [rng.standard_normal(2).astype(np.float32), {},
                 np.int32(7)],
    }


def test_checkpoint_roundtrip(tmp_path):
    tree = _t(_mixed_tree(np.random.default_rng(0)))
    tree["bf"] = torch.linspace(-3, 3, 9).to(torch.bfloat16)
    T_ckpt.save_checkpoint(tmp_path, 7, tree)
    assert T_ckpt.latest_step(tmp_path) == 7
    back = T_ckpt.restore_checkpoint(tmp_path, 7, tree)
    assert paths(back) == paths(tree)
    for a, b in zip(leaves(tree), leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_detects_corruption(tmp_path):
    tree = {"a": torch.ones(4)}
    p = T_ckpt.save_checkpoint(tmp_path, 1, tree)
    arrs = dict(np.load(p / "arrays.npz"))
    arrs["a0"] = arrs["a0"] + 1
    np.savez(p / "arrays.npz", **arrs)
    with pytest.raises(ValueError, match="checksum"):
        T_ckpt.restore_checkpoint(tmp_path, 1, tree)
    T_ckpt.save_checkpoint(tmp_path, 2, tree)
    with pytest.raises(ValueError, match="shape"):
        T_ckpt.restore_checkpoint(tmp_path, 2, {"a": torch.ones(5)})
    with pytest.raises(KeyError, match="missing leaf"):
        T_ckpt.restore_checkpoint(tmp_path, 2, {"b": torch.ones(4)})


@pytest.mark.parametrize("async_save", [False, True])
def test_checkpoint_keep_n_gc(tmp_path, async_save):
    mgr = T_ckpt.CheckpointManager(tmp_path, save_every=1, keep=2,
                                   async_save=async_save)
    for s in (1, 2, 3, 4, 5):
        mgr.save(s, {"a": torch.full((2,), float(s))})
    mgr.wait()
    steps = sorted(int(p.name.split("_")[1]) for p in tmp_path.iterdir())
    assert steps == [4, 5]
    step, back = mgr.restore_latest({"a": torch.zeros(2)})
    assert step == 5 and back["a"].tolist() == [5.0, 5.0]


def test_async_save_takes_its_host_copy_before_returning(tmp_path):
    mgr = T_ckpt.CheckpointManager(tmp_path, save_every=1, async_save=True)
    t = torch.zeros(3)
    mgr.save(1, {"a": t})
    t.fill_(9.0)                    # the caller reuses its tensor at once
    _, back = mgr.restore_latest({"a": torch.ones(3)})
    assert back["a"].tolist() == [0.0, 0.0, 0.0]


def test_checkpoint_tmp_never_visible(tmp_path):
    T_ckpt.save_checkpoint(tmp_path, 3, {"a": torch.zeros(3)})
    assert not list(tmp_path.glob("*.tmp-*"))
    assert T_ckpt.latest_step(tmp_path / "absent") is None


def test_two_writers_of_one_step_in_one_process_both_land(tmp_path,
                                                          monkeypatch):
    """A relaunch in the same process may save a step while the crashed
    run's async write of that step is still in flight: each writer
    needs a tmp dir of its own.  Both writers are held until each has
    made its tmp dir."""
    import threading

    from repro_torch.ckpt import checkpoint as C

    barrier = threading.Barrier(2, timeout=30)
    real_savez = np.savez

    def savez(path, **arrays):
        barrier.wait()
        real_savez(path, **arrays)

    monkeypatch.setattr(C.np, "savez", savez)
    errors = []

    def write(v):
        try:
            C.save_checkpoint(tmp_path, 2, {"a": torch.full((3,), v)})
        except Exception as e:      # collected and asserted below
            errors.append(e)

    threads = [threading.Thread(target=write, args=(float(v),))
               for v in (1, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    back = C.restore_checkpoint(tmp_path, 2, {"a": torch.zeros(3)})
    assert back["a"].tolist() in ([1.0] * 3, [2.0] * 3)
    assert not list(tmp_path.glob("*.tmp-*"))


def _manifest(path):
    return json.loads((path / "manifest.json").read_text())


def test_checkpoint_written_by_either_package_restores_in_the_other(tmp_path):
    rng = np.random.default_rng(3)
    tree_np = _mixed_tree(rng)
    r_tree = _j(tree_np)
    r_tree["bf"] = jnp.linspace(-3, 3, 9).astype(jnp.bfloat16)
    t_tree = _t(tree_np)
    t_tree["bf"] = torch.from_numpy(
        np.array(r_tree["bf"]).view(np.int16)).view(torch.bfloat16)
    r_path = R_ckpt.save_checkpoint(tmp_path / "jax", 4, r_tree)
    t_path = T_ckpt.save_checkpoint(tmp_path / "torch", 4, t_tree)
    # the same tree written by each package: equal manifests
    assert _manifest(t_path) == _manifest(r_path)
    written = [m["path"] for m in _manifest(t_path)["leaves"]]
    assert written == _tree_paths(r_tree)
    like_t = tree_map(torch.zeros_like, t_tree)
    got = T_ckpt.restore_checkpoint(tmp_path / "jax", 4, like_t)
    assert got["bf"].dtype == torch.bfloat16
    _assert_trees_close(got, r_tree, exact=True)
    like_r = jax.tree.map(jnp.zeros_like, r_tree)
    back = R_ckpt.restore_checkpoint(tmp_path / "torch", 4, like_r)
    _assert_trees_close(t_tree, back, exact=True)


def test_train_state_checkpoint_crosses_packages(tmp_path):
    rm = R_M.build_model("fashion_mnist", scale=0.25)
    tm = T_M.build_model("fashion_mnist", scale=0.25)
    r_state, r_opt = R_T.init_train_state(rm, jax.random.PRNGKey(0))
    ds = R_images(0, 64, (28, 28), 1)
    x, y = R_Batcher(n=64, global_batch=16, seed=0).batch((ds.x, ds.y), 0)
    r_state, _ = R_T.train_step(rm, r_opt, r_state, x, y)
    t_state, _ = T_T.init_train_state(tm, torch.Generator().manual_seed(5),
                                      device="cpu")
    # JAX writes, the port restores into its own TrainState
    R_ckpt.save_checkpoint(tmp_path / "jax", 1, r_state)
    got = T_ckpt.restore_checkpoint(tmp_path / "jax", 1, t_state)
    assert isinstance(got, T_T.TrainState)
    _assert_trees_close(got, r_state, exact=True)
    assert int(got.step) == 1 and int(got.opt.step) == 1
    # the port writes (a state carried across), JAX restores
    carried = T_T.train_state_from_numpy(r_state, device="cpu")
    t_path = T_ckpt.save_checkpoint(tmp_path / "torch", 1, carried)
    assert _manifest(t_path) == _manifest(tmp_path / "jax" / "step_1")
    back = R_ckpt.restore_checkpoint(tmp_path / "torch", 1, r_state)
    _assert_trees_close(carried, back, exact=True)


# --------------------------- failure recovery -----------------------------


def _toy_loop(tmp_path, inject_at=None, total=12):
    opt = T_optim.adamw(0.05)
    target = torch.tensor([2.0, -1.0])

    def loss(w, batch):
        return torch.sum((w - target) ** 2) + 0.0 * torch.sum(batch)

    def step_fn(state, batch):
        params, ost = state
        w = params["w"].clone().requires_grad_(True)
        (g,) = torch.autograd.grad(loss(w, batch), w)
        params, ost = opt.update({"w": g}, ost, params)
        return (params, ost), {"loss": loss(params["w"], batch)}

    params = {"w": torch.zeros(2)}
    cfg = LoopConfig(total_steps=total, ckpt_dir=str(tmp_path / "ckpt"),
                     save_every=4, inject_failure_at=inject_at)
    return TrainLoop(step_fn, lambda s: torch.ones(2) * s,
                     (params, opt.init(params)), cfg)


def test_loop_recovers_identically_after_failure(tmp_path):
    ref = _toy_loop(tmp_path / "ref")
    ref_out = ref.run()
    crash = _toy_loop(tmp_path / "crash", inject_at=6)
    with pytest.raises(InjectedFailure):
        crash.run()
    resumed = _toy_loop(tmp_path / "crash")
    out = resumed.run()
    assert resumed.start_step in (4, 8)
    assert torch.equal(resumed.state[0]["w"], ref.state[0]["w"])
    assert out["final_step"] == ref_out["final_step"]
    assert [r["loss"] for r in out["metrics"]] == [
        r["loss"] for r in ref_out["metrics"]][resumed.start_step:]


def _bnn_loop(tmp_path, inject_at=None, total=6):
    m = T_M.build_model("fashion_mnist", scale=0.25)
    state, opt = T_T.init_train_state(m, torch.Generator().manual_seed(0),
                                      lr=2e-3, device="cpu")
    ds = make_image_dataset(0, 128, (28, 28), 1)
    bt = ShardedBatcher(n=128, global_batch=16, seed=0)
    cfg = LoopConfig(total_steps=total, ckpt_dir=str(tmp_path / "ckpt"),
                     save_every=2, async_save=True,
                     inject_failure_at=inject_at)
    return TrainLoop(
        lambda s, b: T_T.train_step(m, opt, s, *b),
        lambda step: bt.batch((ds.x, ds.y), step), state, cfg)


def test_bnn_train_loop_resumes_to_the_uninterrupted_state(tmp_path):
    ref = _bnn_loop(tmp_path / "ref")
    ref_out = ref.run()
    crash = _bnn_loop(tmp_path / "crash", inject_at=3)
    with pytest.raises(InjectedFailure):
        crash.run()
    crash.mgr.wait()            # the crashed run's async write lands first
    resumed = _bnn_loop(tmp_path / "crash")
    out = resumed.run()
    assert resumed.start_step == 2
    assert paths(resumed.state) == paths(ref.state)
    for a, b in zip(leaves(resumed.state), leaves(ref.state)):
        assert torch.equal(a, b)
    assert [r["loss"] for r in out["metrics"]] == [
        r["loss"] for r in ref_out["metrics"]][2:]


def test_loop_flags_a_straggling_step(tmp_path, monkeypatch):
    """The watchdog on a scripted clock: the loop's ``time.perf_counter``
    advances only inside the step, 25 ticks for step 4 and 1 for every
    other, so the flags depend on the script, not on the host's speed.
    The JAX package's loop runs the same script and flags the same
    steps."""
    import types

    from repro.runtime import TrainLoop as R_TrainLoop
    from repro.runtime import loop as R_loop
    from repro.runtime.loop import LoopConfig as R_LoopConfig
    from repro_torch.runtime import loop as T_loop

    now = [0.0]
    clock = types.SimpleNamespace(perf_counter=lambda: now[0])
    monkeypatch.setattr(T_loop, "time", clock)
    monkeypatch.setattr(R_loop, "time", clock)

    def run(loop_cls, cfg_cls, state, metric, name):
        seen = []

        def step_fn(state, batch):
            now[0] += 0.025 if batch == 4 else 0.001
            return state, {"loss": metric(float(batch))}

        cfg = cfg_cls(total_steps=6, ckpt_dir=str(tmp_path / name),
                      save_every=100)
        out = loop_cls(step_fn, lambda s: s, state, cfg,
                       on_straggler=lambda step, dt: seen.append(step)).run()
        return seen, [r["straggler"] for r in out["metrics"]]

    seen, flags = run(TrainLoop, LoopConfig, {"w": torch.zeros(1)},
                      torch.tensor, "port")
    assert seen == [4]
    assert flags == [False] * 4 + [True, False]
    assert run(R_TrainLoop, R_LoopConfig, {"w": jnp.zeros(1)}, jnp.asarray,
               "ref") == (seen, flags)


# --------------------------- data pipeline --------------------------------


@settings(max_examples=25, deadline=None)
@given(step=st.integers(0, 10_000), seed=st.integers(0, 2**31 - 1),
       shards=st.sampled_from([1, 2, 4]))
def test_batcher_indices_equal_reference(step, seed, shards):
    for i in range(shards):
        kw = dict(n=1000, global_batch=32, seed=seed, shard_index=i,
                  num_shards=shards)
        got = ShardedBatcher(**kw).indices(step)
        assert np.array_equal(got, R_Batcher(**kw).indices(step))
        assert np.array_equal(got, ShardedBatcher(**kw).indices(step))


def test_batcher_shards_partition_global_batch():
    shards = [ShardedBatcher(n=100, global_batch=16, seed=1, shard_index=i,
                             num_shards=4) for i in range(4)]
    full = ShardedBatcher(n=100, global_batch=16, seed=1)
    got = np.concatenate([s.indices(5) for s in shards])
    assert np.array_equal(got, full.indices(5))
    with pytest.raises(ValueError, match="divide evenly"):
        ShardedBatcher(n=10, global_batch=10, num_shards=3)


@pytest.mark.parametrize("args", [(0, 64, (28, 28), 1), (3, 16, (32, 32), 3),
                                  (1, 5, (4, 6), 2, 3, 0.1)])
def test_image_dataset_equals_reference(args):
    got, want = make_image_dataset(*args), R_images(*args)
    assert np.array_equal(got.x, want.x) and got.x.dtype == want.x.dtype
    assert np.array_equal(got.y, want.y) and got.y.dtype == want.y.dtype
    assert got.n_classes == want.n_classes


def test_token_stream_resumable_and_step_dependent():
    sample = make_token_stream(0, vocab=50, order=1)
    a = sample(3, 4, 16)
    assert a.dtype == torch.int32 and tuple(a.shape) == (4, 16)
    assert torch.equal(a, sample(3, 4, 16))
    assert torch.equal(a, make_token_stream(0, vocab=50, order=1)(3, 4, 16))
    assert not torch.equal(a, sample(4, 4, 16))
    other_seed = make_token_stream(1, vocab=50, order=1)
    assert not torch.equal(a, other_seed(3, 4, 16))
    assert int(a.max()) < 50 and int(a.min()) >= 0


def test_token_stream_has_learnable_structure():
    """Order 1: the next token depends on the last one through a fixed
    law, far from uniform at temperature 0.5."""
    vocab = 20
    sample = make_token_stream(2, vocab=vocab, order=1)
    toks = torch.cat([sample(s, 8, 64) for s in range(4)]).numpy()
    counts = np.zeros((vocab, vocab))
    for row in toks:
        np.add.at(counts, (row[:-1], row[1:]), 1)
    seen = counts.sum(1) >= 20
    top = (counts[seen].max(1) / counts[seen].sum(1)).mean()
    assert top > 3.0 / vocab
    # the same context gives the same law in another step and row
    b = make_token_stream(2, vocab=vocab, order=2)(0, 2, 8)
    assert tuple(b.shape) == (2, 8)


def test_numpy_conversions_keep_bfloat16_bits():
    t = torch.tensor([1.0, -2.5, 3.140625]).to(torch.bfloat16)
    arr = to_numpy(t)
    assert arr.dtype == np.dtype("V2")
    assert torch.equal(from_numpy(arr, "cpu", "bfloat16"), t)
    assert torch.equal(from_numpy(np.asarray(jnp.asarray(
        [1.0, -2.5, 3.140625], jnp.bfloat16)), "cpu"), t)
