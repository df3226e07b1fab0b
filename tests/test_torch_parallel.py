"""The port's sharding layer (``repro_torch.parallel``, the shape specs)
against the JAX package's, as pure logic on the CPU.

* ``_param_spec`` through ``make_param_shardings`` /
  ``make_opt_shardings``: every leaf of all ten full configs, from the
  port's ``meta`` specs against the reference's ``param_specs``, on the
  production meshes {data 16, model 16} and {pod 2, data 16, model 16}
  and on {data 2, model 2}, under ``default_scheme`` and the
  hillclimb's scheme variants;
* ``make_batch_shardings`` for every ``SHAPES`` cell a config supports,
  and ``make_cache_shardings`` with and without ``allow_hd``;
* ``batch_axes``, ``pick_batch_axes``, ``default_scheme``, the shape
  specs (``param_specs``, ``cache_specs``, ``input_specs``);
* ``constrain``, ``pin_batch``, ``constrain_kv`` and ``constrain_ssd``:
  the spec the port resolves equals the one the reference passes to
  ``with_sharding_constraint``, on a one-device JAX mesh and on the
  fake meshes of ``tests/test_launch_parallel.py``.

The reference plans against fake meshes (axis names and a ``devices``
array, as in ``tests/test_launch_parallel.py``), with its
``NamedSharding`` replaced by a recorder through ``monkeypatch``; the
port plans against ``launch.mesh.abstract_mesh`` of the same sizes.
Specs are compared entry for entry; nothing in the JAX package
changes."""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import configs as R_C  # noqa: E402
from repro.models import transformer as R_T  # noqa: E402
from repro.parallel import constrain as R_CON  # noqa: E402
from repro.parallel import sharding as R_SH  # noqa: E402
from repro_torch import configs as T_C  # noqa: E402
from repro_torch import tree as T_tree  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    abstract_mesh,
    make_production_mesh,
)
from repro_torch.models import transformer as T_T  # noqa: E402
from repro_torch.parallel import constrain as T_CON  # noqa: E402
from repro_torch.parallel import sharding as T_SH  # noqa: E402

MESHES = {
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
    "2x2": {"data": 2, "model": 2},
}
# default_scheme(cfg) with these fields replaced: the hillclimb's
# variants (src/repro/launch/hillclimb.py) and the knobs they combine
VARIANTS = {
    "default": {},
    "attn_tp_off": {"attn_tp": False},
    "attn_kv_parallel": {"attn_kv_parallel": True},
    "decode_replicate_batch": {"decode_replicate_batch": True},
    "out_proj_contracting_2d": {"out_proj_contracting_2d": True},
    "moe_e_over_data": {"moe_e_over_data": True},
    "tp_zero3": {"tp": True, "fsdp": "zero3"},
    "tp_zero3_e_over_data": {"tp": True, "fsdp": "zero3",
                             "moe_e_over_data": True},
    "zero3_ep_2d": {"tp": True, "fsdp": "zero3", "expert_mode": "ep",
                    "out_proj_contracting_2d": True},
    "expert_tp_seq": {"expert_mode": "tp", "seq_over_model": True,
                      "batch_over_model": False},
}


def fake_mesh(**axis_sizes):
    """axis_names + devices.shape is all the pure helpers consult."""
    return SimpleNamespace(
        axis_names=tuple(axis_sizes),
        devices=np.zeros(tuple(axis_sizes.values())),
    )


def _meshes(name):
    sizes = MESHES[name]
    return fake_mesh(**sizes), abstract_mesh(tuple(sizes.values()),
                                             tuple(sizes))


class _Recorded:
    """What the reference's NamedSharding is replaced by: a leaf of its
    trees that keeps the spec."""

    def __init__(self, mesh, spec):
        self.spec = spec


@pytest.fixture
def ref_sh(monkeypatch):
    monkeypatch.setattr(R_SH, "NamedSharding", _Recorded)
    return R_SH


def _schemes(arch, variant):
    r_cfg, t_cfg = R_C.get(arch), T_C.get(arch)
    r = dataclasses.replace(R_SH.default_scheme(r_cfg), **VARIANTS[variant])
    t = dataclasses.replace(T_SH.default_scheme(t_cfg), **VARIANTS[variant])
    assert dataclasses.astuple(r) == dataclasses.astuple(t)
    return r_cfg, t_cfg, r, t


def _r_specs(tree) -> list:
    return [tuple(s.spec) for s in jax.tree.leaves(tree)]


def _t_specs(tree) -> list:
    out = T_tree.leaves(tree)
    assert all(isinstance(s, T_SH.NamedSharding) for s in out)
    return [tuple(s.spec) for s in out]


_R_PARAMS: dict = {}


def _ref_param_specs(arch):
    if arch not in _R_PARAMS:
        _R_PARAMS[arch] = R_T.param_specs(R_C.get(arch))
    return _R_PARAMS[arch]


# ---------------------------------------------------------------------------
# shape specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", R_C.ARCH_NAMES)
def test_param_specs_are_meta_tensors_of_the_reference_shapes(arch):
    t = T_T.param_specs(T_C.get(arch))
    r = _ref_param_specs(arch)
    r_paths = ["/".join(str(k.key) for k in p)
               for p, _ in jax.tree_util.tree_flatten_with_path(r)[0]]
    assert T_tree.paths(t) == r_paths
    for a, b in zip(T_tree.leaves(t), jax.tree.leaves(r)):
        assert a.device.type == "meta"
        assert tuple(a.shape) == b.shape and str(a.dtype)[6:] == str(b.dtype)


@pytest.mark.parametrize("arch", R_C.ARCH_NAMES)
def test_input_specs_equal_reference_for_every_cell(arch):
    r_cfg, t_cfg = R_C.get(arch), T_C.get(arch)
    for shape in R_C.SHAPES:
        if not R_C.cell_supported(r_cfg, shape):
            continue
        r = R_C.input_specs(r_cfg, shape)
        t = T_C.input_specs(t_cfg, shape)
        assert T_tree.paths(t) == ["/".join(str(k.key) for k in p) for p, _
                                   in jax.tree_util.tree_flatten_with_path(
                                       r)[0]]
        assert list(t) == list(r)
        for a, b in zip(T_tree.leaves(t), jax.tree.leaves(r)):
            assert a.device.type == "meta", shape
            assert tuple(a.shape) == b.shape, shape
            assert str(a.dtype)[6:] == str(b.dtype), shape


def test_cache_specs_len_is_a_0d_int32_meta_tensor():
    c = T_T.cache_specs(T_C.get("zamba2_7b"), 4, 32_768)
    assert c["len"].shape == () and c["len"].dtype == torch.int32
    assert all(v.device.type == "meta" for v in c.values())
    assert set(c) == {"conv_x", "conv_bc", "ssd", "k", "v", "len"}


def test_grok_param_specs_allocate_nothing():
    specs = T_T.param_specs(T_C.get("grok_1_314b"))
    n = sum(t.numel() for t in T_tree.leaves(specs))
    assert n > 3e11
    assert all(t.device.type == "meta" for t in T_tree.leaves(specs))


# ---------------------------------------------------------------------------
# param / opt / batch / cache shardings
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", R_C.ARCH_NAMES)
def test_param_and_opt_specs_equal_reference(ref_sh, arch, mesh, variant):
    r_cfg, t_cfg, r_s, t_s = _schemes(arch, variant)
    r_mesh, t_mesh = _meshes(mesh)
    r_tree = _ref_param_specs(arch)
    t_tree = T_T.param_specs(t_cfg)
    want = _r_specs(ref_sh.make_param_shardings(r_cfg, r_mesh, r_tree, r_s))
    got = _t_specs(T_SH.make_param_shardings(t_cfg, t_mesh, t_tree, t_s))
    assert got == want
    for kind in ("adamw", "sgd"):
        want = _r_specs(ref_sh.make_opt_shardings(r_cfg, r_mesh, r_tree, r_s,
                                                  kind=kind))
        got = _t_specs(T_SH.make_opt_shardings(t_cfg, t_mesh, t_tree, t_s,
                                               kind=kind))
        assert got == want, kind


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", R_C.ARCH_NAMES)
def test_batch_and_cache_specs_equal_reference(ref_sh, arch, mesh, variant):
    r_cfg, t_cfg, r_s, t_s = _schemes(arch, variant)
    r_mesh, t_mesh = _meshes(mesh)
    for shape in R_C.SHAPES:
        if not R_C.cell_supported(r_cfg, shape):
            continue
        r_in = R_C.input_specs(r_cfg, shape)
        t_in = T_C.input_specs(t_cfg, shape)
        want = _r_specs(ref_sh.make_batch_shardings(r_cfg, r_mesh, r_in, r_s))
        got = _t_specs(T_SH.make_batch_shardings(t_cfg, t_mesh, t_in, t_s))
        assert got == want, shape
        if "cache" in r_in:
            for hd in (True, False):
                want = _r_specs(ref_sh.make_cache_shardings(
                    r_cfg, r_mesh, r_in["cache"], r_s, allow_hd=hd))
                got = _t_specs(T_SH.make_cache_shardings(
                    t_cfg, t_mesh, t_in["cache"], t_s, allow_hd=hd))
                assert got == want, (shape, hd)


@pytest.mark.parametrize("arch", R_C.ARCH_NAMES)
def test_param_spec_leaf_by_leaf_equals_reference(arch):
    """``_param_spec`` called directly on each (path, shape), the
    reference's key paths against the port's path parts, both force_zero3
    settings, every mesh and variant."""
    r_tree = _ref_param_specs(arch)
    r_leaves = jax.tree_util.tree_flatten_with_path(r_tree)[0]
    t_paths = []
    T_tree.tree_map_with_path(lambda p, x: t_paths.append(p),
                              T_T.param_specs(T_C.get(arch)))
    for variant in VARIANTS:
        r_cfg, t_cfg, r_s, t_s = _schemes(arch, variant)
        for sizes in MESHES.values():
            r_em = r_s.resolve_expert_mode(r_cfg, sizes["model"])
            t_em = t_s.resolve_expert_mode(t_cfg, sizes["model"])
            assert r_em == t_em
            for (r_path, leaf), t_path in zip(r_leaves, t_paths):
                for z3 in (False, True):
                    want = R_SH._param_spec(r_path, leaf.shape, r_cfg, r_s,
                                            sizes, r_em, force_zero3=z3)
                    got = T_SH._param_spec(t_path, leaf.shape, t_cfg, t_s,
                                           sizes, t_em, force_zero3=z3)
                    assert tuple(got) == tuple(want), (t_path, variant)


def test_opt_shardings_replicate_the_step_and_refuse_an_unknown_kind(
        ref_sh):
    cfg = T_C.get_smoke("olmo_1b")
    tree = T_T.param_specs(cfg)
    mesh = abstract_mesh((1, 1))
    opt = T_SH.make_opt_shardings(cfg, mesh, tree, kind="adamw")
    assert opt.step.spec == T_SH.P()
    assert set(opt.inner) == {"m", "v"}
    sgd = T_SH.make_opt_shardings(cfg, mesh, tree, kind="sgd")
    assert T_tree.paths(sgd.inner) == T_tree.paths(tree)
    with pytest.raises(ValueError):
        T_SH.make_opt_shardings(cfg, mesh, tree, kind="adafactor")
    with pytest.raises(ValueError):
        ref_sh.make_opt_shardings(R_C.get_smoke("olmo_1b"), fake_mesh(
            data=1, model=1), R_T.param_specs(R_C.get_smoke("olmo_1b")),
            kind="adafactor")


def test_decode_replicate_batch_pins_token_replicated():
    cfg = T_C.get_smoke("olmo_1b")
    specs = T_C.input_specs(cfg, "decode_32k")
    scheme = T_SH.ShardScheme(decode_replicate_batch=True)
    sh = T_SH.make_batch_shardings(cfg, abstract_mesh((16, 16)), specs,
                                   scheme)
    assert sh["token"].spec == T_SH.P()
    assert sh["cache"]["len"].spec == T_SH.P()


# ---------------------------------------------------------------------------
# schemes and batch axes
# ---------------------------------------------------------------------------


def test_shard_scheme_fields_and_defaults_equal_reference():
    r = [(f.name, f.default) for f in dataclasses.fields(R_SH.ShardScheme)]
    t = [(f.name, f.default) for f in dataclasses.fields(T_SH.ShardScheme)]
    assert t == r
    assert dataclasses.astuple(T_SH.ShardScheme()) == dataclasses.astuple(
        R_SH.ShardScheme())


@pytest.mark.parametrize("arch", R_C.ARCH_NAMES)
def test_default_scheme_and_expert_mode_equal_reference(arch):
    r = R_SH.default_scheme(R_C.get(arch))
    t = T_SH.default_scheme(T_C.get(arch))
    assert dataclasses.astuple(t) == dataclasses.astuple(r)
    for m in (1, 2, 7, 16):
        for mode in ("auto", "ep", "tp"):
            assert (T_SH.ShardScheme(expert_mode=mode).resolve_expert_mode(
                T_C.get(arch), m) == R_SH.ShardScheme(
                expert_mode=mode).resolve_expert_mode(R_C.get(arch), m))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_axes_equal_reference(mesh):
    r_mesh, t_mesh = _meshes(mesh)
    for bom in (False, True):
        r_s = R_SH.ShardScheme(batch_over_model=bom)
        t_s = T_SH.ShardScheme(batch_over_model=bom)
        for batch in (1, 2, 3, 4, 16, 32, 128, 256, 512, 1024):
            assert T_SH.batch_axes(t_mesh, t_s, batch) == R_SH.batch_axes(
                r_mesh, r_s, batch), (bom, batch)


def test_batch_axes_prefers_largest_dividing_subset():
    mesh = abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    folded = T_SH.ShardScheme(batch_over_model=True)
    assert T_SH.batch_axes(mesh, folded, 512) == ("pod", "data", "model")
    assert T_SH.batch_axes(mesh, folded, 256) == ("data", "model")
    assert T_SH.batch_axes(mesh, T_SH.ShardScheme(), 3) == ()


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_pick_batch_axes_equal_reference_under_each_scheme(mesh):
    sizes = MESHES[mesh]
    for kw in ({}, {"batch_over_model": True},
               {"decode_replicate_batch": True}):
        with R_CON.scheme_context(R_SH.ShardScheme(**kw)), \
                T_CON.scheme_context(T_SH.ShardScheme(**kw)):
            for dim in (1, 2, 4, 16, 32, 128, 256, 512, 3):
                assert T_CON.pick_batch_axes(dim, sizes) == \
                    R_CON.pick_batch_axes(dim, sizes), (kw, dim)


def test_scheme_context_sets_and_restores_the_knobs():
    s = T_SH.ShardScheme(sp_residual=True, attn_kv_parallel=True)
    with T_CON.scheme_context(s):
        assert T_CON.sp_residual_enabled()
        assert T_CON.attn_kv_parallel_enabled()
        with T_CON.batch_over_model(True):
            assert T_CON.pick_batch_axes(32, {"data": 2, "model": 2}) == (
                "data", "model")
    assert not T_CON.sp_residual_enabled()
    assert not T_CON.attn_kv_parallel_enabled()


# ---------------------------------------------------------------------------
# constrain: the resolved spec against what the reference constrains to
# ---------------------------------------------------------------------------

# (function, shape, spec args, scheme knobs)
CONSTRAIN_CASES = {
    "moe-buf": ("constrain", (32, 64, 40, 128, 7),
                (("pod", "data"), "model", None, None), {}),
    "moe-buf-odd-experts": ("constrain", (32, 6, 40, 128, 7),
                            (("pod", "data"), "model", None, None), {}),
    "kv-parts": ("constrain", (4, 16, 128, 2, 64),
                 (("pod", "data"), "model", None, None, None), {}),
    "conv-copy": ("constrain", (8, 4, 896),
                  (("pod", "data"), None, "model"), {}),
    "unknown-axis": ("constrain", (8, 32), ("pod", ("model", "expert")),
                     {}),
    "indivisible-batch": ("constrain", (3, 64), (("pod", "data"), "model"),
                          {}),
    "residual": ("pin_batch", (256, 4096, 896), (None, None), {}),
    "residual-folded": ("pin_batch", (256, 4096, 896), (None, None),
                        {"batch_over_model": True}),
    "residual-sp": ("pin_batch", (32, 4096, 896), ("model", None),
                    {"sp_residual": True}),
    "residual-odd-batch": ("pin_batch", (6, 100, 896), ("model", None), {}),
    "residual-decode-replicated": ("pin_batch", (128, 1, 896), (None, None),
                                   {"decode_replicate_batch": True}),
    "kv-heads": ("constrain_kv", (32, 4096, 16, 128), (), {}),
    "kv-few-heads": ("constrain_kv", (32, 4096, 2, 64), (), {}),
    "kv-not-4d": ("constrain_kv", (32, 4096, 64), (), {}),
    "ssd-heads": ("constrain_ssd", (32, 48, 64, 128), (), {}),
    "ssd-head-dim": ("constrain_ssd", (32, 24, 64, 128), (), {}),
    "ssd-neither": ("constrain_ssd", (32, 24, 20, 128), (), {}),
    "ssd-not-4d": ("constrain_ssd", (32, 24, 64), (), {}),
}


def _ref_constrained(monkeypatch, name, mesh):
    """The specs the reference hands ``with_sharding_constraint`` in one
    call of the case's function with `mesh` (a fake mesh) ambient."""
    fn, shape, args, knobs = CONSTRAIN_CASES[name]
    got = []
    monkeypatch.setattr(R_CON, "_ambient_mesh", lambda: mesh)
    monkeypatch.setattr(R_CON, "NamedSharding", _Recorded)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, s: got.append(tuple(s.spec)) or x)
    x = SimpleNamespace(shape=shape, ndim=len(shape))
    with R_CON.scheme_context(R_SH.ShardScheme(**knobs)):
        getattr(R_CON, fn)(x, *args)
    return got


def _port_constrained(monkeypatch, name, mesh):
    """The specs the port resolves in one call of the case's function
    with `mesh` ambient (None where it leaves the tensor alone)."""
    fn, shape, args, knobs = CONSTRAIN_CASES[name]
    got = []
    real = T_CON._guarded

    def recording(*a):
        spec = real(*a)
        if spec is not None:
            got.append(tuple(spec))
        return spec

    monkeypatch.setattr(T_CON, "_guarded", recording)
    x = torch.empty(shape, device="meta")
    with T_CON.use_mesh(mesh), \
            T_CON.scheme_context(T_SH.ShardScheme(**knobs)):
        out = getattr(T_CON, fn)(x, *args)
    assert out is x    # a plain tensor is left as it is
    return got


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(CONSTRAIN_CASES))
def test_constrain_resolves_the_reference_spec(monkeypatch, name, mesh):
    r_mesh, t_mesh = _meshes(mesh)
    want = _ref_constrained(monkeypatch, name, r_mesh)
    got = _port_constrained(monkeypatch, name, t_mesh)
    assert got == want
    fn, shape, args, _ = CONSTRAIN_CASES[name]
    if fn == "constrain":
        spec = T_CON.resolved_spec(shape, *args, mesh=t_mesh)
        assert ([] if spec is None else [tuple(spec)]) == want


@pytest.mark.parametrize("name", sorted(CONSTRAIN_CASES))
def test_constrain_on_a_one_device_jax_mesh(monkeypatch, name):
    """The reference under ``with mesh:`` of a real 1 x 1 JAX mesh (its
    ``with_sharding_constraint`` captured), the port under ``use_mesh``
    of a 1 x 1 abstract mesh."""
    fn, shape, args, knobs = CONSTRAIN_CASES[name]
    want = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, s: want.append(tuple(s.spec)) or x)
    x = SimpleNamespace(shape=shape, ndim=len(shape))
    with jax.make_mesh((1, 1), ("data", "model")), \
            R_CON.scheme_context(R_SH.ShardScheme(**knobs)):
        getattr(R_CON, fn)(x, *args)
    got = _port_constrained(monkeypatch, name, abstract_mesh((1, 1)))
    assert got == want


def test_constrain_is_the_identity_without_a_mesh():
    x = torch.zeros((4, 8))
    assert T_CON.constrain(x, "data", "model") is x
    assert T_CON.pin_batch(x, None) is x
    assert T_CON.constrain_kv(x) is x and T_CON.constrain_ssd(x) is x


# ---------------------------------------------------------------------------
# the port's own: placements, abstract meshes
# ---------------------------------------------------------------------------


def test_named_sharding_placements_follow_the_mesh_dims():
    from torch.distributed.tensor import Replicate, Shard

    m2 = abstract_mesh((16, 16))
    m3 = abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    P = T_SH.P
    assert T_SH.NamedSharding(m2, P()).placements() == (Replicate(),
                                                        Replicate())
    assert T_SH.NamedSharding(m2, P(None, "model")).placements() == (
        Replicate(), Shard(1))
    # a composite entry: both mesh dims on tensor dim 1
    assert T_SH.NamedSharding(m2, P(None, ("model", "data"))).placements() \
        == (Shard(1), Shard(1))
    assert T_SH.NamedSharding(
        m3, P(("pod", "data"), None, "model")).placements() == (
        Shard(0), Shard(0), Shard(2))
    assert T_SH.NamedSharding(m3, P(None, ("data",))).placements() == (
        Replicate(), Shard(1), Replicate())


def test_partition_spec_is_a_tuple_equal_to_jax_entries():
    from jax.sharding import PartitionSpec as JP

    for entries in ((), (None, "model"), (("pod", "data"), None, "model"),
                    (None, ("model", "data")), (("data",), None),
                    ((), ["pod", "data"])):
        assert tuple(T_SH.P(*entries)) == tuple(JP(*entries))
    assert repr(T_SH.P(None, "model")) == "PartitionSpec(None, 'model')"


def test_abstract_mesh_and_production_mesh_refuse_what_they_cannot_build():
    with pytest.raises(ValueError):
        abstract_mesh((2, 2), ("data",))
    with pytest.raises(RuntimeError, match="256 ranks"):
        make_production_mesh()
    with pytest.raises(RuntimeError, match="512 ranks"):
        make_production_mesh(multi_pod=True)
