"""``repro_torch.runtime.elastic.remesh_state`` and the DTensor side of
the sharding layer on a real ``DeviceMesh``: a world of one rank on the
CPU (``gloo``, rendezvous through a ``FileStore`` in a temporary
directory), made and destroyed by a module fixture.

Params are distributed onto a 1 x 1 ('data', 'model') mesh, then
remeshed onto a 1 x 1 x 1 ('pod', 'data', 'model') mesh: every leaf a
DTensor whose placements are its ``NamedSharding.placements()`` and
whose ``to_local()`` is ``torch.equal`` to the original.  The smoke
olmo forward on the remeshed params equals the forward before — the
port's counterpart of ``tests/test_runtime_elastic.py``'s 8-device
remesh, on the one device a CPU test has."""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as T_C  # noqa: E402
from repro_torch.cluster import elastic as T_CL  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    make_debug_mesh,
    single_process_group,
)
from repro_torch.models import transformer as T_T  # noqa: E402
from repro_torch.parallel import constrain as T_CON  # noqa: E402
from repro_torch.parallel import sharding as T_SH  # noqa: E402
from repro_torch.runtime import remesh_state  # noqa: E402
from repro_torch.tree import leaves, paths, tree_map  # noqa: E402


@pytest.fixture(scope="module")
def meshes():
    with single_process_group("gloo"):
        yield (make_debug_mesh((1, 1), ("data", "model"), "cpu"),
               make_debug_mesh((1, 1, 1), ("pod", "data", "model"), "cpu"))


def _params(arch):
    cfg = T_C.get_smoke(arch)
    return cfg, T_T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _check_placed(cfg, tree, original, mesh, scheme):
    from torch.distributed.tensor import DTensor

    want = T_SH.make_param_shardings(cfg, mesh, original, scheme)
    for name, got, orig, sh in zip(paths(tree), leaves(tree),
                                   leaves(original), leaves(want)):
        assert isinstance(got, DTensor), name
        assert got.device_mesh is mesh or got.device_mesh == mesh, name
        assert tuple(got.placements) == sh.placements(), name
        assert torch.equal(got.to_local(), orig), name
        assert got.shape == orig.shape


SCHEMES = {
    "default": None,
    "tp_zero3": T_SH.ShardScheme(tp=True, fsdp="zero3"),
    "zero3_ep_2d": T_SH.ShardScheme(tp=True, fsdp="zero3",
                                    expert_mode="ep",
                                    out_proj_contracting_2d=True),
}


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
@pytest.mark.parametrize("arch", ["olmo_1b", "qwen2_0_5b", "grok_1_314b",
                                  "mamba2_130m", "zamba2_7b"])
def test_remesh_from_2d_to_3d_mesh_keeps_every_leaf(meshes, arch, scheme):
    mesh2, mesh3 = meshes
    cfg, params = _params(arch)
    s = SCHEMES[scheme]
    placed = T_SH.distribute(params,
                             T_SH.make_param_shardings(cfg, mesh2, params, s))
    _check_placed(cfg, placed, params, mesh2, s)
    moved = remesh_state(cfg, placed, mesh3, s)      # DTensors in
    _check_placed(cfg, moved, params, mesh3, s)
    fresh = remesh_state(cfg, params, mesh3, s)      # host tensors in
    _check_placed(cfg, fresh, params, mesh3, s)


def test_remeshed_forward_equals_the_forward_before(meshes):
    _, mesh3 = meshes
    cfg, params = _params("olmo_1b")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (4, 8)))
    ref, _, _ = T_T.forward(cfg, params, toks)
    scheme = T_SH.ShardScheme(tp=True, fsdp="zero1")
    state = remesh_state(cfg, params, mesh3, scheme)
    on_mesh = tree_map(lambda t: t.to_local(), state)
    with T_CON.use_mesh(mesh3), T_CON.scheme_context(scheme):
        out, _, _ = T_T.forward(cfg, on_mesh, toks)
    assert torch.equal(out, ref)


def test_constrain_redistributes_a_dtensor(meshes):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    mesh2, _ = meshes
    x = torch.arange(48.0).reshape(4, 12)
    d = distribute_tensor(x, mesh2, [Replicate(), Replicate()])
    with T_CON.use_mesh(mesh2):
        got = T_CON.constrain(d, ("pod", "data"), "model")
        kept = T_CON.constrain(x, ("pod", "data"), "model")
    assert tuple(got.placements) == (Shard(0), Shard(1))
    assert torch.equal(got.full_tensor(), x)
    assert kept is x


def test_cluster_reexports_the_runtime_remesh(meshes):
    _, mesh3 = meshes
    assert T_CL.remesh_state is remesh_state
    cfg, params = _params("olmo_1b")
    out = T_CL.remesh_state(cfg, params, mesh3)
    assert paths(out) == paths(params)


def test_debug_mesh_names_its_axes(meshes):
    mesh2, mesh3 = meshes
    assert mesh2.mesh_dim_names == ("data", "model")
    assert T_SH._axis_sizes(mesh3) == {"pod": 1, "data": 1, "model": 1}
    assert T_SH.batch_axes(mesh3, T_SH.ShardScheme(batch_over_model=True),
                           4) == ("pod", "data", "model")


def test_single_process_group_refuses_a_second_group(meshes):
    with pytest.raises(RuntimeError, match="already initialised"):
        with single_process_group("gloo"):
            pass
