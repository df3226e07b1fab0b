"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's (``repro.launch.dryrun``), on CPU tensors and fake process
groups: nothing is allocated at the traced sizes.

Held equal to the reference: the skip dict of an unsupported cell (made
before any mesh), ``roofline_terms`` on the same result dict with the
v5e constants passed, and the per-device argument bytes of a smoke
config's train cell on the 16 x 16 mesh against the shard shapes of the
reference's own shardings (``NamedSharding(AbstractMesh, spec)
.shard_shape``).  The DTensor-clean model paths (``parallel.constrain
.split_dim`` and ``batch_local``) give the plain path's numbers on a
one-rank gloo DeviceMesh (f32, atol 1e-6).  The traced FLOPs against
``FlopCounterMode`` are in ``tests/test_torch_dryrun_flops.py``."""

from __future__ import annotations

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import configs as R_C  # noqa: E402
from repro.models.transformer import param_specs as r_param_specs  # noqa: E402
from repro.optim import adamw as r_adamw  # noqa: E402
from repro.parallel import sharding as R_SH  # noqa: E402
from repro_torch import configs as T_C  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    fake_process_group,
    make_debug_mesh,
    single_process_group,
)
from repro_torch.models import transformer as T_T  # noqa: E402
from repro_torch.parallel import constrain as T_CON  # noqa: E402

V5E = {"peak_flops": 197e12, "hbm_bw": 819e9, "link_bw": 50e9}


def _ref_dryrun():
    """The JAX package's dryrun module; it sets ``XLA_FLAGS`` when
    imported, which must not leak into later tests of this process."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as ref
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return ref


@pytest.fixture
def smoke_configs(monkeypatch):
    """Full-config names resolve to their smoke configs for the test."""
    monkeypatch.setattr(T_C, "get", T_C.get_smoke)


# ---------------------------------------------------------------------------
# the reference's result layout
# ---------------------------------------------------------------------------


def test_skip_equals_reference_before_any_mesh():
    import torch.distributed as dist

    ref = _ref_dryrun()
    want = ref.run_cell("olmo_1b", "long_500k", multi_pod=False)
    got = D.run_cell("olmo_1b", "long_500k", multi_pod=False, device="cpu")
    assert got == want
    assert not dist.is_initialized()


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_roofline_terms_equal_reference_with_v5e_constants(
        smoke_configs, shape):
    r = D.run_cell("qwen2_0_5b", shape, multi_pod=False, device="cpu")
    assert r["status"] == "ok"
    assert set(r) == {"arch", "shape", "multi_pod", "devices", "status",
                      "trace_s", "memory", "collectives", "per_device"}
    assert r["devices"] == 256
    assert set(r["memory"]) == {"argument_bytes", "output_bytes",
                                "temp_bytes", "alias_bytes",
                                "peak_bytes_per_device"}
    mem = r["memory"]
    assert mem["peak_bytes_per_device"] == (
        mem["argument_bytes"] + mem["temp_bytes"] + mem["output_bytes"]
        - mem["alias_bytes"])
    assert set(r["collectives"]) == {"per_device_bytes", "by_kind_bytes",
                                     "by_kind_count"}
    assert r["per_device"]["hlo_flops"] > 0
    ref = _ref_dryrun()
    want = ref.roofline_terms(r, R_C.get_smoke("qwen2_0_5b"), shape)
    got = D.roofline_terms(r, T_C.get_smoke("qwen2_0_5b"), shape,
                           peak_flops=V5E["peak_flops"],
                           hbm_bw=V5E["hbm_bw"], link_bw=V5E["link_bw"])
    assert got == want
    h100 = D.roofline_terms(r, T_C.get_smoke("qwen2_0_5b"), shape)
    assert h100["compute_s"] == pytest.approx(
        r["per_device"]["hlo_flops"] / 989e12)


def _shard_bytes(tree, shardings) -> int:
    leaves = jax.tree.leaves(tree)
    shs = jax.tree.leaves(shardings,
                          is_leaf=lambda x: isinstance(
                              x, jax.sharding.NamedSharding))
    assert len(leaves) == len(shs)
    return sum(int(np.prod(sh.shard_shape(leaf.shape)))
               * np.dtype(leaf.dtype).itemsize
               for leaf, sh in zip(leaves, shs))


@pytest.mark.parametrize("arch", ["qwen2_0_5b", "deepseek_moe_16b",
                                  "grok_1_314b", "llava_next_mistral_7b"])
def test_argument_bytes_equal_reference_shard_sizes(smoke_configs, arch,
                                                   monkeypatch):
    """Params, AdamW state and batch of the train_4k cell on the 16 x 16
    mesh: the port's per-device argument bytes are the sum of the
    reference's shard shapes for the same leaves.  The reference plans
    against a mesh's axis names and ``devices.shape``, which JAX's
    ``AbstractMesh`` does not give; so it plans against a stand-in
    holding them, and its ``NamedSharding`` is built on the
    ``AbstractMesh((16, 16), ('data', 'model'))``, whose ``shard_shape``
    gives the shard of each of the reference's specs."""
    from types import SimpleNamespace

    from jax.sharding import AbstractMesh, NamedSharding

    abstract = AbstractMesh((16, 16), ("data", "model"))
    monkeypatch.setattr(R_SH, "NamedSharding",
                        lambda _mesh, spec: NamedSharding(abstract, spec))
    r = D.run_cell(arch, "train_4k", multi_pod=False, device="cpu")
    cfg = R_C.get_smoke(arch)
    mesh = SimpleNamespace(axis_names=("data", "model"),
                           devices=np.zeros((16, 16)))
    scheme = R_SH.default_scheme(cfg)
    ps = r_param_specs(cfg)
    opt = r_adamw(3e-4, state_dtype=jax.numpy.bfloat16
                  if cfg.n_params() > 1e11 else jax.numpy.float32)
    o_specs = jax.eval_shape(opt.init, ps)
    specs = R_C.input_specs(cfg, "train_4k")
    want = (
        _shard_bytes(ps, R_SH.make_param_shardings(cfg, mesh, ps, scheme))
        + _shard_bytes(o_specs, R_SH.make_opt_shardings(
            cfg, mesh, ps, scheme, "adamw"))
        + _shard_bytes(specs, R_SH.make_batch_shardings(
            cfg, mesh, specs, scheme)))
    assert r["memory"]["argument_bytes"] == want


def test_prefill_pins_its_cache_as_the_reference():
    """The prefill's returned cache is redistributed to the cache
    shardings with ``allow_hd=False``; its k/v heads shard over
    'model'."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.parallel.sharding import default_scheme

    cfg = T_C.get_smoke("qwen2_0_5b")
    with fake_process_group(4):
        mesh = make_debug_mesh((2, 2), ("data", "model"), device_type="cpu")
        scheme = default_scheme(cfg)
        with FakeTensorMode(allow_non_fake_inputs=True), \
                T_CON.use_mesh(mesh), T_CON.scheme_context(scheme), \
                implicit_replication():
            run, _ = D.build_step(cfg, T_C.ShapeCell("p", "prefill", 64, 8),
                                  mesh, scheme, device="cpu")
            _, cache = run()
    assert cache["len"] == 64
    assert cache["k"].placements == (Shard(1), Shard(3))
    assert cache["v"].placements == (Shard(1), Shard(3))


def test_main_writes_each_cell_and_a_summary(smoke_configs, tmp_path):
    rc = D.main(["--arch", "olmo_1b", "--device", "cpu", "--out",
                 str(tmp_path)])
    assert rc == 0
    import json

    summary = json.loads((tmp_path / "summary.json").read_text())
    assert [(r["shape"], r["status"]) for r in summary] == [
        ("train_4k", "ok"), ("prefill_32k", "ok"), ("decode_32k", "ok"),
        ("long_500k", "skipped")]
    for r in summary[:3]:
        assert r["roofline"]["dominant"] in ("compute", "memory",
                                             "collective")
    assert (tmp_path / "olmo_1b__train_4k__pod1.json").exists()
    # a second run reads the cells back
    assert D.main(["--arch", "olmo_1b", "--shape", "train_4k", "--device",
                   "cpu", "--out", str(tmp_path)]) == 0


# ---------------------------------------------------------------------------
# the DTensor-clean model code
# ---------------------------------------------------------------------------


def test_split_dim_and_batch_local_are_identities_on_plain_tensors():
    x = torch.arange(24.0).reshape(2, 12)
    assert torch.equal(T_CON.split_dim(x, 1, 3, 4), x.reshape(2, 3, 4))
    assert torch.equal(T_CON.split_dim(x, -1, 4, 3), x.reshape(2, 4, 3))
    out = T_CON.batch_local(lambda a, b: (a + b, a * b), x, x)
    assert torch.equal(out[0], x + x) and torch.equal(out[1], x * x)


@pytest.mark.parametrize("arch", ["qwen2_5_14b", "deepseek_moe_16b",
                                  "mamba2_130m"])
def test_dtensor_forward_equals_the_plain_forward(arch):
    """The smoke forward with DTensor params on a one-rank gloo mesh
    (MoE dispatch through ``batch_local``, heads through ``split_dim``)
    against the plain forward."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.parallel.sharding import (
        default_scheme,
        distribute,
        make_param_shardings,
    )

    cfg = T_C.get_smoke(arch)
    g = torch.Generator().manual_seed(0)
    params = T_T.init_params(cfg, g, device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 16), generator=g)
    want, _, aux = T_T.forward(cfg, params, toks)
    with single_process_group("gloo"):
        mesh = make_debug_mesh((1, 1), ("data", "model"), device_type="cpu")
        sh = make_param_shardings(cfg, mesh, params, default_scheme(cfg))
        dparams = distribute(params, sh)
        with T_CON.use_mesh(mesh), implicit_replication():
            got, _, daux = T_T.forward(cfg, dparams, toks)
        assert isinstance(got, DTensor)
        got = got.full_tensor()
        daux = daux.full_tensor() if isinstance(daux, DTensor) else daux
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(float(daux), float(aux), atol=1e-6)
