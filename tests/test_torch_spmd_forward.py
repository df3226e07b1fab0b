"""The port's sharded forward on a real world of 8 ranks — the
counterpart of ``tests/test_sharding.py::test_sharded_forward_matches_
local`` and ``tests/test_runtime_elastic.py::test_elastic_remesh_
preserves_function``, whose JAX runs use 8 forced host devices.

One ``launch.mesh.spawn_world`` of 8 ``gloo`` processes on the CPU
(rendezvous through a ``FileStore``) runs every case of this module,
from a module-scoped fixture with its own timeout; each case is a test
of its own that reads that world's results.  Each rank builds the smoke
config's params from the JAX package's ``init_params(PRNGKey(0))``
(carried across as NumPy with ``params_from_jax``), places them by
``make_param_shardings`` on a ('data', 'model') DeviceMesh, shards the
tokens (8 x 16) over 'data' and runs ``launch.spmd.forward``; rank 0
returns the whole logits and the port's local forward's.

Tolerances, f32: the sharded logits against the port's local forward
within ``REL = 1e-5`` relative (max |a - b| over max |b|, as
``tests/test_torch_lm.py``; only the order of the sharded sums
differs); against the JAX package's local forward, run in this process,
within the reference's own 2e-4 (``tests/test_sharding.py``).  The
reference's own test fails in this sandbox with a JAX sharding-mode
error (``ShardingTypeError`` at ``params["embed"][tokens]``), not a
numerical one, so the JAX side here is its local forward.  The remesh
is held to the reference's absolute 1e-4.  Serving: a sharded prefill
of 8 tokens and 3 teacher-forced ``make_serve_step`` decodes on caches
placed by ``make_cache_shardings`` (``launch.spmd.run_step``), for
olmo_1b and mamba2_130m on (2, 4), each step's logits held to the
port's local steps (``REL``) and the JAX package's (``REL_JAX``)."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import _torch_spmd as H  # noqa: E402
from repro import configs as R_C  # noqa: E402
from repro.models import steps as R_S  # noqa: E402
from repro.models import transformer as R_T  # noqa: E402
from repro_torch import configs as T_C  # noqa: E402
from repro_torch.launch.mesh import spawn_world  # noqa: E402
from repro_torch.parallel.sharding import default_scheme  # noqa: E402

REL = 1e-5
REL_JAX = 2e-4
REMESH_ATOL = 1e-4
TIMEOUT_S = 300.0

Z1 = {"tp": True, "fsdp": "zero1"}
Z3 = {"tp": True, "fsdp": "zero3"}


def _default(arch):
    return dataclasses.asdict(default_scheme(T_C.get_smoke(arch)))


# name: (arch, mesh, scheme)
FORWARDS = {
    "olmo_1b-2x4-tp-zero1": ("olmo_1b", (2, 4), Z1),
    "qwen2_0_5b-2x4-tp-zero1": ("qwen2_0_5b", (2, 4), Z1),
    "qwen2_0_5b-4x2-tp-zero1": ("qwen2_0_5b", (4, 2), Z1),
    "deepseek_moe_16b-2x4-tp-zero1": ("deepseek_moe_16b", (2, 4), Z1),
    "deepseek_moe_16b-2x4-tp-zero3": ("deepseek_moe_16b", (2, 4), Z3),
    "mamba2_130m-2x4-default": ("mamba2_130m", (2, 4),
                                _default("mamba2_130m")),
    "mamba2_130m-2x4-tp-zero3": ("mamba2_130m", (2, 4), Z3),
    "zamba2_7b-2x4-tp-zero1": ("zamba2_7b", (2, 4), Z1),
    # raised on real ranks before ``gather_data_axes`` (a head dim split
    # over ('model', 'data') reached the SSD's einsums)
    "zamba2_7b-2x4-tp-zero3": ("zamba2_7b", (2, 4), Z3),
    "zamba2_7b-2x4-zero3": ("zamba2_7b", (2, 4),
                            {"tp": False, "fsdp": "zero3"}),
}
SEED = 1
N_PROMPT, N_DECODE = 8, 3
DECODES = ("olmo_1b", "mamba2_130m")


def _cases() -> list:
    cases = [{"name": name, "run": "forward", "arch": arch, "mesh": mesh,
              "scheme": scheme, "seed": SEED}
             for name, (arch, mesh, scheme) in FORWARDS.items()]
    cases.append({"name": "remesh", "run": "remesh", "arch": "olmo_1b",
                  "scheme": Z1, "seed": SEED})
    cases += [{"name": f"decode-{a}", "run": "decode", "arch": a,
               "mesh": (2, 4), "scheme": Z1, "seed": 2,
               "n_prompt": N_PROMPT, "n_decode": N_DECODE} for a in DECODES]
    return cases


@pytest.fixture(scope="module")
def jax_params():
    archs = sorted({c["arch"] for c in _cases()})
    return {a: R_T.init_params(R_C.get_smoke(a), jax.random.PRNGKey(0))
            for a in archs}


@pytest.fixture(scope="module")
def world(jax_params):
    """Every rank's ``{case name: result}``, rank order."""
    np_params = {a: jax.tree.map(np.asarray, p)
                 for a, p in jax_params.items()}
    return spawn_world(H.WORLD, H.run_cases, _cases(), np_params,
                       timeout=TIMEOUT_S)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))


def _jax_forward(jax_params, arch, batch, seq):
    cfg = R_C.get_smoke(arch)
    toks = H.tokens(T_C.get_smoke(arch), batch, seq, SEED)
    fwd = jax.jit(lambda p, t: R_T.forward(cfg, p, t)[0])
    return np.asarray(fwd(jax_params[arch], toks))


@pytest.mark.parametrize("name", sorted(FORWARDS))
def test_sharded_forward_matches_local_and_jax(world, jax_params, name):
    arch = FORWARDS[name][0]
    got = world[0][name]
    assert np.isfinite(got["sharded"]).all()
    assert got["sharded"].shape == (H.BATCH, H.SEQ,
                                    T_C.get_smoke(arch).vocab)
    assert _rel(got["sharded"], got["local"]) < REL
    want = _jax_forward(jax_params, arch, H.BATCH, H.SEQ)
    assert _rel(got["sharded"], want) < REL_JAX
    assert _rel(got["local"], want) < REL


def test_every_rank_of_the_world_answered(world):
    assert len(world) == H.WORLD
    assert all(set(r) == {c["name"] for c in _cases()} for r in world)
    # only rank 0 returns the gathered logits
    assert all(r[name] is None for r in world[1:]
               for name in list(FORWARDS) + [f"decode-{a}" for a in DECODES])


def test_remesh_2x4_to_1x4_preserves_the_forward(world, jax_params):
    """``remesh_state`` onto a (1, 4) mesh over ranks 0-3, as the
    reference's 8 -> 4 devices: the forward there within 1e-4 of the
    local one and of the JAX package's."""
    got = world[0]["remesh"]
    assert np.max(np.abs(got["sharded"] - got["local"])) < REMESH_ATOL
    want = _jax_forward(jax_params, "olmo_1b", 4, 8)
    assert np.max(np.abs(got["sharded"] - want)) < REMESH_ATOL


def test_remesh_leaves_ranks_outside_the_new_mesh_empty(world):
    """Ranks 4-7 took part in the old mesh's gather; afterwards they
    hold DTensors of the new mesh with empty local tensors."""
    seen = [r["remesh"] for r in world]
    assert [s["in_new_mesh"] for s in seen] == [True] * 4 + [False] * 4
    assert all(s["all_dtensors"] for s in seen)
    assert all(s["local_numel"] > 0 for s in seen[:4])
    assert all(s["local_numel"] == 0 for s in seen[4:])


def _jax_decode(jax_params, arch) -> list:
    """The JAX package's prefill and serve steps on the same tokens,
    its decode cache seeded from the prefill's as ``greedy_decode``
    seeds it."""
    cfg = R_C.get_smoke(arch)
    p = jax_params[arch]
    toks = jnp.asarray(H.tokens(T_C.get_smoke(arch), H.BATCH,
                                N_PROMPT + N_DECODE, 2))
    last, cache = jax.jit(R_S.make_prefill_step(cfg))(p,
                                                       toks[:, :N_PROMPT])
    full = R_T.init_cache(cfg, H.BATCH, N_PROMPT + N_DECODE + 2)
    for k in ("k", "v"):
        if k in full:
            full[k] = full[k].at[:, :, :N_PROMPT].set(cache[k])
    for k in ("conv_x", "conv_bc", "ssd"):
        if k in full:
            full[k] = cache[k].astype(full[k].dtype)
    full["len"] = jnp.asarray(N_PROMPT, jnp.int32)
    serve = jax.jit(R_S.make_serve_step(cfg))
    out = [np.asarray(last)]
    for i in range(N_PROMPT, N_PROMPT + N_DECODE):
        logits, full = serve(p, full, toks[:, i:i + 1])
        out.append(np.asarray(logits))
    return out


@pytest.mark.parametrize("arch", DECODES)
def test_sharded_prefill_and_decodes_match_local_and_jax(world, jax_params,
                                                         arch):
    got = world[0][f"decode-{arch}"]
    want = _jax_decode(jax_params, arch)
    assert len(got["sharded"]) == len(want) == 1 + N_DECODE
    for step, (s, loc, ref) in enumerate(zip(got["sharded"], got["local"],
                                             want)):
        assert np.isfinite(s).all(), step
        assert _rel(s, loc) < REL, step
        assert _rel(s, ref) < REL_JAX, step
