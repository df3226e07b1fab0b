"""The port's trace accounting (``repro_torch.launch.trace_analysis``)
against the JAX package's HLO accounting (``repro.launch.hlo_analysis``).

The same programs are written in both: the reference reads them from
(synthetic or compiled) HLO text, the port from the ops DTensor emits
on a fake process group (``launch.mesh.fake_process_group``) under
``StepRecorder``.  Collective bytes and counts, and matmul FLOPs, must be
equal (the scanned-matmul FLOPs within the 1 % the reference's own test
allows of the JAX count, and exactly L * 2 * 4 * N**2).  HBM bytes are
an estimate in both packages: XLA fuses ``tanh`` into its consumer and
eager torch does not, so the two differ by design; the port's is held to
the reference's bounds and the ratio is printed.  Kernel 3's fake op and
FLOP formula are checked here too."""

from __future__ import annotations

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.launch import hlo_analysis as H  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    fake_process_group,
    make_debug_mesh,
)
from repro_torch.launch.trace_analysis import (  # noqa: E402
    StepRecorder,
    collective_kind,
    hide_sharding_propagation,
    ring_bytes,
)
from tests.test_hlo_analysis import _SYNTH  # noqa: E402

FA = importlib.import_module("repro_torch.kernels.flash_attention")


def _fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode

    return FakeTensorMode(allow_non_fake_inputs=True)


def _dt(local, mesh, placements):
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, mesh, placements, run_check=False)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def test_synth_program_collectives_equal_reference():
    """tests/test_hlo_analysis.py's _SYNTH in torch on a (2, 4) mesh: an
    f32[8] all-reduce over groups of 4 five times in a loop, then an
    all-gather to f32[16] over groups of 2."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    want = H.collective_bytes(_SYNTH, 8)
    with fake_process_group(8):
        mesh = make_debug_mesh((2, 4), ("data", "model"), device_type="cpu")
        rec = StepRecorder()
        with _fake_mode():
            x = _dt(torch.empty(8), mesh, [Replicate(), Partial()])
            g = _dt(torch.empty(8), mesh, [Shard(0), Replicate()])
            with rec, hide_sharding_propagation(rec):
                for _ in range(5):
                    x.redistribute(mesh, [Replicate(), Replicate()])
                out = g.redistribute(mesh, [Replicate(), Replicate()])
        assert tuple(out.to_local().shape) == (16,)
    got = rec.collectives
    assert got.bytes_by_kind == pytest.approx(want.bytes_by_kind)
    assert got.count_by_kind == want.count_by_kind
    assert got.bytes_by_kind == {"all-reduce": 240.0, "all-gather": 32.0}
    assert got.count_by_kind == {"all-reduce": 5.0, "all-gather": 1.0}
    assert got.total_bytes == want.total_bytes


@pytest.mark.parametrize("group", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("kind", ["all-reduce", "all-gather",
                                  "reduce-scatter", "all-to-all",
                                  "collective-permute"])
def test_ring_factors_equal_reference(kind, group):
    """One collective of each kind in a one-op HLO program: the port's
    ring factor on its output bytes equals the reference's."""
    n = 32
    groups = f"replica_groups=[{n // group},{group}]<=[{n}]"
    txt = (
        "HloModule m\n\n"
        "ENTRY %main (x: f32[64]) -> f32[64] {\n"
        f"  %c = f32[64]{{0}} {kind}(%x), {groups}\n"
        "  ROOT %o = f32[64]{0} copy(%c)\n"
        "}\n"
    )
    want = H.collective_bytes(txt, n)
    assert want.count_by_kind == {kind: 1.0}
    assert ring_bytes(kind, 64 * 4, group) == pytest.approx(
        want.bytes_by_kind[kind])


def test_collective_kinds_of_functional_ops():
    ops = torch.ops._c10d_functional
    assert collective_kind(ops.all_reduce.default) == "all-reduce"
    assert collective_kind(ops.all_gather_into_tensor.default) == (
        "all-gather")
    assert collective_kind(ops.reduce_scatter_tensor.default) == (
        "reduce-scatter")
    assert collective_kind(ops.all_to_all_single.default) == "all-to-all"
    assert collective_kind(ops.wait_tensor.default) is None
    assert collective_kind(torch.ops.aten.mm.default) is None


def test_one_by_one_mesh_emits_no_collective():
    from torch.distributed.tensor import Replicate

    with fake_process_group(1):
        mesh = make_debug_mesh((1, 1), ("data", "model"), device_type="cpu")
        rec = StepRecorder()
        with _fake_mode():
            a = _dt(torch.empty(8, 16), mesh, [Replicate(), Replicate()])
            b = _dt(torch.empty(16, 4), mesh, [Replicate(), Replicate()])
            with rec, hide_sharding_propagation(rec):
                (a @ b).sum().redistribute(mesh, [Replicate(), Replicate()])
    assert rec.collectives.total_bytes == 0.0
    assert rec.coll_count == {}
    assert rec.dot_flops == 2 * 8 * 16 * 4


# ---------------------------------------------------------------------------
# dot FLOPs and HBM bytes
# ---------------------------------------------------------------------------


def _scan_stack_jax_flops(L: int, N: int) -> float:
    def f(w, x):
        def body(h, wi):
            return jnp.tanh(h @ wi), None
        return jax.lax.scan(body, x, w)[0]

    txt = (
        jax.jit(f)
        .lower(jax.ShapeDtypeStruct((L, N, N), jnp.float32),
               jax.ShapeDtypeStruct((4, N), jnp.float32))
        .compile()
        .as_text()
    )
    return H.dot_flops(txt)


def test_scanned_matmul_stack_flops_equal_reference():
    """The reference's scanned matmul stack (L 6, N 32, batch 4) as a
    Python loop."""
    L, N = 6, 32
    rec = StepRecorder()
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((L, N, N)).astype(np.float32))
    h = torch.from_numpy(rng.standard_normal((4, N)).astype(np.float32))
    with rec:
        for i in range(L):
            h = torch.tanh(h @ w[i])
    assert rec.dot_flops == L * 2 * 4 * N * N
    assert rec.dot_flops == pytest.approx(_scan_stack_jax_flops(L, N),
                                          rel=0.01)


def test_sharded_matmul_counts_the_local_share():
    """The trap: a mode that counted the global product would report 8x
    the per-device work of a product sharded over an 8-rank mesh."""
    from torch.distributed.tensor import Replicate, Shard

    with fake_process_group(8):
        mesh = make_debug_mesh((2, 4), ("data", "model"), device_type="cpu")
        rec = StepRecorder()
        with _fake_mode():
            x = _dt(torch.empty(64, 128), mesh, [Shard(0), Replicate()])
            w = _dt(torch.empty(128, 32), mesh, [Replicate(), Shard(1)])
            with rec, hide_sharding_propagation(rec):
                y = x @ w
    assert tuple(y.shape) == (128, 128)
    assert rec.dot_flops == 2 * 64 * 128 * 32
    assert rec.collectives.total_bytes == 0.0


def test_hbm_bytes_positive_and_bounded():
    """tanh(x) @ ones(64, 64), as the reference's test; XLA fuses the
    tanh into the dot, eager torch writes it out, a stated difference."""
    def f(x):
        return jnp.tanh(x) @ jnp.ones((64, 64))

    txt = (jax.jit(f).lower(jax.ShapeDtypeStruct((64, 64), jnp.float32))
           .compile().as_text())
    ref = H.hbm_bytes(txt)
    rec = StepRecorder()
    x = torch.zeros(64, 64)
    with rec:
        torch.tanh(x) @ torch.ones(64, 64)
    assert 0 < rec.hbm_bytes < 10e6
    # tanh and the product each write 16 KiB, counted twice; the ones
    # are a constant, as XLA's broadcast constant
    assert rec.hbm_bytes == 2 * 2 * 64 * 64 * 4
    print(f"hbm bytes: port {rec.hbm_bytes:.0f}, reference {ref:.0f}, "
          f"ratio {rec.hbm_bytes / ref:.3f}")


def test_views_and_constants_are_free():
    rec = StepRecorder()
    x = torch.zeros(8, 8)
    with rec:
        x.t()[:4].unsqueeze(0)
        x.reshape(64)[:4]
        torch.arange(16)
        torch.zeros(4, 4)
    assert rec.hbm_bytes == 0.0
    with rec:
        x.t().reshape(64)      # a copy: the transpose is not contiguous
    assert rec.hbm_bytes == 2 * 64 * 4


# ---------------------------------------------------------------------------
# peak bytes
# ---------------------------------------------------------------------------


def test_peak_counts_arguments_and_live_storages():
    rec = StepRecorder()
    x = torch.zeros(256)                   # 1 KiB
    assert rec.track({"x": x, "view": x[:4]}) == 1024
    with rec:
        a = x + 1
        b = a * 2                          # x, a, b live: 3 KiB
        del a
        c = b + 1                          # x, b, c live: 3 KiB
        del b
    assert rec.peak_bytes == 3 * 1024
    assert rec.live_bytes == 2 * 1024      # x and c
    del c
    assert rec.live_bytes == 1024


def test_peak_keeps_autograd_saved_tensors_alive():
    """exp saves its output for the backward: the output's storage stays
    live while the graph holds it, though no Python name does."""
    rec = StepRecorder()
    x = torch.zeros(256, requires_grad=True)
    rec.track(x)
    with rec:
        y = x.exp()                        # saved by ExpBackward
        z = (y * 2).sum()
        del y
    assert rec.live_bytes >= 2 * 1024      # x and exp's saved output
    z.backward()
    del z


# ---------------------------------------------------------------------------
# kernel 3 as a traceable op
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dims", [
    (2, 4, 2, 70, 90, 32, 5),       # B, H, Hkv, Sq, Sk, D, kv_offset
    (1, 8, 8, 64, 64, 64, 0),
    (2, 4, 1, 33, 128, 32, -40),    # a KV part's negative offset
    (1, 2, 2, 5, 3, 32, 10),
])
def test_kernel3_flop_formula_equals_the_bound_count(dims, causal):
    """4 B H D x the visible (query, key) pairs: the count the kernel's
    bound uses (``chip_smoke.lse_visible_pairs``), and what
    FlopCounterMode reports for one call on CPU tensors."""
    from torch.utils.flop_counter import FlopCounterMode

    B, H, Hkv, Sq, Sk, D, off = dims
    i = np.arange(Sq)
    pairs = int(np.clip(i + off + 1, 0, Sk).sum()) if causal else Sq * Sk
    want = 4 * B * H * D * pairs
    assert FA.flash_flops((B, H, Sq, D), (B, Hkv, Sk, D), causal,
                          off) == want
    g = torch.Generator().manual_seed(0)
    q = torch.randn(B, H, Sq, D, generator=g)
    k = torch.randn(B, Hkv, Sk, D, generator=g)
    for lse in (False, True):
        with FlopCounterMode(display=False) as fc:
            FA.flash_attention_cuda(q, k, k, causal=causal, kv_offset=off,
                                    return_lse=lse)
        assert fc.get_total_flops() == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel3_fake_op_returns_the_kernels_shapes(dtype):
    """On fake CUDA tensors the op runs its fake implementation: the
    output in q's layout and dtype, the log-sum-exp (B, H, Sq) float32;
    nothing is launched."""
    dt = getattr(torch, dtype)
    before = FA.flash_attention_cuda.launches
    with _fake_mode():
        q = torch.empty(2, 70, 4, 64, dtype=dt, device="cuda").transpose(
            1, 2)
        k = torch.empty(2, 90, 2, 64, dtype=dt, device="cuda").transpose(
            1, 2)
        o = FA.flash_attention_cuda(q, k, k)
        o2, lse = FA.flash_attention_cuda(q, k, k, kv_offset=-10,
                                          return_lse=True)
    for out in (o, o2):
        assert out.shape == q.shape and out.dtype == dt
        assert out.device.type == "cuda" and out.stride() == q.stride()
    assert tuple(lse.shape) == (2, 4, 70) and lse.dtype == torch.float32
    assert FA.flash_attention_cuda.launches == before


def test_kernel3_op_on_cpu_is_the_plain_version():
    g = torch.Generator().manual_seed(1)
    q = torch.randn(2, 4, 50, 32, generator=g)
    k = torch.randn(2, 2, 70, 32, generator=g)
    v = torch.randn(2, 2, 70, 32, generator=g)
    assert torch.equal(FA.flash_attention_cuda(q, k, v, kv_offset=3),
                       FA.flash_attention_plain(q, k, v, kv_offset=3))
    o, lse = FA.flash_attention_cuda(q, k, v, kv_offset=-30,
                                     return_lse=True)
    o2, lse2 = FA.flash_attention_plain(q, k, v, kv_offset=-30,
                                        return_lse=True)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


def test_kernel3_sharding_rule_runs_per_head_shard():
    """Heads over 'model' where H and Hkv divide: the op runs on the
    local heads with no collective; a head count that does not divide
    is gathered."""
    from torch.distributed.tensor import Replicate, Shard

    with fake_process_group(4):
        mesh = make_debug_mesh((2, 2), ("data", "model"), device_type="cpu")
        for hkv, gathers in ((2, False), (1, True)):
            rec = StepRecorder()
            with _fake_mode():
                q = _dt(torch.empty(1, 2, 64, 32), mesh, [Shard(0), Shard(1)])
                kp = [Shard(0), Shard(1) if hkv == 2 else Replicate()]
                k = _dt(torch.empty(1, 1 if hkv == 2 else hkv, 64, 32),
                        mesh, kp)
                with rec, hide_sharding_propagation(rec):
                    o = FA.flash_attention_cuda(q, k, k)
            assert tuple(o.shape) == (2, 4, 64, 32)
            assert (rec.collectives.total_bytes > 0) == gathers
            local_h = 2 if not gathers else 4
            assert rec.dot_flops == FA.flash_flops(
                (1, local_h, 64, 32), (1, hkv, 64, 32), True, 0)
