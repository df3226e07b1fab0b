"""Kernel 1, ``xnor_gemm_cuda``, on the CPU: the AND form of the product
that the kernel runs on the 1-bit tensor cores, held bit-exact to the
JAX package's Pallas kernel (interpret mode) and its oracle on any
words, and the launch arithmetic (``launch_plan``, ``block_share``) for
all 7 aspect sets over the CIFAR-10 and Fashion-MNIST GEMM shapes, with
every output covered exactly once.  The kernel itself runs only on the
card (``tests/test_torch_cuda.py``)."""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.kernels.ref import xnor_gemm_ref as r_xnor_gemm_ref  # noqa: E402
from repro.kernels.xnor_popcount import xnor_gemm_pallas  # noqa: E402
from repro_torch.kernels import xnor_popcount as XP  # noqa: E402
from repro_torch.kernels.ref import xnor_gemm_ref  # noqa: E402

ASPECTS = ("X", "Y", "Z", "XY", "XZ", "YZ", "XYZ")
# full-width GEMM shapes (layer, P windows, N outputs, Kw): conv layers
# as patches x weights, FC layers with one window
GEMM_SHAPES = {
    "cifar10": (("L1", 1024, 64, 9), ("L3", 1024, 64, 18),
                ("L6", 256, 256, 18), ("L8", 256, 256, 72),
                ("L11", 64, 512, 72), ("L13", 64, 512, 144),
                ("L17", 1, 1024, 256), ("L19", 1, 10, 32)),
    "fashion_mnist": (("L1", 784, 64, 9), ("L4", 196, 64, 18),
                      ("L8", 1, 2048, 98), ("L10", 1, 10, 64)),
}
SHAPE_CASES = [(arch, *s) for arch, ss in GEMM_SHAPES.items() for s in ss]


def _words(rng, kind, *shape):
    if kind == "zeros":
        return np.zeros(shape, np.int32)
    if kind == "ones":
        return np.full(shape, -1, np.int32)
    return rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)


@pytest.mark.parametrize("pn", [(1, 10), (37, 21), (5, 10)],
                         ids=lambda pn: f"P{pn[0]}N{pn[1]}")
@pytest.mark.parametrize("kw", [1, 5, 8, 9, 33, 144, 256, 257])
def test_and_form_matches_pallas_and_oracle(kw, pn):
    p, n = pn
    rng = np.random.default_rng(kw * 100 + p)
    a, w = _words(rng, "random", 2, p, kw), _words(rng, "random", n, kw)
    k_true = 32 * kw - 5
    want = np.asarray(xnor_gemm_pallas(
        jnp.asarray(a), jnp.asarray(w), k_true, ("X", "Y"), p_blk=16,
        n_blk=8, interpret=True))
    oracle = np.asarray(r_xnor_gemm_ref(jnp.asarray(a), jnp.asarray(w),
                                        k_true))
    assert np.array_equal(want, oracle)
    got = XP.xnor_gemm_and_plain(torch.from_numpy(a), torch.from_numpy(w),
                                 k_true)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("kinds", [("zeros", "zeros"), ("ones", "ones"),
                                   ("zeros", "ones"), ("ones", "random"),
                                   ("random", "zeros")])
@pytest.mark.parametrize("kw", [1, 9, 257])
def test_and_form_on_all_zero_and_all_one_words(kw, kinds):
    rng = np.random.default_rng(kw)
    a, w = _words(rng, kinds[0], 3, 7, kw), _words(rng, kinds[1], 10, kw)
    want = np.asarray(r_xnor_gemm_ref(jnp.asarray(a), jnp.asarray(w), kw))
    at, wt = torch.from_numpy(a), torch.from_numpy(w)
    assert np.array_equal(XP.xnor_gemm_and_plain(at, wt, kw).numpy(), want)
    assert np.array_equal(xnor_gemm_ref(at, wt, kw).numpy(), want)
    # the wrapper's CPU path is the AND form
    assert np.array_equal(XP.xnor_gemm_cuda(at, wt, kw).numpy(), want)


def _covers(B, P, N, Kw, mask, p_blk, n_blk):
    """Walk every block of the plan as the kernel does; returns the plan
    and the (B*P, N) count of writes per output."""
    plan = XP.launch_plan(B, P, N, Kw, mask, p_blk, n_blk)
    hits = np.zeros((B * P, N), np.int64)
    tm, tn = plan.tile_rows, XP.TILE_COLS
    for blk in range(plan.grid):
        b0, nb, p0, pc, n0, nc = XP.block_share(B, P, N, mask, p_blk, n_blk,
                                                blk)
        rows = nb * pc
        assert 0 < rows <= plan.rows_per_block and 0 < nc <= plan.cols_per_block
        assert 0 <= b0 and b0 + nb <= B and 0 <= p0 and p0 + pc <= P
        assert 0 <= n0 and n0 + nc <= N
        for rt in range(-(-rows // tm)):
            i = np.arange(rt * tm, min(rows, (rt + 1) * tm))
            grow = (b0 + i // pc) * P + p0 + i % pc
            for ct in range(-(-nc // tn)):
                c0 = n0 + ct * tn
                hits[grow, c0:min(n0 + nc, c0 + tn)] += 1
    return plan, hits


@pytest.mark.parametrize("batch", [1, 16, 33])
@pytest.mark.parametrize("aspects", ASPECTS)
@pytest.mark.parametrize("case", SHAPE_CASES,
                         ids=lambda c: f"{c[0]}-{c[1]}")
def test_launch_plan_covers_every_output_once(case, aspects, batch):
    _, _, P, N, Kw = case
    mask = XP.aspect_mask(aspects)
    p_blk, n_blk = XP._fit_tile(XP.P_BLK, P), XP._fit_tile(XP.N_BLK, N)
    plan, hits = _covers(batch, P, N, Kw, mask, p_blk, n_blk)
    assert (hits == 1).all(), (int(hits.min()), int(hits.max()))
    # the grid is B x ceil(P/p_blk) x ceil(N/n_blk) over the aspects
    want = 1
    for bit, extent in ((1, batch), (2, -(-P // p_blk)), (4, -(-N // n_blk))):
        if mask & bit:
            want *= extent
    assert plan.grid == want
    # a block of at most 16 rows takes the 16-row tile, others 64
    assert plan.tile_rows == (16 if plan.rows_per_block <= 16 else 64)
    # FC layers with X serial fill the 16-row fragment with images
    if P == 1 and not mask & 1:
        assert plan.rows_per_block == batch


@pytest.mark.parametrize("kw", [1, 5, 7, 8, 9, 18, 33, 72, 98, 144, 255, 256,
                                257])
def test_launch_plan_reduction(kw):
    plan = XP.launch_plan(16, 64, 512, kw, 7, 64, 64)
    # every ring stage is whole: zeros past Kw, whole m16n8k256 steps
    assert plan.kw_padded % XP.K_CHUNK == 0 and XP.K_CHUNK % XP.K_STEP == 0
    assert kw <= plan.kw_padded < kw + XP.K_CHUNK
    assert plan.k_steps * XP.K_STEP == plan.kw_padded
    assert plan.k_chunks * XP.K_CHUNK == plan.kw_padded
    # 16-byte copies only where a row starts 16-byte aligned
    assert plan.copy_words == (4 if kw % 4 == 0 else 1)
    assert XP.launch_plan(16, 64, 512, kw, 7, 64, 64, False).copy_words == 1
    # the chunks of the ring cover each real word once
    words = []
    for c in range(plan.k_chunks):
        k0 = c * XP.K_CHUNK
        kn = min(XP.K_CHUNK, kw - k0)
        assert 0 < kn <= XP.K_CHUNK
        words += range(k0, k0 + kn)
    assert words == list(range(kw))


@pytest.mark.parametrize("tile_rows", XP.TILE_ROWS)
def test_launch_plan_fits_shared_memory(tile_rows):
    rows = 64 if tile_rows == 64 else 16
    plan = XP.launch_plan(1, rows, 64, 9, 7, 64, 64)
    assert plan.tile_rows == tile_rows
    # an H100 SM has 228 KB of shared memory, 1 KB of it reserved per
    # block; the kernel asks for two blocks an SM
    assert 2 * (plan.smem_bytes + 1024) <= 233472
    assert plan.smem_bytes % 16 == 0


def test_aspect_masks_are_cached_and_canonical():
    assert XP.aspect_mask(("Z", "X")) == XP.aspect_mask("XZ") == 5
    assert XP.aspect_mask(["X", "Y", "Z"]) == 7
    with pytest.raises(ValueError):
        XP.aspect_mask(("Q",))
    with pytest.raises(ValueError):
        XP.aspect_mask(())
