"""How the port's CUDA kernels cut and address their work, checked on
the CPU: the fused segment's per-layer tile table (``_Lowered.tiles``,
the split the persistent kernel's blocks stride over) and the flash
kernel's 16-byte alignment rule for bf16 operands.  The kernels
themselves run only on the card (``tests/test_torch_cuda.py``)."""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.bnn import models as T_M  # noqa: E402
from repro_torch.bnn.binarize import PACK_W  # noqa: E402
from repro_torch.kernels import segment_fused as T_SF  # noqa: E402
from repro_torch.kernels.flash_attention import check_aligned  # noqa: E402

SPANS = {
    "cifar10": {"whole": (0, 19), "tail_step": (14, 19), "mid_mp": (8, 13)},
    "fashion_mnist": {"whole": (0, 10), "tail_step": (5, 10),
                      "mid_mp": (1, 4)},
}
_LOWERED: dict = {}


def _lowered(arch, span):
    """The full-width net's lowering of a span (weights from a seed)."""
    if arch not in _LOWERED:
        specs = T_M.build_model(arch).specs
        _LOWERED[arch] = specs, T_M.pack_params(
            specs, T_M.random_fp_params(specs, 0), device="cpu")
    specs, packed = _LOWERED[arch]
    s, e = SPANS[arch][span]
    return T_SF._Lowered(specs[s:e], packed[s:e],
                         T_SF.infer_in_encoding(specs[s:e]))


def _written(row, r0, r1, c0, c1):
    """The output elements, as (rows, columns) slices of the op's
    (B x rows) x out-columns array, that one tile writes."""
    fused_step = row[T_SF.F_KIND] in (T_SF.OP_CONV, T_SF.OP_FC) and row[
        T_SF.F_STEP]
    if fused_step:   # one ballot word per 32 channels
        return slice(r0, r1), slice(c0 // PACK_W, c1 // PACK_W)
    return slice(r0, r1), slice(c0, c1)


@pytest.mark.parametrize("batch", [1, 16, 33])
@pytest.mark.parametrize("span", ["whole", "tail_step", "mid_mp"])
@pytest.mark.parametrize("arch", ["cifar10", "fashion_mnist"])
def test_segment_tiles_write_every_output_once(arch, span, batch):
    low = _lowered(arch, span)
    tiles = low.tiles(batch)
    assert len(tiles) == len(low.desc)
    assert low.max_tiles(batch) == max(len(t) for t in tiles)
    for row, tab in zip(low.desc.tolist(), tiles):
        n_rows = batch * row[T_SF.F_ROWS]
        cols = row[T_SF.F_COLS]
        fused_step = row[T_SF.F_KIND] in (T_SF.OP_CONV, T_SF.OP_FC) and row[
            T_SF.F_STEP]
        out_cols = cols // PACK_W if fused_step else cols
        hits = np.zeros((n_rows, out_cols), np.int64)
        for r0, r1, c0, c1 in tab.tolist():
            assert 0 <= r0 < r1 <= n_rows and 0 <= c0 < c1 <= cols
            assert r1 - r0 <= row[T_SF.F_TILE_R]
            assert c1 - c0 <= row[T_SF.F_TILE_C]
            if fused_step:
                assert c0 % PACK_W == 0 and (c1 - c0) % PACK_W == 0
            hits[_written(row, r0, r1, c0, c1)] += 1
        assert (hits == 1).all(), (row, int(hits.min()), int(hits.max()))
        # the op's output per example is its rows x out-columns
        per_example = row[T_SF.F_ROWS] * out_cols
        if row[T_SF.F_DST] == T_SF.BUF_OUT:
            assert per_example == int(np.prod(low.out_shape))
        else:
            assert per_example <= low.scratch_elems


@pytest.mark.parametrize("arch", ["cifar10", "fashion_mnist"])
def test_segment_gemm_tiles_fit_the_kernel(arch):
    low = _lowered(arch, "whole")
    gemm = [r for r in low.desc.tolist()
            if r[T_SF.F_KIND] in (T_SF.OP_CONV, T_SF.OP_FC)]
    assert gemm
    for r in gemm:
        kw = 9 * r[T_SF.F_C] if r[T_SF.F_KIND] == T_SF.OP_CONV else r[T_SF.F_C]
        patch = (4 if r[T_SF.F_POOL] else 1) * kw
        tr, tc = r[T_SF.F_TILE_R], r[T_SF.F_TILE_C]
        assert tr % T_SF.TILE_ROWS == 0 and tr <= T_SF.MAX_TILE_ROWS
        assert tc in T_SF.GEMM_TILE_COLS
        # the weight slab and the patch rows fit the staged shared memory
        assert kw * tc + tr * patch <= low.smem_words
        if tr > T_SF.TILE_ROWS:
            assert tr * patch * tc <= T_SF.TILE_WORD_OPS
        if r[T_SF.F_STEP]:
            assert r[T_SF.F_N] % tc == 0
    assert 4 * low.smem_words <= T_SF.MAX_SMEM_BYTES


def test_segment_tile_shapes_of_the_cifar10_net():
    low = _lowered("cifar10", "whole")
    # C64 x2, C256 x2, C512 x2, FC1024, FC10: the widest channel tile
    # whose slab fits 8192 words and divides the channels
    assert low.desc[:, T_SF.F_TILE_C].tolist() == [
        64, 64, 128, 64, 64, 32, 32, 32]
    assert low.desc[:, T_SF.F_ROWS].tolist() == [
        1024, 256, 256, 64, 64, 16, 1, 1]
    # C64 over 1 input word: 9 words a row, 32 rows a tile; FC10 over 32
    # words at 32 channels: 32 rows; the rest one row per warp
    assert low.desc[:, T_SF.F_TILE_R].tolist() == [32, 8, 8, 8, 8, 8, 8, 32]
    # FC1024: a 256 x 32 slab and 8 rows of 256 words (C512 + pool
    # stages 144 x 32 + 8 x 4 x 144)
    assert low.smem_words == 256 * 32 + 8 * 256
    # at the DP's batch 16: the first C256 has the most tiles
    assert low.max_tiles(16) == (16 * 256 // 8) * (256 // 128)
    assert len(low.tiles(16)[5]) == (16 * 16 // 8) * (512 // 32)
    assert low.reads_input_as_int4 is False    # 1 word per input pixel


def test_flash_alignment_rule_for_bf16_operands():
    base = torch.zeros(2 * 3 * 10 * 64 + 8, dtype=torch.bfloat16)
    ok = base[:2 * 3 * 10 * 64].view(2, 10, 3, 64).transpose(1, 2)
    check_aligned(ok)                           # (B,S,H,D) view: fine
    with pytest.raises(ValueError, match="16-byte"):
        check_aligned(base[1:1 + 2 * 3 * 10 * 64].view(2, 3, 10, 64))
    odd_rows = torch.zeros(2, 3, 10, 68, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="16-byte"):
        check_aligned(odd_rows)                 # rows of 136 bytes
    check_aligned(torch.zeros(2, 3, 10, 72, dtype=torch.bfloat16)[..., :64])
