"""A whole device segment as one CUDA launch, activations bit-packed
between its layers.

The per-layer executors launch one kernel per layer and let every
conv/fc write its unpacked int32 pre-activations back to device memory,
only for the following step layer to read them again, threshold and
repack.  ``segment_cuda`` runs the segment's layer chain — conv (patch
gather + xnor GEMM), 2x2 max-pool, step (threshold + bit-plane repack),
flatten, fc — in one persistent cooperative launch of
``csrc/segment_fused.cu``: the whole batch moves through the net layer
by layer on every SM, with a grid-wide barrier between layers.  Each
layer's outputs over the batch, (B x rows) x cols, are cut into tiles
whose shape :class:`_Lowered` writes into the descriptor table
(:meth:`_Lowered.tiles` enumerates them as the kernel does); only the
grid size comes from the card.  It replaces the Pallas TPU kernel
``repro.kernels.segment_fused.build_pallas_segment``.

Builder signature (segment scope, as the registry expects):
``segment_cuda(specs, packed_params, in_encoding=None) -> fn(x) -> out``
over the segment's layer slice.  ``in_encoding`` ("packed" /
"unpacked") disambiguates a segment that *starts* with maxpool layers
(mp preserves either encoding); for any other first layer it is implied
by the layer kind.

On a CPU tensor ``fn`` computes the plain chain (:func:`_run_chain`); on
a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence

import numpy as np
import torch

from repro_torch.bnn import layers as L
from repro_torch.bnn.binarize import PACK_W
from repro_torch.bnn.models import params_to
from repro_torch.kernels import build

PACKED = "packed"
UNPACKED = "unpacked"

# layer kinds whose input encoding is implied by the kind itself
_IN_ENCODING = {
    "conv": PACKED, "fc": PACKED, "flat": PACKED, "step": UNPACKED,
}
#: the kinds the kernel lowers (the packed grammar); a span holding any
#: other is never profiled or chosen for fusion
LOWERED_KINDS = ("conv", "mp", "step", "flat", "fc")


def lowerable(specs: Sequence[L.LayerSpec]) -> bool:
    """Whether ``segment_cuda`` can lower the span `specs`."""
    return all(spec.kind in LOWERED_KINDS for spec in specs)

# descriptor table layout — must match csrc/segment_fused.cu
OP_CONV, OP_FC, OP_POOL, OP_STEP, OP_COPY = range(5)
BUF_IN, BUF_OUT, BUF_S0, BUF_S1 = range(4)
(F_KIND, F_SRC, F_DST, F_H, F_W, F_C, F_N, F_KTRUE, F_POOL, F_STEP,
 F_WOFF, F_TOFF, F_FOFF, F_ROWS, F_COLS, F_TILE_R, F_TILE_C,
 DESC_INTS) = range(18)

# Tiles of a layer's (B x rows) x cols outputs.  A conv/fc tile is at
# least one output row per warp of the kernel's 256-thread block by 32,
# 64 or 128 channels; it stages its weight slab (Kw x tile columns
# words, within SLAB_WORDS where the layer allows) and its patch rows
# (tile rows x pooling positions x Kw words) in shared memory.  Layers
# with little work per row take more rows per tile, up to about
# TILE_WORD_OPS word-ops, so a tile's fixed cost (two barriers, one
# round of copies) is spread.
TILE_ROWS = 8
MAX_TILE_ROWS = 64
TILE_WORD_OPS = 32768
GEMM_TILE_COLS = (128, 64, 32)
SLAB_WORDS = 8192                 # 32 KB
MAX_SMEM_BYTES = 232448           # the most an H100 block may take
ELEMENTWISE_TILE = (8, 128)       # pool, step
COPY_TILE = (1, 1024)


def infer_in_encoding(specs: Sequence[L.LayerSpec]) -> str:
    """The encoding a segment's input must arrive in, from its first
    non-mp layer (mp preserves either).  An all-mp segment defaults to
    unpacked — pooling packed words would OR bitplanes, which no valid
    chain produces mid-network without an adjacent non-mp layer."""
    for spec in specs:
        if spec.kind in _IN_ENCODING:
            return _IN_ENCODING[spec.kind]
    return UNPACKED


def encoded_shape(shape: tuple, encoding: str) -> tuple:
    """Per-example array shape for a logical (unpacked) layer shape
    under `encoding`: packed divides the channel axis into 32-bit
    words; every other encoding (unpacked int32, and a real network's
    uint8 images and float32 activations) keeps one element a value."""
    if encoding != PACKED:
        return tuple(shape)
    return tuple(shape[:-1]) + (math.ceil(shape[-1] / PACK_W),)


def segment_out_encoding(
    specs: Sequence[L.LayerSpec], in_encoding: str
) -> str:
    enc = in_encoding
    for spec in specs:
        if spec.kind in ("conv", "fc"):
            enc = UNPACKED
        elif spec.kind == "step":
            enc = PACKED
        elif spec.kind == "flat":
            enc = PACKED
    return enc


def _run_chain(specs: Sequence[L.LayerSpec], packed_params, x):
    """The segment's plain layer chain on a batched tensor — the
    semantics the kernel is held to."""
    for spec, p in zip(specs, packed_params):
        if spec.kind == "conv":
            x = L.conv_packed(x, p["w_words"], p["k_true"])
        elif spec.kind == "mp":
            x = L.maxpool_packed(x)
        elif spec.kind == "step":
            x = L.step_packed(x, p["thresh"], p["flip"])
        elif spec.kind == "flat":
            x = L.flat_packed(x, spec.in_shape[-1])
        elif spec.kind == "fc":
            x = L.fc_packed(x, p["w_words"], p["k_true"])
        else:
            raise ValueError(spec.kind)
    return x


def segment_weight_bytes(packed_params) -> int:
    """Bytes of parameter data the fused kernel reads."""
    total = 0
    for p in packed_params:
        for v in p.values():
            if isinstance(v, torch.Tensor):
                total += v.numel() * 4
    return total


def segment_gemm_work(
    specs: Sequence[L.LayerSpec], packed_params, batch: int
) -> int:
    """Total word-level MAC count of the segment's GEMM layers at
    `batch` (``GemmShape.work`` summed)."""
    work = 0
    for spec, p in zip(specs, packed_params):
        if spec.kind not in ("conv", "fc"):
            continue
        n, kw = (int(d) for d in p["w_words"].shape)
        pwin = spec.in_shape[0] * spec.in_shape[1] if spec.kind == "conv" else 1
        work += batch * pwin * n * kw
    return work


# ---------------------------------------------------------------------------
# Lowering: layer slice -> descriptor table + flat parameter buffer
# ---------------------------------------------------------------------------


class _Lowered:
    """The kernel's view of a segment: op descriptors, the parameter
    tensors in buffer order, and the per-example edge/scratch sizes."""

    def __init__(self, specs, packed_params, in_encoding):
        self.in_shape = encoded_shape(specs[0].in_shape, in_encoding)
        self.out_shape = encoded_shape(
            specs[-1].out_shape, segment_out_encoding(specs, in_encoding)
        )
        self.params: list = []      # 1-D int32 tensors, buffer order
        self._off = 0
        self.smem_words = 0         # the largest conv/fc tile's staging
        ops: list = []              # (descriptor row, output elements)
        shape, enc = self.in_shape, in_encoding
        i, n = 0, len(specs)
        while i < n:
            spec, p = specs[i], packed_params[i]
            row = [0] * DESC_INTS
            if spec.kind in ("conv", "fc"):
                _need(enc, PACKED, spec)
                units, kw = (int(d) for d in p["w_words"].shape)
                row[F_N], row[F_KTRUE] = units, int(p["k_true"])
                # (Kw, N): a warp's neurons read consecutive words
                row[F_WOFF] = self._add(p["w_words"].t())
                j = i + 1
                if spec.kind == "conv":
                    h, w, cw = shape
                    if kw != 9 * cw:
                        raise ValueError(
                            f"layer {spec.idx}: {kw} weight words for "
                            f"{cw} input words"
                        )
                    row[F_KIND], row[F_H], row[F_W], row[F_C] = (
                        OP_CONV, h, w, cw)
                    if j < n and specs[j].kind == "mp":
                        _even(h, w, specs[j])
                        row[F_POOL], h, w = 1, h // 2, w // 2
                        j += 1
                    shape = (h, w, units)
                    rows = h * w
                else:
                    if shape != (kw,):
                        raise ValueError(
                            f"layer {spec.idx}: fc over {kw} words got "
                            f"input {shape}"
                        )
                    row[F_KIND], row[F_C] = OP_FC, kw
                    shape = (units,)
                    rows = 1
                row[F_ROWS], row[F_COLS] = rows, units
                tc = _gemm_tile_cols(kw, units)
                patch = (4 if row[F_POOL] else 1) * kw   # words per row
                tr = _gemm_tile_rows(patch, tc)
                row[F_TILE_R], row[F_TILE_C] = tr, tc
                self.smem_words = max(self.smem_words, kw * tc + tr * patch)
                enc = UNPACKED
                # threshold + repack in the GEMM epilogue: one warp
                # ballot per 32 consecutive channels
                if j < n and specs[j].kind == "step" and units % PACK_W == 0:
                    sp = packed_params[j]
                    row[F_STEP] = 1
                    row[F_TOFF] = self._add(sp["thresh"])
                    row[F_FOFF] = self._add(sp["flip"])
                    shape = shape[:-1] + (units // PACK_W,)
                    enc = PACKED
                    j += 1
                i = j
            elif spec.kind == "mp":
                h, w, c = shape
                _even(h, w, spec)
                row[F_KIND], row[F_H], row[F_W], row[F_C] = OP_POOL, h, w, c
                row[F_ROWS], row[F_COLS] = (h // 2) * (w // 2), c
                row[F_TILE_R], row[F_TILE_C] = ELEMENTWISE_TILE
                shape = (h // 2, w // 2, c)
                i += 1
            elif spec.kind == "step":
                _need(enc, UNPACKED, spec)
                c = shape[-1]
                row[F_KIND], row[F_H], row[F_W], row[F_C] = (
                    OP_STEP, int(np.prod(shape[:-1])), 1, c)
                row[F_ROWS], row[F_COLS] = row[F_H], math.ceil(c / PACK_W)
                row[F_TILE_R], row[F_TILE_C] = ELEMENTWISE_TILE
                row[F_TOFF] = self._add(p["thresh"])
                row[F_FOFF] = self._add(p["flip"])
                shape = shape[:-1] + (math.ceil(c / PACK_W),)
                enc = PACKED
                i += 1
            elif spec.kind == "flat":
                _need(enc, PACKED, spec)
                if spec.in_shape[-1] % PACK_W != 0:
                    raise ValueError("flatten of packed words needs C % 32 == 0")
                shape = (int(np.prod(shape)),)    # same memory layout
                i += 1
                continue
            else:
                raise ValueError(spec.kind)
            ops.append((row, int(np.prod(shape))))
        if shape != self.out_shape:  # pragma: no cover - lowering invariant
            raise AssertionError((shape, self.out_shape))
        if not ops:   # a flatten-only segment still has to move its data
            row = [0] * DESC_INTS
            row[F_KIND], row[F_C] = OP_COPY, int(np.prod(shape))
            row[F_ROWS], row[F_COLS] = 1, row[F_C]
            row[F_TILE_R], row[F_TILE_C] = COPY_TILE
            ops.append((row, row[F_C]))
        for k, (row, _) in enumerate(ops):
            row[F_SRC] = BUF_IN if k == 0 else (BUF_S0, BUF_S1)[(k - 1) % 2]
            row[F_DST] = BUF_OUT if k == len(ops) - 1 else (BUF_S0, BUF_S1)[k % 2]
        self.desc = np.asarray([r for r, _ in ops], np.int32)
        self.scratch_elems = max([e for _, e in ops[:-1]], default=0)
        if 4 * self.smem_words > MAX_SMEM_BYTES:
            raise ValueError(
                f"a tile staging {self.smem_words} words exceeds a "
                f"block's {MAX_SMEM_BYTES} bytes of shared memory")

    def tiles(self, batch: int) -> list:
        """Per op, the kernel's tiles at `batch` in the order the blocks
        take them (columns fastest): an int array (n_tiles, 4) of rows
        [r0, r1) of the op's (batch x rows) outputs and columns [c0, c1).
        Columns are channels for conv/fc (a fused step writes words
        c0/32 .. c1/32), elements for pool and copy, words for step."""
        out = []
        for row in self.desc.tolist():
            n_rows = batch * row[F_ROWS]
            tr, tc, cols = row[F_TILE_R], row[F_TILE_C], row[F_COLS]
            rt, ct = np.meshgrid(np.arange(-(-n_rows // tr)),
                                 np.arange(-(-cols // tc)), indexing="ij")
            r0, c0 = rt.reshape(-1) * tr, ct.reshape(-1) * tc
            out.append(np.stack([r0, np.minimum(r0 + tr, n_rows), c0,
                                 np.minimum(c0 + tc, cols)], axis=1))
        return out

    def max_tiles(self, batch: int) -> int:
        """The largest op's tile count at `batch` (the grid's cap)."""
        return max(-(-batch * r[F_ROWS] // r[F_TILE_R])
                   * -(-r[F_COLS] // r[F_TILE_C]) for r in self.desc.tolist())

    @property
    def reads_input_as_int4(self) -> bool:
        """Whether the first op reads the input 16 bytes at a time (a
        conv/fc over a multiple of 4 words), so it must be aligned."""
        first = self.desc[0]
        return (int(first[F_KIND]) in (OP_CONV, OP_FC)
                and int(first[F_C]) % 4 == 0)

    def _add(self, t: torch.Tensor) -> int:
        off = self._off
        self.params.append(t.reshape(-1).to(torch.int32))
        self._off += t.numel()
        return off


def _gemm_tile_cols(kw: int, units: int) -> int:
    """Channels per conv/fc tile: the widest of 128, 64, 32 that divides
    the layer's channels (so a fused step's ballots see whole words) and
    keeps the weight slab within SLAB_WORDS; 32 for ragged layers."""
    for tc in GEMM_TILE_COLS:
        if units % tc == 0 and kw * tc <= SLAB_WORDS:
            return tc
    return GEMM_TILE_COLS[-1]


def _gemm_tile_rows(patch_words: int, tile_cols: int) -> int:
    """Rows per conv/fc tile: TILE_ROWS, or the largest power of two up
    to MAX_TILE_ROWS whose tile stays within TILE_WORD_OPS word-ops."""
    rows = TILE_ROWS
    while (2 * rows <= MAX_TILE_ROWS
           and 2 * rows * patch_words * tile_cols <= TILE_WORD_OPS):
        rows *= 2
    return rows


def _need(enc: str, want: str, spec) -> None:
    if enc != want:
        raise ValueError(
            f"layer {spec.idx} ({spec.kind}) needs {want} input, "
            f"segment carries {enc}"
        )


def _even(h: int, w: int, spec) -> None:
    if h % 2 or w % 2:
        raise ValueError(f"layer {spec.idx}: 2x2 pool of odd {h}x{w}")


def segment_cuda(
    specs: Sequence[L.LayerSpec],
    packed_params,
    in_encoding: str | None = None,
):
    """The segment as one launch of the fused kernel: returns
    ``fn(x) -> out`` over (B, *in_shape) int32 in the segment's edge
    encodings.  One persistent cooperative launch over the card; after
    a launch ``fn.grid`` holds its block count."""
    specs = tuple(specs)
    packed_params = list(packed_params)
    if in_encoding is None:
        in_encoding = infer_in_encoding(specs)
    low = _Lowered(specs, packed_params, in_encoding)
    on_device: dict = {}   # device -> (params, desc) tensors

    def buffers(dev):
        if dev not in on_device:
            flat = (
                torch.cat([t.to(dev) for t in low.params])
                if low.params else torch.zeros(1, dtype=torch.int32)
            )
            on_device[dev] = (
                flat.to(dev).contiguous(),
                torch.as_tensor(low.desc, device=dev).contiguous(),
            )
        return on_device[dev]

    def run(x: torch.Tensor) -> torch.Tensor:
        if x.dtype != torch.int32 or tuple(x.shape[1:]) != low.in_shape:
            raise ValueError(
                f"segment expects (B, {low.in_shape}) int32, got "
                f"{tuple(x.shape)} {x.dtype}"
            )
        if x.device.type == "cpu":
            return _run_chain(
                specs, [params_to(p, x.device) for p in packed_params], x
            )
        if x.device.type != "cuda":
            raise ValueError(f"segment_cuda: unsupported device {x.device}")
        if not x.is_contiguous():
            raise ValueError("segment_cuda needs a contiguous input")
        if low.reads_input_as_int4 and x.data_ptr() % 16:
            raise ValueError("segment_cuda needs a 16-byte aligned input")
        b = x.shape[0]
        out = torch.empty((b,) + low.out_shape, dtype=torch.int32,
                          device=x.device)
        if b == 0:
            return out
        params, desc = buffers(x.device)
        # two ping-pong planes of b examples; rows of 16 bytes for the
        # kernel's int4 reads
        stride = -(-max(low.scratch_elems, 1) // 4) * 4
        scratch = torch.empty(2 * b * stride, dtype=torch.int32,
                              device=x.device)
        lib = build.load_library("segment_fused")
        grid = ctypes.c_int(0)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            rc = lib.segment_fused_launch(
                x.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                params.data_ptr(), desc.data_ptr(), int(desc.shape[0]), b,
                int(np.prod(low.in_shape)), int(np.prod(low.out_shape)),
                stride, low.max_tiles(b), 4 * low.smem_words,
                ctypes.byref(grid), stream,
            )
        build.check(lib, "segment_fused", rc)
        segment_cuda.launches += 1
        run.grid = grid.value
        return out

    run.grid = None

    return run


segment_cuda.launches = 0
