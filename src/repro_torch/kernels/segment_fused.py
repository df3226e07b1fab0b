"""A whole device segment as one CUDA launch, activations bit-packed
between its layers.

The per-layer executors launch one kernel per layer and let every
conv/fc write its unpacked int32 pre-activations back to device memory,
only for the following step layer to read them again, threshold and
repack.  ``segment_cuda`` runs the segment's layer chain — conv (patch
gather + xnor GEMM), 2x2 max-pool, step (threshold + bit-plane repack),
flatten, fc — in one launch of ``csrc/segment_fused.cu``, one block per
example.  It replaces the Pallas TPU kernel
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

# descriptor table layout — must match csrc/segment_fused.cu
OP_CONV, OP_FC, OP_POOL, OP_STEP, OP_COPY = range(5)
BUF_IN, BUF_OUT, BUF_S0, BUF_S1 = range(4)
(F_KIND, F_SRC, F_DST, F_H, F_W, F_C, F_N, F_KTRUE, F_POOL, F_STEP,
 F_WOFF, F_TOFF, F_FOFF, DESC_INTS) = range(14)


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
    words."""
    if encoding == UNPACKED:
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
                else:
                    if shape != (kw,):
                        raise ValueError(
                            f"layer {spec.idx}: fc over {kw} words got "
                            f"input {shape}"
                        )
                    row[F_KIND], row[F_C] = OP_FC, kw
                    shape = (units,)
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
                shape = (h // 2, w // 2, c)
                i += 1
            elif spec.kind == "step":
                _need(enc, UNPACKED, spec)
                c = shape[-1]
                row[F_KIND], row[F_H], row[F_W], row[F_C] = (
                    OP_STEP, int(np.prod(shape[:-1])), 1, c)
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
            ops.append((row, row[F_C]))
        for k, (row, _) in enumerate(ops):
            row[F_SRC] = BUF_IN if k == 0 else (BUF_S0, BUF_S1)[(k - 1) % 2]
            row[F_DST] = BUF_OUT if k == len(ops) - 1 else (BUF_S0, BUF_S1)[k % 2]
        self.desc = np.asarray([r for r, _ in ops], np.int32)
        self.scratch_elems = max([e for _, e in ops[:-1]], default=0)

    def _add(self, t: torch.Tensor) -> int:
        off = self._off
        self.params.append(t.reshape(-1).to(torch.int32))
        self._off += t.numel()
        return off


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
    encodings.  Grid (B,), one block per example."""
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
        b = x.shape[0]
        out = torch.empty((b,) + low.out_shape, dtype=torch.int32,
                          device=x.device)
        if b == 0:
            return out
        params, desc = buffers(x.device)
        stride = max(low.scratch_elems, 1)
        scratch = torch.empty(b * 2 * stride, dtype=torch.int32,
                              device=x.device)
        lib = build.load_library("segment_fused")
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            rc = lib.segment_fused_launch(
                x.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                params.data_ptr(), desc.data_ptr(), int(desc.shape[0]), b,
                int(np.prod(low.in_shape)), int(np.prod(low.out_shape)),
                stride, stream,
            )
        build.check(lib, "segment_fused", rc)
        segment_cuda.launches += 1
        return out

    return run


segment_cuda.launches = 0
