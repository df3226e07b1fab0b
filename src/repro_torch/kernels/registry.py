"""Kernel-variant registry — the searchable per-layer GEMM space.

The paper fixes 8 implementations per layer (CPU + 7 aspect configs).
Every implementation of the packed xnor GEMM declares

* a unique ``name`` (what ``ProfileTable`` rows, mappings and JSON
  carry — the registry is the single resolver from name to code);
* a ``placement`` (``"host"`` or ``"device"`` — what the mapper's
  boundary-cost model keys on);
* a ``builder`` ``(a, w, k_true) -> out`` over packed operands
  ``a (B,P,Kw) int32``, ``w (N,Kw) int32``;
* an ``applicable(shape, platform)`` predicate gating which layer
  shapes / platforms the variant may be timed on.

``DEFAULT_REGISTRY`` ships the paper's 8 configs with the JAX package's
names, placements and aspects, so an ``EfficientConfiguration`` written
by either package loads in the other:

* ``CPU`` — the plain xnor GEMM on host tensors (``ref.xnor_gemm_ref``):
  the mapping's choice of the host processor, not a fallback;
* ``X`` ... ``XYZ`` — the CUDA xnor GEMM (``xnor_gemm_cuda``) launched
  with those aspects as grid dimensions;

plus the port's kernel-1 tile variants ``cuda_p16n64``, ``cuda_p32n64``
and ``cuda_p64n32`` — ``xnor_gemm_cuda`` with aspects XYZ under that
``p_blk`` x ``n_blk`` tile, the autotune sweep's extension of the space
(the counterpart of the JAX package's ``pallas_p{p}n{n}``; its 128-wide
tiles exceed the CUDA kernel's 64-wide block tile) — and one
segment-scope variant, ``seg_cuda`` — a whole device segment as one
launch of the fused CUDA kernel (``segment_cuda``).

The JAX package's ``xla_fused`` and ``seg_xla`` are XLA compositions of
the plain version; the port has no counterpart (with a card present the
plain version serves nothing), so they stay reference-only.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable

import torch

from repro_torch.kernels.ref import xnor_gemm_ref
from repro_torch.kernels.segment_fused import (
    segment_cuda,
    segment_gemm_work,
    segment_weight_bytes,
)
from repro_torch.kernels.xnor_popcount import (
    N_BLK,
    P_BLK,
    _fit_tile,
    xnor_gemm_cuda,
)

HOST = "host"
DEVICE = "device"
ASPECT_NAMES = ("X", "Y", "Z", "XY", "XZ", "YZ", "XYZ")
# kernel 1's tile variants (p_blk windows, n_blk neurons a block); 64 x 64
# is the fixed XYZ launch itself
TILE_VARIANTS = ((16, 64), (32, 64), (64, 32))
ASPECTS_XYZ = ("X", "Y", "Z")
# the most word-level MACs a tile variant is timed at on CPU tensors,
# where xnor_gemm_cuda computes its plain version
PLAIN_MAX_WORK = 1 << 22

# variant scopes: a "layer" variant implements one packed xnor-GEMM
# dispatch (builder (a, w, k_true) -> out); a "segment" variant
# implements a whole same-placement layer run as one fused launch
# (builder (specs, packed_params, in_encoding=None) -> fn(x)).
SCOPE_LAYER = "layer"
SCOPE_SEGMENT = "segment"
SCOPES = (SCOPE_LAYER, SCOPE_SEGMENT)

# The paper's 8 names are resolvable without the registry
# (`core.parallel_config` short-circuits on them), so their placement
# and aspects are frozen: re-registering one with another builder is
# allowed, changing its placement or aspects is not.
_FIXED8_META = {
    "CPU": (HOST, ()),
    **{name: (DEVICE, tuple(name)) for name in ASPECT_NAMES},
}


@dataclasses.dataclass(frozen=True)
class GemmShape:
    """Shape of one packed xnor-GEMM dispatch — what applicability
    predicates see.  ``b`` batch, ``p`` windows per image (1 for FC),
    ``n`` output neurons, ``kw`` packed reduction words."""

    b: int
    p: int
    n: int
    kw: int

    @property
    def work(self) -> int:
        """Word-level MAC count."""
        return self.b * self.p * self.n * self.kw


@dataclasses.dataclass(frozen=True)
class SegmentShape:
    """Shape of one fused-segment dispatch — what segment-scope
    applicability predicates see.  ``b`` batch, ``n_layers`` layers in
    the span, ``work`` total word-level GEMM MACs, ``weight_bytes``
    parameter bytes the segment reads."""

    b: int
    n_layers: int
    work: int
    weight_bytes: int


def segment_shape_of(specs, packed_params, batch: int) -> SegmentShape:
    """The :class:`SegmentShape` of a layer slice at `batch`."""
    return SegmentShape(
        b=batch,
        n_layers=len(tuple(specs)),
        work=segment_gemm_work(specs, packed_params, batch),
        weight_bytes=segment_weight_bytes(packed_params),
    )


def current_platform() -> str:
    """``"cuda"`` when a CUDA device is present, else ``"cpu"``."""
    return "cuda" if torch.cuda.is_available() else "cpu"


@dataclasses.dataclass(frozen=True)
class KernelVariant:
    """One registered implementation of the packed xnor GEMM."""

    name: str
    # layer scope: (a, w, k_true) -> (B, P, N) int32
    # segment scope: (specs, packed_params, in_encoding=None) -> fn(x)
    builder: Callable
    placement: str = DEVICE      # HOST or DEVICE (mapper boundary model)
    scope: str = SCOPE_LAYER     # SCOPE_LAYER or SCOPE_SEGMENT
    # pricing metadata, the reference's fields and defaults: grid order
    # from `aspects`, block sizes from p_blk/n_blk (None: kernel 1's
    # 64 x 64, ``core.cost_model.variant_analytics``), and `analytic`
    # the traffic model: "tiled" (loop-nest reuse), "fused" (one pass
    # over the operands) or "host" (CPU side).  The profile store's
    # registry hash reads all of them.
    aspects: tuple = ("X", "Y", "Z")
    p_blk: int | None = None
    n_blk: int | None = None
    analytic: str = "tiled"
    applicable: Callable | None = None   # (shape, platform) -> bool
    description: str = ""

    def applies_to(self, shape, platform: str | None = None) -> bool:
        if self.applicable is None:
            return True
        return bool(
            self.applicable(
                shape, platform if platform is not None else current_platform()
            )
        )


class VariantRegistry:
    """Name -> KernelVariant store with applicability filtering."""

    def __init__(self):
        self._variants: dict = {}

    def register(
        self, variant: KernelVariant, *, replace: bool = False
    ) -> KernelVariant:
        if not variant.name:
            raise ValueError("variant needs a non-empty name")
        if variant.placement not in (HOST, DEVICE):
            raise ValueError(
                f"variant {variant.name!r}: placement must be "
                f"{HOST!r} or {DEVICE!r}, got {variant.placement!r}"
            )
        if variant.scope not in SCOPES:
            raise ValueError(
                f"variant {variant.name!r}: scope must be one of "
                f"{SCOPES}, got {variant.scope!r}"
            )
        if variant.name in self._variants and not replace:
            raise ValueError(
                f"variant {variant.name!r} already registered "
                "(pass replace=True to override)"
            )
        frozen = _FIXED8_META.get(variant.name)
        if frozen is not None and (
            variant.placement, tuple(variant.aspects)
        ) != frozen:
            raise ValueError(
                f"variant {variant.name!r} is a fixed-8 name with "
                f"frozen placement/aspects {frozen}; register the new "
                "semantics under a different name"
            )
        self._variants[variant.name] = variant
        return variant

    def get(self, name: str) -> KernelVariant:
        try:
            return self._variants[name]
        except KeyError:
            raise ValueError(
                f"unknown kernel variant {name!r}; registered: "
                f"{sorted(self._variants)}"
            ) from None

    def remove(self, name: str) -> KernelVariant:
        """Unregister and return `name` (ValueError if absent)."""
        return self._variants.pop(self.get(name).name)

    def __contains__(self, name: str) -> bool:
        return name in self._variants

    def __iter__(self):
        return iter(self._variants.values())

    def __len__(self) -> int:
        return len(self._variants)

    def names(self) -> tuple:
        return tuple(self._variants)

    def applicable(
        self, shape: GemmShape, platform: str | None = None
    ) -> tuple:
        """Layer-scope variants timeable for `shape` on `platform`,
        registration order."""
        return tuple(
            v for v in self._variants.values()
            if v.scope == SCOPE_LAYER and v.applies_to(shape, platform)
        )

    def applicable_segments(
        self, shape: SegmentShape, platform: str | None = None
    ) -> tuple:
        """Segment-scope variants timeable for a fused span of `shape`
        (``core.profiler.profile_segment_variants``'s candidates)."""
        return tuple(
            v for v in self._variants.values()
            if v.scope == SCOPE_SEGMENT and v.applies_to(shape, platform)
        )

    def segment_names(self) -> tuple:
        """Names of the registered segment-scope variants."""
        return tuple(
            v.name for v in self._variants.values()
            if v.scope == SCOPE_SEGMENT
        )

    def placement_of(self, name: str) -> str:
        return self.get(name).placement


def host_xnor_gemm(a: torch.Tensor, w: torch.Tensor, k_true: int):
    """The ``CPU`` config: the plain xnor GEMM on host tensors.  It is
    the host processor's implementation, so a CUDA operand is a
    placement error, never something to compute here."""
    if a.device.type != "cpu" or w.device.type != "cpu":
        raise ValueError(
            f"the CPU config runs on host tensors, got {a.device}/{w.device}"
        )
    return xnor_gemm_ref(a, w, k_true)


def _tile_applicable(p_blk: int, n_blk: int) -> Callable:
    """A tile variant applies where its fitted tiles launch differently
    from XYZ's (on an FC layer, P = 1, a 16- and a 64-row tile are the
    same launch), on the card at any size and on the CPU up to
    ``PLAIN_MAX_WORK``."""

    def applicable(shape: GemmShape, platform: str) -> bool:
        own = (_fit_tile(p_blk, shape.p), _fit_tile(n_blk, shape.n))
        xyz = (_fit_tile(P_BLK, shape.p), _fit_tile(N_BLK, shape.n))
        return own != xyz and (
            platform == "cuda" or shape.work <= PLAIN_MAX_WORK
        )

    return applicable


def _register_defaults(reg: VariantRegistry) -> VariantRegistry:
    reg.register(
        KernelVariant(
            name="CPU",
            builder=host_xnor_gemm,
            placement=HOST,
            aspects=(),
            analytic="host",
            description="paper's sequential CPU implementation on host "
            "tensors (no boundary cost)",
        )
    )
    for name in ASPECT_NAMES:
        reg.register(
            KernelVariant(
                name=name,
                builder=partial(xnor_gemm_cuda, aspects=tuple(name)),
                placement=DEVICE,
                aspects=tuple(name),
                analytic="tiled",
                description=f"CUDA xnor GEMM, {name} as grid dimensions, "
                "the other aspects serial inside the block",
            )
        )
    for p_blk, n_blk in TILE_VARIANTS:
        reg.register(
            KernelVariant(
                name=f"cuda_p{p_blk}n{n_blk}",
                builder=partial(xnor_gemm_cuda, aspects=ASPECTS_XYZ,
                                p_blk=p_blk, n_blk=n_blk),
                placement=DEVICE,
                aspects=ASPECTS_XYZ,
                p_blk=p_blk,
                n_blk=n_blk,
                analytic="tiled",
                applicable=_tile_applicable(p_blk, n_blk),
                description=f"CUDA xnor GEMM, XYZ, {p_blk} x {n_blk} "
                "window/neuron tiles",
            )
        )
    reg.register(
        KernelVariant(
            name="seg_cuda",
            builder=segment_cuda,
            placement=DEVICE,
            scope=SCOPE_SEGMENT,
            aspects=("X",),
            analytic="fused",
            description="whole device segment as one persistent "
            "cooperative CUDA launch, the batch layer by layer over every "
            "SM, pool/threshold/repack fused into the GEMM epilogue",
        )
    )
    return reg


#: The process-wide default registry (the paper's 8, the tile variants,
#: ``seg_cuda``).
DEFAULT_REGISTRY = _register_defaults(VariantRegistry())


def register(variant: KernelVariant, *, replace: bool = False) -> KernelVariant:
    """Register `variant` in the default registry."""
    return DEFAULT_REGISTRY.register(variant, replace=replace)


def get_variant(name: str) -> KernelVariant:
    return DEFAULT_REGISTRY.get(name)
