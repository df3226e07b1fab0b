"""Nested-width BNN subnets as prefix views of one packed model.

A binarized model's inference parameters are bit-packed int32 words
(``repro_torch.bnn.binarize``): conv weights are
``(Cout, 9*ceil(Cin/32))`` word matrices, FC weights
``(Dout, ceil(Din/32))``, step layers a per-channel integer threshold.
Because every hidden width in the paper models (and anything
``build_model`` produces) is a multiple of the 32-bit pack width,
*narrowing a layer is word slicing*: the first ``C/32`` words of each
patch block are exactly what an independently packed ``C``-channel
weight would contain — no tail lanes, no repack.

**Views and copies.**  :func:`slice_packed` returns torch views where
a prefix is a view (a channel prefix of a step layer, a row prefix of
an FC weight whose input width is unchanged, a conv whose input words
are unchanged) and ``reshape`` copies where the prefix is strided (a
conv narrowed on both axes, the FC after a FLAT).  The FC after an FC
narrowed on both axes is a row-strided view — and the CUDA kernels
take contiguous operands only — so :meth:`SubnetFamily.build` makes
every narrowed tensor contiguous once, on the base's device: the
contiguous views keep sharing the base's storage, the strided ones
become copies (:meth:`SubnetFamily.storage` counts both).  The JAX
package's slices copy in the same places (a NumPy reshape of a strided
slice copies), so there too the narrow levels share the base's words
only where the prefix is a view.

:class:`ElasticSpec` names the width fractions (widest first, level 0
always the full model); :class:`SubnetFamily` derives one
:class:`BNNModel` + packed-parameter list per level by slicing the
base model's packed tensors.  Slicing is **bit-exact** against
building the same-width model from scratch (slice the latent fp
weights with :func:`slice_params_fp`, quantize with ``pack_params``):
packing is deterministic LSB-first, widths stay word-aligned, so the
prefix words are byte-identical — property-tested in
``tests/test_elastic.py``.

Level naming: level 0 keeps the base model's name (its profile and
mapping are shared with non-elastic deployments of the same model —
latency depends on architecture, not weights); level ``k > 0`` is
named ``{base}#L{k}``, which tags every store key for that level
(``model_signature`` hashes name + per-layer labels) so the K
mappings live side by side in one
:class:`~repro_torch.store.ProfileStore`.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.bnn.binarize import PACK_W, packed_len
from repro_torch.bnn.layers import LayerSpec, parse_notation
from repro_torch.bnn.models import BNNModel


@dataclasses.dataclass(frozen=True)
class ElasticSpec:
    """Width fractions of the nested subnet family, widest first.

    ``fractions[0]`` must be 1.0 (level 0 is the full model) and the
    rest strictly decreasing in (0, 1).  Each conv/FC width scales as
    ``max(min_units, int(units * fraction))`` floored to a multiple of
    the 32-bit pack width — the same rule ``build_model(scale=)``
    uses, so a family level has exactly the widths of an
    independently-scaled model.  The final FC always maps to
    ``n_classes`` and is never narrowed.
    """

    fractions: tuple = (1.0, 0.5)
    min_units: int = PACK_W

    def __post_init__(self):
        fr = tuple(float(f) for f in self.fractions)
        object.__setattr__(self, "fractions", fr)
        if not fr or fr[0] != 1.0:
            raise ValueError(
                f"fractions must start at 1.0 (the full model), got {fr}"
            )
        if any(not 0.0 < f <= 1.0 for f in fr):
            raise ValueError(f"fractions must lie in (0, 1], got {fr}")
        if any(b >= a for a, b in zip(fr, fr[1:])):
            raise ValueError(
                f"fractions must be strictly decreasing, got {fr}"
            )
        if self.min_units < PACK_W or self.min_units % PACK_W:
            raise ValueError(
                f"min_units must be a positive multiple of {PACK_W}"
            )

    def width(self, units: int, fraction: float) -> int:
        """`units` scaled by `fraction`, word-aligned, floored at
        ``min_units`` — mirrors ``build_model``'s shrink rule."""
        n = max(self.min_units, int(units * fraction))
        return (n // PACK_W) * PACK_W

    def __len__(self) -> int:
        return len(self.fractions)


@dataclasses.dataclass(frozen=True)
class SubnetLevel:
    """One width level: a full :class:`BNNModel` + packed params whose
    weight words are (for ``level > 0``) prefix slices of the base
    model's, each contiguous (a view of the base's storage where the
    prefix is contiguous, else a copy)."""

    level: int
    fraction: float
    model: BNNModel
    packed: list


def level_name(base_name: str, level: int) -> str:
    """The store-visible model name of a family level — level 0 keeps
    the base name, narrower levels carry the ``#L{k}`` tag that keys
    their profiles/mappings apart."""
    return base_name if level == 0 else f"{base_name}#L{level}"


def _narrow_notation(
    model: BNNModel, fraction: float, spec: ElasticSpec
) -> tuple:
    """Paper-notation tokens for `model` narrowed by `fraction`."""
    last_fc = max(
        i for i, s in enumerate(model.specs) if s.kind == "fc"
    )
    tokens = []
    for i, s in enumerate(model.specs):
        if s.kind == "conv":
            tokens.append(f"C{spec.width(s.units, fraction)}")
        elif s.kind == "fc" and i != last_fc:
            tokens.append(f"FC{spec.width(s.units, fraction)}")
        else:
            # the trailing FC maps to n_classes whatever its token
            # says; MP/S/FLAT carry no width
            tokens.append(s.notation)
    return tuple(tokens)


def _check_sliceable(ws: LayerSpec, ns: LayerSpec) -> None:
    """Raise unless the narrow layer is a word-aligned prefix of the
    wide one (the no-repack invariant)."""
    if ws.kind != ns.kind:
        raise ValueError(
            f"layer {ws.idx}: kind mismatch {ws.kind!r} vs {ns.kind!r}"
        )
    if ws.kind == "conv":
        cin_w, cin_n = ws.in_shape[-1], ns.in_shape[-1]
        if cin_n != cin_w and (cin_w % PACK_W or cin_n % PACK_W):
            raise ValueError(
                f"layer {ws.idx}: conv input channels {cin_w} -> "
                f"{cin_n} are not word-aligned; packed prefix slicing "
                "would cross a tail lane"
            )
        if ns.units > ws.units or cin_n > cin_w:
            raise ValueError(
                f"layer {ws.idx}: narrow conv ({cin_n}->{ns.units}) "
                f"exceeds wide ({cin_w}->{ws.units}); levels must nest"
            )
    elif ws.kind == "fc":
        din_w, din_n = ws.in_shape[0], ns.in_shape[0]
        if din_n != din_w and (din_w % PACK_W or din_n % PACK_W):
            raise ValueError(
                f"layer {ws.idx}: fc input width {din_w} -> {din_n} is "
                "not word-aligned"
            )
        if ns.units > ws.units or din_n > din_w:
            raise ValueError(
                f"layer {ws.idx}: narrow fc exceeds wide; levels must "
                "nest"
            )


def slice_packed(
    wide_specs: Sequence[LayerSpec],
    wide_packed: list,
    narrow_specs: Sequence[LayerSpec],
) -> list:
    """Packed params for `narrow_specs` as prefix slices of
    `wide_packed` — zero repacking (module docstring: which slices are
    views and which ``reshape`` copies; an FC after an FC narrowed on
    both axes is a row-strided view, made contiguous by
    :meth:`SubnetFamily.build`).

    Conv words ``(Cout, 9*Cw)`` slice as ``[:cout', :, :cw']`` on the
    ``(Cout, 9, Cw)`` view; FC words after a FLAT slice the word
    columns *per spatial position* (the flattened activation packs
    channels innermost, ``Cw`` words per position); FC-after-FC is a
    contiguous column prefix; step thresholds/flips are channel
    prefixes.  Bit-exact vs an independent pack of the sliced fp
    weights because every narrowed axis stays a multiple of 32 (no
    pad lanes inside the slice)."""
    if len(wide_specs) != len(narrow_specs):
        raise ValueError("wide and narrow models must have equal depth")
    out: list = []
    for i, (ws, ns) in enumerate(zip(wide_specs, narrow_specs)):
        _check_sliceable(ws, ns)
        p = wide_packed[i]
        if ws.kind == "conv":
            cin_w, cout_w = ws.in_shape[-1], ws.units
            cin_n, cout_n = ns.in_shape[-1], ns.units
            if (cin_n, cout_n) == (cin_w, cout_w):
                out.append(p)
                continue
            cw_w, cw_n = packed_len(cin_w), packed_len(cin_n)
            w = p["w_words"].reshape(cout_w, 9, cw_w)
            w = w[:cout_n, :, :cw_n].reshape(cout_n, 9 * cw_n)
            out.append({"w_words": w, "k_true": 9 * cin_n})
        elif ws.kind == "fc":
            din_w, dout_w = ws.in_shape[0], ws.units
            din_n, dout_n = ns.in_shape[0], ns.units
            if (din_n, dout_n) == (din_w, dout_w):
                out.append(p)
                continue
            w = p["w_words"]
            if din_n != din_w:
                prev = wide_specs[i - 1] if i else None
                if prev is not None and prev.kind == "flat":
                    # spatially-flattened input: channel words repeat
                    # per position, so the prefix is strided
                    h, wd, c_w = prev.in_shape
                    c_n = narrow_specs[i - 1].in_shape[-1]
                    cw_w, cw_n = packed_len(c_w), packed_len(c_n)
                    w = w.reshape(dout_w, h * wd, cw_w)
                    w = w[:, :, :cw_n].reshape(dout_w, h * wd * cw_n)
                else:
                    w = w[:, : packed_len(din_n)]
            out.append({"w_words": w[:dout_n], "k_true": din_n})
        elif ws.kind == "step":
            if ns.units == ws.units:
                out.append(p)
            else:
                out.append(
                    {
                        "thresh": p["thresh"][: ns.units],
                        "flip": p["flip"][: ns.units],
                    }
                )
        else:   # mp / flat carry no params
            out.append(p)
    return out


def _contiguous(sliced: list, wide: list) -> list:
    """`sliced` with every narrowed tensor contiguous: layers passed
    through unchanged keep the wide dict, a contiguous slice stays a
    view, a strided one becomes a copy on its own device."""
    return [
        p if p is w else {
            k: v.contiguous() if isinstance(v, torch.Tensor) else v
            for k, v in p.items()
        }
        for p, w in zip(sliced, wide)
    ]


def slice_params_fp(
    wide_specs: Sequence[LayerSpec],
    params_fp: list,
    narrow_specs: Sequence[LayerSpec],
) -> list:
    """Latent fp params sliced to `narrow_specs` — the from-scratch
    reference path (``pack_params`` of this equals
    :func:`slice_packed`'s output bit for bit) and the starting point
    for fine-tuning a narrow level on its own."""
    if len(wide_specs) != len(narrow_specs):
        raise ValueError("wide and narrow models must have equal depth")
    out: list = []
    for i, (ws, ns) in enumerate(zip(wide_specs, narrow_specs)):
        _check_sliceable(ws, ns)
        p = params_fp[i]
        if ws.kind == "conv":
            out.append(
                {"w": p["w"][:, :, : ns.in_shape[-1], : ns.units]}
            )
        elif ws.kind == "fc":
            w = p["w"]                       # (Din, Dout)
            din_n = ns.in_shape[0]
            if din_n != ws.in_shape[0]:
                prev = wide_specs[i - 1] if i else None
                if prev is not None and prev.kind == "flat":
                    h, wd, c_w = prev.in_shape
                    c_n = narrow_specs[i - 1].in_shape[-1]
                    w = w.reshape(h * wd, c_w, -1)[:, :c_n, :]
                    w = w.reshape(din_n, -1)
                else:
                    w = w[:din_n, :]
            out.append({"w": w[:, : ns.units]})
        elif ws.kind == "step":
            out.append({k: v[: ns.units] for k, v in p.items()})
        else:
            out.append(p)
    return out


class SubnetFamily:
    """K nested-width subnets derived from one trained, packed BNN.

    ``levels[0]`` *is* the base model (same objects); every narrower
    level's packed tensors are prefix slices of the base packed
    tensors (:func:`slice_packed`), made contiguous once on the base's
    device so the CUDA kernels take them as they are: the contiguous
    prefixes stay views of the base's storage, the strided ones are
    copies (:meth:`storage`).  Levels are strictly distinct —
    two fractions that clamp to identical widths are rejected, so
    per-level store keys (name + layer labels) can never collide.
    """

    def __init__(self, levels: Sequence[SubnetLevel], spec: ElasticSpec):
        self.levels = tuple(levels)
        self.spec = spec

    @classmethod
    def build(
        cls, model: BNNModel, packed: list, spec: ElasticSpec
    ) -> "SubnetFamily":
        """Derive the family from a packed base model.  `packed` is
        ``pack_params(model.specs, trained_params)`` output."""
        if len(packed) != len(model.specs):
            raise ValueError(
                f"packed params ({len(packed)}) do not match model "
                f"depth ({len(model.specs)})"
            )
        levels = [SubnetLevel(0, 1.0, model, list(packed))]
        seen_widths = {tuple(s.units for s in model.specs)}
        for k, frac in enumerate(spec.fractions[1:], start=1):
            notation = _narrow_notation(model, frac, spec)
            specs = tuple(
                parse_notation(
                    notation, model.input_hw, model.in_channels,
                    model.n_classes,
                )
            )
            widths = tuple(s.units for s in specs)
            if widths in seen_widths:
                raise ValueError(
                    f"level {k} (fraction {frac}) resolves to the same "
                    f"widths as a wider level — min_units clamping "
                    "collapsed it; drop the fraction or widen the model"
                )
            seen_widths.add(widths)
            narrow = BNNModel(
                level_name(model.name, k), specs, model.input_hw,
                model.in_channels, model.n_classes,
            )
            sliced = slice_packed(model.specs, packed, specs)
            levels.append(
                SubnetLevel(k, frac, narrow, _contiguous(sliced, packed))
            )
        return cls(levels, spec)

    def storage(self, k: int) -> dict:
        """Bytes of level `k`'s packed tensors that share the base's
        storage (``shared_bytes``) and that are copies of their own
        (``copied_bytes``); level 0 shares everything."""
        base = {
            v.untyped_storage().data_ptr()
            for p in self.base.packed for v in p.values()
            if isinstance(v, torch.Tensor)
        }
        out = {"shared_bytes": 0, "copied_bytes": 0}
        for p in self.levels[k].packed:
            for v in p.values():
                if isinstance(v, torch.Tensor):
                    key = (
                        "shared_bytes"
                        if v.untyped_storage().data_ptr() in base
                        else "copied_bytes"
                    )
                    out[key] += v.numel() * v.element_size()
        return out

    @property
    def base(self) -> SubnetLevel:
        return self.levels[0]

    def level(self, k: int) -> SubnetLevel:
        return self.levels[k]

    def names(self) -> tuple:
        return tuple(lvl.model.name for lvl in self.levels)

    def __len__(self) -> int:
        return len(self.levels)

    def __iter__(self):
        return iter(self.levels)
