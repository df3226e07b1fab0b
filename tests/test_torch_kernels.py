"""The port's kernel modules against the JAX package's Pallas kernels
(run in interpret mode, as the JAX package's own tests run them on the
CPU): the xnor GEMM under all 7 aspect configurations with ragged
tiles, and the fused-segment chain over whole nets, tail spans and
spans that start at a max-pool.  The CUDA kernels themselves run only
on the card (``tests/test_torch_cuda.py``); here the wrappers take their
plain versions because the tensors lie on the CPU, and the segment
kernel's lowering is checked by interpreting its descriptor table."""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.bnn import models as R_M  # noqa: E402
from repro.kernels import segment_fused as R_SF  # noqa: E402
from repro.kernels.ref import xnor_gemm_ref as r_xnor_gemm_ref  # noqa: E402
from repro.kernels.xnor_popcount import xnor_gemm_pallas  # noqa: E402
from repro_torch.bnn import layers as T_L  # noqa: E402
from repro_torch.bnn import models as T_M  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    DEFAULT_REGISTRY,
    launch_counts,
    reset_launch_counts,
    segment_cuda,
    xnor_gemm_cuda,
)
from repro_torch.kernels import segment_fused as T_SF  # noqa: E402
from repro_torch.kernels.ref import binary_conv2d_ref, xnor_gemm_ref  # noqa: E402
from repro_torch.kernels.registry import (  # noqa: E402
    ASPECT_NAMES,
    SCOPE_SEGMENT,
    GemmShape,
    KernelVariant,
    SegmentShape,
    VariantRegistry,
    host_xnor_gemm,
    segment_shape_of,
)

ASPECTS = ("X", "Y", "Z", "XY", "XZ", "YZ", "XYZ")
ARCHS = ("cifar10", "fashion_mnist")
# (start, stop) spans per architecture: whole net, a tail that starts at
# a step, a mid span that starts at a max-pool
SPANS = {
    "cifar10": {"whole": (0, 19), "tail_step": (14, 19), "mid_mp": (8, 13)},
    "fashion_mnist": {"whole": (0, 10), "tail_step": (5, 10),
                      "mid_mp": (1, 4)},
}


def _words(rng, *shape):
    return rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)


# ---------------------------------------------------------------------------
# kernel 1: the xnor GEMM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("aspects", ASPECTS)
@pytest.mark.parametrize("tiles", [(16, 8), (32, 16)])
def test_xnor_gemm_matches_pallas_ragged(aspects, tiles):
    """P, N not tile multiples, Kw with a tail lane count."""
    rng = np.random.default_rng(len(aspects) * 10 + tiles[0])
    a, w = _words(rng, 2, 37, 5), _words(rng, 21, 5)
    want = np.asarray(xnor_gemm_pallas(
        jnp.asarray(a), jnp.asarray(w), 150, tuple(aspects),
        p_blk=tiles[0], n_blk=tiles[1], interpret=True))
    at, wt = torch.from_numpy(a), torch.from_numpy(w)
    assert np.array_equal(xnor_gemm_ref(at, wt, 150).numpy(), want)
    got = xnor_gemm_cuda(at, wt, 150, tuple(aspects))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(1, 1, 10, 32), (3, 64, 20, 1),
                                   (2, 9, 64, 18)])
def test_xnor_gemm_ref_matches_reference_ref(shape):
    b, p, n, kw = shape
    rng = np.random.default_rng(sum(shape))
    a, w = _words(rng, b, p, kw), _words(rng, n, kw)
    k = 32 * kw - 7
    want = np.asarray(r_xnor_gemm_ref(jnp.asarray(a), jnp.asarray(w), k))
    got = xnor_gemm_ref(torch.from_numpy(a), torch.from_numpy(w), k)
    assert np.array_equal(got.numpy(), want)


def test_binary_conv_ref_is_the_packed_conv():
    rng = np.random.default_rng(9)
    x, w = _words(rng, 2, 5, 5, 2), _words(rng, 7, 18)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    assert torch.equal(binary_conv2d_ref(xt, wt, 40),
                       T_L.conv_packed(xt, wt, 40))


def test_xnor_gemm_wrapper_checks_its_operands():
    a = torch.zeros((2, 3, 4), dtype=torch.int32)
    w = torch.zeros((5, 4), dtype=torch.int32)
    with pytest.raises(TypeError):
        xnor_gemm_cuda(a.float(), w, 1)
    with pytest.raises(ValueError):
        xnor_gemm_cuda(a, w[:, :3], 1)
    with pytest.raises(ValueError):
        xnor_gemm_cuda(a[0], w, 1)
    with pytest.raises(ValueError):
        xnor_gemm_cuda(a, w, 1, ("X", "Q"))
    with pytest.raises(ValueError):
        xnor_gemm_cuda(a, w, 1, ())
    for bad in (0, 24, 128):
        with pytest.raises(ValueError):
            xnor_gemm_cuda(a, w, 1, p_blk=bad)
    # neither the CPU plain version nor anything else runs on a device
    # the wrapper has no kernel for
    with pytest.raises(ValueError, match="unsupported device"):
        xnor_gemm_cuda(a.to("meta"), w.to("meta"), 1)


def test_cpu_tensors_take_the_plain_version_without_counting():
    reset_launch_counts()
    rng = np.random.default_rng(2)
    a, w = torch.from_numpy(_words(rng, 1, 4, 3)), torch.from_numpy(
        _words(rng, 6, 3))
    assert torch.equal(xnor_gemm_cuda(a, w, 90), xnor_gemm_ref(a, w, 90))
    assert launch_counts() == {"xnor_gemm_cuda": 0, "segment_cuda": 0,
                               "flash_attention_cuda": 0}


# ---------------------------------------------------------------------------
# kernel 2: the fused segment
# ---------------------------------------------------------------------------


def _nets(arch, batch=2, seed=0):
    """Same fp weights and images for both packages; returns the
    reference's specs/params/layer inputs and the port's params."""
    r = R_M.build_model(arch, scale=0.25)
    fp = T_M.random_fp_params(r.specs, seed)
    rp = R_M.pack_params(r.specs, fp)
    tp = T_M.pack_params(r.specs, fp, device="cpu")
    x01 = np.random.default_rng(seed + 1).random(
        (batch, *r.input_hw, r.in_channels), dtype=np.float32)
    xs = [R_M.prepare_input_packed(jnp.asarray(x01))]
    for i in range(len(r.specs)):
        xs.append(R_SF._run_chain(r.specs[i:i + 1], rp[i:i + 1], xs[-1]))
    specs = T_M.build_model(arch, scale=0.25).specs
    return r, rp, specs, tp, [np.array(x) for x in xs]


_NETS = {}


def _net(arch):
    if arch not in _NETS:
        _NETS[arch] = _nets(arch)
    return _NETS[arch]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("span", ["whole", "tail_step", "mid_mp"])
def test_segment_chain_matches_pallas_segment(arch, span):
    r, rp, specs, tp, xs = _net(arch)
    s, e = SPANS[arch][span]
    want = np.asarray(R_SF.build_pallas_segment(
        r.specs[s:e], rp[s:e], interpret=True)(jnp.asarray(xs[s])))
    assert np.array_equal(want, xs[e])
    x = torch.from_numpy(xs[s])
    assert np.array_equal(T_SF._run_chain(specs[s:e], tp[s:e], x).numpy(), want)
    got = segment_cuda(specs[s:e], tp[s:e])(x)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("span", ["whole", "tail_step", "mid_mp"])
def test_segment_encodings_match_reference(arch, span):
    r, _, specs, _, xs = _net(arch)
    s, e = SPANS[arch][span]
    enc = T_SF.infer_in_encoding(specs[s:e])
    assert enc == R_SF.infer_in_encoding(r.specs[s:e])
    out = T_SF.segment_out_encoding(specs[s:e], enc)
    assert out == R_SF.segment_out_encoding(r.specs[s:e], enc)
    assert T_SF.encoded_shape(specs[s].in_shape, enc) == xs[s].shape[1:]
    assert T_SF.encoded_shape(specs[e - 1].out_shape, out) == xs[e].shape[1:]


@pytest.mark.parametrize("arch", ARCHS)
def test_segment_size_helpers_match_reference(arch):
    r, rp, specs, tp, _ = _net(arch)
    assert T_SF.segment_weight_bytes(tp) == R_SF.segment_weight_bytes(rp)
    assert T_SF.segment_gemm_work(specs, tp, 3) == R_SF.segment_gemm_work(
        r.specs, rp, 3)


def _interpret(low, x):
    """Execute a lowered segment's descriptor table with the port's
    plain ops, one example at a time — what the CUDA kernel does, so
    the lowering (offsets, shapes, fusion flags, buffer ping-pong) is
    checked without a card."""
    sf = T_SF
    flat = torch.cat(low.params) if low.params else torch.zeros(1, dtype=torch.int32)
    outs = []
    for b in range(x.shape[0]):
        bufs = {sf.BUF_IN: x[b].reshape(-1)}
        for row in low.desc.tolist():
            src = bufs[row[sf.F_SRC]]
            h, w, c, n = row[sf.F_H], row[sf.F_W], row[sf.F_C], row[sf.F_N]
            t = flat[row[sf.F_TOFF]:]
            f = flat[row[sf.F_FOFF]:]
            kind = row[sf.F_KIND]
            if kind == sf.OP_CONV:
                wt = flat[row[sf.F_WOFF]:row[sf.F_WOFF] + n * 9 * c]
                y = T_L.conv_packed(src[:h * w * c].reshape(1, h, w, c),
                                    wt.reshape(9 * c, n).t(), row[sf.F_KTRUE])
                if row[sf.F_POOL]:
                    y = T_L.maxpool_packed(y)
            elif kind == sf.OP_FC:
                wt = flat[row[sf.F_WOFF]:row[sf.F_WOFF] + n * c]
                y = T_L.fc_packed(src[:c].reshape(1, c), wt.reshape(c, n).t(),
                                  row[sf.F_KTRUE])
            elif kind == sf.OP_POOL:
                y = T_L.maxpool_packed(src[:h * w * c].reshape(1, h, w, c))
            elif kind == sf.OP_STEP:
                y = T_L.step_packed(src[:h * w * c].reshape(h * w, c),
                                    t[:c], f[:c].bool())
            else:
                y = src[:c].clone()
            if kind in (sf.OP_CONV, sf.OP_FC) and row[sf.F_STEP]:
                y = T_L.step_packed(y, t[:n], f[:n].bool())
            bufs[row[sf.F_DST]] = y.reshape(-1)
            if row[sf.F_DST] != sf.BUF_OUT:
                assert y.numel() <= low.scratch_elems
        outs.append(bufs[sf.BUF_OUT].reshape(low.out_shape))
    return torch.stack(outs)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("span", ["whole", "tail_step", "mid_mp"])
def test_segment_lowering_interprets_to_the_chain(arch, span):
    _, _, specs, tp, xs = _net(arch)
    s, e = SPANS[arch][span]
    low = T_SF._Lowered(specs[s:e], tp[s:e], T_SF.infer_in_encoding(specs[s:e]))
    got = _interpret(low, torch.from_numpy(xs[s]))
    assert np.array_equal(got.numpy(), xs[e])


def test_lowering_fuses_pool_and_step_into_the_gemm_epilogue():
    specs = T_M.build_model("cifar10").specs
    tp = T_M.pack_params(specs, T_M.random_fp_params(specs, 0), device="cpu")
    low = T_SF._Lowered(specs, tp, "packed")
    kinds = low.desc[:, T_SF.F_KIND].tolist()
    assert kinds == [T_SF.OP_CONV] * 6 + [T_SF.OP_FC] * 2
    assert low.desc[:, T_SF.F_POOL].tolist() == [0, 1, 0, 1, 0, 1, 0, 0]
    assert low.desc[:, T_SF.F_STEP].tolist() == [1] * 7 + [0]
    # ping-pong scratch: the widest interior activation is the packed
    # 32x32x64 conv output (two words per pixel), never an unpacked one
    assert low.scratch_elems == 32 * 32 * 2
    assert low.in_shape == (32, 32, 1) and low.out_shape == (10,)
    srcs, dsts = low.desc[:, T_SF.F_SRC], low.desc[:, T_SF.F_DST]
    assert srcs[0] == T_SF.BUF_IN and dsts[-1] == T_SF.BUF_OUT
    assert all(d == s for d, s in zip(dsts[:-1], srcs[1:]))


def test_lowering_edge_cases():
    specs = T_M.build_model("cifar10", scale=0.25).specs
    tp = T_M.pack_params(specs, T_M.random_fp_params(specs, 0), device="cpu")
    flat_only = T_SF._Lowered(specs[15:16], tp[15:16], "packed")
    assert flat_only.desc[:, T_SF.F_KIND].tolist() == [T_SF.OP_COPY]
    assert flat_only.scratch_elems == 0
    x = torch.from_numpy(_words(np.random.default_rng(0), 2, 4, 4, 4))
    assert torch.equal(_interpret(flat_only, x), x.reshape(2, -1))
    with pytest.raises(ValueError, match="needs unpacked"):
        T_SF._Lowered(specs[1:3], tp[1:3], "packed")     # step on packed
    with pytest.raises(ValueError):
        segment_cuda(specs[0:2], tp[0:2])(torch.zeros((1, 32, 32, 2),
                                                      dtype=torch.int32))


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


def test_registry_holds_the_fixed_8_and_seg_cuda_only():
    """The fixed 8, kernel 1's three tile variants and seg_cuda; none of
    the JAX package's XLA or Pallas variants."""
    tiles = ("cuda_p16n64", "cuda_p32n64", "cuda_p64n32")
    assert DEFAULT_REGISTRY.names() == (
        ("CPU",) + ASPECT_NAMES + tiles + ("seg_cuda",))
    for name in ("xla_fused", "pallas_p64n64", "seg_xla", "seg_pallas"):
        assert name not in DEFAULT_REGISTRY
    for name in tiles:
        v = DEFAULT_REGISTRY.get(name)
        assert (v.placement, v.aspects, v.analytic) == (
            "device", ("X", "Y", "Z"), "tiled")
        assert f"cuda_p{v.p_blk}n{v.n_blk}" == name
        assert v.builder.func is xnor_gemm_cuda
    assert DEFAULT_REGISTRY.placement_of("CPU") == "host"
    for name in ASPECT_NAMES:
        v = DEFAULT_REGISTRY.get(name)
        assert (v.placement, v.aspects) == ("device", tuple(name))
    seg = DEFAULT_REGISTRY.get("seg_cuda")
    assert seg.scope == SCOPE_SEGMENT and seg.builder is segment_cuda
    assert DEFAULT_REGISTRY.segment_names() == ("seg_cuda",)


def test_fixed8_semantics_are_frozen():
    reg = VariantRegistry()
    with pytest.raises(ValueError, match="frozen"):
        reg.register(KernelVariant("CPU", builder=xnor_gemm_ref,
                                   placement="device"))
    with pytest.raises(ValueError, match="frozen"):
        reg.register(KernelVariant("XY", builder=xnor_gemm_ref,
                                   aspects=("X",)))
    reg.register(KernelVariant("XY", builder=xnor_gemm_ref, aspects=("X", "Y")))
    with pytest.raises(ValueError, match="already registered"):
        reg.register(KernelVariant("XY", builder=xnor_gemm_ref,
                                   aspects=("X", "Y")))
    with pytest.raises(ValueError, match="unknown kernel variant"):
        reg.get("xla_fused")


def test_aspect_variants_are_the_cuda_kernel_with_their_aspects():
    rng = np.random.default_rng(4)
    a, w = torch.from_numpy(_words(rng, 2, 5, 3)), torch.from_numpy(
        _words(rng, 7, 3))
    want = xnor_gemm_ref(a, w, 80)
    for name in ("CPU",) + ASPECT_NAMES:
        assert torch.equal(DEFAULT_REGISTRY.get(name).builder(a, w, 80), want)
    assert DEFAULT_REGISTRY.get("XZ").builder.func is xnor_gemm_cuda
    assert DEFAULT_REGISTRY.get("XZ").builder.keywords == {"aspects": ("X", "Z")}


def test_cpu_config_refuses_device_tensors():
    a = torch.zeros((1, 2, 3), dtype=torch.int32, device="meta")
    w = torch.zeros((4, 3), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="host tensors"):
        host_xnor_gemm(a, w, 3)


def test_segment_shapes_gate_segment_variants():
    specs = T_M.build_model("fashion_mnist", scale=0.25).specs
    tp = T_M.pack_params(specs, T_M.random_fp_params(specs, 0), device="cpu")
    shape = segment_shape_of(specs, tp, 4)
    assert shape == SegmentShape(4, len(specs),
                                 T_SF.segment_gemm_work(specs, tp, 4),
                                 T_SF.segment_weight_bytes(tp))
    names = [v.name for v in DEFAULT_REGISTRY.applicable_segments(shape)]
    assert names == ["seg_cuda"]
    layer = DEFAULT_REGISTRY.applicable(GemmShape(b=1, p=4, n=8, kw=2))
    assert [v.name for v in layer] == ["CPU", *ASPECT_NAMES]
