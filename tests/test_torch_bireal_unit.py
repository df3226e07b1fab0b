"""The Bi-Real unit's two kernels around kernel 1
(``repro_torch.kernels.bireal_unit``): their plain versions against an
independent NumPy packing and against the chain of PyTorch operations the
unit ran before, the patches kernel's bands, the ring's count of their
launches, and (on a card) each kernel against its plain version at every
unit shape of Bi-Real Net-18.

Everything here is compared with ``torch.equal``: the patches are integer
words, and the epilogue must round as the plain chain does on the same
device, so that the residual stream is the same to the bit."""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch import api
from repro_torch import kernels as K
from repro_torch.bnn import layers as L
from repro_torch.bnn.binarize import pack_bits
from repro_torch.bnn.models import (
    BNNModel,
    bireal_notation,
    build_model,
    pack_params,
    pack_real,
    packed_params_from_numpy,
    random_fp_params,
    random_real_params,
)
from repro_torch.core.mapper import price_mapping
from repro_torch.kernels import bireal_unit as U
from repro_torch.kernels import xnor_popcount
from repro_torch.kernels.ref import xnor_gemm_ref
from repro_torch.kernels.xnor_popcount import xnor_gemm_cuda
from repro_torch.serving import pipeline as P

#: the 16 units of Bi-Real Net-18 at 224x224: (H, W, Cin, Cout, stride)
UNITS = [(s.in_shape[0], s.in_shape[1], s.in_shape[2], s.units, s.stride)
         for s in build_model("bireal18").specs if s.kind == "bireal"]
TINY = bireal_notation((32, 64, 64, 64), (2, 2, 1, 1), (32, 32))


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(b, h, w, c, seed=0):
    """float32 NHWC with exact zeros, -0.0 and a NaN among the values."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, h, w, c, generator=g)
    flat = x.view(-1)
    pick = torch.randperm(flat.numel(), generator=g)
    n = max(1, flat.numel() // 16)
    flat[pick[:n]] = 0.0
    flat[pick[n:2 * n]] = -0.0
    flat[pick[2 * n]] = float("nan")
    return x


def _patches_numpy(x: np.ndarray, stride: int) -> np.ndarray:
    """The patch words by NumPy's ``packbits``: bit i of word w is channel
    32 w + i where x >= 0, tail lanes and spatial pad words 0, tap-major."""
    b, h, w, c = x.shape
    cw = -(-c // 32)
    bits = np.zeros((b, h, w, 32 * cw), bool)
    bits[..., :c] = x >= 0
    words = np.packbits(bits.reshape(b, h, w, cw, 4, 8), axis=-1,
                        bitorder="little").reshape(b, h, w, cw, 4)
    words = np.ascontiguousarray(words).view("<u4")[..., 0].view(np.int32)
    padded = np.pad(words, ((0, 0), (1, 1), (1, 1), (0, 0)))
    ho, wo = L.strided_side(h, stride), L.strided_side(w, stride)
    taps = [padded[:, dy:dy + stride * (ho - 1) + 1:stride,
                   dx:dx + stride * (wo - 1) + 1:stride]
            for dy in range(3) for dx in range(3)]
    return np.concatenate(taps, axis=-1).reshape(b, ho * wo, 9 * cw)


@pytest.mark.parametrize("cin", [64, 128, 40])
@pytest.mark.parametrize("h,w", [(7, 7), (8, 6)])
@pytest.mark.parametrize("stride", [1, 2])
def test_plain_patches_are_the_sign_words(stride, h, w, cin):
    """On CPU tensors the wrapper's plain version gives the words that
    ``extract_patch_words(pack_bits(x >= 0), stride)`` gives, and NumPy's
    ``packbits`` agrees with both (+0.0 and -0.0 set a bit, NaN does
    not), at odd and even sides and a channel count with a tail word."""
    x = _x(2, h, w, cin, seed=h * w + cin)
    before = U.bireal_patches_cuda.launches
    got = U.bireal_patches_cuda(x, stride)
    chain = L.extract_patch_words(pack_bits(x >= 0), stride)
    assert got.dtype == torch.int32
    assert torch.equal(got, chain.reshape(2, -1, chain.shape[-1]))
    assert np.array_equal(got.numpy(), _patches_numpy(x.numpy(), stride))
    assert U.bireal_patches_cuda.launches == before     # no launch


def _unit(h, w, cin, cout, stride, seed=1):
    """A unit's packed params (CPU tensors)."""
    ho, wo = L.strided_side(h, stride), L.strided_side(w, stride)
    note = f"BR{cout}/2" if stride == 2 else f"BR{cout}"
    spec = L.LayerSpec(1, "bireal", note, (h, w, cin), (ho, wo, cout), cout)
    fp = random_real_params(spec, np.random.default_rng(seed))
    return packed_params_from_numpy([pack_real(spec, fp)], "cpu")[0]


def _chain_unit(x, p, stride, gemm):
    """The unit as it ran before the two kernels: the sign pack, gather,
    GEMM, correction, ``addcmul`` and the shortcut's ``add_``."""
    b, h, w, _ = x.shape
    patches = L.extract_patch_words(pack_bits(x >= 0), stride)
    acc = gemm(patches.reshape(b, -1, patches.shape[-1]), p["w_words"],
               p["k_true"])
    y = torch.addcmul(p["shift"], (acc + p["corr"]).to(torch.float32),
                      p["scale"])
    y = y.view(b, L.strided_side(h, stride), L.strided_side(w, stride), -1)
    if "sc_w" not in p:
        return y.add_(x)
    with L.fp32_convs():
        s = F.conv2d(F.avg_pool2d(L._nchw(x), 2, 2), p["sc_w"], p["sc_b"])
    return y.add_(L._nhwc(s))


@pytest.mark.parametrize("shortcut", ["identity", "projection"])
def test_plain_epilogue_is_addcmul_then_add(shortcut):
    """On CPU tensors the epilogue's plain version is ``addcmul`` then
    ``add_`` to the bit, on the identity and on the projection shortcut,
    and the whole host unit is the chain it ran before."""
    cin, cout, stride = (32, 32, 1) if shortcut == "identity" else (32, 64, 2)
    p = _unit(8, 6, cin, cout, stride)
    x = _x(3, 8, 6, cin, seed=9).nan_to_num_(0.5)
    before = U.bireal_epilogue_cuda.launches
    patches = U.bireal_patches_cuda(x, stride)
    acc = xnor_gemm_ref(patches, p["w_words"], p["k_true"])
    if shortcut == "identity":
        res = x
    else:
        with L.fp32_convs():
            res = L._nhwc(F.conv2d(F.avg_pool2d(L._nchw(x), 2, 2),
                                   p["sc_w"], p["sc_b"]))
    got = U.bireal_epilogue_cuda(acc, p["corr"], p["scale"], p["shift"], res)
    want = torch.addcmul(p["shift"], (acc + p["corr"]).to(torch.float32),
                         p["scale"]).view(res.shape).add_(res)
    assert got.dtype == torch.float32 and got.shape == res.shape
    assert torch.equal(got, want)
    # the kernel's arithmetic: scale * s + shift rounded once (an fma; the
    # float64 product is exact), then + res rounded once
    s64 = (acc + p["corr"]).to(torch.float64)
    fma = (s64 * p["scale"].double() + p["shift"].double()).float()
    assert torch.equal(got, (fma.view(res.shape) + res))
    assert torch.equal(L.bireal_unit(x, p, stride, xnor_gemm_ref),
                       _chain_unit(x, p, stride, xnor_gemm_ref))
    assert U.bireal_epilogue_cuda.launches == before    # no launch


@pytest.mark.parametrize("b", [1, 32])
@pytest.mark.parametrize("h,w,cin,stride", sorted({
    (h, w, cin, stride) for h, w, cin, _, stride in UNITS}))
def test_patch_bands_cover_the_rows(h, w, cin, stride, b):
    """At each unit shape the bands cover every output row once, fit the
    kernel's shared memory, and give the launch at least one block an SM
    where the rows allow."""
    rows = U.patch_band_rows(b, h, w, cin, stride)
    ho = L.strided_side(h, stride)
    bands = -(-ho // rows)
    assert 1 <= rows <= ho and (bands - 1) * rows < ho <= bands * rows
    assert U.patch_smem_bytes(w, -(-cin // 32), rows, stride) <= U.SMEM_MAX
    assert b * bands >= min(132, b * ho)


@pytest.mark.parametrize("name", ["patches", "epilogue"])
def test_wrappers_refuse_other_devices(name):
    x = torch.empty(1, 4, 4, 32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        if name == "patches":
            U.bireal_patches_cuda(x, 1)
        else:
            acc = torch.empty(1, 16, 32, dtype=torch.int32, device="meta")
            U.bireal_epilogue_cuda(acc, acc[0], x[0, 0, 0], x[0, 0, 0], x)


class _Graph:
    """A captured graph's stand-in: a replay runs the segment's callable
    from the slot's input into its output, on CPU tensors."""

    def __init__(self, fn, host_in, host_out):
        self.fn, self.host_in, self.host_out = fn, host_in, host_out

    def replay(self):
        # a card's replay runs no Python: the stand-ins count nothing here
        P.uncounted(lambda: self.host_out.copy_(self.fn(self.host_in)), 1)


class _Done:
    def record(self, stream=None):
        pass

    def synchronize(self):
        pass


class _CapturedOnCPU(P.SegmentPipeline):
    """The ring's capture on CPU tensors: each slot's 'capture' runs the
    segment once, through ``pipeline.uncounted`` as a card's capture
    does; replays go through the pipeline's own ``_replay``."""

    def _capture(self, s, x):
        fn = self.segment_fns[s][1]
        x = torch.as_tensor(np.asarray(x))

        def capture():
            slots = []
            for _ in range(P.RING_SLOTS):
                host_in = torch.empty_like(x)
                host_out = fn(x).clone()
                slots.append(P._Slot(host_in.numpy(), host_in, None,
                                     host_out, _Graph(fn, host_in, host_out),
                                     _Done()))
            return slots

        slots, launches = P.uncounted(capture, P.RING_SLOTS)
        ring = self._rings[(s, x.shape[0])] = P._Ring(slots, launches)
        return ring


def test_ring_adds_the_unit_launches_per_replay(monkeypatch):
    """Each plain version standing in for its kernel counts a launch: the
    capture's counts are put back, each replay adds one launch of kernel 1
    and of each unit kernel per unit, and ``launch_counts()`` keeps its
    keys (the unit kernels are not among them)."""
    for mod, plain, wrapper in (
            (xnor_popcount, "xnor_gemm_and_plain", xnor_gemm_cuda),
            (U, "bireal_patches_plain", U.bireal_patches_cuda),
            (U, "bireal_epilogue_plain", U.bireal_epilogue_cuda)):
        def counted(*args, _f=getattr(mod, plain), _w=wrapper):
            _w.launches += 1
            return _f(*args)
        monkeypatch.setattr(mod, plain, counted)
        monkeypatch.setattr(wrapper, "launches", wrapper.launches)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a, **k: None)
    specs = tuple(L.parse_notation(TINY, (32, 32), 3, 10))
    model = BNNModel("bireal-tiny", specs, (32, 32), 3, 10)
    packed = pack_params(specs, random_fp_params(specs, 3), device="cpu")
    tp = api.plan_single(model, packed, batch_sizes=(1, 4), configs=("XYZ",),
                         time_source="analytic", device="cpu")
    config = price_mapping(tp.table, 4, ("XYZ",) * len(specs))
    pipe = _CapturedOnCPU(model, packed, config, device="cpu")
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
               for _ in range(3)]
    serial = [pipe.run_serial(x) for x in batches]
    units = sum(s.kind == "bireal" for s in specs)
    counted = P.counted_kernels()
    before = [k.launches for k in counted]
    keys = tuple(K.launch_counts())
    pipe.device = torch.device("cuda", 0)       # the label only: no launch
    outs = pipe.run_pipelined(batches)
    ring = pipe._rings[(0, 4)]
    assert [(k.__name__, n) for k, n in ring.launches] == [
        ("xnor_gemm_cuda", units), ("bireal_patches_cuda", units),
        ("bireal_epilogue_cuda", units)]
    grew = {k.__name__: k.launches - n for k, n in zip(counted, before)}
    assert grew == {"xnor_gemm_cuda": 3 * units, "segment_cuda": 0,
                    "flash_attention_cuda": 0,
                    "bireal_patches_cuda": 3 * units,
                    "bireal_epilogue_cuda": 3 * units}
    assert keys == tuple(K.launch_counts()) == (
        "xnor_gemm_cuda", "segment_cuda", "flash_attention_cuda")
    assert all(k not in K.KERNELS for k in U.UNIT_KERNELS)
    for got, want in zip(outs, serial):
        assert np.array_equal(got, want)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 32])
@pytest.mark.parametrize("unit", range(len(UNITS)))
def test_patches_kernel_at_bireal18_units(unit, b):
    """The patches kernel gives its plain version's words on the card."""
    dev = _card()
    h, w, cin, _, stride = UNITS[unit]
    x = _x(b, h, w, cin, seed=unit).to(dev)
    before = U.bireal_patches_cuda.launches
    got = U.bireal_patches_cuda(x, stride)
    assert U.bireal_patches_cuda.launches == before + 1
    assert torch.equal(got, U.bireal_patches_plain(x, stride))


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,cin,stride,shift", [
    (7, 7, 40, 1, 0), (8, 6, 40, 2, 0), (9, 5, 8, 2, 0), (8, 6, 64, 1, 1)])
def test_patches_kernel_one_warp_a_word(h, w, cin, stride, shift):
    """Where C is no multiple of 32, or x is not 16-byte aligned, a warp
    packs each word by a ballot: still the plain version's words, tail
    lanes 0."""
    dev = _card()
    flat = _x(3, h, w, cin, seed=cin).reshape(-1).to(dev)
    x = torch.cat([flat[:shift], flat])[shift:].view(3, h, w, cin)
    assert x.is_contiguous() and (x.data_ptr() % 16 != 0) == bool(shift)
    assert torch.equal(U.bireal_patches_cuda(x, stride),
                       U.bireal_patches_plain(x, stride))


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 32])
@pytest.mark.parametrize("unit", range(len(UNITS)))
def test_epilogue_kernel_at_bireal18_units(unit, b):
    """The epilogue kernel gives its plain version's floats to the bit on
    the card, over sums across kernel 1's whole range; and the whole unit
    through both kernels and kernel 1 is the chain it ran before, to the
    bit."""
    dev = _card()
    h, w, cin, cout, stride = UNITS[unit]
    p = {k: v.to(dev) if torch.is_tensor(v) else v
         for k, v in _unit(h, w, cin, cout, stride, seed=unit).items()}
    g = torch.Generator(device=dev).manual_seed(unit)
    ho, wo = L.strided_side(h, stride), L.strided_side(w, stride)
    k = p["k_true"]
    acc = torch.randint(-k, k + 1, (b, ho * wo, cout), generator=g,
                        device=dev, dtype=torch.int32)
    res = torch.randn(b, ho, wo, cout, generator=g, device=dev)
    before = U.bireal_epilogue_cuda.launches
    got = U.bireal_epilogue_cuda(acc, p["corr"], p["scale"], p["shift"], res)
    assert U.bireal_epilogue_cuda.launches == before + 1
    assert torch.equal(got, U.bireal_epilogue_plain(acc, p["corr"],
                                                     p["scale"], p["shift"],
                                                     res))
    x = _x(b, h, w, cin, seed=unit).nan_to_num_(0.5).to(dev)

    def gemm(a, wd, kt):
        return xnor_gemm_cuda(a, wd, kt, ("X", "Y", "Z"))

    assert torch.equal(L.bireal_unit(x, p, stride, gemm),
                       _chain_unit(x, p, stride, gemm))
