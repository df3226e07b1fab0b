"""The port's CUDA kernels on the card, each held to its plain PyTorch
version on the same inputs (``torch.equal`` for the integer kernels,
the stated tolerance for flash attention) (the plain versions are held to
the JAX package by the other ``test_torch_*`` files).  Every test here
is marked ``cuda`` and skips without an NVIDIA GPU; on a machine with
one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports neither JAX nor the JAX package, so it also runs
where only the port is installed."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.bnn import models as T_M  # noqa: E402
from repro_torch.bnn.layers import extract_patch_words  # noqa: E402
from repro_torch.core.mapped_model import build_segment_fns, run_plan  # noqa: E402
from repro_torch.core.mapper import price_mapping  # noqa: E402
from repro_torch.core.parallel_config import CONFIGS  # noqa: E402
from repro_torch.core.profiler import ProfileTable  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    flash_attention_cuda,
    segment_cuda,
    xnor_gemm_cuda,
)
from repro_torch.kernels.flash_attention import flash_attention_plain  # noqa: E402
from repro_torch.kernels.ref import xnor_gemm_ref  # noqa: E402
from repro_torch.kernels.segment_fused import _run_chain  # noqa: E402
from repro_torch.models import modules as T_MOD  # noqa: E402
from repro_torch.serving import SegmentPipeline  # noqa: E402

ASPECTS = ("X", "Y", "Z", "XY", "XZ", "YZ", "XYZ")
SPANS = {
    "cifar10": {"whole": (0, 19), "tail_step": (14, 19), "mid_mp": (8, 13)},
    "fashion_mnist": {"whole": (0, 10), "tail_step": (5, 10),
                      "mid_mp": (1, 4)},
}

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _words(rng, *shape):
    return rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)


# (B, P, N, Kw, words): ragged P and N, Kw not a multiple of 4 or 8, both
# FC tile kinds (16 images fill one MMA row tile, 33 do not), every
# Fashion-MNIST GEMM shape, and all-zero / all-one words
XNOR_CASES = (
    (2, 37, 21, 5, "random"), (1, 1024, 64, 9, "random"),
    (4, 64, 512, 144, "random"), (3, 1, 10, 32, "random"),
    (2, 100, 70, 33, "random"),
    (16, 64, 512, 72, "random"), (33, 64, 512, 72, "random"),
    (16, 1, 1024, 256, "random"), (33, 1, 1024, 256, "random"),
    (16, 784, 64, 9, "random"), (3, 196, 64, 18, "random"),
    (16, 1, 2048, 98, "random"), (33, 1, 10, 64, "random"),
    (2, 19, 40, 7, "random"), (2, 19, 40, 8, "random"),
    (2, 19, 40, 255, "random"), (2, 19, 40, 257, "random"),
    (3, 37, 21, 9, "zeros"), (3, 37, 21, 9, "ones"),
    (16, 1, 24, 257, "ones"), (2, 70, 16, 8, "zeros"),
)


def _case_words(rng, kind, *shape):
    if kind == "zeros":
        return np.zeros(shape, np.int32)
    if kind == "ones":
        return np.full(shape, -1, np.int32)
    return _words(rng, *shape)


@pytest.mark.parametrize("aspects", ASPECTS)
@pytest.mark.parametrize("tiles", [(64, 64), (16, 32), (48, 16)])
def test_xnor_gemm_cuda_equals_plain(dev, aspects, tiles):
    rng = np.random.default_rng(11)
    for b, p, n, kw, kind in XNOR_CASES:
        a = torch.from_numpy(_case_words(rng, kind, b, p, kw)).to(dev)
        w = torch.from_numpy(_case_words(rng, kind, n, kw)).to(dev)
        before = xnor_gemm_cuda.launches
        got = xnor_gemm_cuda(a, w, 32 * kw - 3, tuple(aspects),
                             p_blk=tiles[0], n_blk=tiles[1])
        torch.cuda.synchronize()
        assert xnor_gemm_cuda.launches == before + 1
        assert torch.equal(got, xnor_gemm_ref(a, w, 32 * kw - 3))


# every CIFAR-10 and Fashion-MNIST GEMM shape at full width (P windows,
# N neurons, Kw words), and a ragged one
PAPER_GEMM_SHAPES = (
    (1024, 64, 9), (1024, 64, 18), (256, 256, 18), (256, 256, 72),
    (64, 512, 72), (64, 512, 144), (1, 1024, 256), (1, 10, 32),
    (784, 64, 9), (196, 64, 18), (1, 2048, 98), (1, 10, 64), (37, 21, 5),
)


@pytest.mark.parametrize("name", ["cuda_p16n64", "cuda_p32n64",
                                  "cuda_p64n32"])
@pytest.mark.parametrize("batch", [1, 16, 33])
def test_tile_variants_equal_plain_at_paper_shapes(dev, name, batch):
    """Each registered kernel-1 tile variant, through its registry
    builder, launches the kernel once per call and equals the plain
    xnor GEMM at every paper GEMM shape."""
    from repro_torch.kernels.registry import DEFAULT_REGISTRY

    build = DEFAULT_REGISTRY.get(name).builder
    rng = np.random.default_rng(batch)
    for p, n, kw in PAPER_GEMM_SHAPES:
        a = torch.from_numpy(_words(rng, batch, p, kw)).to(dev)
        w = torch.from_numpy(_words(rng, n, kw)).to(dev)
        before = xnor_gemm_cuda.launches
        got = build(a, w, 32 * kw - 5)
        torch.cuda.synchronize()
        assert xnor_gemm_cuda.launches == before + 1
        assert torch.equal(got, xnor_gemm_ref(a, w, 32 * kw - 5)), (p, n, kw)


@pytest.mark.parametrize("kw", [8, 72, 256])
def test_xnor_gemm_cuda_unaligned_operands_take_4_byte_copies(dev, kw):
    """Operands one word off a 16-byte boundary: the plan falls back to
    4-byte copies, with the same result."""
    rng = np.random.default_rng(kw)
    a = torch.from_numpy(_words(rng, 3, 50, kw)).to(dev)
    w = torch.from_numpy(_words(rng, 40, kw)).to(dev)
    a_off = torch.empty(a.numel() + 1, dtype=torch.int32, device=dev)
    a_off[1:] = a.reshape(-1)
    w_off = torch.empty(w.numel() + 1, dtype=torch.int32, device=dev)
    w_off[1:] = w.reshape(-1)
    a1, w1 = a_off[1:].view(a.shape), w_off[1:].view(w.shape)
    want = xnor_gemm_ref(a, w, 32 * kw)
    for aspects in ASPECTS:
        assert torch.equal(xnor_gemm_cuda(a1, w1, 32 * kw, tuple(aspects)),
                           want)


def test_xnor_gemm_cuda_refuses_what_it_cannot_launch(dev):
    a = torch.zeros((2, 8, 4), dtype=torch.int32, device=dev)
    w = torch.zeros((6, 4), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        xnor_gemm_cuda(a.transpose(1, 2).contiguous().transpose(1, 2), w, 1)
    with pytest.raises(ValueError):
        xnor_gemm_cuda(a, w.cpu(), 1)
    empty = xnor_gemm_cuda(a[:0], w, 1)
    assert empty.shape == (0, 8, 6)


def _net(arch, dev, batch=3, scale=0.5):
    m = T_M.build_model(arch, scale=scale)
    packed = T_M.pack_params(m.specs, T_M.random_fp_params(m.specs, 2),
                             device=dev)
    x01 = np.random.default_rng(3).random(
        (batch, *m.input_hw, m.in_channels), dtype=np.float32)
    xs = [T_M.prepare_input_packed(torch.from_numpy(x01)).to(dev)]
    for i in range(len(m.specs)):
        xs.append(_run_chain(m.specs[i:i + 1], packed[i:i + 1], xs[-1]))
    return m, packed, xs


_FULL: dict = {}


def _full_net(arch, dev):
    """The full-width net at batch 33 and its plain layer outputs."""
    if arch not in _FULL:
        _FULL[arch] = _net(arch, dev, batch=33, scale=1.0)
    return _FULL[arch]


@pytest.mark.parametrize("batch", [1, 8, 16, 33])
@pytest.mark.parametrize("span", ["whole", "tail_step", "mid_mp"])
@pytest.mark.parametrize("arch", ["cifar10", "fashion_mnist"])
def test_segment_cuda_full_width_equals_chain(dev, arch, span, batch):
    """The persistent kernel at the batches the DP serves (1, 8, 16)
    and at 33, which is no multiple of any tile."""
    m, packed, xs = _full_net(arch, dev)
    s, e = SPANS[arch][span]
    fn = segment_cuda(m.specs[s:e], packed[s:e])
    before = segment_cuda.launches
    got = fn(xs[s][:batch].contiguous())
    torch.cuda.synchronize()
    assert segment_cuda.launches == before + 1
    assert fn.grid >= 1
    assert torch.equal(got, xs[e][:batch])


def test_segment_cuda_refuses_an_unaligned_input(dev):
    """A segment whose first conv reads 16 bytes at a time (C256: 8
    words a pixel) refuses an input off a 16-byte boundary."""
    m, packed, xs = _full_net("cifar10", dev)
    fn = segment_cuda(m.specs[7:10], packed[7:10])
    x = xs[7][:1]
    base = torch.zeros(x.numel() + 1, dtype=torch.int32, device=dev)
    before = segment_cuda.launches
    with pytest.raises(ValueError, match="16-byte"):
        fn(base[1:].view(x.shape))
    assert segment_cuda.launches == before
    base[1:] = x.reshape(-1)
    assert torch.equal(fn(base[1:].view(x.shape).clone()), xs[10][:1])


@pytest.mark.parametrize("arch", ["cifar10", "fashion_mnist"])
@pytest.mark.parametrize("span", ["whole", "tail_step", "mid_mp"])
def test_segment_cuda_equals_chain(dev, arch, span):
    m, packed, xs = _net(arch, dev)
    s, e = SPANS[arch][span]
    before = segment_cuda.launches
    got = segment_cuda(m.specs[s:e], packed[s:e])(xs[s])
    torch.cuda.synchronize()
    assert segment_cuda.launches == before + 1
    assert torch.equal(got, xs[e])


def test_conv_through_the_kernel_equals_the_plain_conv(dev):
    m, packed, xs = _net("cifar10", dev)
    x, p = xs[2], packed[2]
    b, h, w, _ = x.shape
    patches = extract_patch_words(x).reshape(b, h * w, -1)
    got = xnor_gemm_cuda(patches, p["w_words"], p["k_true"], ("Y", "Z"))
    assert torch.equal(got.reshape(b, h, w, -1), xs[3])


def test_mapped_plan_on_the_card_equals_the_plain_forward(dev):
    m, packed, xs = _net("cifar10", dev)
    n = len(m.specs)
    row = [{c: 1e-4 for c in CONFIGS} for _ in range(n)]
    table = ProfileTable(
        m.name, (3,), tuple(f"L{s.idx}:{s.notation}" for s in m.specs),
        {3: row}, kernel_times={3: row},
        h2d_times={3: [1e-5] * n}, d2h_times={3: [1e-5] * n})
    mapping = ("CPU", "CPU") + ("XYZ",) * 12 + ("CPU",) + ("XZ",) * 4
    ec = price_mapping(table, 3, mapping)
    before = dict(x=xnor_gemm_cuda.launches, s=segment_cuda.launches)
    got = run_plan(build_segment_fns(m, packed, ec, device=dev),
                   device=dev)(xs[0].cpu())
    assert torch.equal(got, xs[-1].cpu())
    assert xnor_gemm_cuda.launches > before["x"]
    fused = dataclasses.replace(
        ec, fused_segments=((2, 14, "seg_cuda", 1e-9),))
    got = run_plan(build_segment_fns(m, packed, fused, device=dev),
                   device=dev)(xs[0].cpu())
    assert torch.equal(got, xs[-1].cpu())
    assert segment_cuda.launches == before["s"] + 1


def test_observed_device_segment_waits_for_its_own_stream_only(dev):
    """An observed device segment is timed by waiting for the serving
    stream's own work, not by a device-wide sync: a long sleep queued on
    another stream just before the segment is not billed to it."""
    m, packed, xs = _net("cifar10", dev)
    n = len(m.specs)
    row = [{c: 1e-4 for c in CONFIGS} for _ in range(n)]
    table = ProfileTable(
        m.name, (3,), tuple(f"L{s.idx}:{s.notation}" for s in m.specs),
        {3: row}, kernel_times={3: row},
        h2d_times={3: [1e-5] * n}, d2h_times={3: [1e-5] * n})
    ec = price_mapping(table, 3, ("CPU", "CPU") + ("XYZ",) * (n - 2))
    pipe = SegmentPipeline(m, packed, ec, device=dev)
    x = xs[0].cpu().numpy()
    want = pipe.run_serial(x)                # builds and loads the kernels
    side = torch.cuda.Stream(dev)
    cycles = 200_000_000                     # about 0.1 s at 2 GHz
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.cuda.stream(side):
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
    end.synchronize()
    sleep_s = start.elapsed_time(end) / 1e3
    seen = []
    with torch.cuda.stream(side):
        torch.cuda._sleep(cycles)
    out = pipe.run_pipelined(
        [x], observer=lambda i, seg, t, b: seen.append((seg.on_device, t)))
    torch.cuda.synchronize()
    assert np.array_equal(out[0], want)
    device_s = [t for on_device, t in seen if on_device]
    assert len(device_s) == 1 and len(seen) == 2
    assert device_s[0] < sleep_s / 2, (device_s, sleep_s)


def _fused_whole(m, batch_sizes=(1, 4, 16)):
    """The full net on the card as one ``seg_cuda`` launch (``[D1-19]``
    for CIFAR-10), priced on a flat table at the largest batch."""
    n = len(m.specs)
    row = [{c: 1e-4 for c in CONFIGS} for _ in range(n)]
    rows = {b: row for b in batch_sizes}
    table = ProfileTable(
        m.name, batch_sizes,
        tuple(f"L{s.idx}:{s.notation}" for s in m.specs), rows,
        kernel_times=rows, h2d_times={b: [1e-5] * n for b in batch_sizes},
        d2h_times={b: [1e-5] * n for b in batch_sizes})
    ec = price_mapping(table, max(batch_sizes), ("XYZ",) * n)
    return dataclasses.replace(ec, fused_segments=((0, n, "seg_cuda", 1e-9),))


@pytest.mark.parametrize("size", [1, 4, 16])
def test_graph_ring_serves_bit_exact_results_of_their_own(dev, size):
    """The fused full-width CIFAR-10 mapping served through captured
    graphs: 8 micro-batches of `size` a step over 3 steps (every slot of
    the ring reused, the last micro-batch padded where it can be),
    answers equal to the eager launch and to the plain chain; results
    kept from the first step unchanged after the last; no two results
    share memory; one replay and one ``segment_cuda`` launch a
    micro-batch, after the one eager launch that precedes the capture
    of the ring's two slots."""
    from repro_torch.serving import ServingEngine

    m, packed, xs = _full_net("cifar10", dev)
    ec = _fused_whole(m)
    engine = ServingEngine(m, packed, ec, max_batch=size, max_wait_s=0.0,
                           allowed_batch_sizes=(1, 4, 16), device=dev)
    assert engine.pipeline._graphed(0)
    images = xs[0].cpu().numpy()
    want = xs[-1].cpu().numpy()
    eager = engine.pipeline.run_serial(images)
    assert np.array_equal(eager, want)
    counts = engine.graph_counts
    kept, first = [], None
    for step in range(3):
        n = 8 * size - (1 if size > 1 and step == 2 else 0)
        ids = [(step * 8 * size + j) % len(images) for j in range(n)]
        before = (segment_cuda.launches, counts.graph_replays)
        reqs = [engine.submit(images[i]) for i in ids]
        assert engine.step(force=True) == n
        got = np.stack([r.wait(timeout=60) for r in reqs])
        assert np.array_equal(got, want[ids]), f"step {step}"
        assert np.array_equal(got, eager[ids]), f"step {step}"
        replays = counts.graph_replays - before[1]
        assert replays == 8
        assert segment_cuda.launches - before[0] == replays + (step == 0)
        kept += [r.result for r in reqs]
        if first is None:
            first = [(r.result, r.result.copy()) for r in reqs]
    for result, copy in first:
        assert np.array_equal(result, copy)
    for a in range(len(kept)):
        for b in range(a + 1, len(kept)):
            assert not np.shares_memory(kept[a], kept[b])
    assert counts.graph_replays == engine.microbatches == 24
    assert counts.eager_device_segments == 0
    assert counts.graph_captures == 2


def test_graph_rings_capture_once_per_pad_size(dev):
    """Micro-batches padded to 16, 4 and 1 in one engine: two slots
    captured a pad size, every answer equal to the plain chain."""
    from repro_torch.serving import ServingEngine

    m, packed, xs = _full_net("cifar10", dev)
    engine = ServingEngine(m, packed, _fused_whole(m), max_wait_s=0.0,
                           allowed_batch_sizes=(1, 4, 16), device=dev)
    images, want = xs[0].cpu().numpy(), xs[-1].cpu().numpy()
    for n in (16 + 3, 16 + 1, 3, 1, 16):
        ids = [j % len(images) for j in range(n)]
        reqs = [engine.submit(images[i]) for i in ids]
        engine.step(force=True)
        got = np.stack([r.wait(timeout=60) for r in reqs])
        assert np.array_equal(got, want[ids]), n
    counts = engine.graph_counts
    assert counts.graph_captures == 2 * 3
    assert counts.graph_replays == engine.microbatches == 7
    assert counts.eager_device_segments == 0


# (b, h, hkv, sq, sk, d, dtype, causal): f32 is held at 1e-4 (only the
# order of the f32 sums differs), bf16 at 2e-2 (the JAX bf16 test's)
FLASH_CASES = {
    "f32-gqa-causal": (2, 4, 2, 256, 256, 64, torch.float32, True),
    "f32-mqa-full": (1, 8, 1, 128, 128, 128, torch.float32, False),
    "f32-d32": (1, 2, 2, 128, 128, 32, torch.float32, True),
    "bf16-qwen2-like": (1, 14, 2, 512, 512, 64, torch.bfloat16, True),
    "ragged": (2, 4, 2, 200, 200, 64, torch.float32, True),
    "ragged-full": (1, 4, 4, 77, 130, 64, torch.bfloat16, False),
    "sq1": (2, 14, 2, 1, 2048, 64, torch.float32, True),
    # head dim 112 (zamba2-7b) on the f32 path: 7 column groups of 1
    "f32-d112-gqa-causal": (2, 14, 2, 200, 200, 112, torch.float32, True),
    "f32-d112-ragged-full": (1, 4, 4, 77, 130, 112, torch.float32, False),
    "f32-d112-g7-sq1": (2, 14, 2, 1, 300, 112, torch.float32, True),
}


# bf16 on the tensor cores, held at 2e-2: (b, h, hkv, sq, sk, d, causal,
# kv_offset); ragged S 200 for every head dim and GQA group
TC_CASES = {
    **{f"d{d}-g{g}-{'causal' if c else 'full'}":
       (2, 2 * g, 2, 200, 200, d, c, None)
       for d in (32, 64, 112, 128) for g in (1, 2, 4, 5, 6, 7)
       for c in (True, False)},
    "sq1-sk2048": (4, 14, 2, 1, 2048, 64, True, None),
    "sq1-sk2048-d128": (1, 8, 1, 1, 2048, 128, True, None),
    "sq1-sk2048-d112": (1, 32, 32, 1, 2048, 112, True, None),
    "zamba2-like-d112": (1, 32, 32, 300, 300, 112, True, None),
    "ragged-sq-sk-full": (1, 4, 4, 77, 130, 64, False, None),
    # the full configs' prefill heads at one row of the batch: llava
    # (group 4) and grok-1 (group 6) at llava's S 2,624 (576 frontend
    # embeds + 2,048 tokens), qwen2.5-14b (group 5) and musicgen (MHA 24,
    # D 64) at musicgen's 2,112 (64 + 2,048); no tile multiple of 128
    "llava-d128-g4-s2624": (1, 32, 8, 2624, 2624, 128, True, None),
    "qwen2.5-d128-g5-s2112": (1, 40, 8, 2112, 2112, 128, True, None),
    "grok-d128-g6-s2624": (1, 48, 8, 2624, 2624, 128, True, None),
    "musicgen-d64-mha24-s2112": (1, 24, 24, 2112, 2112, 64, True, None),
}


def _bf16(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))


@pytest.mark.parametrize("name", sorted(TC_CASES))
def test_flash_attention_bf16_tensor_cores_match_plain(dev, name):
    b, h, hkv, sq, sk, d, causal, off = TC_CASES[name]
    rng = np.random.default_rng(100 + sorted(TC_CASES).index(name))
    q, k, v = (_bf16(rng, *shape).to(dev, torch.bfloat16)
               for shape in ((b, h, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)))
    before = flash_attention_cuda.launches
    got = flash_attention_cuda(q, k, v, causal=causal, kv_offset=off)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    want = flash_attention_plain(q, k, v, causal=causal, kv_offset=off)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("d", [32, 64, 112, 128])
def test_flash_attention_bf16_strided_views_with_kv_offset(dev, d):
    """The model's (B,S,H,D) projections seen as (B,H,S,D), a positive
    offset below Sk - Sq (later queries see fewer keys than aligned
    prefill would give them), output in q's layout."""
    rng = np.random.default_rng(d)
    B, Sq, Sk, H, Hkv, off = 2, 100, 300, 14, 2, 150
    q = _bf16(rng, B, Sq, H, d).to(dev, torch.bfloat16).transpose(1, 2)
    k = _bf16(rng, B, Sk, Hkv, d).to(dev, torch.bfloat16).transpose(1, 2)
    v = _bf16(rng, B, Sk, Hkv, d).to(dev, torch.bfloat16).transpose(1, 2)
    got = flash_attention_cuda(q, k, v, causal=True, kv_offset=off)
    torch.cuda.synchronize()
    assert got.stride() == q.stride()
    want = flash_attention_plain(q, k, v, causal=True, kv_offset=off)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


def test_flash_attention_bf16_refuses_unaligned_operands(dev):
    base = torch.zeros(1 * 2 * 64 * 64 + 8, dtype=torch.bfloat16, device=dev)
    q = base[1:1 + 2 * 64 * 64].view(1, 2, 64, 64)       # 2 bytes off
    k = torch.zeros((1, 1, 64, 64), dtype=torch.bfloat16, device=dev)
    odd = torch.zeros((1, 1, 64, 68), dtype=torch.bfloat16,
                      device=dev)[..., :64]              # 136-byte rows
    before = flash_attention_cuda.launches
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_cuda(q, k, k)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_cuda(q.contiguous(), odd, odd)
    assert flash_attention_cuda.launches == before


@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_attention_cuda_matches_plain(dev, name):
    b, h, hkv, sq, sk, d, dt, causal = FLASH_CASES[name]
    rng = np.random.default_rng(sorted(FLASH_CASES).index(name))
    q, k, v = (torch.from_numpy(rng.standard_normal(
        shape, dtype=np.float32)).to(dev, dt)
        for shape in ((b, h, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)))
    before = flash_attention_cuda.launches
    got = flash_attention_cuda(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    assert got.dtype == dt and got.shape == q.shape
    want = flash_attention_plain(q, k, v, causal=causal)
    tol = 1e-4 if dt == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("lse", [False, True])
@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_attention_custom_op_equals_the_direct_launch(dev, name, lse):
    """``flash_attention_cuda`` goes through the custom ops
    ``repro_torch::flash_attention`` / ``flash_attention_lse``; their
    body is the launch, so the bits are those of launching directly
    (``_launch``, the wrapper's path before the op)."""
    from repro_torch.kernels.flash_attention import _launch

    b, h, hkv, sq, sk, d, dt, causal = FLASH_CASES[name]
    rng = np.random.default_rng(sorted(FLASH_CASES).index(name))
    q, k, v = (torch.from_numpy(rng.standard_normal(
        shape, dtype=np.float32)).to(dev, dt)
        for shape in ((b, h, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)))
    before = flash_attention_cuda.launches
    got = flash_attention_cuda(q, k, v, causal=causal, return_lse=lse)
    want = _launch(q, k, v, causal, d ** -0.5, sk - sq, lse)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 2
    if lse:
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    else:
        assert torch.equal(got, want[0]) and want[1] is None


@pytest.mark.parametrize("lse", [False, True])
def test_flop_counter_counts_kernel3_by_its_formula(dev, lse):
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels.flash_attention import flash_flops

    rng = np.random.default_rng(11)
    q = torch.from_numpy(rng.standard_normal(
        (2, 100, 4, 64), dtype=np.float32)).to(dev, torch.bfloat16)
    k = torch.from_numpy(rng.standard_normal(
        (2, 130, 2, 64), dtype=np.float32)).to(dev, torch.bfloat16)
    qt, kt = q.transpose(1, 2), k.transpose(1, 2)
    before = flash_attention_cuda.launches
    with FlopCounterMode(display=False) as fc:
        flash_attention_cuda(qt, kt, kt, kv_offset=-20, return_lse=lse)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    assert fc.get_total_flops() == flash_flops(qt.shape, kt.shape, True,
                                               -20)


def test_chunked_attention_on_the_card_launches_once(dev):
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        shape, dtype=np.float32)).to(dev)
        for shape in ((2, 100, 4, 64), (2, 100, 2, 64), (2, 100, 2, 64)))
    before = flash_attention_cuda.launches
    got = T_MOD.chunked_attention(q, k, v, causal=True, q_chunk=32,
                                  kv_chunk=32)
    assert flash_attention_cuda.launches == before + 1
    want = T_MOD.chunked_attention_plain(q, k, v, causal=True, q_chunk=32,
                                         kv_chunk=32)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ["llava_next_mistral_7b", "musicgen_medium"])
def test_prefill_with_frontend_embeds_launches_once_a_layer(dev, arch):
    """The frontend stub's embeds ahead of the tokens (a smoke config at
    head dim 32, 40 embeds): each layer's chunked_attention launches
    kernel 3 once over embeds and tokens together, and the f32 logits at
    every position equal the plain attention's (1e-4, kernel 3's f32
    tolerance); so does a decode step against the prefilled cache, whose
    length counts the embeds."""
    from repro_torch.models import steps as T_S
    from repro_torch.models import transformer as T_T

    cfg, params = _smoke_params(arch, head_dim=32, n_frontend_embeds=40)
    params = _to(params, dev)
    rng = np.random.default_rng(4)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 70))).to(dev)
    fe = torch.from_numpy(rng.standard_normal(
        (2, 40, cfg.d_model), dtype=np.float32)).to(dev)
    before = flash_attention_cuda.launches
    got, cache, _ = T_T.forward(cfg, params, toks, frontend_embeds=fe,
                                return_cache=True)
    assert flash_attention_cuda.launches == before + cfg.n_layers
    assert got.shape == (2, 110, cfg.vocab) and cache["len"] == 110
    want, _, _ = T_T.forward(cfg, params, toks, frontend_embeds=fe,
                             attention=T_MOD.chunked_attention_plain)
    assert _rel(got, want.cpu()) <= 1e-4
    full = T_S.decode_cache(cfg, cache, 112, device=dev)
    nxt = toks[:, :1]
    dec, _ = T_S.make_serve_step(cfg)(params, full, nxt)
    seq = torch.cat([toks, nxt], dim=1)
    ref, _, _ = T_T.forward(cfg, params, seq, frontend_embeds=fe,
                            attention=T_MOD.chunked_attention_plain)
    assert _rel(dec, ref[:, -1].cpu()) <= 1e-4


@pytest.mark.parametrize("what", ["float16", "head_dim_16", "head_dim_96"])
def test_chunked_attention_on_the_card_raises_not_falls_back(dev, what):
    d = {"head_dim_16": 16, "head_dim_96": 96}.get(what, 64)
    dt = torch.float16 if what == "float16" else torch.float32
    q = torch.zeros((1, 8, 2, d), dtype=dt, device=dev)
    before = flash_attention_cuda.launches
    with pytest.raises((TypeError, ValueError)):
        T_MOD.chunked_attention(q, q, q, causal=True, q_chunk=8, kv_chunk=8)
    assert flash_attention_cuda.launches == before


# ---------------------------------------------------------------------------
# elastic subnets on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["cifar10", "fashion_mnist"])
def test_narrow_fc_level_is_contiguous_on_the_card_and_the_kernel_takes_it(
        dev, arch):
    """Both paper nets end FC S FC: the half-width level's last FC
    weight is a row-strided slice of the base, which the kernel
    refuses; ``SubnetFamily.build`` makes it contiguous on the card."""
    from repro_torch.elastic import ElasticSpec, SubnetFamily, slice_packed

    m, packed, _ = _full_net(arch, dev)
    fam = SubnetFamily.build(m, packed, ElasticSpec(fractions=(1.0, 0.5)))
    last = len(m.specs) - 1
    p = fam.level(1).packed[last]
    w = p["w_words"]
    assert w.is_cuda and w.is_contiguous()
    assert fam.storage(1)["copied_bytes"] >= w.numel() * 4
    a = torch.from_numpy(_words(np.random.default_rng(0), 16, 1,
                                w.shape[1])).to(dev)
    got = xnor_gemm_cuda(a, w, p["k_true"])
    assert torch.equal(got, xnor_gemm_ref(a, w, p["k_true"]))
    raw = slice_packed(m.specs, packed, fam.level(1).model.specs)[last]
    assert not raw["w_words"].is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        xnor_gemm_cuda(a, raw["w_words"], p["k_true"])


def test_elastic_engine_level_switch_serves_equal_to_the_plain_path(dev):
    """Levels 0 -> 1 -> 0 of a half-width family on the card (level 0
    per layer through kernel 1, level 1 one ``seg_cuda`` launch): every
    answer ``torch.equal`` to the plain forward of its level."""
    from repro_torch.api import TenantPlan
    from repro_torch.elastic import (
        ElasticEngine, ElasticPlan, ElasticSpec, SubnetFamily,
    )

    m, packed, xs = _net("fashion_mnist", dev, batch=4)
    fam = SubnetFamily.build(m, packed, ElasticSpec(fractions=(1.0, 0.5)))
    levels = []
    for lvl in fam:
        n = len(lvl.model.specs)
        row = [{c: 1e-4 for c in CONFIGS} for _ in range(n)]
        table = ProfileTable(
            lvl.model.name, (4,),
            tuple(f"L{s.idx}:{s.notation}" for s in lvl.model.specs),
            {4: row}, kernel_times={4: row},
            h2d_times={4: [1e-5] * n}, d2h_times={4: [1e-5] * n})
        ec = price_mapping(table, 4, ("XYZ",) * n)
        if lvl.level:
            ec = dataclasses.replace(
                ec, fused_segments=((0, n, "seg_cuda", 1e-9),))
        levels.append(TenantPlan(name=lvl.model.name, model=lvl.model,
                                 packed=lvl.packed, table=table, config=ec))
    plan = ElasticPlan(family=fam, levels=tuple(levels),
                       predicted=(False, False))
    engine = ElasticEngine(plan, allowed_batch_sizes=(4,), max_wait_s=0.0,
                           device=dev)
    engine.warm()
    x = xs[0].cpu()
    before = (xnor_gemm_cuda.launches, segment_cuda.launches)
    for k in (0, 1, 0):
        assert engine.set_level(k) is True
        lvl = fam.level(k)
        want = T_M.forward_packed(lvl.model.specs, lvl.packed, x).cpu()
        reqs = [engine.submit(x[j].numpy()) for j in range(4)]
        engine.step(force=True)
        got = torch.from_numpy(np.stack([r.wait(timeout=60) for r in reqs]))
        assert torch.equal(got, want), f"level {k}"
    assert engine.level_switches == 2
    assert xnor_gemm_cuda.launches > before[0]
    # level 1's one micro-batch: the eager launch before its graphs'
    # capture, then the replay that serves it
    assert segment_cuda.launches == before[1] + 2
    assert engine.graph_counts.graph_replays == 1


def _train_setup(dev_or_cpu, seed=0):
    """A full-width Fashion-MNIST TrainState on `dev_or_cpu` from one
    CPU generator's init, its AdamW and a data batch."""
    from repro_torch.bnn import layers as T_L
    from repro_torch.bnn.train import TrainState, init_train_state
    from repro_torch.data import ShardedBatcher, make_image_dataset

    m = T_M.build_model("fashion_mnist")
    init, opt = init_train_state(m, torch.Generator().manual_seed(seed),
                                 lr=2e-3, device="cpu")
    params = T_M.fp_params_from_numpy(
        [{k: v.numpy() for k, v in p.items()} for p in init.params],
        dev_or_cpu)
    state = TrainState(params, opt.init(T_L.split_trainable(params)[0]),
                       torch.zeros((), dtype=torch.int32, device=dev_or_cpu))
    ds = make_image_dataset(0, 256, (28, 28), 1)
    bt = ShardedBatcher(n=256, global_batch=32, seed=0)
    return m, opt, state, ds, bt


def _grads(m, state, x, y):
    """The loss gradient of every trainable leaf, as ``train_step``
    takes it, keyed by its path in the TrainState."""
    from repro_torch.bnn import layers as T_L
    from repro_torch.bnn.train import cross_entropy
    from repro_torch.tree import flatten, paths, unflatten

    dev = state.step.device
    trainable, bn = T_L.split_trainable(state.params)
    flat, tdef = flatten(trainable)
    live = [t.detach().requires_grad_(True) for t in flat]
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=False, allow_tf32=False):
        logits, _ = m.apply_fp(T_L.merge_params(unflatten(tdef, live), bn),
                               torch.as_tensor(x, device=dev), train=True)
        loss = cross_entropy(logits, torch.as_tensor(y, device=dev))
        got = torch.autograd.grad(loss, live)
    return {f".params/{n}": g.cpu() for n, g in zip(paths(trainable), got)}


def test_train_step_on_the_card_matches_the_cpu_step(dev):
    """One STE step on the card against the same step on CPU tensors:
    loss and grad_norm within a relative 1e-5, each gradient within 1e-5
    of its largest magnitude; after the first AdamW step (g / (|g| +
    1e-8) x lr) every w, gamma and beta within 0.05 x lr where the
    clipped gradient is at least 1e-6, and within one step either way
    (2 x lr) below that, where rounding decides the step's size; running
    stats within 1e-5 (mean) and 1e-4 (var) of their largest
    magnitude."""
    from repro_torch.bnn.train import train_step
    from repro_torch.tree import leaves, paths

    lr = 2e-3
    m, opt, cpu_state, ds, bt = _train_setup("cpu")
    _, _, dev_state, _, _ = _train_setup(dev)
    x, y = bt.batch((ds.x, ds.y), 0)
    cpu_g, dev_g = _grads(m, cpu_state, x, y), _grads(m, dev_state, x, y)
    cpu_state, cpu_m = train_step(m, opt, cpu_state, x, y)
    dev_state, dev_m = train_step(m, opt, dev_state, x, y)
    assert dev_state.step.device == dev
    for k in ("loss", "grad_norm"):
        assert float(dev_m[k]) == pytest.approx(float(cpu_m[k]), rel=1e-5)
    clip = min(1.0, 1.0 / (float(cpu_m["grad_norm"]) + 1e-9))
    for name, a, b in zip(paths(cpu_state), leaves(dev_state),
                          leaves(cpu_state)):
        assert a.device == dev, name
        d = (a.cpu() - b).abs()
        kind = name.rsplit("/", 1)[-1]
        if kind in ("mean", "var"):
            rtol = 1e-4 if kind == "var" else 1e-5
            assert float(d.max()) <= rtol * float(b.abs().max()), name
        elif name.startswith(".params"):
            g = cpu_g[name]
            assert float((dev_g[name] - g).abs().max()) <= 1e-5 * float(
                g.abs().max()), name
            firm = (clip * g).abs() >= 1e-6
            assert float(d[firm].max()) <= 0.05 * lr, name
            assert float(d.max()) <= 2 * lr, name


def test_train_loop_resumes_on_the_card_equal_to_the_uninterrupted_run(
        dev, tmp_path):
    """``TrainLoop`` on the card under cuDNN deterministic: a failure
    after step 3, a relaunch from the step-2 checkpoint (restored onto
    the card), a final state ``torch.equal`` to an uninterrupted run."""
    from repro_torch.bnn.train import train_step
    from repro_torch.runtime import InjectedFailure, LoopConfig, TrainLoop
    from repro_torch.tree import leaves

    def loop(name, inject=None):
        m, opt, state, ds, bt = _train_setup(dev)
        cfg = LoopConfig(total_steps=6, ckpt_dir=str(tmp_path / name),
                         save_every=2, async_save=True,
                         inject_failure_at=inject)
        return TrainLoop(lambda s, b: train_step(m, opt, s, *b),
                         lambda step: bt.batch((ds.x, ds.y), step), state,
                         cfg)

    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        ref = loop("ref")
        ref_out = ref.run()
        crash = loop("crash", inject=3)
        with pytest.raises(InjectedFailure):
            crash.run()
        crash.mgr.wait()        # the crashed run's async write lands first
        resumed = loop("crash")
        out = resumed.run()
    assert resumed.start_step == 2
    for a, b in zip(leaves(resumed.state), leaves(ref.state)):
        assert a.device == dev and torch.equal(a, b)
    assert [r["loss"] for r in out["metrics"]] == [
        r["loss"] for r in ref_out["metrics"]][2:]


# ---------------------------------------------------------------------------
# the MoE, SSM and hybrid layers on the card (f32, smoke sizes) against the
# same call on CPU tensors: sums in other orders, so a relative max error
# of 1e-5; the MoE drop set must be equal
# ---------------------------------------------------------------------------


def _rel(a, b) -> float:
    return float((a.float().cpu() - b.float()).abs().max()
                 / b.float().abs().max())


def _smoke_params(arch, **changes):
    from repro_torch import configs
    from repro_torch.models import transformer as T_T

    cfg = dataclasses.replace(configs.get_smoke(arch), **changes)
    return cfg, T_T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


def test_moe_ffn_on_the_card_equals_the_cpu_call(dev):
    """deepseek's smoke layer under capacity_factor 0.5, which drops
    choices: the same drop set on both devices."""
    from repro_torch.models import moe as T_MOE
    from repro_torch.models.config import MoEConfig

    cfg, params = _smoke_params("deepseek_moe_16b", moe=MoEConfig(
        n_experts=8, top_k=2, n_shared=2, d_expert=32, capacity_factor=0.5))
    p = {k: v[0] for k, v in params["blocks"]["moe"].items()}
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (3, 24, cfg.d_model)).astype(np.float32))
    out, aux = T_MOE.moe_ffn(x, p, cfg)
    out_d, aux_d = T_MOE.moe_ffn(x.to(dev), _to(p, dev), cfg)
    assert out_d.is_cuda and _rel(out_d, out) <= 1e-5
    assert abs(float(aux_d) - float(aux)) <= 1e-5 * float(aux)
    ids = T_MOE.route((x @ p["router"]).reshape(-1, 8), 2)[1]
    ids_d = T_MOE.route((x.to(dev) @ p["router"].to(dev)).reshape(-1, 8),
                        2)[1]
    C = T_MOE.capacity(cfg, 24)
    keep = T_MOE._dispatch_group(x, ids.reshape(3, 24, 2), C, 8)[1]
    keep_d = T_MOE._dispatch_group(x.to(dev), ids_d.reshape(3, 24, 2), C,
                                   8)[1]
    assert int((~keep).sum()) > 0 and torch.equal(keep_d.cpu(), keep)


@pytest.mark.parametrize("S", [3, 13])
def test_mamba_block_on_the_card_equals_the_cpu_call(dev, S):
    """Prefill (out and the three handoff entries) and one decode step
    from the handed-off state."""
    from repro_torch.models import mamba2 as T_M2

    cfg, params = _smoke_params("mamba2_130m")
    p = {k: v[0] for k, v in params["blocks"]["mamba"].items()}
    x = torch.from_numpy(np.random.default_rng(S).standard_normal(
        (2, S + 1, cfg.d_model)).astype(np.float32))
    out, cache = T_M2.mamba_block(cfg, x[:, :S], p)
    out_d, cache_d = T_M2.mamba_block(cfg, x[:, :S].to(dev), _to(p, dev))
    assert out_d.is_cuda and _rel(out_d, out) <= 1e-5
    for key in ("conv_x", "conv_bc", "ssd"):
        assert _rel(cache_d[key], cache[key]) <= 1e-5, key
    dec, new = T_M2.mamba_block(cfg, x[:, S:], p, cache=cache)
    dec_d, new_d = T_M2.mamba_block(cfg, x[:, S:].to(dev), _to(p, dev),
                                    cache=cache_d)
    assert _rel(dec_d, dec) <= 1e-5
    assert _rel(new_d["ssd"], new["ssd"]) <= 1e-5


def test_grok_smoke_forward_on_the_card_equals_the_cpu_forward(dev):
    """grok-1's smoke config (GQA 4/2, 8 experts top-2, no shared
    expert) with head dim 32, which the flash kernel takes (the smoke
    config's own 16 it refuses): prefill through the kernel once per
    layer, then a decode step.  f32 attention in the kernel differs from
    the plain version in its summation order (1e-4, kernel 3's f32
    tolerance)."""
    from repro_torch.models import steps as T_S
    from repro_torch.models import transformer as T_T

    cfg, params = _smoke_params("grok_1_314b", head_dim=32)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 70)))
    logits, cache, aux = T_T.forward(cfg, params, toks, return_cache=True)
    pd = _to(params, dev)
    before = flash_attention_cuda.launches
    logits_d, cache_d, aux_d = T_T.forward(cfg, pd, toks.to(dev),
                                           return_cache=True)
    assert flash_attention_cuda.launches == before + cfg.n_layers
    assert _rel(logits_d, logits) <= 1e-4
    assert abs(float(aux_d) - float(aux)) <= 1e-5 * float(aux)
    for key in ("k", "v"):
        assert _rel(cache_d[key], cache[key]) <= 1e-5
    full = T_S.decode_cache(cfg, cache, 80, device="cpu")
    full_d = T_S.decode_cache(cfg, cache_d, 80, device=dev)
    step = T_S.make_serve_step(cfg)
    nxt = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 1)))
    dec, _ = step(params, full, nxt)
    dec_d, _ = step(pd, full_d, nxt.to(dev))
    assert _rel(dec_d, dec) <= 1e-4


# ---------------------------------------------------------------------------
# the gradient through kernel 3 (FlashAttentionFn: the kernel's forward,
# the plain body recomputed by query chunk in the backward) against plain
# autograd through flash_attention_plain on the same card; f32 at 1e-4,
# bf16 at 2e-2 (the JAX bf16 test's), relative to the largest magnitude
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", [1, 2, 7])
@pytest.mark.parametrize("d", [32, 64, 112, 128])
def test_flash_attention_fn_gradient_matches_plain_autograd(dev, d, group,
                                                            dt):
    from repro_torch.kernels.flash_attention import FlashAttentionFn

    dtype = getattr(torch, dt)
    b, hkv, s = 2, 2, 200
    rng = np.random.default_rng(1000 + d + group)
    q, k, v, w = (torch.from_numpy(rng.standard_normal(
        shape, dtype=np.float32)).to(dev, dtype)
        for shape in ((b, s, hkv * group, d), (b, s, hkv, d),
                      (b, s, hkv, d), (b, s, hkv * group, d)))

    def grads(fn):
        qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
        out = fn(qq.transpose(1, 2), kk.transpose(1, 2), vv.transpose(1, 2))
        launched = flash_attention_cuda.launches
        got = torch.autograd.grad((out.transpose(1, 2).float() * w.float())
                                  .sum(), (qq, kk, vv))
        assert flash_attention_cuda.launches == launched   # no backward kernel
        return out, got

    before = flash_attention_cuda.launches
    out, got = grads(lambda qt, kt, vt: FlashAttentionFn.apply(
        qt, kt, vt, True, d ** -0.5, 0, 64, 128, True))
    assert flash_attention_cuda.launches == before + 1
    assert out.grad_fn is not None and out.dtype == dtype
    _, want = grads(lambda qt, kt, vt: flash_attention_plain(
        qt, kt, vt, causal=True, kv_offset=0, q_blk=64, k_blk=128))
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for label, a, c in zip("qkv", got, want):
        assert a.dtype == dtype and _rel(a, c.cpu()) <= tol, (label,
                                                             _rel(a, c.cpu()))


def test_chunked_attention_on_the_card_carries_a_gradient(dev):
    q = torch.randn((1, 70, 4, 32), device=dev, requires_grad=True)
    k = torch.randn((1, 70, 2, 32), device=dev, requires_grad=True)
    out = T_MOD.chunked_attention(q, k, k, causal=True, q_chunk=32,
                                  kv_chunk=32)
    assert out.grad_fn is not None
    gq, gk = torch.autograd.grad(out.sum(), (q, k))
    assert gq.is_cuda and gk.is_cuda and bool(torch.isfinite(gk).all())


def test_lm_train_step_on_the_card_matches_the_cpu_step(dev):
    """qwen2's smoke config widened to head dim 32 (the kernel refuses
    the smoke config's 16), f32 with TF32 off: one AdamW step on the
    card through the kernel against the same step on CPU tensors.  Loss,
    ce and grad_norm within a relative 1e-5, the updated params within
    0.05 x lr where the clipped gradient is at least 1e-6 (2 x lr
    below: rounding decides the step), and two kernel launches per layer
    in the card step: the forward's and its remat's (``cfg.remat``)."""
    from repro_torch.models import steps as T_S
    from repro_torch.optim import adamw
    from repro_torch.tree import flatten, leaves, unflatten

    cfg, params = _smoke_params("qwen2_0_5b", head_dim=32)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (2, 40)).astype(np.int32))
    lr = 1e-3
    opt = adamw(lr)
    step = T_S.make_train_step(cfg, opt)
    matmul = torch.backends.cuda.matmul
    prev, matmul.allow_tf32 = matmul.allow_tf32, False
    try:
        p_cpu, _, m_cpu = step(params, opt.init(params),
                               {"tokens": toks, "labels": toks})
        pd = _to(params, dev)
        before = flash_attention_cuda.launches
        p_dev, _, m_dev = step(pd, opt.init(pd), {"tokens": toks.to(dev),
                                                  "labels": toks.to(dev)})
        torch.cuda.synchronize()
        assert cfg.remat
        assert flash_attention_cuda.launches == before + 2 * cfg.n_layers
        flat, tdef = flatten(params)
        live = [t.clone().requires_grad_() for t in flat]
        loss, _ = T_S.loss_fn(cfg, unflatten(tdef, live), toks, toks)
        g_cpu = torch.autograd.grad(loss, live)
    finally:
        matmul.allow_tf32 = prev
    for k in ("loss", "ce", "grad_norm"):
        assert abs(float(m_dev[k]) - float(m_cpu[k])) <= 1e-5 * abs(
            float(m_cpu[k])), k
    clip = min(1.0, 1.0 / (float(m_cpu["grad_norm"]) + 1e-9))
    for a, b, g in zip(leaves(p_dev), leaves(p_cpu), g_cpu):
        d = (a.cpu() - b).abs()
        firm = (clip * g).abs() >= 1e-6
        assert float(d[firm].max()) <= 0.05 * lr
        assert float(d.max()) <= 2 * lr


# kernel 3's log-sum-exp output against the plain version's: (b, h, hkv,
# sq, sk, d, causal, kv_offset).  A negative offset is a KV part's of the
# context-parallel attention: its first queries see no key (lse -inf,
# output 0).  Outputs at the kernel's tolerances (f32 1e-4, bf16 2e-2);
# the lse, f32 statistics either way, at 1e-4 (f32) and 1e-3 (bf16
# inputs: the tensor-core path's exp2 is the hardware's approximate one)
LSE_CASES = {
    **{f"d{d}-part-{off}": (2, 14, 2, 256, 128, d, True, off)
       for d in (64, 112, 128) for off in (0, -64, -128, -200)},
    "d64-aligned": (2, 14, 2, 200, 200, 64, True, None),
    "d128-full": (1, 8, 1, 77, 130, 128, False, None),
    "d112-ragged-part": (1, 32, 32, 100, 64, 112, True, -70),
    "d64-no-row-sees": (1, 4, 2, 64, 64, 64, True, -64),
}


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(LSE_CASES))
def test_flash_attention_lse_matches_plain(dev, name, dt):
    b, h, hkv, sq, sk, d, causal, off = LSE_CASES[name]
    dtype = getattr(torch, dt)
    rng = np.random.default_rng(300 + sorted(LSE_CASES).index(name))
    q, k, v = (torch.from_numpy(rng.standard_normal(
        shape, dtype=np.float32)).to(dev, dtype)
        for shape in ((b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d)))
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))   # the models' views
    before = (flash_attention_cuda.launches,
              flash_attention_cuda.lse_launches)
    got, lse = flash_attention_cuda(q, k, v, causal=causal, kv_offset=off,
                                    return_lse=True)
    torch.cuda.synchronize()
    assert (flash_attention_cuda.launches,
            flash_attention_cuda.lse_launches) == (before[0] + 1,
                                                   before[1] + 1)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, sq)
    assert lse.is_contiguous() and got.stride() == q.stride()
    want, want_lse = flash_attention_plain(q, k, v, causal=causal,
                                           kv_offset=off, return_lse=True)
    dead = torch.isinf(want_lse)
    assert torch.equal(torch.isinf(lse), dead)
    assert bool((lse[dead] < 0).all())
    assert float(got[dead].float().abs().sum()) == 0
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    lse_tol = 1e-4 if dtype == torch.float32 else 1e-3
    torch.testing.assert_close(lse[~dead], want_lse[~dead], atol=lse_tol,
                               rtol=lse_tol)
    # the same launch without the lse: the same output bits
    alone = flash_attention_cuda(q, k, v, causal=causal, kv_offset=off)
    torch.cuda.synchronize()
    assert flash_attention_cuda.lse_launches == before[1] + 1
    assert torch.equal(alone, got)


# (B, S, H, Hkv, D, n_kv_parts, dtype): the kernel once per KV part,
# merged by log-sum-exp, against the plain body on the same card
KV_PARALLEL_CASES = {
    "qwen2-like-f32": (2, 256, 14, 2, 64, 16, "float32"),
    "qwen2-like-bf16": (2, 512, 14, 2, 64, 16, "bfloat16"),
    "d128-parts4-bf16": (1, 384, 8, 8, 128, 4, "bfloat16"),
    "d112-parts16-f32": (1, 256, 4, 4, 112, 16, "float32"),
}


@pytest.mark.parametrize("name", sorted(KV_PARALLEL_CASES))
def test_kv_parallel_attention_on_the_card_matches_its_plain_body(dev, name):
    B, S, H, Hkv, D, parts, dt = KV_PARALLEL_CASES[name]
    dtype = getattr(torch, dt)
    rng = np.random.default_rng(400 + sorted(KV_PARALLEL_CASES).index(name))
    q, k, v, w = (torch.from_numpy(rng.standard_normal(
        shape, dtype=np.float32)).to(dev, dtype)
        for shape in ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D),
                      (B, S, H, D)))
    before = flash_attention_cuda.lse_launches
    got = T_MOD.chunked_attention_kv_parallel(
        q, k, v, causal=True, q_chunk=128, n_kv_parts=parts)
    torch.cuda.synchronize()
    assert flash_attention_cuda.lse_launches == before + parts
    assert got.dtype == dtype and got.shape == q.shape
    want = T_MOD.chunked_attention_kv_parallel_plain(
        q, k, v, causal=True, q_chunk=128, n_kv_parts=parts)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)

    def grads(fn):
        qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
        out = fn(qq, kk, vv)
        return torch.autograd.grad((out.float() * w.float()).sum(),
                                   (qq, kk, vv))

    got_g = grads(lambda a, b, c: T_MOD.chunked_attention_kv_parallel(
        a, b, c, causal=True, q_chunk=128, n_kv_parts=parts))
    want_g = grads(lambda a, b, c: T_MOD.chunked_attention_kv_parallel_plain(
        a, b, c, causal=True, q_chunk=128, n_kv_parts=parts))
    for label, a, c in zip("qkv", got_g, want_g):
        assert a.dtype == dtype and _rel(a, c.cpu()) <= tol, (
            label, _rel(a, c.cpu()))
