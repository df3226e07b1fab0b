"""Bi-Real Net in the port (Liu et al., ECCV 2018): the real-valued layer
kinds' host executors against the float64 reference
(``tests/_bireal_reference.py``), a tiny net through ``api.Deployment``
on CPU tensors, the plan's encodings, fusion leaving real spans alone,
the entry points that take only the packed grammar, the ``layer.run``
spans, and (on a card) kernel 1 at a unit's stride-2 shapes.

Tolerances: a unit's binary-conv sums are exact integers and compared
with ``==``; float32 layer outputs within float32 rounding (1e-6 of the
largest magnitude) of the float64 reference on the same float32 inputs;
whole-net answers within the ``bireal18-224`` configuration's own
tolerance."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import _bireal_reference as R
from repro_torch import api, spans
from repro_torch.bnn import layers as L
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
from repro_torch.core.cost_model import layer_time_split_h100
from repro_torch.core.mapper import price_mapping
from repro_torch.core.plan import (
    IMAGE,
    REAL,
    PlanError,
    kind_of_label,
    layer_encodings,
)
from repro_torch.kernels.ref import xnor_gemm_ref
from repro_torch.kernels.xnor_popcount import xnor_gemm_cuda
from repro_torch.serving import pipeline as P

REPO = Path(__file__).resolve().parents[1]
CONFIG = json.loads((REPO / "hepbench/configs/bireal18-224.json").read_text())
ASPECTS = ("X", "Y", "Z", "XY", "XZ", "YZ", "XYZ")
TINY = bireal_notation((32, 64, 64, 64), (2, 2, 1, 1), (32, 32))


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny(seed=3):
    specs = tuple(L.parse_notation(TINY, (32, 32), 3, 10))
    model = BNNModel("bireal-tiny", specs, (32, 32), 3, 10)
    fp = random_fp_params(specs, seed)
    return model, fp, pack_params(specs, fp, device="cpu")


def _images(n, hw=(32, 32), seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, *hw, 3), dtype=np.uint8)


def _unit(h, w, cin, cout, stride, seed=1):
    """A unit's spec, fp params and packed params (CPU tensors)."""
    ho, wo = L.strided_side(h, stride), L.strided_side(w, stride)
    note = f"BR{cout}/2" if stride == 2 else f"BR{cout}"
    spec = L.LayerSpec(1, "bireal", note, (h, w, cin), (ho, wo, cout), cout)
    fp = random_real_params(spec, np.random.default_rng(seed))
    return spec, fp, packed_params_from_numpy([pack_real(spec, fp)], "cpu")[0]


def _nchw(x):
    return torch.as_tensor(x).to(torch.float64).permute(0, 3, 1, 2)


@pytest.mark.parametrize("gemm", [xnor_gemm_ref, xnor_gemm_cuda],
                         ids=["cpu-config", "kernel1-plain"])
@pytest.mark.parametrize("h,w,stride", [(7, 7, 1), (7, 7, 2), (8, 6, 1),
                                        (8, 6, 2), (5, 8, 2)])
def test_unit_sums_exact_with_zero_padding(h, w, stride, gemm):
    """The packed conv plus the padding correction equals the zero-padded
    ±1 conv exactly, at odd and even sides, stride 1 and 2, with 40
    input channels (a word's tail lanes in play)."""
    spec, fp, p = _unit(h, w, 40, 16, stride)
    x = torch.randn(2, h, w, 40, generator=torch.Generator().manual_seed(h))
    got = L.bireal_sums(x, p, stride, gemm)
    want = R.binary_sums(_nchw(x), fp["w"], stride)
    want = want.permute(0, 2, 3, 1).reshape(2, -1, 16)
    assert got.dtype == torch.int32
    assert torch.equal(got.to(torch.float64), want)


def _close(got, want, tol=1e-6):
    got, want = got.to(torch.float64), want.to(torch.float64)
    scale = want.abs().max()
    assert torch.allclose(got, want, rtol=0, atol=tol * float(scale))


@pytest.mark.parametrize("kind", ["stem", "mpr", "unit", "unit/2", "gap",
                                  "fcr"])
def test_real_layers_match_the_reference(kind):
    gen = torch.Generator().manual_seed(7)
    if kind == "stem":
        spec = L.parse_notation(["STEM16", "GAP", "FCR10"], (9, 10), 3, 10)[0]
        fp = random_real_params(spec, np.random.default_rng(2))
        p = packed_params_from_numpy([pack_real(spec, fp)], "cpu")[0]
        x = torch.as_tensor(_images(2, (9, 10)))
        layer = R.parse(["STEM16", "GAP", "FCR10"], (9, 10), 3, 10)[0]
        want = R.layer_forward(layer, fp, x).permute(0, 2, 3, 1)
        _close(L.real_layer_fn(spec, p)(x), want)
        return
    if kind.startswith("unit"):
        stride = 2 if kind.endswith("/2") else 1
        spec, fp, p = _unit(6, 6, 32, 64 if stride == 2 else 32, stride)
        x = torch.randn(2, 6, 6, 32, generator=gen)
        layer = ("bireal", spec.in_shape, spec.out_shape, spec.units, stride)
        want = R.layer_forward(layer, fp, _nchw(x)).permute(0, 2, 3, 1)
        _close(L.real_layer_fn(spec, p, xnor_gemm_ref)(x), want)
        return
    if kind == "fcr":
        spec = L.LayerSpec(1, "fcr", "FCR10", (24,), (10,), 10)
        fp = random_real_params(spec, np.random.default_rng(4))
        p = packed_params_from_numpy([pack_real(spec, fp)], "cpu")[0]
        x = torch.randn(3, 24, generator=gen)
        want = R.layer_forward(("fcr", (24,), (10,), 10, 1), fp,
                               x.to(torch.float64))
        got = L.real_layer_fn(spec, p)(x)
        assert got.dtype == torch.float32                # the logits
        _close(got, want)
        return
    x = torch.randn(2, 7, 9, 8, generator=gen)
    spec = L.LayerSpec(1, kind, "MPR4" if kind == "mpr" else "GAP",
                       (7, 9, 8), (4, 5, 8) if kind == "mpr" else (8,), 8)
    want = R.layer_forward((kind, (7, 9, 8), None, 8, 2), {}, _nchw(x))
    if kind == "mpr":
        want = want.permute(0, 2, 3, 1)
    _close(L.real_layer_fn(spec, {})(x), want)


def test_tiny_net_through_the_deployment():
    """``api.Deployment`` plans (analytic), maps and serves the tiny net on
    CPU tensors: every answer within the configuration's tolerance of the
    float64 reference, the whole net one device segment, unfused, the
    real layers and the logits float32."""
    model, fp, packed = _tiny()
    assert packed[0]["w"].dtype == torch.float32
    dep = api.Deployment.plan(
        (model, packed), batch_sizes=(1, 4), configs=ASPECTS, fuse=False,
        device="cpu", time_source="analytic")
    ec = dep.configuration()
    assert [s.on_device for s in ec.segments()] == [True]
    assert set(ec.layer_configs) <= set(ASPECTS)
    dep.serve(max_wait_s=0.002)
    x = _images(6)
    reqs = [dep.submit(xi) for xi in x]
    dep.drain()
    got = np.stack([r.wait() for r in reqs])
    want = R.forward(R.parse(TINY, (32, 32), 3, 10), fp,
                     torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == (6, 10)
    err = np.abs(got - want).max(1) / np.abs(want).max(1)
    assert err.max() <= CONFIG["tolerance"]


def test_layer_encodings_chain_the_real_kinds():
    labels = [f"L{i + 1}:{t}" for i, t in enumerate(TINY)]
    kinds = [kind_of_label(x) for x in labels]
    assert kinds[:3] == ["stem", "mpr", "bireal"] and kinds[-2:] == [
        "gap", "fcr"]
    encs = layer_encodings(kinds)
    assert encs[0] == (IMAGE, REAL)
    assert all(e == (REAL, REAL) for e in encs[1:])
    for broken in (["stem", "conv"], ["mpr", "gap"], ["conv", "bireal"],
                   ["stem", "step"]):
        with pytest.raises(PlanError):
            layer_encodings(broken)


CIFAR_FUSED = ((0, 19, "seg_cuda", 2.8186698150041645e-07),)


def test_fuse_leaves_real_spans_alone_and_cifar_unchanged():
    """``fuse=True`` finds no span of a Bi-Real net that ``segment_cuda``
    lowers, so its mapping stays unfused; CIFAR-10's analytic fused plan
    is the one the port chose before real-valued layers existed."""
    model, _, packed = _tiny()
    tp = api.plan_single(model, packed, batch_sizes=(1, 4), fuse=True,
                         configs=ASPECTS, time_source="analytic",
                         device="cpu")
    assert tp.config.fused_segments == ()
    assert not tp.table.segment_times
    cifar = build_model("cifar10")
    cp = pack_params(cifar.specs, random_fp_params(cifar.specs, 0),
                     device="cpu")
    tp = api.plan_single(cifar, cp, batch_sizes=(1, 4, 16), fuse=True,
                         configs=ASPECTS, time_source="analytic",
                         device="cpu")
    assert tp.config.fused_segments == CIFAR_FUSED


def _entry(name, model, packed):
    if name == "training":
        model.apply_fp(random_fp_params(model.specs, 0),
                       torch.zeros(1, 32, 32, 3))
    elif name == "elastic":
        from repro_torch.elastic import SubnetFamily
        from repro_torch.elastic.subnet import ElasticSpec

        SubnetFamily.build(model, packed, ElasticSpec((1.0, 0.5)))
    else:
        tp = api.plan_single(model, packed, batch_sizes=(1,),
                             time_source="analytic", device="cpu")
        if name == "fleet":
            from repro_torch.fleet import map_fleet

            map_fleet([tp.table, tp.table])
        else:
            from repro_torch.adapt import RemapController

            RemapController(object(), tp.table)


@pytest.mark.parametrize("name", ["fleet", "elastic", "adapt", "training"])
def test_packed_only_entry_points_name_the_kind(name):
    model, _, packed = _tiny()
    with pytest.raises(ValueError, match="layer 1 is 'stem'"):
        _entry(name, model, packed)


def test_layer_run_spans():
    """Recording, each composed layer is a ``layer.run`` span: a = layer
    index, b = the micro-batch of the pipeline span around it; off,
    nothing is recorded."""
    model, _, packed = _tiny()
    dep = api.Deployment.plan(
        (model, packed), batch_sizes=(1, 4), configs=("X",), device="cpu",
        time_source="analytic").serve(max_wait_s=0.0)
    x = _images(8)
    spans.take()
    for xi in x[:4]:
        dep.submit(xi)
    dep.step(force=True)
    assert len(spans.take()) == 0
    before = dep.engine.microbatches
    spans.start()
    try:
        for xi in x:
            dep.submit(xi)
        dep.step(force=True)
    finally:
        spans.stop()
    sp = spans.take()
    n = dep.engine.microbatches - before
    run = sp.name == "layer.run"
    assert n > 1
    assert sorted(sp.a[run]) == sorted(list(range(len(TINY))) * n)
    assert sorted(set(sp.b[run])) == list(range(n))
    assert np.all(sp.end[run] >= sp.start[run])


def test_analytic_rows_price_the_real_kinds():
    """The H100 model prices every real kind, the stem's upload at uint8
    bytes, on the card and on the host."""
    model = build_model("bireal18")
    for spec in model.specs:
        for cfg in ("CPU", "XYZ"):
            kern, h2d, d2h = layer_time_split_h100(spec, cfg, 8)
            assert kern > 0
            assert (h2d, d2h) == (0.0, 0.0) if cfg == "CPU" else h2d > 0
    stem = layer_time_split_h100(model.specs[0], "X", 8)
    pool = layer_time_split_h100(model.specs[1], "X", 8)
    # 8 x 224 x 224 x 3 bytes up, at 64 GB/s after a 2 us start-up; the
    # float32 stream and logits at 4 bytes a value
    assert stem[1] == pytest.approx(2e-6 + 8 * 224 * 224 * 3 / 64e9)
    assert pool[1] == pytest.approx(2e-6 + 8 * 112 * 112 * 64 * 4 / 64e9)
    assert layer_time_split_h100(model.specs[-1], "X", 8)[2] == (
        pytest.approx(2e-6 + 8 * 1000 * 4 / 64e9))


class _Done:
    """An event that is always complete (CPU tensors need no wait)."""

    def record(self, stream=None):
        pass

    def synchronize(self):
        pass


class _RingOnCPU(P.SegmentPipeline):
    """The graph path's schedule on CPU tensors: a replay runs the
    segment's callable into the next slot of its ring."""

    def _replay(self, s, x, i, observer):
        ring = self._rings.setdefault(s, P._Ring(
            [P._Slot(None, None, None, None, None, _Done())
             for _ in range(P.RING_SLOTS)], []))
        slot = ring.take()
        slot.host_out = self.segment_fns[s][1](torch.as_tensor(x))
        self.counts.graph_replays += 1
        return slot


def test_real_device_segments_take_the_graph_path():
    """On a card, a device segment of real-valued layers is served by
    captured graphs, and a host segment is not; on the ring's schedule
    the answers are the serial driver's, with no eager device segment."""
    model, _, packed = _tiny()
    tp = api.plan_single(model, packed, batch_sizes=(1, 4),
                         configs=ASPECTS + ("CPU",), time_source="analytic",
                         device="cpu")
    n = len(model.specs)
    device = price_mapping(tp.table, 4, ("XYZ",) * n)
    mixed = price_mapping(tp.table, 4, ("CPU",) * 2 + ("XYZ",) * (n - 3)
                          + ("CPU",))
    for config, want in ((device, [True]), (mixed, [False, True, False])):
        pipe = _RingOnCPU(model, packed, config, device="cpu")
        assert not any(pipe._graphed(s) for s in range(len(want)))
        pipe.device = torch.device("cuda", 0)   # the label only: no launch
        assert [pipe._graphed(s) for s in range(len(want))] == want
    batches = [_images(4, seed=i) for i in range(3)]
    pipe = _RingOnCPU(model, packed, device, device="cpu")
    serial = [pipe.run_serial(b) for b in batches]
    pipe.device = torch.device("cuda", 0)
    outs = pipe.run_pipelined(batches)
    for got, want in zip(outs, serial):
        assert np.array_equal(got, want)
    assert (pipe.counts.graph_replays, pipe.counts.eager_device_segments) == (
        3, 0)


@pytest.mark.cuda
def test_tiny_net_served_by_graphs_on_the_card():
    """On a card the tiny net's one device segment is replayed from
    captured graphs: answers within the configuration's tolerance of the
    float64 reference, kernel 1 counted once a unit a micro-batch, and
    the unit's sign-pack and epilogue kernels once each
    (``unit_launches``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    model, fp, _ = _tiny()
    dev = torch.device("cuda", torch.cuda.current_device())
    packed = pack_params(model.specs, fp, device=dev)
    dep = api.Deployment.plan(
        (model, packed), batch_sizes=(1, 4), configs=ASPECTS, fuse=False,
        device=dev, time_source="analytic").serve(max_wait_s=0.002)
    x = _images(16)
    reqs = [dep.submit(xi) for xi in x[:4]]     # the captures' batch
    dep.drain()
    before = xnor_gemm_cuda.launches
    before_units = dep.stats()["unit_launches"]
    reqs = [dep.submit(xi) for xi in x]
    dep.drain()
    got = np.stack([r.wait() for r in reqs])
    want = R.forward(R.parse(TINY, (32, 32), 3, 10), fp,
                     torch.from_numpy(x)).numpy()
    err = np.abs(got - want).max(1) / np.abs(want).max(1)
    assert err.max() <= CONFIG["tolerance"]
    stats = dep.stats()
    assert stats["graph_replays"] >= 4 and stats["eager_device_segments"] == 0
    units = sum(s.kind == "bireal" for s in model.specs)
    assert xnor_gemm_cuda.launches - before == 4 * units
    assert stats["unit_launches"] - before_units == 2 * 4 * units


@pytest.mark.cuda
@pytest.mark.parametrize("aspects", ASPECTS)
def test_kernel1_at_a_strided_unit_on_the_card(aspects):
    """Kernel 1 under each decomposition at BR128/2's shapes (56x56x64 ->
    28x28x128) gives the host path's sums exactly, and the unit's float
    output within float32 rounding of the host's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    dev = torch.device("cuda", torch.cuda.current_device())
    spec, _, p = _unit(56, 56, 64, 128, 2)
    x = torch.randn(3, 56, 56, 64, generator=torch.Generator().manual_seed(5))
    pd = {k: v.to(dev) if torch.is_tensor(v) else v for k, v in p.items()}

    def gemm(a, w, k):
        return xnor_gemm_cuda(a, w, k, aspects)

    host = L.bireal_sums(x, p, 2, xnor_gemm_ref)
    card = L.bireal_sums(x.to(dev), pd, 2, gemm)
    assert torch.equal(card.cpu(), host)
    _close(L.bireal_unit(x.to(dev), pd, 2, gemm).cpu(),
           L.bireal_unit(x, p, 2, xnor_gemm_ref))
