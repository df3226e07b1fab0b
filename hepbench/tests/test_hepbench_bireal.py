"""The ``bireal`` family on the CPU at a tiny size: one whole run of the
harness through a temporary benchmark folder (correct as served; the
family's rule calls every row wrong with that run's answers moved by
twice the tolerance, or with the bfloat16 control's rows in their
place), the counts at 224x224, the readers on synthetic runs, and the
reference agreeing with the tests' own copy."""

import contextlib
import io
import json
import shutil
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from hepbench import harness, roofline, roofline_bireal
from hepbench import run as bench_run
from hepbench.harness import Run
from hepbench.reference import bireal as ref
from hepbench.spec import Bench
from hepbench.trace import Slice

REPO = Path(__file__).resolve().parents[2]
TOLERANCE = 1e-3
TINY = {
    "name": "tinyreal", "family": "bireal", "source": "a test network",
    "model": "bireal-tiny",
    "notation": ["STEM32", "MPR8", "BR32", "BR64/2", "BR64/2", "BR64/2",
                 "GAP", "FCR1000"],
    "input_hw": [32, 32], "in_channels": 3, "n_classes": 10,
    "bn_eps": 1e-5, "tolerance": TOLERANCE, "max_wrong_share": 0.25,
    "batch_sizes": [1, 4],
    "policy": "dp", "configs": ["X", "XYZ"], "fuse": False,
    "max_wait_s": 0.002,
}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("bench")
    folder = root / "hepbench"
    for sub in ("metrics", "traffic", "families"):
        shutil.copytree(REPO / "hepbench" / sub, folder / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    (folder / "configs").mkdir()
    (folder / "configs" / "tinyreal.json").write_text(json.dumps(TINY))
    doc = {
        "command": ["python3", "hepbench/run.py"], "paths": ["hepbench"],
        "run_seconds": 1,
        "configs": [{"name": "tinyreal", "source": "test",
                     "file": "hepbench/configs/tinyreal.json",
                     "reduced": [], "why": "test"}],
        "workloads": [{"name": "tinyreal.flood", "config": "tinyreal",
                       "traffic": "flood", "chips": 1, "why": "test"}],
        "end_to_end": [
            {"name": "served_img_s", "unit": "img/s", "better": "higher",
             "bound": 0.25, "source": "host_clock",
             "workloads": ["tinyreal.flood"]},
            {"name": "setup_s", "unit": "s", "better": "lower",
             "bound": 0.25, "source": "host_clock"}],
        "per_layer": [],
    }
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    return root


@pytest.fixture(scope="module")
def served(root):
    """One whole CPU run of the tiny cell, and what the family's rule was
    given: the program's answers, the reference's rows for them, and the
    bfloat16 control's."""
    seen = {}
    family_of = Bench.family

    def family(self, config):
        fam = family_of(self, config)

        def expected(config, *args, control=False):
            rows = fam.expected(config, *args, control=control)
            if not control:
                seen["want_all"] = rows
                seen["low_all"] = fam.expected(config, *args, control=True)
            return rows

        def agree(config, answers, want):
            seen["answers"], seen["want"] = np.array(answers), want
            return fam.agree(config, answers, want)

        return SimpleNamespace(**{**vars(fam), "expected": expected,
                                  "agree": agree})

    mp = pytest.MonkeyPatch()
    mp.setattr(Bench, "family", family)
    mp.setattr(bench_run, "forbidden_modules", lambda: [])
    mp.setattr(sys, "path", list(sys.path))
    mp.setenv("TRITON_CACHE_DIR", "unset")
    mp.setenv("TORCH_EXTENSIONS_DIR", "unset")
    mp.setattr(harness, "POOL", 48)
    mp.setattr(harness, "WARM_S", 0.05)
    # the drain ends once every answer is in; the limit only has to
    # outlast 128 CPU answers on a loaded machine
    mp.setattr(harness, "DRAIN_S", 30.0)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = bench_run.main(
                ["--workload", "tinyreal.flood", "--seed", str(2**31 + 11),
                 "--seconds", "0.2", "--trace", "0"],
                root=root, device="cpu", t_start=time.monotonic())
    finally:
        torch.set_num_threads(n)
        mp.undo()
    assert rc == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    # the control's rows of the answered images, found by their
    # reference rows (each image's is its own)
    index = {w.tobytes(): i for i, w in enumerate(seen["want_all"])}
    want = seen["want"]
    control = seen["low_all"][[index[w.tobytes()] for w in want]]
    return line, seen["answers"], want, control


def _moved(out):
    """Each row moved by twice the tolerance of its largest logit."""
    return out + 2 * TOLERANCE * np.abs(out).max(axis=1, keepdims=True)


@pytest.mark.parametrize("case", ["served", "moved", "control"])
def test_bireal_family_decides_correct(case, served):
    """As served, every answer of a whole run agrees with the float64
    reference; with each row moved by twice the tolerance, or with the
    bfloat16 control's logits in the program's place, every answered row
    is wrong, far above the share of wrong rows the rule allows."""
    from hepbench.families import bireal as family

    line, answers, want, control = served
    checks = line["checks"]
    limit = int(0.25 * line["attempted"])
    assert line["attempted"] > 0 and line["failed"] == 0
    assert checks["missing_answers"]["value"] == 0
    assert line["mapping"].endswith(" fused none")
    assert len(answers) == len(want) == line["attempted"]
    if case == "served":
        assert line["correct"] is True
        assert checks["wrong_answers"] == {"value": 0, "limit": limit}
        assert family.row_error(answers, want).max() < TOLERANCE / 4
        assert set(line["metrics"]) == {"served_img_s", "setup_s"}
        return
    got = _moved(answers) if case == "moved" else control
    ok, checks = family.agree(TINY, got, want)
    assert not ok.any()
    assert checks["wrong_answers"] == (line["attempted"], limit)


@pytest.mark.parametrize("share", [0.0, 0.1, 0.25, 0.26, 1.0])
def test_bireal_rule_allows_a_share_of_wrong_rows(share, served):
    """Rows beyond the tolerance are wrong, and the run is correct while
    they are at most ``max_wrong_share`` of the answered rows."""
    from hepbench.families import bireal as family

    _, answers, want, _ = served
    rows = np.tile(want, (100 // len(want) + 1, 1))[:100]
    got = rows.copy()
    bad = int(round(share * len(rows)))
    got[:bad] = _moved(got[:bad])
    ok, checks = family.agree(TINY, got, rows)
    assert list(ok) == [False] * bad + [True] * (len(rows) - bad)
    value, limit = checks["wrong_answers"]
    assert (value, limit) == (bad, 25)
    assert (value <= limit) == (share <= 0.25)


def _bireal18():
    bench = Bench(REPO)
    config = json.loads(
        (REPO / "hepbench" / "configs" / "bireal18-224.json").read_text())
    layers = ref.parse(config["notation"], config["input_hw"],
                       config["in_channels"], config["n_classes"])
    return bench, config, layers


def test_bireal18_counts_and_peaks():
    """1,676,279,808 one-bit products and 137,793,536 real multiply-adds
    an image at 224x224, and the peaks roofline.py freezes."""
    _, config, layers = _bireal18()
    assert len(layers) == 20 and config["family"] == "bireal"
    assert roofline_bireal.products(layers) == 1_676_279_808
    assert roofline_bireal.real_macs(layers) == 137_793_536
    assert [x.real_macs for x in layers if x.real_macs] == [
        118_013_952, 6_422_528, 6_422_528, 6_422_528, 512_000]
    assert roofline_bireal.units(layers) == list(range(2, 18))
    for name in ("HBM_BYTES_PER_S", "B1_PRODUCTS_PER_S", "B1_OPS_PER_S"):
        assert getattr(roofline_bireal, name) == getattr(roofline, name)
    unit = layers[6]                      # BR128/2: 56x56x64 -> 28x28x128
    assert unit.products == 28 * 28 * 128 * 9 * 64
    assert roofline_bireal.unit_launch_bytes(unit, 32) == 4 * (
        32 * (56 * 56 * 2 + 28 * 28 * 128) + 128 * 9 * 2)
    assert roofline_bireal.image_bound_s(layers) == pytest.approx(
        1_676_279_808 / roofline.B1_PRODUCTS_PER_S
        + 2 * 137_793_536 / 67e12)


class _Served:
    layer_configs = ("X",) * 20
    expected_time_per_example = 2.5e-4


def _synthetic_run(slices, layers):
    # 64 answers in a 2 s window: two micro-batches of 32 in the slice
    done = np.concatenate([np.full(32, 1.2), np.full(32, 1.3)])
    return Run(cell={"name": "bireal18-224.flood"}, config={}, mix={},
               seconds=2.0, t0=0.0, t_end=2.0, setup_s=1.0, layers=layers,
               served=_Served(), allowed=(1, 8, 32), due=done - 0.1,
               submit=done - 0.1, done=done, image=np.zeros(64, np.int64),
               ok=np.ones(64, bool),
               steps=np.array([[0.0, 0.5, 32], [0.6, 1.0, 32]]),
               slices=slices)


def _slice(launched, traced, kernel_s=0.004, busy=0.02):
    return Slice(begin=1.0, t0=1.1, t1=1.6, launched=launched,
                 traced=traced, kernel_s={"xnor_gemm_cuda": kernel_s},
                 busy_s=busy, device_ops=[], idle_gaps=[])


def test_bireal_readers_on_a_synthetic_run():
    bench, _, layers = _bireal18()
    n = {"xnor_gemm_cuda": 32}                   # 16 units x 2 batches
    run = _synthetic_run([_slice(n, n)], layers)
    # the last four are cifar10-fused's readers, which read any family
    read = {m: bench.reader(m)(run) for m in (
        "bireal_xnor_roofline.flood", "bireal_step_mfu.flood",
        "bireal_float_share.flood", "device_idle.flood",
        "step_us_per_img.flood", "answers_per_step.flood",
        "predicted_us_per_img.flood")}
    bound = 2 * sum(roofline_bireal.unit_launch_bound_s(layers[i], 32)
                    for i in range(2, 18))
    assert read["bireal_xnor_roofline.flood"] == pytest.approx(
        100 * bound / 0.004)
    assert read["bireal_step_mfu.flood"] == pytest.approx(
        100 * 64 * roofline_bireal.image_bound_s(layers) / 2.0)
    assert read["bireal_float_share.flood"] == pytest.approx(80.0)
    assert read["device_idle.flood"] == pytest.approx(96.0)
    assert read["step_us_per_img.flood"] == pytest.approx(0.9 / 64 * 1e6)
    assert read["answers_per_step.flood"] == pytest.approx(32.0)
    assert read["predicted_us_per_img.flood"] == pytest.approx(250.0)
    # launches the mapping does not predict: no roofline; no slice: none
    # of the traced metrics
    miss = _synthetic_run([_slice({"xnor_gemm_cuda": 31}, n)], layers)
    assert bench.reader("bireal_xnor_roofline.flood")(miss) is None
    bare = _synthetic_run([], layers)
    for name in ("bireal_xnor_roofline.flood", "bireal_float_share.flood",
                 "device_idle.flood"):
        assert bench.reader(name)(bare) is None


def test_reference_copies_agree():
    """The benchmark's reference (blocks, float32 sign convs) and the
    tests' float64 copy give the same logits, and its control moves
    them by far more than the tolerance."""
    sys.path.insert(0, str(REPO / "tests"))
    try:
        import _bireal_reference as twin
    finally:
        sys.path.remove(str(REPO / "tests"))
    family = Bench(REPO).family(TINY)
    layers, weights, images = family.inputs(TINY, 5, 6, "cpu", 6)
    got = family.expected(TINY, layers, weights, images)
    want = twin.forward(twin.parse(TINY["notation"], (32, 32), 3, 10),
                        [{k: v.numpy() for k, v in p.items()}
                         for p in weights], images)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-12, atol=1e-12)
    low = family.expected(TINY, layers, weights, images, control=True)
    assert np.all(family.row_error(low, got) > 4 * TOLERANCE)
    ok, checks = family.agree(TINY, got.astype(np.float32), got)
    assert ok.all() and checks["wrong_answers"] == (0, len(got) // 4)
