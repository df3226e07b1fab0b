"""Whole runs of the harness on the CPU at a tiny size: a configuration, a
network family, a traffic mix, a cell and a metric that exist only as
files in a temporary benchmark folder are found by name, and a timed path
broken underneath makes ``correct`` come out false."""

import hashlib
import itertools
import json
import shutil
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from hepbench import harness, roofline
from hepbench import run as bench_run
from hepbench.spec import Bench

REPO = Path(__file__).resolve().parents[2]

TINY = {
    "name": "tiny", "source": "a test network", "model": "tiny",
    "notation": ["C32", "S", "C32", "MP4", "S", "FLAT", "FC64", "S", "FC64"],
    "input_hw": [8, 8], "in_channels": 3, "n_classes": 10, "bn_eps": 1e-5,
    "batch_sizes": [1, 4, 16], "policy": "dp", "fuse": False,
    "max_wait_s": 0.002,
}
NEW_METRIC = '''"""A metric only this test's folder has: answers in the run."""

import numpy as np


def read(run):
    return float(np.sum(~np.isnan(run.done)))
'''
TOLERANT = '''"""A family only this test's folder has: the paper's networks,
their answers held to the reference moved by the configuration's
``offset``, within its ``tolerance``."""

import numpy as np

from hepbench.families import hepbnn

KERNELS = hepbnn.KERNELS
inputs = hepbnn.inputs
build_program = hepbnn.build_program


def expected(config, net, weights, images, *, control=False):
    return config["offset"] + hepbnn.expected(config, net, weights, images,
                                              control=control)


def agree(config, answers, want):
    gap = np.max(np.abs(answers - want), axis=1)
    ok = gap <= config["tolerance"]
    return ok, {"wrong_answers": (int(np.sum(~ok)), 0),
                "widest_gap": (float(gap.max()), config["tolerance"])}
'''
# a tolerant configuration: its answers are off by `offset` from its
# expected ones; an exact comparison would fail both
OFFSETS = {"tolerant-near": 0.25, "tolerant-off": 1.0}


@pytest.fixture(autouse=True)
def one_thread():
    """The port's host layers on one thread: the suite runs beside other
    workers."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("bench")
    folder = root / "hepbench"
    shutil.copytree(REPO / "hepbench" / "metrics", folder / "metrics")
    shutil.copytree(REPO / "hepbench" / "traffic", folder / "traffic")
    shutil.copytree(REPO / "hepbench" / "families", folder / "families",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (folder / "families" / "tolerant.py").write_text(TOLERANT)
    (folder / "configs").mkdir()
    (folder / "configs" / "tiny.json").write_text(json.dumps(TINY))
    (folder / "configs" / "tiny-host.json").write_text(
        json.dumps({**TINY, "name": "tiny-host", "configs": ["CPU"]}))
    for name, offset in OFFSETS.items():
        (folder / "configs" / f"{name}.json").write_text(json.dumps(
            {**TINY, "name": name, "family": "tolerant", "offset": offset,
             "tolerance": 0.5}))
    (folder / "traffic" / "trickle.json").write_text(
        json.dumps({"kind": "poisson", "rate_per_s": 300}))
    (folder / "metrics" / "answered.test.py").write_text(NEW_METRIC)
    cells = ["tiny.flood", "tiny.trickle"]
    doc = {
        "command": ["python3", "hepbench/run.py"], "paths": ["hepbench"],
        "run_seconds": 1,
        "configs": [{"name": "tiny", "source": "test",
                     "file": "hepbench/configs/tiny.json", "reduced": [],
                     "why": "test"},
                    {"name": "tiny-host", "source": "test",
                     "file": "hepbench/configs/tiny-host.json",
                     "reduced": [], "why": "test"}] + [
                    {"name": name, "source": "test",
                     "file": f"hepbench/configs/{name}.json",
                     "reduced": [], "why": "test"} for name in OFFSETS],
        "workloads": [
            {"name": "tiny.flood", "config": "tiny", "traffic": "flood",
             "chips": 1, "why": "test"},
            {"name": "tiny.trickle", "config": "tiny", "traffic": "trickle",
             "chips": 1, "why": "test"},
            {"name": "tiny-host.flood", "config": "tiny-host",
             "traffic": "flood", "chips": 1, "why": "test"}] + [
            {"name": f"{name}.flood", "config": name, "traffic": "flood",
             "chips": 1, "why": "test"} for name in OFFSETS],
        "end_to_end": [
            {"name": "served_img_s", "unit": "img/s", "better": "higher",
             "bound": 0.05, "source": "host_clock",
             "workloads": ["tiny.flood", "tiny-host.flood"]},
            {"name": "latency_p95_ms", "unit": "ms", "better": "lower",
             "bound": 0.05, "source": "host_clock",
             "workloads": ["tiny.trickle"]},
            {"name": "setup_s", "unit": "s", "better": "lower",
             "bound": 0.25, "source": "host_clock"}],
        "per_layer": [
            {"name": "answered.test", "unit": "img", "better": "higher",
             "source": "program_counter", "layer": "client",
             "moves": "latency_p95_ms"},
            {"name": "answers_per_step.flood", "unit": "img",
             "better": "higher", "source": "program_counter",
             "layer": "batcher", "moves": "served_img_s",
             "workloads": cells[:1]}],
    }
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    return root


def _isolate(monkeypatch):
    """A run here shares its process with tests that import JAX and the
    JAX package; the look for them is tested on its own, below."""
    monkeypatch.setattr(bench_run, "forbidden_modules", lambda: [])
    monkeypatch.setattr(sys, "path", list(sys.path))


def _run(root, cell, monkeypatch, capsys, *, seed=2**31 + 3, trace=0):
    _isolate(monkeypatch)
    monkeypatch.setenv("TRITON_CACHE_DIR", "unset")
    monkeypatch.setenv("TORCH_EXTENSIONS_DIR", "unset")
    monkeypatch.setattr(harness, "POOL", 128)
    monkeypatch.setattr(harness, "WARM_S", 0.2)
    monkeypatch.setattr(harness, "DRAIN_S", 1.0)
    rc = bench_run.main(
        ["--workload", cell, "--seed", str(seed), "--seconds", "0.6",
         "--trace", str(trace)],
        root=root, device="cpu", t_start=time.monotonic())
    out = capsys.readouterr()
    assert rc == 0, out.err[-2000:]
    line = json.loads(out.out.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert out.err.strip().splitlines()[-1].startswith("check ")
    return line


def test_cell_config_mix_and_metric_found_by_name(root, monkeypatch, capsys):
    line = _run(root, "tiny.trickle", monkeypatch, capsys, trace=1)
    assert line["correct"] is True
    assert line["attempted"] == round(300 * 0.6)
    assert set(line["metrics"]) == {"answered.test"}
    assert line["metrics"]["answered.test"]["value"] == line["attempted"]
    line = _run(root, "tiny.trickle", monkeypatch, capsys)
    assert set(line["metrics"]) == {"latency_p95_ms", "setup_s"}
    line = _run(root, "tiny.flood", monkeypatch, capsys)
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == {"served_img_s", "setup_s"}
    assert line["mapping"].startswith("[") and " fused " in line["mapping"]
    assert line["checks"] == {"wrong_answers": {"value": 0, "limit": 0},
                              "missing_answers": {"value": 0, "limit": 0}}


def test_a_configs_list_limits_the_mappers_candidates(root, monkeypatch,
                                                      capsys):
    """A configuration file's ``configs`` reaches the planner: with the
    host alone among the candidates every layer is served on the host,
    and the result line says so."""
    line = _run(root, "tiny-host.flood", monkeypatch, capsys)
    assert line["correct"] is True
    assert line["mapping"] == "[H1-9] fused none"


def _on_complete_fault(change):
    from repro_torch.serving.pipeline import SegmentPipeline

    original = SegmentPipeline.run_pipelined

    def broken(self, inputs, *, on_complete=None, observer=None):
        def complete(i, out):
            on_complete(i, change(np.array(out)))
        return original(self, inputs, on_complete=complete,
                        observer=observer)

    return SegmentPipeline, "run_pipelined", broken


def _altered(out):
    out[0, 0] += 1
    return out


def _half_left_out(out):
    out[len(out) // 2:] = 0
    return out


def _misrouted(out):
    return out[::-1].copy()


def _dropped():
    from repro_torch.serving.batcher import MicroBatcher

    original, n = MicroBatcher.submit, itertools.count()

    def lossy(self, x):
        r = original(self, x)
        if next(n) % 7 == 3:
            with self._lock:           # one client submits: r is last
                assert self._queue.pop() is r
        return r

    return MicroBatcher, "submit", lossy


FAULTS = {
    "answer_altered": lambda: _on_complete_fault(_altered),
    "half_batch_left_out": lambda: _on_complete_fault(_half_left_out),
    "rows_misrouted": lambda: _on_complete_fault(_misrouted),
    "requests_dropped": _dropped,
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_timed_path_is_not_correct(fault, root, monkeypatch, capsys):
    monkeypatch.setattr(*FAULTS[fault]())
    line = _run(root, "tiny.flood", monkeypatch, capsys)
    assert line["correct"] is False
    checks = line["checks"]
    if fault == "requests_dropped":
        assert checks["missing_answers"]["value"] > 0
        assert line["failed"] > 0
    else:
        assert checks["wrong_answers"]["value"] > 0


def test_control_in_the_programs_place_is_not_correct(root, monkeypatch,
                                                      capsys):
    """The control, the reference with its batch norms in bfloat16, put in
    the program's place answer by answer, fails the harness's own
    comparison: ``correct`` comes out false through the whole run."""
    from hepbench.reference import bnn as ref
    from repro_torch.serving.pipeline import SegmentPipeline

    control_of = {}                  # request payload -> control scores
    family_of, original = Bench.family, SegmentPipeline.run_pipelined

    def family(self, config):
        fam = family_of(self, config)

        def recording(config, weights, images, device, store):
            program = fam.build_program(config, weights, images, device,
                                        store)
            layers = ref.parse(config["notation"], config["input_hw"],
                               config["in_channels"], config["n_classes"])
            low = ref.forward(layers, weights, images, eps=config["bn_eps"],
                              control=True).numpy()
            control_of.update(
                (w.tobytes(), s) for w, s in zip(program.payloads, low))
            return program

        return SimpleNamespace(**{**vars(fam), "build_program": recording})

    def control(self, inputs, *, on_complete=None, observer=None):
        def complete(i, out):
            out = np.array(out)
            for j, w in enumerate(np.asarray(inputs[i])):
                if w.tobytes() in control_of:       # pad rows stay
                    out[j] = control_of[w.tobytes()]
            on_complete(i, out)
        return original(self, inputs, on_complete=complete,
                        observer=observer)

    monkeypatch.setattr(Bench, "family", family)
    monkeypatch.setattr(SegmentPipeline, "run_pipelined", control)
    line = _run(root, "tiny.flood", monkeypatch, capsys)
    assert control_of and line["correct"] is False
    assert line["checks"]["wrong_answers"]["value"] > 0
    assert line["checks"]["missing_answers"]["value"] == 0


@pytest.mark.parametrize("config", sorted(OFFSETS))
def test_a_family_that_exists_only_as_files(config, root, monkeypatch,
                                            capsys):
    """A family file of the temporary folder alone is found by its
    configuration's ``"family"`` key, and its own agreement rule decides
    ``correct``: answers off by 0.25 pass its tolerance of 0.5 (an exact
    comparison would fail them), answers off by 1 fail it, every one."""
    bench = Bench(root)
    family = bench.family(bench.config(config))
    assert Path(family.__file__) == root / "hepbench/families/tolerant.py"
    line = _run(root, f"{config}.flood", monkeypatch, capsys)
    near = OFFSETS[config] < 0.5
    assert line["correct"] is near
    assert line["failed"] == 0 and line["attempted"] > 0
    assert line["checks"] == {
        "wrong_answers": {"value": 0 if near else line["attempted"],
                          "limit": 0},
        "widest_gap": {"value": OFFSETS[config], "limit": 0.5},
        "missing_answers": {"value": 0, "limit": 0}}


# computed at commit cc484db (the harness before family files) by the
# same steps, from the seeds 2**31 + 3 derives for weights and images
PARENT_SEEDS = [8089701765405402584, 5622961840797110046,
                1625475212250188974, 8755683368951546384]
PARENT_DIGESTS = {"weights": "fb33705c18844430", "images": "2becbc5d19d9b9cd",
                  "payloads": "6942b017e09c8eb3", "scores": "d2d0186890a21d7c",
                  "control": "58abe6e4630ecdb7"}
PARENT_CIFAR_OPERATIONS = 926306304
PARENT_CIFAR_BOUNDS = {(0, 19, 16): 1.7305555555555556e-06,
                       (0, 17, 16): 1.7305172941536578e-06,
                       (18, 19, 16): 1.1844776119402985e-09,
                       (0, 19, 1): 4.802602985074627e-07,
                       (4, 5, 4): 8.079283582089552e-08}


def _digest(*arrays) -> str:
    d = hashlib.sha256()
    for a in arrays:
        d.update(np.ascontiguousarray(a).tobytes())
    return d.hexdigest()[:16]


def test_hepbnn_family_reads_what_the_harness_read_before():
    """The ``hepbnn`` family gives, seed for seed, the weights, images,
    packed payloads, reference scores and control scores that the harness
    made itself before family files, and the roofline counts the same
    operations and launch bounds of ``cifar10-fused``'s layers."""
    from hepbench import inputs

    seeds = harness.seeds(2**31 + 3, 4)
    assert seeds == PARENT_SEEDS == inputs.seeds(2**31 + 3, 4)
    bench = Bench(REPO)
    family = bench.family(TINY)
    assert family is bench.family({**TINY, "family": "hepbnn"})
    net, weights, images = family.inputs(TINY, seeds[0], seeds[1], "cpu",
                                         256)
    got = {
        "weights": _digest(*[p[k].numpy() for p in weights
                             for k in sorted(p)]),
        "images": _digest(images.numpy()),
        "payloads": _digest(family.payloads(images)),
        "scores": _digest(family.expected(TINY, net, weights, images)),
        "control": _digest(family.expected(TINY, net, weights, images,
                                           control=True)),
    }
    assert got == PARENT_DIGESTS
    cifar = bench.config("cifar10-fused")
    layers = bench.family(cifar).inputs(cifar, seeds[0], seeds[1], "cpu",
                                        1)[0]
    assert roofline.operations(layers) == PARENT_CIFAR_OPERATIONS
    assert {k: roofline.launch_bound_s(layers, *k)
            for k in PARENT_CIFAR_BOUNDS} == PARENT_CIFAR_BOUNDS


def test_no_card_no_result(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _isolate(monkeypatch)
    monkeypatch.setenv("TRITON_CACHE_DIR", "unset")
    monkeypatch.setenv("TORCH_EXTENSIONS_DIR", "unset")
    rc = bench_run.main(["--workload", "cifar10-fused.flood", "--seed", "1",
                         "--seconds", "1"], root=REPO)
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_jax_loaded_is_found_by_top_level_name():
    loaded = ["repro_torch.api", "repro.core", "jax.numpy", "jaxlib",
              "flax.linen", "reprox", "numpy"]
    assert bench_run.forbidden_modules(loaded) == [
        "flax.linen", "jax.numpy", "jaxlib", "repro.core"]
    assert bench_run.forbidden_modules(["repro_torch", "torch"]) == []


@pytest.mark.cuda
def test_traced_run_on_the_card(root, monkeypatch, capsys):
    """On the card: a traced run of the tiny cell is correct, and its
    trace saw the device work."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _isolate(monkeypatch)
    monkeypatch.setenv("TRITON_CACHE_DIR", "unset")
    monkeypatch.setenv("TORCH_EXTENSIONS_DIR", "unset")
    monkeypatch.setattr(harness, "POOL", 256)
    rc = bench_run.main(["--workload", "tiny.flood", "--seed", "7",
                         "--seconds", "3", "--trace", "1"], root=root,
                        t_start=time.monotonic())
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
