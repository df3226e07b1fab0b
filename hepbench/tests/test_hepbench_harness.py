"""Whole runs of the harness on the CPU at a tiny size: a configuration, a
traffic mix, a cell and a metric that exist only as files in a temporary
benchmark folder are found by name, and a timed path broken underneath
makes ``correct`` come out false."""

import itertools
import json
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from hepbench import harness
from hepbench import run as bench_run

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
    (folder / "configs").mkdir()
    (folder / "configs" / "tiny.json").write_text(json.dumps(TINY))
    (folder / "configs" / "tiny-host.json").write_text(
        json.dumps({**TINY, "name": "tiny-host", "configs": ["CPU"]}))
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
                     "reduced": [], "why": "test"}],
        "workloads": [
            {"name": "tiny.flood", "config": "tiny", "traffic": "flood",
             "chips": 1, "why": "test"},
            {"name": "tiny.trickle", "config": "tiny", "traffic": "trickle",
             "chips": 1, "why": "test"},
            {"name": "tiny-host.flood", "config": "tiny-host",
             "traffic": "flood", "chips": 1, "why": "test"}],
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

    control_of = {}                  # packed image words -> control scores
    build, original = harness.build_program, SegmentPipeline.run_pipelined

    def recording(config, fp, x01, device, store):
        program = build(config, fp, x01, device, store)
        layers = ref.parse(config["notation"], config["input_hw"],
                           config["in_channels"], config["n_classes"])
        low = ref.forward(layers, fp, x01, eps=config["bn_eps"],
                          control=True).numpy()
        control_of.update(
            (w.tobytes(), s) for w, s in zip(program.words, low))
        return program

    def control(self, inputs, *, on_complete=None, observer=None):
        def complete(i, out):
            out = np.array(out)
            for j, w in enumerate(np.asarray(inputs[i])):
                if w.tobytes() in control_of:       # pad rows stay
                    out[j] = control_of[w.tobytes()]
            on_complete(i, out)
        return original(self, inputs, on_complete=complete,
                        observer=observer)

    monkeypatch.setattr(harness, "build_program", recording)
    monkeypatch.setattr(SegmentPipeline, "run_pipelined", control)
    line = _run(root, "tiny.flood", monkeypatch, capsys)
    assert control_of and line["correct"] is False
    assert line["checks"]["wrong_answers"]["value"] > 0
    assert line["checks"]["missing_answers"]["value"] == 0


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
