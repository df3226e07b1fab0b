"""The traffic schedules, and the readers' populations: percentiles over
every request, rates over the whole window."""

import json
from pathlib import Path

import numpy as np
import pytest

from hepbench import traffic
from hepbench.harness import Run
from hepbench.spec import Bench

REPO = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("mix", [{"kind": "closed", "outstanding": 128},
                                 {"kind": "poisson", "rate_per_s": 5000}])
def test_schedule_reproducible_from_seed(mix):
    a = traffic.schedule(mix, 2**31 + 7, 3.0, 4096)
    b = traffic.schedule(mix, 2**31 + 7, 3.0, 4096)
    c = traffic.schedule(mix, 2**31 + 8, 3.0, 4096)
    assert np.array_equal(a.order, b.order)
    assert not np.array_equal(a.order, c.order)
    assert sorted(a.order) == list(range(4096))
    if mix["kind"] == "poisson":
        assert np.array_equal(a.due_s, b.due_s)
        # every seed offers the same count, in [0, seconds), sorted
        assert len(a.due_s) == len(c.due_s) == 15000
        assert np.all(np.diff(a.due_s) >= 0)
        assert 0 <= a.due_s[0] and a.due_s[-1] < 3.0
        # ... and the same set of gaps, in an order the seed permutes
        ga, gc = np.diff(a.due_s, prepend=0.0), np.diff(c.due_s, prepend=0.0)
        assert np.allclose(np.sort(ga), np.sort(gc), rtol=0, atol=1e-12)
        assert not np.array_equal(a.due_s, c.due_s)
    else:
        assert a.outstanding == 128 and a.due_s is None


def test_schedule_cycles_the_whole_pool():
    s = traffic.schedule({"kind": "closed", "outstanding": 1}, 5, 1.0, 16)
    first = [s.image(i) for i in range(16)]
    assert sorted(first) == list(range(16))
    assert [s.image(i + 16) for i in range(16)] == first


def test_schedule_rejects_unknown_kind():
    with pytest.raises(ValueError):
        traffic.schedule({"kind": "bursty"}, 1, 1.0, 8)


def _run(due, done, ok, steps=((0.0, 0.5, 2),), submit=None):
    due = np.asarray(due, float)
    return Run(
        cell={"name": "x"}, config={}, mix={}, seconds=2.0, t0=0.0,
        t_end=2.0, setup_s=1.0, layers=[], served=None, allowed=(1, 4, 16),
        due=due, submit=due if submit is None else np.asarray(submit, float),
        done=np.asarray(done, float), image=np.zeros(len(due), np.int64),
        ok=np.asarray(ok, bool), steps=np.asarray(steps, float),
        slices=[])


def _read(name, run):
    return Bench(REPO).reader(name)(run)


def test_percentiles_are_over_every_request():
    rng = np.random.default_rng(0)
    due = np.sort(rng.uniform(0, 2.0, 1000))
    lat = rng.exponential(0.004, 1000)
    lat[::50] = 0.1                           # a tail of 2 %
    run = _run(due, due + lat, np.ones(1000, bool))
    assert _read("latency_p95_ms", run) == pytest.approx(
        np.percentile(lat * 1e3, 95))
    assert _read("latency_p50_ms.open", run) == pytest.approx(
        np.percentile(lat * 1e3, 50))
    # not the median of per-chunk percentiles
    chunks = np.median([np.percentile(c, 95) for c in
                        np.split(lat * 1e3, 10)])
    assert _read("latency_p95_ms", run) != pytest.approx(chunks)


def test_rate_is_over_the_whole_window():
    # 4 answers in [0, 2); one answered after the window, one wrong, one
    # never answered
    due = [0.1, 0.2, 0.3, 0.4, 1.9, 1.0, 1.1]
    done = [0.5, 0.6, 1.5, 1.9, 2.3, 1.2, np.nan]
    ok = [1, 1, 1, 1, 1, 0, 0]
    run = _run(due, done, ok)
    assert _read("served_img_s", run) == pytest.approx(4 / 2.0)
    # latency counts the late answer and the wrong one, not the missing
    lat = (np.array(done[:6]) - np.array(due[:6])) * 1e3
    assert _read("latency_p50_ms.open", run) == pytest.approx(np.median(lat))


def test_queue_wait_runs_from_due_to_the_answering_step():
    due = [0.0, 0.1, 0.2]
    done = [0.45, 0.45, 0.95]
    steps = [(0.3, 0.45, 2), (0.8, 0.95, 1)]
    run = _run(due, done, [1, 1, 1], steps=steps)
    assert _read("queue_wait_p50_ms.open", run) == pytest.approx(300.0)
    assert _read("answers_per_step.flood", run) == pytest.approx(1.5)
    assert _read("step_us_per_img.flood", run) == pytest.approx(1e5)
    assert _read("step_ms.open", run) == pytest.approx(150.0)


def test_sender_lateness_is_submit_minus_due():
    due = np.arange(100) * 0.01
    run = _run(due, due + 0.002, np.ones(100, bool),
               submit=due + np.linspace(0, 0.001, 100))
    assert _read("sender_late_p95_ms.open", run) == pytest.approx(
        np.percentile(np.linspace(0, 1.0, 100), 95))


def test_every_metric_has_a_reader_and_every_cell_reports_enough():
    bench = Bench(REPO)
    doc = json.loads((REPO / "BENCHMARK.json").read_text())
    for m in doc["end_to_end"] + doc["per_layer"]:
        assert callable(bench.reader(m["name"]))
    for cell in doc["workloads"]:
        e2e = {m["name"] for m in bench.metrics(cell["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert bench.metrics(cell["name"], "per_layer")
        bench.config(cell["config"])
        bench.traffic(cell["traffic"])


NAME = r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}"


def test_benchmark_json_keeps_to_its_contract():
    import re

    doc = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(doc) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert "hepbench" in doc["paths"]
    assert 1 <= doc["run_seconds"] <= 51
    names = [c["name"] for c in doc["configs"]]
    for c in doc["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("hepbench/")
        json.loads((REPO / c["file"]).read_text())
    cells = [w["name"] for w in doc["workloads"]]
    for w in doc["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
    e2e = {m["name"]: m for m in doc["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in doc["end_to_end"] + doc["per_layer"]:
        assert re.fullmatch(NAME, m["name"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in doc["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in doc["per_layer"]:
        for cell in m["workloads"]:
            moved = e2e[m["moves"]]
            assert cell in moved.get("workloads", cells)
    for name in names + cells:
        assert re.fullmatch(NAME, name)
