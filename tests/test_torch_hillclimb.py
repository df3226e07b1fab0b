"""The port's scheme hillclimb (``repro_torch.launch.hillclimb``) against
the JAX package's (``repro.launch.hillclimb``): the same cells and
variant ladders, hypotheses word for word; ``evaluate`` returns the
reference's keys (a smoke config's dry run on the 16 x 16 fake mesh,
``configs.get`` swapped for ``get_smoke``); ``run_cell`` prints and
writes one result per variant; ``run_bnn`` writes the reference's JSON
keys and keeps DP <= hillclimb <= start on the port's analytic
autotune.  The BNN mapping hillclimb itself is held to the reference in
``tests/test_torch_adapt.py``."""

from __future__ import annotations

import json
import os

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch import configs as T_C  # noqa: E402
from repro_torch.launch import hillclimb as HC  # noqa: E402

EVALUATE_KEYS = {"compute_s", "memory_s", "collective_s", "peak_gib",
                 "coll_gib", "coll_by_kind_gib"}
BNN_KEYS = {"model", "space", "trajectory_us", "hillclimb_us",
            "hillclimb_mapping", "dp_us", "dp_mapping"}


def _ref_hillclimb():
    """The JAX package's module; it sets ``XLA_FLAGS`` when imported,
    which must not leak into later tests of this process."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import hillclimb as ref
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return ref


@pytest.fixture
def smoke_configs(monkeypatch):
    monkeypatch.setattr(T_C, "get", T_C.get_smoke)


def test_cells_equal_reference():
    ref = _ref_hillclimb()
    assert HC.CELLS == ref.CELLS
    assert len(HC.CELLS) == 5
    assert sum(len(c["variants"]) for c in HC.CELLS.values()) == 27


@pytest.mark.parametrize("key", sorted(HC.CELLS))
def test_every_variant_names_scheme_fields(key):
    """Each variant's overrides are ShardScheme fields of the port."""
    import dataclasses

    from repro_torch.parallel.sharding import ShardScheme

    fields = {f.name for f in dataclasses.fields(ShardScheme)}
    for name, overrides, hyp in HC.CELLS[key]["variants"]:
        assert set(overrides) <= fields, (name, overrides)
        assert hyp


@pytest.mark.parametrize("arch,shape,overrides", [
    ("qwen2_0_5b", "train_4k", {}),
    ("deepseek_moe_16b", "decode_32k", {"expert_mode": "tp"}),
    ("grok_1_314b", "decode_32k", {"decode_replicate_batch": True}),
])
def test_evaluate_returns_reference_keys(smoke_configs, arch, shape,
                                         overrides):
    r = HC.evaluate(arch, shape, overrides, device="cpu")
    assert set(r) == EVALUATE_KEYS
    assert r["compute_s"] > 0 and r["memory_s"] > 0 and r["peak_gib"] > 0
    assert r["coll_gib"] == pytest.approx(sum(r["coll_by_kind_gib"].values()))
    assert r["collective_s"] == pytest.approx(
        r["coll_gib"] * 2**30 / 450e9)


def test_run_cell_writes_one_result_per_variant(smoke_configs, tmp_path,
                                                capsys):
    results = HC.run_cell("grok-decode", tmp_path, device="cpu")
    names = [v[0] for v in HC.CELLS["grok-decode"]["variants"]]
    assert [r["variant"] for r in results] == names
    out = capsys.readouterr().out
    for name in names:
        r = json.loads((tmp_path / f"grok-decode__{name}.json").read_text())
        assert "error" not in r, r
        assert EVALUATE_KEYS <= set(r)
        assert f"  {name:22s} step~" in out
    # a second run reads the written results back
    again = HC.run_cell("grok-decode", tmp_path, device="cpu")
    assert again == json.loads(json.dumps(results))


def test_run_bnn_writes_reference_keys_and_is_sandwiched(tmp_path):
    out = HC.run_bnn(tmp_path, device="cpu")
    written = json.loads((tmp_path / "bnn_mapping_hillclimb.json")
                         .read_text())
    assert written == out
    assert set(written) == BNN_KEYS
    assert written["model"] == "fashion_mnist"
    start = written["trajectory_us"][0]
    assert written["dp_us"] <= written["hillclimb_us"] * (1 + 1e-12)
    assert written["hillclimb_us"] <= start
    assert written["trajectory_us"] == sorted(written["trajectory_us"],
                                              reverse=True)


def test_main_bnn_flag(tmp_path):
    HC.main(["--bnn", "--device", "cpu", "--out", str(tmp_path)])
    assert set(json.loads((tmp_path / "bnn_mapping_hillclimb.json")
                          .read_text())) == BNN_KEYS
