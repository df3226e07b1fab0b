"""``repro_torch.launch.mesh.spawn_world`` itself, with no model: a
world of spawned ``gloo`` processes on the CPU whose rendezvous is a
``FileStore`` in a temporary directory.  Results come back in rank
order; a rank that raises fails the parent with its traceback within
the timeout; a rank that hangs is killed at the timeout; either way no
process of the world is left running.  The all-gather gloo ranks on
CUDA run (``all_gather_through_all_to_all``, an ``all_to_all_single``)
is held here to gloo's own on the CPU, registered for the CPU key.  The
rank bodies are in ``tests/_torch_spmd.py`` (a spawned child imports
them by name)."""

from __future__ import annotations

import multiprocessing
import time

import pytest

torch = pytest.importorskip("torch")

import _torch_spmd as H  # noqa: E402
from repro_torch.launch.mesh import spawn_world  # noqa: E402

TIMEOUT_S = 120.0


def _children() -> set:
    return {p.pid for p in multiprocessing.active_children()}


def test_results_come_back_in_rank_order():
    got = spawn_world(4, H.ok, "x", timeout=TIMEOUT_S)
    assert [r["rank"] for r in got] == [0, 1, 2, 3]
    assert all(r["world"] == 4 and r["value"] == "x" for r in got)
    # the all-reduce moved data between the ranks: 0 + 1 + 2 + 3
    assert all(r["sum"] == 6.0 for r in got)
    assert not _children()


def test_a_rank_that_raises_fails_the_parent_with_its_traceback():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as info:
        spawn_world(3, H.fail_on, 1, timeout=TIMEOUT_S)
    assert time.monotonic() - t0 < TIMEOUT_S
    msg = str(info.value)
    assert "rank 1 raised" in msg
    assert "ValueError: rank 1 fails on purpose" in msg
    assert "fail_on" in msg                       # the rank's traceback
    # ranks 0 and 2 were blocked in the barrier: terminated
    assert not _children()


def test_a_rank_that_hangs_is_killed_at_the_timeout():
    # the timeout covers the ranks' start (importing torch), which a
    # loaded host stretches: rank 0 may or may not have answered by then
    t0 = time.monotonic()
    with pytest.raises(TimeoutError,
                       match="of 2 ranks gave no result within 30 s"):
        spawn_world(2, H.hang_on, 1, timeout=30.0)
    assert 30.0 <= time.monotonic() - t0 < 90.0
    assert not _children()


def test_all_gather_through_all_to_all_equals_the_native_all_gather():
    got = spawn_world(2, H.all_gather_shim, timeout=TIMEOUT_S)
    for r in got:
        assert r["before"] == [] and r["after"] == []
        assert r["during"] == ["CPU"]
        assert len(r["routed"]) == len(r["native"]) == 2
        for routed, native in zip(r["routed"], r["native"]):
            routed, native = torch.from_numpy(routed), torch.from_numpy(native)
            assert routed.dtype == native.dtype
            assert torch.equal(routed, native)
    # each rank holds every rank's input, in rank order
    x0 = torch.arange(12.0).reshape(3, 2, 2)
    assert torch.equal(torch.from_numpy(got[0]["routed"][0]),
                       torch.cat([x0, x0 + 100]))
    assert torch.equal(torch.from_numpy(got[1]["routed"][1]),
                       torch.arange(5).reshape(1, 5) * torch.tensor(
                           [[1], [2]]))
    assert not _children()


def test_spawn_world_routes_nothing_for_gloo_on_the_cpu():
    """Only a gloo world on CUDA installs the all-gather's routing."""
    assert spawn_world(2, H.routed_keys, backend="gloo", device_type="cpu",
                       timeout=TIMEOUT_S) == [[], []]
