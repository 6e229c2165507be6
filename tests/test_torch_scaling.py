"""The port's batch and partition-scaling runners
(``raocp_tpu_torch.scripts.bench_batch`` and ``bench_scaling``) on the CPU
in float64: every lane of ``bench_batch --small`` takes its sequential
solve's count and the JAX package's (``jax_reference.json``); the scaling
harness at one and two gloo ranks on a tiny tree, both partitions, makes
the collectives its plan says and ends where the single device ends."""

import contextlib
import io
import json

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from raocp_tpu_torch.scripts import bench_batch, bench_configs  # noqa: E402
from raocp_tpu_torch.scripts import bench_scaling  # noqa: E402

BATCH_FIELDS = ("metric", "nodes", "batch", "sequential_s", "batched_s",
                "value", "unit", "iters", "sequential_iters", "statuses",
                "count_diff", "dtype", "device", "card", "k1_path",
                "k1_launches", "prox_f_calls", "max_memory_allocated_mb",
                "jax_iterations")


def test_bench_batch_small_lanes_take_their_counts():
    """``bench_batch --small`` with three lanes (float64 on the CPU): each
    lane's count is its sequential solve's and the JAX package's for the
    same lane (the first three of the reference's eight: the lanes' scales
    are one draw sequence), every lane converged, the row's fields
    there."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        bench_batch.main(["--small", "--batch", "3", "--device", "cpu"])
    (row,) = map(json.loads, out.getvalue().splitlines())
    for key in BATCH_FIELDS:
        assert key in row, key
    ref = bench_configs.reference_row(
        *bench_batch.batch_key(True, 8, 4000))
    assert row["iters"] == row["sequential_iters"] \
        == ref["lane_iterations"][:3]
    assert row["count_diff"] == [0, 0, 0] and row["statuses"] == [0, 0, 0]
    assert (row["nodes"], row["batch"], row["dtype"]) == \
        (15, 3, "torch.float64")
    # the 15-node tree's chain stages are not K1's: the plain path
    assert not row["k1_path"] and row["k1_launches"] == 0
    assert row["prox_f_calls"] == max(row["iters"])


def test_batch_lanes_are_one_draw_sequence():
    """A batch's first lanes do not depend on its size, so a smaller batch
    repeats the reference's first lanes."""
    lanes8 = bench_batch.batch_lanes([1.0, -2.0], 8)
    assert (bench_batch.batch_lanes([1.0, -2.0], 3) == lanes8[:3]).all()


@pytest.fixture(scope="module")
def scaling_rows():
    """The harness at one and two gloo ranks, both partitions, on a tiny
    tree (121 nodes, 6 states) in float64, 50 CP steps a row."""
    return list(bench_scaling.run_scaling(
        ranks=(1, 2), partitions=("subtree", "flat"), num_stages=4,
        num_states=6, iters=50, dtype="float64", device="cpu"))


def test_scaling_rows_follow_the_plan(scaling_rows):
    """One partition-free row, then one a partition at two ranks; each
    makes the all-reduces and exchanges its plan gives (the harness raises
    otherwise) and ends within 1e-9 of the single device's result."""
    assert [(r["partition"], r["ranks"]) for r in scaling_rows] == \
        [("none", 1), ("subtree", 2), ("flat", 2)]
    none, subtree, flat = scaling_rows
    assert none["speedup"] == 1.0 and none["all_reduces"] == 0
    for row in scaling_rows:
        assert row["iters"] == 50 and row["num_nodes"] == 121
        assert (row["all_reduces"], row["exchanges"]) == \
            (row["planned"]["all_reduces"], row["planned"]["exchanges"])
        assert row["max_rel_diff_vs_single"] <= bench_scaling.F64_REL
        assert len(row["ms_per_step"]) == row["ranks"]
    # subtree: 4 frontier all-reduces a step, 2 more a check (2 checks)
    assert subtree["all_reduces"] == 1 + 50 * 4 + 2 * 2
    assert subtree["exchanges"] == 0
    # flat, 5 tree stages: 2 x 4 + 3 exchanges a step, 2 more a check
    assert flat["exchanges"] == 3 + 50 * 11 + 2 * 2
    assert flat["all_reduces"] == 2
    assert all(b > 0 for b in flat["exchange_bytes_per_step"])


def test_planned_collectives_scale_with_the_tree():
    """The plan at the harness's default tree (9 stages) and stride."""
    assert bench_scaling.planned_collectives("flat", 9, 500) == dict(
        all_reduces=20, exchanges=3 + 500 * 19 + 40)
    assert bench_scaling.planned_collectives("subtree", 9, 500) == dict(
        all_reduces=1 + 500 * 4 + 40, exchanges=0)
    assert bench_scaling.planned_collectives("none", 9, 500) == dict(
        all_reduces=0, exchanges=0)
