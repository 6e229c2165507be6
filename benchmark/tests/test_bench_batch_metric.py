"""The reader of ``batch.stopped_lane_share`` on runs made by hand: its
arithmetic, nothing outside a batch cell, nothing at 0 steps."""

import pytest

from benchmark import run as bench
from benchmark.tests.conftest import ROOT


def _read(loop, iters, lanes=8):
    window = dict(counts=dict(loop=loop, accel={}),
                  records=[dict(num_iters=k) for k in iters])
    if lanes is not None:
        window["lanes"] = lanes
    return bench.load_module(ROOT / "benchmark" / "metrics"
                             / "batch.stopped_lane_share.py").read(
        dict(window=window))


def test_lanes_that_stop_together_waste_nothing():
    assert _read(dict(steps=1025, wasted_steps=25), [1000] * 8) == 0.0


def test_the_share_of_the_stopped_lanes_steps():
    # two batches: 8 lanes to 1,000 and 8 lanes of which one runs 2,000
    # steps and seven 500; the second batch's loop ran 2,000 steps
    iters = [1000] * 8 + [2000] + [500] * 7
    ran = 8 * 3000
    want = 100.0 * (1.0 - sum(iters) / ran)
    assert _read(dict(steps=3050, wasted_steps=50), iters) == \
        pytest.approx(want)
    assert 0.0 < want < 100.0


def test_nothing_outside_a_batch_cell():
    assert _read(dict(steps=100, wasted_steps=0), [100], lanes=None) is None


def test_nothing_at_zero_steps():
    assert _read(dict(steps=25, wasted_steps=25), []) is None
