"""The readers of the package's loop and set-up timing (``loop.gap_pct``,
``loop.launch_ratio``, ``solve.outside_loop_pct``, ``setup.stacked_s``,
``setup.power_s``) on runs made by hand: their arithmetic, nothing where a
divisor is 0, and nothing from a package that lacks the keys."""

import pytest

from benchmark import run as bench
from benchmark.tests.conftest import ROOT

NAMES = ("loop.gap_pct", "loop.launch_ratio", "solve.outside_loop_pct",
         "setup.stacked_s", "setup.power_s")


def _read(name, run):
    return bench.load_module(ROOT / "benchmark" / "metrics"
                             / f"{name}.py").read(run)


def _run(loop, accel, setup=None):
    return dict(window=dict(counts=dict(loop=loop, accel=accel)),
                setup=dict(counts=dict(loop=setup or {}, accel={})))


def test_the_readers_add_both_loops():
    run = _run(dict(gap_device_seconds=1.0, period_device_seconds=7.0,
                    launch_seconds=2.0, drive_seconds=6.0,
                    solve_seconds=10.0),
               dict(gap_device_seconds=1.0, period_device_seconds=1.0,
                    launch_seconds=1.0, drive_seconds=2.0),
               dict(build_seconds=1.5, power_seconds=0.25))
    assert _read("loop.gap_pct", run) == pytest.approx(20.0)
    assert _read("loop.launch_ratio", run) == pytest.approx(3.0 / 8.0)
    assert _read("solve.outside_loop_pct", run) == pytest.approx(20.0)
    assert _read("setup.stacked_s", run) == 1.5
    assert _read("setup.power_s", run) == 0.25


def test_nothing_where_a_divisor_is_zero():
    zero = dict(gap_device_seconds=0.0, period_device_seconds=0.0,
                launch_seconds=0.0, drive_seconds=0.0, solve_seconds=0.0)
    run = _run(zero, dict(zero))
    for name in NAMES[:3]:
        assert _read(name, run) is None, name


@pytest.mark.parametrize("name", NAMES)
def test_nothing_from_a_package_without_the_keys(name):
    run = _run(dict(periods=3, steps=75), dict(periods=0),
               dict(captures=1, capture_seconds=0.5))
    assert _read(name, run) is None
