"""The reader of ``relax.launches_per_step`` on runs made by hand: its
arithmetic, nothing without the package's count, nothing at 0 steps."""

import pytest

from benchmark import run as bench
from benchmark.tests.conftest import ROOT


def _read(loop):
    run = dict(window=dict(counts=dict(loop=loop, accel={})))
    return bench.load_module(ROOT / "benchmark" / "metrics"
                             / "relax.launches_per_step.py").read(run)


@pytest.mark.parametrize("launches,steps,want", [
    (250, 250, 1.0), (0, 250, 0.0), (100, 250, 0.4), (3, 2, 1.5)])
def test_the_reader_divides_launches_by_steps(launches, steps, want):
    assert _read(dict(relax_launches=launches, dual_launches=steps,
                      steps=steps, periods=steps // 25)) \
        == pytest.approx(want)


def test_nothing_from_a_package_without_the_count():
    assert _read(dict(periods=3, steps=75, replays=2,
                      dual_launches=75)) is None


def test_nothing_at_zero_steps():
    assert _read(dict(relax_launches=0, steps=0, periods=0)) is None
