"""benchmark/trace.py: the arithmetic of a traced slice, on synthetic
Chrome-trace events (times in us)."""

import pytest

from benchmark import trace


def _span(ts, dur):
    return dict(name=trace.SPAN, ph="X", cat="user_annotation", ts=ts,
                dur=dur)


def _kernel(ts, dur, name="k"):
    return dict(name=name, ph="X", cat="kernel", ts=ts, dur=dur)


def _host(ts, dur, name):
    return dict(name=name, ph="X", cat="cuda_runtime", ts=ts, dur=dur)


def test_overlapping_kernels_count_once():
    events = [_span(0, 100), _kernel(10, 50), _kernel(20, 50),
              _kernel(30, 10), dict(_kernel(40, 30), cat="gpu_memcpy")]
    s = trace.summarize(events)
    assert s["busy_s"] == pytest.approx(60e-6)      # [10, 70]
    assert s["busy_s"] <= s["window_s"]
    assert s["device_events"] == 4


def test_a_gap_before_the_first_kernel_is_idle():
    s = trace.summarize([_span(0, 100), _kernel(40, 60)])
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(60e-6)
    assert 1 - s["busy_s"] / s["window_s"] == pytest.approx(0.4)


def test_events_outside_the_window_do_not_count():
    # a record of a kernel that ran before the trace's window began
    s = trace.summarize([_kernel(-50, 20), _span(0, 100), _kernel(0, 10),
                         _kernel(99, 20)])
    assert s["device_events"] == 2
    assert s["busy_s"] == pytest.approx(11e-6)       # clipped at the end


def test_busy_never_exceeds_the_window():
    events = [_span(0, 100)] + [_kernel(t, 30) for t in range(0, 100, 5)]
    s = trace.summarize(events)
    assert s["busy_s"] == pytest.approx(s["window_s"])


def test_idle_gaps_by_what_the_host_did_and_k1_by_name():
    events = [_span(0, 100), _host(0, 30, "cudaGraphLaunch"),
              _kernel(30, 20, "void stage_kernel<float>"),
              _host(50, 40, "cudaEventSynchronize"),
              _kernel(90, 10, "elementwise")]
    s = trace.summarize(events)
    assert dict(s["idle_gaps"]) == pytest.approx(
        {"cudaGraphLaunch": 30e-6, "cudaEventSynchronize": 40e-6})
    assert s["k1_s"] == pytest.approx(20e-6)
    assert s["device_ops"][0] == ["void stage_kernel<float>",
                                  pytest.approx(20e-6)]


def test_a_trace_without_the_span_is_refused():
    with pytest.raises(ValueError):
        trace.summarize([_kernel(0, 10)])


def test_idle_is_taken_against_the_untraced_slice():
    from benchmark import run as bench

    reader = bench.load_module(bench.HERE / "metrics" / "device.idle_pct.py")
    s = trace.summarize([_span(0, 100), _kernel(40, 60)])
    # traced, the card idled 40 of 100 us; untraced the slice took 75 us
    run = dict(slice=dict(summary=s, untraced_s=75e-6))
    assert reader.read(run) == pytest.approx(20.0)
    assert reader.read(dict(slice=None)) is None


def test_the_dual_kernels_time_by_name():
    events = [_span(0, 100), _kernel(0, 20, "void stage_kernel<double>"),
              _kernel(20, 7, "dual_update_kernel(Args)"),
              _kernel(30, 7, "dual_update_kernel(Args)"),
              _kernel(40, 5, "elementwise")]
    s = trace.summarize(events)
    assert s["dual_s"] == pytest.approx(14e-6)
    assert s["k1_s"] == pytest.approx(20e-6)
    assert trace.summarize([_span(0, 10), _kernel(0, 5)])["dual_s"] == 0.0


def test_the_dual_roofline_reads_the_kernels_time_an_iteration():
    from benchmark import run as bench

    reader = bench.load_module(bench.HERE / "metrics"
                               / "dual.roofline_pct.py")
    s = trace.summarize([_span(0, 100),
                         _kernel(0, 8, "dual_update_kernel(Args)"),
                         _kernel(50, 8, "dual_update_kernel(Args)")])
    # two iterations of 8 us each against a least time of 2 us
    run = dict(slice=dict(summary=s, iterations=2), work=dict(
        dual_update=2e-6))
    assert reader.read(run) == pytest.approx(25.0)
    none = trace.summarize([_span(0, 100), _kernel(0, 8)])
    assert reader.read(dict(run, slice=dict(summary=none,
                                            iterations=2))) is None
    assert reader.read(dict(run, slice=None)) is None
