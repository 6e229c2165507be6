"""A bounded slice of the window under ``torch.profiler``, and the
arithmetic that turns its device events into busy time, launches, kernel
time by name and idle gaps.

Device events are the trace's kernels, copies and sets. Busy time is the
length of the union of their intervals inside the slice's own window (the
host span around the traced call), so kernels that overlap count once and
a gap before the first kernel or after the last is idle. The card's tracer
can hand records of kernels that ran before the trace began; only events
that start inside the window count.
"""

import heapq
import json
import os
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "python_function")
SPAN = "benchmark.slice"
# the card idles this long at both ends of the traced window
PAD_S = 0.05
TOP = 10
# traces taken of one call, at most, until one holds a device event
ATTEMPTS = 3


def is_k1(name: str) -> bool:
    """A kernel of K1, the dynamics projection's sweep (its stage and apex
    launches)."""
    return "stage_kernel" in name or "apex_kernel" in name


def is_dual(name: str) -> bool:
    """The dual-update kernel (``csrc/dual.cu``): the prox of g* and the
    dual step in one launch."""
    return "dual_update_kernel" in name


def profile_call(fn):
    """``fn()`` under ``torch.profiler`` (host and device), inside the span
    :data:`SPAN`; returns (fn's result, the trace's :func:`summarize`). A
    trace with no device event in the span lost its device records and is
    taken again, up to :data:`ATTEMPTS` times."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    for _ in range(ATTEMPTS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(PAD_S)
            with record_function(SPAN):
                out = fn()
                torch.cuda.synchronize()
            time.sleep(PAD_S)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh)["traceEvents"]
        finally:
            os.unlink(path)
        summary = summarize(events)
        if summary["device_events"]:
            break
    return out, summary


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def summarize(events: list, span: str = SPAN) -> dict:
    """Of the events of one trace (Chrome trace dicts, times in us): the
    window (the span ``span``), in seconds, the busy time of the device in
    it, its device events, K1's time, the dual-update kernel's time, the
    device time by name (top :data:`TOP`) and the idle time by what the
    host was doing (top :data:`TOP`: for each gap between busy intervals,
    the innermost host event at its middle)."""
    spans = [ev for ev in events if ev.get("name") == span
             and ev.get("ph") == "X"]
    if not spans:
        raise ValueError(f"the trace holds no span '{span}'")
    t0 = min(ev["ts"] for ev in spans)
    t1 = max(ev["ts"] + ev["dur"] for ev in spans)
    device = [ev for ev in events if ev.get("cat") in DEVICE_CATS
              and ev.get("ph") == "X" and t0 <= ev["ts"] <= t1]
    busy = _union((ev["ts"], min(ev["ts"] + ev.get("dur", 0), t1))
                  for ev in device)
    busy_us = sum(b - a for a, b in busy)
    by_name = {}
    for ev in device:
        by_name[ev["name"]] = by_name.get(ev["name"], 0.0) + ev.get("dur", 0)
    k1_us = sum(t for name, t in by_name.items() if is_k1(name))
    dual_us = sum(t for name, t in by_name.items() if is_dual(name))
    host = sorted((ev["ts"], ev["ts"] + ev.get("dur", 0), ev["name"])
                  for ev in events if ev.get("cat") in HOST_CATS
                  and ev.get("ph") == "X" and ev.get("name") != span)
    edges = [t0] + [x for ab in busy for x in ab] + [t1]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    idle = {}
    # the innermost (latest started) host event at each gap's middle: a
    # sweep in time with a heap of the events started so far
    heap, i = [], 0
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = 0.5 * (a + b)
        while i < len(host) and host[i][0] <= mid:
            heapq.heappush(heap, (-host[i][0], host[i][1], host[i][2]))
            i += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        label = heap[0][2] if heap else "host idle"
        idle[label] = idle.get(label, 0.0) + (b - a)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    worst = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return dict(window_s=1e-6 * (t1 - t0), busy_s=1e-6 * busy_us,
                device_events=len(device), k1_s=1e-6 * k1_us,
                dual_s=1e-6 * dual_us,
                device_ops=[[name[:160], 1e-6 * t] for name, t in top],
                idle_gaps=[[name[:160], 1e-6 * t] for name, t in worst])
