"""One pass under torch.profiler, reduced to what the per-layer metrics
and the breakdown read: device busy time over the traced window, kernel
launches, device time by operation, idle gaps by what the host was
doing, and the device time of the mapping k-NN's launches.

A k-NN call's kernels are found by correlation, not by name: the launch
calls (cudaLaunch* or cuLaunch*) made inside a `perfbench.map_knn` range
carry correlation ids, and the device events with those ids are that
call's work, whichever kernel a later version launches.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses

import torch

from . import cost

LAUNCH_PREFIXES = ("cudaLaunch", "cuLaunch")
COPY_PREFIXES = ("Memcpy", "Memset")
NAME_CHARS = 80


@dataclasses.dataclass
class Summary:
    """What the metric readers read: the run's synchronised layer spans
    over the window (name -> [seconds, calls]), the solving mapping
    calls, frames finished in the window, and of the one profiled pass:
    its frames, window and busy seconds, kernel launches, the k-NN's
    least and measured device seconds, the breakdown."""
    spans: dict
    solving: list
    window_frames: int
    traced_frames: int = 0
    window_s: float = 0.0
    busy_s: float = 0.0
    kernel_launches: int = 0
    knn_least_s: float | None = None
    knn_device_s: float = 0.0
    knn_calls: int = 0
    knn_matched: int = 0
    device_ops: list = dataclasses.field(default_factory=list)
    idle_gaps: list = dataclasses.field(default_factory=list)


def _is_device(e) -> bool:
    return e.device_type() != torch.autograd.DeviceType.CPU


class _Intervals:
    """Host ranges of one thread, for the innermost one holding a time."""

    def __init__(self, items):
        items.sort()
        self.starts = [s for s, _, _ in items]
        self.items = items

    def innermost(self, t: int, reach: int = 64):
        i = bisect.bisect_right(self.starts, t) - 1
        for j in range(i, max(-1, i - reach), -1):
            s, e, name = self.items[j]
            if e >= t:
                return name
        return None

    def within(self, name: str):
        return [(s, e) for s, e, n in self.items if n == name]


def profile(fn):
    """Run fn under torch.profiler (CPU and CUDA activity) and return the
    raw events; fn ends in a device synchronise inside its range."""
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
    return prof.profiler.kineto_results.events()


def summarize(events, summary: Summary, knn_calls, card: str) -> Summary:
    """Fill summary's profiled fields from the events of one pass run
    inside a `perfbench.pass` range."""
    ranges = collections.defaultdict(list)   # thread -> perfbench ranges
    ops = collections.defaultdict(list)      # thread -> aten ops
    launches = []                            # (start, thread, corr)
    device = []                              # (start, end, name, corrs)
    for e in events:
        name = e.name()
        start, dur = e.start_ns(), e.duration_ns()
        if _is_device(e):
            if name.startswith("perfbench."):
                continue    # the ranges' mirror on the device timeline
            device.append((start, start + dur, name,
                           (e.correlation_id(), e.linked_correlation_id())))
        elif name.startswith("perfbench."):
            ranges[e.start_thread_id()].append(
                (start, start + dur, name[len("perfbench."):]))
        elif name.startswith("aten::"):
            ops[e.start_thread_id()].append((start, start + dur, name))
        elif name.startswith(LAUNCH_PREFIXES):
            launches.append((start, e.start_thread_id(), e.correlation_id()))

    main = next(t for t, items in ranges.items()
                if any(n == "pass" for _, _, n in items))
    spans = _Intervals(ranges[main])
    host_ops = _Intervals(ops.get(main, []))
    w0, w1 = spans.within("pass")[0]
    summary.window_s = (w1 - w0) * 1e-9

    device = [d for d in device if d[1] > w0 and d[0] < w1]
    device.sort()
    summary.kernel_launches = sum(
        1 for d in device if not d[2].startswith(COPY_PREFIXES))
    by_name = collections.Counter()
    for s, e, name, _ in device:
        by_name[name[:NAME_CHARS]] += (e - s) * 1e-9
    summary.device_ops = [[n, t] for n, t in by_name.most_common(10)]

    busy, gaps = 0, collections.Counter()
    cursor = w0
    for s, e, _, _ in device:
        s, e = max(s, w0), min(e, w1)
        if s > cursor:
            gaps[_label(spans, host_ops, cursor)] += (s - cursor) * 1e-9
        if e > cursor:
            busy += e - max(s, cursor)
            cursor = e
    if w1 > cursor:
        gaps[_label(spans, host_ops, cursor)] += (w1 - cursor) * 1e-9
    summary.busy_s = busy * 1e-9
    summary.idle_gaps = [[n, t] for n, t in gaps.most_common(10)]

    _knn(summary, spans, launches, device, main, knn_calls, card)
    return summary


def _label(spans: _Intervals, host_ops: _Intervals, t: int) -> str:
    span = spans.innermost(t) or "outside_spans"
    op = host_ops.innermost(t) or "between_aten_ops"
    return f"{span} / {op}"


def _knn(summary, spans, launches, device, main, knn_calls, card):
    """The mapping k-NN's device seconds (its calls' kernels, by
    correlation) and least seconds (cost.py, from each call's inputs)."""
    windows = spans.within("map_knn")
    summary.knn_calls = len(knn_calls)
    if not knn_calls or len(windows) != len(knn_calls):
        return
    starts = [s for s, _ in windows]
    corrs = set()
    for t, thread, corr in launches:
        i = bisect.bisect_right(starts, t) - 1
        if thread == main and i >= 0 and t <= windows[i][1]:
            corrs.add(corr)
    matched = [(s, e) for s, e, _, (c, linked) in device
               if c in corrs or (linked and linked in corrs)]
    summary.knn_matched = len(matched)
    summary.knn_device_s = sum(e - s for s, e in matched) * 1e-9
    least = 0.0
    for call in knn_calls:
        if call[0] == "windowed":
            _, n_q, n_ref, k, t_lo, t_hi, tq, tm = call
            ops, n_bytes = cost.windowed_knn(n_q, n_ref, k, t_lo, t_hi, tq,
                                             tm)
        else:
            _, valid, k = call
            ops, n_bytes = cost.candidate_select(valid, k)
        t = cost.least_seconds(ops, n_bytes, card)
        if t is None:
            return
        least += t
    summary.knn_least_s = least
