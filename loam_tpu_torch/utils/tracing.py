"""Tracing / profiling / observability (counterpart of
loam_tpu/utils/tracing.py).

The reference has no instrumentation at all — stage rates are observable
only through ROS topic rates, and the single printf is the odometry NaN
warning (SURVEY.md §5 "Tracing / profiling" / "Metrics / logging").
Here every stage can be timed host-side, counters accumulate
device-side in the state (nan_skips already does), and torch.profiler
can capture full device traces.

Usage:
    with tracing.stage("mapping") as h:
        state, out = mapping_step(...)
        h["out"] = out          # waited for before the clock stops
    print(tracing.report())

    with tracing.profiler_trace("/tmp/loam_trace"):  # chrome trace
        replay(...)
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch


@dataclass
class StageStats:
    count: int = 0
    total_s: float = 0.0
    min_s: float = float("inf")
    max_s: float = 0.0

    def add(self, dt: float) -> None:
        self.count += 1
        self.total_s += dt
        self.min_s = min(self.min_s, dt)
        self.max_s = max(self.max_s, dt)

    @property
    def mean_s(self) -> float:
        return self.total_s / max(self.count, 1)


def _cuda_devices(obj, found: set) -> set:
    """The CUDA devices of the tensors in obj (nested dataclasses,
    tuples, lists and dicts of tensors)."""
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            found.add(obj.device)
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            _cuda_devices(getattr(obj, f.name), found)
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            _cuda_devices(x, found)
    elif isinstance(obj, dict):
        for x in obj.values():
            _cuda_devices(x, found)
    return found


def _wait_for(out) -> None:
    """Block until the device work behind out's CUDA tensors is done;
    nothing to wait for on the CPU."""
    for device in _cuda_devices(out, set()):
        torch.cuda.synchronize(device)


@dataclass
class Tracer:
    """Per-stage wall-clock stats.  `sync=True` waits for the device
    results so timings reflect device work, not dispatch."""

    sync: bool = True
    stats: dict = field(default_factory=lambda: defaultdict(StageStats))

    @contextlib.contextmanager
    def stage(self, name: str, result=None):
        t0 = time.perf_counter()
        holder = {}
        try:
            yield holder
        finally:
            out = holder.get("out", result)
            if self.sync and out is not None:
                _wait_for(out)
            self.stats[name].add(time.perf_counter() - t0)

    def report(self) -> str:
        lines = [f"{'stage':24s} {'n':>6s} {'mean ms':>9s} "
                 f"{'min ms':>9s} {'max ms':>9s} {'total s':>9s}"]
        for name, s in sorted(self.stats.items()):
            lines.append(
                f"{name:24s} {s.count:6d} {s.mean_s*1e3:9.2f} "
                f"{s.min_s*1e3:9.2f} {s.max_s*1e3:9.2f} {s.total_s:9.2f}"
            )
        return "\n".join(lines)

    def as_dict(self) -> dict:
        return {
            k: {"count": v.count, "mean_ms": v.mean_s * 1e3,
                "total_s": v.total_s}
            for k, v in self.stats.items()
        }

    def reset(self) -> None:
        self.stats.clear()


_GLOBAL = Tracer()


def stage(name: str, result=None):
    return _GLOBAL.stage(name, result)


def report() -> str:
    return _GLOBAL.report()


def reset() -> None:
    _GLOBAL.reset()


@contextlib.contextmanager
def profiler_trace(logdir: str):
    """Capture a torch.profiler trace of the host and, where there is
    one, the CUDA device, written to logdir/trace.json (chrome://tracing,
    Perfetto); the counterpart of loam_tpu.utils.tracing.xla_trace."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named region inside a trace (shows up on the profiler timeline)."""
    with torch.profiler.record_function(name):
        yield
