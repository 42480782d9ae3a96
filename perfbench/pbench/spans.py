"""Spans and captures around the port's layer entry points, installed at
run time by wrapping module attributes (no file of the port changes).

Always: the frontend's features of the sampled scenarios in the first
and the latest pass, for the check.
With tracing on: a synchronised host-clock span and a
torch.profiler.record_function around each layer call (frontend,
odometry, mapping), and, while a pass is profiled, the inputs of every
mapping k-NN call (the windowed exact k-NN and the k-of-C selection) in
a span of its own, for its roofline share.
"""

from __future__ import annotations

import contextlib
import functools
import time

import torch

CLASSES = ("sharp", "less_sharp", "flat", "less_flat")
LAYERS = ("frontend", "odometry", "mapping")


class Instrument:
    """Wraps, for one run, replay.batched_frontend, odometry.odometry_step,
    mapping.mapping_step, knn_topk.knn_topk_dyn and map_store.knn_select.
    Use as a context manager; leaving it puts the originals back."""

    def __init__(self, sample, traced: bool):
        self.sample = sample            # (S,) long, sampled scenarios
        self.traced = traced
        self.features = []              # the first and latest call's
        self.spans = {n: [0.0, 0] for n in LAYERS}
        self.solving = [0.0, 0]         # mapping calls after a pass's first
        self.knn_calls = None           # a list while a pass is profiled
        self._in_mapping = False
        self._map_calls = 0
        self._saved = []

    # -- installation -------------------------------------------------
    def __enter__(self):
        from loam_tpu_torch import map_store, mapping, odometry
        from loam_tpu_torch.ops.cuda import knn_topk
        from loam_tpu_torch.parallel import replay

        self._patch(replay, "batched_frontend", self._frontend)
        self._patch(odometry, "odometry_step", self._layer("odometry"))
        self._patch(mapping, "mapping_step", self._mapping)
        self._patch(knn_topk, "knn_topk_dyn", self._windowed_knn)
        self._patch(map_store, "knn_select", self._select)
        return self

    def __exit__(self, *exc):
        for module, name, orig in reversed(self._saved):
            # counters the port keeps on its functions (knn_topk_dyn's
            # .launches) went on counting on the wrapper
            orig.__dict__.update(getattr(module, name).__dict__)
            setattr(module, name, orig)
        self._saved.clear()

    def _patch(self, module, name, make):
        orig = getattr(module, name)
        self._saved.append((module, name, orig))
        wrapped = make(orig)
        functools.update_wrapper(wrapped, orig)
        wrapped.__dict__.pop("__wrapped__", None)
        setattr(module, name, wrapped)

    # -- spans ----------------------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str):
        """A synchronised host-clock span with its profiler range; with
        tracing off, nothing."""
        if not self.traced:
            yield
            return
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"perfbench.{name}"):
            yield
            torch.cuda.synchronize()
        total = self.spans.setdefault(name, [0.0, 0])
        total[0] += time.perf_counter() - t0
        total[1] += 1

    def _layer(self, name):
        def make(orig):
            def wrapped(*args, **kwargs):
                with self.span(name):
                    return orig(*args, **kwargs)
            return wrapped
        return make

    def _frontend(self, orig):
        def wrapped(*args, **kwargs):
            # the first pass's and the latest pass's: the one before is
            # let go first, so the peak does not grow with the passes
            del self.features[1:]
            with self.span("frontend"):
                feats = orig(*args, **kwargs)
            self._map_calls = 0
            idx = self.sample.to(feats.sharp.mask.device)
            self.features.append(
                {c: (getattr(feats, c).xyz.index_select(0, idx),
                     getattr(feats, c).mask.index_select(0, idx))
                 for c in CLASSES})
            return feats
        return wrapped

    def _mapping(self, orig):
        def wrapped(*args, **kwargs):
            self._in_mapping = True
            t0 = self.spans["mapping"][0]
            try:
                with self.span("mapping"):
                    out = orig(*args, **kwargs)
            finally:
                self._in_mapping = False
            # a pass's first mapping frame meets an empty map: no solve
            if self._map_calls > 0:
                self.solving[0] += self.spans["mapping"][0] - t0
                self.solving[1] += 1
            self._map_calls += 1
            return out
        return wrapped

    def _recording(self) -> bool:
        return self.knn_calls is not None and self._in_mapping

    def _windowed_knn(self, orig):
        def wrapped(q, ref, n_q, n_ref, k, t_lo, t_hi, *, tq, tm):
            if not self._recording():
                return orig(q, ref, n_q, n_ref, k, t_lo, t_hi, tq=tq, tm=tm)
            with torch.profiler.record_function("perfbench.map_knn"):
                out = orig(q, ref, n_q, n_ref, k, t_lo, t_hi, tq=tq, tm=tm)
            self.knn_calls.append(("windowed", n_q, n_ref, k, t_lo, t_hi,
                                   tq, tm))
            return out
        return wrapped

    def _select(self, orig):
        def wrapped(cand, valid, q, k):
            if not self._recording():
                return orig(cand, valid, q, k)
            with torch.profiler.record_function("perfbench.map_knn"):
                out = orig(cand, valid, q, k)
            self.knn_calls.append(("select", valid, k))
            return out
        return wrapped
