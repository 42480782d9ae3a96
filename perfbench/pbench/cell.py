"""One run of one cell: set-up, the measured window, the check.

Set-up makes the cell's sweeps on the device from the seed, loads the
port's kernels (nvcc builds them into loam_tpu_torch/_build/ on a
checkout's first run), runs one warm pass at the cell's own B and F,
collects garbage and freezes what is left.  The window is a closed loop
over the same B scenarios: loam_tpu_torch.parallel.replay.batched_replay
(the frontend over B*F sweeps, then pipeline.replay_batch in lockstep)
again as soon as the last pass returns, until `seconds` have passed;
frames_per_s is all the scenario-frames of its passes over all its
time, ending in a device synchronise.  With tracing on, every layer
call is a synchronised span, and one more pass after the window runs
under torch.profiler.
"""

from __future__ import annotations

import dataclasses
import gc
import random
import sys
import time

import torch

from . import check, gen, spans, trace

GIB = float(1 << 30)


def loam_config(config: dict):
    """The LoamConfig a configuration file states: its keys that are
    LoamConfig fields, the rest at the port's defaults."""
    from loam_tpu_torch.config import LoamConfig

    fields = {f.name for f in dataclasses.fields(LoamConfig)}
    return LoamConfig(**{k: v for k, v in config.items() if k in fields})


def sampled(seed: int, scenarios: int, count: int) -> list:
    """The scenarios the reference checks, drawn from the seed."""
    return sorted(random.Random(seed).sample(range(scenarios),
                                             min(count, scenarios)))


def _host(out) -> dict:
    return {k: getattr(out, k).cpu().numpy()
            for k in ("pose_odom", "pose_aft", "pose_integrated", "mapped")}


def run(cell, seed: int, seconds: float, traced: bool, device, t_start,
        card: str, readers=None, workers: int = 7) -> dict:
    """The run's result: correct, attempted, failed, metrics, device and,
    traced, breakdown, then `checks` (each number with its limit).
    t_start: the process's start on the perf_counter clock.  readers:
    per-layer metric name -> read(summary) (traced runs)."""
    from loam_tpu_torch.parallel.replay import batched_replay

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cfg = loam_config(cell.config)
    traffic = cell.traffic
    raw, mask = gen.make_traffic(seed, traffic, cell.config, device)
    B, F = raw.shape[:2]
    sample = sampled(seed, B, int(traffic["check_scenarios"]))
    sync()
    if cuda:
        # the generator's scratch is not the program's
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    with spans.Instrument(torch.tensor(sample, device=device),
                          traced) as inst:
        batched_replay(raw, mask, cfg, device)     # builds, warms up
        sync()
        inst.features.clear()
        inst.spans = {n: [0.0, 0] for n in spans.LAYERS}
        inst.solving = [0.0, 0]
        # what set-up made is never collected: the window's collections
        # walk only what the window makes
        gc.collect()
        gc.freeze()
        setup_s = time.perf_counter() - t_start

        passes = []
        t0 = time.perf_counter()
        while True:
            passes.append(batched_replay(raw, mask, cfg, device))
            if time.perf_counter() - t0 >= seconds:
                break
        sync()
        window = time.perf_counter() - t0
        layer_spans = {k: list(v) for k, v in inst.spans.items()}
        solving = list(inst.solving)
        window_frames = len(passes) * B * F
        events = knn_calls = None
        if traced and cuda:
            # one more pass, after the window, under the profiler
            inst.knn_calls = []

            def one_pass():
                with torch.profiler.record_function("perfbench.pass"):
                    passes.append(batched_replay(raw, mask, cfg, device))
                    sync()

            events = trace.profile(one_pass)
            knn_calls, inst.knn_calls = inst.knn_calls, None
        t_check = time.perf_counter()

    peak = torch.cuda.max_memory_allocated() if cuda else 0
    attempted = len(passes) * B * F
    port = [_host(o) for o in passes]
    feats = {i: {c: (x.cpu().numpy(), m.cpu().numpy())
                 for c, (x, m) in f.items()}
             for i, f in zip((0, len(passes) - 1), inst.features)}
    jobs = [(raw[b].cpu().numpy(), mask[b].cpu().numpy(), False)
            for b in sample]
    del passes, raw, mask
    inst.features.clear()
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    result = dict(correct=False, attempted=attempted, failed=0,
                  metrics={}, device=dict(
                      platform="gpu" if cuda else "cpu", kind=card,
                      count=1, memory_peak_bytes=int(peak)))
    metrics = result["metrics"]
    with check.References(jobs, min(workers, len(jobs))) as references:
        if traced:
            summary = trace.Summary(spans=layer_spans, solving=solving,
                                    window_frames=window_frames,
                                    traced_frames=B * F)
            if events is not None:
                trace.summarize(events, summary, knn_calls, card)
            for m in cell.per_layer:
                value = (readers or {})[m["name"]](summary)
                if value is not None:
                    metrics[m["name"]] = dict(value=value, unit=m["unit"])
            result["device"].update(busy_s=summary.busy_s,
                                    window_s=summary.window_s)
            result["breakdown"] = dict(device_ops=summary.device_ops,
                                       idle_gaps=summary.idle_gaps)
        else:
            values = dict(frames_per_s=window_frames / window,
                          peak_mem_gib=peak / GIB, setup_s=setup_s)
            for m in cell.end_to_end:
                metrics[m["name"]] = dict(value=values[m["name"]],
                                          unit=m["unit"])
        refs = references.results()
    print(f"perfbench: set-up {setup_s:.1f} s, window {window:.1f} s in "
          f"{window_frames // (B * F)} passes, then "
          f"{time.perf_counter() - t_check:.1f} s to the check's end",
          file=sys.stderr)
    numbers, failed = check.compare(port, feats, refs, sample,
                                    cell.limits)
    result["correct"] = check.verdict(numbers, cell.limits)
    result["failed"] = failed
    result["checks"] = {n: dict(value=numbers[n], limit=cell.limits[n])
                        for n in check.NUMBERS if n in cell.limits}
    for n in check.NUMBERS:
        if n not in cell.limits:
            print(f"perfbench: {n} {numbers[n]!r} (read, not compared)",
                  file=sys.stderr)
    return result

