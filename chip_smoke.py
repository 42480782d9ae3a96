"""Drive the PyTorch/CUDA port (loam_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit) on failure:
  1. require a CUDA device; print its name and power limit;
  2. build every kernel from loam_tpu_torch/csrc (one nvcc per source,
     all started together);
  3. hold each kernel against its plain PyTorch version at the main
     path's shapes on seeded inputs (indices and bit-fields equal,
     squared distances within 1e-6 relative) and time both with CUDA
     events (median of 20 runs);
  4. replay 13 full-density synthetic VLP-16 sweeps through
     loam_tpu_torch.pipeline.replay_sweeps with LoamConfig() unchanged,
     count every kernel's launches in that run (each must be > 0), and
     hold the integrated trajectory within 5 cm ATE of the NumPy golden
     oracle (tests/golden) on the same sweeps.
The second-to-last lines are the kernels JSON and the card's name and
power limit; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 21
FRAMES = 13
N_AZIMUTH = 1800
REL_TOL = 1e-6     # squared distances, kernel vs plain
ATE_GATE = 0.05    # metres, integrated trajectory vs the golden oracle


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20) -> float:
    """Median milliseconds of fn() between CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _rel_err(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    live = (a < 1e28) | (b < 1e28)
    if not live.any():
        return 0.0
    return float(((a - b).abs() / b.abs().clamp(min=1e-12))[live].max())


def _abs_err(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    live = (a < 1e28) | (b < 1e28)
    return float((a - b).abs()[live].max()) if live.any() else 0.0


def _compare(name, kernel_out, plain_out, n_idx):
    """First n_idx outputs are indices or bit-fields (must be equal), the
    rest squared distances (within REL_TOL).  Returns max abs error."""
    for k, p in zip(kernel_out[:n_idx], plain_out[:n_idx]):
        if not torch.equal(k.cpu(), p.cpu()):
            bad = int((k.cpu() != p.cpu()).sum())
            raise AssertionError(f"{name}: {bad} index entries differ")
    err = 0.0
    for k, p in zip(kernel_out[n_idx:], plain_out[n_idx:]):
        if _rel_err(k, p) > REL_TOL:
            raise AssertionError(f"{name}: d2 off by {_rel_err(k, p)} rel")
        err = max(err, _abs_err(k, p))
    return err


def make_sweeps():
    from loam_tpu.io import synth

    world = synth.make_world(seed=SEED)
    poses = synth.straight_trajectory(FRAMES, speed=0.9, yaw_rate=0.1)
    poses = np.vstack([poses[:1], poses])[: FRAMES + 1]
    sweeps = [synth.simulate_sweep(world, poses[k], poses[k + 1],
                                   n_azimuth=N_AZIMUTH, seed=SEED + k)
              for k in range(FRAMES)]
    raw = np.stack([s[0] for s in sweeps]).astype(np.float32)
    return raw, np.stack([s[1] for s in sweeps])


def kernel_phase(dev, raw, msk, cfg):
    """Each kernel vs its plain version at the main path's shapes."""
    from loam_tpu_torch import frontend
    from loam_tpu_torch.ops import features as FT
    from loam_tpu_torch.ops.cuda import knn_topk as KN
    from loam_tpu_torch.ops.cuda import odom_corr as OC
    from loam_tpu_torch.ops.cuda import select_walk as SW

    rng = np.random.default_rng(SEED)
    i32 = dict(dtype=torch.int32, device=dev)
    rows = []

    def cloud(n, live, spread):
        pts = rng.uniform(-spread, spread, (1, n, 3)).astype(np.float32)
        pts[:, live:] = 0.0
        return torch.tensor(pts, device=dev)

    # ---- knn_topk k=1: the odometry 1-NN (corner, then surf shapes)
    err, ms = 0.0, {}
    for Q, M in ((256, 2048), (512, 16384)):
        n_ref = torch.tensor([M * 2 // 3], **i32)
        ref = cloud(M, M * 2 // 3, 30.0)
        q = (ref[:, rng.integers(0, M * 2 // 3, Q)]
             + torch.tensor(rng.normal(0, 0.2, (1, Q, 3)), device=dev)
             ).float().contiguous()
        t_lo, t_hi = KN.full_windows(1, Q, M, 256, 512, dev)
        run_k = lambda: KN._launch(q, ref, torch.tensor([Q], **i32), n_ref,
                                   1, t_lo, t_hi, 256, 512)
        run_p = lambda: KN.knn_topk_plain(q, ref, torch.tensor([Q], **i32),
                                          n_ref, 1, t_lo, t_hi, tq=256,
                                          tm=512)
        err = max(err, _compare("knn_topk", run_k(), run_p(), 1))
        ms = dict(ms=time_ms(run_k), plain_ms=time_ms(run_p))
    rows.append(dict(name="knn_topk", source="loam_tpu_torch/csrc/knn_topk.cu",
                     replaces="loam_tpu/ops/pallas/knn_topk.py:63",
                     max_abs_err=err, shape="Q=512,M=16384,k=1", **ms))

    # ---- knn_topk_dyn k=5 with tile windows: the mapping 5-NN
    err = 0.0
    for Q, M, n_q, n_ref_i in ((2048, 32768, 1500, 25000),
                               (8192, 65536, 6000, 50000)):
        half = np.array([60.0, 20.0, 5.0])
        ref_np = rng.uniform(-half, half, (n_ref_i, 3)).astype(np.float32)
        ref_np = ref_np[np.argsort(ref_np[:, 0], kind="stable")]
        refp = np.zeros((1, M, 3), np.float32)
        refp[0, :n_ref_i] = ref_np
        q_np = ref_np[rng.integers(0, n_ref_i, n_q)] + rng.normal(
            0, 0.3, (n_q, 3))
        q_np = q_np[np.argsort(q_np[:, 0], kind="stable")]
        qp = np.zeros((1, Q, 3), np.float32)
        qp[0, :n_q] = q_np
        q, ref = torch.tensor(qp, device=dev), torch.tensor(refp, device=dev)
        nq_t, nr_t = torch.tensor([n_q], **i32), torch.tensor([n_ref_i], **i32)
        mask = torch.arange(M, device=dev) < n_ref_i
        t_lo, t_hi = KN.tile_windows(q[0, :, 0], nq_t[0], ref[0, :, 0], mask,
                                     256, 512, 1.0 + 1e-3)
        t_lo, t_hi = t_lo[None].contiguous(), t_hi[None].contiguous()
        run_k = lambda: KN._launch(q, ref, nq_t, nr_t, 5, t_lo, t_hi, 256,
                                   512)
        run_p = lambda: KN.knn_topk_plain(q, ref, nq_t, nr_t, 5, t_lo, t_hi,
                                          tq=256, tm=512)
        err = max(err, _compare("knn_topk_dyn", run_k(), run_p(), 1))
        ms = dict(ms=time_ms(run_k), plain_ms=time_ms(run_p))
    rows.append(dict(name="knn_topk_dyn",
                     source="loam_tpu_torch/csrc/knn_topk.cu",
                     replaces="loam_tpu/ops/pallas/knn_topk.py:133",
                     max_abs_err=err, shape="Q=8192,M=65536,k=5", **ms))

    # ---- odom_corr: corner then surf walks on a ring-sorted cloud
    err = 0.0
    for Q, M, surf in ((256, 2048, False), (512, 16384, True)):
        live = M * 2 // 3
        rings = np.zeros((1, M), np.int32)
        rings[0, :live] = np.sort(rng.integers(0, 16, live))
        ref = cloud(M, live, 30.0)
        j1 = torch.tensor(rng.integers(-1, live, (1, Q)), **i32)
        q = (ref[:, j1[0].clamp(min=0).long()]
             + torch.tensor(rng.normal(0, 0.3, (1, Q, 3)), device=dev)
             ).float().contiguous()
        args = (q, ref, torch.tensor(rings, device=dev), j1,
                torch.tensor([Q * 3 // 4], **i32), torch.tensor([live], **i32))
        kw = dict(surf=surf, window=cfg.ring_window, truncate=True)
        run_k = lambda: OC._launch(*args, **kw)
        run_p = lambda: OC.odom_corr_plain(*args, **kw)
        err = max(err, _compare("odom_corr", run_k(), run_p(), 2))
        ms = dict(ms=time_ms(run_k), plain_ms=time_ms(run_p))
    rows.append(dict(name="odom_corr", source="loam_tpu_torch/csrc/odom_corr.cu",
                     replaces="loam_tpu/ops/pallas/odom_corr.py:65",
                     max_abs_err=err, shape="Q=512,M=16384,surf", **ms))

    # ---- select_walk: every ring of every frame of the replay
    sweep = frontend.ingest_sweep(torch.tensor(raw, device=dev),
                                  torch.tensor(msk, device=dev), cfg)
    curv, gap, pre, counts = FT.selection_inputs(sweep, cfg)
    W = cfg.ring_width
    cm, fm = FT.walk_meta(curv.reshape(-1, W), gap.reshape(-1, W),
                          counts.reshape(-1), cfg)
    cm, fm = cm[None].contiguous(), fm[None].contiguous()
    p0 = SW.pack_bits(pre.reshape(-1, W))[None]
    kw = dict(n_sub=cfg.n_subregions, subw=W // cfg.n_subregions + 8, W=W,
              max_sharp=cfg.max_sharp_per_subregion,
              max_less_sharp=cfg.max_less_sharp_per_subregion,
              max_flat=cfg.max_flat_per_subregion)
    run_k = lambda: SW._launch(cm, fm, p0, **kw)
    run_p = lambda: SW.select_walk_plain(cm, fm, p0, **kw)
    err = _compare("select_walk", run_k(), run_p(), 4)
    rows.append(dict(name="select_walk",
                     source="loam_tpu_torch/csrc/select_walk.cu",
                     replaces="loam_tpu/ops/pallas/select_walk.py:81",
                     max_abs_err=err, shape=f"R={cm.shape[1]},W={W}",
                     ms=time_ms(run_k), plain_ms=time_ms(run_p)))
    torch.cuda.synchronize()
    return rows


def main_path(dev, raw, msk, cfg):
    """The default replay on the card; returns (outputs, launch counts,
    seconds)."""
    from loam_tpu_torch import pipeline
    from loam_tpu_torch.ops.cuda import knn_topk as KN
    from loam_tpu_torch.ops.cuda import odom_corr as OC
    from loam_tpu_torch.ops.cuda import select_walk as SW

    raw_t = torch.tensor(raw, device=dev)
    msk_t = torch.tensor(msk, device=dev)
    # warm-up (library handles, allocator) on the first frames, uncounted
    pipeline.replay_sweeps(raw_t[:3], msk_t[:3], cfg)
    torch.cuda.synchronize()
    wrappers = {"knn_topk": KN.knn_topk, "knn_topk_dyn": KN.knn_topk_dyn,
                "odom_corr": OC.odom_corr, "select_walk": SW.select_walk}
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    outs = pipeline.replay_sweeps(raw_t, msk_t, cfg)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {name: fn.launches for name, fn in wrappers.items()}
    return outs, counts, seconds


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is False)")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    from loam_tpu.config import LoamConfig
    from loam_tpu_torch import configure_numerics, metrics
    from loam_tpu_torch.ops.cuda import _build

    card = card_line()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda", 0)
    configure_numerics()
    cfg = LoamConfig()

    secs = _build.build_all()
    print(f"built {len(_build.KERNEL_SOURCES)} kernel libraries in "
          f"{secs:.1f} s", flush=True)

    raw, msk = make_sweeps()
    rows = kernel_phase(dev, raw, msk, cfg)
    for r in rows:
        print(f"kernel {r['name']}: max_abs_err {r['max_abs_err']:.3g}, "
              f"{r['ms']:.4f} ms vs plain {r['plain_ms']:.4f} ms "
              f"({r['shape']})", flush=True)

    outs, counts, seconds = main_path(dev, raw, msk, cfg)
    print(f"main path launches: {counts}", flush=True)
    for r in rows:
        r["route"] = "cuda"
        r["launches"] = counts[r["name"]]
    missing = [n for n, c in counts.items() if c <= 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
    poses = outs.pose_integrated.cpu().numpy()
    if not np.isfinite(poses).all():
        raise AssertionError("non-finite poses")

    from golden.pipeline import run_pipeline

    oracle = run_pipeline(raw, msk)
    ate = metrics.ate_rmse(poses[:, 3:6], oracle["integrated"][:, 3:6])
    mapped_ok = np.array_equal(outs.mapped.cpu().numpy(), oracle["mapped"])
    fps = FRAMES / seconds
    print(f"replay: {FRAMES} frames in {seconds:.3f} s = {fps:.2f} frames/s; "
          f"integrated ATE vs golden oracle {100 * ate:.3f} cm; "
          f"mapping cadence equal: {mapped_ok} [{card}]", flush=True)
    if not ate < ATE_GATE:
        raise AssertionError(f"integrated ATE {ate:.4f} m >= {ATE_GATE} m")
    if not mapped_ok:
        raise AssertionError("mapping cadence differs from the oracle")

    print(json.dumps({"kernels": [
        {k: r[k] for k in ("name", "route", "source", "replaces", "launches",
                           "max_abs_err", "ms", "plain_ms", "shape")}
        for r in rows]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
