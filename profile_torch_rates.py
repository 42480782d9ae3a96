"""The port's trajectories at the VLP-16's other rotation rates against
the golden oracle on one NVIDIA GPU, for this checkout and, with
--parent, for an earlier commit's package beside it.

    python3 profile_torch_rates.py [--parent DIR] [--out FILE]

Makes chip_smoke.py phase 13's sweeps once (5 Hz: 13 sweeps of 7200
azimuths at scan_period 0.2 s, the default cell's recipe; 20 Hz: 26
sweeps of 900 azimuths at 0.05 s), runs the NumPy oracle on each in a
process of its own (chip_smoke.start_oracle), and replays them strict,
at chip_smoke.rate5_config() and rate20_config(), with each package in a
process of its own (`--replay PACKAGE_ROOT OUT`), which builds that
package's kernels.  DIR is an unpacked earlier commit (`git archive`);
the packages run in turns: parent, this, this, parent.  Prints each
run's integrated ATE against the oracle and its frames/s, with the
card's name and power limit, and writes them as JSON (default
smoke_out/profile_rates.json).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
CASES = ("5 Hz strict", "20 Hz")


def replay_process(package: str, sweeps: str, out: str) -> int:
    """Replay both cases with the package under `package` (its own
    kernel build); save each case's poses, cadence and seconds to OUT."""
    import torch

    import chip_smoke as CS      # this checkout's, from the script's folder

    sys.path.insert(0, package)
    import loam_tpu_torch
    from loam_tpu_torch import configure_numerics, pipeline
    from loam_tpu_torch.ops.cuda import _build

    if not Path(loam_tpu_torch.__file__).resolve().is_relative_to(
            Path(package).resolve()):
        raise SystemExit(f"imported {loam_tpu_torch.__file__}, not the "
                         f"package under {package}")
    configure_numerics()
    _build.build_all()
    dev = torch.device("cuda", 0)
    data = np.load(sweeps)
    saved = {}
    for case, cfg in zip(CASES, (CS.rate5_config(), CS.rate20_config())):
        tag = case.split()[0]
        raw = torch.tensor(data[f"raw_{tag}"], device=dev)
        msk = torch.tensor(data[f"msk_{tag}"], device=dev)
        pipeline.replay_sweeps(raw[:3], msk[:3], cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = pipeline.replay_sweeps(raw, msk, cfg)
        torch.cuda.synchronize()
        saved[f"seconds_{tag}"] = time.perf_counter() - t0
        saved[f"integrated_{tag}"] = outs.pose_integrated.cpu().numpy()
        saved[f"mapped_{tag}"] = outs.mapped.cpu().numpy()
    np.savez(out, **saved)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="an unpacked earlier commit")
    ap.add_argument("--out", default=str(ROOT / "smoke_out" /
                                         "profile_rates.json"))
    ap.add_argument("--replay", nargs=3, metavar=("PACKAGE", "SWEEPS", "OUT"),
                    help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.replay:
        return replay_process(*a.replay)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_rates: no CUDA device")
    sys.path.insert(0, str(ROOT / "tests"))
    import chip_smoke as CS
    from loam_tpu_torch import metrics

    card = CS.card_line()
    print(f"card: {card}", flush=True)
    started = {"5": CS.start_oracle("rate5"), "20": CS.start_oracle("rate20")}
    sweeps = CS.OUT_DIR / "rates_sweeps.npz"
    (raw5, msk5), (raw20, msk20) = CS.rate5_sweeps(), CS.rate20_sweeps()
    np.savez(sweeps, raw_5=raw5, msk_5=msk5, raw_20=raw20, msk_20=msk20)
    packages = {"this": str(ROOT)}
    if a.parent:
        packages["parent"] = str(Path(a.parent).resolve())
    order = (["parent", "this", "this", "parent"] if a.parent
             else ["this", "this"])
    runs = []
    for i, name in enumerate(order):
        out = CS.OUT_DIR / f"rates_{i}_{name}.npz"
        t0 = time.perf_counter()
        done = subprocess.run(
            [sys.executable, __file__, "--replay", packages[name],
             str(sweeps), str(out)], cwd=ROOT, capture_output=True,
            text=True, timeout=900)
        if done.returncode:
            raise SystemExit(f"{name} exited {done.returncode}:\n"
                             f"{done.stdout[-3000:]}\n{done.stderr[-5000:]}")
        runs.append((name, dict(np.load(out)), time.perf_counter() - t0))
    oracles = {tag: CS.wait_oracle(s) for tag, s in started.items()}
    report = []
    for name, got, seconds in runs:
        row = dict(package=name, process_s=seconds)
        for case in CASES:
            tag = case.split()[0]
            est = got[f"integrated_{tag}"]
            oracle = oracles[tag]
            ate = metrics.ate_rmse(est[:, 3:6], oracle["integrated"][:, 3:6])
            frames = est.shape[0]
            row[case] = dict(
                ate_cm=100 * ate, frames=frames,
                frames_per_s=frames / float(got[f"seconds_{tag}"]),
                cadence_equal=bool(np.array_equal(got[f"mapped_{tag}"],
                                                  oracle["mapped"])),
                finite=bool(np.isfinite(est).all()))
            print(f"rates {name}: {case}, {frames} frames: integrated ATE "
                  f"vs golden oracle {100 * ate:.4f} cm, "
                  f"{row[case]['frames_per_s']:.2f} frames/s, mapping "
                  f"cadence equal: {row[case]['cadence_equal']} [{card}]",
                  flush=True)
        report.append(row)
    Path(a.out).write_text(json.dumps(dict(card=card, runs=report),
                                      indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
