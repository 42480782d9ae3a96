"""How far one ulp of input moves a small replay of the port.

    python3 profile_torch_conditioning.py [--device cuda|cpu]

Replays the four straight sweeps of the GPU tests (tests/torch_parity.py
`make_sweeps(4)`, 480 azimuths, in rings of 512 at `small_config`) twice
in each mapping mode and at each configuration of
tests/torch_parity.WIDE_K: once as made, once with every coordinate
moved by one ulp up or down (seeded).  Prints the largest gap of each
pose stream in rad and m, and the frame where it is.  The gap is the
floor under any bound that compares two devices' whole replays of these
sweeps: their arithmetic differs by about an ulp.  Runs on the card;
on the CPU only with --device cpu.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device (pass --device cpu to replay on the CPU)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_parity import WIDE_K, make_sweeps, small_config

    from loam_tpu_torch import pipeline

    torch.set_num_threads(1)
    raw, msk, _ = make_sweeps(4)
    rng = np.random.default_rng(0)
    up = rng.uniform(size=raw.shape) < 0.5
    moved = np.nextafter(raw, np.where(up, np.inf, -np.inf).astype(
        np.float32))
    assert moved.dtype == np.float32 and (moved != raw).all()
    modes = [("strict", {}), ("hybrid", dict(map_exact_regather_every=5)),
             ("cells", dict(map_exact_knn=False))] + list(WIDE_K)
    for name, over in modes:
        cfg = dataclasses.replace(small_config(), **over)
        a = pipeline.replay_sweeps(raw, msk, cfg, device=args.device)
        b = pipeline.replay_sweeps(moved, msk, cfg, device=args.device)
        gaps = []
        for field in ("pose_odom", "pose_aft", "pose_integrated"):
            d = (getattr(a, field) - getattr(b, field)).abs().cpu()
            rot, trans = d[:, :3].max(1).values, d[:, 3:].max(1).values
            gaps.append(f"{field} {float(rot.max()):.3g} rad (frame "
                        f"{int(rot.argmax())}) {float(trans.max()):.3g} m "
                        f"(frame {int(trans.argmax())})")
        print(f"{name} {over}: one ulp moves {'; '.join(gaps)} "
              f"[{args.device}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
