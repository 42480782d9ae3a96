"""Time the nvcc builds of the port's kernel libraries
(loam_tpu_torch/csrc/*.cu) as chip_smoke.py starts them: one nvcc per
source, all started together.

    python3 profile_torch_build.py [--parent DIR] [--rounds N]

Each round builds every source of this checkout into a fresh temporary
directory under the gitignored loam_tpu_torch/_build/ and, with --parent
DIR (an unpacked earlier commit), every source of
DIR/loam_tpu_torch/csrc with DIR's headers, in turns: this, parent,
parent, this, ... so that both see the same host.  Prints, a build, the
wall seconds and each source's seconds from the start to its own nvcc's
end, with the card's name and power limit; nothing is kept.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def build_once(csrc: Path, names) -> tuple:
    """(wall seconds, {source: seconds to its nvcc's end}) of one build of
    every source in `names` from `csrc`, all nvcc started together."""
    from loam_tpu_torch.ops.cuda import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as out:
        t0 = time.perf_counter()
        procs = {n: subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
             str(Path(out) / f"lib{n}.so"), str(csrc / f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for n in names}
        seconds = {}

        def wait(name):
            log, _ = procs[name].communicate()
            if procs[name].returncode != 0:
                raise RuntimeError(f"nvcc failed for {csrc / name}.cu:\n{log}")
            seconds[name] = time.perf_counter() - t0

        with ThreadPoolExecutor(len(procs)) as pool:
            for done in [pool.submit(wait, n) for n in procs]:
                done.result()
        return time.perf_counter() - t0, seconds


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--rounds", type=int, default=2)
    a = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    from loam_tpu_torch.ops.cuda import _build

    card = card_line()
    builds = {"this": _build.CSRC}
    if a.parent:
        builds["parent"] = a.parent / "loam_tpu_torch" / "csrc"
    order = list(builds)
    for r in range(a.rounds):
        for tag in (order if r % 2 == 0 else order[::-1]):
            wall, each = build_once(builds[tag], _build.KERNEL_SOURCES)
            print(f"nvcc {tag}: {wall:.2f} s wall; " + ", ".join(
                f"{n} {s:.2f}" for n, s in each.items())
                + f" [{card}]", flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
