"""Time the candidate-row k-nearest kernel (loam_tpu_torch/csrc/kselect.cu)
beside other builds of it on one CUDA device.

    python3 profile_torch_kselect.py [--parent DIR] [--source TAG=FILE]...
                                     [--ptxas] [--out FILE]

Builds this checkout's csrc/kselect.cu and, each into a library of its
own, every build asked for:

  --parent DIR       DIR/loam_tpu_torch/csrc/kselect.cu with DIR's headers
                     (an unpacked earlier commit: the same C entry point);
  --source TAG=FILE  another kselect.cu with this checkout's headers
                     (repeatable).

Then it runs every build on the (Q, C, k) shapes of chip_smoke.py's
kselect and kselect_dense rows, with the same inputs: lattice candidates
(exact ties in every row) or continuous clouds around each query, about
60% valid, the second half of each row of 864 or more a copy of the
first, rows with fewer than k valid candidates and rows with none.  Rows
of C > 32 run twice, from the tensor's own base pointer and from one
shifted by a float (rows not 16-byte aligned: the loads a kernel takes
there).  Every output must equal knn_select_plain's bit for bit.  Device
ms is 50 calls queued behind a long matrix product, taken in turns: this
build, the others, the others again in reverse, this build again.
--ptxas prints nvcc -Xptxas -v's registers, stack, shared memory and
spills for each kernel instance of this build.  Prints a line a shape
with the card's name and power limit, and writes the numbers as JSON
(default smoke_out/profile_kselect.json).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 21
# (Q, C, k, lattice): chip_smoke.py's kselect rows, then kselect_dense's,
# then the k = 24 and 40 of each gather width, then k = 64 (past the
# warp kernel's two keys a lane) at the dense width and at 27 cells of 80
SHAPES = ((8200, 24, 5, True), (1024, 864, 24, True), (8192, 8, 5, False),
          (8 * 8192, 8, 5, False), (8192, 24, 5, False),
          (2048, 864, 1, False), (2048, 864, 24, False),
          (1024, 1296, 40, True), (8192, 40, 5, False),
          (2048, 1296, 40, False), (8192, 64, 5, False),
          (2048, 864, 40, False), (2048, 1296, 24, False),
          (2048, 1296, 64, False), (200, 2160, 64, False))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


_BALLAST = None


def device_ms(fn, reps: int = 50) -> float:
    """Milliseconds a call of fn() takes on the device with the host out
    of the way: reps calls queued behind a long matrix product."""
    global _BALLAST
    fn()
    if _BALLAST is None:
        _BALLAST = torch.empty((8192, 8192), device="cuda").fill_(1e-3)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.mm(_BALLAST, _BALLAST)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def lattice(rng, shape, half: int = 2):
    """Coordinates on a 0.25 m lattice: many exactly equal distances."""
    return (rng.integers(-half, half + 1, size=shape) * 0.25).astype(
        np.float32)


def inputs(rng, dev, Q, C, k, ties):
    """chip_smoke.py's kselect inputs for one shape: (cand, valid, q)."""
    if ties:
        q_np = lattice(rng, (Q, 3))
        cand_np = lattice(rng, (Q, C, 3), half=3)
    else:
        q_np = rng.uniform(-30, 30, (Q, 3)).astype(np.float32)
        cand_np = (q_np[:, None, :]
                   + rng.normal(0, 0.8, (Q, C, 3))).astype(np.float32)
    valid_np = rng.uniform(size=(Q, C)) < 0.6
    if C >= 864:
        cand_np[:, C // 2:] = cand_np[:, :C // 2]
        valid_np[::7, max(k - 4, 0):] = False   # fewer than k valid
        valid_np[::64] = False                  # none at all
    return (torch.tensor(cand_np, device=dev),
            torch.tensor(valid_np, device=dev), torch.tensor(q_np, device=dev))


def build(tag: str, text: str, headers: Path, extra=()):
    """Start nvcc for `text` (a kselect.cu) beside copies of the headers;
    returns (process, library path)."""
    from loam_tpu_torch.ops.cuda import _build

    d = _build.BUILD_DIR / "variants" / f"kselect_{tag}"
    d.mkdir(parents=True, exist_ok=True)
    for h in headers.glob("*.cuh"):
        (d / h.name).write_bytes(h.read_bytes())
    (d / "kselect.cu").write_text(text)
    lib = d / "libkselect.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *extra, "-o", str(lib),
           str(d / "kselect.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), lib


def ptxas_report(log: str) -> list:
    """(kernel, ptxas lines) from nvcc -Xptxas -v output."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        elif name and ("registers" in line or "spill" in line
                       or "stack frame" in line):
            out.append((name, line.split("ptxas info    :")[-1].strip()))
    return out


class Build:
    def __init__(self, tag, lib):
        from loam_tpu_torch.ops.cuda import kselect as KS

        self.tag = tag
        cdll = ctypes.CDLL(str(lib))
        self.fn = cdll.kselect_launch
        self.fn.restype = ctypes.c_int
        self.fn.argtypes = list(KS._ARGTYPES)

    def __call__(self, cand, valid, q, k):
        from loam_tpu_torch.ops.cuda import _build

        Q, C = valid.shape
        pts = torch.empty((Q, k, 3), dtype=torch.float32, device=q.device)
        d2 = torch.empty((Q, k), dtype=torch.float32, device=q.device)
        err = self.fn(*(_build.ptr(t) for t in (cand, valid, q, pts, d2)),
                      Q, C, k, _build.stream_of(q))
        _build.check(err, f"kselect ({self.tag})")
        return pts, d2


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--source", action="append", default=[],
                    metavar="TAG=FILE")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "smoke_out" / "profile_kselect.json")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_kselect: no CUDA device")
    sys.path.insert(0, str(ROOT))
    from loam_tpu_torch.ops.cuda import _build
    from loam_tpu_torch.ops.cuda import kselect as KS

    card = card_line()
    dev = torch.device("cuda", 0)
    jobs = {"this": build("this", (_build.CSRC / "kselect.cu").read_text(),
                          _build.CSRC, ("-Xptxas", "-v") if a.ptxas else ())}
    if a.parent:
        csrc = a.parent / "loam_tpu_torch" / "csrc"
        jobs["parent"] = build("parent", (csrc / "kselect.cu").read_text(),
                               csrc)
    for spec in a.source:
        tag, path = spec.split("=", 1)
        jobs[tag] = build(tag, Path(path).read_text(), _build.CSRC)
    builds = []
    for tag, (proc, lib) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {tag}:\n{log}")
        if tag == "this" and a.ptxas:
            for name, line in ptxas_report(log):
                print(f"ptxas {name}: {line}", flush=True)
        builds.append(Build(tag, lib))
    print(f"builds: {[b.tag for b in builds]} [{card}]", flush=True)

    rng = np.random.default_rng(SEED)
    results = []
    for Q, C, k, ties in SHAPES:
        cand, valid, q = inputs(rng, dev, Q, C, k, ties)
        want = KS.knn_select_plain(cand, valid, q, k)
        bases = {"aligned": cand}
        if C > 32:
            shifted = torch.empty(cand.numel() + 1, device=dev)[1:]
            bases["shifted"] = shifted.view_as(cand).copy_(cand)
        shape = f"Q={Q},C={C},k={k}" + (",lattice" * ties)
        for base, c in bases.items():
            for b in builds:
                got = b(c, valid, q, k)
                if not (torch.equal(got[0], want[0])
                        and torch.equal(got[1], want[1])):
                    raise AssertionError(f"{b.tag}: {shape} ({base}) "
                                         "differs from the plain version")
            ms = {b.tag: [] for b in builds}
            for b in builds + builds[::-1]:
                ms[b.tag].append(device_ms(lambda: b(c, valid, q, k)))
            results.append(dict(shape=shape, base=base, device_ms=ms))
            print(f"kselect {shape} {base}: " + ", ".join(
                f"{t} {min(v):.4f}-{max(v):.4f} ms" for t, v in ms.items())
                + f" [{card}]", flush=True)
    a.out.parent.mkdir(parents=True, exist_ok=True)
    a.out.write_text(json.dumps(dict(card=card, results=results), indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
