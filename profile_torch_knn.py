"""Time the windowed exact k-NN kernel (loam_tpu_torch/csrc/knn_topk.cu)
beside other builds of it on one CUDA device.

    python3 profile_torch_knn.py [--parent DIR] [--queue W:T,...]...
                                 [--ptxas] [--out FILE]

Builds this checkout's csrc/knn_topk.cu and, each into a library of its
own, every build asked for:

  --parent DIR    DIR/loam_tpu_torch/csrc/knn_topk.cu with DIR's headers
                  (an unpacked earlier commit: the same C entry point);
  --queue TABLE   this source with the warp queue's thread-queue slots T
                  set for the listed queue sizes W, e.g. 32:4,64:4
                  (repeatable).

Then it runs every build on the shapes of chip_smoke.py's
knn_topk_dyn_k16 row: the lattice (B=1, Q=2048, M=4096, 1153 x 3587
live, the kernel phase's tile windows: exact ties everywhere) and the
dense cell's hybrid gather (chip_smoke.sorted_cloud: 8192 queries
against 50000 of 65536 references, 2 m windows), at each k of
LATTICE_K and DENSE_K.  Every output must equal knn_topk_plain's bit
for bit.  Device ms is chip_smoke.device_ms (50 calls queued behind a
long matrix product), taken in turns: this build, the others, the others
again in reverse, this build again.  A build whose entry refuses k (an
earlier limit) is skipped at that k.  --ptxas prints nvcc -Xptxas -v's
registers, stack and spills for each kernel instance of this build.
Prints a line a shape and k with the card's name and power limit, and
writes the numbers as JSON (default chiprun_out/profile_knn.json).

    python3 profile_torch_knn.py --emulate K

runs on the CPU instead: the warp queue of the kernel's k > 8 path
(WarpQueue<W, T>, W the smallest power of two >= K from 32) step by step
in NumPy over 24 seeded rows of the dense gather, at T = 1, 2, 4 and 8,
and prints the scan steps, admissions and merges a query, each row's
result held to its k smallest (distance, index) pairs.
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
LATTICE_K = (5, 8, 9, 12, 13, 16, 24, 32, 40, 100, 200, 300, 812, 1024)
DENSE_K = (5, 8, 9, 12, 13, 16, 24, 32, 40)


def queue_source(text: str, table: dict) -> str:
    """csrc/knn_topk.cu with KNN_QUEUE(W, T) set to the table's T."""
    def sub(m):
        w = int(m.group(1))
        return f"KNN_QUEUE({w}, {table.get(w, int(m.group(2)))})"
    out, n = re.subn(r"KNN_QUEUE\((\d+), (\d+)\)", sub, text)
    if not n:
        raise SystemExit("no KNN_QUEUE(W, T) in the source")
    return out


def build(tag: str, text: str, headers: Path, extra=()):
    """Start nvcc for `text` (a knn_topk.cu) beside copies of the
    headers; returns (process, library path)."""
    from loam_tpu_torch.ops.cuda import _build

    d = _build.BUILD_DIR / "variants" / tag
    d.mkdir(parents=True, exist_ok=True)
    for h in headers.glob("*.cuh"):
        (d / h.name).write_bytes(h.read_bytes())
    (d / "knn_topk.cu").write_text(text)
    lib = d / "libknn_topk.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *extra, "-o", str(lib),
           str(d / "knn_topk.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), lib


def ptxas_report(log: str) -> list:
    """(kernel instance, ptxas lines) from nvcc -Xptxas -v output."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            inst = re.search(r"(LaneLists|WarpQueue)ILi(\d+)E(?:Li(\d+)E)?",
                             name)
            name = (f"{inst.group(1)}<{inst.group(2)}"
                    + (f", {inst.group(3)}>" if inst.group(3) else ">")
                    if inst else name)
        elif name and ("registers" in line or "spill" in line
                       or "stack frame" in line):
            out.append((name, line.split("ptxas info    :")[-1].strip()))
    return out


# the kernel's empty key: (+inf, index 0x7fffffff)
EMPTY = np.uint64((0x7F800000 << 32) | 0x7FFFFFFF)


def _step(a, size, j):
    """bitonic_step over the warp-wide array a (element e = r * 32 +
    lane, flattened): e meets e ^ j; the lower keeps the smaller key in
    a run of `size` that ascends, the larger in one that descends."""
    e = np.arange(a.size)
    other = a[e ^ j]
    small = ((e & size) == 0) == ((e & j) == 0)
    return np.where(small, np.minimum(a, other), np.maximum(a, other))


def _merge(a, size):
    j = size // 2
    while j:
        a = _step(a, size, j)
        j //= 2
    return a


class QueueEmulation:
    """WarpQueue<W, T> of csrc/knn_topk.cu for one query, in NumPy."""

    def __init__(self, W, T, k):
        self.W, self.T, self.k = W, T, k
        self.q = np.full(W, EMPTY)
        self.t = np.full((T, 32), EMPTY)     # slot s of lane l
        self.n = np.zeros(32, int)
        self.kth = np.float32(np.inf)
        self.steps = self.admits = self.merges = 0

    def merge(self):
        self.merges += 1
        t = self.t.reshape(-1)
        size = 2
        while size <= t.size:               # bitonic_sort
            t = _merge(t, size)
            size *= 2
        m = min(t.size, self.W)             # pair e against W - 1 - e
        self.q[self.W - m:] = np.minimum(self.q[self.W - m:], t[:m][::-1])
        self.q = _merge(self.q, self.W)
        self.t[:] = EMPTY
        self.n[:] = 0
        self.kth = np.uint32(self.q[self.k - 1] >> np.uint64(32)).view(
            np.float32)

    def scan(self, d, base):
        """One staged slice: distances d of references base, base + 1..."""
        lanes = np.arange(32)
        for j0 in range(0, len(d), 32):
            self.steps += 1
            j = j0 + lanes
            dj = np.where(j < len(d), d[np.minimum(j, len(d) - 1)],
                          np.float32(np.inf)).astype(np.float32)
            take = dj < self.kth
            self.admits += int(take.sum())
            keys = ((dj.view(np.uint32).astype(np.uint64) << np.uint64(32))
                    | (base + j).astype(np.uint64))
            self.t[1:, take] = self.t[:-1, take]    # shift in
            self.t[0, take] = keys[take]
            self.n += take
            if (self.n == self.T).any():
                self.merge()

    def result(self):
        if (self.n > 0).any():
            self.merge()
        top = self.q[: self.k]
        return ((top & np.uint64(0xFFFFFFFF)).astype(np.int64),
                np.uint32(top >> np.uint64(32)).view(np.float32))


def emulate(k: int, rows: int = 24) -> None:
    """The warp queue on `rows` seeded rows of the dense gather."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as CS

    rng = np.random.default_rng(CS.SEED)
    tq, tm, n_ref, slice_ = 256, 512, 50000, 1024
    q, ref, t_lo, t_hi = CS.sorted_cloud(rng, torch.device("cpu"), 1, 8192,
                                         65536, 8192, n_ref, 2.0, tq, tm)
    q, ref = q[0].numpy(), ref[0].numpy()
    picks = rng.integers(0, 8192, rows)
    W = max(32, 1 << (k - 1).bit_length())
    for T in (1, 2, 4, 8):
        total = np.zeros(3)
        for i in picks:
            blk = i // tq
            start = max(int(t_lo[0, blk]), 0) * tm
            end = min(int(t_hi[0, blk]) * tm, n_ref)
            diff = (q[i] - ref[start:end]).astype(np.float32)
            d = (diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1]) \
                + diff[:, 2] * diff[:, 2]
            em = QueueEmulation(W, T, k)
            for s0 in range(0, len(d), slice_):
                em.scan(d[s0:s0 + slice_], start + s0)
            idx, d2 = em.result()
            best = np.lexsort((np.arange(len(d)), d))[:k]
            if not (np.array_equal(idx, start + best)
                    and np.array_equal(d2, d[best])):
                raise AssertionError(f"emulation differs at row {i}")
            total += (em.steps, em.admits, em.merges)
        steps, admits, merges = total / rows
        print(f"emulated WarpQueue<{W}, {T}> at k={k}, {rows} rows of the "
              f"dense gather: {steps:.0f} scan steps, {admits:.0f} "
              f"admissions, {merges:.1f} merges a query; every row its k "
              "smallest pairs", flush=True)


class Build:
    def __init__(self, tag, lib):
        from loam_tpu_torch.ops.cuda import knn_topk as KN

        self.tag = tag
        cdll = ctypes.CDLL(str(lib))
        self.fn = cdll.knn_topk_launch
        self.fn.restype = ctypes.c_int
        self.fn.argtypes = list(KN._ARGTYPES)
        self.max_k = cdll.knn_topk_max_k()

    def __call__(self, q, ref, n_q, n_ref, k, t_lo, t_hi, tq, tm):
        from loam_tpu_torch.ops.cuda import _build

        B, Q, _ = q.shape
        d2 = torch.empty((B, Q, k), dtype=torch.float32, device=q.device)
        idx = torch.empty((B, Q, k), dtype=torch.int32, device=q.device)
        inst = ctypes.c_int(0)
        err = self.fn(*(_build.ptr(t) for t in (q, ref, n_q, n_ref, t_lo,
                                                t_hi, d2, idx)),
                      B, Q, ref.shape[1], k, tq, tm, ctypes.byref(inst),
                      _build.stream_of(q))
        _build.check(err, f"knn_topk ({self.tag})")
        return idx, d2, inst.value


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--queue", action="append", default=[])
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "chiprun_out" / "profile_knn.json")
    ap.add_argument("--emulate", type=int, metavar="K")
    a = ap.parse_args()
    if a.emulate:
        emulate(a.emulate)
        return 0
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_knn: no CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as CS
    from loam_tpu_torch.ops.cuda import _build
    from loam_tpu_torch.ops.cuda import knn_topk as KN

    card = CS.card_line()
    dev = torch.device("cuda", 0)
    text = (_build.CSRC / "knn_topk.cu").read_text()
    jobs = {"this": build("this", text, _build.CSRC,
                          ("-Xptxas", "-v") if a.ptxas else ())}
    if a.parent:
        csrc = a.parent / "loam_tpu_torch" / "csrc"
        jobs["parent"] = build("parent", (csrc / "knn_topk.cu").read_text(),
                               csrc)
    for spec in a.queue:
        table = {int(w): int(t) for w, t in
                 (item.split(":") for item in spec.split(","))}
        jobs[f"queue {spec}"] = build(f"queue_{spec.replace(':', '-')}"
                                      .replace(",", "_"),
                                      queue_source(text, table), _build.CSRC)
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

    rng = np.random.default_rng(CS.SEED)
    i32 = dict(dtype=torch.int32, device=dev)
    tq, tm = 256, 512
    lat = (torch.tensor(CS.lattice(rng, (1, 8 * tq, 3)), device=dev),
           torch.tensor(CS.lattice(rng, (1, 8 * tm, 3)), device=dev),
           torch.tensor([4 * tq + tq // 2 + 1], **i32),
           torch.tensor([7 * tm + 3], **i32),
           torch.tensor([[0, 7, 3, 2, -1, 0, 0, 0]], **i32),
           torch.tensor([[8, 8, 3, 5, 99, 8, 8, 8]], **i32))
    q, ref, t_lo, t_hi = CS.sorted_cloud(rng, dev, 1, 8192, 65536, 8192,
                                         50000, 2.0, tq, tm)
    dense = (q, ref, torch.tensor([8192], **i32), torch.tensor([50000], **i32),
             t_lo, t_hi)
    results = []
    for shape, args, ks in (("lattice", lat, LATTICE_K),
                            ("dense", dense, DENSE_K)):
        q, ref, n_q, n_ref, t_lo, t_hi = args
        for k in ks:
            want = KN.knn_topk_plain(q, ref, n_q, n_ref, k, t_lo, t_hi,
                                     tq=tq, tm=tm)
            runs = [b for b in builds if k <= b.max_k]
            inst = {}
            for b in runs:
                idx, d2, inst[b.tag] = b(q, ref, n_q, n_ref, k, t_lo, t_hi,
                                         tq, tm)
                if not (torch.equal(idx, want[0]) and torch.equal(d2, want[1])):
                    raise AssertionError(f"{b.tag}: {shape} k={k} differs "
                                         "from the plain version")
            ms = {b.tag: [] for b in runs}
            for b in runs + runs[::-1]:
                ms[b.tag].append(CS.device_ms(
                    lambda: b(q, ref, n_q, n_ref, k, t_lo, t_hi, tq, tm)))
            results.append(dict(shape=shape, k=k, instance=inst,
                                device_ms=ms))
            print(f"knn {shape} k={k}: " + ", ".join(
                f"{t} {min(v):.4f}-{max(v):.4f} ms (instance {inst[t]})"
                for t, v in ms.items()) + f" [{card}]", flush=True)
    a.out.parent.mkdir(parents=True, exist_ok=True)
    a.out.write_text(json.dumps(dict(card=card, results=results), indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
