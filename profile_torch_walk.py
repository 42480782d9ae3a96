"""Time the selection walk (loam_tpu_torch/csrc/select_walk.cu) beside an
earlier commit's build of it on one CUDA device.

    python3 profile_torch_walk.py [--parent DIR] [--rounds N] [--out FILE]

Builds this checkout's csrc/select_walk.cu and, with --parent, DIR's (an
unpacked earlier commit, `git archive HEAD | tar -x -C DIR`, built with
its own headers), each into a library of its own.  The walk's inputs are
those of chip_smoke.py's rows: every ring of phase 4's 13 sweeps (B=1 x
R=208, W=2048: row 4) and of phase 13 a's (W=7200, 8 words a lane: row
4w), at suppress_neighbors 5 and, for this build only, 8 and 16.  Each
build gets the meta words in its own layout, read from its
ops/cuda/select_walk.py (the shifts and the reach fields' width; an
earlier layout takes reaches up to 7 only).  Every output must equal this
checkout's select_walk_plain bit for bit.  Device ms is 50 calls queued
behind a long matrix product, call ms the median of 20 calls between
CUDA events; the builds run in turns (this, parent, parent, this), N
rounds.  Prints a line a shape with the card's name and power limit, and
writes the numbers as JSON (default smoke_out/profile_walk.json).
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
REACHES = (5, 8, 16)


def layout(select_walk_py: Path) -> dict:
    """The meta word's field shifts and reach width of a select_walk.py."""
    text = select_walk_py.read_text()
    out = {name: int(re.search(rf"^_{name.upper()}_SHIFT = (\d+)$", text,
                               re.M).group(1))
           for name in ("up", "dn", "valid", "qual")}
    bits = re.search(r"^_REACH_MASK = \(1 << (\d+)\) - 1$", text, re.M)
    out["reach_bits"] = int(bits.group(1)) if bits else 3
    return out


def repack(meta, lay: dict):
    """This checkout's meta words in the layout `lay`; raises where a
    reach does not fit that layout's field."""
    from loam_tpu_torch.ops.cuda import select_walk as SW

    ind, up, dn, valid, qual = SW.unpack_walk_meta(meta.long())
    if int(torch.maximum(up, dn).max()) >= 1 << lay["reach_bits"]:
        raise ValueError("a reach past the layout's field")
    return (ind | (up << lay["up"]) | (dn << lay["dn"])
            | (valid.long() << lay["valid"])
            | (qual.long() << lay["qual"])).to(torch.int32).contiguous()


def build(tag: str, csrc: Path):
    """Start nvcc for csrc/select_walk.cu beside copies of csrc's headers;
    returns (process, library path)."""
    from loam_tpu_torch.ops.cuda import _build

    d = _build.BUILD_DIR / "variants" / f"select_walk_{tag}"
    d.mkdir(parents=True, exist_ok=True)
    for f in list(csrc.glob("*.cuh")) + [csrc / "select_walk.cu"]:
        (d / f.name).write_bytes(f.read_bytes())
    lib = d / "libselect_walk.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
           str(d / "select_walk.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), lib


class Build:
    def __init__(self, tag, lib, lay):
        from loam_tpu_torch.ops.cuda import select_walk as SW

        self.tag, self.layout = tag, lay
        self.fn = ctypes.CDLL(str(lib)).select_walk_launch
        self.fn.restype = ctypes.c_int
        self.fn.argtypes = list(SW._ARGTYPES)

    def __call__(self, cm, fm, p0, kw):
        from loam_tpu_torch.ops.cuda import _build
        from loam_tpu_torch.ops.cuda import select_walk as SW

        B, R, _ = cm.shape
        wb = SW.words_for(kw["W"])
        out = torch.empty((B, R, 4 * wb), dtype=torch.int64,
                          device=cm.device)
        instance = ctypes.c_int(0)
        err = self.fn(*(_build.ptr(t) for t in (cm, fm, p0, out)),
                      B, R, kw["n_sub"], kw["subw"], kw["W"],
                      SW.walk_limit(kw["corner_k"], kw["subw"]),
                      SW.walk_limit(kw["flat_k"], kw["subw"]),
                      kw["max_sharp"], kw["max_less_sharp"], kw["max_flat"],
                      ctypes.byref(instance), _build.stream_of(out))
        _build.check(err, f"select_walk ({self.tag})")
        return tuple(out[..., f * wb:(f + 1) * wb] for f in range(4))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", type=Path,
                    default=ROOT / "smoke_out" / "profile_walk.json")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_walk: no CUDA device")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    import chip_smoke as CS
    from loam_tpu_torch import configure_numerics, frontend
    from loam_tpu_torch.ops.cuda import _build
    from loam_tpu_torch.ops.cuda import select_walk as SW

    configure_numerics()
    card = CS.card_line()
    dev = torch.device("cuda", 0)
    here = ROOT / "loam_tpu_torch"
    jobs = {"this": (build("this", _build.CSRC),
                     layout(here / "ops" / "cuda" / "select_walk.py"))}
    if a.parent:
        there = a.parent.resolve() / "loam_tpu_torch"
        jobs["parent"] = (build("parent", there / "csrc"),
                          layout(there / "ops" / "cuda" / "select_walk.py"))
    builds = []
    for tag, ((proc, lib), lay) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {tag}:\n{log}")
        builds.append(Build(tag, lib, lay))
    print(f"builds: {[(b.tag, b.layout) for b in builds]} [{card}]",
          flush=True)

    cells = (("row 4", CS.make_sweeps(), CS.replay_config("default")),
             ("row 4w", CS.rate5_sweeps(), CS.rate5_config()))
    results = []
    for row, (raw, msk), cfg0 in cells:
        for reach in REACHES:
            cfg = dataclasses.replace(cfg0, suppress_neighbors=reach)
            cm, fm, pre, kw, need = CS.walk_inputs(frontend.ingest_sweep(
                torch.tensor(raw, device=dev), torch.tensor(msk, device=dev),
                cfg), cfg)
            cm, fm = cm[None].contiguous(), fm[None].contiguous()
            p0 = SW.pack_bits(pre)[None]
            want = SW.select_walk_plain(cm, fm, p0, **kw)
            shape = (f"B=1,R={cm.shape[1]},W={kw['W']},reach={reach},"
                     f"walked={int(need['walked'].sum())},"
                     f"picks={int(need['picks'].sum())}")
            runs = {}
            for b in builds:
                try:
                    metas = (repack(cm, b.layout), repack(fm, b.layout))
                except ValueError:
                    continue          # an earlier layout's 3-bit reaches
                got = b(*metas, p0, kw)
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise AssertionError(f"{b.tag}: {row} {shape} differs "
                                         "from the plain version")
                runs[b.tag] = (b, metas)
            ms = {t: [] for t in runs}
            call = {t: [] for t in runs}
            order = list(runs) + list(runs)[::-1]
            for _ in range(a.rounds):
                for tag in order:
                    b, (m1, m2) = runs[tag]
                    fn = lambda: b(m1, m2, p0, kw)
                    ms[tag].append(CS.device_ms(fn))
                    call[tag].append(CS.time_ms(fn))
            results.append(dict(row=row, shape=shape, device_ms=ms,
                                call_ms=call))
            print(f"walk {row} {shape}: " + "; ".join(
                f"{t} device {min(ms[t]):.4f}-{max(ms[t]):.4f} ms, call "
                f"{min(call[t]):.4f}-{max(call[t]):.4f} ms" for t in ms)
                + f" [{card}]", flush=True)
    a.out.parent.mkdir(parents=True, exist_ok=True)
    a.out.write_text(json.dumps(dict(card=card, results=results), indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
