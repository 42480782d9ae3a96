"""The benchmark of loam_tpu_torch on one NVIDIA card.

    python3 perfbench/run.py --workload <config>.<traffic> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout.  Runs one cell of BENCHMARK.json: makes its
sweeps on the card from the seed, warms up, replays them in a closed
loop for `seconds`, checks what the window produced against the plain
reference and the ground truth, and prints one JSON line last on
standard output (correct, attempted, failed, metrics, device, with
--trace 1 breakdown, then checks), each compared number beside its
limit as the last lines on standard error.  With --trace 0 the metrics
are the cell's end-to-end metrics, with --trace 1 its per-layer ones.

Exits non-zero and prints no result without a CUDA card, with fewer
cards than the cell asks for, where the port is not in the checkout, or
where the process holds jax, jaxlib, flax or loam_tpu once the window
has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "loam_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is jax's or
    the JAX package's (loam_tpu_torch is not loam_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # every build and kernel cache of the program inside the checkout
    cache = ROOT / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    sys.path.insert(0, str(ROOT / "perfbench"))
    sys.path.insert(1, str(ROOT))
    from pbench import spec

    try:
        cell = spec.resolve(args.workload, ROOT)
    except (KeyError, FileNotFoundError) as exc:
        print(f"perfbench: {exc}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("perfbench: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {cell.name} needs {cell.chips} cards and "
              f"{torch.cuda.device_count()} are here", file=sys.stderr)
        return 2
    if not (ROOT / "loam_tpu_torch" / "__init__.py").exists():
        print(f"perfbench: the program loam_tpu_torch is not in {ROOT}",
              file=sys.stderr)
        return 2
    import loam_tpu_torch  # noqa: F401
    from pbench import cell as cellrun

    torch.set_num_threads(1)
    readers = {m["name"]: spec.metric_reader(m["name"], ROOT)
               for m in cell.per_layer} if args.trace else None
    result = cellrun.run(cell, args.seed, args.seconds, bool(args.trace),
                         "cuda", T_START, torch.cuda.get_device_name(0),
                         readers)
    found = forbidden_modules()
    if found:
        print(f"perfbench: the process holds {', '.join(found)}: the port "
              "must not load JAX or the JAX package", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
