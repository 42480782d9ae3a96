"""Readings from which a cell's correctness limits are set.

    python3 perfbench/calibrate.py --workload <config>.<traffic> \
        --seeds 11,12,... [--control 3] [--fault 3] [--workers 7]

For each seed: the cell's sweeps made on the card as a run makes them,
one pass of the timed path (batched_replay at the cell's B and F), and
the numbers that perfbench/run.py compares (pbench/check.py) for the
program against the plain reference: the lower readings.  For the first
`--control` seeds also the control: the reference computed at TF32
precision (reference/precision.py) put in the program's place for the
same sampled scenarios: the upper readings.  For the first `--fault`
seeds also the selection fault: the program with its neighbour
suppression one point short of LOAM's (SELECTION_FAULT), a frontend
that picks other features from the same points.  Prints one JSON line a
seed, with each sampled scenario's numbers and each feature class's
largest share of a frame, and a summary last; the references of all
seeds run in one pool of `--workers` processes while the card works on
the next seed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SELECTION_FAULT = {"suppress_neighbors": 4}


def as_port(results):
    """Reference results of S scenarios in the program's output layout:
    ([a pass of (S, F, ...) pose arrays], {0: class -> (xyz, mask)})."""
    import numpy as np

    keys = {"pose_odom": "odom", "pose_aft": "aft",
            "pose_integrated": "integrated", "mapped": "mapped"}
    out = {k: np.stack([r[v] for r in results]) for k, v in keys.items()}
    S, F = len(results), len(results[0]["features"])
    feats = {}
    for c in results[0]["features"][0]:
        n = max(len(r["features"][f][c]) for r in results for f in range(F))
        xyz = np.zeros((S, F, max(n, 1), 3), np.float32)
        mask = np.zeros((S, F, max(n, 1)), bool)
        for s, r in enumerate(results):
            for f in range(F):
                pts = r["features"][f][c]
                xyz[s, f, :len(pts)] = pts
                mask[s, f, :len(pts)] = True
        feats[c] = (xyz, mask)
    return [out], {0: feats}


def control_numbers(refs, ctrls):
    """The check's numbers with the control's results in the program's
    place, over the sampled scenarios it ran on."""
    from pbench import check

    passes, feats = as_port(ctrls)
    no_limits = {n: float("inf") for n in check.NUMBERS}
    return check.compare(passes, feats, refs, range(len(refs)),
                         no_limits)[0]


def class_shares(port_f: dict, ref_f: dict) -> dict:
    """One frame's mismatch per feature class, over the reference's
    count of that class (check.feature_mismatch's terms)."""
    from pbench import check

    out = {}
    for c in check.EXACT_CLASSES:
        diff = len(check._rows(port_f[c]) ^ check._rows(ref_f[c]))
        out[c] = diff / max(len(ref_f[c]), 1)
    a, b = port_f["less_flat"], ref_f["less_flat"]
    out["less_flat"] = ((check._unmatched(a, b) + check._unmatched(b, a))
                        / max(len(b), 1))
    return out


def scenario_lines(port, feats, refs, sample):
    """Each sampled scenario's numbers (check.compare on it alone), with
    each feature class's largest share of a frame and the frame of the
    largest feature mismatch."""
    from pbench import check

    no_limits = {n: float("inf") for n in check.NUMBERS}
    lines = []
    for s, b in enumerate(sample):
        one = {p: {c: (x[s:s + 1], m[s:s + 1]) for c, (x, m) in f.items()}
               for p, f in feats.items()}
        numbers = check.compare(port, one, [refs[s]], [b], no_limits)[0]
        shares = []
        for f, ref_f in enumerate(refs[s]["features"]):
            port_f = {c: x[0, f][m[0, f]] for c, (x, m) in one[0].items()}
            shares.append(class_shares(port_f, ref_f))
        worst = max(range(len(shares)),
                    key=lambda f: sum(shares[f].values()))
        lines.append(dict(
            scenario=b, **numbers, worst_frame=worst,
            classes={c: max(sh[c] for sh in shares) for c in shares[0]}))
    return lines


def replay_seed(seed, with_control, with_fault, cell, cfg, references,
                device="cuda"):
    """One pass of the timed path on the seed's sweeps (and, with_fault,
    one of the program under SELECTION_FAULT); submits the reference
    (and the control) of its sampled scenarios."""
    import dataclasses

    import torch

    from pbench import cell as cellrun, gen, spans
    from loam_tpu_torch.parallel.replay import batched_replay

    raw, mask = gen.make_traffic(seed, cell.traffic, cell.config, device)
    sample = cellrun.sampled(seed, raw.shape[0],
                             int(cell.traffic["check_scenarios"]))
    runs = [cfg] + ([dataclasses.replace(cfg, **SELECTION_FAULT)]
                    if with_fault else [])
    replays = []
    for c in runs:
        with spans.Instrument(torch.tensor(sample, device=device),
                              False) as inst:
            out = batched_replay(raw, mask, c, device)
        replays.append(([cellrun._host(out)],
                        {0: {k: (x.cpu().numpy(), m.cpu().numpy())
                             for k, (x, m) in inst.features[0].items()}}))
        del out, inst
    for b in sample:
        b_raw, b_mask = raw[b].cpu().numpy(), mask[b].cpu().numpy()
        references.submit((b_raw, b_mask, False))
        if with_control:
            references.submit((b_raw, b_mask, True))
    del raw, mask
    return seed, sample, replays, with_control, len(sample)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--fault", type=int, default=3)
    p.add_argument("--workers", type=int, default=7)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT / "perfbench"))
    sys.path.insert(1, str(ROOT))
    import torch

    from pbench import cell as cellrun, check, spec

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.resolve(args.workload, ROOT)
    cfg = cellrun.loam_config(cell.config)
    seeds = [int(s) for s in args.seeds.split(",")]
    no_limits = {n: float("inf") for n in check.NUMBERS}
    pending = []
    with check.References([], args.workers) as references:
        for i, seed in enumerate(seeds):
            pending.append(replay_seed(seed, i < args.control,
                                       i < args.fault, cell, cfg,
                                       references))
            print(f"calibrate: seed {seed} replayed at "
                  f"{time.perf_counter() - T_START:.1f} s", file=sys.stderr,
                  flush=True)
        results = references.results()
    print(f"calibrate: references done at "
          f"{time.perf_counter() - T_START:.1f} s", file=sys.stderr)

    lower, upper, fault, cursor = {}, {}, {}, 0
    for seed, sample, replays, with_control, n in pending:
        step = 2 if with_control else 1
        mine = results[cursor:cursor + step * n]
        cursor += step * n
        refs = mine[::step]
        port, feats = replays[0]
        numbers, _ = check.compare(port, feats, refs, sample, no_limits)
        line = dict(seed=seed, sample=sample, program=numbers,
                    scenarios=scenario_lines(port, feats, refs, sample))
        for k, v in numbers.items():
            lower[k] = max(lower.get(k, 0.0), v)
        if with_control:
            ctrl = control_numbers(refs, mine[1::2])
            line["control"] = ctrl
            for k, v in ctrl.items():
                upper[k] = min(upper.get(k, float("inf")), v)
        if len(replays) > 1:
            f_port, f_feats = replays[1]
            f_numbers = check.compare(f_port, f_feats, refs, sample,
                                      no_limits)[0]
            line["selection_fault"] = f_numbers
            line["selection_fault_scenarios"] = scenario_lines(
                f_port, f_feats, refs, sample)
            for k, v in f_numbers.items():
                fault[k] = min(fault.get(k, float("inf")), v)
        print(json.dumps(line), flush=True)
    print(json.dumps(dict(workload=args.workload, seeds=len(seeds),
                          lower=lower, upper=upper,
                          selection_fault=fault,
                          card=torch.cuda.get_device_name(0))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
