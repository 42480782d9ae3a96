"""Find where a scenario of a batched replay departs from its single
replay on the card.

    python3 profile_torch_drift.py [--package DIR]

Runs bench.py's workload (chip_smoke.batch_sweeps, entry.bench_cfg: B=8
scenarios x F=17 full-density sweeps) through loam_tpu_torch on one
CUDA device and compares, bit for bit:

  1. the frontend's features: the B x F frame batch against each
     scenario's F frames, and scenario 0's F frames against each of its
     frames alone (the streaming engine's one-sweep call);
  2. the recurrent core frame by frame, the batch and the eight single
     states both fed the batch's features: every state field of every
     scenario after every frame;
  3. at the first frame whose states differ, every output of the traced
     functions (the residuals, Jacobians, normal equations, solves,
     neighbour searches, voxel aggregation, table insertion, pose
     algebra) in call order, batched against single, from the same
     state: the first call that differs names the op.

--package DIR imports loam_tpu_torch from another checkout (an unpacked
earlier commit that has loam_tpu_torch/entry.py) to compare two versions
on one card.  Prints the card's name and power limit on every line.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent

PHASE = ["step"]
LOG: list = []
DEPTH: dict = {}


def leaves(tree, prefix=""):
    """(name, tensor) pairs of a tree of dataclasses, tuples and dicts."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    if isinstance(tree, (tuple, list)):
        items = [(f"[{i}]", t) for i, t in enumerate(tree)]
    elif isinstance(tree, dict):
        items = [(f".{k}", t) for k, t in tree.items()]
    elif dataclasses.is_dataclass(tree):
        items = [(f".{f.name}", getattr(tree, f.name))
                 for f in dataclasses.fields(tree)]
    else:
        return []
    return [leaf for name, t in items for leaf in leaves(t, prefix + name)]


def gap(a, b) -> float:
    """Largest absolute difference (floats) or count of differences."""
    if not a.is_floating_point():
        return float((a != b).sum())
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def traced(modules):
    """Wrap the functions whose outputs the trace compares; returns the
    originals to restore."""
    odometry, mapping, map_store, residuals, linalg, rotations, KN = modules
    names = {
        odometry: ("_odom_residuals", "_odom_associate", "accumulate_pose",
                   "_project_cloud_to_end", "transform_to_start",
                   "odom_correspondences"),
        residuals: ("odom_point_jacobians", "normal_equations_accumulated",
                    "map_jacobian_rows", "normal_equations", "point_to_line",
                    "plane_from_tripod", "point_to_plane"),
        linalg: ("solve_sym6", "degeneracy_projector", "fit_plane5",
                 "eigh3x3"),
        mapping: ("_corner_map_residuals", "_surf_map_residuals",
                  "_downsample_cloud", "_sort_stack_axis", "knn_points"),
        rotations: ("apply_pose", "transform_associate_to_map"),
        map_store: ("aggregate_by_voxel", "table_insert", "local_map_points",
                    "local_cube_fov", "evict_outside_window",
                    "knn_from_candidates"),
        KN: ("recenter",),
    }
    saved = []
    for mod, fns in names.items():
        for name in fns:
            fn = getattr(mod, name)
            saved.append((mod, name, fn))

            def wrapper(*a, _fn=fn, _name=name, **kw):
                DEPTH[_name] = DEPTH.get(_name, 0) + 1
                try:
                    out = _fn(*a, **kw)
                finally:
                    DEPTH[_name] -= 1
                if DEPTH[_name] == 0:       # not a per-scenario inner call
                    LOG.append((PHASE[0], _name, [
                        (n, t.detach().clone()) for n, t in leaves(out)]))
                return out
            setattr(mod, name, wrapper)
    for mod, name, phase in ((odometry, "gauss_newton_odometry", "odom-gn"),
                             (mapping, "gauss_newton_mapping", "map-gn")):
        fn = getattr(mod, name)
        saved.append((mod, name, fn))

        def in_phase(*a, _fn=fn, _phase=phase, **kw):
            PHASE[0] = _phase
            try:
                return _fn(*a, **kw)
            finally:
                PHASE[0] = "step"
        setattr(mod, name, in_phase)
    return saved


def keyed(log):
    """Each call keyed by (phase, function, its count in that phase)."""
    seen, out = {}, []
    for phase, name, outs in log:
        seen[(phase, name)] = seen.get((phase, name), 0) + 1
        out.append(((phase, name, seen[(phase, name)]), outs))
    return out


def first_differing_call(step, modules, state, feats, B: int) -> list:
    """The batched step against each single step from the same state:
    per scenario, the first traced call whose output differs."""
    from loam_tpu_torch.types import tree_map

    saved = traced(modules)
    try:
        LOG.clear()
        step(state, feats)
        batched = dict(keyed(LOG))
        found = []
        for b in range(B):
            LOG.clear()
            one = lambda t: t[b:b + 1]  # noqa: E731
            step(tree_map(one, state), feats.map(one))
            for pos, (key, outs) in enumerate(keyed(LOG)):
                bad = [(n, gap(t[0], bt[b]))
                       for (n, t), (_, bt) in zip(outs, batched.get(key, []))
                       if t.dim() and bt.dim() and t.shape[0] == 1
                       and bt.shape[0] == B and t.shape[1:] == bt.shape[1:]
                       and gap(t[0], bt[b])]
                if bad:
                    found.append((b, pos, key, bad[:4]))
                    break
        return found
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def drift(dev, cfg, raw, msk, card: str) -> None:
    """Steps 1-3 of the module docstring for raw (B, F, N, 3), msk
    (B, F, N) on `dev`."""
    from loam_tpu_torch import (frontend, map_store, mapping, odometry,
                                pipeline)
    from loam_tpu_torch.ops import residuals
    from loam_tpu_torch.ops.cuda import knn_topk as KN
    from loam_tpu_torch.ops.features import extract_features
    from loam_tpu_torch.parallel import replay as PR
    from loam_tpu_torch.utils import linalg, rotations

    raw_t = torch.as_tensor(raw, device=dev)
    msk_t = torch.as_tensor(msk, device=dev)
    B, F = raw_t.shape[:2]

    # 1. the frontend
    batched = PR.batched_frontend(raw_t, msk_t, cfg, dev)
    single = [dict(leaves(extract_features(
        frontend.ingest_sweep(raw_t[b], msk_t[b], cfg), cfg)))
        for b in range(B)]
    alone = [dict(leaves(extract_features(
        frontend.ingest_sweep(raw_t[0, k], msk_t[0, k], cfg), cfg)))
        for k in range(F)]
    for name, t in leaves(batched):
        scen = max(gap(t[b], single[b][name]) for b in range(B))
        one = max(gap(single[0][name][k], alone[k][name]) for k in range(F))
        print(f"  features{name}: B x F frames vs each scenario's F "
              f"{scen:.3g}; F frames vs one frame {one:.3g} [{card}]",
              flush=True)

    # 2. the core frame by frame on the batch's features, 3. the trace
    step = lambda s, f: pipeline._step(s, f, cfg, None, None, None)  # noqa
    state = PR.batched_initial_state(B, cfg, dev)
    states = [pipeline.PipelineState.create(cfg, dev, batch=1)
              for _ in range(B)]
    for k in range(F):
        feats = batched.map(lambda t: t[:, k])
        before = state
        state, out = step(state, feats)
        differ = []
        for b in range(B):
            states[b], _ = step(states[b], feats.map(lambda t: t[b:b + 1]))
            differ += [(n, b, gap(t[b], s[0])) for (n, t), (_, s) in
                       zip(leaves(state), leaves(states[b]))
                       if gap(t[b], s[0])]
        print(f"  frame {k} (mapping {bool(out.mapped.any())}): "
              f"{len(differ)} state fields differ "
              f"{sorted(differ, key=lambda d: -d[2])[:4]} [{card}]",
              flush=True)
        if differ:
            modules = (odometry, mapping, map_store, residuals, linalg,
                       rotations, KN)
            for b, pos, key, bad in first_differing_call(
                    step, modules, before, feats, B):
                print(f"    scenario {b}: call #{pos} {key} differs "
                      f"{bad} [{card}]", flush=True)
            return


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", help="checkout to import loam_tpu_torch "
                    "from")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_drift: no CUDA device")
    if args.package:
        sys.path.insert(0, str(Path(args.package).resolve()))
    sys.path.append(str(ROOT))
    import chip_smoke as CS
    import loam_tpu_torch
    from loam_tpu_torch import configure_numerics
    from loam_tpu_torch.entry import bench_cfg
    from loam_tpu_torch.ops.cuda import _build

    card = CS.card_line()
    t0 = time.perf_counter()
    configure_numerics()
    _build.build_all()
    raw, msk, _ = CS.batch_sweeps()
    print(f"drift: loam_tpu_torch from {Path(loam_tpu_torch.__file__).parent}"
          f", B={raw.shape[0]} x F={raw.shape[1]} [{card}]", flush=True)
    drift(torch.device("cuda", 0), bench_cfg(), raw, msk, card)
    print(f"drift: {time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
