"""Shared helpers for the loam_tpu_torch parity tests: one NumPy input,
both packages, outputs compared as NumPy arrays.  Importing this module
imports neither jax nor loam_tpu (parity_cfg does, when called)."""

from __future__ import annotations

import bz2
import ctypes
import dataclasses
import struct

import numpy as np
import torch

from loam_tpu_torch.config import LoamConfig as PortConfig
from loam_tpu_torch.io import synth
from loam_tpu_torch.ops.cuda import select_walk as SW


def tree_to_numpy(obj):
    """A (JAX or torch) dataclass tree as nested dicts of NumPy arrays."""
    if dataclasses.is_dataclass(obj):
        return {f.name: tree_to_numpy(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    return np.asarray(obj)


def cloud_to_torch(cloud, cls):
    """A JAX PointCloud (any leading axes) as a port PointCloud."""
    return cls(xyz=torch.tensor(np.asarray(cloud.xyz)),
               rel=torch.tensor(np.asarray(cloud.rel)),
               mask=torch.tensor(np.asarray(cloud.mask)))


def feats_to_torch(feats):
    from loam_tpu_torch.types import FeatureClouds, PointCloud

    return FeatureClouds(**{
        f.name: cloud_to_torch(getattr(feats, f.name), PointCloud)
        for f in dataclasses.fields(feats)
    })


def parity_cfg(**kw):
    """The tiny test configuration (__graft_entry__._tiny_cfg, a
    loam_tpu LoamConfig) with rings wide enough for 480-azimuth sweeps:
    at the tiny 256-wide rings the sparse azimuth spacing trips the
    parallel-beam filter on every point and no feature is ever
    selected."""
    from __graft_entry__ import _tiny_cfg

    base = dict(ring_width=512, max_less_flat=2048, less_flat_ring_cap=256)
    base.update(kw)
    return dataclasses.replace(_tiny_cfg(), **base)


# configurations that the port refused before any frame while its
# neighbour kernels were built for k in (1, 5, 8), kselect for k <= 32
# and C <= 1024: (test id, config changes), one each for the strict
# exact k-NN, the hybrid gather, and the cell path's gather at k > 32
# and at C > 1024
WIDE_K = (
    ("strict", dict(map_knn=3)),
    ("hybrid", dict(map_exact_regather_every=5, map_exact_cache_k=12)),
    ("cells_k", dict(map_exact_knn=False, knn_candidates=40)),
    ("cells_C", dict(map_exact_knn=False, search_bucket_cap=40)),
)

# configurations the port refuses up front, with a pattern of the
# ValueError that names the limit: (test id, config changes, pattern).
# The cell path's re-rank at k > C, which loam_tpu's lax.top_k refuses
# too, and the limits of the kernels: rings of more than 8192 points,
# an exact k past the widest warp queue, C past kselect's MAX_C, a
# suppression reach past the walk's two words a pick
REFUSED = (
    ("cells_rerank", dict(map_exact_knn=False, knn_candidates=4),
     r"map_knn=5 from C=knn_candidates=4 .*1 <= k <= C <= 17880"),
    ("ring_width", dict(ring_width=8224),
     r"ring_width=8224: .*at most 8192 points"),
    ("exact_k", dict(map_knn=1025), r"map_knn=1025 .*1 <= k <= 1024"),
    ("cells_row", dict(map_exact_knn=False, search_bucket_cap=663),
     r"C=17901 .*1 <= k <= C <= 17880"),
    ("suppress", dict(suppress_neighbors=17),
     r"suppress_neighbors=17: .*at most 16 neighbours a side"),
)
REFUSED_IDS = [case[0] for case in REFUSED]


def to_port_cfg(jcfg) -> PortConfig:
    """The port's LoamConfig with the fields of a loam_tpu one."""
    return PortConfig(**dataclasses.asdict(jcfg))


def make_sweeps(frames: int, seed: int = 3, n_azimuth: int = 480,
                speed: float = 0.9, yaw_rate: float = 0.12,
                scan_period: float = 0.1):
    """Seeded synthetic VLP-16 sweeps (F, N, 3), masks (F, N), poses; a
    sweep lasts scan_period seconds."""
    world = synth.make_world(seed=seed)
    poses = synth.straight_trajectory(frames, speed=speed, yaw_rate=yaw_rate,
                                      scan_period=scan_period)
    poses = np.vstack([poses[:1], poses])[: frames + 1]
    sweeps = [synth.simulate_sweep(world, poses[k], poses[k + 1],
                                   n_azimuth=n_azimuth, seed=seed + k)
              for k in range(frames)]
    raw = np.stack([s[0] for s in sweeps]).astype(np.float32)
    msk = np.stack([s[1] for s in sweeps])
    return raw, msk, poses


def small_config() -> PortConfig:
    """The port's configuration for a few sweeps of make_sweeps: rings of
    512, small tables and caps, five odometry iterations."""
    return dataclasses.replace(
        PortConfig(), ring_width=512, max_less_flat=2048,
        less_flat_ring_cap=256, corner_table_size=1 << 12,
        surf_table_size=1 << 13, search_buckets=1 << 10,
        max_corner_from_map=1024, max_surf_from_map=2048,
        max_corner_stack=512, max_surf_stack=1024, odom_max_iters=5)


def pose_errors(a, b):
    """Max |rotation| (rad) and |translation| (m) differences of (..., 6)
    pose arrays."""
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return float(d[..., :3].max()), float(d[..., 3:].max())


def _table_set(key_hi, key_lo, centroids):
    key_hi = np.asarray(key_hi).astype(np.int64)
    live = key_hi != 0xFFFFFFFF
    keys = key_hi[live] * (1 << 32) + np.asarray(key_lo).astype(np.int64)[live]
    return dict(zip(keys.tolist(), np.asarray(centroids)[live]))


def assert_same_map(jtable, ttable):
    """A JAX and a port VoxelTable hold the same keys with centroids
    within 1e-4 m (slot order is not part of the contract).  Returns the
    number of live entries."""
    a = _table_set(jtable.key_hi, jtable.key_lo, jtable.centroids())
    b = _table_set(ttable.key_hi.numpy(), ttable.key_lo.numpy(),
                   ttable.centroids().numpy())
    assert a.keys() == b.keys()
    keys = sorted(a)
    np.testing.assert_allclose(np.array([b[k] for k in keys]),
                               np.array([a[k] for k in keys]), atol=1e-4)
    return len(keys)


# ---- tie-heavy inputs and scalar references for the neighbour kernels

def lattice(rng, shape, half: int = 2):
    """Coordinates on a 0.25 m lattice: many exactly equal distances."""
    return (rng.integers(-half, half + 1, size=shape) * 0.25).astype(
        np.float32)


def sq_dists_np(a, b):
    """float32 round(round(dx^2 + dy^2) + dz^2) of a - b, the kernels'
    order; a and b broadcast to (..., 3)."""
    d = (a - b).astype(np.float32)
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + \
        d[..., 2] * d[..., 2]


def windowed_knn_case(tq: int, tm: int, seed: int = 0):
    """Three lattice problems over 8 query blocks and 8 reference tiles.
    Problem 0: five live blocks, the last with rows past n_q; block 1 sees
    3 references (the ragged last tile), block 2 an empty window, block 4
    a window that needs both clamps; blocks 5-7 are dead.  Problem 1: no
    live reference.  Problem 2: one live query, every reference live.
    Returns NumPy arrays (q, ref, n_q, n_ref, t_lo, t_hi)."""
    rng = np.random.default_rng(seed)
    B, nqb, tiles = 3, 8, 8
    Q, M = nqb * tq, tiles * tm
    q, ref = lattice(rng, (B, Q, 3)), lattice(rng, (B, M, 3))
    n_q = np.array([4 * tq + tq // 2 + 1, Q, 1], np.int32)
    n_ref = np.array([7 * tm + 3, 0, M], np.int32)
    t_lo = rng.integers(0, 3, (B, nqb)).astype(np.int32)
    t_hi = rng.integers(4, tiles + 1, (B, nqb)).astype(np.int32)
    t_lo[0, :5] = (0, 7, 3, 2, -1)
    t_hi[0, :5] = (8, 8, 3, 5, 99)
    return q, ref, n_q, n_ref, t_lo, t_hi


def windowed_knn_scalar(q, ref, n_q, n_ref, t_lo, t_hi, k, tq, tm):
    """The contract of ops/cuda/knn_topk one row at a time: the k smallest
    (distance, index) pairs of the references a row's block sees, else
    (0, 1e30).  Returns (idx, d2)."""
    B, Q, _ = q.shape
    M, nqb = ref.shape[1], Q // tq
    idx = np.zeros((B, Q, k), np.int32)
    d2 = np.full((B, Q, k), 1e30, np.float32)
    for b in range(B):
        live_blocks = min(max(-(-int(n_q[b]) // tq), 1), nqb)
        for i in range(live_blocks * tq):
            blk = i // tq
            j = np.arange(M)
            j = j[(j < n_ref[b]) & (j // tm >= t_lo[b, blk])
                  & (j // tm < t_hi[b, blk])]
            d = sq_dists_np(q[b, i], ref[b, j])
            best = np.lexsort((j, d))[:k]
            idx[b, i, :len(best)] = j[best]
            d2[b, i, :len(best)] = d[best]
    return idx, d2


def kselect_lattice_case(Q: int, C: int, k: int, seed: int = 0):
    """Lattice candidates around lattice queries, about 70% valid; every
    fifth row has fewer than k valid candidates, every eleventh none.
    Returns NumPy arrays (cand, valid, q)."""
    rng = np.random.default_rng(seed + C)
    cand = lattice(rng, (Q, C, 3), half=3)
    valid = rng.uniform(size=(Q, C)) < 0.7
    valid[::5, k - 2:] = False
    valid[::11] = False
    return cand, valid, lattice(rng, (Q, 3))


def kselect_argsort(cand, valid, q, k):
    """The contract of ops/cuda/kselect by a stable argsort of the float32
    distances (1e30 where invalid).  Returns (pts, d2)."""
    d = np.where(valid, sq_dists_np(cand, q[:, None, :]),
                 np.float32(1e30)).astype(np.float32)
    order = np.argsort(d, axis=1, kind="stable")[:, :k]
    return (np.take_along_axis(cand, order[..., None], 1),
            np.take_along_axis(d, order, 1))


# ---- the selection walk: constructed meta and a serial reference

WALK_KINDS = ("overflow", "picked_runs", "stop_first", "short_ring",
              "edges", "random")


def walk_kwargs(cfg, W: int, corner_k: int = 0, flat_k: int = 0) -> dict:
    """Keyword arguments of ops/cuda/select_walk for rings of width W, the
    corner and flat walks cut at corner_k and flat_k candidates (0: the
    whole subregion)."""
    return dict(n_sub=cfg.n_subregions, subw=W // cfg.n_subregions + 8, W=W,
                max_sharp=cfg.max_sharp_per_subregion,
                max_less_sharp=cfg.max_less_sharp_per_subregion,
                max_flat=cfg.max_flat_per_subregion, corner_k=corner_k,
                flat_k=flat_k)


def walk_meta_case(B: int, R: int, W: int, n_sub: int = 6, seed: int = 0,
                   reach: int = 5):
    """Constructed walk inputs for B x R rings of width W in the layout of
    features.walk_meta (subregion j walks indices j*(W/n_sub) + [0, subw),
    those past W-1 clamped to it and not in-span, reaches clipped at the
    ring ends), ring g = b*R + r of kind WALK_KINDS[g % 6]:
      overflow     every candidate qualifies and suppresses only itself:
                   each corner walk overflows at its 21st, each flat walk
                   stops at its 4th pick;
      picked_runs  most of each subregion pre-picked and walked in index
                   order: 80+ picked candidates before the first pick;
      stop_first   each walk's first (flat: second) candidate stops it;
      short_ring   no in-span candidate (a ring under 12 points);
      edges        reaches of `reach` (across words and into the next
                   subregion), index W-1 first in the last subregion's
                   walks, bit-31 candidates next, bit 31 of every other
                   word pre-picked;
      random       random stops, reaches up to `reach` and pre-picks.
    Returns NumPy corner_meta, flat_meta (B, R, n_sub*subw) int32, picked0
    (B, R, W) bool and the kind index of each ring (B, R)."""
    rng = np.random.default_rng(seed)
    span, subw = W // n_sub, W // n_sub + 8
    N = B * R
    metas = np.zeros((2, N, n_sub, subw), np.int32)
    picked0 = np.zeros((N, W), bool)
    kinds = np.arange(N) % len(WALK_KINDS)
    for g in range(N):
        kind = WALK_KINDS[kinds[g]]
        if kind in ("stop_first", "short_ring", "random"):
            picked0[g] = rng.uniform(size=W) < 0.05
        elif kind == "edges":
            picked0[g, 31::64] = True
        for j in range(n_sub):
            idx = j * span + np.arange(subw)
            if kind == "picked_runs":
                picked0[g, j * span:j * span + min(subw - 12, 200)] = True
            for s in range(2):                      # 0 corner, 1 flat
                live = idx <= W - 1
                order = rng.permutation(subw)
                if kind == "picked_runs":
                    order = np.arange(subw)
                elif kind == "edges":
                    key = np.where(idx == W - 1, -1,
                                   np.where(idx % 32 == 31, 0, 2))
                    order = np.argsort(key, kind="stable")
                order = np.concatenate([order[live[order]],
                                        order[~live[order]]])
                ind = np.minimum(idx[order], W - 1)
                valid = live[order] & (kind != "short_ring")
                qual = np.ones(subw, bool)
                if kind == "stop_first":
                    (qual if s == 0 else valid)[s] = False
                elif kind == "random":
                    stop = rng.integers(0, subw + 1)
                    (qual if stop % 2 else valid)[stop:] = False
                fixed = reach if kind == "edges" else 0 \
                    if kind == "overflow" else None
                up, dn = (np.full(subw, fixed) if fixed is not None
                          else rng.integers(0, reach + 1, subw)
                          for _ in range(2))
                up, dn = np.minimum(up, W - 1 - ind), np.minimum(dn, ind)
                metas[s, g, j] = SW.pack_walk_meta(*(
                    torch.tensor(a) for a in (ind, valid, qual, up, dn)
                )).numpy()
    cm, fm = (m.reshape(B, R, n_sub * subw) for m in metas)
    return cm, fm, picked0.reshape(B, R, W), kinds.reshape(B, R)


def serial_walk(corner_meta, flat_meta, picked0, *, n_sub, subw, W,
                max_sharp, max_less_sharp, max_flat, corner_k=0, flat_k=0):
    """The contract of ops/cuda/select_walk one ring and one candidate at a
    time (src/scanRegistration.cpp:477-541).  corner_meta/flat_meta
    (N, n_sub*subw) int32, picked0 (N, W) bool.  Returns the (sharp,
    less_sharp, flat, picked) masks, each (N, W) bool, and per ring (N,)
    int64 counts: `walked` candidates (meta words read), labelled `picks`,
    and `rounds` of the one-warp-a-ring kernel (32-candidate chunks plus
    picks)."""
    N = corner_meta.shape[0]
    fields = np.zeros((4, N, W), bool)
    fields[3] = picked0
    counts = {k: np.zeros(N, np.int64) for k in ("walked", "picks",
                                                  "rounds")}
    for i in range(N):
        sharp, less, flat, picked = fields[:, i]
        for j in range(n_sub):
            for corner in (True, False):
                meta = (corner_meta if corner else flat_meta)[
                    i, j * subw:(j + 1) * subw].tolist()
                depth = corner_k if corner else flat_k
                cnt = steps = picks = 0
                for m in meta[:subw if depth <= 0 else min(depth, subw)]:
                    steps += 1
                    ind = m & SW._IND_MASK
                    up = (m >> SW._UP_SHIFT) & SW._REACH_MASK
                    dn = (m >> SW._DN_SHIFT) & SW._REACH_MASK
                    if not ((m >> SW._VALID_SHIFT) & 1
                            and (m >> SW._QUAL_SHIFT) & 1):
                        break                     # processed, then stop
                    if picked[ind]:
                        continue
                    cnt += 1
                    if corner and cnt > max_less_sharp:
                        break                     # counted, not labelled
                    picks += 1
                    if corner:
                        (sharp if cnt <= max_sharp else less)[ind] = True
                    else:
                        flat[ind] = True
                        if cnt >= max_flat:
                            break                 # before its suppression
                    picked[max(ind - dn, 0):ind + up + 1] = True
                counts["walked"][i] += steps
                counts["picks"][i] += picks
                counts["rounds"][i] += -(-steps // 32) + picks
    return tuple(fields), counts


# ---- a minimal rosbag 2.0 writer (a copy of tests/test_rosbag.py's,
# which imports loam_tpu), and the raw IMU messages of a trajectory

def _field(name: bytes, value: bytes) -> bytes:
    body = name + b"=" + value
    return struct.pack("<I", len(body)) + body


def _record(header_fields: dict, data: bytes) -> bytes:
    hdr = b"".join(_field(k, v) for k, v in header_fields.items())
    return struct.pack("<I", len(hdr)) + hdr + struct.pack("<I", len(data)) + data


def _header_dict(fields: dict) -> bytes:
    return b"".join(_field(k, v) for k, v in fields.items())


def _std_header(stamp: float, frame: bytes = b"velodyne") -> bytes:
    sec = int(stamp)
    nsec = int(round((stamp - sec) * 1e9))
    return (struct.pack("<I", 0) + struct.pack("<II", sec, nsec)
            + struct.pack("<I", len(frame)) + frame)


def pointcloud2(stamp, xyz, ring=None, rel=None) -> bytes:
    """A sensor_msgs/PointCloud2 message body: x, y, z float32, optional
    uint16 ring and float32 time fields."""
    n = xyz.shape[0]
    fields = [(b"x", 0, 7, 1), (b"y", 4, 7, 1), (b"z", 8, 7, 1)]
    step = 12
    if ring is not None:
        fields.append((b"ring", step, 4, 1))  # UINT16
        step += 2
    if rel is not None:
        fields.append((b"time", step, 7, 1))  # FLOAT32
        step += 4
    buf = bytearray(n * step)
    for i in range(n):
        o = i * step
        struct.pack_into("<fff", buf, o, *xyz[i])
        o += 12
        if ring is not None:
            struct.pack_into("<H", buf, o, int(ring[i]))
            o += 2
        if rel is not None:
            struct.pack_into("<f", buf, o, float(rel[i]))
    msg = _std_header(stamp)
    msg += struct.pack("<II", 1, n)          # height, width
    msg += struct.pack("<I", len(fields))
    for name, off, dtype, cnt in fields:
        msg += struct.pack("<I", len(name)) + name
        msg += struct.pack("<IBI", off, dtype, cnt)
    msg += struct.pack("<B", 0)              # is_bigendian
    msg += struct.pack("<II", step, step * n)
    msg += struct.pack("<I", len(buf)) + bytes(buf)
    msg += struct.pack("<B", 1)              # is_dense
    return msg


def imu_message(stamp, quat, ang_vel, lin_acc) -> bytes:
    """A sensor_msgs/Imu message body (zero covariances)."""
    msg = _std_header(stamp, b"imu")
    msg += struct.pack("<4d", *quat)
    msg += struct.pack("<9d", *([0.0] * 9))
    msg += struct.pack("<3d", *ang_vel)
    msg += struct.pack("<9d", *([0.0] * 9))
    msg += struct.pack("<3d", *lin_acc)
    msg += struct.pack("<9d", *([0.0] * 9))
    return msg


def connection(conn_id, topic: bytes, typ: bytes) -> bytes:
    data = _header_dict({
        b"topic": topic, b"type": typ,
        b"md5sum": b"0" * 32, b"message_definition": b"",
    })
    return _record(
        {b"op": b"\x07", b"conn": struct.pack("<I", conn_id),
         b"topic": topic},
        data,
    )


def message(conn_id, stamp, payload: bytes) -> bytes:
    sec = int(stamp)
    nsec = int(round((stamp - sec) * 1e9))
    return _record(
        {b"op": b"\x02", b"conn": struct.pack("<I", conn_id),
         b"time": struct.pack("<II", sec, nsec)},
        payload,
    )


def lz4_frame(data: bytes) -> bytes:
    """data as one LZ4 frame (what rosbag's roslz4 writes), by the system's
    liblz4.so.1 over ctypes; OSError where that library is missing."""
    lib = ctypes.CDLL("liblz4.so.1")
    lib.LZ4F_compressFrameBound.restype = ctypes.c_size_t
    lib.LZ4F_compressFrameBound.argtypes = (ctypes.c_size_t, ctypes.c_void_p)
    lib.LZ4F_compressFrame.restype = ctypes.c_size_t
    lib.LZ4F_compressFrame.argtypes = (ctypes.c_void_p, ctypes.c_size_t,
                                       ctypes.c_char_p, ctypes.c_size_t,
                                       ctypes.c_void_p)
    lib.LZ4F_isError.argtypes = (ctypes.c_size_t,)
    dst = ctypes.create_string_buffer(
        lib.LZ4F_compressFrameBound(len(data), None))
    n = lib.LZ4F_compressFrame(dst, len(dst), data, len(data), None)
    if lib.LZ4F_isError(n):
        raise RuntimeError("LZ4F_compressFrame failed")
    return dst.raw[:n]


def write_bag(path, messages, compression=b"none"):
    """messages: list of (conn_records, msg_records) flattened bytes that
    go inside one chunk (compression none, bz2 or lz4: an LZ4 frame)."""
    chunk_body = b"".join(messages)
    if compression == b"bz2":
        comp = bz2.compress(chunk_body)
    elif compression == b"lz4":
        comp = lz4_frame(chunk_body)
    else:
        comp = chunk_body
    with open(path, "wb") as f:
        f.write(b"#ROSBAG V2.0\n")
        f.write(_record(
            {b"op": b"\x03",
             b"index_pos": struct.pack("<Q", 0),
             b"conn_count": struct.pack("<I", 2),
             b"chunk_count": struct.pack("<I", 1)},
            b" " * 4096,
        ))
        f.write(_record(
            {b"op": b"\x05", b"compression": compression,
             b"size": struct.pack("<I", len(chunk_body))},
            comp,
        ))


def write_sweep_bag(path, sweeps, stamps, imu=None):
    """A bag of lidar sweeps on /velodyne_points (each (xyz, mask); the
    valid points only, without ring or time fields) and, given imu =
    (t, quat xyzw, lin_acc), the IMU stream on /imu/data."""
    recs = [connection(0, b"/velodyne_points", b"sensor_msgs/PointCloud2")]
    if imu is not None:
        recs.append(connection(1, b"/imu/data", b"sensor_msgs/Imu"))
    for (xyz, m), stamp in zip(sweeps, stamps):
        recs.append(message(0, float(stamp),
                            pointcloud2(float(stamp), xyz[m])))
    if imu is not None:
        for t, q, a in zip(*imu):
            recs.append(message(1, float(t), imu_message(
                float(t), q, [0.0, 0.0, 0.0], a)))
    write_bag(path, recs)


def rpy_to_quat(rpy):
    """(M, 3) (roll, pitch, yaw) -> (M, 4) xyzw, the ZYX quaternion that
    rosbag.quat_to_rpy decodes back (|pitch| < pi/2)."""
    h = np.asarray(rpy, np.float64) / 2
    cr, sr = np.cos(h[:, 0]), np.sin(h[:, 0])
    cp, sp = np.cos(h[:, 1]), np.sin(h[:, 1])
    cy, sy = np.cos(h[:, 2]), np.sin(h[:, 2])
    return np.stack([sr * cp * cy - cr * sp * sy,
                     cr * sp * cy + sr * cp * sy,
                     cr * cp * sy - sr * sp * cy,
                     cr * cp * cy + sr * sp * sy], -1)


def imu_samples(pose_fn, t_end: float, rate: float = 200.0):
    """The noise-free IMU stream of a trajectory from t=0 to t_end at
    `rate` Hz: orientation (pitch, yaw, roll) straight from the
    trajectory, body-frame coordinate acceleration from central
    differences (the post-gravity-removal quantities of
    scanRegistration.cpp:643-647).  Returns (t, pyr, acc)."""
    imu_t = np.arange(0.0, t_end, 1.0 / rate)
    h = 1e-3
    rpy = np.zeros((imu_t.shape[0], 3))
    acc = np.zeros((imu_t.shape[0], 3))
    for i, t in enumerate(imu_t):
        p = pose_fn(t)
        rpy[i] = p[:3]  # (pitch, yaw, roll) == (rx, ry, rz)
        a_w = (pose_fn(t + h)[3:6] - 2 * p[3:6] + pose_fn(t - h)[3:6]) / h**2
        R, _ = synth._pose_matrix(p)
        acc[i] = R.T @ a_w
    return imu_t, rpy, acc


def raw_imu(pyr, acc_int, g: float = 9.81):
    """The raw sensor_msgs/Imu content of internal-frame IMU samples:
    pyr (M, 3) (pitch, yaw, roll) and acc_int (M, 3) the gravity-removed
    internal-frame acceleration -> (roll, pitch, yaw) and the
    velodyne-frame acceleration, inverting imu_from_raw's gravity
    removal and axis swap (src/scanRegistration.cpp:638-652)."""
    pyr = np.asarray(pyr, np.float64)
    acc_int = np.asarray(acc_int, np.float64)
    pitch, yaw, roll = pyr[:, 0], pyr[:, 1], pyr[:, 2]
    acc = np.stack([
        acc_int[:, 2] - np.sin(pitch) * g,
        acc_int[:, 0] + np.sin(roll) * np.cos(pitch) * g,
        acc_int[:, 1] + np.cos(roll) * np.cos(pitch) * g,
    ], -1)
    return np.stack([roll, pitch, yaw], -1), acc


def paced_engine_run(eng, raw, msk, t_scans=None, imu=None):
    """A started streaming engine fed one sweep at a time, the IMU
    samples (t, rpy, acc) up to the sweep's window end pushed first as
    the command line interleaves them, with drain() after each sweep.
    Without t_scans (and imu) each sweep is stamped by the engine's own
    clock.  Returns (odom (F, 6), aft (F, 6),
    integrated (F, 6)): the latest odometry and aft-mapped poses read
    after each frame, and the integrated trajectory."""
    odom, aft = [], []
    cursor = 0
    for k in range(raw.shape[0]):
        t_scan = None if t_scans is None else float(t_scans[k])
        while imu is not None and cursor < imu[0].shape[0] and \
                imu[0][cursor] <= t_scan + eng.cfg.scan_period + 0.05:
            eng.push_imu(*(a[cursor] for a in imu))
            cursor += 1
        eng.push_sweep(raw[k], msk[k], t_scan)
        if not eng.drain(timeout_s=600):
            raise AssertionError(f"frame {k}: the engine did not drain")
        odom.append(eng.latest_odom())
        aft.append(eng.latest_aft())
    return np.stack(odom), np.stack(aft), eng.trajectory()


def online_rule_replay(raw, msk, cfg, device, streams=None, t_scans=None):
    """replay_sweeps' frames (the same batched frontend, then one
    pipeline_step a frame), and the pose the streaming engine integrates
    at each frame: transform_associate_to_map of the frame's odometry
    pose with the bef/aft pair that held before the frame (the last
    mapping frame that has finished).  Returns (FrameOutput with a
    leading F axis, online integrated poses (F, 6))."""
    from loam_tpu_torch import pipeline
    from loam_tpu_torch.ops.features import extract_features
    from loam_tpu_torch.types import tree_map
    from loam_tpu_torch.utils import rotations

    raw_t = torch.as_tensor(raw, dtype=torch.float32).to(device)
    msk_t = torch.as_tensor(msk, dtype=torch.bool).to(device)
    sweeps, imu_trans, map_rpy = pipeline.ingest_frames(
        raw_t, msk_t, cfg, streams, t_scans)
    feats = extract_features(sweeps, cfg)
    state = pipeline.PipelineState.create(cfg, device)
    outs, online = [], []
    for k in range(raw_t.shape[0]):
        before = state.map
        state, out = pipeline.pipeline_step(
            state, feats.map(lambda t: t[k]), cfg,
            imu=tree_map(lambda t: t[k], imu_trans),
            map_rpy=None if map_rpy is None else map_rpy[k])
        outs.append(out)
        online.append(rotations.transform_associate_to_map(
            out.pose_odom, before.transform_bef, before.transform_aft))
    return (tree_map(lambda *ts: torch.stack(ts), *outs),
            torch.stack(online))


def masked_imu_windows(frames: int, capacity: int = 256, device="cpu"):
    """All-masked IMU windows (an ImuStream with a leading frame axis):
    what the streaming engine's frontend integrates when no IMU sample
    was pushed."""
    from loam_tpu_torch import imu as imu_mod

    z = lambda *s: torch.zeros(s, device=device)
    return imu_mod.imu_from_raw(
        z(frames, capacity), z(frames, capacity, 3), z(frames, capacity, 3),
        torch.zeros((frames, capacity), dtype=torch.bool, device=device))
