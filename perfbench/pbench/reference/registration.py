"""scanRegistration oracle: NumPy transcription of laserCloudHandler
(src/scanRegistration.cpp:211-635), no-IMU path.

Input: one raw Velodyne sweep in firing order (N, 3) + validity mask
(stands in for pcl::removeNaNFromPointCloud, :226-228).
Output: the five published clouds as (xyz (n,3), intensity (n,)) pairs in
the reference's exact push order.
"""

from __future__ import annotations

import dataclasses

import numpy as np

N_SCANS = 16
SCAN_PERIOD = 0.1


@dataclasses.dataclass
class Cloud:
    xyz: np.ndarray        # (n, 3) internal frame (z fwd, x left, y up)
    intensity: np.ndarray  # (n,) scanID + scanPeriod * relTime

    def __len__(self):
        return self.xyz.shape[0]

    def copy(self):
        return Cloud(self.xyz.copy(), self.intensity.copy())


def voxel_grid(cloud: Cloud, leaf: float) -> Cloud:
    """pcl::VoxelGrid centroid filter (setLeafSize(leaf), filter()):
    per-voxel centroid of ALL fields (xyz and intensity), output in
    ascending linear voxel-index order (pcl/filters/voxel_grid.hpp
    semantics used at src/scanRegistration.cpp:576-579)."""
    if len(cloud) == 0:
        return Cloud(np.zeros((0, 3), np.float32), np.zeros(0, np.float32))
    inv = 1.0 / leaf
    ijk = np.floor(cloud.xyz.astype(np.float64) * inv).astype(np.int64)
    min_b = ijk.min(axis=0)
    rel = ijk - min_b
    div = rel.max(axis=0) + 1
    lin = rel[:, 0] + rel[:, 1] * div[0] + rel[:, 2] * (div[0] * div[1])
    uniq, inverse = np.unique(lin, return_inverse=True)
    k = uniq.shape[0]
    cnt = np.bincount(inverse, minlength=k).astype(np.float64)
    sx = np.stack(
        [np.bincount(inverse, weights=cloud.xyz[:, a], minlength=k)
         for a in range(3)],
        axis=1,
    )
    si = np.bincount(inverse, weights=cloud.intensity, minlength=k)
    return Cloud(
        (sx / cnt[:, None]).astype(np.float32),
        (si / cnt).astype(np.float32),
    )


class ImuOracle:
    """scanRegistration's IMU state: the circular sample buffer with
    dead-reckoned velocity/shift (src/scanRegistration.cpp:
    68-99,173-209,638-660) plus the per-sweep start/cur deskew state.

    Append-only arrays stand in for the 200-entry circular buffer —
    equivalent while queries stay within the buffered horizon (true here:
    every query targets the current sweep and samples arrive just ahead
    of it).  All state math is float32, like the reference's float
    globals.
    """

    def __init__(self):
        self.t: list[float] = []
        self.rpy: list[np.ndarray] = []     # (pitch, yaw, roll)
        self.velo: list[np.ndarray] = []
        self.shift: list[np.ndarray] = []
        # sweep-persistent start/cur state (the C++ globals :72-81)
        self.rpy_start = np.zeros(3, np.float32)
        self.rpy_cur = np.zeros(3, np.float32)
        self.velo_start = np.zeros(3, np.float32)
        self.shift_start = np.zeros(3, np.float32)
        self.shift_from_start_cur = np.zeros(3, np.float32)
        self.velo_from_start_cur = np.zeros(3, np.float32)

    def add(self, t: float, pitch: float, yaw: float, roll: float,
            acc_internal: np.ndarray):
        """imuHandler + AccumulateIMUShift (:173-209,638-660).
        acc_internal: gravity-removed internal-frame (accX, accY, accZ)
        — i.e. AFTER the :645-647 conversion."""
        acc = np.asarray(acc_internal, np.float32)
        r, p, y = np.float32(roll), np.float32(pitch), np.float32(yaw)
        # world acc = Ry(yaw) Rx(pitch) Rz(roll) acc  (:181-192)
        x1 = np.cos(r) * acc[0] - np.sin(r) * acc[1]
        y1 = np.sin(r) * acc[0] + np.cos(r) * acc[1]
        z1 = acc[2]
        x2 = x1
        y2 = np.cos(p) * y1 - np.sin(p) * z1
        z2 = np.sin(p) * y1 + np.cos(p) * z1
        aw = np.array(
            [np.cos(y) * x2 + np.sin(y) * z2, y2,
             -np.sin(y) * x2 + np.cos(y) * z2], np.float32
        )
        if self.t:
            dt = np.float32(t - self.t[-1])
            if dt < SCAN_PERIOD:
                v0 = self.velo[-1]
                self.shift.append(
                    self.shift[-1] + v0 * dt + aw * dt * dt / 2
                )
                self.velo.append(v0 + aw * dt)
            else:
                # gap guard (:196-207): freeze velocity/shift
                self.shift.append(self.shift[-1].copy())
                self.velo.append(self.velo[-1].copy())
        else:
            self.shift.append(np.zeros(3, np.float32))
            self.velo.append(np.zeros(3, np.float32))
        self.t.append(float(t))
        self.rpy.append(np.array([pitch, yaw, roll], np.float32))

    def _interp(self, tq):
        """The pointer-walk interpolation (:288-332) for query times tq
        (vectorized searchsorted — the walk only moves forward and our
        queries are nondecreasing).  Returns (rpy (n,3), velo (n,3),
        shift (n,3)), float32."""
        t = np.asarray(self.t)
        rpy = np.stack(self.rpy)
        velo = np.stack(self.velo)
        shift = np.stack(self.shift)
        tq = np.asarray(tq, np.float64)
        assert tq.min() >= t[0], "query precedes the IMU stream"
        hi = np.searchsorted(t, tq, side="right")
        clamp = hi >= t.shape[0]
        hi = np.clip(hi, 1, t.shape[0] - 1)
        lo = hi - 1
        ratio_f = ((tq - t[lo]) / (t[hi] - t[lo])).astype(np.float32)
        ratio_b = ((t[hi] - tq) / (t[hi] - t[lo])).astype(np.float32)

        def mix(series, wrap=False):
            v_hi = series[hi]
            v_lo = series[lo]
            if wrap:
                # yaw +-pi unwrap (:316-323)
                d = v_hi - v_lo
                v_lo = np.where(d > np.pi, v_lo + 2 * np.float32(np.pi), v_lo)
                v_lo = np.where(d < -np.pi, v_lo - 2 * np.float32(np.pi), v_lo)
            if series.ndim > 1:
                return v_hi * ratio_f[:, None] + v_lo * ratio_b[:, None]
            return v_hi * ratio_f + v_lo * ratio_b

        rpy_i = np.stack(
            [mix(rpy[:, 0]), mix(rpy[:, 1], wrap=True), mix(rpy[:, 2])],
            axis=1,
        )
        velo_i = mix(velo)
        shift_i = mix(shift)
        # beyond the newest sample: clamp to it (:295-307)
        if clamp.any():
            rpy_i[clamp] = rpy[-1]
            velo_i[clamp] = velo[-1]
            shift_i[clamp] = shift[-1]
        return rpy_i, velo_i, shift_i

    def process_sweep(self, P, rel_time, t_scan, first_is_index0):
        """The per-point IMU block of laserCloudHandler (:286-347):
        interpolate state at each point, record the start state at the
        sweep's first point, deskew the rest into the start IMU frame.
        P: (n, 3) kept internal-frame points in loop order.  Returns the
        deskewed points; leaves start/cur/fromStart state on self."""
        n = P.shape[0]
        if not self.t or n == 0:
            return P
        pt_time = (rel_time * SCAN_PERIOD).astype(np.float32)
        rpy_i, velo_i, shift_i = self._interp(t_scan + pt_time.astype(np.float64))

        if first_is_index0:
            # i == 0 branch (:333-345): record the start state; the
            # first point itself is NOT transformed
            self.rpy_start = rpy_i[0].copy()
            self.velo_start = velo_i[0].copy()
            self.shift_start = shift_i[0].copy()
        ps, ys, rs = self.rpy_start[0], self.rpy_start[1], self.rpy_start[2]

        # ShiftToStartIMU (:108-125), vectorized
        drift = (
            shift_i - self.shift_start[None, :]
            - self.velo_start[None, :] * pt_time[:, None]
        )
        x1 = np.cos(ys) * drift[:, 0] - np.sin(ys) * drift[:, 2]
        y1 = drift[:, 1]
        z1 = np.sin(ys) * drift[:, 0] + np.cos(ys) * drift[:, 2]
        y2 = np.cos(ps) * y1 + np.sin(ps) * z1
        z2 = -np.sin(ps) * y1 + np.cos(ps) * z1
        sfs = np.stack(
            [np.cos(rs) * x1 + np.sin(rs) * y2,
             -np.sin(rs) * x1 + np.cos(rs) * y2, z2], axis=1
        )

        # VeloToStartIMU (:127-144)
        dv = velo_i - self.velo_start[None, :]
        x1 = np.cos(ys) * dv[:, 0] - np.sin(ys) * dv[:, 2]
        y1 = dv[:, 1]
        z1 = np.sin(ys) * dv[:, 0] + np.cos(ys) * dv[:, 2]
        y2 = np.cos(ps) * y1 + np.sin(ps) * z1
        z2 = -np.sin(ps) * y1 + np.cos(ps) * z1
        vfs = np.stack(
            [np.cos(rs) * x1 + np.sin(rs) * y2,
             -np.sin(rs) * x1 + np.cos(rs) * y2, z2], axis=1
        )

        # TransformToStartIMU (:146-171)
        rc, pc, yc = rpy_i[:, 2], rpy_i[:, 0], rpy_i[:, 1]
        x1 = np.cos(rc) * P[:, 0] - np.sin(rc) * P[:, 1]
        y1 = np.sin(rc) * P[:, 0] + np.cos(rc) * P[:, 1]
        z1 = P[:, 2]
        y2 = np.cos(pc) * y1 - np.sin(pc) * z1
        z2 = np.sin(pc) * y1 + np.cos(pc) * z1
        x3 = np.cos(yc) * x1 + np.sin(yc) * z2
        z3 = -np.sin(yc) * x1 + np.cos(yc) * z2
        x4 = np.cos(ys) * x3 - np.sin(ys) * z3
        z4 = np.sin(ys) * x3 + np.cos(ys) * z3
        y5 = np.cos(ps) * y2 + np.sin(ps) * z4
        z5 = -np.sin(ps) * y2 + np.cos(ps) * z4
        out = np.stack(
            [np.cos(rs) * x4 + np.sin(rs) * y5 + sfs[:, 0],
             -np.sin(rs) * x4 + np.cos(rs) * y5 + sfs[:, 1],
             z5 + sfs[:, 2]], axis=1
        ).astype(np.float32)
        if first_is_index0:
            out[0] = P[0]  # the i==0 point is recorded untransformed

        # post-loop "Cur" state = last processed point (:584-635)
        self.rpy_cur = rpy_i[-1].copy()
        self.shift_from_start_cur = sfs[-1].copy()
        self.velo_from_start_cur = vfs[-1].copy()
        return out

    def imu_trans(self):
        """The 4-point imuTrans payload (:614-629): start rpy, cur rpy,
        shiftFromStart, veloFromStart — all (pitch, yaw, roll)-ordered
        where angular."""
        return {
            "rpy_start": self.rpy_start.copy(),
            "rpy_last": self.rpy_cur.copy(),
            "shift_from_start": self.shift_from_start_cur.copy(),
            "velo_from_start": self.velo_from_start_cur.copy(),
        }


def scan_registration(xyz_velo: np.ndarray, mask: np.ndarray,
                      imu: "ImuOracle | None" = None, t_scan: float = 0.0):
    """One sweep through laserCloudHandler.

    imu: optional ImuOracle already fed with the samples that would have
    arrived before this callback fires — enables the per-point deskew
    branch (:286-347).  t_scan: the sweep's stamp (timeScanCur).
    Returns dict with keys full, sharp, less_sharp, flat, less_flat
    (Cloud each) and imu_trans (dict, zeros when imu is None).
    """
    # the reference stores points and does all geometry in float32
    # (pcl::PointXYZ / float locals); matching the precision keeps the
    # chaotic near-tie comparisons aligned with the implementation under test
    pts = np.asarray(xyz_velo, np.float32)[np.asarray(mask, bool)]
    cloud_size_in = pts.shape[0]

    # start/end azimuth (:230-238)
    start_ori = -np.arctan2(pts[0, 1], pts[0, 0])
    end_ori = -np.arctan2(pts[-1, 1], pts[-1, 0]) + 2 * np.pi
    if end_ori - start_ori > 3 * np.pi:
        end_ori -= 2 * np.pi
    elif end_ori - start_ori < np.pi:
        end_ori += 2 * np.pi

    # axis remap (:244-246) — internal point = (y, z, x)_velodyne
    P = pts[:, [1, 2, 0]]

    # elevation -> scan id (:248-256)
    angle = np.degrees(
        np.arctan(P[:, 1] / np.sqrt(P[:, 0] ** 2 + P[:, 2] ** 2))
    )
    rounded = np.trunc(angle + np.where(angle < 0.0, -0.5, 0.5)).astype(int)
    scan_id = np.where(rounded > 0, rounded, rounded + (N_SCANS - 1))
    keep = (scan_id >= 0) & (scan_id <= N_SCANS - 1)

    Pk = P[keep]
    sid = scan_id[keep]
    n = Pk.shape[0]

    # azimuth unwrap with the halfPassed state machine (:262-281) —
    # evaluated only over kept points, exactly like the reference's
    # continue-before-ori control flow
    ori_raw = -np.arctan2(Pk[:, 0], Pk[:, 2])
    # pre-flip adjustment
    pre = ori_raw.copy()
    pre = np.where(pre < start_ori - np.pi / 2, pre + 2 * np.pi, pre)
    pre = np.where(pre > start_ori + np.pi * 3 / 2, pre - 2 * np.pi, pre)
    flipped = pre - start_ori > np.pi
    flip_idx = int(np.argmax(flipped)) if flipped.any() else n
    # post-flip adjustment
    post = ori_raw + 2 * np.pi
    post = np.where(post < end_ori - np.pi * 3 / 2, post + 2 * np.pi, post)
    post = np.where(post > end_ori + np.pi / 2, post - 2 * np.pi, post)
    ori = np.where(np.arange(n) <= flip_idx, pre, post)

    rel_time = (ori - start_ori) / (end_ori - start_ori)
    intensity = sid + SCAN_PERIOD * rel_time

    # IMU deskew (:286-347): interpolate state per point, record the
    # start at the sweep's first point (only if index 0 of the
    # NaN-filtered cloud survived the ring filter — the literal i == 0
    # test), transform the rest into the start IMU frame.  relTime /
    # intensity are already fixed; only coordinates change.
    if imu is not None and len(imu.t) > 0 and n > 0:
        Pk = imu.process_sweep(
            Pk.astype(np.float32), rel_time.astype(np.float32),
            float(t_scan), first_is_index0=bool(keep[0]),
        )

    # per-ring buckets in arrival order, then concatenation (:350-357)
    order = np.argsort(sid, kind="stable")
    xyz_cat = Pk[order]
    int_cat = intensity[order]
    cloud_size = n

    # curvature + ring boundary bookkeeping (:358-393) — literal f32
    # left-to-right accumulation (x[i-5] + ... + x[i-1] - 10 x[i] +
    # x[i+1] + ...), bit-matching the reference's float chain
    curv = np.zeros(cloud_size, np.float32)
    idx5 = np.arange(5, cloud_size - 5)
    if idx5.size:
        x = xyz_cat
        acc = x[idx5 - 5].copy()
        for off in (-4, -3, -2, -1):
            acc = acc + x[idx5 + off]
        acc = acc - np.float32(10.0) * x[idx5]
        for off in (1, 2, 3, 4, 5):
            acc = acc + x[idx5 + off]
        curv[idx5] = (
            acc[:, 0] * acc[:, 0] + acc[:, 1] * acc[:, 1]
            + acc[:, 2] * acc[:, 2]
        )
    picked = np.zeros(cloud_size, dtype=bool)
    label = np.zeros(cloud_size, dtype=int)

    scan_start = [0] * N_SCANS
    scan_end = [0] * N_SCANS
    ring_of = np.trunc(int_cat).astype(int)
    scan_count = -1
    for i in range(5, cloud_size - 5):
        if ring_of[i] != scan_count:
            scan_count = ring_of[i]
            if 0 < scan_count < N_SCANS:
                scan_start[scan_count] = i + 5
                scan_end[scan_count - 1] = i - 5
    scan_start[0] = 5
    scan_end[-1] = cloud_size - 5

    # occlusion / parallel-beam rejection (:395-452), vectorized over the
    # concatenated cloud (ring-boundary bleed preserved, as in the
    # reference)
    i_arr = np.arange(5, cloud_size - 6)
    if i_arr.size:
        diff_v = xyz_cat[i_arr + 1] - xyz_cat[i_arr]
        diff = np.sum(diff_v * diff_v, axis=1)
        depth = np.sqrt(np.sum(xyz_cat * xyz_cat, axis=1))
        d1 = depth[i_arr]
        d2 = depth[i_arr + 1]
        big = diff > 0.1
        with np.errstate(divide="ignore", invalid="ignore"):
            v_b = xyz_cat[i_arr + 1] - xyz_cat[i_arr] * (d2 / d1)[:, None]
            occl_b = big & (d1 > d2) & (
                np.sqrt(np.sum(v_b * v_b, axis=1)) / d2 < 0.1
            )
            v_a = xyz_cat[i_arr + 1] * (d1 / d2)[:, None] - xyz_cat[i_arr]
            occl_a = big & ~(d1 > d2) & (
                np.sqrt(np.sum(v_a * v_a, axis=1)) / d1 < 0.1
            )
        for off in range(-5, 1):
            picked[i_arr[occl_b] + off] = True
        for off in range(1, 7):
            picked[i_arr[occl_a] + off] = True
        diff2_v = xyz_cat[i_arr] - xyz_cat[i_arr - 1]
        diff2 = np.sum(diff2_v * diff2_v, axis=1)
        dis = np.sum(xyz_cat[i_arr] * xyz_cat[i_arr], axis=1)
        par = (diff > 0.0002 * dis) & (diff2 > 0.0002 * dis)
        picked[i_arr[par]] = True

    # per-ring / per-subregion greedy selection (:455-582)
    sharp_idx: list[int] = []
    less_sharp_idx: list[int] = []
    flat_idx: list[int] = []
    less_flat_clouds: list[Cloud] = []

    def suppress(ind):
        picked[ind] = True
        for off in range(1, 6):
            g = xyz_cat[ind + off] - xyz_cat[ind + off - 1]
            if np.dot(g, g) > 0.05:
                break
            picked[ind + off] = True
        for off in range(-1, -6, -1):
            g = xyz_cat[ind + off] - xyz_cat[ind + off + 1]
            if np.dot(g, g) > 0.05:
                break
            picked[ind + off] = True

    for ring in range(N_SCANS):
        less_flat_scan: list[int] = []
        s, e = scan_start[ring], scan_end[ring]
        for j in range(6):
            sp = (s * (6 - j) + e * j) // 6
            ep = (s * (5 - j) + e * (j + 1)) // 6 - 1
            if ep < sp:
                continue
            span = np.arange(sp, ep + 1)
            # the insertion sort (:466-474) is a stable ascending sort of
            # the identity-initialized index slice
            order_asc = span[np.argsort(curv[span], kind="stable")]

            largest = 0
            for ind in order_asc[::-1]:
                if picked[ind] or curv[ind] <= 0.1:
                    continue
                largest += 1
                if largest <= 2:
                    label[ind] = 2
                    sharp_idx.append(ind)
                    less_sharp_idx.append(ind)
                elif largest <= 20:
                    label[ind] = 1
                    less_sharp_idx.append(ind)
                else:
                    break
                suppress(ind)

            smallest = 0
            for ind in order_asc:
                if picked[ind] or curv[ind] >= 0.1:
                    continue
                label[ind] = -1
                flat_idx.append(ind)
                smallest += 1
                if smallest >= 4:
                    break
                suppress(ind)

            for k in range(sp, ep + 1):
                if label[k] <= 0:
                    less_flat_scan.append(k)

        lf = Cloud(xyz_cat[less_flat_scan], int_cat[less_flat_scan])
        less_flat_clouds.append(voxel_grid(lf, 0.2))

    less_flat = Cloud(
        np.concatenate([c.xyz for c in less_flat_clouds], axis=0),
        np.concatenate([c.intensity for c in less_flat_clouds]),
    )
    del cloud_size_in
    if imu is not None and len(imu.t) > 0:
        imu_trans = imu.imu_trans()
    else:
        imu_trans = {
            "rpy_start": np.zeros(3, np.float32),
            "rpy_last": np.zeros(3, np.float32),
            "shift_from_start": np.zeros(3, np.float32),
            "velo_from_start": np.zeros(3, np.float32),
        }
    return {
        "full": Cloud(xyz_cat, int_cat),
        "sharp": Cloud(xyz_cat[sharp_idx], int_cat[sharp_idx]),
        "less_sharp": Cloud(xyz_cat[less_sharp_idx], int_cat[less_sharp_idx]),
        "flat": Cloud(xyz_cat[flat_idx], int_cat[flat_idx]),
        "less_flat": less_flat,
        "imu_trans": imu_trans,
    }
