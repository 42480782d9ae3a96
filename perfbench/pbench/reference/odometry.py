"""laserOdometry oracle: NumPy transcription of the main loop
(src/laserOdometry.cpp:357-938), no-IMU path.

Stateful like the node: one instance consumes scanRegistration outputs
frame by frame.  kd-tree 1-NN queries are exact brute-force argmins
(FLANN with default exact settings returns the same neighbor); the
second-point ring scans transcribe the literal index walks including the
cornerPointsSharpNum / surfPointsFlatNum upward truncation quirk
(:486,598) — switchable for divergence measurement.
"""

from __future__ import annotations

import numpy as np

from .precision import product
from .registration import Cloud

SCAN_PERIOD = 0.1


def _rot_x(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def _rot_z(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def transform_to_start(xyz, intensity, transform):
    """TransformToStart (:101-124), vectorized: undo the s-interpolated
    motion (Rz then Rx then inverse-Ry order as written)."""
    s = 10.0 * (intensity - np.trunc(intensity))
    rx, ry, rz = (s[:, None] * transform[None, :3]).T
    tx, ty, tz = (s[:, None] * transform[None, 3:]).T
    x = xyz[:, 0] - tx
    y = xyz[:, 1] - ty
    z = xyz[:, 2] - tz
    x1 = np.cos(rz) * x + np.sin(rz) * y
    y1 = -np.sin(rz) * x + np.cos(rz) * y
    z1 = z
    x2 = x1
    y2 = np.cos(rx) * y1 + np.sin(rx) * z1
    z2 = -np.sin(rx) * y1 + np.cos(rx) * z1
    return np.stack(
        [
            np.cos(ry) * x2 - np.sin(ry) * z2,
            y2,
            np.sin(ry) * x2 + np.cos(ry) * z2,
        ],
        axis=1,
    )


def transform_to_end(xyz, intensity, transform, imu=None):
    """TransformToEnd (:126-194).  imu: optional (rpy_start, rpy_last,
    shift_from_start) from the imuTrans message — enables the :168-190
    tail that swaps the solver's start attitude for the IMU-observed one;
    zeros/None reduce to exact identity.  Returns (xyz_end,
    intensity_int)."""
    p0 = transform_to_start(xyz, intensity, transform)
    rx, ry, rz = transform[:3]
    tx, ty, tz = transform[3:]
    x4 = np.cos(ry) * p0[:, 0] + np.sin(ry) * p0[:, 2]
    y4 = p0[:, 1]
    z4 = -np.sin(ry) * p0[:, 0] + np.cos(ry) * p0[:, 2]
    x5 = x4
    y5 = np.cos(rx) * y4 - np.sin(rx) * z4
    z5 = np.sin(rx) * y4 + np.cos(rx) * z4
    x6 = np.cos(rz) * x5 - np.sin(rz) * y5 + tx
    y6 = np.sin(rz) * x5 + np.cos(rz) * y5 + ty
    z6 = z5 + tz
    if imu is None:
        return np.stack([x6, y6, z6], axis=1), np.trunc(intensity)

    rpy_start, rpy_last, sfs = imu
    ps, ys, rs = rpy_start
    pl, yl, rl = rpy_last
    # undo start IMU attitude + drift (:168-181)
    x7 = np.cos(rs) * (x6 - sfs[0]) - np.sin(rs) * (y6 - sfs[1])
    y7 = np.sin(rs) * (x6 - sfs[0]) + np.cos(rs) * (y6 - sfs[1])
    z7 = z6 - sfs[2]
    x8 = x7
    y8 = np.cos(ps) * y7 - np.sin(ps) * z7
    z8 = np.sin(ps) * y7 + np.cos(ps) * z7
    x9 = np.cos(ys) * x8 + np.sin(ys) * z8
    y9 = y8
    z9 = -np.sin(ys) * x8 + np.cos(ys) * z8
    # re-apply last-point IMU attitude (:183-190)
    x10 = np.cos(yl) * x9 - np.sin(yl) * z9
    y10 = y9
    z10 = np.sin(yl) * x9 + np.cos(yl) * z9
    x11 = x10
    y11 = np.cos(pl) * y10 + np.sin(pl) * z10
    z11 = -np.sin(pl) * y10 + np.cos(pl) * z10
    out = np.stack(
        [
            np.cos(rl) * x11 + np.sin(rl) * y11,
            -np.sin(rl) * x11 + np.cos(rl) * y11,
            z11,
        ],
        axis=1,
    )
    return out, np.trunc(intensity)


def plugin_imu_rotation(bc, bl, al):
    """PluginIMURotation (:196-254): replace the solver-accumulated
    start attitude bl with the IMU-observed last attitude al inside the
    accumulated rotation bc.  All args (rx, ry, rz) == (pitch, yaw,
    roll) triples; returns (acx, acy, acz)."""
    bcx, bcy, bcz = bc
    blx, bly, blz = bl
    alx, aly, alz = al
    sbcx, cbcx = np.sin(bcx), np.cos(bcx)
    sbcy, cbcy = np.sin(bcy), np.cos(bcy)
    sbcz, cbcz = np.sin(bcz), np.cos(bcz)
    sblx, cblx = np.sin(blx), np.cos(blx)
    sbly, cbly = np.sin(bly), np.cos(bly)
    sblz, cblz = np.sin(blz), np.cos(blz)
    salx, calx = np.sin(alx), np.cos(alx)
    saly, caly = np.sin(aly), np.cos(aly)
    salz, calz = np.sin(alz), np.cos(alz)

    srx = (
        -sbcx * (salx * sblx + calx * caly * cblx * cbly
                 + calx * cblx * saly * sbly)
        - cbcx * cbcz * (calx * saly * (cbly * sblz - cblz * sblx * sbly)
                         - calx * caly * (sbly * sblz + cbly * cblz * sblx)
                         + cblx * cblz * salx)
        - cbcx * sbcz * (calx * caly * (cblz * sbly - cbly * sblx * sblz)
                         - calx * saly * (cbly * cblz + sblx * sbly * sblz)
                         + cblx * salx * sblz)
    )
    acx = -np.arcsin(srx)

    srycrx = (
        (cbcy * sbcz - cbcz * sbcx * sbcy)
        * (calx * saly * (cbly * sblz - cblz * sblx * sbly)
           - calx * caly * (sbly * sblz + cbly * cblz * sblx)
           + cblx * cblz * salx)
        - (cbcy * cbcz + sbcx * sbcy * sbcz)
        * (calx * caly * (cblz * sbly - cbly * sblx * sblz)
           - calx * saly * (cbly * cblz + sblx * sbly * sblz)
           + cblx * salx * sblz)
        + cbcx * sbcy * (salx * sblx + calx * caly * cblx * cbly
                         + calx * cblx * saly * sbly)
    )
    crycrx = (
        (cbcz * sbcy - cbcy * sbcx * sbcz)
        * (calx * caly * (cblz * sbly - cbly * sblx * sblz)
           - calx * saly * (cbly * cblz + sblx * sbly * sblz)
           + cblx * salx * sblz)
        - (sbcy * sbcz + cbcy * cbcz * sbcx)
        * (calx * saly * (cbly * sblz - cblz * sblx * sbly)
           - calx * caly * (sbly * sblz + cbly * cblz * sblx)
           + cblx * cblz * salx)
        + cbcx * cbcy * (salx * sblx + calx * caly * cblx * cbly
                         + calx * cblx * saly * sbly)
    )
    acy = np.arctan2(srycrx / np.cos(acx), crycrx / np.cos(acx))

    srzcrx = (
        sbcx * (cblx * cbly * (calz * saly - caly * salx * salz)
                - cblx * sbly * (caly * calz + salx * saly * salz)
                + calx * salz * sblx)
        - cbcx * cbcz * ((caly * calz + salx * saly * salz)
                         * (cbly * sblz - cblz * sblx * sbly)
                         + (calz * saly - caly * salx * salz)
                         * (sbly * sblz + cbly * cblz * sblx)
                         - calx * cblx * cblz * salz)
        + cbcx * sbcz * ((caly * calz + salx * saly * salz)
                         * (cbly * cblz + sblx * sbly * sblz)
                         + (calz * saly - caly * salx * salz)
                         * (cblz * sbly - cbly * sblx * sblz)
                         + calx * cblx * salz * sblz)
    )
    crzcrx = (
        sbcx * (cblx * sbly * (caly * salz - calz * salx * saly)
                - cblx * cbly * (saly * salz + caly * calz * salx)
                + calx * calz * sblx)
        + cbcx * cbcz * ((saly * salz + caly * calz * salx)
                         * (sbly * sblz + cbly * cblz * sblx)
                         + (caly * salz - calz * salx * saly)
                         * (cbly * sblz - cblz * sblx * sbly)
                         + calx * calz * cblx * cblz)
        - cbcx * sbcz * ((saly * salz + caly * calz * salx)
                         * (cblz * sbly - cbly * sblx * sblz)
                         + (caly * salz - calz * salx * saly)
                         * (cbly * cblz + sblx * sbly * sblz)
                         - calx * calz * cblx * sblz)
    )
    acz = np.arctan2(srzcrx / np.cos(acx), crzcrx / np.cos(acx))
    return acx, acy, acz


def accumulate_rotation(cx, cy, cz, lx, ly, lz):
    """AccumulateRotation (:256-273)."""
    srx = (
        np.cos(lx) * np.cos(cx) * np.sin(ly) * np.sin(cz)
        - np.cos(cx) * np.cos(cz) * np.sin(lx)
        - np.cos(lx) * np.cos(ly) * np.sin(cx)
    )
    ox = -np.arcsin(srx)
    srycrx = (
        np.sin(lx) * (np.cos(cy) * np.sin(cz) - np.cos(cz) * np.sin(cx) * np.sin(cy))
        + np.cos(lx) * np.sin(ly) * (
            np.cos(cy) * np.cos(cz) + np.sin(cx) * np.sin(cy) * np.sin(cz)
        )
        + np.cos(lx) * np.cos(ly) * np.cos(cx) * np.sin(cy)
    )
    crycrx = (
        np.cos(lx) * np.cos(ly) * np.cos(cx) * np.cos(cy)
        - np.cos(lx) * np.sin(ly) * (
            np.cos(cz) * np.sin(cy) - np.cos(cy) * np.sin(cx) * np.sin(cz)
        )
        - np.sin(lx) * (np.sin(cy) * np.sin(cz) + np.cos(cy) * np.cos(cz) * np.sin(cx))
    )
    oy = np.arctan2(srycrx / np.cos(ox), crycrx / np.cos(ox))
    srzcrx = (
        np.sin(cx) * (np.cos(lz) * np.sin(ly) - np.cos(ly) * np.sin(lx) * np.sin(lz))
        + np.cos(cx) * np.sin(cz) * (
            np.cos(ly) * np.cos(lz) + np.sin(lx) * np.sin(ly) * np.sin(lz)
        )
        + np.cos(lx) * np.cos(cx) * np.cos(cz) * np.sin(lz)
    )
    crzcrx = (
        np.cos(lx) * np.cos(lz) * np.cos(cx) * np.cos(cz)
        - np.cos(cx) * np.sin(cz) * (
            np.cos(ly) * np.sin(lz) - np.cos(lz) * np.sin(lx) * np.sin(ly)
        )
        - np.sin(cx) * (np.sin(ly) * np.sin(lz) + np.cos(ly) * np.cos(lz) * np.sin(lx))
    )
    oz = np.arctan2(srzcrx / np.cos(ox), crzcrx / np.cos(ox))
    return ox, oy, oz


def _degeneracy(matAtA, thr):
    """cv::eigen + the zero-row projector (:770-797)."""
    w, v = np.linalg.eigh(matAtA)         # ascending, columns
    w = w[::-1]
    V = v[:, ::-1].T                      # rows, descending eigenvalues
    V2 = V.copy()
    degenerate = False
    for i in range(5, -1, -1):
        if w[i] < thr:
            V2[i, :] = 0.0
            degenerate = True
        else:
            break
    matP = np.linalg.inv(V) @ V2
    return matP, degenerate


class LaserOdometryOracle:
    def __init__(self, truncate_upward_scan: bool = True,
                 tf32: bool = False):
        self.truncate = truncate_upward_scan
        self.tf32 = tf32
        self.inited = False
        self.transform = np.zeros(6)
        self.transform_sum = np.zeros(6)
        self.corner_last: Cloud | None = None
        self.surf_last: Cloud | None = None
        self.corner_last_num = 0
        self.surf_last_num = 0
        self.frame_count = 1  # = skipFrameNum (:407)
        self.is_degenerate = False
        self.matP = np.zeros((6, 6))

    # ---- correspondence scans ----

    def _corner_search(self, proj, n_query_bound):
        """1-NN + nearby-different-ring second point (:474-528).  proj:
        (Q,3) query points in start frame.  Returns ind1, ind2 (Q,).

        Vectorized when the last cloud's ring ids are nondecreasing in
        push order (true by construction: ring-major push at
        scanRegistration.cpp:460-582, intensities truncated to ints by
        TransformToEnd :193) — then the literal break-bounded scans equal
        ring-window masked argmins.  Falls back to the literal scan loop
        otherwise."""
        last = self.corner_last
        ring = np.trunc(last.intensity).astype(int)
        M = len(last)
        Q = proj.shape[0]
        ref64 = np.asarray(last.xyz, np.float64)
        q64 = np.asarray(proj, np.float64)
        d2 = product(q64, -2.0 * ref64.T, self.tf32)
        d2 += np.sum(ref64 * ref64, axis=1)[None, :]
        d2 += np.sum(q64 * q64, axis=1)[:, None]
        np.maximum(d2, 0.0, out=d2)
        nn = np.argmin(d2, axis=1)
        nnd = d2[np.arange(Q), nn]
        ind1 = np.where(nnd < 25, nn, -1)
        ind2 = np.full(Q, -1, int)
        up_bound = min(n_query_bound, M) if self.truncate else M

        if np.all(np.diff(ring) >= 0):
            cr = ring[nn]
            col = np.arange(M)[None, :]
            rr = ring[None, :]
            crq = cr[:, None]
            cand = (ind1 >= 0)[:, None] & (
                ((col > nn[:, None]) & (col < up_bound)
                 & (rr > crq) & (rr <= crq + 2))
                | ((col < nn[:, None]) & (rr < crq) & (rr >= crq - 2))
            )
            d2m = np.where(cand, d2, np.inf)
            j2 = np.argmin(d2m, axis=1)
            best = d2m[np.arange(Q), j2]
            ind2 = np.where(best < 25.0, j2, -1)
            return ind1, ind2

        for q in range(Q):
            if nnd[q] >= 25:
                continue
            cp = nn[q]
            cr = ring[cp]
            best2 = 25.0
            for j in range(cp + 1, up_bound):
                if ring[j] > cr + 2.5:
                    break
                if ring[j] > cr and d2[q, j] < best2:
                    best2 = d2[q, j]
                    ind2[q] = j
            for j in range(cp - 1, -1, -1):
                if ring[j] < cr - 2.5:
                    break
                if ring[j] < cr and d2[q, j] < best2:
                    best2 = d2[q, j]
                    ind2[q] = j
        return ind1, ind2

    def _surf_search(self, proj, n_query_bound):
        """1-NN + same-ring second + nearby-ring third point (:586-651)."""
        last = self.surf_last
        ring = np.trunc(last.intensity).astype(int)
        M = len(last)
        Q = proj.shape[0]
        ref64 = np.asarray(last.xyz, np.float64)
        q64 = np.asarray(proj, np.float64)
        d2 = product(q64, -2.0 * ref64.T, self.tf32)
        d2 += np.sum(ref64 * ref64, axis=1)[None, :]
        d2 += np.sum(q64 * q64, axis=1)[:, None]
        np.maximum(d2, 0.0, out=d2)
        nn = np.argmin(d2, axis=1)
        nnd = d2[np.arange(Q), nn]
        ind1 = np.full(Q, -1, int)
        ind2 = np.full(Q, -1, int)
        ind3 = np.full(Q, -1, int)
        up_bound = min(n_query_bound, M) if self.truncate else M

        if np.all(np.diff(ring) >= 0):
            ind1 = np.where(nnd < 25, nn, -1)
            cr = ring[nn]
            col = np.arange(M)[None, :]
            rr = ring[None, :]
            crq = cr[:, None]
            ok = (ind1 >= 0)[:, None]
            up = (col > nn[:, None]) & (col < up_bound)
            dn = col < nn[:, None]
            # 2nd point: ring <= cr upward / ring >= cr downward — under
            # monotonic rings both collapse to ring == cr (:610,634)
            cand2 = ok & (rr == crq) & (col != nn[:, None]) & (
                up | dn
            )
            # 3rd point: different ring within the +-2.5 break window
            cand3 = ok & (
                (up & (rr > crq) & (rr <= crq + 2))
                | (dn & (rr < crq) & (rr >= crq - 2))
            )
            d2m2 = np.where(cand2, d2, np.inf)
            j2 = np.argmin(d2m2, axis=1)
            b2 = d2m2[np.arange(Q), j2]
            ind2 = np.where(b2 < 25.0, j2, -1)
            d2m3 = np.where(cand3, d2, np.inf)
            j3 = np.argmin(d2m3, axis=1)
            b3 = d2m3[np.arange(Q), j3]
            ind3 = np.where(b3 < 25.0, j3, -1)
            return ind1, ind2, ind3

        for q in range(Q):
            if nnd[q] >= 25:
                continue
            cp = nn[q]
            cr = ring[cp]
            ind1[q] = cp
            best2 = 25.0
            best3 = 25.0
            for j in range(cp + 1, up_bound):
                if ring[j] > cr + 2.5:
                    break
                if ring[j] <= cr:
                    if d2[q, j] < best2:
                        best2 = d2[q, j]
                        ind2[q] = j
                else:
                    if d2[q, j] < best3:
                        best3 = d2[q, j]
                        ind3[q] = j
            for j in range(cp - 1, -1, -1):
                if ring[j] < cr - 2.5:
                    break
                if ring[j] >= cr:
                    if d2[q, j] < best2:
                        best2 = d2[q, j]
                        ind2[q] = j
                else:
                    if d2[q, j] < best3:
                        best3 = d2[q, j]
                        ind3[q] = j
        return ind1, ind2, ind3

    # ---- one frame ----

    def handle(self, feats: dict, imu_trans: dict | None = None):
        """One sync-gated loop body (:427-931).  feats: the
        scan_registration output dict.  imu_trans: the imuTransHandler
        payload (:330-354) — enables the velocity prior (:461-463), the
        IMU tail of TransformToEnd, and PluginIMURotation (:848-856).
        Returns dict with pose (6,), published corner/surf clouds (or
        None on skip frames), full cloud (every 2nd frame), published
        flag."""
        sharp = feats["sharp"]
        less_sharp = feats["less_sharp"].copy()
        flat = feats["flat"]
        less_flat = feats["less_flat"].copy()
        full = feats["full"].copy()
        has_imu = imu_trans is not None
        if has_imu:
            imu_rpy_start = np.asarray(imu_trans["rpy_start"], float)
            imu_rpy_last = np.asarray(imu_trans["rpy_last"], float)
            imu_sfs = np.asarray(imu_trans["shift_from_start"], float)
            imu_vfs = np.asarray(imu_trans["velo_from_start"], float)
            imu_end = (imu_rpy_start, imu_rpy_last, imu_sfs)
        else:
            imu_sfs = np.zeros(3)
            imu_end = None

        if not self.inited:
            # init frame: hand clouds over, publish, seed transformSum
            # with the IMU start attitude (:427-456)
            self.corner_last = less_sharp
            self.surf_last = less_flat
            self.corner_last_num = len(less_sharp)
            self.surf_last_num = len(less_flat)
            self.inited = True
            if has_imu:
                self.transform_sum[0] += imu_rpy_start[0]
                self.transform_sum[2] += imu_rpy_start[2]
            return {
                "pose": self.transform_sum.copy(),
                "corner_last": self.corner_last.copy(),
                "surf_last": self.surf_last.copy(),
                "full": full,
                "published": True,
            }

        # IMU velocity prior on translation (:461-463)
        if has_imu:
            self.transform[3:] -= imu_vfs * SCAN_PERIOD

        ori_points: list[np.ndarray] = []   # accumulated pointOri
        coeff_sel: list[np.ndarray] = []    # accumulated (la,lb,lc,s*d)

        if self.corner_last_num > 10 and self.surf_last_num > 100:
            n_sharp = len(sharp)
            n_flat = len(flat)
            c_ind1 = np.full(n_sharp, -1, int)
            c_ind2 = np.full(n_sharp, -1, int)
            s_ind1 = np.full(n_flat, -1, int)
            s_ind2 = np.full(n_flat, -1, int)
            s_ind3 = np.full(n_flat, -1, int)

            for it in range(25):
                # ---- corners (:471-584) ----
                proj_c = transform_to_start(
                    sharp.xyz, sharp.intensity, self.transform
                )
                if it % 5 == 0:
                    c_ind1, c_ind2 = self._corner_search(proj_c, n_sharp)
                sel = c_ind2 >= 0
                if sel.any():
                    p0 = proj_c[sel]
                    p1 = self.corner_last.xyz[c_ind1[sel]]
                    p2 = self.corner_last.xyz[c_ind2[sel]]
                    cx = (p0[:, 0] - p1[:, 0]) * (p0[:, 1] - p2[:, 1]) \
                        - (p0[:, 0] - p2[:, 0]) * (p0[:, 1] - p1[:, 1])
                    cy = (p0[:, 0] - p1[:, 0]) * (p0[:, 2] - p2[:, 2]) \
                        - (p0[:, 0] - p2[:, 0]) * (p0[:, 2] - p1[:, 2])
                    cz = (p0[:, 1] - p1[:, 1]) * (p0[:, 2] - p2[:, 2]) \
                        - (p0[:, 1] - p2[:, 1]) * (p0[:, 2] - p1[:, 2])
                    a012 = np.sqrt(cx * cx + cy * cy + cz * cz)
                    d12 = p1 - p2
                    l12 = np.sqrt(np.sum(d12 * d12, axis=1))
                    la = (d12[:, 1] * cx + d12[:, 2] * cy) / a012 / l12
                    lb = -(d12[:, 0] * cx - d12[:, 2] * cz) / a012 / l12
                    lc = -(d12[:, 0] * cy + d12[:, 1] * cz) / a012 / l12
                    ld2 = a012 / l12
                    s = np.ones_like(ld2)
                    if it >= 5:
                        s = 1.0 - 1.8 * np.abs(ld2)
                    keep = (s > 0.1) & (ld2 != 0.0)
                    orig = sharp.xyz[sel][keep]
                    ori_points.extend(orig)
                    coeff_sel.extend(
                        np.stack(
                            [s * la, s * lb, s * lc, s * ld2], axis=1
                        )[keep]
                    )

                # ---- surfs (:586-695) ----
                proj_s = transform_to_start(
                    flat.xyz, flat.intensity, self.transform
                )
                if it % 5 == 0:
                    s_ind1, s_ind2, s_ind3 = self._surf_search(
                        proj_s, n_flat
                    )
                sel = (s_ind2 >= 0) & (s_ind3 >= 0)
                if sel.any():
                    p0 = proj_s[sel]
                    t1 = self.surf_last.xyz[s_ind1[sel]]
                    t2 = self.surf_last.xyz[s_ind2[sel]]
                    t3 = self.surf_last.xyz[s_ind3[sel]]
                    pa = (t2[:, 1] - t1[:, 1]) * (t3[:, 2] - t1[:, 2]) \
                        - (t3[:, 1] - t1[:, 1]) * (t2[:, 2] - t1[:, 2])
                    pb = (t2[:, 2] - t1[:, 2]) * (t3[:, 0] - t1[:, 0]) \
                        - (t3[:, 2] - t1[:, 2]) * (t2[:, 0] - t1[:, 0])
                    pc = (t2[:, 0] - t1[:, 0]) * (t3[:, 1] - t1[:, 1]) \
                        - (t3[:, 0] - t1[:, 0]) * (t2[:, 1] - t1[:, 1])
                    pd = -(pa * t1[:, 0] + pb * t1[:, 1] + pc * t1[:, 2])
                    ps = np.sqrt(pa * pa + pb * pb + pc * pc)
                    pa, pb, pc, pd = pa / ps, pb / ps, pc / ps, pd / ps
                    pd2 = (
                        pa * p0[:, 0] + pb * p0[:, 1] + pc * p0[:, 2] + pd
                    )
                    s = np.ones_like(pd2)
                    if it >= 5:
                        s = 1.0 - 1.8 * np.abs(pd2) / np.sqrt(
                            np.sqrt(np.sum(p0 * p0, axis=1))
                        )
                    keep = (s > 0.1) & (pd2 != 0.0)
                    orig = flat.xyz[sel][keep]
                    ori_points.extend(orig)
                    coeff_sel.extend(
                        np.stack(
                            [s * pa, s * pb, s * pc, s * pd2], axis=1
                        )[keep]
                    )

                # ---- solve (:697-826) ----
                n_rows = len(ori_points)
                if n_rows < 10:
                    continue
                P = np.asarray(ori_points)
                C = np.asarray(coeff_sel)
                srx, crx = np.sin(self.transform[0]), np.cos(self.transform[0])
                sry, cry = np.sin(self.transform[1]), np.cos(self.transform[1])
                srz, crz = np.sin(self.transform[2]), np.cos(self.transform[2])
                tx, ty, tz = self.transform[3:]
                px, py, pz = P[:, 0], P[:, 1], P[:, 2]
                ax, ay, az = C[:, 0], C[:, 1], C[:, 2]
                arx = (
                    (-crx * sry * srz * px + crx * crz * sry * py + srx * sry * pz
                     + tx * crx * sry * srz - ty * crx * crz * sry - tz * srx * sry) * ax
                    + (srx * srz * px - crz * srx * py + crx * pz
                       + ty * crz * srx - tz * crx - tx * srx * srz) * ay
                    + (crx * cry * srz * px - crx * cry * crz * py - cry * srx * pz
                       + tz * cry * srx + ty * crx * cry * crz - tx * crx * cry * srz) * az
                )
                ary = (
                    ((-crz * sry - cry * srx * srz) * px
                     + (cry * crz * srx - sry * srz) * py - crx * cry * pz
                     + tx * (crz * sry + cry * srx * srz)
                     + ty * (sry * srz - cry * crz * srx) + tz * crx * cry) * ax
                    + ((cry * crz - srx * sry * srz) * px
                       + (cry * srz + crz * srx * sry) * py - crx * sry * pz
                       + tz * crx * sry - ty * (cry * srz + crz * srx * sry)
                       - tx * (cry * crz - srx * sry * srz)) * az
                )
                arz = (
                    ((-cry * srz - crz * srx * sry) * px
                     + (cry * crz - srx * sry * srz) * py
                     + tx * (cry * srz + crz * srx * sry)
                     - ty * (cry * crz - srx * sry * srz)) * ax
                    + (-crx * crz * px - crx * srz * py
                       + ty * crx * srz + tx * crx * crz) * ay
                    + ((cry * crz * srx - sry * srz) * px
                       + (crz * sry + cry * srx * srz) * py
                       + tx * (sry * srz - cry * crz * srx)
                       - ty * (crz * sry + cry * srx * srz)) * az
                )
                atx = -(cry * crz - srx * sry * srz) * ax + crx * srz * ay \
                    - (crz * sry + cry * srx * srz) * az
                aty = -(cry * srz + crz * srx * sry) * ax - crx * crz * ay \
                    - (sry * srz - cry * crz * srx) * az
                atz = crx * sry * ax - srx * ay - crx * cry * az
                A = np.stack([arx, ary, arz, atx, aty, atz], axis=1)
                B = -0.05 * C[:, 3]
                AtA = product(A.T, A, self.tf32)
                AtB = product(A.T, B, self.tf32)
                try:
                    X = np.linalg.solve(AtA, AtB)
                except np.linalg.LinAlgError:
                    X = np.linalg.lstsq(AtA, AtB, rcond=None)[0]

                if it == 0:
                    self.matP, self.is_degenerate = _degeneracy(AtA, 10.0)
                if self.is_degenerate:
                    X = product(self.matP, X, self.tf32)
                if np.any(np.isnan(X)):
                    pass  # the fork's NaN guard (:799-812): skip update
                else:
                    self.transform += X
                delta_r = np.sqrt(np.sum(np.degrees(X[:3]) ** 2))
                delta_t = np.sqrt(np.sum((X[3:] * 100.0) ** 2))
                if delta_r < 0.1 and delta_t < 0.1:
                    break

        # pose accumulation (:830-856); without IMU the plugin is
        # identity and the drift terms are zero
        rx, ry, rz = accumulate_rotation(
            self.transform_sum[0], self.transform_sum[1],
            self.transform_sum[2],
            -self.transform[0], -self.transform[1] * 1.05,
            -self.transform[2],
        )
        x1 = np.cos(rz) * (self.transform[3] - imu_sfs[0]) \
            - np.sin(rz) * (self.transform[4] - imu_sfs[1])
        y1 = np.sin(rz) * (self.transform[3] - imu_sfs[0]) \
            + np.cos(rz) * (self.transform[4] - imu_sfs[1])
        z1 = self.transform[5] * 1.05 - imu_sfs[2]
        x2 = x1
        y2 = np.cos(rx) * y1 - np.sin(rx) * z1
        z2 = np.sin(rx) * y1 + np.cos(rx) * z1
        tx = self.transform_sum[3] - (np.cos(ry) * x2 + np.sin(ry) * z2)
        ty = self.transform_sum[4] - y2
        tz = self.transform_sum[5] - (-np.sin(ry) * x2 + np.cos(ry) * z2)
        if has_imu:
            rx, ry, rz = plugin_imu_rotation(
                (rx, ry, rz), imu_rpy_start, imu_rpy_last
            )
        self.transform_sum = np.array([rx, ry, rz, tx, ty, tz])

        # end-of-sweep reprojection (:875-891) and swap (:893-908)
        ls_xyz, ls_int = transform_to_end(
            less_sharp.xyz, less_sharp.intensity, self.transform, imu_end
        )
        lf_xyz, lf_int = transform_to_end(
            less_flat.xyz, less_flat.intensity, self.transform, imu_end
        )
        self.frame_count += 1
        published = self.frame_count >= 2  # skipFrameNum + 1
        if published:
            fr_xyz, fr_int = transform_to_end(
                full.xyz, full.intensity, self.transform, imu_end
            )
            full = Cloud(fr_xyz, fr_int)
        self.corner_last = Cloud(ls_xyz, ls_int)
        self.surf_last = Cloud(lf_xyz, lf_int)
        self.corner_last_num = len(self.corner_last)
        self.surf_last_num = len(self.surf_last)
        if published:
            self.frame_count = 0

        return {
            "pose": self.transform_sum.copy(),
            "corner_last": self.corner_last.copy(),
            "surf_last": self.surf_last.copy(),
            "full": full if published else None,
            "published": published,
        }
