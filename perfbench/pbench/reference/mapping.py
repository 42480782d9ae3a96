"""laserMapping oracle: NumPy transcription of the main loop
(src/laserMapping.cpp:337-1104), no-IMU path.

Stateful like the node: 21x11x21 cube clouds with the pointer-shuffle
recentering while-loops, FOV-culled 5x5x5 local map, brute-force exact
5-NN (== FLANN), cv::eigen line fits / QR plane fits, the 10-iteration GN
with the threshold-100 degeneracy projector, and per-cube VoxelGrid
re-downsampling after insertion.
"""

from __future__ import annotations

import numpy as np

from .oracles import transform_associate_to_map
from .precision import einsum, product
from .registration import Cloud, voxel_grid

SCAN_PERIOD = 0.1
W, H, D = 21, 11, 21  # laserCloudWidth/Height/Depth (:67-69)


def _empty():
    return Cloud(np.zeros((0, 3)), np.zeros(0))


def point_associate_to_map(xyz, transform):
    """pointAssociateToMap (:234-252), vectorized."""
    rx, ry, rz = transform[:3]
    x1 = np.cos(rz) * xyz[:, 0] - np.sin(rz) * xyz[:, 1]
    y1 = np.sin(rz) * xyz[:, 0] + np.cos(rz) * xyz[:, 1]
    z1 = xyz[:, 2]
    x2 = x1
    y2 = np.cos(rx) * y1 - np.sin(rx) * z1
    z2 = np.sin(rx) * y1 + np.cos(rx) * z1
    return np.stack(
        [
            np.cos(ry) * x2 + np.sin(ry) * z2 + transform[3],
            y2 + transform[4],
            -np.sin(ry) * x2 + np.cos(ry) * z2 + transform[5],
        ],
        axis=1,
    )


def point_associate_tobe_mapped(xyz, transform):
    """pointAssociateTobeMapped (:254-272), vectorized inverse."""
    rx, ry, rz = transform[:3]
    x1 = np.cos(ry) * (xyz[:, 0] - transform[3]) \
        - np.sin(ry) * (xyz[:, 2] - transform[5])
    y1 = xyz[:, 1] - transform[4]
    z1 = np.sin(ry) * (xyz[:, 0] - transform[3]) \
        + np.cos(ry) * (xyz[:, 2] - transform[5])
    x2 = x1
    y2 = np.cos(rx) * y1 + np.sin(rx) * z1
    z2 = -np.sin(rx) * y1 + np.cos(rx) * z1
    return np.stack(
        [
            np.cos(rz) * x2 + np.sin(rz) * y2,
            -np.sin(rz) * x2 + np.cos(rz) * y2,
            z2,
        ],
        axis=1,
    )


def _degeneracy(matAtA, thr):
    w, v = np.linalg.eigh(matAtA)
    w = w[::-1]
    V = v[:, ::-1].T
    V2 = V.copy()
    degenerate = False
    for i in range(5, -1, -1):
        if w[i] < thr:
            V2[i, :] = 0.0
            degenerate = True
        else:
            break
    return np.linalg.inv(V) @ V2, degenerate


def _knn5(queries, ref, tf32: bool = False):
    """Exact 5-NN (== kdtree->nearestKSearch(pointSel, 5, ...)), chunked.

    Returns (idx (Q,5) nearest-first, d2 (Q,5))."""
    queries = np.asarray(queries, np.float64)
    ref = np.asarray(ref, np.float64)
    Q = queries.shape[0]
    idx = np.empty((Q, 5), int)
    d2o = np.empty((Q, 5))
    r2 = np.sum(ref * ref, axis=1)
    chunk = 2048
    for s in range(0, Q, chunk):
        q = queries[s : s + chunk]
        # |q|^2 - 2 q.r + |r|^2 via BLAS; distances recomputed exactly for
        # the 5 winners below so the gate compares true values
        d2 = product(q, -2.0 * ref.T, tf32)
        d2 += r2[None, :]
        d2 += np.sum(q * q, axis=1)[:, None]
        part = np.argpartition(d2, 4, axis=1)[:, :5]
        pd = np.einsum(
            "qkd,qkd->qk",
            q[:, None, :] - ref[part],
            q[:, None, :] - ref[part],
        )
        order = np.argsort(pd, axis=1)
        idx[s : s + chunk] = np.take_along_axis(part, order, axis=1)
        d2o[s : s + chunk] = np.take_along_axis(pd, order, axis=1)
    return idx, d2o


class LaserMappingOracle:
    def __init__(self, tf32: bool = False):
        self.tf32 = tf32
        self.cen = [10, 5, 10]  # laserCloudCenWidth/Height/Depth (:64-66)
        self.corner_array = [_empty() for _ in range(W * H * D)]
        self.surf_array = [_empty() for _ in range(W * H * D)]
        self.transform_bef = np.zeros(6)
        self.transform_aft = np.zeros(6)
        self.tobe = np.zeros(6)
        self.is_degenerate = False
        self.matP = np.zeros((6, 6))
        self.corner_stack2 = _empty()
        self.surf_stack2 = _empty()
        self.map_frame_count = 4  # mapFrameNum - 1 (:405)

    @staticmethod
    def _ind(i, j, k):
        return i + W * j + W * H * k

    def _shift(self, axis, direction):
        """One recentering pointer shuffle (:454-614): shift every cube
        one slot along `axis`; the wrapped-around edge cube is cleared."""
        for arr in (self.corner_array, self.surf_array):
            if axis == 0:
                for j in range(H):
                    for k in range(D):
                        row = [arr[self._ind(i, j, k)] for i in range(W)]
                        row = (
                            [row[-1]] + row[:-1]
                            if direction > 0
                            else row[1:] + [row[0]]
                        )
                        edge = 0 if direction > 0 else W - 1
                        row[edge] = _empty()
                        for i in range(W):
                            arr[self._ind(i, j, k)] = row[i]
            elif axis == 1:
                for i in range(W):
                    for k in range(D):
                        row = [arr[self._ind(i, j, k)] for j in range(H)]
                        row = (
                            [row[-1]] + row[:-1]
                            if direction > 0
                            else row[1:] + [row[0]]
                        )
                        edge = 0 if direction > 0 else H - 1
                        row[edge] = _empty()
                        for j in range(H):
                            arr[self._ind(i, j, k)] = row[j]
            else:
                for i in range(W):
                    for j in range(H):
                        row = [arr[self._ind(i, j, k)] for k in range(D)]
                        row = (
                            [row[-1]] + row[:-1]
                            if direction > 0
                            else row[1:] + [row[0]]
                        )
                        edge = 0 if direction > 0 else D - 1
                        row[edge] = _empty()
                        for k in range(D):
                            arr[self._ind(i, j, k)] = row[k]

    def handle(self, pose_sum, corner_last: Cloud, surf_last: Cloud,
               full: Cloud | None = None, imu_pitch_roll=None):
        """One mapping frame (:420-1096).  Returns dict with pose_aft,
        pose_bef, solved, registered (or None), surround (every 5th frame
        else None)."""
        self.tobe = transform_associate_to_map(
            pose_sum, self.transform_bef, self.transform_aft
        )

        # stack projection to map frame with the prior (:424-435), then
        # back to body (:683-691) — identity up to rounding, kept for
        # fidelity
        cs2 = point_associate_to_map(corner_last.xyz, self.tobe)
        ss2 = point_associate_to_map(surf_last.xyz, self.tobe)

        # cube recentering (:446-614)
        ci = int((self.tobe[3] + 25.0) / 50.0) + self.cen[0]
        cj = int((self.tobe[4] + 25.0) / 50.0) + self.cen[1]
        ck = int((self.tobe[5] + 25.0) / 50.0) + self.cen[2]
        if self.tobe[3] + 25.0 < 0:
            ci -= 1
        if self.tobe[4] + 25.0 < 0:
            cj -= 1
        if self.tobe[5] + 25.0 < 0:
            ck -= 1
        while ci < 3:
            self._shift(0, +1)
            ci += 1
            self.cen[0] += 1
        while ci >= W - 3:
            self._shift(0, -1)
            ci -= 1
            self.cen[0] -= 1
        while cj < 3:
            self._shift(1, +1)
            cj += 1
            self.cen[1] += 1
        while cj >= H - 3:
            self._shift(1, -1)
            cj -= 1
            self.cen[1] -= 1
        while ck < 3:
            self._shift(2, +1)
            ck += 1
            self.cen[2] += 1
        while ck >= D - 3:
            self._shift(2, -1)
            ck -= 1
            self.cen[2] -= 1

        # 5x5x5 neighborhood + FOV culling (:616-672)
        p_y = point_associate_to_map(
            np.array([[0.0, 10.0, 0.0]]), self.tobe
        )[0]
        valid_ind = []
        surround_ind = []
        for i in range(ci - 2, ci + 3):
            for j in range(cj - 2, cj + 3):
                for k in range(ck - 2, ck + 3):
                    if not (0 <= i < W and 0 <= j < H and 0 <= k < D):
                        continue
                    cx = 50.0 * (i - self.cen[0])
                    cy = 50.0 * (j - self.cen[1])
                    cz = 50.0 * (k - self.cen[2])
                    in_fov = False
                    for ii in (-1, 1):
                        for jj in (-1, 1):
                            for kk in (-1, 1):
                                corner = np.array(
                                    [cx + 25.0 * ii, cy + 25.0 * jj,
                                     cz + 25.0 * kk]
                                )
                                s1 = np.sum((self.tobe[3:] - corner) ** 2)
                                s2 = np.sum((p_y - corner) ** 2)
                                root = 10.0 * np.sqrt(3.0) * np.sqrt(s1)
                                if (100.0 + s1 - s2 - root < 0
                                        and 100.0 + s1 - s2 + root > 0):
                                    in_fov = True
                    ind = self._ind(i, j, k)
                    if in_fov:
                        valid_ind.append(ind)
                    surround_ind.append(ind)

        corner_from_map = Cloud(
            np.concatenate(
                [self.corner_array[i].xyz for i in valid_ind]
                + [np.zeros((0, 3))]
            ),
            np.concatenate(
                [self.corner_array[i].intensity for i in valid_ind]
                + [np.zeros(0)]
            ),
        )
        surf_from_map = Cloud(
            np.concatenate(
                [self.surf_array[i].xyz for i in valid_ind]
                + [np.zeros((0, 3))]
            ),
            np.concatenate(
                [self.surf_array[i].intensity for i in valid_ind]
                + [np.zeros(0)]
            ),
        )

        # stacks: back to body frame, downsample (:683-701)
        cs_body = point_associate_tobe_mapped(cs2, self.tobe)
        ss_body = point_associate_tobe_mapped(ss2, self.tobe)
        corner_stack = voxel_grid(
            Cloud(cs_body, corner_last.intensity.copy()), 0.2
        )
        surf_stack = voxel_grid(
            Cloud(ss_body, surf_last.intensity.copy()), 0.4
        )

        solved = (
            len(corner_from_map) > 10 and len(surf_from_map) > 100
        )
        if solved:
            for it in range(10):
                ori_points = []
                coeffs = []

                # corners (:714-819), vectorized over gated queries
                qc = point_associate_to_map(corner_stack.xyz, self.tobe)
                if len(corner_stack):
                    idx, d2 = _knn5(qc, corner_from_map.xyz, self.tf32)
                    gate = d2[:, 4] < 1.0
                    gq = np.nonzero(gate)[0]
                    if gq.size:
                        nb = corner_from_map.xyz[idx[gq]]     # (g,5,3)
                        c = nb.mean(axis=1)
                        ctr = nb - c[:, None, :]
                        cov = einsum("gki,gkj->gij", ctr, ctr,
                                     self.tf32) / 5.0
                        wv, vv = np.linalg.eigh(cov)          # ascending
                        w0 = wv[:, 2]
                        w1 = wv[:, 1]
                        v0 = vv[:, :, 2]                      # largest
                        is_line = w0 > 3.0 * w1
                        p0 = qc[gq]
                        p1 = c + 0.1 * v0
                        p2 = c - 0.1 * v0
                        cxv = (p0[:, 0]-p1[:, 0])*(p0[:, 1]-p2[:, 1]) \
                            - (p0[:, 0]-p2[:, 0])*(p0[:, 1]-p1[:, 1])
                        cyv = (p0[:, 0]-p1[:, 0])*(p0[:, 2]-p2[:, 2]) \
                            - (p0[:, 0]-p2[:, 0])*(p0[:, 2]-p1[:, 2])
                        czv = (p0[:, 1]-p1[:, 1])*(p0[:, 2]-p2[:, 2]) \
                            - (p0[:, 1]-p2[:, 1])*(p0[:, 2]-p1[:, 2])
                        a012 = np.sqrt(cxv*cxv + cyv*cyv + czv*czv)
                        l12 = np.linalg.norm(p1 - p2, axis=1)
                        with np.errstate(divide="ignore", invalid="ignore"):
                            la = ((p1[:, 1]-p2[:, 1])*cxv
                                  + (p1[:, 2]-p2[:, 2])*cyv) / a012 / l12
                            lb = -((p1[:, 0]-p2[:, 0])*cxv
                                   - (p1[:, 2]-p2[:, 2])*czv) / a012 / l12
                            lc = -((p1[:, 0]-p2[:, 0])*cyv
                                   + (p1[:, 1]-p2[:, 1])*czv) / a012 / l12
                            ld2 = a012 / l12
                        s = 1.0 - 0.9 * np.abs(ld2)
                        keep = is_line & (s > 0.1) & (a012 > 0) & (l12 > 0)
                        for t in np.nonzero(keep)[0]:
                            q = gq[t]
                            ori_points.append(corner_stack.xyz[q])
                            coeffs.append(np.array(
                                [s[t]*la[t], s[t]*lb[t], s[t]*lc[t],
                                 s[t]*ld2[t]]
                            ))

                # surfs (:821-877)
                qs = point_associate_to_map(surf_stack.xyz, self.tobe)
                if len(surf_stack):
                    idx, d2 = _knn5(qs, surf_from_map.xyz, self.tf32)
                    gate = d2[:, 4] < 1.0
                    gq = np.nonzero(gate)[0]
                    if gq.size:
                        nb = surf_from_map.xyz[idx[gq]]        # (g,5,3)
                        A0 = nb
                        # cv::solve(A0, -1, DECOMP_QR): least squares
                        AtA0 = einsum("gki,gkj->gij", A0, A0, self.tf32)
                        Atb0 = -np.sum(A0, axis=1)
                        try:
                            X0 = np.linalg.solve(AtA0, Atb0[..., None])[..., 0]
                        except np.linalg.LinAlgError:
                            X0 = np.stack([
                                np.linalg.lstsq(a, b, rcond=None)[0]
                                for a, b in zip(AtA0, Atb0)
                            ])
                        ps = np.linalg.norm(X0, axis=1)
                        pa = X0[:, 0] / ps
                        pb = X0[:, 1] / ps
                        pc = X0[:, 2] / ps
                        pdv = 1.0 / ps
                        off = np.abs(
                            einsum("gki,gi->gk", nb, X0 / ps[:, None], self.tf32)
                            + pdv[:, None]
                        )
                        plane_ok = np.all(off <= 0.2, axis=1)
                        p0g = qs[gq]
                        pd2 = (
                            pa * p0g[:, 0] + pb * p0g[:, 1]
                            + pc * p0g[:, 2] + pdv
                        )
                        s = 1.0 - 0.9 * np.abs(pd2) / np.sqrt(
                            np.sqrt(np.sum(p0g * p0g, axis=1))
                        )
                        keep = plane_ok & (s > 0.1)
                        for t in np.nonzero(keep)[0]:
                            q = gq[t]
                            ori_points.append(surf_stack.xyz[q])
                            coeffs.append(np.array([
                                s[t]*pa[t], s[t]*pb[t], s[t]*pc[t],
                                s[t]*pd2[t],
                            ]))

                if len(ori_points) < 50:
                    continue
                P = np.asarray(ori_points)
                C = np.asarray(coeffs)
                srx, crx = np.sin(self.tobe[0]), np.cos(self.tobe[0])
                sry, cry = np.sin(self.tobe[1]), np.cos(self.tobe[1])
                srz, crz = np.sin(self.tobe[2]), np.cos(self.tobe[2])
                px, py, pz = P[:, 0], P[:, 1], P[:, 2]
                ax, ay, az = C[:, 0], C[:, 1], C[:, 2]
                arx = (
                    (crx*sry*srz*px + crx*crz*sry*py - srx*sry*pz) * ax
                    + (-srx*srz*px - crz*srx*py - crx*pz) * ay
                    + (crx*cry*srz*px + crx*cry*crz*py - cry*srx*pz) * az
                )
                ary = (
                    ((cry*srx*srz - crz*sry)*px
                     + (sry*srz + cry*crz*srx)*py + crx*cry*pz) * ax
                    + ((-cry*crz - srx*sry*srz)*px
                       + (cry*srz - crz*srx*sry)*py - crx*sry*pz) * az
                )
                arz = (
                    ((crz*srx*sry - cry*srz)*px
                     + (-cry*crz - srx*sry*srz)*py) * ax
                    + (crx*crz*px - crx*srz*py) * ay
                    + ((sry*srz + cry*crz*srx)*px
                       + (crz*sry - cry*srx*srz)*py) * az
                )
                A = np.stack([arx, ary, arz, ax, ay, az], axis=1)
                B = -C[:, 3]
                AtA = product(A.T, A, self.tf32)
                AtB = product(A.T, B, self.tf32)
                try:
                    X = np.linalg.solve(AtA, AtB)
                except np.linalg.LinAlgError:
                    X = np.linalg.lstsq(AtA, AtB, rcond=None)[0]
                if it == 0:
                    self.matP, self.is_degenerate = _degeneracy(AtA, 100.0)
                if self.is_degenerate:
                    X = product(self.matP, X, self.tf32)
                self.tobe += X
                delta_r = np.sqrt(np.sum(np.degrees(X[:3]) ** 2))
                delta_t = np.sqrt(np.sum((X[3:] * 100.0) ** 2))
                if delta_r < 0.05 and delta_t < 0.05:
                    break

            # transformUpdate (:199-232): optional IMU roll/pitch blend
            # (imu_pitch_roll = the IMU stream's (pitch, roll)
            # interpolated at timeLaserOdometry + scanPeriod, :203-225)
            if imu_pitch_roll is not None:
                self.tobe[0] = 0.998 * self.tobe[0] + 0.002 * imu_pitch_roll[0]
                self.tobe[2] = 0.998 * self.tobe[2] + 0.002 * imu_pitch_roll[1]
            self.transform_bef = np.asarray(pose_sum, float).copy()
            self.transform_aft = self.tobe.copy()

        # insertion (:980-1016)
        def insert(stack: Cloud, arrays):
            world = point_associate_to_map(stack.xyz, self.tobe)
            cube_i = ((world[:, 0] + 25.0) / 50.0).astype(int) + self.cen[0]
            cube_j = ((world[:, 1] + 25.0) / 50.0).astype(int) + self.cen[1]
            cube_k = ((world[:, 2] + 25.0) / 50.0).astype(int) + self.cen[2]
            cube_i -= (world[:, 0] + 25.0 < 0).astype(int)
            cube_j -= (world[:, 1] + 25.0 < 0).astype(int)
            cube_k -= (world[:, 2] + 25.0 < 0).astype(int)
            ok = (
                (cube_i >= 0) & (cube_i < W)
                & (cube_j >= 0) & (cube_j < H)
                & (cube_k >= 0) & (cube_k < D)
            )
            inds = self._ind(cube_i[ok], cube_j[ok], cube_k[ok])
            wpts = world[ok]
            wint = stack.intensity[ok]
            for u in np.unique(inds):
                sel = inds == u
                c = arrays[u]
                arrays[u] = Cloud(
                    np.concatenate([c.xyz, wpts[sel]]),
                    np.concatenate([c.intensity, wint[sel]]),
                )

        insert(corner_stack, self.corner_array)
        insert(surf_stack, self.surf_array)

        # per-cube downsample of the touched (valid) cubes (:1018-1036)
        for ind in valid_ind:
            self.corner_array[ind] = voxel_grid(self.corner_array[ind], 0.2)
            self.surf_array[ind] = voxel_grid(self.surf_array[ind], 0.4)

        # surround cloud every 5th frame (:1038-1058)
        surround = None
        self.map_frame_count += 1
        if self.map_frame_count >= 5:
            self.map_frame_count = 0
            parts_x = [self.corner_array[i].xyz for i in surround_ind] + \
                [self.surf_array[i].xyz for i in surround_ind]
            parts_i = [self.corner_array[i].intensity
                       for i in surround_ind] + \
                [self.surf_array[i].intensity for i in surround_ind]
            s2 = Cloud(
                np.concatenate(parts_x + [np.zeros((0, 3))]),
                np.concatenate(parts_i + [np.zeros(0)]),
            )
            surround = voxel_grid(s2, 0.2)  # downSizeFilterCorner (:1050)

        registered = None
        if full is not None:
            registered = Cloud(
                point_associate_to_map(full.xyz, self.tobe),
                full.intensity.copy(),
            )

        return {
            "pose_aft": self.transform_aft.copy(),
            "pose_bef": self.transform_bef.copy(),
            "solved": solved,
            "surround": surround,
            "registered": registered,
        }
