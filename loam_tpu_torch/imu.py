"""IMU dead reckoning and per-point deskew (counterpart of loam_tpu/imu.py;
src/scanRegistration.cpp:68-99,146-209,286-347,614-660).

The reference's 200-entry circular buffer becomes a padded window of
samples per sweep; dead reckoning is a cumulative sum and the per-point
interpolation a batched searchsorted + gather over the whole sweep.
Every function takes leading batch axes (frames) in front of the sample
and point axes, and the stream's leading axes are those of the sweep.

Conventions (internal frame: x left, y up, z forward): the IMU
world-from-body rotation is R = Ry(yaw) @ Rx(pitch) @ Rz(roll), and
angle triples are stored as (pitch, yaw, roll) == (rx, ry, rz), the
layout of the imuTrans message.  Validity is always a torch.where: no
host read per sample or per point.  Every rotation product is the
fixed-order elementwise form of utils/rotations (mat_vec, vec_mat,
r_yxz_fixed), so one sweep rounds as a batch of frames does: the
streaming engine's frontend as the replay's, on the card too.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .config import LoamConfig
from .types import ImuTrans, _map_fields
from .utils.numerics import cumsum
from .utils.rotations import mat_vec, r_yxz_fixed, vec_mat

_BIG_TIME = 1e18


@dataclasses.dataclass
class ImuStream:
    """A padded window of IMU samples: t (..., M) float32 sample times,
    strictly increasing on the valid slots; rpy (..., M, 3) (pitch, yaw,
    roll); acc (..., M, 3) gravity-removed acceleration in the internal
    body frame (src/scanRegistration.cpp:643-647); mask (..., M).  The
    valid samples are a prefix of the window (the interpolation's
    searchsorted needs each row sorted), and M >= 2 keeps every gather
    of the interpolation in range."""

    t: torch.Tensor
    rpy: torch.Tensor
    acc: torch.Tensor
    mask: torch.Tensor

    def __post_init__(self):
        if self.t.shape[-1] < 2:
            raise ValueError(f"an ImuStream needs M >= 2 sample slots, got "
                             f"{self.t.shape[-1]}")

    @staticmethod
    def zeros(m: int, device=None) -> "ImuStream":
        return ImuStream(
            t=torch.zeros(m, dtype=torch.float32, device=device),
            rpy=torch.zeros((m, 3), dtype=torch.float32, device=device),
            acc=torch.zeros((m, 3), dtype=torch.float32, device=device),
            mask=torch.zeros(m, dtype=torch.bool, device=device),
        )

    def map(self, fn) -> "ImuStream":
        return _map_fields(self, fn)


def imu_from_raw(t, quat_rpy, lin_acc_velodyne, mask) -> ImuStream:
    """The imuHandler conversion (src/scanRegistration.cpp:638-652):
    quat_rpy (..., M, 3) (roll, pitch, yaw) and the raw velodyne-frame
    acceleration -> internal-frame gravity-removed acceleration.

    accX = a.y - sin(roll) cos(pitch) g
    accY = a.z - cos(roll) cos(pitch) g
    accZ = a.x + sin(pitch) g
    """
    g = 9.81
    roll, pitch, yaw = quat_rpy[..., 0], quat_rpy[..., 1], quat_rpy[..., 2]
    ax = lin_acc_velodyne[..., 1] - torch.sin(roll) * torch.cos(pitch) * g
    ay = lin_acc_velodyne[..., 2] - torch.cos(roll) * torch.cos(pitch) * g
    az = lin_acc_velodyne[..., 0] + torch.sin(pitch) * g
    return ImuStream(
        t=t.to(torch.float32),
        rpy=torch.stack([pitch, yaw, roll], -1).to(torch.float32),
        acc=torch.stack([ax, ay, az], -1).to(torch.float32),
        mask=mask,
    )


@dataclasses.dataclass
class ImuIntegral:
    """Dead-reckoned world-frame velocity and position per sample."""

    velo: torch.Tensor   # (..., M, 3)
    shift: torch.Tensor  # (..., M, 3)


def integrate(stream: ImuStream, cfg: LoamConfig = LoamConfig()
              ) -> ImuIntegral:
    """AccumulateIMUShift over the whole window
    (src/scanRegistration.cpp:173-209): world acceleration R(rpy) @ acc,
    constant acceleration per interval.  An interval with dt >=
    scanPeriod (a gap), or an invalid sample on either side, contributes
    nothing: velocity and position freeze across it."""
    acc_w = mat_vec(r_yxz_fixed(stream.rpy), stream.acc)
    t, mask = stream.t, stream.mask
    dt = torch.diff(t, dim=-1, prepend=t[..., :1])
    prev_valid = torch.cat([torch.zeros_like(mask[..., :1]),
                            mask[..., :-1]], -1)
    ok = mask & prev_valid & (dt > 0.0) & (dt < cfg.scan_period)
    dt = torch.where(ok, dt, 0.0)[..., None]

    velo = cumsum(acc_w * dt, -2)
    # shift_k = shift_{k-1} + velo_{k-1} dt + 0.5 acc dt^2
    velo_prev = torch.cat([torch.zeros_like(velo[..., :1, :]),
                           velo[..., :-1, :]], -2)
    ds = velo_prev * dt + 0.5 * acc_w * dt ** 2
    return ImuIntegral(velo=velo, shift=cumsum(ds, -2))


def _interp_series(tq, t, series, mask, wrap: bool = False):
    """Linear interpolation of a padded series at query times.

    tq (..., Q); t, mask (..., M); series (..., M) or (..., M, C), with
    the same leading axes.  Clamps to the last valid sample beyond the
    window and to the first before it; wrap=True applies the reference's
    +-pi yaw unwrap between the bracketing samples
    (src/scanRegistration.cpp:316-323).  The valid samples must be a
    prefix of the window: t_pad (valid times, then 1e18) is then sorted,
    as searchsorted needs."""
    t_pad = torch.where(mask, t, _BIG_TIME)
    idx_hi = torch.searchsorted(t_pad, tq.contiguous(), right=True)
    n_valid = mask.sum(-1, keepdim=True)
    # the explicit clamp keeps both gathers inside the window (M >= 2):
    # JAX clamps an out-of-range gather, torch would fault
    idx_hi = torch.minimum(idx_hi.clamp(min=1),
                           (n_valid - 1).clamp(min=1))
    idx_lo = idx_hi - 1
    t_lo = torch.gather(t, -1, idx_lo)
    t_hi = torch.gather(t, -1, idx_hi)
    denom = torch.where((t_hi - t_lo).abs() < 1e-9, 1.0, t_hi - t_lo)
    # tensor / tensor is IEEE division on the card too
    w_hi = torch.clamp((tq - t_lo) / denom, 0.0, 1.0)
    if series.dim() > t.dim():
        idx = (idx_lo[..., None].expand(idx_lo.shape + series.shape[-1:]),
               idx_hi[..., None].expand(idx_hi.shape + series.shape[-1:]))
        v_lo, v_hi = (torch.gather(series, -2, i) for i in idx)
        w_hi = w_hi[..., None]
    else:
        v_lo = torch.gather(series, -1, idx_lo)
        v_hi = torch.gather(series, -1, idx_hi)
    if wrap:
        diff = v_hi - v_lo
        v_lo = torch.where(diff > math.pi, v_lo + 2 * math.pi, v_lo)
        v_lo = torch.where(diff < -math.pi, v_lo - 2 * math.pi, v_lo)
    return v_hi * w_hi + v_lo * (1.0 - w_hi)


def _interp_rpy(tq, stream: ImuStream):
    """(pitch, yaw, roll) at query times tq (..., Q) -> (..., Q, 3)."""
    return torch.stack([
        _interp_series(tq, stream.t, stream.rpy[..., i], stream.mask,
                       wrap=(i == 1))
        for i in range(3)], -1)


def _stream_valid(stream: ImuStream):
    return stream.mask.sum(-1) >= 2


@dataclasses.dataclass
class SweepImu:
    """Per-sweep IMU deskew data: the interpolated start state and the
    per-point state (leading axes (...), point axes P)."""

    rpy_start: torch.Tensor             # (..., 3) (pitch, yaw, roll)
    rpy_pt: torch.Tensor                # (..., *P, 3) per-point orientation
    shift_from_start: torch.Tensor      # (..., *P, 3) start-frame drift
    velo_from_start_last: torch.Tensor  # (..., 3)
    rpy_last: torch.Tensor              # (..., 3)
    shift_from_start_last: torch.Tensor  # (..., 3)
    valid: torch.Tensor                 # (...) bool: >= 2 valid samples


def _take(x, i):
    """x (..., Q, C) at per-row index i (...) -> (..., C)."""
    return torch.gather(x, -2, i[..., None, None].expand(
        i.shape + (1, x.shape[-1])))[..., 0, :]


def sweep_state(stream: ImuStream, integ: ImuIntegral, t_scan, rel_time,
                point_mask, cfg: LoamConfig = LoamConfig()) -> SweepImu:
    """Interpolate the IMU state at every point of a sweep
    (src/scanRegistration.cpp:286-347) and form the start-frame drift.

    t_scan (...) sweep start times; rel_time (..., *P) per-point sweep
    fraction in [0, 1]; point_mask (..., *P).  The start state is the
    one at the first valid point's time, the last state the one at the
    last valid point (argmin / argmax over the flattened points: the
    first index on ties, as in the JAX package)."""
    lead = stream.t.shape[:-1]
    pshape = rel_time.shape[len(lead):]
    rel = rel_time.reshape(lead + (-1,))
    flat_mask = point_mask.reshape(lead + (-1,))
    tq = t_scan[..., None] + rel * cfg.scan_period

    rpy_pt = _interp_rpy(tq, stream)
    velo_pt = _interp_series(tq, stream.t, integ.velo, stream.mask)
    shift_pt = _interp_series(tq, stream.t, integ.shift, stream.mask)

    flat_t = torch.where(flat_mask, rel, math.inf)
    t_first = torch.gather(flat_t, -1, torch.argmin(flat_t, -1,
                                                    keepdim=True))[..., 0]
    t0 = t_scan + torch.where(torch.isfinite(t_first), t_first,
                              0.0) * cfg.scan_period
    t0q = t0[..., None]
    rpy_start = _interp_rpy(t0q, stream)[..., 0, :]
    velo_start = _interp_series(t0q, stream.t, integ.velo,
                                stream.mask)[..., 0, :]
    shift_start = _interp_series(t0q, stream.t, integ.shift,
                                 stream.mask)[..., 0, :]

    # ShiftToStartIMU (:108-125): world drift minus the linear
    # prediction, rotated into the start IMU frame (drift @ R == R^T drift)
    pt_time = (tq - t0q)[..., None]
    drift_w = (shift_pt - shift_start[..., None, :]
               - velo_start[..., None, :] * pt_time)
    R_start = r_yxz_fixed(rpy_start)
    shift_from_start = vec_mat(drift_w, R_start)

    il = torch.argmax(torch.where(flat_mask, rel, -math.inf), -1)
    velo_last = _take(velo_pt, il)
    velo_from_start_last = vec_mat((velo_last - velo_start)[..., None, :],
                                   R_start)[..., 0, :]
    return SweepImu(
        rpy_start=rpy_start,
        rpy_pt=rpy_pt.reshape(lead + pshape + (3,)),
        shift_from_start=shift_from_start.reshape(lead + pshape + (3,)),
        velo_from_start_last=velo_from_start_last,
        rpy_last=_take(rpy_pt, il),
        shift_from_start_last=_take(shift_from_start, il),
        valid=_stream_valid(stream),
    )


def rpy_at(stream: ImuStream, t):
    """The stream's (pitch, yaw, roll) at times t (...): the
    laserMapping IMU lookup at timeLaserOdometry + scanPeriod
    (src/laserMapping.cpp:203-222).  Returns ((..., 3) rpy, (...) valid)."""
    return _interp_rpy(t[..., None], stream)[..., 0, :], _stream_valid(stream)


def deskew_points(xyz, sweep_imu: SweepImu):
    """TransformToStartIMU for every point (src/scanRegistration.cpp:
    146-171): p <- R_start^T @ R_cur @ p + shiftFromStart, which removes
    the non-constant-velocity motion over the sweep.  xyz (..., *P, 3)."""
    lead = sweep_imu.rpy_start.shape[:-1]
    p_w = mat_vec(r_yxz_fixed(sweep_imu.rpy_pt), xyz)
    p_start = vec_mat(p_w.reshape(lead + (-1, 3)),
                      r_yxz_fixed(sweep_imu.rpy_start))
    return p_start.reshape(xyz.shape) + sweep_imu.shift_from_start


def imu_trans(sweep_imu: SweepImu) -> ImuTrans:
    """The 4-vector imuTrans summary (src/scanRegistration.cpp:614-629);
    zeros where the window held fewer than two valid samples."""
    v = sweep_imu.valid[..., None]
    return ImuTrans(
        rpy_start=torch.where(v, sweep_imu.rpy_start, 0.0),
        rpy_cur=torch.where(v, sweep_imu.rpy_last, 0.0),
        shift_from_start=torch.where(v, sweep_imu.shift_from_start_last, 0.0),
        velo_from_start=torch.where(v, sweep_imu.velo_from_start_last, 0.0),
    )
