"""Online streaming engine (counterpart of loam_tpu/runtime/streaming.py):
the reference's 4-process real-time graph as threaded stages over native
lossy queues.

The reference runs scanRegistration -> laserOdometry -> laserMapping ->
transformMaintenance as separate OS processes connected by roscpp
subscription queues of depth 2-5 that drop the oldest message under load
(src/laserOdometry.cpp:357-398); odometry keeps 10 Hz while mapping
consumes every 2nd frame (src/laserOdometry.cpp:51).

Here each stage is a host thread making plain calls into the port on
one device; the inter-stage queues are the native bounded drop-oldest
queues (native/runtime.cc), so an overloaded stage sheds load like the
reference instead of stalling the lidar ingest.  Every stage launches on
its device's default stream, so a tensor handed from one stage to the
next needs no event.  The kernels and the native library are built in
the constructor, before any thread starts.

Integration (transformMaintenance, src/transformMaintenance.cpp:147-180)
runs on the odometry output: frame k's odometry pose is composed with
the bef/aft pair of the last mapping frame that has FINISHED.  The
offline replay (pipeline.replay_sweeps) integrates after frame k's own
mapping.  So in a paced run (drain() after every push):
  * the odometry poses equal the replay's pose_odom at every frame;
  * latest_aft() after a mapping frame equals that frame's pose_aft;
  * the integrated pose equals the replay's pose_integrated on frames
    without mapping, and on a mapping frame k it equals
    transform_associate_to_map(pose_odom[k], bef, aft) of the previous
    mapping frame.
The frontend always runs the IMU path on the sweep's window of pushed
samples; a window with fewer than two samples takes the no-IMU way
(SweepImu.valid), so a run without push_imu equals replay_sweeps given
the same all-masked windows.

The first exception of any stage stops the engine and is raised again
by drain(), stop() and the next push_sweep / push_imu: no stage dies
silently.  drain() waits on an exact count of the sweeps in flight
(pushed and neither finished nor dropped), where the JAX engine polls
the queue depths and per-stage busy flags, which a stage sets only
after its pop: it can report idle between a pop and the flag.

Usage:
    eng = StreamingEngine(cfg)          # device=None: the CUDA device
    eng.start()
    eng.push_sweep(xyz, mask)           # from the sensor thread, a sweep
                                        # every cfg.scan_period seconds
    pose = eng.latest_pose()            # integrated pose at sweep rate
    eng.stop(); print(eng.stats())
"""

from __future__ import annotations

import contextlib
import ctypes
import itertools
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import (configure_numerics, imu as imu_mod, mapping, odometry,
                resolve_device)
from ..config import LoamConfig
from ..io.rosbag import _load as _load_native
from ..ops.features import extract_features
from ..pipeline import check_config, ingest_frames
from ..types import add_scenario_axis, drop_scenario_axis
from ..utils import rotations

_IMU_WINDOW = 256  # per-sweep IMU window capacity (reference buffer: 200)


class NativeQueue:
    """ctypes wrapper over the native drop-oldest bounded queue (the
    loam_q_* signatures are declared by io.rosbag._load)."""

    def __init__(self, capacity: int):
        lib = _load_native()
        self._lib = lib
        self._h = lib.loam_q_create(capacity)
        self._slots: dict[int, object] = {}
        self._next = itertools.count()
        self._lock = threading.Lock()

    def push(self, obj) -> bool:
        """Returns False if an old entry was dropped to make room."""
        with self._lock:
            handle = next(self._next)
            self._slots[handle] = obj
        dropped = ctypes.c_uint64()
        rc = self._lib.loam_q_push(self._h, handle, ctypes.byref(dropped))
        if rc != 0:
            with self._lock:
                self._slots.pop(handle, None)
            return True
        if dropped.value != 0xFFFFFFFFFFFFFFFF:
            with self._lock:
                self._slots.pop(dropped.value, None)
            return False
        return True

    def pop(self, timeout_ms: int = -1):
        """Returns the object, or None on timeout/closed."""
        out = ctypes.c_uint64()
        rc = self._lib.loam_q_pop(self._h, ctypes.byref(out), timeout_ms)
        if rc != 0:
            return None
        with self._lock:
            return self._slots.pop(out.value, None)

    def close(self):
        self._lib.loam_q_close(self._h)

    def stats(self) -> dict:
        vals = [ctypes.c_uint64() for _ in range(4)]
        self._lib.loam_q_stats(self._h, *[ctypes.byref(v) for v in vals])
        return dict(zip(
            ("pushed", "popped", "dropped", "depth"),
            (v.value for v in vals),
        ))


@dataclass
class EngineStats:
    frames_in: int = 0
    odom_frames: int = 0
    map_frames: int = 0
    integrated: int = 0
    queue_stats: dict = field(default_factory=dict)


class StreamingEngine:
    """Threaded 4-stage online pipeline with reference queue depths, on
    `device` (None: the CUDA device, and a RuntimeError without one)."""

    def __init__(self, cfg: LoamConfig = LoamConfig(),
                 raw_queue_depth: int = 2, feat_queue_depth: int = 2,
                 map_queue_depth: int = 5, device=None):
        check_config(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        configure_numerics()
        # build everything a stage could build lazily, before any thread
        if self.device.type == "cuda":
            from ..ops.cuda import _build

            _build.build_all()
        # queue depths follow the reference's subscriber queues:
        # odometry inputs 2, mapping inputs 5 (src/laserOdometry.cpp:362,
        # src/laserMapping.cpp:340-352)
        self.q_raw = NativeQueue(raw_queue_depth)
        self.q_feats = NativeQueue(feat_queue_depth)
        self.q_map = NativeQueue(map_queue_depth)
        self.stats_ = EngineStats()
        self._pose_lock = threading.Lock()
        self._latest_integrated = np.zeros(6, np.float32)
        self._latest_aft = np.zeros(6, np.float32)
        self._latest_odom = np.zeros(6, np.float32)
        # latest /velodyne_cloud_registered (PointCloud) when
        # cfg.emit_registered is set
        self._latest_registered = None
        self._trajectory: list[np.ndarray] = []
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()
        # sweeps pushed and neither finished (by odometry, or by mapping
        # where odometry publishes) nor dropped by a queue; the first
        # stage exception; both guarded by _flight
        self._in_flight = 0
        self._error: BaseException | None = None
        self._flight = threading.Condition()
        self._odom_state = odometry.OdomState.create(cfg, self.device)
        self._map_state = mapping.MapState.create(cfg, self.device)
        # transformMaintenance pose pair (src/transformMaintenance.cpp:
        # 52-58), on the device: the integration rounds as the replay's
        self._bef = torch.zeros(6, device=self.device)
        self._aft = torch.zeros(6, device=self.device)
        # host-side IMU ring buffer (the reference's 200-entry circular
        # buffer, src/scanRegistration.cpp:68-99)
        self._imu_lock = threading.Lock()
        self._imu_t = np.zeros(0, np.float32)
        self._imu_rpy = np.zeros((0, 3), np.float32)
        self._imu_acc = np.zeros((0, 3), np.float32)
        self._sweep_clock = 0.0

    # ---- stages ----

    def _front(self, xyz, m, it, irpy, iacc, imask, t_scan):
        """One sweep with its IMU window (the scanRegistration IMU path,
        src/scanRegistration.cpp:286-347,638-660) through the replay's
        frontend as a batch of one frame: dead reckoning, the deskewed
        ingest, the mapping blend's [pitch, roll, ok] at the sweep end
        (pipeline.ingest_frames), then the features.  An all-masked
        window degrades to the no-IMU path (SweepImu.valid gates the
        deskew).  Returns (features, ImuTrans, map_rpy) of the sweep."""
        stream = imu_mod.imu_from_raw(it, irpy, iacc, imask)
        sweeps, imu_trans, map_rpy = ingest_frames(
            xyz[None], m[None], self.cfg, add_scenario_axis(stream),
            t_scan[None])
        return drop_scenario_axis(
            (extract_features(sweeps, self.cfg), imu_trans, map_rpy))

    def _imu_window(self, t_scan: float):
        """Snapshot the per-sweep IMU window [t_scan - 0.05,
        t_scan + scanPeriod + 0.05] into fixed-capacity arrays."""
        ts = np.zeros(_IMU_WINDOW, np.float32)
        rp = np.zeros((_IMU_WINDOW, 3), np.float32)
        ac = np.zeros((_IMU_WINDOW, 3), np.float32)
        mk = np.zeros(_IMU_WINDOW, bool)
        with self._imu_lock:
            t = self._imu_t
            lo = int(np.searchsorted(t, t_scan - 0.05))
            hi = min(
                int(np.searchsorted(
                    t, t_scan + self.cfg.scan_period + 0.05
                )),
                lo + _IMU_WINDOW,
            )
            n = hi - lo
            if n > 0:
                ts[:n] = t[lo:hi]
                rp[:n] = self._imu_rpy[lo:hi]
                ac[:n] = self._imu_acc[lo:hi]
                mk[:n] = True
        return ts, rp, ac, mk

    def _stage(self, queue: NativeQueue, process):
        """A stage thread: pop, process, until stopped.  The first
        exception of any stage stops the engine and is kept for the
        caller (drain, stop, push_*)."""
        on_card = (torch.cuda.device(self.device)
                   if self.device.type == "cuda" else contextlib.nullcontext())
        try:
            with on_card:
                while not self._stop.is_set():
                    item = queue.pop(timeout_ms=100)
                    if item is not None:
                        process(item)
        except BaseException as exc:  # noqa: BLE001 - re-raised to the caller
            with self._flight:
                if self._error is None:
                    self._error = exc
                self._flight.notify_all()
            self._stop.set()

    def _finished(self):
        """One sweep left the engine: done, or dropped by a full queue."""
        with self._flight:
            self._in_flight -= 1
            self._flight.notify_all()

    def _hand_on(self, queue: NativeQueue, item):
        """Pass a sweep in flight to the next stage's queue."""
        if not queue.push(item):
            self._finished()        # the queue dropped its oldest sweep

    def _process_front(self, item):
        xyz, m, t_scan = item
        windows = self._imu_window(t_scan)
        dev = self.device
        self._hand_on(self.q_feats, self._front(
            xyz, m, *(torch.from_numpy(a).to(dev) for a in windows),
            torch.tensor(np.float32(t_scan), device=dev)))

    def _process_odom(self, item):
        feats, imu_trans, map_rpy = item
        self._odom_state, out = odometry.odometry_step(
            self._odom_state, feats, self.cfg, imu=imu_trans)
        self.stats_.odom_frames += 1
        # transformMaintenance: integrate odometry with the latest
        # mapping correction, publish at odometry rate
        with self._pose_lock:
            bef, aft = self._bef, self._aft
        integrated = rotations.transform_associate_to_map(out.pose, bef, aft)
        # the frame's one host read: pose, integrated pose, publish flag
        host = torch.cat([out.pose, integrated,
                          out.publish_to_mapping.to(torch.float32)[None]]
                         ).cpu().numpy()
        pose, integrated = host[:6], host[6:12]
        with self._pose_lock:
            self._latest_integrated = integrated
            self._latest_odom = pose
            self._trajectory.append(integrated)
        self.stats_.integrated += 1
        if host[12] > 0.5:
            full = out.full if self.cfg.emit_registered else None
            self._hand_on(self.q_map, (out.pose, out.corner_last,
                                       out.surf_last, map_rpy, full))
        else:
            self._finished()

    def _process_map(self, item):
        pose, corner_last, surf_last, map_rpy, full = item
        new_map_state, mout = mapping.mapping_step(
            self._map_state, pose, corner_last, surf_last, self.cfg,
            imu_rpy=map_rpy, full=full)
        aft_host = mout.pose_aft.cpu().numpy()
        self.stats_.map_frames += 1
        with self._pose_lock:
            self._map_state = new_map_state
            self._bef = mout.pose_bef
            self._aft = mout.pose_aft
            self._latest_aft = aft_host
            if mout.registered is not None:
                self._latest_registered = mout.registered
        self._finished()

    # ---- public API ----

    def _raise_failure(self):
        if self._error is not None:
            raise self._error

    def start(self):
        self._raise_failure()
        self._stop.clear()
        for queue, process in ((self.q_raw, self._process_front),
                               (self.q_feats, self._process_odom),
                               (self.q_map, self._process_map)):
            t = threading.Thread(target=self._stage, args=(queue, process),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def push_sweep(self, xyz, mask, t_scan: float | None = None) -> bool:
        """Feed one raw sweep (non-blocking; oldest dropped under load,
        like the reference's lossy subscriber queues).  t_scan: sweep
        start time; defaults to a clock that starts at 0 and advances by
        cfg.scan_period a sweep."""
        self._raise_failure()
        if t_scan is None:
            t_scan = self._sweep_clock
            self._sweep_clock += self.cfg.scan_period
        self.stats_.frames_in += 1
        with self._flight:
            self._in_flight += 1
        kept = self.q_raw.push((
            torch.as_tensor(xyz, dtype=torch.float32).to(self.device),
            torch.as_tensor(mask, dtype=torch.bool).to(self.device),
            float(t_scan)))
        if not kept:
            self._finished()        # the oldest queued sweep was dropped
        return kept

    def push_imu(self, t, rpy, acc_velodyne) -> None:
        """Feed one IMU sample — the imuHandler subscription
        (src/scanRegistration.cpp:638-660).  rpy: (roll, pitch, yaw) from
        the orientation quaternion; acc_velodyne: raw velodyne-frame
        linear acceleration (gravity removal happens on the device in
        imu_from_raw)."""
        self._raise_failure()
        with self._imu_lock:
            self._imu_t = np.append(self._imu_t, np.float32(t))[-2048:]
            self._imu_rpy = np.vstack(
                [self._imu_rpy, np.asarray(rpy, np.float32)[None]]
            )[-2048:]
            self._imu_acc = np.vstack(
                [self._imu_acc, np.asarray(acc_velodyne, np.float32)[None]]
            )[-2048:]

    def latest_pose(self) -> np.ndarray:
        with self._pose_lock:
            return self._latest_integrated.copy()

    def latest_aft(self) -> np.ndarray:
        """Latest aft-mapped pose (/aft_mapped_to_init), locked."""
        with self._pose_lock:
            return self._latest_aft.copy()

    def latest_odom(self) -> np.ndarray:
        """Latest raw odometry pose (/laser_odom_to_init), locked."""
        with self._pose_lock:
            return self._latest_odom.copy()

    def latest_registered(self):
        """Latest registered full-res cloud
        (/velodyne_cloud_registered), or None when cfg.emit_registered
        is off or no mapping frame has completed yet.  Locked snapshot;
        a mapping frame makes new tensors, never writes into these."""
        with self._pose_lock:
            return self._latest_registered

    def map_state_snapshot(self):
        """Consistent (map_state, aft_pose) snapshot for observers.

        The mapping stage publishes both under the pose lock, so a reader
        taking the lock never sees a map from frame k paired with the
        pose of frame k+1.  A mapping frame builds a new MapState and
        never writes into the old one's tensors, so the snapshot is safe
        to read from any thread."""
        with self._pose_lock:
            return self._map_state, self._latest_aft.copy()

    def trajectory(self) -> np.ndarray:
        with self._pose_lock:
            return np.stack(self._trajectory) if self._trajectory else \
                np.zeros((0, 6), np.float32)

    def drain(self, timeout_s: float = 30.0):
        """Block until every pushed sweep is finished or dropped (for
        replay use); False on timeout.  Raises the first exception of a
        stage."""
        deadline = time.monotonic() + timeout_s
        with self._flight:
            while self._in_flight and self._error is None:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._flight.wait(left)
            idle = self._in_flight == 0
        self._raise_failure()
        return idle

    def stop(self):
        """Stop the stages; raises the first exception of a stage."""
        self._stop.set()
        for q in (self.q_raw, self.q_feats, self.q_map):
            q.close()
        for t in self._threads:
            t.join(timeout=5)
        self._threads.clear()
        self._raise_failure()

    def stats(self) -> EngineStats:
        self.stats_.queue_stats = {
            "raw": self.q_raw.stats(),
            "feats": self.q_feats.stats(),
            "map": self.q_map.stats(),
        }
        return self.stats_
