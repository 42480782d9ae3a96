"""rosbag data layer: native reader binding + sweep/IMU packing (the
port's own copy of loam_tpu/io/rosbag.py, NumPy only).

The reference replays rosbag datasets through roscpp subscriptions
(README.md:25-33, src/scanRegistration.cpp:662-693 in the reference).
Standalone equivalent: loam_tpu_torch/native/bag_reader.cc parses the
public rosbag 2.0 container directly (bz2/lz4 chunks included) and this
module packs the messages into the padded arrays the pipeline consumes.

The native library is built from the sources at first use, with the
flags of native/Makefile, into the gitignored loam_tpu_torch/_build/,
keyed by a hash of the sources: nothing is written beside them, and an
edited source rebuilds.  It also holds the streaming engine's queues
(native/runtime.cc, the loam_q_* functions).  Building and loading are
safe from several threads and processes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from dataclasses import dataclass
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
NATIVE_DIR = _PKG / "native"
NATIVE_SOURCES = ("bag_reader.cc", "runtime.cc")
BUILD_DIR = _PKG / "_build"
# native/Makefile's CXXFLAGS and link line
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared")
LINK_FLAGS = ("-ldl", "-lpthread")

_lib = None
_LOAD_LOCK = threading.Lock()


def library_path() -> Path:
    """Where the library of the current sources lives."""
    sha = hashlib.sha1(" ".join(CXX_FLAGS + LINK_FLAGS).encode())
    for name in NATIVE_SOURCES:
        sha.update((NATIVE_DIR / name).read_bytes())
    return BUILD_DIR / f"libloam_native_{sha.hexdigest()[:12]}.so"


def _build() -> Path:
    """Compile the native sources unless the library is current.  Several
    processes and threads may build at once: each writes its own
    temporary file and renames it into place."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp),
           *(str(NATIVE_DIR / n) for n in NATIVE_SOURCES), *LINK_FLAGS]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the native library failed:\n"
                           f"{' '.join(cmd)}\n{done.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    """Build (if needed) and load the native library, once, under a
    lock; every signature is declared here."""
    global _lib
    if _lib is not None:
        return _lib
    with _LOAD_LOCK:
        if _lib is None:
            _lib = _declared(ctypes.CDLL(str(_build())))
    return _lib


def _declared(lib):
    lib.loam_bag_open.restype = ctypes.c_void_p
    lib.loam_bag_open.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int
    ]
    lib.loam_bag_close.argtypes = [ctypes.c_void_p]
    lib.loam_bag_topics.restype = ctypes.c_int
    lib.loam_bag_topics.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int
    ]
    lib.loam_bag_count.restype = ctypes.c_long
    lib.loam_bag_count.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.loam_bag_read_cloud.restype = ctypes.c_long
    lib.loam_bag_read_cloud.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float), ctypes.c_long,
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.loam_bag_read_imu.restype = ctypes.c_long
    lib.loam_bag_read_imu.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_long,
    ]
    # the streaming engine's drop-oldest handle queues
    lib.loam_q_create.restype = ctypes.c_void_p
    lib.loam_q_create.argtypes = [ctypes.c_long]
    lib.loam_q_push.restype = ctypes.c_int
    lib.loam_q_push.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.loam_q_pop.restype = ctypes.c_int
    lib.loam_q_pop.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64), ctypes.c_long,
    ]
    lib.loam_q_close.argtypes = [ctypes.c_void_p]
    lib.loam_q_stats.argtypes = [ctypes.c_void_p] + [
        ctypes.POINTER(ctypes.c_uint64)] * 4
    lib.loam_q_destroy.argtypes = [ctypes.c_void_p]
    return lib


@dataclass
class ImuRecords:
    t: np.ndarray        # (M,) float64 stamps
    quat: np.ndarray     # (M, 4) xyzw orientation
    ang_vel: np.ndarray  # (M, 3)
    lin_acc: np.ndarray  # (M, 3)


class BagReader:
    """Random-access reader over one bag file."""

    def __init__(self, path: str):
        lib = _load()
        err = ctypes.create_string_buffer(256)
        self._h = lib.loam_bag_open(path.encode(), err, 256)
        if not self._h:
            raise IOError(f"bag open failed: {err.value.decode()}")
        self._lib = lib

    def close(self):
        if self._h:
            self._lib.loam_bag_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    def topics(self) -> dict:
        buf = ctypes.create_string_buffer(1 << 16)
        self._lib.loam_bag_topics(self._h, buf, len(buf))
        out = {}
        for line in buf.value.decode().strip().splitlines():
            topic, _, typ = line.partition("\t")
            out[topic] = typ
        return out

    def count(self, topic: str) -> int:
        return int(self._lib.loam_bag_count(self._h, topic.encode()))

    def read_cloud(self, topic: str, index: int, cap: int = 150000):
        """Returns (xyz (n,3) float32, ring (n,) int32 or None,
        rel_time (n,) float32 or None, stamp float)."""
        xyz = np.empty((cap, 3), np.float32)
        ring = np.empty((cap,), np.int32)
        rel = np.empty((cap,), np.float32)
        stamp = ctypes.c_double()
        n = self._lib.loam_bag_read_cloud(
            self._h, topic.encode(), index,
            xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ring.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            rel.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            cap, ctypes.byref(stamp),
        )
        if n < 0:
            raise IOError(f"cloud read failed: {topic}[{index}]")
        ring_out = ring[:n] if (ring[:n] >= 0).any() else None
        rel_out = rel[:n] if np.isfinite(rel[:n]).any() else None
        return xyz[:n], ring_out, rel_out, stamp.value

    def read_imu(self, topic: str, cap: int = 1 << 20) -> ImuRecords:
        t = np.empty((cap,), np.float64)
        quat = np.empty((cap, 4), np.float64)
        av = np.empty((cap, 3), np.float64)
        la = np.empty((cap, 3), np.float64)
        n = self._lib.loam_bag_read_imu(
            self._h, topic.encode(),
            t.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            quat.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            av.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            la.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            cap,
        )
        return ImuRecords(t[:n], quat[:n], av[:n], la[:n])


def quat_to_rpy(quat_xyzw: np.ndarray) -> np.ndarray:
    """tf::Matrix3x3(q).getRPY equivalent (ZYX convention) — the
    orientation decode of the reference imuHandler
    (src/scanRegistration.cpp:640-643).  quat (M, 4) xyzw -> (M, 3)
    (roll, pitch, yaw)."""
    x, y, z, w = (quat_xyzw[:, 0], quat_xyzw[:, 1],
                  quat_xyzw[:, 2], quat_xyzw[:, 3])
    roll = np.arctan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = np.arcsin(np.clip(2 * (w * y - z * x), -1.0, 1.0))
    yaw = np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return np.stack([roll, pitch, yaw], -1)


def load_sweeps(path: str, topic: str = "/velodyne_points",
                max_points: int | None = None, skip: int = 0):
    """Load all sweeps from a bag into padded (F, N, 3) float32 + mask +
    stamps.  `skip` drops the first frames (the reference's systemDelay,
    src/scanRegistration.cpp:57,213-219).
    """
    with BagReader(path) as bag:
        n_msgs = bag.count(topic)
        clouds, stamps = [], []
        for k in range(skip, n_msgs):
            xyz, _, _, stamp = bag.read_cloud(topic, k)
            finite = np.isfinite(xyz).all(axis=1)
            clouds.append((xyz, finite))
            stamps.append(stamp)
    if not clouds:
        raise IOError(f"no messages on {topic}")
    cap = max_points or max(c[0].shape[0] for c in clouds)
    F = len(clouds)
    out = np.zeros((F, cap, 3), np.float32)
    mask = np.zeros((F, cap), bool)
    for k, (xyz, finite) in enumerate(clouds):
        n = min(cap, xyz.shape[0])
        out[k, :n] = xyz[:n]
        mask[k, :n] = finite[:n]
    return out, mask, np.asarray(stamps)


def load_imu_stream(path: str, topic: str = "/imu/data"):
    """Load the IMU stream as (t, rpy(roll,pitch,yaw), lin_acc) numpy
    arrays ready for loam_tpu_torch.imu.imu_from_raw."""
    with BagReader(path) as bag:
        rec = bag.read_imu(topic)
    return rec.t, quat_to_rpy(rec.quat), rec.lin_acc
