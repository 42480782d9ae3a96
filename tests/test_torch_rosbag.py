"""The port's rosbag reader (loam_tpu_torch/io/rosbag.py over its own
copy of the native sources) against loam_tpu.io.rosbag, on bags written
by the tests' pure-Python writer (torch_parity, a copy of
test_rosbag's, held byte-equal to it here): uncompressed and bz2
chunks, clouds with and without ring/time fields, an IMU stream."""

import os

import numpy as np
import pytest

import test_rosbag as TRB
import torch_parity as TPB

from loam_tpu.io import rosbag as JRB

from loam_tpu_torch.io import rosbag as TRBAG

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _code_lines(path):
    """The lines of a source, comment lines blanked."""
    with open(path, "rb") as f:
        return [b"//" if ln.lstrip().startswith(b"//") else ln
                for ln in f.read().splitlines()]


@pytest.mark.parametrize("name", ["bag_reader.cc", "runtime.cc",
                                  "Makefile"])
def test_native_sources_are_loam_tpus(name):
    """The port's native sources are loam_tpu/native's, line for line;
    of the comments only one line of bag_reader.cc differs (it named a
    local checkout of the reference), the rest are equal too."""
    port = os.path.join(ROOT, "loam_tpu_torch", "native", name)
    jax_ = os.path.join(ROOT, "loam_tpu", "native", name)
    assert _code_lines(port) == _code_lines(jax_)
    with open(port, "rb") as a, open(jax_, "rb") as b:
        differ = sum(x != y for x, y in zip(a.read().splitlines(),
                                            b.read().splitlines()))
    assert differ == (1 if name == "bag_reader.cc" else 0)


# (connection, message, PointCloud2, Imu) record makers of each writer
WRITERS = {
    "port": (TPB.connection, TPB.message, TPB.pointcloud2, TPB.imu_message),
    "test_rosbag": (TRB._connection, TRB._message, TRB._pointcloud2,
                    TRB._imu),
}


def _messages(writer, data, with_ring=True):
    conn, msg, pc2, imu = WRITERS[writer]
    clouds, rings, rels, imu_t, quat, acc = data
    recs = [conn(0, b"/velodyne_points", b"sensor_msgs/PointCloud2"),
            conn(1, b"/imu/data", b"sensor_msgs/Imu")]
    for k, xyz in enumerate(clouds):
        stamp = 100.0 + 0.1 * k
        recs.append(msg(0, stamp, pc2(
            stamp, xyz, rings[k] if with_ring else None,
            rels[k] if with_ring else None)))
    for i in range(len(imu_t)):
        recs.append(msg(1, imu_t[i], imu(imu_t[i], quat[i], [0.0, 0.0, 0.0],
                                         acc[i])))
    return recs


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(5)
    clouds = [rng.normal(scale=10.0, size=(n, 3)).astype(np.float32)
              for n in (60, 45, 70)]
    clouds[1][3] = np.nan    # a non-finite point is masked out
    rings = [rng.integers(0, 16, c.shape[0]).astype(np.uint16)
             for c in clouds]
    rels = [rng.uniform(0, 0.1, c.shape[0]).astype(np.float32)
            for c in clouds]
    imu_t = np.arange(12) * 0.01 + 100.0
    quat = rng.normal(size=(12, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    acc = rng.normal(size=(12, 3))
    return clouds, rings, rels, imu_t, quat, acc


@pytest.mark.parametrize("compression", [b"none", b"bz2"])
@pytest.mark.parametrize("with_ring", [True, False])
def test_reader_matches_loam_tpu(tmp_path, data, compression, with_ring):
    path = str(tmp_path / "t.bag")
    TPB.write_bag(path, _messages("port", data, with_ring), compression)
    ref = str(tmp_path / "ref.bag")
    TRB.write_bag(ref, _messages("test_rosbag", data, with_ring),
                  compression)
    with open(path, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()     # the writer is test_rosbag's

    with TRBAG.BagReader(path) as tb, JRB.BagReader(path) as jb:
        assert tb.topics() == jb.topics()
        assert tb.count("/velodyne_points") == 3
        for k in range(3):
            got = tb.read_cloud("/velodyne_points", k)
            want = jb.read_cloud("/velodyne_points", k)
            for g, w in zip(got, want):
                if w is None:
                    assert g is None
                else:
                    np.testing.assert_array_equal(g, w)
            if with_ring:
                np.testing.assert_array_equal(got[1], data[1][k])
        tr, jr = tb.read_imu("/imu/data"), jb.read_imu("/imu/data")
        for name in ("t", "quat", "ang_vel", "lin_acc"):
            np.testing.assert_array_equal(getattr(tr, name),
                                          getattr(jr, name))

    for kw in (dict(), dict(max_points=64, skip=1)):
        for g, w in zip(TRBAG.load_sweeps(path, **kw),
                        JRB.load_sweeps(path, **kw)):
            np.testing.assert_array_equal(g, w)
    raw, mask, _ = TRBAG.load_sweeps(path, max_points=64)
    assert raw.shape == (3, 64, 3) and mask.sum() == 60 + 44 + 64
    for g, w in zip(TRBAG.load_imu_stream(path),
                    JRB.load_imu_stream(path)):
        np.testing.assert_array_equal(g, w)


def test_rejects_garbage(tmp_path):
    path = str(tmp_path / "bad.bag")
    with open(path, "wb") as f:
        f.write(b"not a bag at all")
    with pytest.raises(IOError):
        TRBAG.BagReader(path)
    with pytest.raises(IOError):
        TRBAG.load_sweeps(path)


def test_library_lands_in_build_dir():
    """The library is built from the port's own sources into the
    gitignored _build/ directory, keyed by their hash; nothing is
    written beside the sources."""
    TRBAG._load()
    lib = TRBAG.library_path()
    assert lib.exists()
    assert lib.parent == TRBAG.BUILD_DIR
    assert lib.parent.name == "_build" and \
        lib.parent.parent.name == "loam_tpu_torch"
    assert sorted(os.listdir(TRBAG.NATIVE_DIR)) == [
        "Makefile", "bag_reader.cc", "runtime.cc"]


def test_raw_imu_inverts_imu_from_raw():
    """torch_parity.raw_imu and rpy_to_quat (what the card's bag run
    writes) invert the loader's decode and imu_from_raw's gravity
    removal and axis swap."""
    import torch

    from loam_tpu_torch import imu as TI

    rng = np.random.default_rng(3)
    pyr = rng.uniform(-0.4, 0.4, (50, 3))
    acc_int = rng.normal(size=(50, 3))
    rpy, acc = TPB.raw_imu(pyr, acc_int)
    np.testing.assert_allclose(TRBAG.quat_to_rpy(TPB.rpy_to_quat(rpy)), rpy,
                               rtol=0, atol=1e-12)
    stream = TI.imu_from_raw(torch.zeros(50), torch.tensor(rpy),
                             torch.tensor(acc), torch.ones(50, dtype=bool))
    np.testing.assert_allclose(stream.rpy.numpy(), pyr, rtol=0, atol=1e-6)
    np.testing.assert_allclose(stream.acc.numpy(), acc_int, rtol=0,
                               atol=1e-5)
