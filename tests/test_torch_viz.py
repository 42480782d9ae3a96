"""loam_tpu_torch.viz and viz_live (the rviz layer) against loam_tpu's:
the HTML viewer byte for byte, the dashboard PNG where matplotlib is
installed, and the live server over the port's streaming engine."""

import dataclasses
import importlib.util
import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from loam_tpu import viz as JV

from loam_tpu_torch import viz as TV
from loam_tpu_torch.config import LoamConfig
from loam_tpu_torch.io import synth
from loam_tpu_torch.runtime.streaming import StreamingEngine
from loam_tpu_torch.viz_live import LiveServer

torch.set_num_threads(1)


def _fake_run(F=40, N=500, seed=0):
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 4 * np.pi, F)
    pos = np.stack([np.sin(t), 0.05 * t, t], axis=1)
    poses = np.concatenate([np.zeros((F, 3)), pos], axis=1)
    trajs = {
        "integrated": poses,
        "aft_mapped": poses + rng.normal(0, 0.01, poses.shape),
        "odom": poses + rng.normal(0, 0.05, poses.shape),
    }
    xyz = rng.normal(0, 5, (N, 3)).astype(np.float32)
    mask = rng.random(N) > 0.2
    return trajs, xyz, mask


@pytest.mark.parametrize("as_tensors", [False, True])
def test_html_viewer_equals_loam_tpu(tmp_path, as_tensors):
    """The same trajectories and clouds give loam_tpu's file byte for
    byte, from NumPy arrays or from tensors; masked and non-finite points
    are left out and a large cloud is decimated alike."""
    trajs, xyz, mask = _fake_run(N=5000)
    xyz[7] = np.nan
    clouds = {"map": (xyz, mask), "bare": xyz[:300]}
    JV.export_html_viewer(str(tmp_path / "j.html"), trajs, clouds=clouds,
                          max_points=1000)
    if as_tensors:
        trajs = {k: torch.tensor(v) for k, v in trajs.items()}
        clouds = {"map": (torch.tensor(xyz), torch.tensor(mask)),
                  "bare": torch.tensor(xyz[:300])}
    TV.export_html_viewer(str(tmp_path / "t.html"), trajs, clouds=clouds,
                          max_points=1000)
    want = (tmp_path / "j.html").read_bytes()
    assert (tmp_path / "t.html").read_bytes() == want
    payload = want.decode().split("const DATA = ", 1)[1].split(";\n", 1)[0]
    data = json.loads(payload)
    assert {t["name"] for t in data["trajs"]} == set(trajs)
    assert len(data["clouds"][0]["pts"]) <= 3 * 1001


def test_dashboard_png(tmp_path):
    """The four rviz displays in one PNG (tests/test_viz.py), from
    tensors too."""
    if importlib.util.find_spec("matplotlib") is None:
        pytest.skip("needs matplotlib")
    trajs, xyz, mask = _fake_run()
    out = TV.plot_dashboard(
        str(tmp_path / "viz.png"),
        {k: torch.tensor(v) for k, v in trajs.items()},
        map_xyz=torch.tensor(xyz), map_mask=torch.tensor(mask),
        registered_xyz=xyz[:100], registered_mask=mask[:100],
    )
    with open(out, "rb") as f:
        assert f.read(8)[:4] == b"\x89PNG"
    assert os.path.getsize(out) > 10000
    pos_only = TV.plot_dashboard(str(tmp_path / "v.png"),
                                 {k: v[:, 3:] for k, v in trajs.items()})
    assert os.path.getsize(pos_only) > 0


CFG = dataclasses.replace(
    LoamConfig(),
    ring_width=512,
    max_less_flat=4096,
    less_flat_ring_cap=256,
    corner_table_size=1 << 12,
    surf_table_size=1 << 13,
    search_buckets=1 << 10,
    max_corner_from_map=1024,
    max_surf_from_map=2048,
    max_corner_stack=512,
    max_surf_stack=1024,
    odom_max_iters=5,
    map_max_iters=3,
    # live /velodyne_cloud_registered (rviz_cfg/loam_velodyne.rviz:157)
    emit_registered=True,
)


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, r.read()


def test_live_server_serves_state_and_page():
    """While the port's engine estimates online, an HTTP poller sees the
    viewer page, a growing pose trail, the rate-limited surround cloud
    and the registered cloud (tests/test_viz_live.py, same keys)."""
    world = synth.make_world(seed=3)
    F = 5
    poses = synth.straight_trajectory(F, speed=0.8)
    poses = np.vstack([poses[:1], poses])[: F + 1]

    eng = StreamingEngine(CFG, device="cpu")
    eng.start()
    live = LiveServer(eng, port=0, surround_every=0.0).start()
    try:
        status, body = _get(live.url)
        assert status == 200
        assert b"state.json" in body and b"<canvas" in body

        status, body = _get(live.url + "state.json")
        s0 = json.loads(body)
        assert status == 200 and s0["stats"]["odom_frames"] == 0
        assert set(s0) == {"seq", "integrated", "aft", "odom", "trajectory",
                           "surround", "registered", "stats"}

        for k in range(F):
            xyz, m = synth.simulate_sweep(
                world, poses[k], poses[k + 1], n_azimuth=300, seed=3 + k
            )
            eng.push_sweep(xyz, m, t_scan=0.1 * k)
            assert eng.drain(timeout_s=120)

        status, body = _get(live.url + "state.json")
        s1 = json.loads(body)
        assert s1["stats"]["odom_frames"] == F
        assert s1["stats"]["map_frames"] >= 1
        assert len(s1["trajectory"]) >= F - 1
        assert len(s1["integrated"]) == 6
        assert np.isfinite(np.asarray(s1["integrated"])).all()
        assert len(s1["surround"]) > 100
        assert len(s1["odom"]) == 6
        assert np.isfinite(np.asarray(s1["odom"])).all()
        assert len(s1["registered"]) > 100
        assert np.isfinite(np.asarray(s1["registered"])).all()
        assert s1["seq"] > s0["seq"]
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(live.url + "nope")
        assert err.value.code == 404
    finally:
        live.stop()
        eng.stop()


class _StubEngine:
    """What LiveServer reads of a StreamingEngine, with set stats and a
    registered cloud that a test sets."""

    def __init__(self, stats):
        self._stats = stats
        self.registered = None

    def trajectory(self):
        return np.zeros((2, 6))

    def stats(self):
        return self._stats

    def latest_pose(self):
        return np.zeros(6)

    latest_aft = latest_odom = latest_pose

    def map_state_snapshot(self):
        return None, None

    def latest_registered(self):
        return self.registered


def test_live_state_reports_the_queues_drops():
    """"dropped" is the sum of the engine's per-queue drops (EngineStats
    has no field of that name; its queue_stats has one a queue)."""
    from loam_tpu_torch.runtime.streaming import EngineStats

    queues = {name: dict(pushed=9, popped=9 - d, dropped=d, depth=0)
              for name, d in (("sweeps", 3), ("features", 4), ("map", 0))}
    stats = EngineStats(frames_in=9, odom_frames=5, map_frames=2,
                        queue_stats=queues)
    live = LiveServer(_StubEngine(stats), port=0)
    try:
        s = live._state()
    finally:
        live._httpd.server_close()
    assert s["stats"] == {"odom_frames": 5, "map_frames": 2, "dropped": 7}


def _clock(monkeypatch, *readings):
    """time.monotonic in viz_live reads `readings` in turn, small values
    as on a machine booted seconds ago."""
    import loam_tpu_torch.viz_live as VL

    it = iter(readings)
    monkeypatch.setattr(VL.time, "monotonic", lambda: next(it))


def test_live_registered_waits_for_a_cloud_before_rate_limiting(monkeypatch):
    """A poll that finds no registered cloud yet does not start the rate
    limit: the next poll, well inside surround_every, fetches the cloud
    that has arrived; after that the cache holds until the limit.  The
    clock reads under surround_every from the first poll on, as on a
    machine booted less than surround_every ago."""
    from loam_tpu_torch.runtime.streaming import EngineStats

    eng = _StubEngine(EngineStats())
    live = LiveServer(eng, port=0, surround_every=3600.0)
    _clock(monkeypatch, 5.0, 6.0, 7.0)
    try:
        assert live._registered() == []
        eng.registered = dataclasses.make_dataclass(
            "Cloud", ["xyz", "mask"])(torch.tensor([[1.0, 2.0, 3.0],
                                                    [4.0, 5.0, 6.0]]),
                                      torch.tensor([True, False]))
        assert live._registered() == [[1.0, 2.0, 3.0]]
        eng.registered = None
        assert live._registered() == [[1.0, 2.0, 3.0]]
    finally:
        live._httpd.server_close()


def test_live_surround_fetches_on_the_first_poll(monkeypatch):
    """The first poll extracts the surround cloud of a map that exists,
    whatever the clock reads (here under surround_every, as on a machine
    booted less than surround_every ago); the next poll inside the limit
    returns the cache."""
    from loam_tpu_torch.runtime.streaming import EngineStats

    class Mapped(_StubEngine):
        def map_state_snapshot(self):
            return "map", None

    cloud = dataclasses.make_dataclass("Cloud", ["xyz", "mask"])(
        torch.tensor([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]]),
        torch.tensor([False, True]))
    calls = []

    class Mapping:
        @staticmethod
        def surround_cloud(map_state, cap):
            calls.append((map_state, cap))
            return cloud

    live = LiveServer(Mapped(EngineStats()), port=0, surround_every=3600.0,
                      surround_cap=7)
    live._mapping_mod = Mapping
    _clock(monkeypatch, 5.0, 6.0)
    try:
        assert live._surround() == [[4.0, 5.0, 6.0]]
        assert live._surround() == [[4.0, 5.0, 6.0]]
    finally:
        live._httpd.server_close()
    assert calls == [("map", 7)]
