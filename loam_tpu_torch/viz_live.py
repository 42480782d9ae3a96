"""Live visualization server — the rviz-equivalent L5 (the port's own
copy of loam_tpu/viz_live.py).

The reference's L5 is rviz subscribed to four live displays
(rviz_cfg/loam_velodyne.rviz:91,118,130,157 in the reference):
/integrated_to_init (10 Hz pose + trail), /laser_odom_to_init,
/laser_cloud_surround (~1 Hz map cloud), /velodyne_cloud_registered.
Headless, the subscriber becomes an HTTP poller: ``LiveServer`` wraps
a running ``runtime.streaming.StreamingEngine`` and serves

* ``/``            a self-contained HTML viewer (no dependencies) with a
                   3-D orbit camera (drag = orbit, wheel = zoom,
                   shift-drag = pan; key T toggles a top-down ortho
                   view) drawing all four displays: trajectory trail,
                   integrated + odometry poses, surround map cloud, and
                   the registered full-res cloud;
* ``/state.json``  the live state: latest integrated / aft-mapped /
                   odometry poses, the 10 Hz trajectory trail, engine
                   stats, the surround cloud — recomputed at most every
                   ``surround_every`` seconds, mirroring the reference's
                   every-5th-mapping-frame (~1 Hz) surround cadence
                   (src/laserMapping.cpp:52,1038-1040) — and, when the
                   engine runs with cfg.emit_registered, the latest
                   registered cloud (src/laserMapping.cpp:1060-1069).

Zero impact on the estimation threads: state reads go through the
engine's locked accessors (map_state_snapshot / latest_aft /
latest_odom / latest_registered), and the surround extraction is a small
gather over the map tables on the engine's device, rate-limited and
cached, copied to the host before it is serialised.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>loam_tpu live</title>
<style>
 body { margin:0; background:#101216; color:#d8dee9;
        font:13px/1.4 system-ui, sans-serif; overflow:hidden; }
 #hud { position:fixed; top:10px; left:12px; background:#0009;
        padding:8px 12px; border-radius:6px; white-space:pre; }
 canvas { display:block; width:100vw; height:100vh; }
</style></head><body>
<canvas id="c"></canvas><div id="hud">connecting...</div>
<script>
// 3-D orbit viewer (the rviz Views panel equivalent): drag = orbit,
// wheel = zoom, shift-drag = pan, key T = top-down toggle.
const cv = document.getElementById('c'), hud = document.getElementById('hud');
const ctx = cv.getContext('2d');
let S = null;
let cam = { yaw: -0.7, pitch: 0.45, dist: 60,
            cx: 0, cy: 0, cz: 0, top: false };
function fit() { cv.width = innerWidth; cv.height = innerHeight; }
addEventListener('resize', fit); fit();
let drag = null;
cv.addEventListener('mousedown', e => {
  drag = { x: e.clientX, y: e.clientY, pan: e.shiftKey }; });
addEventListener('mouseup', () => drag = null);
addEventListener('mousemove', e => {
  if (!drag) return;
  const dx = e.clientX - drag.x, dy = e.clientY - drag.y;
  if (drag.pan) {
    const s = cam.dist / cv.height;
    const cy = Math.cos(cam.yaw), sy = Math.sin(cam.yaw);
    cam.cx -= (dx * cy) * s; cam.cz += (dx * sy) * s;
    cam.cy += dy * s;
  } else {
    cam.yaw += dx * 0.008;
    cam.pitch = Math.min(1.55, Math.max(-1.55, cam.pitch + dy * 0.008));
  }
  drag = { x: e.clientX, y: e.clientY, pan: drag.pan };
  draw();
});
cv.addEventListener('wheel', e => {
  cam.dist *= Math.exp(e.deltaY * 0.001);
  cam.dist = Math.min(2000, Math.max(2, cam.dist)); draw();
}, { passive: true });
addEventListener('keydown', e => {
  if (e.key === 't' || e.key === 'T') { cam.top = !cam.top; draw(); } });
function proj(p) {
  // world (x, y, z) with y up; camera orbits the follow point
  const x = p[0] - cam.cx, y = p[1] - cam.cy, z = p[2] - cam.cz;
  if (cam.top) {  // orthographic top-down (the round-4 view)
    const s = cv.height / cam.dist;
    return [cv.width / 2 + x * s, cv.height / 2 - z * s, 1];
  }
  const cyw = Math.cos(cam.yaw), syw = Math.sin(cam.yaw);
  const cp = Math.cos(cam.pitch), sp = Math.sin(cam.pitch);
  const x1 = x * cyw - z * syw, z1 = x * syw + z * cyw;
  const y2 = y * cp - z1 * sp, z2 = y * sp + z1 * cp + cam.dist;
  if (z2 < 0.5) return null;
  const f = cv.height * 0.9 / z2;
  return [cv.width / 2 + x1 * f, cv.height / 2 - y2 * f, f];
}
function dots(pts, color, size) {
  ctx.fillStyle = color;
  for (const p of pts) {
    const q = proj(p);
    if (q) ctx.fillRect(q[0], q[1], size, size);
  }
}
function draw() {
  ctx.fillStyle = '#101216'; ctx.fillRect(0, 0, cv.width, cv.height);
  if (!S) return;
  const tr = S.trajectory;
  if (tr.length) {  // follow the newest pose, rviz target-frame style
    const p = tr[tr.length - 1];
    cam.cx += (p[0] - cam.cx) * 0.2;
    cam.cy += (p[1] - cam.cy) * 0.2;
    cam.cz += (p[2] - cam.cz) * 0.2;
  }
  dots(S.surround, '#4c6ef5', 1.6);                 // /laser_cloud_surround
  dots(S.registered, '#63e6be', 1.2);               // /velodyne_cloud_registered
  ctx.strokeStyle = '#fab005'; ctx.lineWidth = 2;   // /integrated_to_init trail
  ctx.beginPath();
  let started = false;
  for (const p of tr) {
    const q = proj(p);
    if (!q) { started = false; continue; }
    if (started) ctx.lineTo(q[0], q[1]);
    else { ctx.moveTo(q[0], q[1]); started = true; }
  }
  ctx.stroke();
  if (tr.length) {
    const q = proj(tr[tr.length - 1]);
    if (q) { ctx.fillStyle = '#ff6b6b'; ctx.beginPath();
             ctx.arc(q[0], q[1], 5, 0, 7); ctx.fill(); }
  }
  if (S.odom) {                                     // /laser_odom_to_init
    const q = proj(S.odom.slice(3));
    if (q) { ctx.strokeStyle = '#a9e34b'; ctx.lineWidth = 1.5;
             ctx.beginPath(); ctx.arc(q[0], q[1], 7, 0, 7); ctx.stroke(); }
  }
  hud.textContent =
    `frames odo/map: ${S.stats.odom_frames}/${S.stats.map_frames}` +
    `\\npose: [${S.integrated.slice(3).map(v => v.toFixed(2))}]` +
    `\\nsurround: ${S.surround.length}  registered: ${S.registered.length}` +
    `\\nview: ${cam.top ? 'top-down (T: orbit)' : 'orbit (T: top-down)'}` +
    `  seq: ${S.seq}`;
}
async function tick() {
  try {
    const r = await fetch('state.json'); S = await r.json(); draw();
  } catch (e) { hud.textContent = 'poll failed: ' + e; }
  setTimeout(tick, 400);
}
tick();
</script></body></html>"""


class LiveServer:
    """Serve a live view of a running StreamingEngine over HTTP."""

    def __init__(self, engine, port: int = 0,
                 surround_every: float = 1.0, surround_cap: int = 16384,
                 registered_cap: int = 8192, trail_cap: int = 4096):
        from . import mapping as mapping_mod

        self._engine = engine
        self._surround_every = surround_every
        self._surround_cap = surround_cap
        self._registered_cap = registered_cap
        self._trail_cap = trail_cap
        self._mapping_mod = mapping_mod
        # -inf: the first poll fetches, whatever time.monotonic() reads
        # (seconds since boot on Linux, under surround_every after a boot)
        self._surround_cache: list = []
        self._surround_t = float("-inf")
        self._registered_cache: list = []
        self._registered_t = float("-inf")
        self._surround_lock = threading.Lock()
        self._seq = 0

        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                if self.path.split("?")[0] in ("/", "/index.html"):
                    body = _PAGE.encode()
                    ctype = "text/html; charset=utf-8"
                elif self.path.split("?")[0] == "/state.json":
                    body = json.dumps(server._state()).encode()
                    ctype = "application/json"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}/"

    def _surround(self):
        """Rate-limited surround-cloud extraction (the ~1 Hz
        /laser_cloud_surround analogue)."""
        now = time.monotonic()
        with self._surround_lock:
            if now - self._surround_t < self._surround_every:
                return self._surround_cache
            self._surround_t = now
        map_state, _ = self._engine.map_state_snapshot()
        if map_state is None:
            return self._surround_cache
        cloud = self._mapping_mod.surround_cloud(
            map_state, cap=self._surround_cap
        )
        xyz = cloud.xyz.cpu().numpy()[cloud.mask.cpu().numpy()]
        pts = np.round(xyz.astype(np.float64), 3).tolist()
        with self._surround_lock:
            self._surround_cache = pts
        return pts

    def _registered(self):
        """Rate-limited registered-cloud snapshot
        (/velodyne_cloud_registered); empty when the engine runs without
        cfg.emit_registered."""
        now = time.monotonic()
        with self._surround_lock:
            if now - self._registered_t < self._surround_every:
                return self._registered_cache
        cloud = self._engine.latest_registered()
        if cloud is None:   # not stamped: the next poll looks again
            return self._registered_cache
        xyz = cloud.xyz.cpu().numpy()[cloud.mask.cpu().numpy()]
        if xyz.shape[0] > self._registered_cap:
            step = -(-xyz.shape[0] // self._registered_cap)
            xyz = xyz[::step]
        pts = np.round(xyz.astype(np.float64), 3).tolist()
        with self._surround_lock:
            self._registered_cache = pts
            self._registered_t = now
        return pts

    def _state(self) -> dict:
        eng = self._engine
        traj = eng.trajectory()
        if traj.shape[0] > self._trail_cap:
            # decimate the trail, always keeping the newest pose
            step = -(-traj.shape[0] // self._trail_cap)
            traj = np.concatenate([traj[::step], traj[-1:]])
        st = eng.stats()
        self._seq += 1
        return {
            "seq": self._seq,
            "integrated": [float(v) for v in eng.latest_pose()],
            "aft": [float(v) for v in eng.latest_aft()],
            "odom": [float(v) for v in eng.latest_odom()],
            "trajectory": np.round(
                traj[:, 3:6].astype(np.float64), 3
            ).tolist(),
            "surround": self._surround(),
            "registered": self._registered(),
            "stats": {
                "odom_frames": st.odom_frames,
                "map_frames": st.map_frames,
                "dropped": sum(q["dropped"]
                               for q in st.queue_stats.values()),
            },
        }

    def start(self):
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
