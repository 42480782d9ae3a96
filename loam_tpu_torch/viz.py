"""Visualization — the rviz layer of the reference (SURVEY.md §1 L5); the
port's own copy of loam_tpu/viz.py.

The reference's only dashboard is rviz displaying four topics
(`rviz_cfg/loam_velodyne.rviz:91,118,130,157`): the integrated trajectory,
the odometry trajectory, the map surround cloud, and the registered full
cloud.  Headless hosts have no rviz; the equivalents here are

* :func:`plot_dashboard` — a single PNG with the same four displays
  (top-down map + trajectories, altitude profile, 3-D view, stage rates),
* :func:`export_html_viewer` — a self-contained zero-dependency HTML file
  with an orbiting 3-D canvas renderer of the map cloud + trajectories
  (pure inline JS; works offline, no CDN).

Both take plain numpy arrays (a tensor on any device is copied to one on
the way in) and draw on the host.  Internal frame convention (SURVEY.md
§1): z = forward, x = left, y = up — the top-down view is therefore the
(z, x) plane.
"""

from __future__ import annotations

import json

import numpy as np

# reference rviz colors: trajectories drawn as distinct line strips;
# we keep a fixed readable palette (colorblind-safe).
_TRAJ_COLORS = {
    "integrated": "#2a7de1",   # blue   — /integrated_to_init
    "aft_mapped": "#d94f04",   # orange — /aft_mapped_to_init
    "odom": "#767676",         # grey   — /laser_odom_to_init
    "gt": "#1a9850",           # green  — ground truth (synthetic runs)
}


def _np(a):
    """A NumPy view of an array or a tensor on any device."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def _positions(traj):
    """(F, 6) pose rows or (F, 3) positions -> (F, 3) positions."""
    traj = _np(traj)
    return traj[:, 3:6] if traj.shape[-1] == 6 else traj[:, :3]


def plot_dashboard(out_path, trajectories, map_xyz=None, map_mask=None,
                   registered_xyz=None, registered_mask=None,
                   title="loam_tpu"):
    """Render the four rviz displays into one PNG.

    trajectories: dict name -> (F, 6) poses or (F, 3) positions;
    map_xyz/map_mask: the /laser_cloud_surround equivalent;
    registered_xyz: the /velodyne_cloud_registered equivalent (last frame).
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(13, 9), dpi=110)
    fig.suptitle(title, fontsize=13)

    ax = fig.add_subplot(2, 2, 1)
    _scatter_topdown(ax, map_xyz, map_mask, registered_xyz, registered_mask)
    for name, traj in trajectories.items():
        p = _positions(traj)
        ax.plot(p[:, 2], p[:, 0], lw=1.6, label=name,
                color=_TRAJ_COLORS.get(name))
    ax.set_xlabel("z forward [m]")
    ax.set_ylabel("x left [m]")
    ax.set_title("top-down: map + trajectories")
    ax.axis("equal")
    ax.legend(fontsize=8, loc="best")

    ax = fig.add_subplot(2, 2, 2)
    for name, traj in trajectories.items():
        p = _positions(traj)
        ax.plot(p[:, 1], lw=1.4, label=name, color=_TRAJ_COLORS.get(name))
    ax.set_xlabel("frame")
    ax.set_ylabel("y up [m]")
    ax.set_title("altitude profile")
    ax.legend(fontsize=8, loc="best")

    ax = fig.add_subplot(2, 2, 3, projection="3d")
    if map_xyz is not None:
        pts = _masked(map_xyz, map_mask, cap=20000)
        if pts.shape[0]:
            ax.scatter(pts[:, 2], pts[:, 0], pts[:, 1], s=0.3, alpha=0.35,
                       c=pts[:, 1], cmap="viridis")
    for name, traj in trajectories.items():
        p = _positions(traj)
        ax.plot(p[:, 2], p[:, 0], p[:, 1], lw=1.6,
                color=_TRAJ_COLORS.get(name))
    ax.set_title("3-D view")

    ax = fig.add_subplot(2, 2, 4)
    names = list(trajectories)
    if len(names) >= 2 and "integrated" in names:
        ref = _positions(trajectories["integrated"])
        for name in names:
            if name in ("integrated", "gt"):
                continue
            p = _positions(trajectories[name])
            n = min(len(p), len(ref))
            d = np.linalg.norm(p[:n] - ref[:n], axis=1)
            ax.plot(d, lw=1.2, label=f"|{name} - integrated|",
                    color=_TRAJ_COLORS.get(name))
        if "gt" in names:
            g = _positions(trajectories["gt"])
            n = min(len(g), len(ref))
            ax.plot(np.linalg.norm(ref[:n] - g[:n], axis=1), lw=1.2,
                    label="|integrated - gt|", color=_TRAJ_COLORS["gt"])
        ax.set_ylabel("deviation [m]")
        ax.legend(fontsize=8)
    ax.set_xlabel("frame")
    ax.set_title("stage deviations")

    fig.tight_layout(rect=(0, 0, 1, 0.96))
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def _masked(xyz, mask, cap=None):
    xyz = _np(xyz).astype(np.float32, copy=False).reshape(-1, 3)
    if mask is not None:
        xyz = xyz[_np(mask).reshape(-1)]
    xyz = xyz[np.isfinite(xyz).all(axis=1)]
    if cap is not None and xyz.shape[0] > cap:
        step = int(np.ceil(xyz.shape[0] / cap))
        xyz = xyz[::step]
    return xyz


def _scatter_topdown(ax, map_xyz, map_mask, reg_xyz, reg_mask):
    if map_xyz is not None:
        pts = _masked(map_xyz, map_mask, cap=60000)
        if pts.shape[0]:
            ax.scatter(pts[:, 2], pts[:, 0], s=0.25, alpha=0.3,
                       c="#9aa7b0", linewidths=0)
    if reg_xyz is not None:
        pts = _masked(reg_xyz, reg_mask, cap=30000)
        if pts.shape[0]:
            ax.scatter(pts[:, 2], pts[:, 0], s=0.3, alpha=0.5,
                       c="#caa24b", linewidths=0)


# ---------------------------------------------------------------------------
# self-contained HTML viewer
# ---------------------------------------------------------------------------

_HTML_TEMPLATE = """<!doctype html>
<html><head><meta charset="utf-8"><title>loam_tpu viewer</title>
<style>
 body{margin:0;background:#14181d;color:#cfd8df;font:12px sans-serif}
 #hud{position:fixed;top:8px;left:10px;line-height:1.5;user-select:none}
 canvas{display:block}
 .sw{display:inline-block;width:9px;height:9px;border-radius:2px;
     margin-right:4px;vertical-align:-1px}
</style></head><body>
<div id="hud"><b>loam_tpu</b> &mdash; drag: orbit &middot; wheel: zoom
&middot; shift-drag: pan<div id="legend"></div></div>
<canvas id="cv"></canvas>
<script>
const DATA = __DATA__;
const cv = document.getElementById('cv'), ctx = cv.getContext('2d');
let yaw = 0.7, pitch = 0.45, dist = null, cx=[0,0,0], panx=0, pany=0;
function fit(){
  let lo=[1e9,1e9,1e9], hi=[-1e9,-1e9,-1e9];
  for(const c of DATA.clouds) for(let i=0;i<c.pts.length;i+=3)
    for(let k=0;k<3;k++){const v=c.pts[i+k];
      if(v<lo[k])lo[k]=v; if(v>hi[k])hi[k]=v;}
  for(const t of DATA.trajs) for(let i=0;i<t.pts.length;i+=3)
    for(let k=0;k<3;k++){const v=t.pts[i+k];
      if(v<lo[k])lo[k]=v; if(v>hi[k])hi[k]=v;}
  for(let k=0;k<3;k++) cx[k]=(lo[k]+hi[k])/2;
  dist = 1.6*Math.max(hi[0]-lo[0],hi[1]-lo[1],hi[2]-lo[2],1);
}
function project(x,y,z,W,H){
  // internal frame: z fwd, x left, y up -> view axes
  let px=z-cx[2], py=x-cx[0], pz=y-cx[1];
  const cy_=Math.cos(yaw), sy=Math.sin(yaw);
  const cp=Math.cos(pitch), sp=Math.sin(pitch);
  let rx=cy_*px+sy*py, ry=-sy*px+cy_*py;
  let rz=cp*pz-sp*rx, rxx=sp*pz+cp*rx;
  const d=rxx+dist; if(d<=0.1) return null;
  const f=0.9*Math.min(W,H)/d*dist/2.2;
  return [W/2+f*ry/dist*2.2+panx, H/2-f*rz/dist*2.2+pany, d];
}
function draw(){
  const W=cv.width=innerWidth, H=cv.height=innerHeight;
  ctx.fillStyle='#14181d'; ctx.fillRect(0,0,W,H);
  for(const c of DATA.clouds){
    ctx.fillStyle=c.color; ctx.globalAlpha=0.55;
    for(let i=0;i<c.pts.length;i+=3){
      const p=project(c.pts[i],c.pts[i+1],c.pts[i+2],W,H);
      if(p) ctx.fillRect(p[0],p[1],1.3,1.3);
    }
  }
  ctx.globalAlpha=1;
  for(const t of DATA.trajs){
    ctx.strokeStyle=t.color; ctx.lineWidth=2; ctx.beginPath();
    let started=false;
    for(let i=0;i<t.pts.length;i+=3){
      const p=project(t.pts[i],t.pts[i+1],t.pts[i+2],W,H);
      if(!p){started=false;continue;}
      if(started) ctx.lineTo(p[0],p[1]); else ctx.moveTo(p[0],p[1]);
      started=true;
    }
    ctx.stroke();
  }
}
let drag=null;
cv.onmousedown=e=>drag=[e.clientX,e.clientY,e.shiftKey];
onmouseup=()=>drag=null;
onmousemove=e=>{ if(!drag) return;
  const dx=e.clientX-drag[0], dy=e.clientY-drag[1];
  if(drag[2]){panx+=dx;pany+=dy;}
  else{yaw+=dx*0.008; pitch=Math.max(-1.5,Math.min(1.5,pitch+dy*0.008));}
  drag=[e.clientX,e.clientY,drag[2]]; requestAnimationFrame(draw);};
onwheel=e=>{dist*=Math.exp(e.deltaY*0.001); requestAnimationFrame(draw);};
onresize=()=>requestAnimationFrame(draw);
const lg=document.getElementById('legend');
for(const t of DATA.trajs.concat(DATA.clouds))
  lg.innerHTML+='<div><span class="sw" style="background:'+t.color+
                '"></span>'+t.name+'</div>';
fit(); draw();
</script></body></html>
"""


def export_html_viewer(out_path, trajectories, clouds=None,
                       max_points=120000):
    """Write a standalone HTML orbit viewer (no network, no deps).

    trajectories: dict name -> (F, 6) poses or (F, 3) positions.
    clouds: dict name -> (xyz, mask) tuples or bare (N, 3) arrays.
    """
    cloud_colors = ["#8e9aa5", "#caa24b", "#6fb3a0", "#b07aa1"]
    data = {"trajs": [], "clouds": []}
    for name, traj in trajectories.items():
        p = _positions(traj).astype(np.float32)
        data["trajs"].append({
            "name": name,
            "color": _TRAJ_COLORS.get(name, "#e0e0e0"),
            "pts": [round(float(v), 3) for v in p.reshape(-1)],
        })
    for i, (name, cloud) in enumerate((clouds or {}).items()):
        xyz, mask = cloud if isinstance(cloud, tuple) else (cloud, None)
        pts = _masked(xyz, mask, cap=max_points)
        data["clouds"].append({
            "name": name,
            "color": cloud_colors[i % len(cloud_colors)],
            "pts": [round(float(v), 3) for v in pts.reshape(-1)],
        })
    html = _HTML_TEMPLATE.replace(
        "__DATA__", json.dumps(data, separators=(",", ":"))
    )
    with open(out_path, "w") as f:
        f.write(html)
    return out_path
