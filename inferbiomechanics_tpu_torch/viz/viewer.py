"""Web viewer: self-contained HTML animation export + optional HTTP serve.

Capability parity: the reference's interactive NimbleGUI loops
(visualize.py:123-263 on port 8888, visualize_file.py:174-292 on port
8080) — skeleton joint centers as spheres, root velocity line, label
(red) vs predicted (blue) force vectors drawn at their CoPs, keyboard
transport (space = play/pause). NimbleGUI is a C++ web-server dependency;
the TPU-native replacement renders the same primitives in a dependency-
free HTML5 canvas with an embedded JSON payload, so it works over SSH /
headless (open the file or serve it on the parity port).
"""

from __future__ import annotations

import http.server
import json
import os
import socketserver
from typing import Dict, List

# Shared orbit-camera JS (state + handlers + projection), spliced into
# both the static template below and the live template (viz/live.py) so
# camera fixes land in one place. Expects `cv` (canvas) in scope; expands
# to `P(v) -> [px, py]` plus the interaction handlers.
CAMERA_JS = """
let yaw = 0.7, pitch = 0.25, dist = 4.2, ccx = 0, ccy = 1.0, drag = null;
cv.addEventListener('mousedown', e => drag = [e.clientX, e.clientY]);
addEventListener('mouseup', () => drag = null);
addEventListener('mousemove', e => {
  if (!drag) return;
  yaw += (e.clientX - drag[0]) * 0.008;
  pitch = Math.max(-1.4, Math.min(1.4, pitch + (e.clientY - drag[1]) * 0.008));
  drag = [e.clientX, e.clientY];
});
cv.addEventListener('wheel', e => { dist = Math.max(0.8, dist * (1 + e.deltaY * 0.001)); });
function frameCamera(pts){
  // mesh-aware framing: center + distance from the bounding box of the
  // posed geometry (falls back to joints when no meshes are loaded)
  if (!pts || !pts.length) return;
  let lo = [1e9, 1e9, 1e9], hi = [-1e9, -1e9, -1e9];
  for (const p of pts) for (let k = 0; k < 3; k++){
    lo[k] = Math.min(lo[k], p[k]); hi[k] = Math.max(hi[k], p[k]);
  }
  ccx = (lo[0] + hi[0]) / 2; ccy = (lo[1] + hi[1]) / 2;
  const span = Math.max(hi[0]-lo[0], hi[1]-lo[1], hi[2]-lo[2], 0.5);
  dist = Math.max(1.2, span * 2.2);
}
function P(v){
  const x = v[0] - ccx, y = v[1] - ccy, z = v[2] || 0;
  const cyw = Math.cos(yaw), syw = Math.sin(yaw);
  const cp = Math.cos(pitch), sp = Math.sin(pitch);
  let X = cyw * x + syw * z, Z0 = -syw * x + cyw * z;
  let Y = cp * y - sp * Z0, Z = sp * y + cp * Z0 + dist;
  if (Z < 0.1) Z = 0.1;
  const fpx = 0.9 * Math.min(cv.width, cv.height) / Z;
  return [cv.width / 2 + X * fpx, cv.height / 2 - Y * fpx, fpx];
}
"""

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title>
<style>
 body { margin:0; background:#111; color:#ddd; font-family:monospace; }
 #hud { position:fixed; top:8px; left:8px; }
 canvas { display:block; }
</style></head>
<body>
<div id="hud">__TITLE__ — space: play/pause, ←/→: step, +/-: speed, drag: orbit, wheel: zoom<br>
 <span style="color:#f55">■</span> label force&nbsp;
 <span style="color:#59f">■</span> predicted force&nbsp;
 <span style="color:#ddd">●</span> joint centers</div>
<canvas id="c"></canvas>
<script>
const DATA = __DATA__;
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
function resize(){ cv.width = innerWidth; cv.height = innerHeight; }
addEventListener('resize', resize); resize();
let frame = 0, playing = true, speed = 1, acc = 0, last = performance.now();
__CAMERA__
function line(a, b, color, w){ ctx.strokeStyle = color; ctx.lineWidth = w;
  ctx.beginPath(); ctx.moveTo(...P(a)); ctx.lineTo(...P(b)); ctx.stroke(); }
function dot(a, r, color){ ctx.fillStyle = color; ctx.beginPath();
  const p = P(a); ctx.arc(p[0], p[1], r, 0, 6.283); ctx.fill(); }
function xform(R, p, v){
  return [R[0]*v[0] + R[1]*v[1] + R[2]*v[2] + p[0],
          R[3]*v[0] + R[4]*v[1] + R[5]*v[2] + p[1],
          R[6]*v[0] + R[7]*v[1] + R[8]*v[2] + p[2]];
}
// mesh-aware initial framing from frame 0's posed bodies + joints
(function(){
  const f0 = DATA.frames[0];
  if (!f0) return;
  const pts = (f0.joints || []).slice();
  if (f0.bodies) for (const T of Object.values(f0.bodies)) pts.push(T.p);
  frameCamera(pts);
})();
addEventListener('keydown', ev => {
  if (ev.key === 'f'){
    const f = DATA.frames[frame];
    const pts = (f.joints || []).slice();
    if (f.bodies) for (const T of Object.values(f.bodies)) pts.push(T.p);
    frameCamera(pts);
  }
});
function draw(){
  ctx.fillStyle = '#111'; ctx.fillRect(0, 0, cv.width, cv.height);
  const f = DATA.frames[frame];
  for (let i = -5; i <= 5; i++){
    line([i * 0.5, 0, -2.5], [i * 0.5, 0, 2.5], '#333', 1);
    line([-2.5, 0, i * 0.5], [2.5, 0, i * 0.5], '#333', 1);
  }
  if (DATA.meshes && f.bodies){
    for (const [name, T] of Object.entries(f.bodies)){
      const mesh = DATA.meshes[name];
      if (!mesh) continue;
      for (const [a, b] of mesh.e)
        line(xform(T.R, T.p, mesh.v[a]), xform(T.R, T.p, mesh.v[b]),
             f.missing_grf ? '#533' : '#365', 1);
    }
  }
  for (const j of f.joints) dot(j, 4, '#ddd');
  if (f.bones) for (const b of f.bones) line(f.joints[b[0]], f.joints[b[1]], '#888', 2);
  if (f.root_vel) line(f.joints[0],
    [f.joints[0][0]+f.root_vel[0]*0.3, f.joints[0][1]+f.root_vel[1]*0.3,
     f.joints[0][2]+f.root_vel[2]*0.3], '#5d5', 2);
  if (f.root_history) for (const h of f.root_history) dot(h, 2, '#777');
  const FS = 0.2;  // force draw scale (parity: visualize_file.py:263)
  for (const [cop, v] of (f.label_forces || []))
    line(cop, [cop[0]+v[0]*FS, cop[1]+v[1]*FS, cop[2]+v[2]*FS], '#f55', 3);
  for (const [cop, v] of (f.pred_forces || []))
    line(cop, [cop[0]+v[0]*FS, cop[1]+v[1]*FS, cop[2]+v[2]*FS], '#59f', 3);
  if (f.missing_grf) { ctx.fillStyle = '#f55';
    ctx.fillText('MISSING GRF', 12, cv.height - 16); }
  ctx.fillStyle = '#888';
  ctx.fillText(`frame ${frame}/${DATA.frames.length-1}  x${speed}` +
               (playing ? '' : '  [paused]'), 12, cv.height - 36);
}
function tick(now){
  const dt = (now - last) / 1000; last = now;
  if (playing) { acc += dt * speed / DATA.dt;
    while (acc >= 1) { frame = (frame + 1) % DATA.frames.length; acc -= 1; } }
  draw(); requestAnimationFrame(tick);
}
addEventListener('keydown', e => {
  if (e.code === 'Space') { playing = !playing; e.preventDefault(); }
  else if (e.key === 'ArrowRight') frame = (frame + 1) % DATA.frames.length;
  else if (e.key === 'ArrowLeft') frame = (frame - 1 + DATA.frames.length) % DATA.frames.length;
  else if (e.key === '+') speed *= 1.5; else if (e.key === '-') speed /= 1.5;
});
requestAnimationFrame(tick);
</script></body></html>
"""


def export_html(path: str, payload: Dict, title: str = 'InferBiomechanics') -> str:
    """Write a self-contained animation viewer. ``payload``:
    {dt: float, frames: [{joints: [[x,y,z]..], bones: [[i,j]..],
    label_forces: [[[cop],[vec]]..], pred_forces: ..., missing_grf: bool}]}"""
    html = (_TEMPLATE
            .replace('__CAMERA__', CAMERA_JS)
            .replace('__TITLE__', title)
            .replace('__DATA__', json.dumps(payload)))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, 'w') as f:
        f.write(html)
    return os.path.abspath(path)


def serve_file(path: str, port: int, host: str = '127.0.0.1') -> None:
    """Serve the exported HTML on ``port`` (parity: 8888 / 8080).
    Loopback-only by default; pass ``host='0.0.0.0'`` for remote access."""
    directory = os.path.dirname(os.path.abspath(path))
    fname = os.path.basename(path)

    class Handler(http.server.SimpleHTTPRequestHandler):
        def __init__(self, *a, **kw):
            super().__init__(*a, directory=directory, **kw)

        def do_GET(self):  # default route -> the viewer
            if self.path in ('/', ''):
                self.path = '/' + fname
            return super().do_GET()

    with socketserver.TCPServer((host, port), Handler) as httpd:
        print(f'Serving viewer at http://{host}:{port}/ (ctrl-c to stop)')
        httpd.serve_forever()


# Default bone connectivity for the 12-joint-center standard skeleton
# (joint order: root, hip_r, knee_r, ankle_r, subtalar_r, mtp_r,
#               hip_l, knee_l, ankle_l, subtalar_l, mtp_l, back).
STANDARD_BONES: List[List[int]] = [
    [0, 1], [1, 2], [2, 3], [3, 4], [4, 5],
    [0, 6], [6, 7], [7, 8], [8, 9], [9, 10],
    [0, 11],
]
