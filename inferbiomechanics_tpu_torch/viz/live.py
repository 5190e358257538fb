"""Live model-in-the-loop viewer: WebSocket streaming + true-3D client.

Capability parity: the reference's interactive NimbleGUI sessions —
``visualize.py:123-263`` (dev-split playback on port 8888: per-tick model
forward pass, loss-evaluator accumulation, 'r' report, space/e/a
transport, joint-center spheres, root velocity line, root position
history, red label / blue predicted force lines) and
``visualize_file.py:174-292`` (single-file playback on port 8080) —
NimbleGUI's ``Ticker``+``registerKeydownListener``+``renderSkeleton``
replaced by a stdlib WebSocket server (viz/ws.py) pushing JSON frames at
the same 0.04 s tick, and mesh rendering from the Geometry folder
(viz/mesh.py) transformed by the FK world transforms each frame.

Unlike the static export (viz/viewer.py), the model runs per tick — what
the GUI shows always reflects the CURRENT checkpoint and loss evaluator
state, and the client renders in real 3D (orbit camera), replacing the
round-1 fake-3D projection.
"""

from __future__ import annotations

import json
import socket
import threading
import time
from typing import Callable, Dict, Optional

from inferbiomechanics_tpu_torch.viz import ws

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title>
<style>
 body { margin:0; background:#0b0e12; color:#cfd8e3; font-family:monospace; }
 #hud { position:fixed; top:8px; left:8px; white-space:pre; font-size:12px; }
 canvas { display:block; cursor:grab; }
</style></head>
<body>
<div id="hud">connecting…</div>
<canvas id="c"></canvas>
<script>
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
const hud = document.getElementById('hud');
function resize(){ cv.width = innerWidth; cv.height = innerHeight; }
addEventListener('resize', resize); resize();

__CAMERA__
function line3(a, b, color, w){
  const pa = P(a), pb = P(b);
  ctx.strokeStyle = color; ctx.lineWidth = w;
  ctx.beginPath(); ctx.moveTo(pa[0], pa[1]); ctx.lineTo(pb[0], pb[1]); ctx.stroke();
}
function dot3(a, r, color){
  const p = P(a);
  ctx.fillStyle = color; ctx.beginPath();
  ctx.arc(p[0], p[1], Math.max(1.5, r * p[2]), 0, 6.283); ctx.fill();
}
function xform(R, p, v){
  return [R[0]*v[0] + R[1]*v[1] + R[2]*v[2] + p[0],
          R[3]*v[0] + R[4]*v[1] + R[5]*v[2] + p[1],
          R[6]*v[0] + R[7]*v[1] + R[8]*v[2] + p[2]];
}

let INIT = null, FRAME = null;
function draw(){
  ctx.fillStyle = '#0b0e12'; ctx.fillRect(0, 0, cv.width, cv.height);
  // ground grid
  for (let i = -5; i <= 5; i++){
    line3([i * 0.5, 0, -2.5], [i * 0.5, 0, 2.5], '#1d242e', 1);
    line3([-2.5, 0, i * 0.5], [2.5, 0, i * 0.5], '#1d242e', 1);
  }
  if (!FRAME){ requestAnimationFrame(draw); return; }
  const f = FRAME;
  if (INIT && f.bodies){
    for (const [name, T] of Object.entries(f.bodies)){
      const mesh = INIT.meshes[name];
      if (!mesh) continue;
      ctx.strokeStyle = f.missing ? '#573030' : '#36465c'; ctx.lineWidth = 1;
      for (const [a, b] of mesh.e)
        line3(xform(T.R, T.p, mesh.v[a]), xform(T.R, T.p, mesh.v[b]),
              f.missing ? '#573030' : '#36465c', 1);
    }
  }
  if (INIT && f.joints)
    for (const [a, b] of INIT.bones)
      line3(f.joints[a], f.joints[b], '#8fa3bb', 2);
  if (f.joints) for (const j of f.joints) dot3(j, 0.02, '#e8eef5');
  if (f.root_history) for (const h of f.root_history) dot3(h, 0.012, '#4fbf67');
  if (f.root_vel) line3([0, 0, 0], f.root_vel, '#bf4fae', 2);
  const FS = 0.2;  // force draw scale (parity: visualize_file.py:263)
  if (f.label_forces)
    for (const [cop, vec] of f.label_forces)
      line3(cop, [cop[0]+vec[0]*FS, cop[1]+vec[1]*FS, cop[2]+vec[2]*FS],
            '#e05252', 2.5);
  if (f.pred_forces)
    for (const [cop, vec] of f.pred_forces)
      line3(cop, [cop[0]+vec[0]*FS, cop[1]+vec[1]*FS, cop[2]+vec[2]*FS],
            '#5286e0', 2.5);
  requestAnimationFrame(draw);
}
requestAnimationFrame(draw);

function framePoints(f){
  const pts = [];
  if (f.joints) for (const j of f.joints) pts.push(j);
  if (f.bodies) for (const T of Object.values(f.bodies)) pts.push(T.p);
  return pts;
}
let framed = false;
const sock = new WebSocket(`ws://${location.host}/ws`);
sock.onmessage = ev => {
  const m = JSON.parse(ev.data);
  if (m.type === 'init'){ INIT = m; document.title = m.title; }
  else if (m.type === 'frame'){
    FRAME = m;
    if (!framed){ frameCamera(framePoints(m)); framed = true; }
    hud.textContent = `${m.title || ''}  frame ${m.frame}/${m.total}` +
      (m.subject !== undefined ? `  subject ${m.subject}` : '') +
      (m.missing ? '  [missing GRF]' : '') + (m.hud ? '\\n' + m.hud : '') +
      '\\nspace: play/pause  e/a: step  s: next subject  r: report' +
      '\\nf: frame camera  drag: orbit  wheel: zoom' +
      '\\n\\u25a0 label force (red)  \\u25a0 predicted force (blue)';
  }
};
addEventListener('keydown', ev => {
  if (ev.key === 'f'){ if (FRAME) frameCamera(framePoints(FRAME)); return; }
  if ([' ', 'e', 'a', 'r', 'n', 's'].includes(ev.key)){
    sock.send(JSON.stringify({type: 'key', key: ev.key}));
    ev.preventDefault();
  }
});
</script></body></html>
"""


class LiveSession:
    """Playback state machine with the reference's transport semantics
    (visualize.py:139-154: space toggles, 'e'/'a' step with wrap at
    num_frames-5, 'r' prints the loss report)."""

    def __init__(self, num_frames: int,
                 packet_for_frame: Callable[[int], dict],
                 on_report: Optional[Callable[[], None]] = None,
                 jump_points: Optional[list] = None):
        self.num_frames = num_frames
        self.packet_for_frame = packet_for_frame
        self.on_report = on_report
        # 's' cycles to the next jump point (subject starts in the
        # dev-split live mode; beyond-reference: the NimbleGUI session
        # had no subject navigation)
        self.jump_points = sorted(jump_points) if jump_points else []
        self.frame = 0
        self.playing = True
        self._lock = threading.Lock()

    def key(self, key: str) -> None:
        with self._lock:
            if key == ' ':
                self.playing = not self.playing
            elif key == 'e':
                self.frame += 1
                if self.frame >= max(self.num_frames - 5, 1):
                    self.frame = 0
            elif key == 'a':
                self.frame -= 1
                if self.frame < 0:
                    self.frame = max(self.num_frames - 5, 1) - 1
            elif key == 's' and self.jump_points:
                nxt = [p for p in self.jump_points if p > self.frame]
                self.frame = nxt[0] if nxt else self.jump_points[0]
            elif key == 'r' and self.on_report:
                self.on_report()

    def tick(self) -> dict:
        with self._lock:
            frame = self.frame
            if self.playing:
                self.frame += 1
                if self.frame >= max(self.num_frames - 5, 1):
                    self.frame = 0
        packet = self.packet_for_frame(frame)
        packet.setdefault('type', 'frame')
        packet['frame'] = frame
        packet['total'] = self.num_frames
        return packet


class LiveViewerServer:
    """Stdlib HTTP+WebSocket server: GET / serves the 3D client page,
    GET /ws upgrades and receives the frame stream + key events."""

    def __init__(self, session: LiveSession, init_payload: dict,
                 title: str = 'inferbiomechanics', port: int = 8888,
                 tick_interval: float = 0.04, host: str = '127.0.0.1'):
        """``host`` defaults to loopback: the viewer exposes keypress
        control of the session, so remote access is opt-in
        (``--host 0.0.0.0``), not the default."""
        self.session = session
        self.init_payload = dict(init_payload, type='init', title=title)
        self.title = title
        self.host = host
        self.port = port
        self.tick_interval = tick_interval
        self._clients: Dict[socket.socket, bool] = {}
        self._lock = threading.Lock()
        self._running = False
        self._srv: Optional[socket.socket] = None
        self._threads = []

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> int:
        """Bind + start accept/tick threads; returns the bound port."""
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((self.host, self.port))
        self.port = self._srv.getsockname()[1]
        self._srv.listen(8)
        self._running = True
        for fn in (self._accept_loop, self._tick_loop):
            t = threading.Thread(target=fn, daemon=True)
            t.start()
            self._threads.append(t)
        return self.port

    def stop(self) -> None:
        self._running = False
        try:
            if self._srv:
                self._srv.close()
        except OSError:
            pass
        with self._lock:
            for c in list(self._clients):
                try:
                    c.close()
                except OSError:
                    pass
            self._clients.clear()

    def block(self) -> None:
        """Parity with ``gui.blockWhileServing`` (visualize.py:263)."""
        try:
            while self._running:
                time.sleep(0.5)
        except KeyboardInterrupt:
            self.stop()

    # -- internals -----------------------------------------------------------

    def _accept_loop(self) -> None:
        while self._running:
            try:
                conn, _addr = self._srv.accept()
            except OSError:
                return
            threading.Thread(target=self._handle, args=(conn,),
                             daemon=True).start()

    def _handle(self, conn: socket.socket) -> None:
        try:
            conn.settimeout(10.0)
            req = b''
            while b'\r\n\r\n' not in req:
                chunk = conn.recv(4096)
                if not chunk:
                    return
                req += chunk
            head = req.split(b'\r\n\r\n', 1)[0].decode('latin-1')
            lines = head.split('\r\n')
            path = lines[0].split(' ')[1] if len(lines[0].split(' ')) > 1 else '/'
            headers = {}
            for line in lines[1:]:
                if ':' in line:
                    k, v = line.split(':', 1)
                    headers[k.strip().lower()] = v.strip()
            if path == '/ws' and 'sec-websocket-key' in headers:
                conn.sendall(ws.handshake_response(headers['sec-websocket-key']))
                conn.sendall(ws.encode_frame(
                    json.dumps(self.init_payload).encode()))
                conn.settimeout(0.2)
                with self._lock:
                    self._clients[conn] = True
                self._read_ws(conn)
            else:
                from inferbiomechanics_tpu_torch.viz.viewer import CAMERA_JS
                page = (_PAGE.replace('__CAMERA__', CAMERA_JS)
                        .replace('__TITLE__', self.title).encode())
                conn.sendall(b'HTTP/1.1 200 OK\r\nContent-Type: text/html\r\n'
                             + f'Content-Length: {len(page)}\r\n\r\n'.encode()
                             + page)
                conn.close()
        except OSError:
            pass

    def _read_ws(self, conn: socket.socket) -> None:
        buf = b''
        while self._running:
            try:
                chunk = conn.recv(4096)
                if not chunk:
                    break
                buf += chunk
            except socket.timeout:
                continue
            except OSError:
                break
            msgs, buf = ws.decode_frames(buf)   # reassembles fragments
            for opcode, payload in msgs:
                if opcode == ws.OP_CLOSE:
                    with self._lock:
                        self._clients.pop(conn, None)
                    try:
                        conn.close()
                    except OSError:
                        pass
                    return
                if opcode == ws.OP_PING:
                    try:
                        conn.sendall(ws.encode_frame(payload, ws.OP_PONG))
                    except OSError:
                        return
                elif opcode == ws.OP_TEXT:
                    try:
                        msg = json.loads(payload)
                    except ValueError:
                        continue
                    if msg.get('type') == 'key':
                        self.session.key(msg.get('key', ''))
        with self._lock:
            self._clients.pop(conn, None)

    def _tick_loop(self) -> None:
        while self._running:
            t0 = time.time()
            with self._lock:
                have_clients = bool(self._clients)
            if have_clients:
                packet = self.session.tick()
                packet['title'] = self.title
                data = ws.encode_frame(json.dumps(packet).encode())
                with self._lock:
                    dead = []
                    for c in self._clients:
                        try:
                            c.sendall(data)
                        except OSError:
                            dead.append(c)
                    for c in dead:
                        self._clients.pop(c, None)
                        try:
                            c.close()
                        except OSError:
                            pass
            time.sleep(max(0.0, self.tick_interval - (time.time() - t0)))
