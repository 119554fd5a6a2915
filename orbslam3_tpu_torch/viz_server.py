"""Live interactive viewer: browser-based map/trajectory display.

The port of `orbslam3_tpu/viz_server.py`.  Parity target: the reference
Viewer/FrameDrawer/MapDrawer (src/Viewer.cc:160-191: a Pangolin window with
camera-follow and step-by-step mode).  A Pangolin/GL window assumes a local
display; the engine runs headless on a server, so the equivalent is a
zero-dependency HTTP viewer: a background thread serves a self-contained
HTML/canvas page (no external assets) that polls the map state as JSON and
renders top-down + side projections with pan/zoom, camera-follow, and
pause/step/resume controls that gate the tracking loop (like the
reference's Viewer 'Step' button, src/Viewer.cc:326-334).

Usage:
    viewer = ViewerServer(port=8765)
    viewer.attach(system)            # system.viewer = viewer
    ... run the tracking loop ...    # publish+gate happen per frame
    viewer.stop()

The System calls `publish(system)` (a host-side snapshot: points
subsampled to `max_points`, keyframe poses, trajectory tail, state; the
map's tensors are brought to numpy here, at viewer cadence) and
`wait_if_paused()` once per tracked frame.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .viz import _np

_PAGE = """<!DOCTYPE html>
<html><head><title>orbslam3_tpu viewer</title><style>
body { margin:0; background:#111; color:#ddd; font:13px monospace; }
#bar { padding:6px; background:#1b1b1b; }
#bar button { font:12px monospace; margin-right:4px; }
#stats { margin-left: 12px; color:#8c8; }
canvas { display:block; }
</style></head><body>
<div id="bar">
 <button onclick="ctl('pause')">pause</button>
 <button onclick="ctl('step')">step</button>
 <button onclick="ctl('resume')">resume</button>
 <button onclick="follow=!follow">follow: <span id="fol">on</span></button>
 <button onclick="side=!side">view: <span id="vw">top</span></button>
 <span id="stats"></span>
</div>
<canvas id="c"></canvas>
<img id="fr" style="position:fixed; right:8px; top:42px; max-width:38%;
 border:1px solid #333; image-rendering:pixelated;">
<script>
let cv = document.getElementById('c'), cx = cv.getContext('2d');
let scale = 60, ox = 0, oy = 0, follow = true, side = false, st = null;
function resize() { cv.width = innerWidth; cv.height = innerHeight - 34; }
addEventListener('resize', resize); resize();
cv.addEventListener('wheel', e => { scale *= e.deltaY < 0 ? 1.15 : 0.87; });
let drag = null;
cv.addEventListener('mousedown', e => drag = [e.clientX, e.clientY]);
addEventListener('mouseup', () => drag = null);
addEventListener('mousemove', e => {
  if (drag) { ox += (e.clientX - drag[0]) / scale;
              oy += (e.clientY - drag[1]) / scale;
              drag = [e.clientX, e.clientY]; follow = false; }
});
function ctl(c) { fetch('/control?cmd=' + c); }
function W2S(p) {  // world -> screen (top-down: x,y; side: x,z)
  let u = p[0], v = side ? p[2] : p[1];
  return [cv.width / 2 + (u + ox) * scale,
          cv.height / 2 + (v + oy) * scale];
}
async function tick() {
  try {
    let r = await fetch('/state.json'); st = await r.json();
  } catch (e) {}
  if (st) draw();
  // tracked-frame overlay stream (FrameDrawer analogue)
  document.getElementById('fr').src = '/frame.png?t=' + Date.now();
  setTimeout(tick, 120);
}
function draw() {
  document.getElementById('fol').textContent = follow ? 'on' : 'off';
  document.getElementById('vw').textContent = side ? 'side' : 'top';
  if (follow && st.cam) {
    ox = -st.cam[0]; oy = -(side ? st.cam[2] : st.cam[1]);
  }
  cx.fillStyle = '#111'; cx.fillRect(0, 0, cv.width, cv.height);
  cx.fillStyle = '#5af';
  for (const p of st.points) {
    const s = W2S(p); cx.fillRect(s[0], s[1], 1.6, 1.6);
  }
  cx.strokeStyle = '#fa0'; cx.beginPath();
  st.traj.forEach((p, i) => {
    const s = W2S(p); i ? cx.lineTo(s[0], s[1]) : cx.moveTo(s[0], s[1]);
  });
  cx.stroke();
  cx.fillStyle = '#0f6';
  for (const k of st.kfs) {
    const s = W2S(k); cx.fillRect(s[0] - 2, s[1] - 2, 4, 4);
  }
  if (st.cam) {
    const s = W2S(st.cam);
    cx.strokeStyle = '#f33'; cx.lineWidth = 2;
    cx.strokeRect(s[0] - 5, s[1] - 5, 10, 10); cx.lineWidth = 1;
  }
  document.getElementById('stats').textContent =
    `frame ${st.frame}  state ${st.state}  kfs ${st.n_kf}  ` +
    `pts ${st.n_pts}  loops ${st.loops}  resets ${st.resets}` +
    (st.paused ? '  [PAUSED]' : '');
}
tick();
</script></body></html>"""


class ViewerServer:
    """Threaded HTTP viewer with tracking-loop gating (pause/step)."""

    def __init__(self, port: int = 8765, max_points: int = 4096,
                 traj_tail: int = 2000, frame_every: int = 3):
        self.max_points = max_points
        self.traj_tail = traj_tail
        self.frame_every = frame_every
        self._frame_png = None
        self._frame_n = 0
        self._lock = threading.Lock()
        self._state_json = b'{"points":[],"traj":[],"kfs":[],"cam":null,' \
                           b'"frame":0,"state":0,"n_kf":0,"n_pts":0,' \
                           b'"loops":0,"resets":0,"paused":false}'
        self.paused = False
        self._step = threading.Event()
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):        # silence request logging
                pass

            def do_GET(self):
                if self.path.startswith("/state.json"):
                    body = viewer._state_json
                    ctype = "application/json"
                elif self.path.startswith("/frame.png"):
                    body = viewer._frame_png or b""
                    ctype = "image/png"
                elif self.path.startswith("/control"):
                    cmd = self.path.split("cmd=")[-1]
                    viewer.control(cmd)
                    body = b"ok"
                    ctype = "text/plain"
                else:
                    body = _PAGE.encode()
                    ctype = "text/html"
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    # ------------------------------------------------------------- controls
    def control(self, cmd: str) -> None:
        if cmd == "pause":
            self.paused = True
        elif cmd == "resume":
            self.paused = False
            self._step.set()
        elif cmd == "step":
            self.paused = True
            self._step.set()

    def wait_if_paused(self, poll_s: float = 0.05) -> None:
        """Gate the tracking loop like the reference Viewer's step mode
        (src/Viewer.cc:326-334): while paused, block until 'step'
        (process exactly one frame) or 'resume'."""
        while self.paused and not self._step.is_set():
            time.sleep(poll_s)
        self._step.clear()

    # -------------------------------------------------------------- publish
    def attach(self, system) -> None:
        system.viewer = self

    def publish(self, system) -> None:
        """Snapshot the system state (host-side numpy; the map's
        tensors are read back at viewer cadence)."""
        m = system.map
        nk = system.n_kf_host
        pt_valid = _np(m.pt_valid)
        idx = np.nonzero(pt_valid)[0]
        if len(idx) > self.max_points:
            idx = idx[:: max(1, len(idx) // self.max_points)]
        pts = _np(m.pt_xyz)[idx].astype(np.float64).round(3)
        kR = _np(m.kf_R[:max(nk, 1)])
        kt = _np(m.kf_t[:max(nk, 1)])
        kf_centers = -np.einsum("kji,kj->ki", kR.astype(np.float64),
                        kt.astype(np.float64)).round(3)
        traj = [np.round(np.asarray(p[2], np.float64), 3).tolist()
                for p in system.trajectory[-self.traj_tail:]]
        cam = None
        if system.trajectory:
            cam = np.round(np.asarray(system.trajectory[-1][2],
                                      np.float64), 3).tolist()
        loops = getattr(getattr(system, "loop_closer", None),
                        "n_loops_closed", 0) or 0
        state = {
            "points": pts.tolist(),
            "traj": traj,
            "kfs": kf_centers[:nk].tolist(),
            "cam": cam,
            "frame": int(system.frame_id),
            "state": int(system.state),
            "n_kf": int(nk),
            "n_pts": int(pt_valid.sum()),
            "loops": int(loops),
            "resets": int(system.n_resets),
            "paused": self.paused,
        }
        with self._lock:
            self._state_json = json.dumps(state).encode()

    def publish_frame(self, img, ff=None, kp_pt=None) -> None:
        """Annotated tracked-image stream (reference FrameDrawer::
        DrawFrame, src/FrameDrawer.cc:40,343: current frame with
        keypoint overlay — green = bound to a map point, blue =
        unbound).  Downsampled 2x, PNG-encoded at `frame_every`
        cadence; the browser shows it beside the map.  `img` may be a
        device tensor (one small pull at viewer cadence only)."""
        if img is None:
            return
        self._frame_n += 1
        if (self._frame_n - 1) % max(self.frame_every, 1):
            return
        import io

        from PIL import Image
        g = _np(img)
        if g.ndim == 3:
            g = g[..., 0]
        g = np.clip(g[::2, ::2], 0, 255).astype(np.uint8)
        rgb = np.stack([g, g, g], -1)
        if ff is not None:
            xy = (_np(ff.xy) * 0.5).astype(np.int32)
            valid = _np(ff.valid)
            bound = _np(kp_pt) >= 0 if kp_pt is not None else \
                np.zeros(len(valid), bool)
            H, W = g.shape
            for color, sel in (((80, 140, 255), valid & ~bound),
                               ((40, 230, 90), valid & bound)):
                pts = xy[sel]
                pts = pts[(pts[:, 0] >= 1) & (pts[:, 0] < W - 1) &
                          (pts[:, 1] >= 1) & (pts[:, 1] < H - 1)]
                for du in (-1, 0, 1):
                    for dv in (-1, 0, 1):
                        if du == 0 and dv == 0:
                            continue   # ring, keep the center pixel
                        rgb[pts[:, 1] + dv, pts[:, 0] + du] = color
        buf = io.BytesIO()
        Image.fromarray(rgb).save(buf, "PNG")
        with self._lock:
            self._frame_png = buf.getvalue()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
