"""Live map viewer: a dependency-free HTTP/JSON equivalent of the
reference's Pangolin GUI thread (src/frontend/DSOViewer.cc:343+).

The reference renders, on a dedicated GL thread: the sparse map point
cloud, keyframe camera frusta, the red pre-loop trajectory (Tcw) and the
yellow loop-corrected one (TcwOpti), plus the live video frame
(README.md:101-104 color convention; publish hooks DSOViewer.h:115-152).
A GL window is useless on a headless TPU pod, so the TPU-native
equivalent is a tiny threaded HTTP server (Python stdlib only) serving

  /        an HTML canvas renderer (orbit controls, auto-polls /state)
  /state   JSON snapshot: trajectories, subsampled point cloud, frusta,
           current camera pose, frame id
  /frame   the latest published video frame as PNG (io/png.py)

Publish hooks mirror the reference viewer API: `publish_cam_pose` per
frame (IOWrap::Output3DWrapper::publishCamPose), `publish_keyframes` per
keyframe (publishKeyframes), `publish_frame` for the video view
(pushLiveFrame). All hooks copy small host arrays under a lock — they
never touch the device, so the SLAM threads lose nothing measurable.

In this package `publish_frame` also takes a frame that lies on the CUDA
card: the hook keeps the tensor and an event, and the server's thread
copies and encodes it (the package's own PNG writer) when `/frame` is
asked for, so neither the copy nor the encoding runs on a SLAM thread.

Usage:
    viewer = LiveViewer(port=8765).start()
    fs.viewer = viewer            # FullSystem publishes automatically
    ...
    viewer.stop()
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from ldso_tpu_torch.io.png import encode_png

_MAX_VIEW_POINTS = 40000


class LiveViewer:
    """Threaded live-state server (the PangolinDSOViewer equivalent)."""

    def __init__(self, port: int = 8765, host: str = "127.0.0.1"):
        self._lock = threading.Lock()
        self._state = {
            "frame_id": -1,
            "current_pose": np.eye(4).tolist(),
            "traj_odo": [],       # red: camera centers from T_cw
            "traj_opt": [],       # yellow: centers from S_cw (post-loop)
            "frusta": [],         # last-N keyframe poses (camToWorld 4x4)
            "points": [],         # subsampled world points
            "n_kfs": 0,
            "n_loops": 0,
        }
        self._frame_png: Optional[bytes] = None
        self._frame = None        # (image, event) not yet encoded
        self._port = port
        self._host = host
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- control
    def start(self) -> "LiveViewer":
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):            # silence request spam
                pass

            def _send(self, code, ctype, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path.startswith("/state"):
                    with viewer._lock:
                        body = json.dumps(viewer._state).encode()
                    self._send(200, "application/json", body)
                elif self.path.startswith("/frame"):
                    png = viewer._encoded_frame()
                    if png is None:
                        self._send(404, "text/plain", b"no frame yet")
                    else:
                        self._send(200, "image/png", png)
                else:
                    self._send(200, "text/html", _PAGE.encode())

        self._httpd = ThreadingHTTPServer((self._host, self._port), Handler)
        self._port = self._httpd.server_address[1]   # resolves port=0
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="ldso-viewer")
        self._thread.start()
        return self

    @property
    def port(self) -> int:
        return self._port

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    # ------------------------------------------------------------- publish
    def publish_cam_pose(self, shell):
        """Per-frame hook (publishCamPose): current camera + red breadcrumb."""
        T_wc = np.linalg.inv(shell.T_cw)
        with self._lock:
            self._state["frame_id"] = int(shell.id)
            self._state["current_pose"] = T_wc.tolist()
            self._state["traj_odo"].append(
                [round(float(x), 5) for x in T_wc[:3, 3]])

    def publish_keyframes(self, global_map, window_shells=()):
        """Per-keyframe hook (publishKeyframes): refresh the optimized
        trajectory, frusta, and the subsampled world point cloud."""
        kfs = global_map.get_all_kfs()
        traj_opt = [np.linalg.inv(kf.get_S_cw())[:3, 3] for kf in kfs]
        frusta = [np.linalg.inv(kf.get_S_cw()) for kf in kfs[-10:]]
        pts = global_map.point_cloud()
        if len(pts) > _MAX_VIEW_POINTS:
            pts = pts[:: len(pts) // _MAX_VIEW_POINTS + 1]
        n_loops = sum(1 for kf in kfs
                      for (_, _, is_loop) in kf.pose_rel.values() if is_loop)
        with self._lock:
            self._state["traj_opt"] = [
                [round(float(x), 5) for x in c] for c in traj_opt]
            self._state["frusta"] = [f.tolist() for f in frusta]
            self._state["points"] = np.round(
                np.asarray(pts, np.float32), 4).tolist() if len(pts) else []
            self._state["n_kfs"] = len(kfs)
            self._state["n_loops"] = int(n_loops)

    def publish_frame(self, image):
        """Video-view hook (pushLiveFrame). image: (H, W) float or uint8, a
        numpy array (copied) or a tensor (kept, with an event on its
        stream when it lies on the card); encoded on request."""
        event = None
        if isinstance(image, torch.Tensor):
            if image.is_cuda:
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(image.device))
        else:
            image = np.array(image)
        with self._lock:
            self._frame = (image, event)

    def _encoded_frame(self) -> Optional[bytes]:
        """The latest frame as PNG bytes, encoded at the first request after
        its publish (server thread)."""
        with self._lock:
            frame, png = self._frame, self._frame_png
        if frame is None:
            return png
        image, event = frame
        if isinstance(image, torch.Tensor):
            if event is not None:
                event.synchronize()
            image = image.cpu().numpy()
        arr = np.asarray(image)
        if arr.dtype != np.uint8:
            arr = np.clip(arr, 0, 255).astype(np.uint8)
        png = encode_png(arr)
        with self._lock:
            if self._frame is frame:
                self._frame, self._frame_png = None, png
        return png


_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>ldso_tpu live viewer</title>
<style>
 body { margin:0; background:#101014; color:#ddd; font:12px monospace; }
 #hud { position:fixed; top:8px; left:8px; }
 canvas { display:block; }
 img#video { position:fixed; right:8px; top:8px; width:240px;
             border:1px solid #333; }
</style></head><body>
<div id="hud"></div><canvas id="c"></canvas><img id="video"/>
<script>
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let st = null, yaw = -0.6, pitch = -0.4, dist = 8, cx = 0, cy = 0, cz = 0;
let drag = false, lx = 0, ly = 0;
cv.onmousedown = e => { drag = true; lx = e.clientX; ly = e.clientY; };
window.onmouseup = () => drag = false;
window.onmousemove = e => { if (!drag) return;
  yaw += (e.clientX - lx) * 0.01; pitch += (e.clientY - ly) * 0.01;
  lx = e.clientX; ly = e.clientY; };
cv.onwheel = e => { dist *= Math.exp(e.deltaY * 0.001); e.preventDefault(); };
function proj(p) {
  const sy = Math.sin(yaw), cyw = Math.cos(yaw),
        sp = Math.sin(pitch), cp = Math.cos(pitch);
  let x = p[0] - cx, y = p[1] - cy, z = p[2] - cz;
  let x1 = cyw * x + sy * z, z1 = -sy * x + cyw * z;
  let y1 = cp * y - sp * z1, z2 = sp * y + cp * z1 + dist;
  if (z2 < 0.05) return null;
  const f = 0.9 * Math.min(cv.width, cv.height) / z2;
  return [cv.width / 2 + f * x1, cv.height / 2 + f * y1];
}
function polyline(pts, color) {
  ctx.strokeStyle = color; ctx.beginPath(); let started = false;
  for (const p of pts) { const q = proj(p); if (!q) { started = false; continue; }
    if (!started) { ctx.moveTo(q[0], q[1]); started = true; }
    else ctx.lineTo(q[0], q[1]); }
  ctx.stroke();
}
function draw() {
  cv.width = window.innerWidth; cv.height = window.innerHeight;
  ctx.fillStyle = '#101014'; ctx.fillRect(0, 0, cv.width, cv.height);
  if (!st) return;
  if (st.traj_opt.length) { const c = st.traj_opt[st.traj_opt.length - 1];
    cx = c[0]; cy = c[1]; cz = c[2]; }
  ctx.fillStyle = '#8899aa';
  for (const p of st.points) { const q = proj(p);
    if (q) ctx.fillRect(q[0], q[1], 1, 1); }
  polyline(st.traj_odo, '#cc2222');          // red: odometry
  polyline(st.traj_opt, '#e6a817');          // yellow: loop-corrected
  ctx.strokeStyle = '#44cc88';
  for (const F of st.frusta) {
    const o = [F[0][3], F[1][3], F[2][3]], s = 0.15, corners = [];
    for (const [u, v] of [[-1,-1],[1,-1],[1,1],[-1,1]]) {
      const d = [u*s, v*s*0.7, s*1.4];
      corners.push([F[0][0]*d[0]+F[0][1]*d[1]+F[0][2]*d[2]+o[0],
                    F[1][0]*d[0]+F[1][1]*d[1]+F[1][2]*d[2]+o[1],
                    F[2][0]*d[0]+F[2][1]*d[1]+F[2][2]*d[2]+o[2]]);
    }
    for (let i = 0; i < 4; i++) {
      polyline([o, corners[i]], '#44cc88');
      polyline([corners[i], corners[(i+1)%4]], '#44cc88');
    }
  }
  document.getElementById('hud').textContent =
    `frame ${st.frame_id}  KFs ${st.n_kfs}  loops ${st.n_loops}  ` +
    `points ${st.points.length}`;
}
async function tick() {
  try {
    st = await (await fetch('/state')).json();
    document.getElementById('video').src = '/frame?' + st.frame_id;
  } catch (e) {}
  draw();
  setTimeout(tick, 400);
}
tick();
</script></body></html>
"""
