"""Live scene viewer: a headless HTTP server over the current Gaussian
scene.

Serves an interactive page (WASD/arrow fly controls) that pulls PNG renders
of the CURRENT scene; a training loop shares the scene through
`set_scene` and can honour `pause` / `lock`. The renders go through the
general rasterizer on `device` (backend "pallas": the tiled kernels on the
card). Standard library HTTP server; the frames are PNG, encoded by
data/png.py (the JAX package serves JPEG through OpenCV; the page's <img>
takes either).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from .._device import DEFAULT_DEVICE, as_f32, resolve_device

_PAGE = """<!DOCTYPE html><html><head><title>gsplatloc_tpu_torch viewer</title>
<style>body{background:#111;color:#eee;font-family:monospace;text-align:center}
img{border:1px solid #444;margin-top:8px}</style></head><body>
<h3>gsplatloc_tpu_torch live viewer</h3>
<div>WASD move &middot; arrows rotate &middot; Q/E up/down &middot; P pause training</div>
<img id="v" width="640"/><div id="s"></div>
<script>
let t=[0,0,-1], r=[0,0];
const S=0.08, A=0.05;
document.addEventListener('keydown', e=>{
  const k=e.key.toLowerCase();
  const c=Math.cos(r[1]), s=Math.sin(r[1]);
  if(k==='w'){t[0]+=S*s;t[2]+=S*c}
  if(k==='s'){t[0]-=S*s;t[2]-=S*c}
  if(k==='a'){t[0]-=S*c;t[2]+=S*s}
  if(k==='d'){t[0]+=S*c;t[2]-=S*s}
  if(k==='q')t[1]-=S; if(k==='e')t[1]+=S;
  if(e.key==='ArrowLeft')r[1]-=A; if(e.key==='ArrowRight')r[1]+=A;
  if(e.key==='ArrowUp')r[0]-=A; if(e.key==='ArrowDown')r[0]+=A;
  if(k==='p')fetch('/toggle_pause');
});
async function loop(){
  const q = `/render?tx=${t[0]}&ty=${t[1]}&tz=${t[2]}&rx=${r[0]}&ry=${r[1]}`;
  const im = document.getElementById('v');
  im.src = q + `&_=${Date.now()}`;
  const st = await (await fetch('/stats')).json();
  document.getElementById('s').innerText =
    `step ${st.step}  rays/s ${st.rays_per_sec.toExponential(2)}  ` +
    (st.paused ? 'PAUSED' : 'training');
  setTimeout(loop, 250);
}
loop();
</script></body></html>"""


class LiveViewer:
    """Background HTTP viewer over a (mutable) Gaussian scene."""

    def __init__(self, K, width=640, height=360, port=8080,
                 backend="pallas", native_size=None, device=DEFAULT_DEVICE):
        if isinstance(K, torch.Tensor):
            K = K.detach().cpu().numpy()
        self.K = np.asarray(K, np.float32)
        # (w, h) the intrinsics are calibrated for; estimated from the
        # principal point if not given (cx/cy ~ image center)
        self.native_size = native_size
        self.width = width
        self.height = height
        self.port = port
        self.backend = backend
        self.device = resolve_device(device)
        self._scene = None
        self.lock = threading.Lock()  # trainer cooperation
        self.paused = False
        self.stats = {"step": 0, "rays_per_sec": 0.0}
        self._server = None
        self._thread = None

    def set_scene(self, scene):
        with self.lock:
            self._scene = scene

    def update(self, step: int, rays_per_sec: float):
        self.stats = {"step": int(step), "rays_per_sec": float(rays_per_sec)}

    def wait_if_paused(self):
        import time

        while self.paused:
            time.sleep(0.01)

    def camera(self, params):
        """The query's camera: (c2w (4, 4), K (3, 3)), float32 numpy. The
        intrinsics are scaled from their native frame size to the
        viewer's (a 1200x680 K at a 640x360 viewport would put the
        principal point off-screen)."""
        from scipy.spatial.transform import Rotation

        tx = float(params.get("tx", ["0"])[0])
        ty = float(params.get("ty", ["0"])[0])
        tz = float(params.get("tz", ["-1"])[0])
        rx = float(params.get("rx", ["0"])[0])
        ry = float(params.get("ry", ["0"])[0])
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, :3] = Rotation.from_euler("xy", [rx, ry]).as_matrix()
        c2w[:3, 3] = [tx, ty, tz]
        K = self.K.copy()
        if self.native_size is not None:
            native_w, native_h = self.native_size
        else:
            native_w = 2.0 * K[0, 2] + 1.0
            native_h = 2.0 * K[1, 2] + 1.0
        K[0, :] *= self.width / native_w
        K[1, :] *= self.height / native_h
        return c2w, K

    def render_rgb(self, params) -> np.ndarray:
        """(height, width, 3) uint8 RGB frame of the query's camera
        (black while no scene is set)."""
        from ..ops.lie import invert_se3
        from ..ops.rasterize import rasterize

        with self.lock:
            scene = self._scene
        if scene is None:
            return np.zeros((self.height, self.width, 3), np.uint8)
        c2w, K = self.camera(params)
        with torch.no_grad():
            render, _ = rasterize(
                scene.means, scene.quats, scene.scales, scene.opacities,
                scene.sh_coeffs, invert_se3(as_f32(c2w, self.device)),
                as_f32(K, self.device), self.width, self.height,
                sh_degree=1, render_mode="RGB+ED", backend=self.backend,
            )
        rgb = np.clip(render[..., :3].cpu().numpy(), 0, 1)
        return (rgb * 255).astype(np.uint8)

    def _render(self, params) -> bytes:
        from ..data.png import encode

        return encode(self.render_rgb(params)[..., ::-1])  # takes BGR

    def start(self):
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence
                pass

            def do_GET(self):
                parsed = urlparse(self.path)
                if parsed.path == "/":
                    body = _PAGE.encode()
                    ctype = "text/html"
                elif parsed.path == "/render":
                    body = viewer._render(parse_qs(parsed.query))
                    ctype = "image/png"
                elif parsed.path == "/stats":
                    body = json.dumps(
                        {**viewer.stats, "paused": viewer.paused}
                    ).encode()
                    ctype = "application/json"
                elif parsed.path == "/toggle_pause":
                    viewer.paused = not viewer.paused
                    body = b"ok"
                    ctype = "text/plain"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._server = ThreadingHTTPServer(("0.0.0.0", self.port), Handler)
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        if self._server:
            self._server.shutdown()
            self._server.server_close()
            self._thread.join(timeout=30)
            self._server = None
