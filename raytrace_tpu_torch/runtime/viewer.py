"""Live progressive viewer — the headless analogue of the reference window.

Port of ``raytrace_tpu/runtime/viewer.py``: the same page, endpoints,
``/state`` keys and camera input.  The reference presents each GPU's band
in a borderless window and feeds the cursor into a camera-direction input
(window.hpp:29-54; dead code there, quirk Q4; live here).  Headless, an HTTP
server streams the running image after every progressive call, and any
HTTP client can steer the camera, which restarts the accumulation.

Zero dependencies: stdlib ``http.server`` and the port's PNG writer.

Endpoints:
  GET  /            interactive page (auto-refreshing image, drag-to-orbit)
  GET  /frame.png   latest progressive render
  GET  /state       JSON {samples_done, target, frame, camera_pos, ...}
  POST /camera      JSON {"pos": [x,y,z]} and/or {"dir": [x,y,z]}, or
                    {"orbit": [d_azimuth, d_elevation]} — restarts the
                    progressive accumulation with the new camera

Usage: ``python -m raytrace_tpu_torch --serve 8000 --samples 1000`` or::

    from raytrace_tpu_torch.runtime.viewer import LiveViewer
    LiveViewer(RenderConfig(...)).run()        # blocks; ctrl-C to stop

It renders on ``device`` ("cuda" by default, raising without a GPU; "cpu"
runs the kernels' plain versions).
"""

from __future__ import annotations

import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

import torch

from ..config import RenderConfig
from .renderer import render_device

_PAGE = """<!doctype html>
<html><head><title>raytrace_tpu live</title><style>
body { background:#111; color:#ccc; font-family:monospace; text-align:center }
img { image-rendering:pixelated; max-width:95vw; cursor:grab }
</style></head><body>
<h3>raytrace_tpu &mdash; live progressive render</h3>
<div id="s">connecting...</div>
<img id="f" src="/frame.png" draggable="false">
<p>drag to orbit the camera (restarts accumulation)</p>
<script>
const img = document.getElementById('f'), st = document.getElementById('s');
setInterval(() => { img.src = '/frame.png?' + Date.now(); }, 500);
setInterval(async () => {
  const r = await fetch('/state'); const j = await r.json();
  st.textContent = `frame ${j.frame}  ${j.samples_done}/${j.target} spp  ` +
                   `cam ${j.camera_pos.map(x=>x.toFixed(1))}`;
}, 500);
let drag = null;
img.onmousedown = e => { drag = [e.clientX, e.clientY]; };
window.onmouseup = async e => {
  if (!drag) return;
  const d = [(e.clientX - drag[0]) * 0.01, (e.clientY - drag[1]) * 0.01];
  drag = null;
  if (d[0] || d[1]) await fetch('/camera', {method: 'POST',
    body: JSON.stringify({orbit: d})});
};
</script></body></html>"""


class LiveViewer:
    """Progressive render loop + HTTP presentation/input server."""

    def __init__(self, config: RenderConfig, scene=None, port: int = 8000,
                 host: str = "127.0.0.1", device="cuda"):
        self.config = config
        self.device = render_device(device)
        self.scene = scene
        self.port = port
        self.host = host
        self._lock = threading.Lock()
        self._png: bytes = b""
        self._state = {"samples_done": 0, "target": config.samples,
                       "frame": 0, "camera_pos": [13.0, 11.0, -3.0],
                       "camera_dir": [-13.0, -11.0, 3.0]}
        self._camera_changed = threading.Event()
        self._stop = threading.Event()
        self._new_camera: Optional[Tuple[tuple, tuple]] = None
        self.httpd: Optional[ThreadingHTTPServer] = None

    # ---- camera input (window.hpp:42-46 analogue) -------------------------

    def set_camera(self, pos=None, direction=None) -> None:
        with self._lock:
            p = tuple(pos) if pos is not None else tuple(self._state["camera_pos"])
            if direction is not None:
                d = tuple(direction)
            elif pos is not None:
                d = (-p[0], -p[1], -p[2])  # keep looking at the origin
            else:
                d = tuple(self._state["camera_dir"])
            self._new_camera = (p, d)
            self._state["camera_pos"] = list(p)
            self._state["camera_dir"] = list(d)
        self._camera_changed.set()

    def orbit(self, d_azimuth: float, d_elevation: float) -> None:
        """Orbit the camera around the origin (the scene center)."""
        with self._lock:
            x, y, z = self._state["camera_pos"]
        r = math.sqrt(x * x + y * y + z * z)
        az = math.atan2(z, x) + d_azimuth
        el = math.asin(max(-1.0, min(1.0, y / r))) + d_elevation
        el = max(-1.45, min(1.45, el))
        pos = (r * math.cos(el) * math.cos(az), r * math.sin(el),
               r * math.cos(el) * math.sin(az))
        self.set_camera(pos=pos)

    # ---- presentation ------------------------------------------------------

    def _publish(self, accum, done: int) -> None:
        from ..ops.image import accum_to_u8
        from ..utils.png import encode_png

        img = accum_to_u8(accum, max(done, 1))
        png = encode_png(img.cpu().numpy() if torch.is_tensor(img) else img)
        with self._lock:
            self._png = png
            self._state["samples_done"] = done

    def _make_handler(self):
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/":
                    self._send(200, "text/html", _PAGE.encode())
                elif path == "/frame.png":
                    with viewer._lock:
                        png = viewer._png
                    if not png:
                        self._send(503, "text/plain", b"no frame yet")
                    else:
                        self._send(200, "image/png", png)
                elif path == "/state":
                    with viewer._lock:
                        body = json.dumps(viewer._state).encode()
                    self._send(200, "application/json", body)
                else:
                    self._send(404, "text/plain", b"not found")

            def do_POST(self):
                if self.path.split("?")[0] != "/camera":
                    self._send(404, "text/plain", b"not found")
                    return
                n = int(self.headers.get("Content-Length", 0))
                try:
                    req = json.loads(self.rfile.read(n) or b"{}")
                    if "orbit" in req:
                        viewer.orbit(float(req["orbit"][0]),
                                     float(req["orbit"][1]))
                    else:
                        viewer.set_camera(req.get("pos"), req.get("dir"))
                except Exception as e:
                    self._send(400, "text/plain", str(e).encode())
                    return
                self._send(200, "application/json", b'{"ok": true}')

        return Handler

    def start_server(self) -> int:
        """Start the HTTP server (daemon thread); returns the bound port."""
        self.httpd = ThreadingHTTPServer((self.host, self.port),
                                         self._make_handler())
        self.port = self.httpd.server_address[1]
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        t.start()
        return self.port

    def stop(self) -> None:
        self._stop.set()
        self._camera_changed.set()  # unblock an idle wait
        if self.httpd is not None:
            self.httpd.shutdown()
            self.httpd.server_close()

    def render_loop(self, max_frames: Optional[int] = None) -> None:
        """Progressive render; restarts accumulation on camera input.

        Each outer iteration is a "frame" (one camera): progressive calls
        stream the refining image until ``config.samples`` is reached, then
        the loop idles awaiting camera input.  ``max_frames`` bounds the
        number of camera frames (for tests)."""
        import dataclasses

        from .renderer import Renderer

        frames = 0
        while not self._stop.is_set():
            with self._lock:
                cam = self._new_camera
                self._new_camera = None
                self._state["frame"] = frames
            self._camera_changed.clear()
            cfg = self.config
            if cam is not None:
                cfg = dataclasses.replace(cfg, camera_pos=cam[0],
                                          camera_dir=cam[1])
            r = Renderer(cfg, scene=self.scene, device=self.device)
            per = cfg.samples_per_call or max(1, cfg.samples // 16)
            done, number, accum = 0, 0, None
            while done < cfg.samples and not self._camera_changed.is_set():
                spp = min(per, cfg.samples - done)
                accum = r.render_call(spp, number=number, accum=accum)
                done += spp
                number += 1
                self._publish(accum, done)
            frames += 1
            if max_frames is not None and frames >= max_frames:
                return
            if not self._camera_changed.is_set():
                # converged: idle until steered (or stopped)
                self._camera_changed.wait()

    def run(self, max_frames: Optional[int] = None) -> None:
        port = self.start_server()
        print(f"live viewer: http://{self.host}:{port}/  (ctrl-C to stop)")
        try:
            self.render_loop(max_frames=max_frames)
        finally:
            self.stop()
