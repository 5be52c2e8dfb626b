"""Browser-based live viewer, a copy of chameleonrt_tpu/display/http_display.py
with the port's imports: the headless completion of the
reference's interactive window (SDL window + ImGui stats overlay + arcball
mouse input, reference main.cpp:231-380, util/display/gldisplay.cpp:105-139,
overlay main.cpp:352-376). On a headless GPU host a tiny stdlib HTTP server
streams the progressive framebuffer as MJPEG (encoded by utils/jpeg_encode)
to any browser and feeds mouse arcball events back to the render loop.

Endpoints:
  /            the viewer page (canvas image + stats line + mouse handlers)
  /stream      multipart/x-mixed-replace MJPEG of the progressive frame
  /stats       JSON {ms_per_frame, rays_per_second, frame_id, w, h, ...}
  /input       POST JSON {type: rotate|pan|zoom|quit, ...} -> event queue

The server runs on daemon threads; the render loop stays in the caller's
thread and exchanges frames/events through this object (display() publishes
a frame, poll_events() drains mouse input).
"""

from __future__ import annotations

import json
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from chameleonrt_tpu_torch.display.display import Display
from chameleonrt_tpu_torch.core.backend import RenderBackend

_PAGE = """<!doctype html>
<html><head><title>chameleonrt-cuda</title><style>
 body { background:#111; color:#ddd; font:13px monospace; margin:0; }
 #bar { padding:6px 10px; background:#1b1b1b; }
 #view { display:block; margin:0 auto; cursor:grab; image-rendering:pixelated; }
</style></head><body>
<div id="bar">chameleonrt-cuda &mdash; drag: rotate &middot; shift/right-drag:
pan &middot; wheel: zoom &middot; <span id="stats">connecting...</span></div>
<img id="view" src="/stream" draggable="false">
<script>
const img = document.getElementById('view');
const stats = document.getElementById('stats');
let drag = null;
function ndc(ev) {
  const r = img.getBoundingClientRect();
  return [ (ev.clientX - r.left) / r.width * 2 - 1,
           1 - (ev.clientY - r.top) / r.height * 2 ];
}
function post(o) { fetch('/input', {method:'POST', body:JSON.stringify(o)}); }
img.addEventListener('mousedown', ev => { drag = {p: ndc(ev), pan: ev.shiftKey || ev.button === 2}; ev.preventDefault(); });
window.addEventListener('mouseup', () => { drag = null; });
window.addEventListener('mousemove', ev => {
  if (!drag) return;
  const p = ndc(ev);
  if (drag.pan) post({type:'pan', dx: p[0]-drag.p[0], dy: p[1]-drag.p[1]});
  else post({type:'rotate', x0: drag.p[0], y0: drag.p[1], x1: p[0], y1: p[1]});
  drag.p = p;
});
img.addEventListener('wheel', ev => { post({type:'zoom', amount: ev.deltaY > 0 ? -0.2 : 0.2}); ev.preventDefault(); });
img.addEventListener('contextmenu', ev => ev.preventDefault());
setInterval(async () => {
  try {
    const s = await (await fetch('/stats')).json();
    stats.textContent = s.ms_per_frame.toFixed(1) + ' ms/frame  ' +
      (s.rays_per_second/1e6).toFixed(2) + ' Mray/s  frame ' + s.frame_id +
      '  ' + s.width + 'x' + s.height;
  } catch (e) {}
}, 500);
</script></body></html>"""


class HttpDisplay(Display):
    """Serves the progressive framebuffer over HTTP; collects mouse input."""

    def __init__(
        self, port: int = 8000, quality: int = 80, host: str = "127.0.0.1"
    ):
        # Default bind is loopback: /input accepts unauthenticated POSTs
        # (camera drags and {type:'quit'}, which terminates the render
        # loop), so exposing the port to a network is strictly opt-in via
        # -display http:<host>:<port> (e.g. http:0.0.0.0:8000 behind a
        # trusted-network tunnel).
        self.host = host
        self.quality = quality
        self.events: "queue.Queue[dict]" = queue.Queue()
        self.closed = False
        self._frame_lock = threading.Condition()
        self._jpeg: bytes | None = None
        self._frame_no = 0
        self._stats = {
            "ms_per_frame": 0.0,
            "rays_per_second": 0.0,
            "frame_id": 0,
            "width": 0,
            "height": 0,
        }
        disp = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                if self.path == "/" or self.path.startswith("/index"):
                    body = _PAGE.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/stats":
                    body = json.dumps(disp._stats).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/stream":
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "multipart/x-mixed-replace; boundary=crtframe",
                    )
                    self.end_headers()
                    last = -1
                    try:
                        while not disp.closed:
                            with disp._frame_lock:
                                if disp._frame_no == last:
                                    disp._frame_lock.wait(timeout=1.0)
                                if disp._jpeg is None or disp._frame_no == last:
                                    continue
                                data = disp._jpeg
                                last = disp._frame_no
                            self.wfile.write(
                                b"--crtframe\r\nContent-Type: image/jpeg\r\n"
                                + f"Content-Length: {len(data)}\r\n\r\n".encode()
                            )
                            self.wfile.write(data)
                            self.wfile.write(b"\r\n")
                    except (BrokenPipeError, ConnectionResetError):
                        pass
                else:
                    self.send_error(404)

            def do_POST(self):
                if self.path == "/input":
                    n = int(self.headers.get("Content-Length", 0))
                    try:
                        ev = json.loads(self.rfile.read(n) or b"{}")
                    except json.JSONDecodeError:
                        self.send_error(400)
                        return
                    if ev.get("type") == "quit":
                        disp.closed = True
                    else:
                        disp.events.put(ev)
                    self.send_response(204)
                    self.end_headers()
                else:
                    self.send_error(404)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()

    def name(self) -> str:
        return f"HTTP viewer on :{self.port}"

    def display(self, renderer: RenderBackend, status: str = "") -> None:
        from chameleonrt_tpu_torch.utils.jpeg_encode import encode_jpeg

        img = np.asarray(renderer.img)[..., :3]
        data = encode_jpeg(img, quality=self.quality)
        with self._frame_lock:
            self._jpeg = data
            self._frame_no += 1
            self._stats["width"] = img.shape[1]
            self._stats["height"] = img.shape[0]
            self._frame_lock.notify_all()

    def set_stats(self, ms_per_frame: float, rays_per_second: float,
                  frame_id: int) -> None:
        self._stats["ms_per_frame"] = float(ms_per_frame)
        self._stats["rays_per_second"] = float(rays_per_second)
        self._stats["frame_id"] = int(frame_id)

    def poll_events(self) -> list:
        out = []
        while True:
            try:
                out.append(self.events.get_nowait())
            except queue.Empty:
                return out

    def close(self) -> None:
        self.closed = True
        with self._frame_lock:
            self._frame_lock.notify_all()
        self._server.shutdown()
        self._server.server_close()
