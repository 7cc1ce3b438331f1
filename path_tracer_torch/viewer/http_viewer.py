"""A threaded HTTP progressive viewer that needs no display server.

Port of ``path_tracer_tpu/viewer/http_viewer.py``. The render driver calls
``update(image_u8, ...)`` after every pass batch; the page served on
127.0.0.1 polls and repaints the latest frame, as the reference's window
repaints its running average.

- ``/``: the page (wheel to zoom at the cursor, drag to pan, double-click
  to reset, a status line and a Stop button);
- ``/frame.png``: the latest frame, encoded by ``utils.image_io``;
- ``/status``: JSON progress (samples done and total, elapsed seconds,
  Mray/s, done, stopping);
- ``/stop``: asks for an early end; the render driver reads
  ``stop_requested`` between pass batches and finalizes the image over
  the samples done;
- ``wait_for_close()`` keeps serving the final frame until ``/stop`` or
  Ctrl-C, and ``close()`` shuts the server down.

Port 0 takes a free port (``url`` names it). When the port cannot be
bound, frames go to ``preview.png`` in the working directory instead.
"""
from __future__ import annotations

import json
import threading
import time

import numpy as np

from path_tracer_torch.utils.image_io import encode_png

_PAGE = b"""<!doctype html><html><head><title>path-tracer-torch</title></head>
<body style="margin:0;background:#111;color:#ccc;font:13px monospace;\
overflow:hidden">
<div style="padding:4px;position:relative;z-index:2">
  <span id="st">starting...</span>
  <button onclick="fetch('/stop',{method:'POST'})">Stop</button>
  <span style="opacity:.6">&nbsp;wheel: zoom &middot; drag: pan &middot;
  double-click: reset</span>
</div>
<div id="vp" style="position:fixed;inset:0;cursor:grab">
  <img id="im" draggable="false" style="image-rendering:pixelated;\
position:absolute;left:50%;top:50%;transform-origin:0 0;\
user-select:none"/>
</div>
<script>
const im = document.getElementById('im');
const vp = document.getElementById('vp');
const st = document.getElementById('st');
let z = 1, tx = 0, ty = 0;  // zoom + pan offset (view center analog)
function apply() {
  im.style.transform =
    `translate(-50%,-50%) translate(${tx}px,${ty}px) scale(${z})`;
}
vp.addEventListener('wheel', e => {
  e.preventDefault();
  const f = Math.pow(1.1, -Math.sign(e.deltaY));   // one zoom step
  const cx = e.clientX - vp.clientWidth / 2 - tx;
  const cy = e.clientY - vp.clientHeight / 2 - ty;
  tx -= cx * (f - 1); ty -= cy * (f - 1);          // anchor at the cursor
  z *= f; apply();
}, {passive: false});
let drag = null;
vp.addEventListener('mousedown', e => {
  e.preventDefault();  // defeat native <img> drag so panning works
  drag = [e.clientX, e.clientY];
});
window.addEventListener('mousemove', e => {
  if (!drag) return;
  tx += e.clientX - drag[0]; ty += e.clientY - drag[1];
  drag = [e.clientX, e.clientY]; apply();
});
window.addEventListener('mouseup', () => { drag = null; });
vp.addEventListener('dblclick', () => { z = 1; tx = ty = 0; apply(); });
apply();
setInterval(() => {
  const n = new Image();
  n.onload = () => { im.src = n.src; };   // swap only once loaded
  n.src = '/frame.png?' + Date.now();
}, 250);
setInterval(async () => {
  try {
    const s = await (await fetch('/status')).json();
    st.textContent = `${s.samples_done}/${s.samples_total} spp  ` +
      `${s.elapsed_s.toFixed(1)}s  ${s.mrays_per_s.toFixed(2)} Mray/s` +
      (s.done ? '  [done]' : s.stopping ? '  [stopping]' : '');
  } catch (e) {}
}, 500);
</script></body></html>"""


class ProgressiveViewer:
    def __init__(self, resolution=None, port: int = 8642):
        self._lock = threading.Lock()
        self._png: bytes = b""
        self._server = None
        self._stop = threading.Event()
        self._status = {"samples_done": 0, "samples_total": 0,
                        "elapsed_s": 0.0, "mrays_per_s": 0.0,
                        "done": False, "stopping": False}
        self._t0 = time.time()
        self.url = None
        try:
            self._start_server(port)
        except OSError as e:
            import warnings

            warnings.warn(
                f"viewer could not bind port {port} ({e}); falling back to "
                "writing preview.png per pass", stacklevel=2)
            self._server = None

    def _start_server(self, port: int):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def _send(self, code: int, kind=None, body: bytes = b""):
                self.send_response(code)
                if kind is not None:
                    self.send_header("Content-Type", kind)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802
                if self.path.startswith("/frame.png"):
                    with viewer._lock:
                        body = viewer._png
                    self._send(200 if body else 404, "image/png", body)
                elif self.path.startswith("/status"):
                    with viewer._lock:
                        body = json.dumps(viewer._status).encode()
                    self._send(200, "application/json", body)
                elif self.path.startswith("/stop"):
                    viewer.request_stop()
                    self._send(200)
                else:
                    self._send(200, "text/html", _PAGE)

            def do_POST(self):  # noqa: N802
                if self.path.startswith("/stop"):
                    viewer.request_stop()
                    self._send(200)
                else:
                    self._send(404)

            def log_message(self, *a):  # no request log
                pass

        self._server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self._server.daemon_threads = True
        self.url = f"http://127.0.0.1:{self._server.server_address[1]}/"
        threading.Thread(target=self._server.serve_forever,
                         daemon=True).start()
        print(f"Viewer: {self.url}", flush=True)

    @property
    def stop_requested(self) -> bool:
        """True once the user asked to end the render early."""
        return self._stop.is_set()

    def request_stop(self) -> None:
        self._stop.set()
        with self._lock:
            self._status["stopping"] = True

    def update(self, image_u8: np.ndarray, samples_done: int = 0,
               samples_total: int = 0, rays_done: int = 0) -> None:
        """Push the latest tonemapped frame ([H,W,3] uint8) and progress."""
        png = encode_png(np.asarray(image_u8, np.uint8))
        elapsed = time.time() - self._t0
        if self._server is None:
            with open("preview.png", "wb") as f:
                f.write(png)
            return
        with self._lock:
            self._png = png
            self._status.update(
                samples_done=int(samples_done),
                samples_total=int(samples_total),
                elapsed_s=elapsed,
                mrays_per_s=(rays_done / max(elapsed, 1e-9)) / 1e6,
                done=samples_done >= samples_total > 0
                and not self._stop.is_set())

    def wait_for_close(self) -> None:
        """Keep serving the final frame until /stop or Ctrl-C (the
        reference's wait for its window to close)."""
        if self._server is None:
            return
        with self._lock:
            self._status["done"] = True
        print("Viewer still serving — press Ctrl-C or hit Stop to exit.",
              flush=True)
        try:
            while not self._stop.wait(timeout=0.25):
                pass
        except KeyboardInterrupt:
            pass

    def close(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
