"""Interactive HTTP viewer: a live frame stream plus keyboard, mouse and
parameter input (port of rtrt_tpu/app/viewer.py; the same routes and page).

A render thread paces itself to settings.frame_cap_fps
(`Timer.update_with_limiter`), renders a frame and encodes it as PNG
(utils/image.py::encode_png); an HTTP server (stdlib http.server) serves

  GET  /        the page (stream, stats, a parameter panel built from
                PARAM_REGISTRY);
  GET  /stream  multipart PNG frames;
  GET  /params  the registry with the current values, as JSON;
  GET  /stats   {"fps", "w", "h"} as JSON; 500 with the error once the
                render thread has failed;
  POST /input   {"key", "down"}, {"cursor": [x, y]} or {"param", "value"}.

An exception in the render thread ends the render loop and is kept: /stats
reports it, and `stop()` re-raises it.  Engine input and the frame take
one lock, so a key, a cursor move or a parameter lands between frames.

Usage:
  python -m rtrt_tpu_torch.app.viewer --scene demo --width 480 \
      --height 270 --port 8000 [--config cfg.toml] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..utils.config import PARAM_REGISTRY, get_param, set_param
from ..utils.image import encode_png

_PAGE = """<!DOCTYPE html>
<html><head><title>rtrt_tpu</title><style>
body { background:#111; color:#ccc; font-family:monospace; margin:0; display:flex }
#view { image-rendering:pixelated; width:75vw; }
#panel { padding:12px; width:25vw; overflow-y:auto }
.row { margin:4px 0 } input[type=range] { width:140px }
</style></head><body>
<img id="view" src="/stream">
<div id="panel"><h3>rtrt_tpu</h3><div id="stats"></div><div id="params"></div>
<p>WASD move, C/X up/down, drag to look.</p></div>
<script>
const send = (o) => fetch('/input', {method:'POST', body:JSON.stringify(o)});
onkeydown = e => send({key:e.key, down:true});
onkeyup = e => send({key:e.key, down:false});
let dragging=false, lx=0, ly=0;
const v = document.getElementById('view');
v.onmousedown = e => {dragging=true; lx=e.clientX; ly=e.clientY};
onmouseup = () => dragging=false;
onmousemove = e => { if(dragging){ send({cursor:[e.clientX, e.clientY]}); } };
fetch('/params').then(r=>r.json()).then(ps=>{
  const d = document.getElementById('params');
  for (const p of ps) {
    const row = document.createElement('div'); row.className='row';
    row.innerHTML = `${p.label}: <input type=range min=${p.min} max=${p.max}
      step=${(p.max-p.min)/200} value=${p.value}
      oninput="send({param:'${p.path}', value:parseFloat(this.value)})">`;
    d.appendChild(row);
  }
});
setInterval(()=>fetch('/stats').then(r=>r.json()).then(s=>{
  document.getElementById('stats').innerText =
    `${s.fps.toFixed(1)} fps @ ${s.w}x${s.h}`;}), 1000);
</script></body></html>"""

_JOIN_SECONDS = 120.0  # a frame on the CPU takes seconds


class ViewerServer:
    """Runs the Engine in a render thread; serves frames and takes input.
    port=0 binds a free port; `port` is the bound one after `start()`."""

    def __init__(self, engine, port: int = 8000, host: str = "0.0.0.0"):
        self.engine = engine
        self.host = host
        self.port = port
        self.error: BaseException | None = None
        self._latest_png = b""
        self._lock = threading.Lock()       # the latest PNG
        self._engine_lock = threading.Lock()  # frames and input
        self._running = False
        self._server = None
        self._threads = []

    def _render_loop(self):
        try:
            min_dt = 1.0 / max(self.engine.settings.frame_cap_fps, 1.0)
            while self._running:
                self.engine.timer.update_with_limiter(min_dt)
                with self._engine_lock:
                    img = self.engine.render_frame(
                        dt=max(self.engine.timer.delta, 1e-3))
                png = encode_png(img, compress_level=1)
                with self._lock:
                    self._latest_png = png
        except Exception as e:  # kept for /stats and re-raised by stop()
            traceback.print_exc()
            self.error = e

    def _input(self, msg: dict):
        eng = self.engine
        with self._engine_lock:
            if "key" in msg:
                eng.key_event(msg["key"], msg["down"])
            elif "cursor" in msg:
                eng.cursor_event(*msg["cursor"])
            elif "param" in msg:
                eng.params = set_param(eng.params, msg["param"], msg["value"])

    def _handler(self):
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, code, ctype, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _json(self, obj, code=200):
                self._send(code, "application/json", json.dumps(obj).encode())

            def do_GET(self):
                if self.path == "/":
                    self._send(200, "text/html", _PAGE.encode())
                elif self.path == "/stream":
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "multipart/x-mixed-replace; boundary=f")
                    self.end_headers()
                    try:
                        while viewer._running:
                            with viewer._lock:
                                png = viewer._latest_png
                            if png:
                                self.wfile.write(
                                    b"--f\r\nContent-Type: image/png\r\n"
                                    + f"Content-Length: {len(png)}\r\n\r\n"
                                    .encode() + png + b"\r\n")
                            time.sleep(0.05)
                    except (BrokenPipeError, ConnectionResetError):
                        pass
                elif self.path == "/params":
                    params = viewer.engine.params
                    self._json([dict(path=p, label=lab, min=lo, max=hi,
                                     value=float(get_param(params, p)))
                                for (p, lab, _w, lo, hi, _l)
                                in PARAM_REGISTRY])
                elif self.path == "/stats":
                    if viewer.error is not None:
                        self._json(dict(error=repr(viewer.error)), 500)
                    else:
                        eng = viewer.engine
                        self._json(dict(fps=eng.timer.fps, w=eng.render_w,
                                        h=eng.render_h))
                else:
                    self.send_error(404)

            def do_POST(self):
                if self.path == "/input":
                    n = int(self.headers.get("Content-Length", 0))
                    viewer._input(json.loads(self.rfile.read(n)))
                    self.send_response(204)
                    self.end_headers()
                else:
                    self.send_error(404)

        return Handler

    def start(self):
        """Bind the server and start the render and serving threads."""
        self._server = ThreadingHTTPServer((self.host, self.port),
                                           self._handler())
        self.port = self._server.server_address[1]
        self._running = True
        self._threads = [
            threading.Thread(target=self._render_loop, name="viewer-render"),
            threading.Thread(target=self._server.serve_forever,
                             name="viewer-http")]
        for t in self._threads:
            t.start()
        return self

    def stop(self):
        """Stop serving and rendering, join the threads; re-raise the
        render thread's exception, if it had one."""
        self._running = False
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()  # joins the request threads
            self._server = None
        for t in self._threads:
            t.join(_JOIN_SECONDS)
            if t.is_alive():
                raise RuntimeError(f"viewer: thread {t.name} did not stop")
        self._threads = []
        if self.error is not None:
            raise self.error

    def serve(self):
        """start(), then serve until interrupted; stop() on the way out."""
        self.start()
        print(f"viewer at http://localhost:{self.port}/")
        try:
            while self._threads[1].is_alive():
                self._threads[1].join(1.0)
        finally:
            self.stop()


def main(argv=None):
    p = argparse.ArgumentParser(description="rtrt_tpu_torch interactive "
                                            "viewer")
    p.add_argument("--config", default=None)
    p.add_argument("--scene", default="demo")
    p.add_argument("--width", type=int, default=480)
    p.add_argument("--height", type=int, default=270)
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu (plain versions)")
    args = p.parse_args(argv)

    import dataclasses

    from ..engine.engine import Engine
    from ..utils.config import load_config

    settings = dataclasses.replace(
        load_config(args.config), scene=args.scene,
        render_width=args.width, render_height=args.height)
    ViewerServer(Engine(settings, device=args.device), args.port).serve()


if __name__ == "__main__":
    main()
