"""Live map and frame viewer: the reference's Pangolin Viewer thread as an
HTTP server.

Counterpart of orbslam2_tpu/viz/live_viewer.py. The reference spawns a GL
window thread (src/Viewer.cpp:108-169) that renders the map at camera rate
with menu toggles (follow camera, show points / keyframes / graph,
localization mode, reset; src/Viewer.cpp:73-79), plus a FrameDrawer overlay
updated from the tracking thread (src/FrameDrawer.cpp, Update called at
src/Tracking.cpp:346,526). A server has no display, so a browser polls
`/map.png` and `/frame.png`, which a render thread redraws at a bounded
rate (never the tracking thread), and drives the same toggles through
`/set?...`. The tracking thread pays only for `update()`: one image copy
under a lock, the analogue of FrameDrawer::Update's state copy.

The render thread reads host arrays only (the map's numpy fields, the
frame's pose and keypoints, the tracker's trajectory) and makes no torch
call, so it never waits for, or competes with, the tracker's CUDA stream.

Routes:
    /            HTML page (auto-refreshing images + toggle buttons)
    /map.png     top-down map render (points, keyframes, covis graph, trajectory)
    /frame.png   current-frame keypoint overlay
    /stats.json  map_stats() and the menu
    /set?points=0|1&graph=0|1&follow=0|1&localization=0|1
    /reset       full system reset (the menu's "Reset" button)
"""
from __future__ import annotations

import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

_PAGE = """<!doctype html><html><head><title>orbslam2_tpu viewer</title>
<style>body{font-family:sans-serif;background:#111;color:#ddd}
img{border:1px solid #444;max-width:48vw}
a{color:#8cf;margin-right:1em}</style></head><body>
<h3>orbslam2_tpu live viewer (PyTorch port)</h3>
<div id="menu"></div>
<p id="stats"></p>
<img id="map" src="/map.png"> <img id="frame" src="/frame.png">
<script>
const toggles=["follow","points","graph","localization"];
function menu(st){const m=st.menu||{};document.getElementById("menu").innerHTML=
 toggles.map(t=>`<a href="#" onclick="fetch('/set?${t}='+(${m[t]}?0:1))
 .then(()=>location.reload());return false">[${m[t]?"x":" "}] ${t}</a>`)
 .join("")+`<a href="#" onclick="fetch('/reset');return false">RESET</a>`;}
setInterval(()=>{
 document.getElementById("map").src="/map.png?"+Date.now();
 document.getElementById("frame").src="/frame.png?"+Date.now();
 fetch("/stats.json").then(r=>r.json()).then(s=>{
   document.getElementById("stats").textContent=JSON.stringify(s);menu(s);});
},1000);
fetch("/stats.json").then(r=>r.json()).then(menu);
</script></body></html>"""


class LiveViewer:
    def __init__(self, system, host: str = "127.0.0.1", port: int = 0,
                 interval: float = 0.5):
        self.system = system
        self.interval = interval
        # menu state (src/Viewer.cpp:73-79)
        self.follow = True
        self.show_points = True
        self.show_graph = True
        self.localization = False
        self._lock = threading.Lock()
        self._latest = None         # (gray image copy, Frame)
        self._dirty = threading.Event()
        self._map_png: bytes | None = None
        self._frame_png: bytes | None = None
        # ms of the last map and frame render; the renders dropped and the
        # last one's error
        self.render_ms: dict = {}
        self.n_dropped = 0
        self.last_error: str | None = None
        self._stop = threading.Event()

        viewer = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                u = urlparse(self.path)
                if u.path == "/":
                    self._send(200, "text/html", _PAGE.encode())
                elif u.path == "/map.png":
                    self._send_png(viewer._map_png)
                elif u.path == "/frame.png":
                    self._send_png(viewer._frame_png)
                elif u.path == "/stats.json":
                    self._send(200, "application/json",
                               json.dumps(viewer.stats()).encode())
                elif u.path == "/set":
                    viewer._apply_toggles(parse_qs(u.query))
                    self._send(200, "text/plain", b"ok")
                elif u.path == "/reset":
                    # deferred: applied on the tracking thread (the
                    # reference's mbReset flag, src/System.cpp:255-262)
                    viewer.system.request_reset()
                    self._send(200, "text/plain", b"ok")
                else:
                    self._send(404, "text/plain", b"not found")

            def _send_png(self, data):
                if data is None:
                    self._send(503, "text/plain", b"no render yet")
                else:
                    self._send(200, "image/png", data)

            def _send(self, code, ctype, body):
                try:
                    self.send_response(code)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(body)))
                    self.send_header("Cache-Control", "no-store")
                    self.end_headers()
                    self.wfile.write(body)
                except (BrokenPipeError, ConnectionResetError):
                    pass

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._http_thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._render_thread = threading.Thread(target=self._render_loop, daemon=True)
        self._http_thread.start()
        self._render_thread.start()

    # ------------------------------------------------------------ tracking side
    def update(self, img: np.ndarray, frame) -> None:
        """FrameDrawer::Update's counterpart, called from the tracking thread
        after every frame: one image copy under a lock."""
        with self._lock:
            self._latest = (np.array(img, copy=True), frame)
        self._dirty.set()

    # --------------------------------------------------------------- toggles
    def stats(self) -> dict:
        """/stats.json: the System's map_stats() and the menu state."""
        st = dict(self.system.map_stats())
        st["menu"] = dict(follow=int(self.follow), points=int(self.show_points),
                          graph=int(self.show_graph), localization=int(self.localization))
        return st

    def _apply_toggles(self, q: dict) -> None:
        def flag(name, cur):
            v = q.get(name)
            return cur if v is None else v[0] not in ("0", "false", "")

        self.follow = flag("follow", self.follow)
        self.show_points = flag("points", self.show_points)
        self.show_graph = flag("graph", self.show_graph)
        loc = flag("localization", self.localization)
        if loc != self.localization:
            self.localization = loc
            if loc:
                self.system.activate_localization_mode()
            else:
                self.system.deactivate_localization_mode()
        self._dirty.set()

    # ------------------------------------------------------------ render side
    def _render_loop(self) -> None:
        while not self._stop.is_set():
            if not self._dirty.wait(timeout=0.25):
                continue
            self._dirty.clear()
            try:
                self._render_once()
            except Exception as e:  # noqa: BLE001 - the thread must keep serving
                # a snapshot torn while the mapper grows or edits the map:
                # drop this render, the next tick redraws (the reference
                # holds the map mutex instead)
                self.n_dropped += 1
                self.last_error = repr(e)
            self._stop.wait(self.interval)
        self._httpd.shutdown()

    def _render_once(self) -> None:
        from .map_render import render_frame_overlay, render_map_topdown

        with self._lock:
            latest = self._latest
        mp = self.system.map

        center = None
        if latest is not None:
            img, frame = latest
            t0 = time.perf_counter()
            buf = io.BytesIO()
            render_frame_overlay(img, frame, buf)
            self._frame_png = buf.getvalue()
            self.render_ms["frame"] = (time.perf_counter() - t0) * 1e3
            if self.follow and frame.pose is not None:
                T = frame.pose
                center = -T[:, :3].T @ T[:, 3]

        t0 = time.perf_counter()
        ts, est = self.system.tracker.trajectory()
        buf = io.BytesIO()
        render_map_topdown(mp, trajectory=est if len(est) else None, path=buf,
                           show_covisibility=self.show_graph,
                           show_points=self.show_points,
                           center=center if self.follow else None)
        self._map_png = buf.getvalue()
        self.render_ms["map"] = (time.perf_counter() - t0) * 1e3

    # ---------------------------------------------------------------- control
    def stop(self) -> None:
        self._stop.set()
        self._dirty.set()
        self._render_thread.join(timeout=10)
        self._http_thread.join(timeout=10)
        self._httpd.server_close()
