"""Interactive viewer, the ``rayinteractive`` equivalent
(rayinteractive.c:106-208).

Port of :mod:`tpuray.apps.rayview`.  The reference opens a minifb window and
re-renders every frame, mutating camera state from keyboard callbacks (WASD
move along dir/right, arrows = spherical rotation at 0.05 rad, Space/Shift =
up/down at 0.1; rayinteractive.c:32-104).  The capability that matters
(SURVEY.md section 3.2) is the parameter-swap re-render: here the scene is
packed once (``pack_scene``, triangle tables included) and a frame swaps only
the camera basis (``megakernel.swap_basis``: one small host-to-device copy),
launches the megakernel once, quantises on the device and copies the u8
frame back.  Where ``engine='auto'`` cannot take the megakernel (too many
triangles, too deep) the frames go through the whole-image tracer, with one
warning.

    python -m tpuray_torch.apps.rayview [--scene render.map] [--asset-dir A]
        [--width 800 --height 600] [--depth 6] [--device cuda]
        [--keys "wwassdd 8"] [--frames-dir out/frames] [--serve PORT]

Three modes:

* ``--keys`` feeds a key script (e.g. "wwassdd 8_") and writes one PNG per
  frame; the exact key -> state mapping of rayinteractive.c.
* ``--serve PORT`` serves the live display surface: an in-browser viewer
  streaming MJPEG frames over HTTP (it works through an SSH tunnel to a
  remote card, where the reference's local minifb window,
  rayinteractive.c:118-122 and 183-197, cannot), with browser keyboard
  events driving the same ``CameraController``.  The render thread
  re-renders only when the camera changed (the vsync-paced mfb_wait_sync
  analog).  Frames are encoded by ``io.encode_jpeg``.
* interactive stdin: type keys and enter; 'q' quits.
"""
from __future__ import annotations

import argparse
import os
import threading
import time
import traceback

import numpy as np
import torch

from ..camera import Camera, perspective_basis
from ..config import REFERENCE_DIR, RenderConfig
from ..io import encode_jpeg, write_png
from ..kernels.megakernel import pack_scene, render_megakernel, swap_basis
from ..render import quantize_image, render_from_basis_tracer, resolve_engine
from ..sceneio import load_scene
from ..textures import DEFAULT_SKYBOX, REFERENCE_ASSETS, load_default_assets

MOVE_SPEED = 0.1    # rayinteractive.c:29
ROT_SPEED = 0.05    # rayinteractive.c:30


class CameraController:
    """Spherical-angle + WASD camera state machine (rayinteractive.c:32-104).

    State: origin + (x_rot, y_rot) spherical angles, y-up
    (dir = (sin x cos y, cos x, sin x sin y), rayinteractive.c:85-92).
    ``key`` and ``camera`` hold a lock, so a render thread's camera never
    mixes the states before and after a key.
    """

    def __init__(self, origin=(0.8, 2.5, -8.0), x_rot=np.pi / 2.0,
                 y_rot=np.pi / 2.0):
        self.origin = np.asarray(origin, np.float64)
        self.x_rot = float(x_rot)   # polar, rayinteractive.c:16
        self.y_rot = float(y_rot)   # azimuth
        self._lock = threading.Lock()

    @property
    def lookdir(self):
        sx, cx = np.sin(self.x_rot), np.cos(self.x_rot)
        sy, cy = np.sin(self.y_rot), np.cos(self.y_rot)
        return np.array([sx * cy, cx, sx * sy])

    def key(self, k: str) -> None:
        with self._lock:
            d = self.lookdir
            forward = -d
            right = np.cross([0.0, 1.0, 0.0], forward)  # cpu_ray.c:82-87
            up = np.cross(forward, right)               # cpu_ray.c:88-91
            if k == "w":
                self.origin += d * MOVE_SPEED
            elif k == "s":
                self.origin -= d * MOVE_SPEED
            elif k == "a":                          # rayinteractive.c:60-63
                self.origin -= right * MOVE_SPEED
            elif k == "d":                          # rayinteractive.c:65-68
                self.origin += right * MOVE_SPEED
            elif k == " ":                          # along the perspective up
                self.origin += up * MOVE_SPEED      # vector, :70-73
            elif k == "_":                          # shift = down, :75-78
                self.origin -= up * MOVE_SPEED
            elif k == "8":                          # up arrow
                self.x_rot -= ROT_SPEED
            elif k == "2":                          # down arrow
                self.x_rot += ROT_SPEED
            elif k == "4":                          # left arrow
                self.y_rot -= ROT_SPEED
            elif k == "6":                          # right arrow
                self.y_rot += ROT_SPEED

    def camera(self) -> Camera:
        with self._lock:
            return Camera(tuple(self.origin), tuple(self.lookdir), 90.0, 1.0)


class FrameLoop:
    """Renders frames of one scene from changing cameras.

    The engine is resolved once (``render.resolve_engine``: a fall-back to
    the tracer warns here, not every frame).  For the megakernel the scene
    is packed once, here; a frame swaps the basis in (the basis is made on
    the host), launches the kernel, quantises on the device and copies the
    u8 frame back.  ``times`` holds each frame's host times in ms (``swap``,
    ``copy`` back, the whole ``frame``) and, on a card, its ``device`` time
    (CUDA events around the render and the quantisation); ``rgb`` the last
    frame's linear image on the device."""

    def __init__(self, scene, assets, cfg: RenderConfig, camera: Camera):
        self.scene, self.assets, self.cfg = scene, assets, cfg
        self.device = scene.device
        self.engine = resolve_engine(scene, cfg)
        self.packed = None
        if self.engine == "megakernel":
            if self.device.type == "cuda":
                # build and load the kernels here, before any render thread
                from ..kernels.build import load_library
                load_library()
            self.packed = pack_scene(scene, self._basis(camera))
        self.times = []
        self.rgb = None

    def _basis(self, camera: Camera):
        return perspective_basis(camera, self.cfg.width, self.cfg.height,
                                 device="cpu")

    def frame(self, camera: Camera) -> np.ndarray:
        """One frame of ``camera`` as host u8 [H, W, 3]."""
        cfg, cuda = self.cfg, self.device.type == "cuda"
        t0 = time.perf_counter()
        basis = self._basis(camera)
        if self.packed is not None:
            self.packed = swap_basis(self.packed, basis)
        t1 = time.perf_counter()
        if cuda:
            events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            events[0].record()
        if self.packed is None:
            rgb = render_from_basis_tracer(self.scene, self.assets,
                                           basis.to(self.device), cfg)
        else:
            rgb = render_megakernel(self.packed, self.assets, cfg)
        q = quantize_image(rgb, cfg.width, cfg.height)
        if cuda:
            events[1].record()
        t2 = time.perf_counter()
        img = q.cpu().numpy()
        t3 = time.perf_counter()
        self.rgb = rgb
        self.times.append({
            "swap": (t1 - t0) * 1e3, "copy": (t3 - t2) * 1e3,
            "frame": (t3 - t0) * 1e3,
            "device": events[0].elapsed_time(events[1]) if cuda else None})
        return img


_VIEWER_HTML = """<!doctype html>
<html><head><title>tpuray rayview</title><style>
  body { margin:0; background:#111; color:#ccc;
         font:13px system-ui, sans-serif; }
  #hud { padding:6px 10px; } img { display:block; margin:0 auto; }
</style></head><body>
<div id="hud">tpuray — WASD move &middot; arrows rotate &middot;
space/shift up/down &middot; <span id="stat"></span></div>
<img id="view" src="/stream">
<script>
const MAP = {"w":"w","a":"a","s":"s","d":"d"," ":" ",
             "ArrowUp":"8","ArrowDown":"2","ArrowLeft":"4",
             "ArrowRight":"6","Shift":"_"};
document.addEventListener("keydown", (e) => {
  const k = MAP[e.key];
  if (k === undefined) return;
  e.preventDefault();
  fetch("/key?k=" + encodeURIComponent(k)).then(r => r.text())
    .then(t => { document.getElementById("stat").textContent = t; });
});
</script></body></html>
"""


def serve(ctl, frame_u8, width, height, port, host="0.0.0.0",
          quality=85, started=None):
    """MJPEG live viewer (the reference's display surface, re-homed to a
    browser so it works across a tunnel to a remote card).

    ``frame_u8()`` -> HWC u8 frame for the CURRENT ctl state; it is called
    from one render thread, only when a key changed the camera (the
    mfb_wait_sync analog: idle costs no device time).  HTTP handlers only
    read the latest encoded JPEG.  ``started(httpd, stop)`` is called once
    the server listens; ``stop.set()`` and ``httpd.shutdown()`` end it.  A
    failure of ``frame_u8`` stops the server and is raised here.
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs, urlparse

    state = {"jpeg": b"", "seq": 0, "ms": 0.0, "error": None}
    cond = threading.Condition()
    dirty = threading.Event()
    dirty.set()     # render the first frame at once
    stop = threading.Event()

    def render_loop():
        while not stop.is_set():
            if not dirty.wait(timeout=0.25):
                continue
            dirty.clear()
            t0 = time.perf_counter()
            try:
                jpeg = encode_jpeg(frame_u8(), quality)
            except Exception as e:      # the server cannot go on without it
                traceback.print_exc()
                state["error"] = e
                stop.set()
                httpd.shutdown()
                return
            with cond:
                state["jpeg"] = jpeg
                state["seq"] += 1
                state["ms"] = (time.perf_counter() - t0) * 1e3
                cond.notify_all()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):   # quiet
            pass

        def _reply(self, kind: str, body: bytes):
            self.send_response(200)
            self.send_header("Content-Type", kind)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/" or self.path.startswith("/index"):
                self._reply("text/html", _VIEWER_HTML.encode())
            elif self.path.startswith("/key"):
                q = parse_qs(urlparse(self.path).query)
                for k in q.get("k", [""])[0]:
                    ctl.key(k)
                dirty.set()
                self._reply("text/plain", (
                    f"{state['ms']:.0f} ms/frame  origin="
                    f"{np.round(ctl.origin, 2)}").encode())
            elif self.path.startswith("/stream"):
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "multipart/x-mixed-replace; boundary=frame")
                self.end_headers()
                seen = -1
                try:
                    while not stop.is_set():
                        with cond:
                            if state["seq"] == seen:
                                cond.wait(timeout=1.0)
                            if state["seq"] == seen:
                                continue
                            jpeg, seen = state["jpeg"], state["seq"]
                        self.wfile.write(
                            b"--frame\r\nContent-Type: image/jpeg\r\n"
                            + f"Content-Length: {len(jpeg)}\r\n\r\n"
                            .encode() + jpeg + b"\r\n")
                except (BrokenPipeError, ConnectionResetError):
                    pass
            elif self.path.startswith("/frame.jpg"):
                with cond:
                    if state["seq"] == 0:
                        cond.wait(timeout=30.0)
                    jpeg = state["jpeg"]
                self._reply("image/jpeg", jpeg)
            else:
                self.send_response(404)
                self.end_headers()

    httpd = ThreadingHTTPServer((host, port), Handler)
    rt = threading.Thread(target=render_loop, daemon=True)
    rt.start()
    if started is not None:
        started(httpd, stop)
    print(f"serving on http://{host}:{httpd.server_address[1]}/ "
          "(open in a browser; WASD/arrows drive the camera)", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        stop.set()
        httpd.server_close()
        rt.join(timeout=10.0)
    if state["error"] is not None:
        raise RuntimeError("the render thread failed") from state["error"]


def main(argv=None) -> dict:
    """Run the CLI; returns {"loop": the FrameLoop (its ``times``,
    ``engine``, last ``rgb``), "camera": the last frame's camera, "images":
    the ``--keys`` frames, "png_ms": their PNG writing times}."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scene", default=os.path.join(REFERENCE_DIR, "scenes",
                                                    "render.map"))
    ap.add_argument("--asset-dir", default=REFERENCE_ASSETS,
                    help="directory holding the four textures and bg/")
    ap.add_argument("--skybox", default=DEFAULT_SKYBOX,
                    help="cross-layout cubemap relative to the asset dir")
    ap.add_argument("--width", type=int, default=800)
    ap.add_argument("--height", type=int, default=600)
    ap.add_argument("--depth", type=int, default=6)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' runs the CUDA kernels")
    ap.add_argument("--keys", default=None,
                    help="scripted keypresses, one frame per key "
                         "(wasd, space, _=down, 8/2/4/6=arrows)")
    ap.add_argument("--frames-dir", default="out/frames")
    ap.add_argument("--serve", type=int, default=None, metavar="PORT",
                    help="serve a live in-browser MJPEG viewer on PORT "
                         "(the display-surface mode; 0 = ephemeral port)")
    ap.add_argument("--jpeg-quality", type=int, default=85)
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is "
                           "available (pass --device cpu for the plain "
                           "PyTorch version)")
    scene = load_scene(args.scene).to_scene(device)
    assets = load_default_assets(args.asset_dir, args.skybox, device=device)
    cfg = RenderConfig(width=args.width, height=args.height,
                       max_depth=args.depth, chunk_size=0)
    ctl = CameraController()
    loop = FrameLoop(scene, assets, cfg, ctl.camera())
    how = ("scene packed once, camera swapped per frame"
           if loop.packed is not None else "whole-image tracer")
    print(f"engine: {loop.engine} on {device} ({how}; "
          f"{scene.num_triangles:,} triangles)")
    res = {"loop": loop, "camera": ctl.camera(), "images": [], "png_ms": []}

    t0 = time.perf_counter()
    loop.frame(res["camera"])
    print(f"first frame {(time.perf_counter() - t0) * 1e3:.1f} ms")

    if args.serve is not None:
        serve(ctl, lambda: loop.frame(ctl.camera()), cfg.width, cfg.height,
              args.serve, quality=args.jpeg_quality)
        return res

    if args.keys is not None:
        os.makedirs(args.frames_dir, exist_ok=True)
        for i, k in enumerate(args.keys):
            ctl.key(k)
            res["camera"] = ctl.camera()
            img = loop.frame(res["camera"])
            t0 = time.perf_counter()
            write_png(os.path.join(args.frames_dir, f"frame_{i:04d}.png"),
                      img)
            res["png_ms"].append((time.perf_counter() - t0) * 1e3)
            res["images"].append(img)
        n = len(args.keys)
        avg = sum(t["frame"] for t in loop.times[1:]) / max(n, 1)
        print(f"{n} frames, avg {avg:.1f} ms/frame "
              f"({1e3 / max(avg, 1e-9):.1f} fps), wrote {args.frames_dir}/")
        return res

    print("keys: wasd move, space/_ up/down, 8/2/4/6 rotate, q quit")
    os.makedirs("out", exist_ok=True)
    while True:
        try:
            line = input("> ")
        except EOFError:
            break
        if line.strip() == "q":
            break
        for k in line:
            ctl.key(k)
        res["camera"] = ctl.camera()
        img = loop.frame(res["camera"])
        write_png("out/view.png", img)
        print(f"{loop.times[-1]['frame']:.1f} ms -> out/view.png  "
              f"origin={ctl.origin}")
    return res


if __name__ == "__main__":
    main()
