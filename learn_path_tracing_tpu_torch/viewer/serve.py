"""Live progressive viewer over HTTP (counterpart of
``learn_path_tracing_tpu.viewer.serve``; the reference's free-fly loop,
legacy/PT_in_one_weekend/12_free_view.py:557-579 and the mouse-look variant
14_mesh.py:1029-1062).

A render host has no window, so the interactive surface is a small stdlib
HTTP server: the render loop runs in the main thread (progressive
accumulation, restart on movement), a browser page polls ``/frame.png`` and
posts WASD and mouse-look input to ``/input``.

    python -m learn_path_tracing_tpu_torch.viewer.serve --scene spheres
    python -m learn_path_tracing_tpu_torch.viewer.serve --scene path/to/x.world.npy --port 8413
    # then open http://localhost:8413/

The render runs on the card unless ``--device cpu`` is given. ``--scene``
takes 'spheres' (the legacy cover scene, ``--scene-size`` its grid
half-extent), the name of a reference world (``<name>.world.npy`` beside
the reference's asset tree; a missing one exits 2 naming the file) or the
path of a ``.world.npy``, whose './textures/…' paths resolve against its
own directory. A texture or environment that does not load falls back to
the neutral fill or the sky gradient, and each fallback is printed.

Controls (12_free_view.py:559-574): W/A/S/D move, Space up, Shift down,
mouse drag to look (pitch clamped, 14_mesh.py:413-418). Each frame's
headers: ``X-Gen`` (frames published), ``X-Spp`` (samples in the frame) and
``X-Pass-Ms`` (the frame's render and encode time).
"""

from __future__ import annotations

import argparse
import io
import json
import os
import queue
import sys
import threading
import time
import warnings
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_PAGE = """<!doctype html>
<html><head><title>learn_path_tracing_tpu_torch viewer</title><style>
 body { background:#111; color:#ccc; font-family:monospace; text-align:center }
 canvas { image-rendering:pixelated; margin-top:12px; cursor:crosshair }
 #hud { margin-top:8px }
</style></head><body>
<canvas id="c"></canvas>
<div id="hud">connecting…</div>
<div>W/A/S/D move · Space up · Shift down · drag to look</div>
<script>
const cv = document.getElementById('c'), hud = document.getElementById('hud');
const ctx = cv.getContext('2d');
let dragging = false, px = 0, py = 0, gen = -1;
function send(ev) { fetch('/input', {method:'POST', body: JSON.stringify(ev)}); }
window.addEventListener('keydown', e => {
  const k = e.key.toLowerCase();
  if ('wasd '.includes(k)) { send({move: k === ' ' ? 'space' : k}); e.preventDefault(); }
  if (k === 'shift') send({move: 'shift'});
});
cv.addEventListener('mousedown', e => { dragging = true; px = e.clientX; py = e.clientY; });
window.addEventListener('mouseup', () => dragging = false);
window.addEventListener('mousemove', e => {
  if (!dragging) return;
  send({rotate: [(e.clientX - px) * 0.25, (py - e.clientY) * 0.25]});
  px = e.clientX; py = e.clientY;
});
async function tick() {
  try {
    const r = await fetch('/frame.png?g=' + gen, {cache: 'no-store'});
    gen = parseInt(r.headers.get('X-Gen'));
    hud.textContent = 'spp ' + r.headers.get('X-Spp') + ' · pass ' +
      r.headers.get('X-Pass-Ms') + ' ms';
    const blob = await r.blob();
    const img = await createImageBitmap(blob);
    cv.width = img.width; cv.height = img.height;
    ctx.drawImage(img, 0, 0);
  } catch (e) { hud.textContent = 'disconnected'; }
  setTimeout(tick, 100);
}
tick();
</script></body></html>"""


class ViewerState:
    """Shared between the HTTP threads and the render loop."""

    def __init__(self):
        self.inputs: queue.Queue = queue.Queue()
        self.lock = threading.Lock()
        self.png: bytes = b""
        self.gen = 0
        self.spp = 0
        self.pass_ms = 0.0

    def publish(self, png: bytes, spp: int, pass_ms: float):
        with self.lock:
            self.png = png
            self.gen += 1
            self.spp = spp
            self.pass_ms = pass_ms

    def snapshot(self):
        with self.lock:
            return self.png, self.gen, self.spp, self.pass_ms


def _make_handler(state: ViewerState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            if self.path.startswith("/frame.png"):
                png, gen, spp, ms = state.snapshot()
                if not png:
                    self.send_response(503)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", "image/png")
                self.send_header("X-Gen", str(gen))
                self.send_header("X-Spp", str(spp))
                self.send_header("X-Pass-Ms", f"{ms:.0f}")
                self.send_header("Content-Length", str(len(png)))
                self.end_headers()
                self.wfile.write(png)
            else:
                body = _PAGE.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        def do_POST(self):
            if self.path != "/input":
                self.send_response(404)
                self.end_headers()
                return
            length = int(self.headers.get("Content-Length", 0))
            try:
                ev = json.loads(self.rfile.read(length) or b"{}")
                state.inputs.put(ev)
            except json.JSONDecodeError:
                pass
            self.send_response(204)
            self.end_headers()

    return Handler


def _apply_inputs(camera, inputs: queue.Queue, velocity: float) -> bool:
    """Drain queued input events onto the camera; True if it moved
    (12_free_view.py:559-574 key map)."""
    moved = False
    while True:
        try:
            ev = inputs.get_nowait()
        except queue.Empty:
            return moved
        mv = ev.get("move")
        if mv == "w":
            camera.move_front(velocity)
        elif mv == "s":
            camera.move_front(-velocity)
        elif mv == "a":
            camera.move_right(-velocity)
        elif mv == "d":
            camera.move_right(velocity)
        elif mv == "space":
            camera.move_up(velocity)
        elif mv == "shift":
            camera.move_up(-velocity)
        rot = ev.get("rotate")
        if rot:
            camera.rotate(float(rot[0]), float(rot[1]))
        moved = True


def _encode_png(frame) -> bytes:
    """A display frame ``f32[W,H,3]`` (tensor or array, any device) as PNG
    bytes."""
    from PIL import Image

    from ..core.image import to_raster

    buf = io.BytesIO()
    Image.fromarray(to_raster(frame)).save(buf, format="PNG")
    return buf.getvalue()


def build_scene(name: str, res, asset_root=None, size: int = 11, device="cuda"):
    """Returns ``(world_data, camera, bsdf, scene_kind, hit_backend,
    load_warnings)`` on ``device``.

    ``size``: grid half-extent of the 'spheres' scene (11: the reference's
    ~490 spheres, 10_final/__main__.py:12-45; tests pass 1). A mesh world's
    texture paths resolve against ``asset_root``: by default the reference's
    asset tree for a named world and the file's directory for a path.
    ``load_warnings`` lists the loader's fallbacks (missing textures or
    environment). Raises ``FileNotFoundError`` for a missing world file."""
    from ..camera import LegacyCamera

    if name == "spheres":
        from ..stages.l11_bvh import legacy_random_scene

        # hit_backend 'auto': the sphere scan (K1) on the card
        wd = legacy_random_scene(size=size).device(device)
        cam = LegacyCamera(res)
        cam.set_fov(20)
        cam.set_position((13, 2, 3))
        cam.look_at((0, 0, 0))
        return wd, cam, "legacy", "spheres", "auto", []

    from ..scene.legacy_world import LegacyWorld
    from ..stages.legacy_common import DEFAULT_ASSET_ROOT, make_asset_path_map

    # a path as given, else the reference's world of that name, beside its assets
    path = name if name.endswith(".npy") else os.path.join(
        os.path.dirname(DEFAULT_ASSET_ROOT), "legacy", f"{name}.world.npy")
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if asset_root is None and name.endswith(".npy"):
        asset_root = os.path.dirname(os.path.abspath(path))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        wd = LegacyWorld().load(path, path_map=make_asset_path_map(asset_root), device=device)
    cam = LegacyCamera(res)
    cam.set_fov(30)
    if os.path.basename(path).startswith("demo"):
        cam.set_position((0, 2, 8))
        cam.look_at((0, 0, 0))
    else:
        cam.set_position((0, 8, -30))
        cam.look_at((0, 8, 0))
    return wd, cam, "legacy", "legacy", "auto", [str(w.message) for w in caught]


def parse_args(argv=None):
    """The viewer's flags; raises (``stages.common.require_device``) if the
    device cannot run here."""
    from ..stages.common import require_device

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--scene", type=str, default="spheres",
                   help="'spheres' | world name (demo/Yoimiya/...) | path to a .world.npy")
    p.add_argument("--scene-size", type=int, default=11,
                   help="sphere-scene grid half-extent (11 = the reference "
                        "cover scene; tests use 1 for a tiny world)")
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=360)
    p.add_argument("--spp", type=int, default=16, help="samples per frame")
    p.add_argument("--limit", type=int, default=10)
    p.add_argument("--port", type=int, default=8413, help="0: any free port (printed)")
    p.add_argument("--host", type=str, default="127.0.0.1",
                   help="bind address; the server is unauthenticated, so "
                        "pass 0.0.0.0 only to deliberately expose it")
    p.add_argument("--velocity", type=float, default=1.0)
    p.add_argument("--preview-spp", type=int, default=-1,
                   help="motion-preview samples per frame (0 disables; "
                        "-1 auto: 4 for mesh scenes, off for the sphere scene)")
    p.add_argument("--preview-limit", type=int, default=2,
                   help="motion-preview bounce limit (2 = first hit + env)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to render on (default: cuda; the CPU "
                        "only when asked for with --device cpu)")
    p.add_argument("--max-frames", type=int, default=0,
                   help="stop after N frames (0 = run until interrupted)")
    p.add_argument("--frame-interval", type=float, default=0.0,
                   help="minimum seconds between published frames")
    args = p.parse_args(argv)
    require_device(args.device)
    return args


def setup(args):
    """``(ProgressiveRenderer, camera, load_warnings)`` of parsed ``args``;
    raises ``FileNotFoundError`` for a missing world file."""
    from .progressive import ProgressiveRenderer

    res = (args.width, args.height)
    wd, cam, bsdf, scene_kind, hit_backend, load_warnings = build_scene(
        args.scene, res, size=args.scene_size, device=args.device)
    preview_spp = args.preview_spp
    if preview_spp < 0:
        # auto: mesh worlds take the cheap motion path; the sphere scene
        # free-flies at full spp
        preview_spp = 4 if args.scene != "spheres" else 0
    pr = ProgressiveRenderer(wd, cam, res, spp_per_frame=args.spp, limit=args.limit,
                             bsdf=bsdf, scene=scene_kind, hit_backend=hit_backend,
                             preview_spp=preview_spp, preview_limit=args.preview_limit)
    return pr, cam, load_warnings


def serve(pr, camera, server, state: ViewerState, max_frames: int = 0,
          velocity: float = 1.0, frame_interval: float = 0.0, on_frame=None) -> int:
    """The render loop over a bound ``server`` (made with
    ``_make_handler(state)``): serves it from a thread, renders and
    publishes frames (restarting accumulation when queued input moved
    ``camera``) until ``max_frames`` (0: until interrupted), then shuts the
    server down. ``on_frame(frames)``, when given, runs after each publish,
    before the input is read. Returns the frames published."""
    threading.Thread(target=server.serve_forever, daemon=True).start()
    frames = 0
    moved = True
    try:
        while True:
            t0 = time.perf_counter()
            frame = pr.render(moved=moved)
            png = _encode_png(frame)   # reads the frame back: the pass has ended
            state.publish(png, pr.spp, (time.perf_counter() - t0) * 1e3)
            frames += 1
            if on_frame is not None:
                on_frame(frames)
            if max_frames and frames >= max_frames:
                break
            if frame_interval:
                dt = frame_interval - (time.perf_counter() - t0)
                if dt > 0:
                    time.sleep(dt)
            moved = _apply_inputs(camera, state.inputs, velocity)
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        server.server_close()
    return frames


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        pr, cam, load_warnings = setup(args)
    except FileNotFoundError as e:
        print(f"viewer: world file missing: {e.filename or e}", file=sys.stderr)
        return 2
    for msg in load_warnings:
        print(f"viewer: asset fallback: {msg}", file=sys.stderr)
    state = ViewerState()
    server = ThreadingHTTPServer((args.host, args.port), _make_handler(state))
    print(f"viewer: http://localhost:{server.server_address[1]}/  (scene={args.scene}, "
          f"device={args.device})", flush=True)
    serve(pr, cam, server, state, max_frames=args.max_frames, velocity=args.velocity,
          frame_interval=args.frame_interval)
    return 0


if __name__ == "__main__":
    sys.exit(main())
