"""The port's HTTP viewer (``viewer.serve``) on the CPU: loopback cases
mirroring the JAX package's ``tests/test_viewer.py``, the render loop driven
in-process, and one subprocess run of the module.

Tolerances: the camera after the same input events equals the JAX
package's within 1e-6 (position, yaw, pitch: both are float64 host math);
the sphere scene's arrays equal JAX's exactly; a PNG of the same frame is
the same bytes.
"""

import json
import os
import queue
import select
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from learn_path_tracing_tpu.camera import LegacyCamera as JLegacyCamera
from learn_path_tracing_tpu.viewer import serve as jserve
from learn_path_tracing_tpu_torch.camera import LegacyCamera
from learn_path_tracing_tpu_torch.viewer import serve
from learn_path_tracing_tpu_torch.viewer.serve import (ViewerState, _apply_inputs, _encode_png,
                                                       _make_handler)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def server():
    state = ViewerState()
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _make_handler(state))
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield state, f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()


def _get(url):
    try:
        r = urllib.request.urlopen(url, timeout=10)
        return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), b""


def _post(url, body: bytes):
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        return urllib.request.urlopen(req, timeout=10).status
    except urllib.error.HTTPError as e:
        return e.code


def test_page_and_frame_lifecycle(server):
    state, base = server
    status, _, body = _get(base + "/")
    assert status == 200 and b"learn_path_tracing_tpu_torch viewer" in body
    status, _, _ = _get(base + "/frame.png")          # nothing published yet
    assert status == 503
    png = _encode_png(np.full((8, 4, 3), 0.5, np.float32))
    state.publish(png, spp=16, pass_ms=12.0)
    status, headers, body = _get(base + "/frame.png")
    assert status == 200 and headers["X-Gen"] == "1" and headers["X-Spp"] == "16"
    assert headers["X-Pass-Ms"] == "12" and body == png and body[:4] == b"\x89PNG"
    state.publish(png, spp=16, pass_ms=10.0)
    assert _get(base + "/frame.png")[1]["X-Gen"] == "2"


def test_input_post_enqueues(server):
    state, base = server
    assert _post(base + "/input", json.dumps({"move": "w"}).encode()) == 204
    assert state.inputs.get_nowait() == {"move": "w"}
    assert _post(base + "/input", b"{oops") == 204     # malformed JSON is dropped
    assert state.inputs.empty()
    assert _post(base + "/nope", b"{}") == 404


EVENTS = ({"move": "w"}, {"move": "d"}, {"move": "space"}, {"rotate": [10.0, 5.0]},
          {"move": "a"}, {"move": "s"}, {"move": "shift"}, {"rotate": [-400.0, 120.0]},
          {"move": "w", "rotate": [3.5, -2.25]}, {"other": 1})


def test_apply_inputs_moves_the_camera_as_jax():
    cams = []
    for cls, apply in ((LegacyCamera, _apply_inputs), (JLegacyCamera, jserve._apply_inputs)):
        cam = cls((8, 4))
        cam.set_position((0.0, 0.0, 5.0))
        cam.look_at((0.0, 0.0, 0.0))
        q = queue.Queue()
        assert apply(cam, q, velocity=1.0) is False       # empty queue
        for ev in EVENTS:
            q.put(ev)
        assert apply(cam, q, velocity=0.75) is True and q.empty()
        cams.append(cam)
    port, jax_cam = cams
    np.testing.assert_allclose(port.position, jax_cam.position, rtol=0, atol=1e-6)
    np.testing.assert_allclose([port.yaw, port.pitch], [jax_cam.yaw, jax_cam.pitch],
                               rtol=0, atol=1e-6)
    assert port.pitch == 89.0 - 2.25                      # clamped at 89, then -2.25


def test_encode_png_is_jax_bytes():
    frame = np.random.default_rng(3).uniform(-0.1, 1.1, size=(12, 7, 3)).astype(np.float32)
    assert _encode_png(torch.from_numpy(frame)) == jserve._encode_png(frame)


def test_build_scene_spheres_matches_jax():
    wd, cam, bsdf, kind, backend, warns = serve.build_scene("spheres", (32, 18), size=1,
                                                            device="cpu")
    jwd, jcam, jbsdf, jkind, jbackend = jserve.build_scene("spheres", (32, 18), size=1)
    assert (bsdf, kind, backend, warns) == (jbsdf, jkind, jbackend, [])
    np.testing.assert_array_equal(wd.centers.numpy(), np.asarray(jwd.centers))
    np.testing.assert_array_equal(wd.radii.numpy(), np.asarray(jwd.radii))
    for f in ("albedo", "roughness", "metallic", "ior", "transparency", "absorptivity"):
        np.testing.assert_array_equal(getattr(wd.materials, f).numpy(),
                                      np.asarray(getattr(jwd.materials, f)))
    assert cam.position == jcam.position and (cam.yaw, cam.pitch) == (jcam.yaw, jcam.pitch)


def test_missing_named_world_exits_2(capsys):
    assert serve.main(["--device", "cpu", "--scene", "absent_world_x"]) == 2
    assert "absent_world_x.world.npy" in capsys.readouterr().err


def test_world_file_loads_and_reports_fallbacks(tmp_path):
    world = chip_smoke.standin_world(str(tmp_path), level=1, tex_size=16, env_size=(32, 16))
    world.build()
    path = str(tmp_path / "standin.world.npy")
    world.save(path)
    _, _, _, kind, _, warns = serve.build_scene(path, (16, 8), device="cpu")
    assert kind == "legacy" and warns == []
    os.remove(tmp_path / "standin_albedo.png")
    *_, warns = serve.build_scene(path, (16, 8), device="cpu")
    assert any("texture missing" in w for w in warns), warns


def test_render_loop_in_process():
    """The loop over a server on an ephemeral port: frames accumulate
    (``X-Spp`` rises), a posted move restarts the next frame at the full
    spp, and ``X-Gen`` counts the frames."""
    args = serve.parse_args(["--device", "cpu", "--scene-size", "1", "--width", "16",
                             "--height", "8", "--spp", "2", "--limit", "3"])
    pr, cam, _ = serve.setup(args)
    state = ViewerState()
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _make_handler(state))
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    seen = []

    def on_frame(frames):
        status, headers, body = _get(base + "/frame.png")
        seen.append((status, int(headers["X-Gen"]), int(headers["X-Spp"]), body[:4]))
        if frames == 2:
            assert _post(base + "/input", b'{"move": "w"}') == 204
        if frames == 1:
            assert _get(base + "/")[0] == 200

    p0 = cam.position
    assert serve.serve(pr, cam, srv, state, max_frames=4, on_frame=on_frame) == 4
    assert seen == [(200, 1, 2, b"\x89PNG"), (200, 2, 4, b"\x89PNG"),
                    (200, 3, 2, b"\x89PNG"), (200, 4, 4, b"\x89PNG")]
    assert cam.position != p0


def test_viewer_subprocess_serves_a_png():
    proc = subprocess.Popen(
        [sys.executable, "-m", "learn_path_tracing_tpu_torch.viewer.serve", "--device", "cpu",
         "--scene-size", "1", "--width", "32", "--height", "18", "--max-frames", "3",
         "--frame-interval", "1.0", "--port", "0"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        ready, _, _ = select.select([proc.stdout], [], [], 60)
        assert ready, "the viewer printed no address"
        line = proc.stdout.readline()
        assert line.startswith("viewer: http://localhost:"), line
        base = "http://127.0.0.1:" + line.split("localhost:")[1].split("/")[0]
        deadline = time.time() + 60
        while time.time() < deadline:
            status, headers, body = _get(base + "/frame.png")
            if status == 200:
                break
            time.sleep(0.1)
        assert status == 200 and body[:4] == b"\x89PNG" and int(headers["X-Gen"]) >= 1
        assert proc.wait(timeout=60) == 0
    finally:
        proc.kill()
        proc.wait()
