"""The cell ``l11_spheres_bvh`` (configuration ``l11_legacy_spheres``): its
frozen scene and camera are the stage's, its parts are found by name, its
reference is the program's frame, a planted fault or the bfloat16 control
comes out not correct, and its two readers (``k3_roofline``,
``wavefront_host_ms_per_frame``) read hand-worked records. CPU, at small
sizes."""

import json

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.harness import compare, guard, loop, peaks, registry
from benchmark.metrics import k3_roofline, wavefront_host_ms_per_frame
from benchmark.reference import integrate
from benchmark.scenes import l11

CELL, CONFIG = "l11_spheres_bvh", "l11_legacy_spheres"


def tiny_config(resolution=(32, 18), grid_size=3, depth=6):
    """The configuration at a CPU test's size, with its own digest."""
    cfg = registry.config(CONFIG)
    cfg.update(resolution=list(resolution), grid_size=grid_size, depth=depth)
    cfg["digest"] = l11.digest(l11.generate(cfg))
    return cfg


def execute(seed, cache, seconds=0.6, trace=0, fault=None, spp=4):
    bench = registry.spec()
    cell = {**registry.cell(CELL, bench), "spp": spp, "trace_frames": 1}
    return run.execute(cell, tiny_config(), registry.metrics_of(cell, bench, trace), seed,
                       seconds, trace, device="cpu", cache=str(cache), fault=fault)


def test_scene_is_the_stages():
    from learn_path_tracing_tpu_torch.stages.l11_bvh import legacy_random_scene

    cfg = registry.config(CONFIG)
    arrays = l11.generate(cfg)
    assert l11.digest(arrays) == cfg["digest"]
    wd = legacy_random_scene(size=cfg["grid_size"], seed=cfg["scene_seed"]).device("cpu")
    n = arrays["radius"].shape[0]
    assert n == 485
    assert np.array_equal(wd.centers.numpy()[:n], arrays["center"])
    assert np.array_equal(wd.radii.numpy()[:n], arrays["radius"])
    for k in ("albedo", "roughness", "metallic", "ior", "transparency", "absorptivity"):
        assert np.array_equal(getattr(wd.materials, k).numpy()[:n], arrays[k]), k


def test_camera_is_orbit_frame_0():
    from learn_path_tracing_tpu_torch.stages.l11_bvh import orbit_camera

    from benchmark.drivers import wavefront

    cfg = registry.config(CONFIG)
    ours = wavefront.camera(cfg).params("cpu")
    stage = orbit_camera(tuple(cfg["resolution"]), 0).params("cpu")
    for field in ("position", "yaw", "pitch", "roll", "fov", "focal_length", "aperture",
                  "fov_scale"):
        assert torch.equal(getattr(ours, field), getattr(stage, field)), field


def test_cell_is_found_and_reports_its_metrics():
    bench = registry.spec()
    cell = registry.cell(CELL, bench)
    assert cell["config"] == CONFIG and cell["chips"] == 1
    assert registry.module("drivers", cell["driver"]).frame
    assert registry.module("reference", registry.config(CONFIG)["reference"]).render
    assert [m["name"] for m in registry.metrics_of(cell, bench, False)] == ["msamples_per_s",
                                                                            "setup_s"]
    layer = [m["name"] for m in registry.metrics_of(cell, bench, True)]
    assert set(layer) == {"passes_per_frame", "launches_per_frame", "device_idle_share",
                          "peak_mem_gib", "host_reads_per_frame", "host_wait_ms_per_frame",
                          "k3_roofline", "wavefront_host_ms_per_frame"}


def test_reference_is_the_drivers_frame(tmp_path):
    cfg = tiny_config()
    cell = dict(registry.cell(CELL, registry.spec()), spp=4)
    scene = l11.generate(cfg)
    drv = registry.module("drivers", cell["driver"])
    state = drv.setup(cfg, cell, drv.prepare(cfg, cell, scene, str(tmp_path)),
                      torch.device("cpu"))
    out = drv.frame(state, 98765)
    pix = compare.pixels({"compare": {"pixels": "all"}}, cfg, 0, "cpu")
    acc, segs = registry.module("reference", cfg["reference"]).render(scene, cfg, 98765, 4,
                                                                        pix)
    assert out["segments"] == int(segs.sum())
    assert torch.equal(out["image"].reshape(-1, 3), integrate.image(acc, 4))
    assert out["stats"]["passes"] > 0


@pytest.mark.parametrize("fault", [None, "stale", "half", "altered"])
def test_fault_is_caught(fault, tmp_path):
    code, out = execute(2 ** 31 + 424242, tmp_path, fault=fault)
    assert code == 0
    assert out["correct"] is (fault is None), out["checks"]
    if fault:
        assert out["failed"] >= 1
    assert guard.forbidden_modules() == []


def test_bf16_control_fails_small():
    """The reference in bfloat16 in the program's place: not correct by the
    cell's limits; the float32 reference reads 0."""
    cfg = tiny_config(resolution=(48, 27))
    cell = registry.cell(CELL, registry.spec())
    scene = l11.generate(cfg)
    w, h = cfg["resolution"]
    for s in (3, 4, 5):
        pix = compare.pixels(cell, cfg, s, "cpu")
        fs = loop.frame_seed(s, 0)
        f32 = compare.reference_frame(config=cfg, cell=dict(cell, spp=4), scene=scene,
                                      frame_seed=fs, pix=pix)
        bf16 = compare.reference_frame(cfg, dict(cell, spp=4), scene, fs, pix,
                                       dtype=torch.bfloat16)
        full = torch.zeros((w * h, 3))
        full[pix] = bf16[0]
        got = compare.readings(full, bf16[1] * (w * h) / pix.numel(), *f32, pix, w * h)
        assert any(got[k] > cell["limits"][k] for k in ("mean_abs_frac", "pixels_differ",
                                                        "segments_rel")), got
        full[pix] = f32[0]
        same = compare.readings(full, f32[1] * (w * h) / pix.numel(), *f32, pix, w * h)
        assert same["mean_abs_frac"] == 0 and same["pixels_differ"] == 0


def test_a_traced_cpu_run_reports_the_wavefront_metrics(tmp_path):
    """The counters and, where the window had an untraced frame, the span
    metrics; K3's roofline needs the card's kernel, so it is absent."""
    code, out = execute(77, tmp_path, seconds=3.0, trace=1)
    assert code == 0 and out["correct"]
    with open(tmp_path / "traces" / f"{CELL}.record.json") as f:
        record = json.load(f)
    untraced = len(record["frames"]) - record["trace"]["frames"]
    got = set(out["metrics"])
    assert {"passes_per_frame", "host_reads_per_frame"} <= got
    spans = {"host_wait_ms_per_frame", "wavefront_host_ms_per_frame"}
    assert (spans & got) == (spans if untraced else set())
    assert "k3_roofline" not in got
    assert out["metrics"]["passes_per_frame"]["value"] > 0


# ------------------------------------------------------ the readers, by hand --

K3_NAME = "void (anonymous namespace)::packet_traverse_kernel<1, false, false>(float const*)"
K2_NAME = "void (anonymous namespace)::packet_traverse_kernel<2, false, false>(float const*)"


def _frame(spans, kernels):
    return {"start": 0.0, "end": 1.0, "segments": 10, "samples": 100,
            "stats": {"passes": 40, "host_reads": 90, "spans": spans, "kernels": kernels}}


def _record(kernels_trace=None, k3=None):
    """Three frames, the first traced, whose K3 ran 0.5 ms over 1e6 lanes, all
    active; the untraced frames' wavefront spans sum to 20 and 40 ms."""
    k3 = k3 if k3 is not None else {"k3": {"launches": 40, "lanes": 1_000_000,
                                           "active_lanes": 1_000_000}}
    frames = [
        _frame({"lpt.wavefront.pass": [40, 0.5], "lpt.sync": [90, 0.1]}, k3),
        _frame({"lpt.wavefront.pass": [40, 0.002], "lpt.wavefront.hit": [40, 0.010],
                "lpt.wavefront.escape": [40, 0.001], "lpt.bsdf.scatter": [40, 0.006],
                "lpt.camera.primary": [4, 0.001], "lpt.sync": [90, 0.5]}, k3),
        _frame({"lpt.wavefront.pass": [40, 0.004], "lpt.wavefront.hit": [40, 0.030],
                "lpt.bsdf.scatter": [40, 0.006], "lpt.sync": [90, 0.5]}, k3)]
    tr = {"frames": 1, "launches": 400, "busy_s": 0.3, "window_s": 0.4,
          "kernels": kernels_trace if kernels_trace is not None else {
              K3_NAME: [40, 5e-4], "sphere_scan_kernel": [3, 1e-3]}}
    return {"trace": tr, "frames": frames, "spheres": 485}


def test_k3_roofline_reads_its_bytes_over_its_time():
    want = 100 * (17e6 + 24e6) / peaks.HBM_BYTES_PER_S / 5e-4
    assert k3_roofline.read(_record()) == pytest.approx(want)
    assert k3_roofline.read(_record()) <= 100.0
    # K2 beside it in the trace: its time is not K3's
    assert k3_roofline.read(_record({K3_NAME: [40, 5e-4], K2_NAME: [9, 9e-3]})) == \
        pytest.approx(want)
    # names without the template argument: K3's only where no K2 lanes were counted
    plain = {"packet_traverse_kernel": [40, 5e-4]}
    assert k3_roofline.read(_record(plain)) == pytest.approx(want)
    both = {"k3": {"launches": 40, "lanes": 1_000_000, "active_lanes": 1_000_000},
            "k2": {"launches": 2, "lanes": 10}}
    assert k3_roofline.read(_record(plain, both)) is None
    # a mangled name shows the leaf kind too
    mangled = {"_Z22packet_traverse_kernelILi1ELb0ELb0EEvPKf": [40, 5e-4]}
    assert k3_roofline.read(_record(mangled, both)) == pytest.approx(want)


def test_wavefront_host_ms_is_the_median_of_the_untraced_frames():
    # 2 + 10 + 1 + 6 + 1 = 20 ms and 4 + 30 + 6 = 40 ms
    assert wavefront_host_ms_per_frame.read(_record()) == pytest.approx(30.0)


@pytest.mark.parametrize("what", ["no trace", "no K3 in the trace", "no K3 lanes",
                                  "no active count", "stats without the tables",
                                  "every frame traced", "other spans only"])
def test_readers_find_nothing_where_their_inputs_are_absent(what):
    rec = _record()
    silent = {k3_roofline}
    if what == "no trace":
        rec["trace"] = None
        silent = {k3_roofline}
    elif what == "no K3 in the trace":
        rec["trace"]["kernels"] = {K2_NAME: [9, 9e-3], "sphere_scan_kernel": [3, 1e-3]}
    elif what == "no K3 lanes":
        for f in rec["frames"]:
            f["stats"]["kernels"] = {}
    elif what == "no active count":         # the counters of a program without it
        for f in rec["frames"]:
            f["stats"]["kernels"] = {"k3": {"launches": 40, "lanes": 1_000_000}}
    elif what == "stats without the tables":
        for f in rec["frames"]:
            f["stats"] = {"passes": 40}
        silent = {k3_roofline, wavefront_host_ms_per_frame}
    elif what == "every frame traced":
        rec["trace"]["frames"] = len(rec["frames"])
        silent = {wavefront_host_ms_per_frame}
    else:                                   # a render of another integrator
        for f in rec["frames"]:
            f["stats"]["spans"] = {"lpt.sync": [3, 0.1], "lpt.bsdf.scatter": [2, 0.1]}
        silent = {wavefront_host_ms_per_frame}
    for reader in (k3_roofline, wavefront_host_ms_per_frame):
        value = reader.read(rec)
        assert (value is None) == (reader in silent), (reader.__name__, value)
