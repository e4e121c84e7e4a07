"""Benchmark of the PyTorch/CUDA port: the 10_final cover scene (or a legacy
mesh world) on one GPU. The port's counterpart of ``bench.py``.

    python3 bench_torch.py [--engine auto|persistent|mega|hybrid] [--device cuda|cpu]
                           [--scene 10_final|yoimiya] [--world X.world.npy]
                           [--time1024 | --sweep-res | --flagship]

Prints one JSON line a cell:
  {"metric": ..., "value": N, "unit": ..., "frames": [s, ...],
   "segments": N, "card": "<name>, <power limit>"}

- Workload: the reference's stage-10 scene (~490 spheres, mixed BSDFs) at
  1280x720, depth 32 (10_final/__main__.py:50-52), ``--spp`` samples a
  frame; ``--scene yoimiya`` the reference's Yoimiya world
  (``--world``, default the reference's ``.world.npy``) through the legacy
  BSDF.
- ``value``: millions of *live* ray segments traced per second (dead and
  masked lanes do not count), ``segments`` (an exact count, the same in
  every frame) over the median of 3 timed frames; for ``--time1024`` and
  ``--flagship`` the median frame's seconds. ``frames`` holds each timed
  frame's seconds, from CUDA events around the frame (the host clock on
  the CPU). One frame at spp 1 before them builds the kernels and warms
  the launches; world and camera set-up are not timed.
- ``--engine``: 'persistent' the modular path-regeneration engine (K1 for
  the sphere hits), 'mega' the fused bounce kernel (K4, spheres only; the
  metric gains ``_mega``), 'hybrid' the dense-primary integrator (legacy
  scenes: K2, K6a, K6b), 'auto' hybrid for legacy scenes and persistent
  for spheres, as ``bench.py`` chooses.
- ``card``: ``nvidia-smi``'s name and power limit, or ``cpu``.

A missing world file prints its path and exits 2 with no result line. The
JAX package's ``--pool-mult/--pool-div`` are not carried over (the port's
persistent engine sizes its pool itself) and its ``vs_baseline`` (a TPU
target) is not reported.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

DEFAULT_WORLD = "/root/reference/legacy/Yoimiya.world.npy"
SCENE_SEED = 20230328
FRAMES = 3
TIME1024_CHUNK = 512           # the modular engine's spp per call under --time1024
SWEEP = ((1280, 720), (1920, 1080), (2560, 1440), (3840, 2160))
ROW_KEYS = ("metric", "value", "unit", "frames", "segments", "card")


def card(device) -> str:
    """``nvidia-smi``'s name and power limit of the card, or 'cpu'."""
    import torch

    if torch.device(device).type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[torch.device(device).index or 0]


def world_label(scene: str, world: str) -> str:
    """The name a mesh cell's metric carries: 'yoimiya' for the default
    world, else the world file's stem, so a stand-in is never filed as
    Yoimiya."""
    if scene != "yoimiya" or os.path.abspath(world) == DEFAULT_WORLD:
        return scene
    return os.path.basename(world).split(".world.npy")[0]


def metric_name(kind: str, scene: str, world: str, resolution, spp: int, mega: bool) -> str:
    label = world_label(scene, world)
    if kind == "time1024":
        name = f"seconds_to_1024spp_1080p_{label}"
    elif kind == "flagship":
        name = f"seconds_flagship_3000x2000_spp32_{label}"
    else:
        name = ("mrays_per_sec_chip_10final" if scene == "10_final"
                else f"bvh_mrays_per_sec_chip_{label}")
        if kind == "sweep":
            name += f"_{resolution[0]}x{resolution[1]}_spp{spp}"
    return name + ("_mega" if mega else "")


def cell_scene(scene, resolution, device, world, assets):
    """``(world data, camera params, scene kind, bsdf, camera model)``."""
    if scene == "10_final":
        from learn_path_tracing_tpu_torch.models import random_scene, stage10_camera

        return (random_scene(seed=SCENE_SEED).device(device),
                stage10_camera(resolution).params(device), "spheres", "modern", "thinlens")
    import warnings

    from learn_path_tracing_tpu_torch.camera import LegacyCamera
    from learn_path_tracing_tpu_torch.scene.legacy_world import LegacyWorld
    from learn_path_tracing_tpu_torch.stages.legacy_common import make_asset_path_map

    if not os.path.exists(world):
        raise FileNotFoundError(world)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        wd = LegacyWorld().load(world, path_map=make_asset_path_map(assets), device=device)
    cam = LegacyCamera(resolution)
    cam.set_fov(30)
    cam.set_position((0, 8, -30))
    cam.look_at((0, 8, 0))
    # the legacy camera has no lens: 'jitter' is bit for bit its degenerate
    # thin lens without the disk sample
    return wd, cam.params(device), "legacy", "legacy", "jitter"


def run_cell(scene="10_final", engine="auto", resolution=(1280, 720), spp=64, limit=32,
             hit_backend="auto", device="cuda", world=DEFAULT_WORLD, assets=None,
             cap=0, pool_w=0, drain_ratio=2, chunk_spp=0, kind="rate",
             frames=FRAMES) -> dict:
    """Render one cell and return its row: ``ROW_KEYS`` (what the CLI
    prints) plus ``engine`` (the one 'auto' chose), ``calls`` (the hit or
    traversal calls of every render the cell made, warm-up included: what
    the kernels' launch counts must equal), ``stats`` (the last render's
    stats) and ``image`` (the last frame's linear ``f32[W,H,3]``).

    ``kind``: 'rate' (Mrays/s), 'sweep' (Mrays/s, the resolution in the
    name), 'time1024' (seconds for ``spp`` samples, in 512-spp calls under
    the modular engine, one call under the mega engine) or 'flagship'
    (seconds a frame). ``frames``: the timed frames (the CLI times 3).
    Raises ``FileNotFoundError`` for a missing world
    file and ``RuntimeError`` for a CUDA device that is not there."""
    from learn_path_tracing_tpu_torch.integrator.hybrid import render_hybrid
    from learn_path_tracing_tpu_torch.integrator.persistent import render_persistent
    from learn_path_tracing_tpu_torch.stages.common import require_device
    from learn_path_tracing_tpu_torch.utils.benchlib import time_fn

    require_device(device)
    wd, cp, scene_kind, bsdf, cam_model = cell_scene(scene, resolution, device, world, assets)
    if engine == "auto":
        engine = "hybrid" if scene_kind == "legacy" else "persistent"
    calls, stats = [], {}

    def render(seed, n_spp):
        if engine == "hybrid":
            img, segs, st = render_hybrid(
                wd, cp, resolution, spp=n_spp, limit=limit, seed=seed, bsdf=bsdf,
                camera_model=cam_model, scene=scene_kind, chunk_spp=chunk_spp, cap=cap,
                pool_w=pool_w, drain_ratio=drain_ratio, stats=True)
            calls.append(st["n_chunks"] + st["passes"])
        else:
            img, segs, st = render_persistent(
                wd, cp, resolution, spp=n_spp, limit=limit, seed=seed, bsdf=bsdf,
                camera_model=cam_model, scene=scene_kind, hit_backend=hit_backend,
                engine="mega" if engine == "mega" else "modular", stats=True)
            calls.append(st["passes"] if engine == "mega"
                         else st["passes_full"] + sum(st["drain_passes"]))
        stats.update(st)
        return img, segs

    def frame():
        if kind == "time1024" and engine != "mega":
            # separate calls with a seed each (the stages' chunking), as
            # bench.py does; their mean is the frame
            parts = [render(s0, min(TIME1024_CHUNK, spp - s0))
                     for s0 in range(0, spp, TIME1024_CHUNK)]
            return (sum(img for img, _ in parts) / len(parts), sum(s for _, s in parts))
        return render(0, spp)

    render(-1, 1)           # builds the kernels and warms the launches
    seconds, (img, segs) = time_fn(frame, iters=frames, warmup=0, device=device)
    med = statistics.median(seconds)
    rate = kind in ("rate", "sweep")
    return {"metric": metric_name(kind, scene, world, resolution, spp, engine == "mega"),
            "value": segs / med / 1e6 if rate else med,
            "unit": "Mrays/s" if rate else "s",
            "frames": seconds, "segments": int(segs), "card": card(device),
            "engine": engine, "calls": calls, "stats": stats, "image": img}


def sharded_cells(cells, limit=32, device="cuda", world=DEFAULT_WORLD, assets=None):
    """A job for ``parallel.launch`` (every rank runs it): each cell
    ``(scene, engine, resolution, spp, n_spp)`` of ``cells`` through its
    engine's sharded function (``parallel.mesh``; 'persistent', 'wavefront'
    or 'hybrid') over a ``(ranks / n_spp) x n_spp`` mesh of every rank,
    after a warm-up frame at spp ``n_spp``. Then, on each of those meshes,
    the collectives of a sharded frame's int64 accumulator at the first
    cell's resolution, each the median ms of 20 calls (CUDA events on the
    card): the spp axis's ``all_reduce`` of the rank's ``(W·H / n_tile, 3)``
    rows (when ``n_spp > 1``), the tile axis's ``all_gather_into_tensor``
    of them, and an ``all_reduce`` of the whole ``(W·H, 3)`` accumulator
    over every rank.

    Returns ``(frames, collectives)``: ``{"image", "segments", "seconds"}``
    a cell (the frame's wall seconds from a barrier to the assembled image
    on this rank), and ``{"<n_tile>x<n_spp>": {collective: ms}}``."""
    import time

    import torch
    import torch.distributed as dist

    from learn_path_tracing_tpu_torch.parallel import mesh as pm
    from learn_path_tracing_tpu_torch.utils.benchlib import time_fn

    fns = {"persistent": pm.render_persistent_multichip, "wavefront": pm.render_multichip,
           "hybrid": pm.render_hybrid_multichip}
    ranks = dist.get_world_size()
    meshes, scenes, frames = {}, {}, []
    for scene, engine, res, spp, n_spp in cells:
        if n_spp not in meshes:
            meshes[n_spp] = pm.make_mesh(ranks // n_spp, n_spp)
        if (scene, tuple(res)) not in scenes:
            scenes[scene, tuple(res)] = cell_scene(scene, res, device, world, assets)
        wd, cp, kind, bsdf, cam_model = scenes[scene, tuple(res)]
        fn, mesh = fns[engine], meshes[n_spp]
        kw = dict(limit=limit, bsdf=bsdf, camera_model=cam_model, scene=kind)
        fn(wd, cp, res, n_spp, mesh, **kw)          # warm-up (its collectives sync)
        dist.barrier()
        t0 = time.perf_counter()
        img, segs = fn(wd, cp, res, spp, mesh, **kw)
        img = img.cpu()                               # waits for the frame
        frames.append({"image": img, "segments": segs, "seconds": time.perf_counter() - t0})

    def ms(f):
        return 1e3 * statistics.median(time_fn(f, iters=20, warmup=3, device=device)[0])

    w, h = cells[0][2]
    collectives = {}
    for mesh in meshes.values():
        rows = -(-w * h // mesh.n_tile)
        acc = torch.ones((rows, 3), dtype=torch.int64, device=device)
        tiles = torch.empty((rows * mesh.n_tile, 3), dtype=torch.int64, device=device)
        whole = torch.ones((w * h, 3), dtype=torch.int64, device=device)
        times = {}
        if mesh.n_spp > 1:
            times["all_reduce spp"] = ms(lambda: dist.all_reduce(acc, group=mesh.spp_group))
        times["all_gather_into_tensor tile"] = ms(
            lambda: dist.all_gather_into_tensor(tiles, acc, group=mesh.tile_group))
        times["all_reduce all ranks"] = ms(lambda: dist.all_reduce(whole))
        collectives[f"{mesh.n_tile}x{mesh.n_spp}"] = times
    return frames, collectives


def row_line(row) -> str:
    """The JSON line the CLI prints for a ``run_cell`` row."""
    return json.dumps({k: row[k] for k in ROW_KEYS})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--spp", type=int, default=64)
    p.add_argument("--limit", type=int, default=32)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to render (default: the card)")
    p.add_argument("--hit-backend", default="auto", choices=["auto", "cuda", "xla", "bvh"],
                   help="sphere hit backend of the persistent engines")
    p.add_argument("--engine", default="auto", choices=["auto", "persistent", "mega", "hybrid"],
                   help="auto: hybrid for legacy mesh scenes, persistent for spheres")
    p.add_argument("--cap", type=int, default=0,
                   help="hybrid survivor batch width (0 = auto: slab/8)")
    p.add_argument("--pool-w", type=int, default=0,
                   help="hybrid secondary pool width (0 = auto)")
    p.add_argument("--drain-ratio", type=int, default=2,
                   help="hybrid end-of-render cascade narrowing ratio")
    p.add_argument("--chunk-spp", type=int, default=0,
                   help="hybrid primary slab spp (0 = auto)")
    p.add_argument("--scene", default="10_final", choices=["10_final", "yoimiya"],
                   help="10_final: sphere cover scene (headline); yoimiya: the mesh world")
    p.add_argument("--world", default=DEFAULT_WORLD,
                   help="the .world.npy of --scene yoimiya and --flagship")
    p.add_argument("--assets", default=None,
                   help="root the world's './…' texture paths resolve against "
                        "(default: the reference's asset root)")
    p.add_argument("--time1024", action="store_true",
                   help="wall seconds to render 1024 spp at 1080p")
    p.add_argument("--sweep-res", action="store_true",
                   help="one line per resolution (720p/1080p/1440p/4K at --spp)")
    p.add_argument("--flagship", action="store_true",
                   help="the reference's flagship mesh frame: the world at 3000x2000, "
                        "32 spp, depth 32 (15_module.py:36-44); seconds a frame")
    args = p.parse_args(argv)
    if args.time1024 and args.flagship:
        p.error("--time1024 and --flagship are mutually exclusive")
    res, kind = (args.width, args.height), "rate"
    if args.time1024:
        res, args.spp, kind = (1920, 1080), 1024, "time1024"
    if args.flagship:
        args.scene, res, args.spp, kind = "yoimiya", (3000, 2000), 32, "flagship"
    cell = dict(scene=args.scene, engine=args.engine, spp=args.spp, limit=args.limit,
                hit_backend=args.hit_backend, device=args.device, world=args.world,
                assets=args.assets, cap=args.cap, pool_w=args.pool_w,
                drain_ratio=args.drain_ratio, chunk_spp=args.chunk_spp)
    cells = ([dict(cell, resolution=r, kind="sweep") for r in SWEEP] if args.sweep_res
             else [dict(cell, resolution=res, kind=kind)])
    for c in cells:
        try:
            row = run_cell(**c)
        except FileNotFoundError as e:
            print(f"bench_torch: world file missing: {e.filename or e}", file=sys.stderr)
            return 2
        print(row_line(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
