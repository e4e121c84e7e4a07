"""The readings that the limits of ``correct`` are set from.

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,... [--control-seeds 7,8,9]

In one process (one set-up): for each seed ``s`` of ``--seeds``, the
program renders frame 0 of a run of seed ``s`` (``harness.loop.frame_seed``)
through the cell's own driver at the cell's size, and the plain reference
renders the same frame over the run's compared pixels; each line printed is
the numbers of ``harness.compare.readings`` for that seed (the lower
readings: sound runs of the program). Then the control, on each seed of
``--control-seeds``: the reference put in the program's place, computed in
bfloat16 (sphere scenes, whose configuration states float32), or the
program with its own bfloat16 path switched on (``LPT_PACKET_BF16=1``: the
mesh traversal's bf16 boxes, K2h), against the float32 reference (the
upper readings). The last line sums up: the largest program reading and the
smallest control reading of each number. The benchmark's own runs never
run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.harness import compare, loop, registry  # noqa: E402

CONTROL_ENV = "LPT_PACKET_BF16"


def program_frames(job, seeds, device):
    """``{seed: (compared pixels' image f32[P,3], segments)}`` of frame 0 of
    each seed, rendered by the program on this rank (rank 0 keeps them)."""
    import torch
    import torch.distributed as dist

    cell, config = job["cell"], job["config"]
    driver = registry.module("drivers", cell["driver"])
    dev = torch.device(device)
    if dev.type == "cuda" and dist.is_initialized():
        dev = torch.device("cuda", torch.cuda.current_device())
    state = driver.setup(config, cell, job["prepared"], dev)
    driver.frame(state, loop.frame_seed(seeds[0], -1))          # warm-up
    out = {}
    for s in seeds:
        res = driver.frame(state, loop.frame_seed(s, 0))
        pix = compare.pixels(cell, config, s, "cpu")
        out[s] = (res["image"].reshape(-1, 3).cpu()[pix], int(res["segments"]))
    del state
    return out


def _rendered(job, seeds, device, env=None):
    chips = int(job["cell"]["chips"])
    old = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    try:
        if chips > 1:
            from learn_path_tracing_tpu_torch.parallel.launch import launch

            from benchmark.readings import program_frames as job_fn   # pickled by this name

            return launch(chips, job_fn, job, seeds, device, device=device)
        return program_frames(job, seeds, device)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def collect(name, seeds, control_seeds, device="cuda", config=None, emit=print,
            cache=os.path.join(HERE, ".cache")):
    """The program's and the control's readings: ``(program, control)``,
    each ``{seed: numbers}``; the written world goes under ``cache``."""
    import gc

    import torch

    bench = registry.spec()
    cell = registry.cell(name, bench)
    config = config or registry.config(cell["config"])
    scene = registry.module("scenes", config["scene"]).generate(config)
    driver = registry.module("drivers", cell["driver"])
    job = {"cell": cell, "config": config, "prepared": driver.prepare(config, cell, scene, cache)}
    w, h = config["resolution"]
    dev = torch.device(device)
    sphere_scene = config["reference"] == "spheres"

    frames = _rendered(job, seeds, device)
    ctrl_frames = {} if sphere_scene else _rendered(
        job, control_seeds, device, {CONTROL_ENV: "1"})
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    def numbers(s, img, segs, kind):
        """``img``: the compared pixels' radiance, in ``compare.pixels`` order."""
        pix = compare.pixels(cell, config, s, dev)
        full = torch.zeros((w * h, 3))
        full[pix.cpu()] = img
        ref_img, ref_segs = compare.reference_frame(config, cell, scene,
                                                    loop.frame_seed(s, 0), pix)
        got = compare.readings(full, segs, ref_img, ref_segs, pix, w * h)
        emit(json.dumps({"kind": kind, "seed": s, **got}))
        return got

    program = {s: numbers(s, img, segs, "program") for s, (img, segs) in frames.items()}
    control = {}
    for s in control_seeds:
        if sphere_scene:
            pix = compare.pixels(cell, config, s, dev)
            img, segs = compare.reference_frame(config, cell, scene, loop.frame_seed(s, 0), pix,
                                                dtype=torch.bfloat16)
            control[s] = numbers(s, img, segs * (w * h) / pix.numel(), "control")
        else:
            control[s] = numbers(s, *ctrl_frames[s], "control")
    return program, control


def summary(program, control) -> dict:
    keys = ("mean_abs_frac", "pixels_differ", "segments_rel")
    return {"lower": {k: max(r[k] for r in program.values()) for k in keys},
            "upper": {k: min(r[k] for r in control.values()) for k in keys} if control else None,
            "seeds": len(program), "control_seeds": len(control)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated run seeds")
    p.add_argument("--control-seeds", default="", help="comma-separated run seeds")
    args = p.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctrl = [int(s) for s in args.control_seeds.split(",") if s]
    program, control = collect(args.workload, seeds, ctrl)
    print(json.dumps({"summary": summary(program, control)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
