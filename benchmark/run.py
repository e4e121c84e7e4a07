"""The path tracer's benchmark: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Set-up builds the cell's program state and
renders one warm-up frame; the window renders whole frames for ``--seconds``
(``harness/loop.py``); then the plain reference renders one frame of the
window, drawn from the seed, and decides ``correct`` (``harness/compare.py``).
The last line of standard output is the result, a JSON object; the numbers
compared, each beside its limit, are the last lines of standard error and
the result's last key. ``--trace 1`` profiles a few frames of the window and
reports the cell's per-layer metrics instead of its end-to-end ones (each
metric read by ``metrics/<name>.py``, where ``<name>`` is the metric's name
up to its first dot), and writes the Chrome trace and the
per-layer record to ``benchmark/.cache/traces/<cell>.json`` and
``<cell>.record.json`` (the newest traced run of the cell).

Exit codes: 0 a result was printed; 2 an unknown cell; 3 no card, or fewer
than the cell needs; 4 the scene's digest is not the configuration's; 5 a
JAX module was loaded.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.harness import compare, guard, loop, registry  # noqa: E402


def _fail(code: int, msg: str) -> int:
    print(f"benchmark: {msg}", file=sys.stderr)
    return code


def execute(cell, config, metrics, seed, seconds, trace, device="cuda", cache=CACHE,
            fault=None):
    """A run of ``cell`` (its entry merged with its traffic) on ``config``,
    reporting ``metrics`` (entries of ``BENCHMARK.json``):
    ``(exit code, result dict or None)``. ``fault`` plants one of
    ``harness.faults.KINDS``; ``cache`` holds the written world and the
    traces."""
    chips = int(cell["chips"])
    scene_mod = registry.module("scenes", config["scene"])
    scene = scene_mod.generate(config)
    found = scene_mod.digest(scene)
    if found != config["digest"]:
        return _fail(4, f"scene digest {found} is not the configuration's "
                        f"{config['digest']}"), None
    driver = registry.module("drivers", cell["driver"])
    prepared = driver.prepare(config, cell, scene, cache)
    job = {"cell": cell, "config": config, "prepared": prepared, "seed": int(seed),
           "seconds": float(seconds), "trace": bool(trace), "device": device,
           "t_start": T_START, "fault": fault,
           "trace_path": os.path.join(cache, "traces", f"{cell['name']}.json")}
    if chips > 1:
        from learn_path_tracing_tpu_torch.parallel.launch import launch

        rec = launch(chips, loop.run, job, device=device)
    else:
        rec = loop.run(job)
    gc.collect()
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        kind = torch.cuda.get_device_name(0)
    else:
        kind = "cpu"
    ranks = rec["ranks"]
    memory_peak = max(r["memory_peak_bytes"] for r in ranks)

    kept = rec["kept"]
    t_ref = time.time()
    pix = compare.pixels(cell, config, seed, dev)
    ref_image, ref_segments = compare.reference_frame(config, cell, scene, kept["seed"], pix)
    print(f"benchmark: {len(rec['frames'])} frames, frame {kept['index']} compared; "
          f"reference {time.time() - t_ref:.1f} s over {pix.numel()} pixels", file=sys.stderr)
    w, h = config["resolution"]
    numbers = compare.readings(kept["image"], kept["segments"], ref_image, ref_segments,
                               pix, w * h)
    numbers.update(compare.frame_checks(rec["frames"], rec["checks"]))
    correct, checks = compare.verdict(numbers, cell["limits"])
    failed = numbers["repeated_frames"] + numbers["nonfinite_frames"] + (0 if correct else 1)

    bad = guard.forbidden_modules()
    if bad:
        return _fail(5, f"JAX modules loaded: {', '.join(bad)}"), None

    frames = rec["frames"]
    record = {"cell": cell, "config": config, "frames": frames, "trace": rec["trace"],
              "ranks": ranks, "setup_s": rec["setup_s"],
              "spheres": int(scene["radius"].shape[0]) if "radius" in scene else None}
    values = {}
    for m in metrics:
        value = registry.reader(m["name"]).read(record)
        if value is not None:
            values[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": bool(correct and failed == 0), "attempted": len(frames),
           "failed": int(failed), "metrics": values,
           "device": {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": kind,
                      "count": chips, "memory_peak_bytes": int(memory_peak)}}
    if trace:
        busy = [r["busy_s"] for r in ranks if r.get("busy_s") is not None]
        window = [r["window_s"] for r in ranks if r.get("window_s") is not None]
        out["device"]["busy_s"] = sum(busy) / len(busy)
        out["device"]["window_s"] = sum(window) / len(window)
        out["breakdown"] = {"device_ops": rec["trace"]["device_ops"],
                            "idle_gaps": rec["trace"]["idle_gaps"]}
        with open(job["trace_path"][:-len(".json")] + ".record.json", "w") as f:
            json.dump({"metrics": values, "trace": rec["trace"], "frames": frames}, f)
    out["checks"] = checks
    return 0, out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # every build and kernel cache of the program stays inside the checkout
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(CACHE, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
    bench = registry.spec()
    try:
        cell = registry.cell(args.workload, bench)
    except KeyError as e:
        return _fail(2, str(e.args[0]))
    why = guard.cards_missing(int(cell["chips"]))
    if why:
        return _fail(3, why)
    code, out = execute(cell, registry.config(cell["config"]),
                        registry.metrics_of(cell, bench, args.trace), args.seed, args.seconds,
                        args.trace)
    if code:
        return code
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
