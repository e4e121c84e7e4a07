"""The measured window: a closed loop of whole frames on one rank.

Set-up builds the cell's program state through its driver and renders one
warm-up frame of the cell's own traffic (the first run in a checkout builds
the kernels there). Then frames run one after another, each a render call
at the cell's spp that ends in its image synchronised on the device, until
``seconds`` have passed since the first frame's start; the frame in flight
is finished. Frame ``i`` renders with ``frame_seed(seed, i)``.

One frame of the window, drawn from the seed (a reservoir of one), is kept
for the comparison with the reference. A traced run profiles its first
``trace_frames`` frames (CPU and CUDA activity), each inside a ``frame``
span, and reduces the session (``harness.trace``). On several ranks every
rank runs this loop; rank 0 decides when the window ends.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import random
import time

from . import faults, registry, trace as trace_mod
from .stats import window_done


def frame_seed(seed: int, index: int) -> int:
    """The render seed of frame ``index`` of a run of ``seed``, in [0, 2**31)."""
    digest = hashlib.sha256(f"{int(seed)}:{int(index)}".encode()).digest()
    return int.from_bytes(digest[:4], "little") & 0x7FFFFFFF


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _profiler(device):
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _stop_vote(stop: bool, device) -> bool:
    """Rank 0's decision, on every rank."""
    import torch
    import torch.distributed as dist

    if not dist.is_initialized():
        return stop
    flag = torch.tensor([int(stop)], device=device)
    dist.broadcast(flag, src=0)
    return bool(flag.item())


def run(job: dict) -> dict:
    """One rank's run of ``job`` (``cell``, ``config``, ``prepared``,
    ``seed``, ``seconds``, ``trace``, ``device``, ``t_start``, ``fault``,
    ``trace_path``: where rank 0 writes its Chrome trace). Returns this
    rank's record."""
    import torch
    import torch.distributed as dist

    ranked = dist.is_initialized()
    rank = dist.get_rank() if ranked else 0
    device = torch.device(job["device"])
    if device.type == "cuda" and ranked:
        device = torch.device("cuda", torch.cuda.current_device())
    cell, config, seed = job["cell"], job["config"], job["seed"]
    driver = registry.module("drivers", cell["driver"])
    state = driver.setup(config, cell, job["prepared"], device)
    render = faults.wrap(job.get("fault"), driver.frame)
    w, h = config["resolution"]
    samples = w * h * cell["spp"]

    render(state, frame_seed(seed, -1))        # warm-up: the cell's own traffic
    _sync(device)
    cuda = device.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    n_trace = int(cell.get("trace_frames", 1)) if job["trace"] else 0
    pick = random.Random(f"keep:{int(seed)}")
    frames, checks, pending, kept, prof = [], [], [], None, None

    def check(img):      # (finite, sum): read back after the window
        return torch.isfinite(img).all(), img.to(torch.float64).sum()

    first_wall = None
    i = 0
    while True:
        fs = frame_seed(seed, i)
        if i == 0 and n_trace:
            prof = _profiler(device)
            prof.start()
        span = (torch.profiler.record_function(trace_mod.FRAME_SPAN) if i < n_trace
                else contextlib.nullcontext())
        if i == 0:
            first_wall = time.time()
        t0 = time.perf_counter()
        with span:
            out = render(state, fs)
            _sync(device)
        t1 = time.perf_counter()
        frames.append({"start": t0, "end": t1, "samples": samples,
                       "segments": int(out["segments"]), "stats": out.get("stats", {})})
        if i < n_trace:
            pending.append(out["image"])
            if i + 1 == n_trace:
                prof.stop()
                checks += [check(img) for img in pending]
                pending = []
        else:
            checks.append(check(out["image"]))
        if pick.random() * (i + 1) < 1.0:
            kept = {"index": i, "seed": fs, "image": out["image"],
                    "segments": int(out["segments"])}
        i += 1
        if _stop_vote(i >= n_trace and window_done(frames, job["seconds"]), device):
            break
    _sync(device)
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    rec = {"rank": rank, "frames": frames,
           "checks": [(bool(ok), float(total)) for ok, total in checks],
           "setup_s": first_wall - job["t_start"],
           "memory_peak_bytes": max(setup_peak, window_peak),
           "window_peak_bytes": window_peak, "trace": None}
    if rank == 0:
        kept["image"] = kept["image"].detach().cpu()
        rec["kept"] = kept
    if prof is not None:
        path = job["trace_path"] if rank == 0 else f"{job['trace_path'][:-5]}.rank{rank}.json"
        os.makedirs(os.path.dirname(path), exist_ok=True)
        prof.export_chrome_trace(path)
        rec["trace"] = trace_mod.reduce(*trace_mod.from_chrome_trace(path))
        if rank:
            os.remove(path)
    mine = {"busy_s": rec["trace"]["busy_s"] if rec["trace"] else None,
            "window_s": rec["trace"]["window_s"] if rec["trace"] else None,
            "memory_peak_bytes": rec["memory_peak_bytes"], "window_peak_bytes": window_peak}
    rec["ranks"] = [mine]
    if ranked:
        rec["ranks"] = [None] * dist.get_world_size()
        dist.all_gather_object(rec["ranks"], mine)
    return rec
