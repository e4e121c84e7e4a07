"""Faults planted under the timed path, for the benchmark's own tests.

Each breaks the program's output the way a wrong optimisation could, and a
run with one must come out not correct:

- ``stale``: the render hands back its first frame's result every time (a
  step that returns its state unchanged);
- ``half``: each frame renders half of its samples and reports their mean;
- ``altered``: the image's colour channels are rotated where it is made;
- ``exchange``: the sharded render skips the gather of the other ranks'
  tiles and the sum of their segment counts (multi-card cells).
"""

from __future__ import annotations

KINDS = ("stale", "half", "altered", "exchange")


def wrap(kind, frame):
    """``frame(state, seed)``, broken as ``kind`` says (None: untouched)."""
    if kind is None:
        return frame
    if kind not in KINDS:
        raise ValueError(f"unknown fault {kind!r}")
    if kind == "exchange":
        _skip_exchange()
        return frame
    first = []

    def broken(state, seed):
        if kind == "stale":
            if not first:
                first.append(frame(state, seed))
            return first[0]
        if kind == "half":
            return frame(dict(state, spp=state["spp"] // 2), seed)
        out = frame(state, seed)
        return dict(out, image=out["image"].roll(1, dims=-1))

    return broken


def _skip_exchange():
    """Replace the sharded render's collectives by a local copy: this rank's
    rows in place, every other tile zero, the rank's own segment count."""
    import torch

    from learn_path_tracing_tpu_torch.parallel import mesh as pm

    def combine(acc, segments, mesh):
        full = torch.zeros((mesh.n_tile * acc.shape[0], *acc.shape[1:]), dtype=acc.dtype,
                           device=acc.device)
        full[mesh.tile * acc.shape[0]:(mesh.tile + 1) * acc.shape[0]] = acc
        return full, int(segments)

    pm.combine = combine
