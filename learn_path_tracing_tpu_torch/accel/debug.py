"""BVH debug tooling: structural tree dump + AABB visual debug render.

Counterpart of ``learn_path_tracing_tpu.accel.debug``:

- the reference prints its tree (node index, depth, leaf object counts)
  after every build (11_bvh.py:276-284, 15_module.py:515-524):
  ``format_tree`` / ``print_tree`` / ``tree_stats``;
- every BVH-era reference script carries a ``test_aabb`` kernel that
  renders the hit mask of one AABB as a visual unit test (11_bvh.py:478-484):
  ``render_aabb_mask``, and its traversal-cost upgrade
  ``render_bvh_heatmap``.

The renders take primary rays through pixel centres
(``camera.generate_rays_for_pixels(model='center')``) on the camera
parameters' device and return numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from ..camera.camera import CameraParams, generate_rays_for_pixels
from ..geometry.aabb import aabb_hit
from .bvh import FlatBVH


def format_tree(bvh: FlatBVH, max_lines: int | None = None) -> str:
    """Indented DFS dump: one line per node with bounds and, for leaves,
    the primitive count — the print_tree analog (11_bvh.py:276-284)."""
    left, right, low, high, data, cut = (np.asarray(a) for a in (
        bvh.left, bvh.right, bvh.low, bvh.high, bvh.data, bvh.cut))
    lines: list[str] = []
    stack = [(0, 0)]
    truncated = False
    while stack:
        if max_lines is not None and len(lines) >= max_lines:
            truncated = True
            break
        node, depth = stack.pop()
        lo = ", ".join(f"{v:.3g}" for v in low[node])
        hi = ", ".join(f"{v:.3g}" for v in high[node])
        if data[node] >= 0:
            leaf = int(data[node])
            desc = f"leaf#{leaf} prims={int(cut[leaf + 1] - cut[leaf])}"
        else:
            desc = f"children=({int(left[node])}, {int(right[node])})"
        lines.append(f"{'  ' * depth}[{node}] aabb=({lo})-({hi}) {desc}")
        if data[node] < 0:
            # push right first so the left child prints first (DFS order)
            stack.append((int(right[node]), depth + 1))
            stack.append((int(left[node]), depth + 1))
    if truncated:
        lines.append(f"... ({data.shape[0]} nodes total)")
    return "\n".join(lines)


def print_tree(bvh: FlatBVH, max_lines: int | None = 64) -> None:
    print(format_tree(bvh, max_lines=max_lines))


def tree_stats(bvh: FlatBVH) -> dict:
    """Aggregate structural stats (node/leaf counts, depth, prim counts)."""
    data, cut, left, right = (np.asarray(a) for a in (bvh.data, bvh.cut, bvh.left, bvh.right))
    depth = np.zeros(data.shape[0], np.int32)
    order = [0]
    for node in order:  # parents precede children in build order
        if data[node] < 0:
            for c in (int(left[node]), int(right[node])):
                depth[c] = depth[node] + 1
                order.append(c)
    leaf_sizes = cut[1:] - cut[:-1]
    return {
        "n_nodes": int(data.shape[0]),
        "n_leaves": int((data >= 0).sum()),
        "max_depth": int(depth.max(initial=0)),
        "max_leaf_prims": int(leaf_sizes.max(initial=0)),
        "mean_leaf_prims": float(leaf_sizes.mean()) if leaf_sizes.size else 0.0,
        "n_prims": int(cut[-1]) if cut.size else 0,
    }


def _center_rays(cam: CameraParams, resolution, seed):
    w, h = resolution
    pixel_ids = torch.arange(w * h, dtype=torch.int64, device=cam.device)
    return generate_rays_for_pixels(cam, resolution, pixel_ids, seed, 0, model="center")


def render_aabb_mask(low, high, cam: CameraParams, resolution, seed: int = 0) -> np.ndarray:
    """``test_aabb`` analog: the primary-ray hit mask ``bool[W, H]`` of one
    AABB (11_bvh.py:478-484)."""
    w, h = resolution
    rays = _center_rays(cam, resolution, seed)
    dev = cam.device
    mask = aabb_hit(torch.as_tensor(low, dtype=torch.float32, device=dev),
                    torch.as_tensor(high, dtype=torch.float32, device=dev), rays.ro, rays.rd)
    return mask.cpu().numpy().reshape(w, h)


def render_bvh_heatmap(bvh: FlatBVH, cam: CameraParams, resolution, seed: int = 0) -> np.ndarray:
    """Per-pixel count ``i32[W, H]`` of BVH nodes whose AABB the primary ray
    enters — a traversal-cost heatmap. A ``[N, M]`` broadcast slab test:
    debug scale only."""
    w, h = resolution
    rays = _center_rays(cam, resolution, seed)
    dev = cam.device
    low = torch.as_tensor(np.asarray(bvh.low, np.float32), device=dev)
    high = torch.as_tensor(np.asarray(bvh.high, np.float32), device=dev)
    mask = aabb_hit(low[None], high[None], rays.ro[:, None, :], rays.rd[:, None, :])
    return mask.sum(dim=1).to(torch.int32).cpu().numpy().reshape(w, h)
