"""Host-side sweep-SAH BVH construction.

Counterpart of ``learn_path_tracing_tpu.accel.bvh``: the numpy builder here
and the native C++ builder of ``accel.native`` give the same arrays byte for
byte (as the JAX package's two builders do):

- per node, per axis: stable argsort of primitive centroids, prefix/suffix
  AABB accumulations, cost = n0*area0 + n1*area1 (half-surface areas),
  minimum over (axis, split);
- split while depth < max_depth and count > max_leaf;
- flattened to a node table ``left/right/low/high/data`` plus CSR leaf
  offsets ``cut`` and a leaf primitive table ``prim`` (primitive indices in
  leaf order). Node order is build order, as in the reference's
  serialized ``.world.npy`` trees.

Everything here stays on the host as numpy arrays: the tables the device
reads are built from it by ``accel.wide.collapse`` and the packers of
``ops.packet_traverse``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class FlatBVH:
    """Flat binary BVH. ``data[i] >= 0`` marks a leaf whose primitives are
    ``prim[cut[data[i]] : cut[data[i]+1]]``."""

    left: np.ndarray    # i32[M]
    right: np.ndarray   # i32[M]
    low: np.ndarray     # f32[M,3]
    high: np.ndarray    # f32[M,3]
    data: np.ndarray    # i32[M]  leaf id or -1
    cut: np.ndarray     # i32[L+1]
    prim: np.ndarray    # i32[P]  primitive indices in leaf order
    max_depth: int
    max_leaf: int

    @property
    def n_nodes(self) -> int:
        return self.left.shape[0]


def _half_area(low, high):
    size = np.maximum(high - low, 0.0)
    return size[..., 0] * size[..., 1] + size[..., 1] * size[..., 2] \
        + size[..., 2] * size[..., 0]


def _split_node(idx, plow, phigh, centroid):
    """SAH sweep over one node's primitive set. Returns
    (left_idx, right_idx, left_aabb, right_aabb)."""
    n = idx.shape[0]
    best = (np.inf, None, None)  # cost, axis, split position
    orders = []
    for axis in range(3):
        order = idx[np.argsort(centroid[idx, axis], kind="stable")]
        orders.append(order)
        lo = plow[order]
        hi = phigh[order]
        # prefix: bounds of order[:i+1]; suffix: bounds of order[i+1:]
        pre_low = np.minimum.accumulate(lo, axis=0)
        pre_high = np.maximum.accumulate(hi, axis=0)
        suf_low = np.minimum.accumulate(lo[::-1], axis=0)[::-1]
        suf_high = np.maximum.accumulate(hi[::-1], axis=0)[::-1]
        counts = np.arange(1, n, dtype=np.float64)
        cost = counts * _half_area(pre_low[:-1], pre_high[:-1]) \
            + (n - counts) * _half_area(suf_low[1:], suf_high[1:])
        i = int(np.argmin(cost))
        if cost[i] < best[0]:
            best = (cost[i], axis, i)
    _, axis, i = best
    order = orders[axis]
    lo = plow[order]
    hi = phigh[order]
    left_aabb = (lo[: i + 1].min(0), hi[: i + 1].max(0))
    right_aabb = (lo[i + 1:].min(0), hi[i + 1:].max(0))
    return order[: i + 1], order[i + 1:], left_aabb, right_aabb


def build_bvh(plow, phigh, centroid=None, max_depth: int = 16,
              max_leaf: int = 4, backend: str = "auto") -> FlatBVH:
    """Build a FlatBVH over primitives with per-primitive AABBs
    ``plow/phigh: f32[N,3]`` (spheres: center∓radius; triangles: vertex
    min/max). ``centroid`` defaults to the AABB center.

    ``backend``: 'native' runs the C++ builder (``accel.native``, built at
    first use; raises ``RuntimeError`` where it cannot be built), 'numpy'
    the numpy one, and 'auto' (the JAX package's rule) the native builder
    where it builds and numpy otherwise. The arrays are the same."""
    if backend not in ("auto", "numpy", "native"):
        raise ValueError(f"unknown BVH builder backend: {backend!r}")
    plow = np.asarray(plow, np.float32)
    phigh = np.asarray(phigh, np.float32)
    if centroid is None:
        centroid = 0.5 * (plow + phigh)
    centroid = np.asarray(centroid, np.float32)
    n = plow.shape[0]
    if n == 0:
        raise ValueError("empty primitive set")

    if backend != "numpy":
        from .native import build_bvh_native

        try:
            left, right, low, high, data, cut, prim = build_bvh_native(
                plow, phigh, centroid, max_depth, max_leaf)
        except RuntimeError:
            if backend == "native":
                raise
        else:
            return FlatBVH(left=left, right=right, low=low, high=high, data=data, cut=cut,
                           prim=prim, max_depth=int(max_depth),
                           max_leaf=int((cut[1:] - cut[:-1]).max(initial=1)))

    nodes = []  # [left, right, low, high, data]
    queue = []  # (depth, idx array), aligned with nodes
    nodes.append([-1, -1, plow.min(0), phigh.max(0), -1])
    queue.append((0, np.arange(n, dtype=np.int64)))
    leaves = []

    i = 0
    while i < len(queue):
        depth, idx = queue[i]
        if depth < max_depth and idx.shape[0] > max_leaf:
            li, ri, laabb, raabb = _split_node(idx, plow, phigh, centroid)
            nodes[i][0] = len(nodes)
            nodes.append([-1, -1, laabb[0], laabb[1], -1])
            queue.append((depth + 1, li))
            nodes[i][1] = len(nodes)
            nodes.append([-1, -1, raabb[0], raabb[1], -1])
            queue.append((depth + 1, ri))
        else:
            nodes[i][4] = len(leaves)
            leaves.append(idx)
        i += 1

    cut = np.zeros(len(leaves) + 1, np.int32)
    for k, leaf in enumerate(leaves):
        cut[k + 1] = cut[k] + leaf.shape[0]
    prim = np.concatenate(leaves).astype(np.int32)

    return FlatBVH(
        left=np.array([x[0] for x in nodes], np.int32),
        right=np.array([x[1] for x in nodes], np.int32),
        low=np.stack([x[2] for x in nodes]).astype(np.float32),
        high=np.stack([x[3] for x in nodes]).astype(np.float32),
        data=np.array([x[4] for x in nodes], np.int32),
        cut=cut,
        prim=prim,
        max_depth=int(max_depth),
        max_leaf=int((cut[1:] - cut[:-1]).max(initial=1)),
    )


def bvh_stats(bvh: FlatBVH) -> dict:
    sizes = bvh.cut[1:] - bvh.cut[:-1]
    return {
        "nodes": int(bvh.data.shape[0]),
        "leaves": int((bvh.data >= 0).sum()),
        "prims": int(bvh.cut[-1]),
        "max_leaf_size": int(sizes.max(initial=0)),
        "mean_leaf_size": float(sizes.mean()) if sizes.size else 0.0,
    }
