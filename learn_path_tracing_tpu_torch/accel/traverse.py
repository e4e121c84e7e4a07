"""Lockstep BVH walk with a caller-supplied leaf test (plain PyTorch).

Counterpart of ``learn_path_tracing_tpu.accel.traverse``: the whole ray
batch steps in lockstep, every live ray advancing its own stack entry each
step; rays that finish idle until the last one is done. States live in
``[N, depth+1]`` tensors on the rays' device; node fetches are gathers from
the flat node table. The loop ends when no ray is live (one host read a
step) or at the JAX package's iteration backstop.

Traversal order and hit semantics are the JAX package's (unordered child
push, epsilon-relaxed slab test, strict nearest ``t`` with the first hit
found taken on a tie), so results are interchangeable with a brute-force
scan. ``accel.wide.traverse_wide`` is the same walk over a ``WideBVH``.

These walks are an API and an oracle, not a hit path: ``scene.world.hit``
and the legacy hit reach the traversal kernels of ``ops.packet_traverse``.
The leaf tests here are the plain geometry of ``geometry.sphere`` and
``geometry.triangle``, and share no table or arithmetic with those kernels,
so a walk checks them independently.
"""

from __future__ import annotations

import torch

from ..geometry.sphere import T_MIN, sphere_t
from ..geometry.triangle import triangle_t
from .bvh import FlatBVH


def stack_read(stack, col):
    """Per-lane stack read: ``stack[i, col[i]]``."""
    return torch.gather(stack, 1, col.to(torch.int64)[:, None])[:, 0]


def stack_write(stack, col, value, mask):
    """Per-lane stack write: a copy of ``stack`` with ``stack[i, col[i]] =
    value[i]`` where ``mask[i]``. (The JAX package writes it as a one-hot
    select because XLA's scatter is serial on the TPU; a scatter of the
    lanes' own or new value gives the same result.)"""
    idx = col.to(torch.int64)[:, None]
    new = torch.where(mask[:, None], value.to(stack.dtype)[:, None],
                      torch.gather(stack, 1, idx))
    return stack.scatter(1, idx, new)


def _t_init(t_init, n, device):
    if t_init is None:
        return torch.full((n,), float("inf"), dtype=torch.float32, device=device)
    return torch.as_tensor(t_init, dtype=torch.float32, device=device).clone()


def traverse(bvh: FlatBVH, ro, rd, leaf_test, eps: float = T_MIN,
             t_init=None, *, stats: bool = False):
    """Nearest-hit traversal of a binary ``FlatBVH``.

    ``leaf_test(prim_idx i32[N], valid bool[N], ro, rd) -> t f32[N]`` must
    return +inf for invalid or missed lanes and respect the epsilon cut.
    ``t_init`` (optional ``f32[N]``) seeds the best ``t`` for
    cross-structure pruning; a hit that is only pruned keeps ``prim = -1``.

    Returns ``(t f32[N] (+inf: miss), prim i32[N] (-1: miss))``, and the
    number of lockstep steps as a third element when ``stats``.
    """
    n, dev = ro.shape[0], ro.device
    depth_cap = bvh.max_depth + 2
    max_leaf = bvh.max_leaf
    n_prim = bvh.prim.shape[0]
    left, right, low, high, data, cut, prim = (
        torch.as_tensor(getattr(bvh, k), device=dev)
        for k in ("left", "right", "low", "high", "data", "cut", "prim"))
    # the JAX package's backstop: a lockstep walk visits every node at most
    # once a lane (2 * nodes stack events)
    max_iters = 4 * bvh.n_nodes + 64
    inv = 1.0 / rd

    stack = torch.zeros((n, depth_cap), dtype=torch.int32, device=dev)
    sp = torch.zeros((n,), dtype=torch.int32, device=dev)
    t_best = _t_init(t_init, n, dev)
    prim_best = torch.full((n,), -1, dtype=torch.int32, device=dev)
    steps = 0
    while steps < max_iters and bool((sp >= 0).any()):
        steps += 1
        active = sp >= 0
        slot = torch.clamp(sp, 0, depth_cap - 1)
        cur = stack_read(stack, slot).to(torch.int64)

        ti = (low[cur] - ro) * inv
        to = (high[cur] - ro) * inv
        t1 = torch.amin(torch.maximum(ti, to), dim=-1)
        t0 = torch.amax(torch.minimum(ti, to), dim=-1)
        # slab test + t-pruning: skip boxes whose entry distance can no
        # longer beat the best hit
        hitbox = (t1 > t0 - eps) & (t1 > 0.0) & (t0 < t_best + eps) & active

        leaf = data[cur]
        is_leaf = (leaf >= 0) & hitbox
        leaf_id = torch.clamp_min(leaf, 0).to(torch.int64)
        start = cut[leaf_id]
        count = cut[leaf_id + 1] - start
        for k in range(max_leaf):
            pidx = prim[torch.clamp(start + k, 0, max(n_prim - 1, 0)).to(torch.int64)]
            valid = is_leaf & (k < count)
            t = leaf_test(pidx, valid, ro, rd)
            better = valid & (t < t_best)
            t_best = torch.where(better, t, t_best)
            prim_best = torch.where(better, pidx, prim_best)

        # on an inner-node hit overwrite the current slot with `left` and
        # push `right`; otherwise pop
        push = hitbox & ~is_leaf
        stack = stack_write(stack, slot, left[cur], push)
        sp = torch.where(push, sp + 1, torch.where(active, sp - 1, sp))
        stack = stack_write(stack, torch.clamp(sp, 0, depth_cap - 1), right[cur], push)
    if stats:
        return t_best, prim_best, steps
    return t_best, prim_best


def make_sphere_leaf_test(centers, radii, transparency, eps: float = T_MIN):
    """Leaf test over a sphere table (``geometry.sphere.sphere_t``, one
    primitive a lane): the near root, or the far root of a transparent
    sphere whose near root is below ``eps``."""

    def leaf_test(pidx, valid, ro, rd):
        i = pidx.to(torch.int64)
        t = sphere_t(centers[i], radii[i], transparency[i], ro, rd, eps=eps)
        return torch.where(valid, t, float("inf"))

    return leaf_test


def make_triangle_leaf_test(v0, v1, v2, eps: float = T_MIN):
    """Leaf test over a triangle vertex-position table ``v0/v1/v2 f32[T,3]``
    (``geometry.triangle.triangle_t``)."""

    def leaf_test(pidx, valid, ro, rd):
        i = pidx.to(torch.int64)
        t = triangle_t(v0[i], v1[i], v2[i], ro, rd, eps=eps)
        return torch.where(valid, t, float("inf"))

    return leaf_test
