"""Wide (8-ary) BVH: collapse of a binary ``FlatBVH`` (numpy, host side).

Counterpart of ``learn_path_tracing_tpu.accel.wide``'s ``collapse``: a
binary BVH is collapsed by repeatedly expanding the largest-area frontier
entry until each wide node has up to 8 children; children are either inner
wide nodes or leaf runs (contiguous prim ranges in the shared ``prim`` list,
capped at ``max_run`` prims). A node whose content exceeds 8 slots chains
into continuation nodes through its last slot.

Slot entries: a wide-node index (``>= 0``), a leaf run
``-(start * 64 + count + 1)``, or ``_PAD``. The packers of
``ops.packet_traverse`` turn this layout into the traversal kernel's tables.
``traverse_wide`` is the JAX package's lockstep walk over this layout with
a caller-supplied leaf test (``accel.traverse``'s contract), in plain
PyTorch on the rays' device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..geometry.aabb import EPSILON
from .bvh import FlatBVH

WIDTH = 8
# Leaf-run length cap (the encoding allows up to 63; one packed run row
# holds 8 primitives).
DEFAULT_MAX_RUN = 8
_ENC = 64  # run-length field width in the encoding

_PAD = np.int32(-(2 ** 30))


def _encode_leaf(start: int, count: int) -> int:
    return -(start * _ENC + count + 1)


def decode_leaf(code):
    """Leaf code(s) (``< 0``, ``!= _PAD``) → ``(start, count)``."""
    v = -(code + 1)
    return v // _ENC, v % _ENC


@dataclass(frozen=True)
class WideBVH:
    child_low: np.ndarray    # f32[M, 8, 3]
    child_high: np.ndarray   # f32[M, 8, 3]
    child_entry: np.ndarray  # i32[M, 8] — node idx >=0 | leaf-run code | PAD
    prim: np.ndarray         # i32[P] leaf-ordered primitive indices
    depth: int               # max wide-tree depth (stack sizing)
    max_leaf: int            # longest leaf run (<= 63)


def collapse(flat: FlatBVH, max_run: int = DEFAULT_MAX_RUN) -> WideBVH:
    if not 1 <= max_run < _ENC:
        raise ValueError(f"max_run={max_run} must be in [1, {_ENC})")
    left, right, low, high = flat.left, flat.right, flat.low, flat.high
    data, cut = flat.data, flat.cut

    def area(i):
        s = np.maximum(high[i] - low[i], 0)
        return float(s[0] * s[1] + s[1] * s[2] + s[2] * s[0])

    def slots_needed(e: int) -> int:
        if data[e] < 0:
            return 1
        prims = int(cut[data[e] + 1] - cut[data[e]])
        return max(1, -(-prims // max_run))

    def frontier(b: int) -> list[int]:
        if data[b] >= 0:
            entries = [b]
        else:
            entries = [int(left[b]), int(right[b])]
        while True:
            total = sum(slots_needed(e) for e in entries)
            expandable = [
                e for e in entries if data[e] < 0 and
                total - 1 + slots_needed(int(left[e]))
                + slots_needed(int(right[e])) <= WIDTH
            ]
            if not expandable:
                return entries
            pick = max(expandable, key=area)
            k = entries.index(pick)
            entries[k:k + 1] = [int(left[pick]), int(right[pick])]

    # Phase 1: frontier selection per wide node (BFS over binary nodes).
    wide_children: list[list[int]] = []
    wide_of_binary: dict[int, int] = {}
    queue = [0]
    depth_of = {0: 0}
    max_depth = 0
    while queue:
        b = queue.pop(0)
        wide_of_binary[b] = len(wide_children)
        kids = frontier(b)
        wide_children.append(kids)
        for e in kids:
            if data[e] < 0:
                queue.append(e)
                depth_of[e] = depth_of[b] + 1
                max_depth = max(max_depth, depth_of[e])

    # Phase 2: flatten each wide node's children into slot entries.
    # ('leaf', s, c, bin) | ('bin', bin) | ('cont', out_idx). Nodes whose
    # content exceeds 8 slots chain into continuation nodes (slot 7 links).
    out_slots: list[list[tuple]] = []
    out_of_wide: dict[int, int] = {}
    actual_max_run = 1
    extra_depth = 0

    for w, kids in enumerate(wide_children):
        entries: list[tuple] = []
        for e in kids:
            if data[e] >= 0:
                start = int(cut[data[e]])
                end = int(cut[data[e] + 1])
                s = start
                while s < end:
                    c = min(max_run, end - s)
                    entries.append(("leaf", s, c, e))
                    actual_max_run = max(actual_max_run, c)
                    s += c
            else:
                entries.append(("bin", e))
        out_of_wide[w] = len(out_slots)
        chain = 0
        while True:
            if len(entries) <= WIDTH:
                out_slots.append(entries)
                break
            head = entries[: WIDTH - 1]
            rest = entries[WIDTH - 1:]
            cont_idx = len(out_slots) + 1
            out_slots.append(head + [("cont", cont_idx)])
            entries = rest
            chain += 1
        extra_depth = max(extra_depth, chain)

    m = len(out_slots)
    child_low = np.full((m, WIDTH, 3), np.inf, dtype=np.float32)
    child_high = np.full((m, WIDTH, 3), -np.inf, dtype=np.float32)
    child_entry = np.full((m, WIDTH), _PAD, np.int32)

    for o, entries in enumerate(out_slots):
        for slot, ent in enumerate(entries):
            if ent[0] == "leaf":
                _, s, c, e = ent
                child_low[o, slot] = low[e]
                child_high[o, slot] = high[e]
                child_entry[o, slot] = _encode_leaf(s, c)
            elif ent[0] == "bin":
                e = ent[1]
                child_low[o, slot] = low[e]
                child_high[o, slot] = high[e]
                child_entry[o, slot] = out_of_wide[wide_of_binary[e]]
            else:  # continuation: AABB = union of its remaining entries
                cont = ent[1]
                lo = np.full(3, np.inf, np.float32)
                hi = np.full(3, -np.inf, np.float32)
                stackq = [cont]
                while stackq:
                    oi = stackq.pop()
                    for e2 in out_slots[oi]:
                        if e2[0] == "cont":
                            stackq.append(e2[1])
                        else:
                            b2 = e2[3] if e2[0] == "leaf" else e2[1]
                            lo = np.minimum(lo, low[b2])
                            hi = np.maximum(hi, high[b2])
                child_low[o, slot] = lo
                child_high[o, slot] = hi
                child_entry[o, slot] = cont

    return WideBVH(
        child_low=child_low,
        child_high=child_high,
        child_entry=child_entry,
        prim=flat.prim,
        depth=int(max_depth) + 1 + int(extra_depth) + 1,
        max_leaf=int(actual_max_run),
    )


# Batcher odd-even merge network for 8 elements (19 compare-exchanges).
_SORT8 = [(0, 1), (2, 3), (4, 5), (6, 7), (0, 2), (1, 3), (4, 6), (5, 7),
          (1, 2), (5, 6), (0, 4), (1, 5), (2, 6), (3, 7), (2, 4), (3, 5),
          (1, 2), (3, 4), (5, 6)]


def _sort8_by_key(key, val):
    """Sort 8 ``(key, val)`` columns of ``[N, 8]`` ascending by key with the
    JAX package's sorting network (so equal keys keep its order)."""
    key, val = key.clone(), val.clone()
    for a, b in _SORT8:
        swap = key[:, a] > key[:, b]
        ka, kb = key[:, a], key[:, b]
        va, vb = val[:, a], val[:, b]
        key[:, a], key[:, b] = torch.where(swap, kb, ka), torch.where(swap, ka, kb)
        val[:, a], val[:, b] = torch.where(swap, vb, va), torch.where(swap, va, vb)
    return key, val


def traverse_wide(wbvh: WideBVH, ro, rd, leaf_test, eps: float = EPSILON,
                  t_init=None, *, stats: bool = False):
    """Nearest hit over a ``WideBVH``; the contract of
    ``accel.traverse.traverse`` (``leaf_test``, ``t_init``, ``stats``).

    An ordered walk: the children a ray enters are pushed near to far (the
    8-wide sorting network on their slab entry distances) with their entry
    distance on a parallel f32 stack, and a popped entry whose distance can
    no longer beat the best hit is dropped without a fetch. Hits are those
    of the unordered walk (the pruning only skips subtrees that cannot
    improve). Raises ``RuntimeError`` if the walk outlasts ``8 * M + 64``
    steps for ``M`` wide nodes, which no well-formed tree needs (every entry
    is pushed at most once a ray).
    """
    from .traverse import _t_init, stack_read, stack_write

    n, dev = ro.shape[0], ro.device
    cap = wbvh.depth * (WIDTH - 1) + 3
    n_prim = wbvh.prim.shape[0]
    m = wbvh.child_entry.shape[0]
    clow = torch.as_tensor(wbvh.child_low, device=dev)
    chigh = torch.as_tensor(wbvh.child_high, device=dev)
    centry = torch.as_tensor(wbvh.child_entry, device=dev)
    prim = torch.as_tensor(wbvh.prim, device=dev)
    pad = int(_PAD)
    inv = 1.0 / rd

    stack = torch.full((n, cap), pad, dtype=torch.int32, device=dev)
    stack[:, 0] = 0
    stack_t = torch.zeros((n, cap), dtype=torch.float32, device=dev)  # root: 0
    sp = torch.zeros((n,), dtype=torch.int32, device=dev)
    t_best = _t_init(t_init, n, dev)
    prim_best = torch.full((n,), -1, dtype=torch.int32, device=dev)
    steps = 0
    while bool((sp >= 0).any()):
        if steps == 8 * m + 64:
            raise RuntimeError("traverse_wide: iteration backstop reached (corrupt tree?)")
        steps += 1
        active = sp >= 0
        slot = torch.clamp(sp, 0, cap - 1)
        cur = stack_read(stack, slot)
        fresh = active & (stack_read(stack_t, slot) < t_best + eps)  # stale: pop
        is_node = fresh & (cur >= 0)
        is_leaf = fresh & (cur < 0) & (cur != pad)

        # leaf runs: up to max_leaf primitive tests
        start, count = decode_leaf(torch.where(is_leaf, cur, -1))
        for k in range(wbvh.max_leaf):
            pidx = prim[torch.clamp(start + k, 0, max(n_prim - 1, 0)).to(torch.int64)]
            valid = is_leaf & (k < count)
            t = leaf_test(pidx, valid, ro, rd)
            better = valid & (t < t_best)
            t_best = torch.where(better, t, t_best)
            prim_best = torch.where(better, pidx, prim_best)

        # wide nodes: test the 8 child boxes, push the entered ones
        node = torch.clamp_min(cur, 0).to(torch.int64)
        entry = centry[node]                                        # [N,8]
        ti = (clow[node] - ro[:, None, :]) * inv[:, None, :]
        to = (chigh[node] - ro[:, None, :]) * inv[:, None, :]
        t1 = torch.amin(torch.maximum(ti, to), dim=-1)
        t0 = torch.amax(torch.minimum(ti, to), dim=-1)
        hit8 = ((t1 > t0 - eps) & (t1 > 0.0) & (entry != pad)
                & (t0 < t_best[:, None] + eps) & is_node[:, None])

        # near to far: missed slots get +inf keys and sink to the tail
        key = torch.where(hit8, torch.clamp_min(t0, 0.0), float("inf"))
        key, entry = _sort8_by_key(key, entry)
        hit = torch.isfinite(key)
        pushed = hit.sum(dim=1, dtype=torch.int32)
        new_sp = torch.where(active, sp - 1 + torch.where(is_node, pushed, 0), sp)
        # slot k lands at sp - 1 + (entered slots at or after k), so slot 0
        # (the nearest) ends on top
        suffix = torch.flip(torch.cumsum(torch.flip(hit, [1]), 1, dtype=torch.int32), [1])
        for k in range(WIDTH):
            pos = torch.clamp(sp - 1 + suffix[:, k], 0, cap - 1)
            stack = stack_write(stack, pos, entry[:, k], hit[:, k])
            stack_t = stack_write(stack_t, pos, key[:, k], hit[:, k])
        sp = new_sp
    if stats:
        return t_best, prim_best, steps
    return t_best, prim_best
