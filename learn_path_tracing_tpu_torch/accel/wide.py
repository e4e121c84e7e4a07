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
The JAX package's lockstep XLA walk over it (``traverse_wide``) has no
counterpart here: the port's plain traversal walks the packed tables.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

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
