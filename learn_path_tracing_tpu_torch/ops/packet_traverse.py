"""Kernels K2/K3/K5a/K5b: nearest hit over an 8-wide BVH, with their plain
twin.

Counterpart of ``learn_path_tracing_tpu.ops.packet_traverse``, whose kernel
versions (the JAX package's ``LPT_PACKET_VERSION``) are the ``version``
argument here, all in ``csrc/packet_traverse.cu``:

- version 2 (default): K2 (triangle leaves) and K3 (sphere leaves) for the
  TPU's ``_kernel_v2``. The TPU walks one shared SMEM stack per 1024-ray
  packet; the port gives every ray its own stack (one thread per ray),
  which is how the reference walks its BVH. On the H100 the walk is bound
  by instruction rate under divergence, so it reads a node row and a
  sphere run row as 16-byte loads, a triangle run row as 8-byte loads (two
  slots at a time) and takes the slab test's NaN-propagating min/max as
  single ``min.NaN``/``max.NaN`` operations (the source note has the designs
  that were measured and dropped).
- version 3: K5b for ``_kernel_v3`` (tile-ranged). v3 lets each of its 8
  lane tiles skip the nodes none of its lanes entered; here a tile is a
  warp with a stack of its own (``stack_cap`` entries of shared memory),
  which walks only what its own lanes entered, with no block-wide barrier.
  It keeps v3's hoisted slab form (so its function is K2's) and tests
  leaves inline at their parent's pop, nearest first. A packet of 8 warps
  sharing one ranged stack was measured and dropped: every shared pop cost
  all its warps a barrier and saved none of them a slab test.
- version 1: K5a for ``_kernel`` (v1). The same walk, one template with
  K5b, with what is v1's function: nodes are slab-tested in v1's form
  ``(lo - ro)*inv``. v1's pushed leaves are its schedule, not its function;
  they were measured here and lost to the inline test.

K2 has the two modes of ``_kernel_v2`` that the JAX package reaches from
its mesh path, template flags of the same kernel:

- K2r, the treelet restart (``packet_traverse_sorted(restart=True)``, the
  JAX package's ``seed_init``): rays sorted by the treelet key start their
  walk from the depth-2 treelets each of them enters itself (``RaySeeds``:
  its entered words and its two nearest treelets, at most 8 treelets)
  instead of the root; exact, so ``(t, prim)`` are the root walk's. The
  TPU seeds a 1024-ray packet with its block's union (``seed_rows``, kept
  to pin the JAX package's rows); a thread walks one ray here, so the
  union would only add pops;
- K2h, the bf16 slabs: a ``bfloat16`` node table (``nodes_to_bf16``,
  boxes rounded outward) and the slab test in bf16 (packed bf16x2
  arithmetic on the card). It loses hits whose ray terms round past a box
  face, so its image is not the f32 one (an ablation, as in the JAX
  package); K2rh is both.

Sphere leaves take version 2 only, as in the JAX package. The data
contract is the JAX package's:

- ``nodes f32[M,128]``: the 8 child AABBs of wide node ``i``, component-major
  (column ``c + 8*k`` for ``k`` = lo.x, lo.y, lo.z, hi.x, hi.y, hi.z);
- ``entries i32[M,128]``: columns 0..7 hold each child's entry, a node index
  (``>= 0``), a leaf run code ``-(run_row*64 + count + 1)``, or ``_PAD``;
- ``runs f32[R,128]``: up to 8 primitives per row, coefficient-major
  (coefficient ``k`` of slot ``j`` at column ``k*8 + j``), prim ids at
  columns 96..103; a run of more than 8 spills into the next row.
  Triangles (K2, ``leaf_kind='tri'``) are in plane/barycentric coefficient
  form ``n, d, g1, c1, g2, c2``: ``t = (d - ro.n)/(rd.n)``,
  ``w1 = ro.g1 + t (rd.g1) + c1``, ``w2`` alike, ``w3 = 1 - w1 - w2``, a hit
  needs ``t > eps`` and all three weights ``> 0``. Spheres (K3,
  ``leaf_kind='sphere'``) are ``cx, cy, cz, r², flag``: flag 2 (transparent)
  takes the far root when the near root is ``< eps``; empty slots have
  ``r² = -inf``.

Semantics shared by the kernels and ``packet_traverse_plain`` (the same f32
operations in the same order, each rounded on its own):

- slab test of each child as ``t = lo*inv - ro*inv`` (versions 2 and 3,
  ``slab='hoisted'``) or ``t = (lo - ro)*inv`` (version 1,
  ``slab='direct'``) with ``inv = 1/rd``, NaN-propagating min/max; a child
  is entered when ``t1 > t0 - eps``, ``t1 > 0`` and ``t0 < t_best + eps``.
  The two forms differ on a direction component of exactly 0: the hoisted
  one gives ``inf - inf = NaN`` where ``lo`` and ``ro`` have the same sign
  and rejects the box, so such a ray misses what version 1 hits;
- entered leaf children are tested at once, nearest first (key
  ``max(t0, 0)``, ties to the lower slot), each skipped if its key is no
  longer ``< t_best + eps``; entered node children are pushed so that the
  nearest pops first; a popped entry whose key is not ``< t_best + eps`` is
  dropped;
- **tie rule**: a candidate replaces the best hit when its ``t`` is
  strictly smaller, or equal with a smaller prim id. The winner is then the
  least ``(t, prim)`` over every primitive the walk tests, independent of
  the traversal order. (The TPU kernel takes the earliest slot among keys
  equal after dropping 3 mantissa bits, so against it ``prim`` is compared
  off exact ties only.)
- ``t_init`` seeds the best ``t`` per ray (``prim`` stays -1 unless beaten);
  inactive rays are not walked and return ``(t_init, -1)``.

The packet kernels (K5a, K5b) walk a packet's union of nodes, each lane
testing only what its own mask says it entered, so their ``(t, prim)``
are the per-ray walk's. Their ``iters`` are the node pops of the ray's
warp, given to each of its rays; the twin's are per ray, so ``iters`` is
reported and not compared.

The coherence keys are the JAX package's (``_coherence_key``: 'treelet',
the default, or 'morton'). In both packages an empty treelet slot's box
(``lo = +inf``, ``hi = -inf``) passes the key's slab test for every ray, so
on a tree whose top two levels have empty slots every ray "enters" them:
the treelet pair then sorts by those slots, and a block's seed row
(``seed_rows``) is filled only where at most 8 slots are entered in all.
``RaySeeds`` drops those empty slots from a ray's words, so a ray is seeded
wherever it enters at most 8 real treelets.

``traverse`` dispatches on the device: CUDA tensors launch the version's
kernel or K2's mode (and count the launch in
``traverse.launches[<kernel>]``, ``kernel_of``, its lanes in
``traverse.lanes[<kernel>]`` and, for K3, the active lanes its caller
counted on the host in ``ACTIVE_LANES['k3']``), CPU tensors run
the plain twin. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..accel.wide import _PAD, WIDTH, WideBVH, decode_leaf
from ..utils.profiling import host_read
from . import build

SLOT_F = 12                 # floats per triangle slot (n, d, g1, c1, g2, c2)
SLOTS = 8                   # primitive slots per run row
_PRIM_COL = SLOT_F * SLOTS  # cols 96..103: prim index per slot (f32)
_ENC = 64
LEAF_KINDS = ("tri", "sphere")
VERSIONS = (1, 2, 3)
SORT_KEYS = ("treelet", "morton")
# the kernel that carries each (leaf kind, version), as traverse.launches counts
KERNELS = {("tri", 2): "k2", ("sphere", 2): "k3", ("tri", 1): "k5a", ("tri", 3): "k5b"}
# K2's modes (version 2, triangle leaves): seeded from each ray's own
# treelets (the treelet restart), bf16 node boxes, or both
MODES = {(True, False): "k2r", (False, True): "k2h", (True, True): "k2rh"}
SLABS = {1: "direct", 2: "hoisted", 3: "hoisted"}
# stack entries K2 and K3 hold (csrc kMaxStack); K5a and K5b size their
# shared memory by the tables' stack_cap
MAX_STACK = 256
_INF = float("inf")
# The JAX package's RAY_BLOCK: the lanes of one of its seed rows (its
# treelet restart seeds a block of 1024 sorted rays), and the divisor
# nstacks takes.
SEED_BLOCK = 1024
SEED_COLS = 16          # seed row: codes at 0..7, their count at column 8
NO_TREELET = WIDTH * WIDTH   # m1/m2 of RaySeeds.words: no such treelet
# the bf16 slab test's initial bounds: the TPU kernel's jnp.bfloat16(3.0e38)
_BMAX16 = float(torch.tensor(3.0e38).to(torch.bfloat16))

# Treelet-key sentinels (see _treelet_entry_key / _coherence_key): rays that
# enter no depth-2 treelet get major key 65²; packet_traverse_sorted parks
# inactive rays one past that, so sorted order is
# [entered... | enters-nothing... | inactive...].
_TREELET_NONE = (WIDTH * WIDTH + 1) ** 2
_KEY_ENTERED_LIM = _TREELET_NONE << 18
_KEY_INACTIVE = (_TREELET_NONE + 1) << 18


# ------------------------------------------------------------ host packers --

def _node_columns(wbvh: WideBVH):
    m = wbvh.child_entry.shape[0]
    nodes = np.zeros((m, 128), np.float32)
    for d in range(3):
        nodes[:, d * 8:(d + 1) * 8] = wbvh.child_low[:, :, d]
        nodes[:, (3 + d) * 8:(4 + d) * 8] = wbvh.child_high[:, :, d]
    return nodes


def _leaf_runs(wbvh: WideBVH, fill_row, empty_row):
    """Entries table plus run rows: ``fill_row(row, prim_ids)`` writes one
    row's slots (at most 8); ``empty_row()`` makes a blank row."""
    m = wbvh.child_entry.shape[0]
    entries = np.full((m, 128), _PAD, np.int32)
    runs = []
    for i in range(m):
        for c in range(WIDTH):
            e = int(wbvh.child_entry[i, c])
            if e == _PAD:
                continue
            if e >= 0:
                entries[i, c] = e
                continue
            start, count = decode_leaf(np.int32(e))
            start, count = int(start), int(count)
            if count > 2 * SLOTS:
                raise ValueError(
                    f"leaf run of {count} prims exceeds the kernels' 2-row "
                    f"unroll (max_leaf <= {2 * SLOTS})")
            entries[i, c] = -(len(runs) * _ENC + count + 1)
            for r0 in range(0, count, SLOTS):
                row = empty_row()
                k = min(SLOTS, count - r0)
                fill_row(row, wbvh.prim[start + r0:start + r0 + k])
                runs.append(row)
    if not runs:
        runs.append(empty_row())
    return entries, np.stack(runs)


def pack_packet_tables(wbvh: WideBVH, v0, v1, v2):
    """Kernel tables ``(nodes f32[M,128], entries i32[M,128], runs
    f32[R,128])`` for a wide BVH over triangles ``v0, v1, v2 f32[T,3]``,
    byte for byte the JAX package's (the same numpy operations per
    triangle)."""
    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)

    def empty_row():
        return np.zeros((128,), np.float32)

    def fill_row(row, prims):
        for j, p in enumerate(prims):
            row[_PRIM_COL + j] = float(p)
            p1, p2, p3 = v0[p], v1[p], v2[p]
            n = np.cross(p2 - p1, p3 - p1)
            nn = np.sqrt(np.dot(n, n))
            n = n / max(nn, 1e-20)
            den1 = np.dot(np.cross(p3 - p2, p1 - p2), n)
            den2 = np.dot(np.cross(p1 - p3, p2 - p3), n)
            den1 = den1 if abs(den1) > 1e-20 else 1e-20
            den2 = den2 if abs(den2) > 1e-20 else 1e-20
            g1 = np.cross(n, p3 - p2) / den1
            c1 = -np.dot(np.cross(p3 - p2, p2), n) / den1
            g2 = np.cross(n, p1 - p3) / den2
            c2 = -np.dot(np.cross(p1 - p3, p3), n) / den2
            coefs = [n[0], n[1], n[2], np.dot(p1, n),
                     g1[0], g1[1], g1[2], c1,
                     g2[0], g2[1], g2[2], c2]
            for k, val in enumerate(coefs):
                row[k * WIDTH + j] = val
        # empty slots never report a hit: plane at infinity
        for j in range(len(prims), SLOTS):
            row[3 * WIDTH + j] = np.inf

    entries, runs = _leaf_runs(wbvh, fill_row, empty_row)
    return _node_columns(wbvh), entries, runs


def pack_sphere_packet_tables(wbvh: WideBVH, centers, radii, transparency):
    """Kernel tables for a wide BVH over spheres: run rows hold
    ``(cx, cy, cz, r², flag)`` per slot, flag 1 opaque / 2 transparent, and
    ``r² = -inf`` in empty slots. Byte for byte the JAX package's."""
    centers = np.asarray(centers, np.float32)
    radii = np.asarray(radii, np.float32)
    transparency = np.asarray(transparency, np.float32)

    def empty_row():
        row = np.zeros((128,), np.float32)
        row[3 * WIDTH:4 * WIDTH] = -np.inf   # empty: r² = -inf
        return row

    def fill_row(row, prims):
        for j, p in enumerate(prims):
            p = int(p)
            row[_PRIM_COL + j] = float(p)
            row[0 * WIDTH + j] = centers[p, 0]
            row[1 * WIDTH + j] = centers[p, 1]
            row[2 * WIDTH + j] = centers[p, 2]
            row[3 * WIDTH + j] = radii[p] * radii[p]
            row[4 * WIDTH + j] = 2.0 if transparency[p] > 0 else 1.0

    entries, runs = _leaf_runs(wbvh, fill_row, empty_row)
    return _node_columns(wbvh), entries, runs


def nodes_to_bf16(nodes):
    """bfloat16 copy ``[M,128]`` of a ``nodes`` table with outward rounding,
    byte for byte the JAX package's: lo columns 0..23 round toward -inf and
    hi columns 24..47 toward +inf (so every bf16 box contains its f32
    box), the other columns to nearest even. K2 walks such a table in its
    bf16-slab mode (K2h); versions 1 and 3 widen it to f32, as the JAX
    package's kernels promote it."""
    if isinstance(nodes, torch.Tensor):
        nodes = nodes.cpu().numpy()
    nodes = np.array(nodes, np.float32)
    near = torch.from_numpy(nodes).to(torch.bfloat16)     # round to nearest even
    back = near.to(torch.float32).numpy()
    bits = near.view(torch.int16).numpy().view(np.uint16)

    def step(b, up):
        """One bf16 ulp toward +inf (``up``) or -inf, across signs and zero."""
        pos = (b & 0x8000) == 0
        inc = np.where(pos == up, b + 1, b - 1).astype(np.uint16)
        return np.where((b & 0x7FFF) == 0,
                        np.uint16(1) | np.where(up, 0, 0x8000).astype(np.uint16), inc)

    out = bits.copy()
    for d in range(6):
        cols = slice(d * 8, (d + 1) * 8)
        up = d >= 3                    # hi columns need bf16 >= f32
        need = (back[:, cols] < nodes[:, cols]) if up else (back[:, cols] > nodes[:, cols])
        out[:, cols] = np.where(need, step(bits[:, cols], up), bits[:, cols])
    return torch.from_numpy(out.view(np.int16).copy()).view(torch.bfloat16)


def stack_cap(entries) -> int:
    """Stack entries a walk of these tables can need: ``1 + 7*depth``, with
    ``depth`` the number of wide-node levels. A pop of a node at level
    ``L`` replaces it by at most 8 children while each ancestor on its path
    leaves at most 7 unvisited children below it: ``7*(L-1) + 8``. Every
    kernel tests leaf children inline, so only node children count (the
    bound would also hold with leaves pushed: a leaf pop only removes an
    entry)."""
    entries = np.asarray(entries)
    depth, level = 0, [0]
    while level:
        depth += 1
        kids = entries[level, :WIDTH]
        level = kids[kids >= 0].tolist()
    return 1 + (WIDTH - 1) * depth


def treelet_boxes(nodes, entries):
    """``(lo f32[64,3], hi f32[64,3])`` AABBs of the root's depth-2 subtrees
    (numpy, computed once per world). A root child that is itself a leaf
    run occupies its own first slot; empty slots keep never-hit boxes."""
    nodes = np.asarray(nodes, np.float32)
    entries = np.asarray(entries)
    m = nodes.shape[0]
    ent0 = entries[0, 0:WIDTH]
    crows = nodes[np.clip(ent0, 0, m - 1)]                       # [8,128]
    glo = np.stack([crows[:, d * 8:(d + 1) * 8] for d in range(3)], -1)
    ghi = np.stack([crows[:, (3 + d) * 8:(4 + d) * 8] for d in range(3)], -1)
    rlo = np.stack([nodes[0, d * 8:(d + 1) * 8] for d in range(3)], -1)
    rhi = np.stack([nodes[0, (3 + d) * 8:(4 + d) * 8] for d in range(3)], -1)
    is_node = (ent0 >= 0)[:, None, None]
    self_slot = (np.arange(WIDTH) == 0)[None, :, None]
    lo = np.where(is_node, glo, np.where(self_slot, rlo[:, None, :], np.inf))
    hi = np.where(is_node, ghi, np.where(self_slot, rhi[:, None, :], -np.inf))
    return (lo.reshape(WIDTH * WIDTH, 3).astype(np.float32),
            hi.reshape(WIDTH * WIDTH, 3).astype(np.float32))


def treelet_seed_codes(nodes, entries):
    """``i32[64]`` stack entry code of each treelet slot of
    ``treelet_boxes``: root child ``c``'s grandchild ``g`` at ``c*8 + g``; a
    root child that is itself a leaf run holds slot ``c*8`` with its own
    leaf code; empty slots ``_PAD`` (numpy, computed once per world; the
    treelet restart's seeds, ``packet_traverse_sorted(restart=True)``)."""
    entries = np.asarray(entries.cpu() if isinstance(entries, torch.Tensor) else entries)
    m = entries.shape[0]
    ent0 = entries[0, 0:WIDTH]
    grand = entries[np.clip(ent0, 0, m - 1)][:, 0:WIDTH]          # [8,8]
    is_node = (ent0 >= 0)[:, None]
    self_slot = (np.arange(WIDTH) == 0)[None, :]
    codes = np.where(is_node, grand, np.where(self_slot, ent0[:, None], _PAD))
    return codes.reshape(WIDTH * WIDTH).astype(np.int32)


# --------------------------------------------------------- coherence keys --

def _treelet_entry_key(ro, rd, treelets, eps: float = 0.0, want_mask: bool = False):
    """Sort key = the two nearest depth-2 treelets each ray enters
    (``m1 * 65 + m2``; 64 = none; ``65²`` when the ray enters none), from
    dense slab tests against the <= 64 treelet boxes. ``want_mask`` also
    returns every treelet the ray enters as two int64 words ``(w0, w1)``
    (bit ``t`` of word ``t // 32``: the JAX package's two u32 words)."""
    lo, hi = treelets
    inv = torch.ones_like(rd) / rd
    t0 = t1 = None
    for d in range(3):
        ta = (lo[None, :, d] - ro[:, d:d + 1]) * inv[:, d:d + 1]   # [N,64]
        tb = (hi[None, :, d] - ro[:, d:d + 1]) * inv[:, d:d + 1]
        mn, mx = torch.minimum(ta, tb), torch.maximum(ta, tb)
        t0 = mn if t0 is None else torch.maximum(t0, mn)
        t1 = mx if t1 is None else torch.minimum(t1, mx)
    # eps-relaxed like the kernel's child test (flat boxes have t1 == t0)
    entered = (t1 > t0 - eps) & (t1 > 0.0)
    tmin = torch.where(entered, torch.clamp_min(t0, 0.0), _INF)
    t_m1, m1 = torch.min(tmin, dim=1)          # first index of the minimum
    nw = WIDTH * WIDTH
    slots = torch.arange(nw, device=ro.device)
    tmin2 = torch.where(slots[None, :] == m1[:, None], _INF, tmin)
    t_m2, m2 = torch.min(tmin2, dim=1)
    m2 = torch.where(torch.isfinite(t_m2), m2, nw)
    key = m1 * (nw + 1) + m2
    key = torch.where(torch.isfinite(t_m1), key, _TREELET_NONE)
    if not want_mask:
        return key
    bits = torch.arange(32, dtype=torch.int64, device=ro.device)
    words = [torch.sum(entered[:, h * 32:(h + 1) * 32].to(torch.int64) << bits, dim=1)
             for h in range(2)]
    return key, words[0], words[1]


def _spread(v):  # 5 bits -> every 3rd position (Morton interleave)
    v = (v | (v << 8)) & 0x0300F
    v = (v | (v << 4)) & 0x030C3
    v = (v | (v << 2)) & 0x09249
    return v


def _morton_key(nodes, ro, rd):
    """int64 Morton code of the origin's cell over the root box (32 cells
    per axis) times 8 plus the direction octant: 18 bits."""
    cells = 32
    root = nodes[0]
    lo = torch.stack([torch.amin(root[d * 8:(d + 1) * 8]) for d in range(3)])
    hi = torch.stack([torch.amax(root[(3 + d) * 8:(4 + d) * 8]) for d in range(3)])
    span = torch.clamp_min(hi - lo, 1e-6)
    # clamped before the integer cast (the JAX package clips after a
    # saturating cast: the same cells, without an out-of-range cast)
    q = torch.clamp((ro - lo) / span * cells, 0, cells - 1).to(torch.int64)
    octant = ((rd[:, 0] > 0).to(torch.int64) + 2 * (rd[:, 1] > 0).to(torch.int64)
              + 4 * (rd[:, 2] > 0).to(torch.int64))
    cell = (_spread(q[:, 0]) << 2) | (_spread(q[:, 1]) << 1) | _spread(q[:, 2])
    return cell * 8 + octant


def _coherence_key(nodes, ro, rd, treelets, eps: float = 0.0, kind: str = "treelet"):
    """int64 sort key of the JAX package's ``_coherence_key``, value for
    value: ``kind='treelet'`` the treelet-entry pair (major, 13 bits) then
    the Morton code (``_morton_key``, 18 bits); ``kind='morton'`` the
    Morton code alone (``treelets`` unused)."""
    if kind not in SORT_KEYS:
        raise ValueError(f"unknown sort key: {kind!r} (one of {SORT_KEYS})")
    morton = _morton_key(nodes, ro, rd)
    if kind == "morton":
        return morton
    return _treelet_entry_key(ro, rd, treelets, eps=eps) * (1 << 18) + morton


def seed_rows(w0, w1, seed_codes):
    """The JAX package's treelet-restart seed rows ``i32[ceil(N/1024), 16]``
    from the sorted rays' entered words ``w0, w1``
    (``_treelet_entry_key(want_mask=True)`` in sorted order, 0 for inactive
    rays) and the tables' ``seed_codes`` (``treelet_seed_codes``). Row
    ``b`` seeds rays ``[1024 b, 1024 b + 1024)``: columns 0..7 hold the
    codes of the treelets any of them enters, in slot order (then the rest
    of the slots' codes), column 8 their count, 0 (a root walk) when it is
    above 8. K2r seeds each ray from its own treelets instead
    (``RaySeeds``); these rows report what the TPU's packets would take."""
    n = w0.shape[0]
    nblk = -(-n // SEED_BLOCK)
    bits = torch.arange(32, dtype=torch.int64, device=w0.device)
    ent = torch.cat([((w[:, None] >> bits) & 1).bool() for w in (w0, w1)], dim=1)
    ent = torch.cat([ent, ent.new_zeros((nblk * SEED_BLOCK - n, WIDTH * WIDTH))])
    ent = ent.view(nblk, SEED_BLOCK, WIDTH * WIDTH).any(dim=1)         # [nblk,64]
    cnt = ent.sum(dim=1)
    # entered codes to the row head, in slot order (a stable sort)
    slot = torch.sort((~ent).to(torch.int32), dim=1, stable=True).indices
    codes = torch.as_tensor(seed_codes, device=w0.device).to(torch.int32)[slot]
    rows = torch.zeros((nblk, SEED_COLS), dtype=torch.int32, device=w0.device)
    rows[:, :WIDTH] = codes[:, :WIDTH]
    rows[:, WIDTH] = torch.where((cnt >= 1) & (cnt <= WIDTH), cnt, 0).to(torch.int32)
    return rows


class RaySeeds(NamedTuple):
    """K2r's seeds (``sorted_rays(restart=True)``, ``ray_seeds``): ray
    ``i`` starts its walk from the treelet slots set in its words, when
    they are at most 8.

    - ``words i32[N,4]``: ``(w0, w1, m1, m2)``: bit ``t`` of ``w0`` (``t <
      32``) or ``w1`` (``t >= 32``) set when the ray enters treelet slot
      ``t``; ``m1``, ``m2`` its nearest and second-nearest slots
      (``NO_TREELET``: none), which pop first, then the rest in slot order;
    - ``codes i32[64]``: each slot's stack entry code
      (``treelet_seed_codes``): a node is pushed at entry distance +0, a
      leaf run tested at once, an empty slot (``_PAD``) skipped.

    More than 8 set bits walk from the root; none, an active ray walks
    nothing."""
    words: torch.Tensor
    codes: torch.Tensor

    def to(self, device) -> "RaySeeds":
        return RaySeeds(self.words.to(device), self.codes.to(device))

    def counts(self):
        """``i64[N]``: the slots each ray's words set (seeded at most 8)."""
        return _entered(self.words).sum(dim=1)


def _entered(words):
    """``bool[N,64]``: the treelet slots set in ``RaySeeds.words``."""
    w = words.to(torch.int64)
    bits = torch.arange(32, dtype=torch.int64, device=words.device)
    return torch.cat([((w[:, h, None] >> bits) & 1).bool() for h in range(2)], dim=1)


def _u32_as_i32(w):
    """int64 values in [0, 2^32) as the int32 of the same bits."""
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def ray_seeds(w0, w1, tkey, seed_codes) -> RaySeeds:
    """K2r's ``RaySeeds`` of rays with entered words ``w0, w1`` and treelet
    key ``tkey`` (``_treelet_entry_key(want_mask=True)``: the words int64,
    the key ``m1*65 + m2``, ``65²`` for none) over tables with
    ``seed_codes`` (``treelet_seed_codes``). Empty slots, which the key's
    slab test enters for every ray, are dropped from the words, so they
    neither seed nor count."""
    codes = torch.as_tensor(seed_codes, device=w0.device).to(torch.int32)
    real = (codes != int(_PAD)).to(torch.int64)
    bits = torch.arange(32, dtype=torch.int64, device=w0.device)
    masks = [host_read(int, torch.sum(real[h * 32:(h + 1) * 32] << bits)) for h in range(2)]
    m1 = torch.where(tkey < _TREELET_NONE, tkey // (NO_TREELET + 1), NO_TREELET)
    m2 = torch.where(tkey < _TREELET_NONE, tkey % (NO_TREELET + 1), NO_TREELET)
    words = torch.stack([_u32_as_i32(w0 & masks[0]), _u32_as_i32(w1 & masks[1]),
                         m1.to(torch.int32), m2.to(torch.int32)], dim=1)
    return RaySeeds(words.contiguous(), codes.contiguous())


def _seed_slots(words):
    """The treelet slots ray ``i`` of ``words`` (``RaySeeds.words``) pushes,
    in push order: ``(slots i64[N,64], count i64[N])``, the first
    ``count`` columns valid. Pops run m1, m2, then the rest in slot order,
    so the rest are pushed from the highest slot down, then m2, then m1."""
    w = words.to(torch.int64)
    ent = _entered(words)
    slot = torch.arange(WIDTH * WIDTH, dtype=torch.int64, device=words.device)
    rank = torch.where(slot[None, :] == w[:, 2:3], WIDTH * WIDTH + 1,
                       torch.where(slot[None, :] == w[:, 3:4], WIDTH * WIDTH,
                                   WIDTH * WIDTH - 1 - slot[None, :]))
    rank = torch.where(ent, rank, 2 * WIDTH * WIDTH)
    return torch.sort(rank, dim=1, stable=True).indices, ent.sum(dim=1)


# ----------------------------------------------------------- entry points --

def _check(nodes, entries, runs, ro, rd, t_init, active, leaf_kind, version=2, seeds=None):
    if leaf_kind not in LEAF_KINDS:
        raise ValueError(f"unknown leaf kind: {leaf_kind!r}")
    if version not in VERSIONS:
        raise ValueError(f"unknown packet version: {version!r} (one of {VERSIONS})")
    if leaf_kind != "tri" and version != 2:
        raise ValueError("sphere leaf runs require version 2")
    bf16 = nodes.dtype == torch.bfloat16
    if (bf16 or seeds is not None) and leaf_kind != "tri":
        raise ValueError("bf16 node slabs and restart seeds are modes of K2 (triangle leaves)")
    if seeds is not None and version != 2:
        raise ValueError("restart seeding requires the v2 kernel")
    n = ro.shape[0]
    checks = [("nodes", nodes, torch.bfloat16 if bf16 else torch.float32, (nodes.shape[0], 128)),
              ("entries", entries, torch.int32, (nodes.shape[0], 128)),
              ("runs", runs, torch.float32, (runs.shape[0], 128)),
              ("ro", ro, torch.float32, (n, 3)), ("rd", rd, torch.float32, (n, 3)),
              ("t_init", t_init, torch.float32, (n,)),
              ("active", active, torch.bool, (n,))]
    if seeds is not None:
        if not isinstance(seeds, RaySeeds):
            raise ValueError(f"packet traversal: seeds must be RaySeeds, got {type(seeds)}")
        checks += [("seeds.words", seeds.words, torch.int32, (n, 4)),
                   ("seeds.codes", seeds.codes, torch.int32, (WIDTH * WIDTH,))]
    for name, x, dtype, shape in checks:
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"packet traversal: {name} must be {dtype}{list(shape)}, "
                             f"got {x.dtype}{list(x.shape)}")
        if x.device != ro.device:
            raise ValueError(f"packet traversal: {name} is on {x.device}, "
                             f"rays on {ro.device}")


def kernel_of(leaf_kind: str = "tri", version: int = 2, seeded: bool = False,
              bf16: bool = False) -> str:
    """The name under which ``traverse.launches`` counts the kernel of these
    arguments: K2's modes are ``k2r`` (seeded), ``k2h`` (bf16 slabs) and
    ``k2rh`` (both)."""
    if version == 2 and leaf_kind == "tri" and (seeded or bf16):
        return MODES[seeded, bf16]
    return KERNELS[(leaf_kind, version)]


def traverse(nodes, entries, runs, ro, rd, t_init, active, eps: float = 1e-4,
             leaf_kind: str = "tri", stack: int | None = None, version: int = 2,
             seeds=None, active_lanes: int | None = None, err=None):
    """Nearest hit of ``N`` rays → ``(t f32[N], prim i32[N], iters i32[N])``:
    ``t`` is ``t_init`` and ``prim`` -1 where nothing beats ``t_init``;
    ``iters`` counts stack pops (each ray's in the twin and K2/K3, its
    packet's in K5a/K5b). ``stack`` is the tables' ``stack_cap`` (computed
    from ``entries`` when None); ``version`` picks the kernel (1, 2 or 3).

    K2's modes (version 2, triangle leaves): ``seeds`` (``RaySeeds``)
    starts ray ``i``'s walk from the treelets its words name instead of the
    root (K2r); a ``bfloat16`` ``nodes`` table (``nodes_to_bf16``) runs the
    slab test in bf16 (K2h); both, K2rh.
    Versions 1 and 3 widen a bf16 table to f32 and walk it, as the JAX
    package's v1 and v3 kernels promote it.

    ``active_lanes``: how many of ``active`` are set, where the caller knows
    it without reading the device (None where it does not); a K3 launch
    adds it to ``ACTIVE_LANES['k3']``, which never reads the device.

    ``err``: the caller's error word (``i32[1]`` on the rays' device). A
    launch ORs its flags into it and reads nothing back; the caller reads it
    when it will (``check_flags`` raises this call's errors). So the caller
    consumes a flagged launch's outputs before the check: a walk that
    faults stops and returns the nearest hit it had found (a prim of the
    tables or -1; on corrupt tables, any value), and the work after it runs
    on that until the read raises. Without ``err`` a launch reads its own
    word and raises at once. The plain twin raises at once either way and
    leaves ``err`` as it was.

    CUDA tensors launch the kernel, CPU tensors run the plain twin."""
    if nodes.dtype == torch.bfloat16 and version != 2:
        nodes = nodes.to(torch.float32)
    _check(nodes, entries, runs, ro, rd, t_init, active, leaf_kind, version, seeds)
    if err is not None and (err.dtype != torch.int32 or tuple(err.shape) != (1,)
                            or err.device != ro.device):
        raise ValueError(f"packet traversal: err must be torch.int32[1] on {ro.device}, "
                         f"got {err.dtype}{list(err.shape)} on {err.device}")
    if stack is None:
        stack = stack_cap(entries.cpu().numpy())
    if ro.device.type == "cpu":
        return packet_traverse_plain(nodes, entries, runs, ro, rd, t_init, active,
                                     eps=eps, leaf_kind=leaf_kind, stack=stack,
                                     slab=SLABS[version], seeds=seeds)
    if ro.device.type != "cuda":
        raise ValueError(f"packet traversal: no kernel for device {ro.device}")
    return _launch(nodes, entries, runs, ro, rd, t_init, active, eps, leaf_kind, stack,
                   version, seeds, active_lanes, err)


traverse.launches = {kernel: 0 for kernel in (*KERNELS.values(), *MODES.values())}
traverse.lanes = dict(traverse.launches)
# the active lanes of the kernels whose callers count them on the host (K3):
# a module table, which a wrapper of ``traverse`` leaves in place
ACTIVE_LANES = {"k3": 0}


def count_launch(kernel: str, lanes: int, active_lanes: int | None = None):
    """Count one launch of ``kernel`` over ``lanes`` lanes in ``traverse``'s
    counters, and ``active_lanes`` where the kernel keeps that count."""
    traverse.launches[kernel] += 1
    traverse.lanes[kernel] += lanes
    if active_lanes is not None and kernel in ACTIVE_LANES:
        ACTIVE_LANES[kernel] += active_lanes


def _treelets(nodes, entries, device):
    return tuple(torch.as_tensor(x, device=device) for x in
                 treelet_boxes(nodes.to(torch.float32).cpu().numpy(), entries.cpu().numpy()))


def _check_nstacks(nstacks: int, version: int):
    """The JAX package's checks of its sub-packet count."""
    if nstacks < 1 or SEED_BLOCK % nstacks:
        raise ValueError(f"nstacks={nstacks} must divide block {SEED_BLOCK}")
    if nstacks != 1 and version != 2:
        raise ValueError("nstacks > 1 requires version=2")


def packet_traverse(nodes, entries, runs, ro, rd, t_init, active,
                    eps: float = 1e-4, sort_rays: bool = False,
                    with_stats: bool = False, sort_key: str = "treelet",
                    version: int = 2, nstacks: int = 1, treelets=None,
                    leaf_kind: str = "tri", stack: int | None = None):
    """Nearest-hit traversal in caller lane order: ``(t, prim)``. ``t`` is
    ``t_init`` where nothing beats it (inactive rays included) and ``prim``
    is -1 there. The parameters take the JAX package's order.

    ``sort_rays``: the JAX package's coherence sort around the kernel
    (``_sort_fwd``/``_sort_inv``): rays are stably sorted by ``sort_key``
    ('treelet': the treelet-entry pair then the Morton code, with
    ``treelets`` the tables' ``treelet_boxes``, computed when None;
    'morton': the Morton code alone), traversed, and put back in lane
    order. A packet kernel's cost is its packet's node union, which the
    sort shrinks; the result is the same either way (a permutation, and an
    order-free tie rule). The JAX package sorts by default; the port does
    not (version 2's sort cost more than it saved on the card).

    ``nstacks``: the JAX package's sub-packets of version 2 (it splits a
    1024-ray block into that many stacks walked in turn), checked as there
    (a divisor of 1024; 1 for versions 1 and 3). K2 gives every ray a stack
    of its own, finer than any split, and the result of ``_kernel_v2`` is
    exact for every value, so the argument changes nothing here.

    ``with_stats``: also return the walk's ``iters i32[N]``, the node pops
    of each ray (of its warp for versions 1 and 3; the JAX package gives
    one count a packet). It needs ``sort_rays=False``, as there."""
    _check_nstacks(nstacks, version)
    if with_stats and sort_rays:
        raise ValueError("with_stats requires sort_rays=False to keep lane identity")
    if not sort_rays:
        t, prim, iters = traverse(nodes, entries, runs, ro, rd, t_init, active, eps=eps,
                                  leaf_kind=leaf_kind, stack=stack, version=version)
        return (t, prim, iters) if with_stats else (t, prim)
    if treelets is None and sort_key == "treelet":
        treelets = _treelets(nodes, entries, ro.device)
    order = torch.argsort(_coherence_key(nodes, ro, rd, treelets, kind=sort_key),
                          stable=True)
    t_s, p_s, _ = traverse(nodes, entries, runs, ro[order], rd[order], t_init[order],
                           active[order], eps=eps, leaf_kind=leaf_kind, stack=stack,
                           version=version)
    t, prim = torch.empty_like(t_s), torch.empty_like(p_s)
    t[order] = t_s
    prim[order] = p_s
    return t, prim


def packet_traverse_sorted(nodes, entries, runs, ro, rd, active,
                           eps: float = 1e-4, sort_key: str = "treelet", treelets=None,
                           version: int = 2, restart: bool = False, seed_codes=None,
                           payload=(), stack: int | None = None):
    """Coherence-sorted traversal: the JAX package's entry for fused hit
    shading on single-structure worlds (``t_init`` is +inf).
    ``scene.legacy_world.trace_shade_compact`` takes it for versions 1 and
    3 (packet kernels), as the JAX package does, and for version 2 under
    the treelet restart; version 2 otherwise walks in lane order (the sort
    cost more than it saved there).

    Rays are stably sorted by the treelet coherence key (``treelets``: the
    tables' ``treelet_boxes``, computed when None; ``sort_key`` must be
    'treelet', whose entered prefix the result reports), inactive rays last
    (``_KEY_INACTIVE``), and traversed in that order. Returns ``(t_s,
    prim_s, ro_s, rd_s, entered_n, order_idx)`` in sorted order: ``t_s`` is
    +inf where nothing was hit, ``entered_n`` (0-dim tensor) counts the
    sorted rays that enter a depth-2 treelet (every hit lies in that
    prefix), ``order_idx[i]`` is the original lane of sorted slot ``i``.
    ``payload``: extra ``[N, ...]`` tensors carried through the sort; when
    given, the result gains a 7th element, the payload in sorted order.

    ``restart`` (version 2 only): the JAX package's treelet restart. Each
    sorted ray starts its walk from the depth-2 treelets it enters itself
    (``RaySeeds``, from ``seed_codes``, the tables' ``treelet_seed_codes``,
    computed when None) instead of the root: K2r. Exact, since a ray can
    only hit a primitive below a treelet it enters (the primitive lies in
    the treelet's box, and the key's slab test is eps-relaxed like the
    kernel's), so ``(t_s, prim_s)`` equal the root walk's. A ray entering
    more than 8 treelets walks from the root. (The JAX package seeds a
    1024-ray block with the union of its rays' treelets, ``seed_rows``.)"""
    if sort_key != "treelet":
        # the entered prefix (hits in the first entered_n sorted rays) holds
        # for the treelet-major key only
        raise ValueError("packet_traverse_sorted requires sort_key='treelet'")
    if restart and version != 2:
        raise ValueError("restart seeding requires the v2 kernel")
    order_idx, active_s, entered_n, seeds = sorted_rays(
        nodes, entries, ro, rd, active, eps=eps, treelets=treelets, restart=restart,
        seed_codes=seed_codes)
    ro_s, rd_s = ro[order_idx], rd[order_idx]
    t_init = torch.full_like(ro_s[:, 0], _INF)
    t, prim, _ = traverse(nodes, entries, runs, ro_s, rd_s, t_init, active_s,
                          eps=eps, stack=stack, version=version, seeds=seeds)
    t_s = torch.where(prim >= 0, t, _INF)
    out = (t_s, prim, ro_s, rd_s, entered_n, order_idx)
    if payload:
        return out + (tuple(p[order_idx] for p in payload),)
    return out


def sorted_rays(nodes, entries, ro, rd, active, eps: float = 1e-4, treelets=None,
                restart: bool = False, seed_codes=None):
    """``packet_traverse_sorted``'s ray order: ``(order_idx, active_s,
    entered_n, seeds)``, the stable sort by the treelet coherence key with
    inactive rays last, the sorted rays' active mask, the count of sorted
    rays that enter a treelet, and with ``restart`` the sorted rays' own
    seeds (``ray_seeds``; inactive rays none; else None)."""
    if treelets is None:
        treelets = _treelets(nodes, entries, ro.device)
    if restart:
        tkey, w0, w1 = _treelet_entry_key(ro, rd, treelets, eps=eps, want_mask=True)
        key = tkey * (1 << 18) + _morton_key(nodes, ro, rd)
    else:
        key = _coherence_key(nodes, ro, rd, treelets, eps=eps)
    key = torch.where(active, key, _KEY_INACTIVE)
    order_idx = torch.argsort(key, stable=True)
    key_s = key[order_idx]
    active_s = key_s < _KEY_INACTIVE
    entered_n = torch.sum(key_s < _KEY_ENTERED_LIM)
    seeds = None
    if restart:
        if seed_codes is None:
            seed_codes = treelet_seed_codes(nodes, entries)
        w0_s, w1_s = (torch.where(active_s, w[order_idx], 0) for w in (w0, w1))
        seeds = ray_seeds(w0_s, w1_s, tkey[order_idx], seed_codes)
    return order_idx, active_s, entered_n, seeds


# ------------------------------------------------------------------ kernel --

# the kernels' error flags (csrc kErrStack, kErrIters), as ``check_flags`` names them
_FLAGS = {1: "stack overflow", 2: "iteration backstop reached",
          3: "stack overflow and iteration backstop reached"}


def check_flags(flags: int):
    """Raise the ``RuntimeError`` of an error word that holds ``flags``
    (nothing for 0)."""
    if flags:
        raise RuntimeError(f"packet traversal kernel: {_FLAGS[flags]} (corrupt tables?)")


def _launch(nodes, entries, runs, ro, rd, t_init, active, eps, leaf_kind, stack, version,
            seeds=None, active_lanes=None, err=None):
    bf16 = nodes.dtype == torch.bfloat16
    kernel = kernel_of(leaf_kind, version, seeds is not None, bf16)
    if version == 2 and stack > MAX_STACK:
        raise ValueError(f"packet traversal kernel: the tables need a stack of "
                         f"{stack} entries, {kernel} holds {MAX_STACK}")
    tensors = (("nodes", nodes), ("entries", entries), ("runs", runs), ("ro", ro),
               ("rd", rd), ("t_init", t_init), ("active", active),
               *((("seeds.words", seeds.words), ("seeds.codes", seeds.codes))
                 if seeds is not None else ()))
    for name, x in tensors:
        if not x.is_contiguous():
            raise ValueError(f"packet traversal kernel: {name} must be contiguous")
    lib = load_kernel()
    n, m = ro.shape[0], nodes.shape[0]
    dev = ro.device
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    prim = torch.empty((n,), dtype=torch.int32, device=dev)
    iters = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return t, prim, iters
    word = torch.zeros((1,), dtype=torch.int32, device=dev) if err is None else err
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.lpt_packet_traverse(
            nodes.data_ptr(), entries.data_ptr(), runs.data_ptr(), ro.data_ptr(),
            rd.data_ptr(), t_init.data_ptr(), active.data_ptr(),
            None if seeds is None else seeds.words.data_ptr(),
            None if seeds is None else seeds.codes.data_ptr(), t.data_ptr(),
            prim.data_ptr(), iters.data_ptr(), word.data_ptr(), n, stack,
            16 * m + 64, float(eps), LEAF_KINDS.index(leaf_kind), version, int(bf16),
            stream)
    if code != 0:
        msg = lib.lpt_error_string(code).decode()
        raise RuntimeError(f"packet traversal kernel launch failed: {msg} ({code})")
    count_launch(kernel, n, active_lanes)
    if err is None:
        check_flags(host_read(int, word))
    return t, prim, iters


@functools.cache
def load_kernel() -> ctypes.CDLL:
    """Build (first use) and load the kernel library with its C signature."""
    lib = build.load("packet_traverse")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.lpt_packet_traverse.argtypes = [vp] * 13 + [ci, ci, ci, ctypes.c_float, ci, ci, ci,
                                                    vp]
    lib.lpt_packet_traverse.restype = ci
    lib.lpt_error_string.argtypes = [ci]
    lib.lpt_error_string.restype = ctypes.c_char_p
    return lib


# -------------------------------------------------------------- plain twin --

def _sqrt_f32(x):
    """Correctly rounded f32 square root (PyTorch's vectorized CPU f32 sqrt
    is not always; the f64 root rounded to f32 is, like the kernel's)."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def _slot_candidates(row, nslots, o, d, eps, leaf_kind):
    """Every slot of one run row per ray: ``row f32[R,128]``, valid slots
    ``j < nslots[R]``, ray origins/directions ``o, d f32[R,3]``. Returns
    ``(t f32[R,8] (+inf: no hit), prim i32[R,8], ok bool[R,8])``."""
    def c(k):
        return row[:, k * WIDTH:(k + 1) * WIDTH]                   # [R,8]

    o0, o1, o2 = (o[:, i:i + 1] for i in range(3))
    d0, d1, d2 = (d[:, i:i + 1] for i in range(3))
    if leaf_kind == "tri":
        denom = (d0 * c(0) + d1 * c(1)) + d2 * c(2)
        ron = (o0 * c(0) + o1 * c(1)) + o2 * c(2)
        t = (c(3) - ron) / denom
        w1 = (((o0 * c(4) + o1 * c(5)) + o2 * c(6))
              + t * ((d0 * c(4) + d1 * c(5)) + d2 * c(6))) + c(7)
        w2 = (((o0 * c(8) + o1 * c(9)) + o2 * c(10))
              + t * ((d0 * c(8) + d1 * c(9)) + d2 * c(10))) + c(11)
        w3 = (1.0 - w1) - w2
        ok = (t > eps) & (w1 > 0.0) & (w2 > 0.0) & (w3 > 0.0)
    else:
        ocx, ocy, ocz = o0 - c(0), o1 - c(1), o2 - c(2)
        half_b = (ocx * d0 + ocy * d1) + ocz * d2
        cterm = ((ocx * ocx + ocy * ocy) + ocz * ocz) - c(3)
        disc = half_b * half_b - cterm
        sq = _sqrt_f32(torch.clamp_min(disc, 0.0))
        t_near = (-half_b) - sq
        t = torch.where((t_near < eps) & (c(4) > 1.5), (-half_b) + sq, t_near)
        ok = (disc >= 0.0) & (t > eps)
    slot = torch.arange(SLOTS, device=row.device)
    ok = ok & (slot[None, :] < nslots[:, None])
    pid = row[:, _PRIM_COL:_PRIM_COL + SLOTS].to(torch.int32)
    return torch.where(ok, t, _INF), pid, ok


def _leaf_candidates(row, nslots, o, d, eps, leaf_kind):
    """Best ``(t, prim)`` of one run row per ray (arguments as
    ``_slot_candidates``): the least ``t`` and, among the slots that reach
    it, the least prim id. Returns ``(t f32[R] (+inf: none), prim i32[R])``."""
    t, pid, ok = _slot_candidates(row, nslots, o, d, eps, leaf_kind)
    t_min, _ = torch.min(t, dim=1)
    at_min = ok & (t == t_min[:, None])
    p_min, _ = torch.min(torch.where(at_min, pid, torch.iinfo(torch.int32).max), dim=1)
    return t_min, torch.where(at_min.any(dim=1), p_min, -1)


def _bf16(x):
    """``x`` rounded to the nearest even bfloat16, held as f32: the bf16
    slab test's rounding after every f32 operation."""
    return x.to(torch.bfloat16).to(torch.float32)


def packet_traverse_plain(nodes, entries, runs, ro, rd, t_init, active,
                          eps: float = 1e-4, leaf_kind: str = "tri",
                          stack: int | None = None, slab: str = "hoisted", seeds=None):
    """Plain PyTorch twin of the kernels, on any device: a lockstep walk in
    which every unfinished ray pops one stack entry per step, over the same
    tables, in the same order as K2, with the same f32 operations and tie
    rule. ``slab``: ``'hoisted'`` (``lo*inv - ro*inv``: K2, K3, K5b) or
    ``'direct'`` (``(lo - ro)*inv``: K5a). Returns ``(t, prim, iters)``
    like ``traverse``, ``iters`` per ray; raises on a stack overflow or the
    ``16*M + 64`` step backstop.

    K2's modes, as ``traverse`` takes them:

    - ``seeds`` (K2r, ``RaySeeds``): when ray ``i``'s words set at most 8
      slots, its walk starts from them instead of the root, pushed in
      ``_seed_slots``' order (the rest from the highest slot down, then m2,
      then m1, so m1 pops first): a node code at entry distance +0, a leaf
      run (a treelet that is a leaf) tested at once, an empty slot skipped;
      no slot set, the walk is empty. Leaves at seed time are not pops.
    - a ``bfloat16`` ``nodes`` table (K2h): the hoisted slab test in bf16,
      every operation an f32 operation rounded to the nearest even bf16:
      ``inv16 = bf(1/rd)``, ``roinv16 = bf(ro*inv)``, ``t = bf(bf(lo*inv16) -
      roinv16)``, ``t0``/``t1`` NaN-propagating max/min from ``∓bf(3e38)``,
      entered if ``t1 > bf(t0 - eps16)``, ``t1 > 0`` and ``t0 < bf(bf(t_best)
      + eps16)`` (``eps16 = bf(eps)``); the child's key is ``max(t0, 0)``
      in f32, and the pops' and leaves' checks stay f32."""
    _check(nodes, entries, runs, ro, rd, t_init, active, leaf_kind, seeds=seeds)
    if slab not in ("hoisted", "direct"):
        raise ValueError(f"unknown slab form: {slab!r}")
    bf16 = nodes.dtype == torch.bfloat16
    if bf16 and slab != "hoisted":
        raise ValueError("the bf16 slab test takes the hoisted form")
    if stack is None:
        stack = stack_cap(entries.cpu().numpy())
    n, m = ro.shape[0], nodes.shape[0]
    dev = ro.device
    eps_t = torch.tensor(eps, dtype=torch.float32, device=dev)
    inv = torch.ones_like(rd) / rd
    roinv = ro * inv
    boxes = nodes[:, :6 * WIDTH].to(torch.float32)
    kids = entries[:, :WIDTH]
    if bf16:
        eps16 = _bf16(eps_t)
        inv, roinv = _bf16(inv), _bf16(roinv)
        bmax = _BMAX16
    else:
        bmax = _INF

    t_best = t_init.clone()
    prim_best = torch.full((n,), -1, dtype=torch.int32, device=dev)
    iters = torch.zeros((n,), dtype=torch.int32, device=dev)
    st_code = torch.zeros((n, stack), dtype=torch.int64, device=dev)
    st_t = torch.zeros((n, stack), dtype=torch.float32, device=dev)
    sp = torch.where(active, 0, -1).to(torch.int64)

    def leaf_step(rays, code):
        v = -(code + 1)
        row, cnt = v // _ENC, v % _ENC
        for extra in (0, 1):
            sel = cnt > extra * SLOTS
            r, rr = rays[sel], row[sel] + extra
            t_c, p_c = _leaf_candidates(runs[rr], cnt[sel] - extra * SLOTS,
                                        ro[r], rd[r], eps_t, leaf_kind)
            tb, pb = t_best[r], prim_best[r]
            better = (t_c < tb) | ((t_c == tb) & (p_c >= 0) & (p_c < pb))
            t_best[r] = torch.where(better, t_c, tb)
            prim_best[r] = torch.where(better, p_c, pb)

    if seeds is not None:
        slots, cnt = _seed_slots(seeds.words)
        codes = seeds.codes.to(torch.int64)
        seeded = active & (cnt <= WIDTH)
        sp = torch.where(seeded, -1, sp)
        for j in range(WIDTH):
            code = codes[slots[:, j]]
            take = seeded & (j < cnt)
            push = torch.nonzero(take & (code >= 0)).squeeze(1)
            sp[push] += 1
            if bool((sp[push] >= stack).any()):
                raise RuntimeError("packet traversal: stack overflow (corrupt tables?)")
            st_code[push, sp[push]] = code[push]
            leaf = torch.nonzero(take & (code < 0) & (code != int(_PAD))).squeeze(1)
            leaf_step(leaf, code[leaf])

    for _ in range(16 * m + 64):
        rays = torch.nonzero(sp >= 0).squeeze(1)
        if rays.numel() == 0:
            return t_best, prim_best, iters
        s = sp[rays]
        code = st_code[rays, s]
        t_pop = st_t[rays, s]
        sp[rays] = s - 1
        iters[rays] += 1
        live = t_pop < t_best[rays] + eps_t
        rays, code, s = rays[live], code[live], s[live] - 1

        # slab test of the 8 children
        box = boxes[code]
        t0 = torch.full((rays.numel(), WIDTH), -bmax, device=dev)
        t1 = torch.full((rays.numel(), WIDTH), bmax, device=dev)
        for dim in range(3):
            iv = inv[rays, dim:dim + 1]
            lo, hi = box[:, dim * 8:(dim + 1) * 8], box[:, (3 + dim) * 8:(4 + dim) * 8]
            if slab == "direct":
                o = ro[rays, dim:dim + 1]
                ta, tb = (lo - o) * iv, (hi - o) * iv
            elif bf16:
                riv = roinv[rays, dim:dim + 1]
                ta, tb = _bf16(_bf16(lo * iv) - riv), _bf16(_bf16(hi * iv) - riv)
            else:
                riv = roinv[rays, dim:dim + 1]
                ta, tb = lo * iv - riv, hi * iv - riv
            t0 = torch.maximum(t0, torch.minimum(ta, tb))
            t1 = torch.minimum(t1, torch.maximum(ta, tb))
        ent = kids[code]
        if bf16:
            reach = _bf16(_bf16(t_best[rays, None]) + eps16)
            hit = (t1 > _bf16(t0 - eps16)) & (t1 > 0.0) & (t0 < reach)
        else:
            hit = (t1 > t0 - eps_t) & (t1 > 0.0) & (t0 < t_best[rays, None] + eps_t)
        hit &= ent != int(_PAD)
        key = torch.where(hit, torch.clamp_min(t0, 0.0), _INF)
        skey, slot = torch.sort(key, dim=1, stable=True)  # ties: lower slot
        sent = ent.gather(1, slot).to(torch.int64)
        entered = torch.isfinite(skey)

        # leaf children inline, nearest first
        for k in range(WIDTH):
            sel = entered[:, k] & (sent[:, k] < 0)
            sel &= skey[:, k] < t_best[rays] + eps_t
            if bool(sel.any()):
                leaf_step(rays[sel], sent[sel, k])

        # node children: the nearest lands on top
        is_node = entered & (sent >= 0)
        n_node = is_node.sum(dim=1)
        if bool((s + n_node >= stack).any()):
            raise RuntimeError("packet traversal: stack overflow (corrupt tables?)")
        above = torch.flip(torch.cumsum(torch.flip(is_node, [1]), 1), [1])
        r_idx, k_idx = torch.nonzero(is_node, as_tuple=True)
        pos = s[r_idx] + above[r_idx, k_idx]
        st_code[rays[r_idx], pos] = sent[r_idx, k_idx]
        st_t[rays[r_idx], pos] = skey[r_idx, k_idx]
        sp[rays] = s + n_node
    raise RuntimeError("packet traversal: iteration backstop reached (corrupt tables?)")
