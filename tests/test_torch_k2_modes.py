"""Port parity: K2's two modes and the sort keys of the packet traversal,
on the CPU, where each mode runs its kernel's plain twin
(``ops.packet_traverse.packet_traverse_plain``):

- the treelet restart (K2r): ``treelet_seed_codes``, the entered words of
  ``_treelet_entry_key(want_mask=True)``, the JAX package's block seed rows
  (``seed_rows``) and ``packet_traverse_sorted(restart=True)`` against the
  JAX package's (``_kernel_v2``'s ``seed_init`` in Pallas interpret mode),
  which the port seeds from each ray's own treelets (``RaySeeds``);
- the premise of K2h's packed bf16x2 slab test: a bf16 product or
  difference computed in f32 and rounded once to bf16 is the correctly
  rounded bf16 result (``test_bf16_double_rounding_is_innocuous``);
- the bf16 slabs (K2h): ``nodes_to_bf16`` and the walk over its table
  against the JAX package's bf16 kernel in interpret mode;
- the Morton key (``sort_key='morton'``) and the JAX package's checks of
  ``sort_key``, ``restart`` and ``nstacks``.

Inputs: the JAX package's own restart test input
(``tests/test_packet_traverse.py:184``: 40 triangles, 2,048 rays), a tree
whose top two levels are full (600 triangles), so that blocks of coherent
rays are seeded with nodes, and the same with a far triangle, a leaf child
of the root, whose seed row holds its leaf code; and (``_many_beams``) 64
narrow beams into the full tree, so that each ray enters at most 8
treelets but every 1024-ray block more: the port seeds the rays where the
JAX package's blocks walk from the root. In both packages an empty
treelet slot has the box ``lo = +inf, hi = -inf``, which the key's slab
test enters for every ray (``t0 = -inf``, ``t1 = +inf``), so a tree with
empty slots in its top two levels gets a block seed row only where at
most 8 slots are entered in all: the JAX test input's rows all hold 0,
which the seed-row test states. ``RaySeeds`` drops the empty slots from
each ray's words, so the port seeds its rays there too.

Tolerances, with their reasons:

- Seed codes, entered words, keys, seed rows, per-ray seeds, the sort
  permutation, ``entered_n`` and ``nodes_to_bf16``'s bytes: exact. The
  double-rounding premise: bit for bit on every finite and infinite
  result, NaN for NaN.
- Hits against the JAX package: ``prim`` and hit/miss equal on at least
  99.9 % of rays, each difference an exact tie or a grazing edge, ``t``
  within 1e-5 relative (``test_torch_packet._agree``): XLA on the CPU
  contracts the kernel's multiply-adds into FMAs, the port rounds every
  operation. For the bf16 walk's ray sets also within 2e-6 absolute: a hit
  near the origin (``t`` ~ 0.09) loses the FMA's extra bits to the
  cancellation in ``d - ro.n`` (the f32 twin shows the same difference on
  these rays). XLA rounds every bf16 operation of the slab test to bf16,
  as the port defines it (``test_xla_rounds_each_bf16_slab_operation``),
  so the bf16 walk is held to the f32 walk's tolerance.
- The restart against the root walk, and a coherence sort against lane
  order: ``(t, prim)`` bit for bit. The bf16 walk against the f32 walk on
  these sets: bit for bit too (the outward-rounded boxes only widen the
  walk; the bf16 rounding of the ray terms could narrow it for a ray
  within ~2^-8 of a box face, which these sets do not reach).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from learn_path_tracing_tpu.accel.bvh import build_bvh as j_build_bvh
from learn_path_tracing_tpu.accel.wide import collapse as j_collapse
from learn_path_tracing_tpu.ops import packet_traverse as jpt
from learn_path_tracing_tpu_torch.ops import packet_traverse as tpt
from test_torch_packet import _agree, _jax, _port, _rays, _tri_explain, _tri_tables

torch.set_num_threads(2)

N_RAYS = 2048


def _cluster(seed, t_count, far):
    """``t_count`` small triangles around the origin; with ``far`` the last
    one moved 60 units along x, where the root keeps it as a leaf child."""
    r = np.random.default_rng(seed)
    v0 = r.normal(size=(t_count, 3)).astype(np.float32) * 3
    v1 = v0 + r.normal(size=(t_count, 3)).astype(np.float32) * 0.3
    v2 = v0 + r.normal(size=(t_count, 3)).astype(np.float32) * 0.3
    if far:
        for v in (v0, v1, v2):
            v[-1] += np.float32([60, 0, 0])
    return v0, v1, v2


def _beam(r, n, origin, target, spread):
    ro = np.repeat(np.float32(origin)[None], n, 0)
    rd = (np.float32(target) - ro + r.normal(size=(n, 3)).astype(np.float32) * spread)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return ro, rd.astype(np.float32)


def _case(name):
    """``(v, tables, ro, rd, active)`` of a named input."""
    if name == "jax test input":       # tests/test_packet_traverse.py:184
        np_rng = np.random.default_rng(1234)
        base = np_rng.normal(size=(40, 3)).astype(np.float32) * 3
        v = (base, base + np_rng.normal(size=(40, 3)).astype(np.float32),
             base + np_rng.normal(size=(40, 3)).astype(np.float32))
        max_leaf = 4
        ro = np_rng.normal(size=(N_RAYS, 3)).astype(np.float32) * 4
        rd = np_rng.normal(size=(N_RAYS, 3)).astype(np.float32)
        rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
        active = np_rng.random(N_RAYS) < 0.9
    else:
        far = name == "leaf child"
        v = _cluster(0, 600, far)
        max_leaf = 4
        r = np.random.default_rng(3)
        half = N_RAYS // 2
        if far:   # one beam on the far triangle, one through the cluster
            target = (v[0][-1] + v[1][-1] + v[2][-1]) / 3
            a = _beam(r, half, target + np.float32([0.5, 30, 0.5]), target, 0.3)
            b = _beam(r, half, (5.0, 40, 3.0), (5.0, 0, 3.0), 0.01)
        else:     # two beams, each entering at most 3 treelets
            a = _beam(r, half, (5.0, 40, 3.0), (5.0, 0, 3.0), 0.01)
            b = _beam(r, half, (4.0, 40, 5.0), (4.0, 0, 5.0), 0.05)
        ro, rd = (np.concatenate(x) for x in zip(a, b))
        active = r.random(N_RAYS) < 0.9
    plow = np.minimum(np.minimum(v[0], v[1]), v[2])
    phigh = np.maximum(np.maximum(v[0], v[1]), v[2])
    flat = j_build_bvh(plow, phigh, centroid=(v[0] + v[1] + v[2]) / 3, max_depth=12,
                       max_leaf=max_leaf, backend="numpy")
    tables = [np.asarray(x) for x in jpt.pack_packet_tables(j_collapse(flat), *v)]
    return v, tables, ro, rd.astype(np.float32), active


CASES = ["jax test input", "full tree", "leaf child"]


@pytest.fixture(scope="module", params=CASES)
def case(request):
    return request.param, _case(request.param)


def _t(*xs):
    return [torch.as_tensor(np.array(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def test_seed_codes_and_entry_words_match_jax(case):
    name, (_, tables, ro, rd, _) = case
    nodes, entries = tables[:2]
    codes = tpt.treelet_seed_codes(nodes, entries)
    np.testing.assert_array_equal(codes, np.asarray(jpt.treelet_seed_codes(*_j(nodes, entries))))
    assert codes.dtype == np.int32 and codes.shape == (64,)
    if name == "leaf child":        # a root child that is a leaf holds its own slot
        leaf = np.flatnonzero(entries[0, :8] < 0)
        assert len(leaf) == 1 and codes[leaf[0] * 8] == entries[0, leaf[0]]
    treelets = jpt.treelet_boxes(*_j(nodes, entries))
    jkey, jw0, jw1 = jpt._treelet_entry_key(*_j(nodes, entries, ro, rd), eps=1e-4,
                                            treelets=treelets, want_mask=True)
    key, w0, w1 = tpt._treelet_entry_key(*_t(ro, rd), tuple(_t(*map(np.asarray, treelets))),
                                         eps=1e-4, want_mask=True)
    np.testing.assert_array_equal(key.numpy(), np.asarray(jkey))
    np.testing.assert_array_equal(w0.numpy(), np.asarray(jw0).astype(np.int64))
    np.testing.assert_array_equal(w1.numpy(), np.asarray(jw1).astype(np.int64))


def _jax_seed_rows(tables, ro, rd, active, monkeypatch):
    """The seed rows the JAX package hands its kernel, captured at
    ``_kernel_call`` (eagerly, the kernel not run)."""
    seen = {}

    def capture(nodes, entries, runs, rays, eps, interpret, version=2, nstacks=1,
                entered=None, leaf_kind="tri", seed_rows=None):
        seen["rows"] = np.asarray(seed_rows)
        n_pad = rays.shape[1]
        return (jnp.full((1, n_pad), jnp.inf), jnp.full((1, n_pad), -1, jnp.int32),
                jnp.zeros((1, n_pad), jnp.int32))

    monkeypatch.setattr(jpt, "_kernel_call", capture)
    with jax.disable_jit():
        jpt.packet_traverse_sorted(*_j(*tables, ro, rd, active), restart=True, version=2)
    return seen["rows"]


def _sorted_words(tables, ro, rd, active):
    """``(order, active_s, tkey_s, w0_s, w1_s)``: the port's restart order
    and the sorted rays' treelet keys and entered words (0 for inactive
    rays), as ``sorted_rays(restart=True)`` computes them."""
    nodes, entries, ro_t, rd_t, act = _t(tables[0], tables[1], ro, rd, active)
    order, active_s, _, _ = tpt.sorted_rays(nodes, entries, ro_t, rd_t, act, restart=True)
    tkey, w0, w1 = tpt._treelet_entry_key(ro_t, rd_t, tpt._treelets(nodes, entries, "cpu"),
                                          eps=1e-4, want_mask=True)
    w0_s, w1_s = (torch.where(active_s, w[order], 0) for w in (w0, w1))
    return order, active_s, tkey[order], w0_s, w1_s


def _port_seed_rows(tables, ro, rd, active, monkeypatch):
    """``seed_rows`` of the port's sorted words: the rows the JAX package's
    blocks would take."""
    _, _, _, w0_s, w1_s = _sorted_words(tables, ro, rd, active)
    return tpt.seed_rows(w0_s, w1_s, tpt.treelet_seed_codes(*tables[:2])).numpy()


def test_seed_rows_match_jax(case, monkeypatch):
    name, (_, tables, ro, rd, active) = case
    rows = _port_seed_rows(tables, ro, rd, active, monkeypatch)
    np.testing.assert_array_equal(rows, _jax_seed_rows(tables, ro, rd, active, monkeypatch))
    assert rows.shape == (N_RAYS // 1024, 16) and rows.dtype == np.int32
    cnt = rows[:, 8]
    if name == "jax test input":     # every slot of its empty subtrees is entered
        assert (cnt == 0).all()
        return
    seeded = (cnt >= 1) & (cnt <= 8)
    seeds = np.concatenate([r[:c] for r, c in zip(rows[seeded], cnt[seeded])])
    if name == "full tree":          # every block seeded, with nodes
        assert seeded.all() and (seeds >= 0).any()
    else:                            # the far beam's block: the leaf, tested at seed time
        assert ((seeds < 0) & (seeds != tpt._PAD)).any()


def test_restart_twin_matches_jax_and_the_root_walk(case):
    """K2r's twin: the JAX package's restart walk (``prim`` and hit/miss to
    the stated tolerance, the sort bit for bit) and the port's root walk
    (bit for bit)."""
    _, (v, tables, ro, rd, active) = case
    j = jpt.packet_traverse_sorted(*_j(*tables, ro, rd, active), interpret=True, version=2,
                                   restart=True)
    p = tpt.packet_traverse_sorted(*_t(*tables, ro, rd, active), restart=True)
    root = tpt.packet_traverse_sorted(*_t(*tables, ro, rd, active))
    np.testing.assert_array_equal(p[5].numpy(), np.asarray(j[5]))
    assert int(p[4]) == int(j[4])
    for a, b in zip(p[:4], root[:4]):
        assert torch.equal(a, b)
    order = p[5].numpy()
    tp, pp, tj, pj = p[0].numpy(), p[1].numpy(), np.asarray(j[0]), np.asarray(j[1])
    hits = _agree(tp, pp, tj, pj, _tri_explain(v, ro[order], rd[order], tp, pp, tj, pj))
    assert hits > 50


def test_seeded_walk_checks_its_rows():
    """``traverse(seeds=RaySeeds)``'s checks, and its words' rules: more
    than 8 slots set is a root walk, none an empty walk, and slots whose
    code is empty are skipped."""
    _, tables = _tri_tables(1, 200, 4)
    ro, rd, ti, active = _rays(1, 1500)
    args = _t(*tables, ro, rd, ti, active)
    codes = torch.as_tensor(tpt.treelet_seed_codes(*tables[:2]))
    words = torch.zeros((1500, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="seeds must be"):
        tpt.traverse(*args, seeds=torch.zeros((2, 16), dtype=torch.int32))
    with pytest.raises(ValueError, match="seeds.words must be"):
        tpt.traverse(*args, seeds=tpt.RaySeeds(words[:1], codes))
    with pytest.raises(ValueError, match="v2 kernel"):
        tpt.traverse(*args, seeds=tpt.RaySeeds(words, codes), version=1)
    t0, p0, i0 = tpt.traverse(*args)
    words[:, :2] = -1                                   # all 64 slots: a root walk
    t, p, it = tpt.traverse(*args, seeds=tpt.RaySeeds(words, codes))
    assert torch.equal(t, t0) and torch.equal(p, p0) and torch.equal(it, i0)
    words[:, :2] = 0                                    # none: nothing walked
    t, p, it = tpt.traverse(*args, seeds=tpt.RaySeeds(words, codes))
    assert torch.equal(t, args[5]) and (p == -1).all() and (it == 0).all()
    words[:, 0] = 0xFF                                  # 8 slots, all empty codes
    t, p, it = tpt.traverse(*args, seeds=tpt.RaySeeds(words, torch.full_like(codes, tpt._PAD)))
    assert torch.equal(t, args[5]) and (p == -1).all() and (it == 0).all()


def test_ray_seeds_are_each_rays_own_treelets(case):
    """``sorted_rays(restart=True)``'s seeds: each sorted ray's entered
    words with the empty slots dropped, its nearest two slots from the key,
    and the tables' codes; every case seeds most of its active rays."""
    name, (_, tables, ro, rd, active) = case
    order, active_s, tkey_s, w0_s, w1_s = _sorted_words(tables, ro, rd, active)
    _, _, _, seeds = tpt.sorted_rays(*_t(tables[0], tables[1], ro, rd, active), restart=True)
    codes = tpt.treelet_seed_codes(*tables[:2])
    np.testing.assert_array_equal(seeds.codes.numpy(), codes)
    real = np.flatnonzero(codes != tpt._PAD)
    mask = sum(1 << int(b) for b in real)
    words = seeds.words.numpy()
    np.testing.assert_array_equal(words[:, 0].view(np.uint32), w0_s.numpy() & (mask & 0xFFFFFFFF))
    np.testing.assert_array_equal(words[:, 1].view(np.uint32), w1_s.numpy() & (mask >> 32))
    none = tkey_s.numpy() == 65 * 65
    np.testing.assert_array_equal(words[:, 2], np.where(none, 64, tkey_s.numpy() // 65))
    np.testing.assert_array_equal(words[:, 3], np.where(none, 64, tkey_s.numpy() % 65))
    count = np.unpackbits(words[:, :2].copy().view(np.uint8), axis=1).sum(axis=1)
    np.testing.assert_array_equal(seeds.counts().numpy(), count)
    seeded = active_s.numpy() & (count <= 8)
    assert seeded.sum() > 0.9 * active_s.numpy().sum()
    if name == "jax test input":     # no block row, yet the rays are seeded
        assert (_port_seed_rows(tables, ro, rd, active, None)[:, 8] == 0).all()


def _many_beams():
    """The full tree under 64 narrow beams from above, one a 32-ray group in
    lane order, aimed at points spread over the cluster: each ray enters at
    most 8 treelets, but every 1024-ray block of the sorted rays enters
    more, so the JAX package's rows walk every block from the root."""
    v, tables, _, _, _ = _case("full tree")
    r = np.random.default_rng(8)
    targets = r.normal(size=(64, 3)).astype(np.float32) * 3
    parts = [_beam(r, N_RAYS // 64, tgt + np.float32([0.2, 40, 0.2]), tgt, 0.002)
             for tgt in targets]
    ro, rd = (np.concatenate(x) for x in zip(*parts))
    active = r.random(N_RAYS) < 0.9
    return v, tables, ro, rd.astype(np.float32), active


def test_rays_are_seeded_where_their_block_is_not():
    """(b): the per-ray seeds on rays whose 1024-ray blocks enter more than
    8 treelets: the JAX package's rows seed no block, the port seeds the
    rays, and the seeded walk is the root walk bit for bit (with fewer
    pops) and the JAX package's restart walk to the stated tolerance."""
    v, tables, ro, rd, active = _many_beams()
    rows = _port_seed_rows(tables, ro, rd, active, None)
    assert (rows[:, 8] == 0).all()
    args = _t(*tables, ro, rd, active)
    order, active_s, _, seeds = tpt.sorted_rays(args[0], args[1], *args[3:], restart=True)
    seeded = active_s & (seeds.counts() <= 8)
    assert int(seeded.sum()) > 0.9 * int(active_s.sum())
    p = tpt.packet_traverse_sorted(*args, restart=True)
    root = tpt.packet_traverse_sorted(*args)
    for a, b in zip(p[:4], root[:4]):
        assert torch.equal(a, b)
    ro_s, rd_s = args[3][order], args[4][order]
    inf = torch.full((N_RAYS,), float("inf"))
    _, _, it_seeded = tpt.traverse(*args[:3], ro_s, rd_s, inf, active_s, seeds=seeds)
    _, _, it_root = tpt.traverse(*args[:3], ro_s, rd_s, inf, active_s)
    assert int(it_seeded.sum()) < int(it_root.sum())
    j = jpt.packet_traverse_sorted(*_j(*tables, ro, rd, active), interpret=True, version=2,
                                   restart=True)
    np.testing.assert_array_equal(p[5].numpy(), np.asarray(j[5]))
    tp, pp, tj, pj = p[0].numpy(), p[1].numpy(), np.asarray(j[0]), np.asarray(j[1])
    o = order.numpy()
    assert _agree(tp, pp, tj, pj, _tri_explain(v, ro[o], rd[o], tp, pp, tj, pj)) > 200


# ------------------------------------------------------------- bf16 slabs --

def test_nodes_to_bf16_matches_jax_and_contains_the_f32_boxes():
    _, tables = _tri_tables(2, 250, 8)
    nodes = tables[0].copy()
    # the edge cases of outward rounding: signed zeros, values exact in bf16,
    # the smallest normal and subnormal floats, one ulp either side of a tie
    special = np.float32([0.0, -0.0, 1.0, -1.0, 1.17549435e-38, -1.4e-45, 1.0 + 2 ** -8,
                          1.0 + 2 ** -7 + 2 ** -20, 3.0e38, -3.0e38, np.inf, -np.inf])
    nodes[0, :len(special)] = special
    nodes[0, 24:24 + len(special)] = special
    out = tpt.nodes_to_bf16(nodes)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == nodes.shape
    ref = np.asarray(jpt.nodes_to_bf16(nodes)).view(np.uint16)
    np.testing.assert_array_equal(out.view(torch.int16).numpy().view(np.uint16), ref)
    back = out.to(torch.float32).numpy()
    assert (back[:, :24] <= nodes[:, :24]).all() and (back[:, 24:48] >= nodes[:, 24:48]).all()
    np.testing.assert_array_equal(back[:, 48:], nodes[:, 48:].astype(ml_dtypes.bfloat16)
                                  .astype(np.float32))


def test_xla_rounds_each_bf16_slab_operation():
    """The JAX kernel's bf16 slab terms (``lo*inv16 - roinv16``, ``t0 -
    eps16``, ``t_best + eps16``) as XLA computes them on the CPU equal an
    op-by-op oracle (each f32 result rounded to the nearest even bf16):
    the rounding the port's twin and K2h define."""
    r = np.random.default_rng(0)
    n = 100_000
    bf = ml_dtypes.bfloat16
    lo = (r.normal(size=n) * 5).astype(bf)
    inv = (1 / r.normal(size=n)).astype(np.float32).astype(bf)
    roinv = (r.normal(size=n) * 3).astype(np.float32).astype(bf)
    t0 = (r.normal(size=n) * 3).astype(bf)
    eps16 = jnp.bfloat16(1e-4)
    got = jax.jit(lambda a, b, c, d: (a * b - c, d - eps16, d + eps16))(lo, inv, roinv, t0)

    def rn(x):
        return np.asarray(x, np.float32).astype(bf).view(np.uint16)

    f = np.float32
    want = (rn(rn(lo.astype(f) * inv.astype(f)).view(bf).astype(f) - roinv.astype(f)),
            rn(t0.astype(f) - f(eps16)), rn(t0.astype(f) + f(eps16)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g).view(np.uint16), w)
    # and the port's constants are the kernel's
    assert tpt._BMAX16 == float(jnp.bfloat16(3.0e38))
    assert float(tpt._bf16(torch.tensor(1e-4))) == float(eps16)


def _bf16_correctly_rounded(x):
    """f64 values rounded once to the nearest even bf16 (8 significant bits,
    subnormal step 2^-133, overflow to inf), as f32: the reference that a
    native bf16 operation must give."""
    with np.errstate(over="ignore", invalid="ignore"):
        _, e = np.frexp(x)
        step = np.ldexp(1.0, np.maximum(e - 8, -133))
        r = np.where(np.isfinite(x), np.rint(x / step) * step, x)
        return r.astype(np.float32)


@pytest.mark.parametrize("op", ["mul", "sub"])
def test_bf16_double_rounding_is_innocuous(op):
    """(c) The premise of K2h's packed slab test: for bf16 ``a``, ``b``, the
    f32 result of ``a*b`` or ``a - b`` rounded to the nearest even bf16
    (the twin's and XLA's op-by-op form) is the correctly rounded bf16
    result that Hopper's ``mul.rn.bf16x2``/``sub.rn.bf16x2`` give (24 >= 2*8
    + 2 significant bits, and the f32 grid is 16 bits finer than bf16's in
    the subnormal range too). Held on 300,000 random bit patterns (every
    exponent, subnormals, infinities and NaNs among them), 100,000 pairs
    whose results lie about the smallest normal, and on every pair
    of edge values: signed zeros, the extreme subnormals, the smallest
    normal, one, values near -/+bf(3e38) and the largest finite bf16, and
    the infinities. Bit for bit; a NaN result must be NaN on both sides
    (its payload is never read: a NaN slab term fails every comparison)."""
    bf = ml_dtypes.bfloat16
    r = np.random.default_rng(13)
    bits = r.integers(0, 1 << 16, size=(2, 300_000), dtype=np.uint32).astype(np.uint16)
    # and 100,000 pairs whose results lie about the smallest normal: the
    # exponent fields near 63 (products) or near 0 (differences)
    lo, hi = (56, 69) if op == "mul" else (0, 4)
    near = ((r.integers(0, 2, size=(2, 100_000)) << 15) | (r.integers(lo, hi, size=(2, 100_000))
            << 7) | r.integers(0, 128, size=(2, 100_000))).astype(np.uint16)
    bits = np.concatenate([bits, near], axis=1)
    a, b = bits[0].view(bf), bits[1].view(bf)
    edge = np.float32([0.0, -0.0, 2.0 ** -133, -2.0 ** -133, 2.0 ** -126 - 2.0 ** -133,
                       2.0 ** -126, -2.0 ** -126, 1.0, -1.0, 3.0e38, -3.0e38, 1.5,
                       3.3895314e38, -3.3895314e38, 2.0 ** 64, 2.0 ** -64, np.inf, -np.inf,
                       np.nan]).astype(bf)
    ea, eb = np.meshgrid(edge, edge)
    a, b = np.concatenate([a, ea.ravel()]), np.concatenate([b, eb.ravel()])
    fn = (lambda x, y: x * y) if op == "mul" else (lambda x, y: x - y)
    with np.errstate(all="ignore"):
        twin = fn(a.astype(np.float32), b.astype(np.float32)).astype(bf)
        want = _bf16_correctly_rounded(fn(a.astype(np.float64), b.astype(np.float64))).astype(bf)
    nan = np.isnan(want.astype(np.float32))
    np.testing.assert_array_equal(np.isnan(twin.astype(np.float32)), nan)
    np.testing.assert_array_equal(twin.view(np.uint16)[~nan], want.view(np.uint16)[~nan])
    # the sets reach every class the slab test can meet
    res = want.astype(np.float32)[~nan]
    tiny = np.abs(res) < 2.0 ** -126
    assert (tiny & (res != 0)).sum() > 10_000 and np.isinf(res).sum() > 100
    assert (np.signbit(res) & (res == 0)).any() and (~np.signbit(res) & (res == 0)).any()


@pytest.mark.parametrize("version", [2, 1, 3])
@pytest.mark.parametrize("max_leaf,t_init,inactive", [(4, False, False), (8, True, True)])
def test_bf16_twin_matches_jax(version, max_leaf, t_init, inactive):
    """K2h's twin (version 2) against the JAX package's bf16 kernel; versions
    1 and 3 walk the table widened to f32, as the JAX package's v1 and v3
    kernels promote it. Every hit is also the f32 tables' hit."""
    v, tables = _tri_tables(3 + max_leaf, 300, max_leaf)
    ro, rd, ti, active = _rays(11 + max_leaf, 1200, t_init=t_init, inactive=inactive)
    nb = tpt.nodes_to_bf16(tables[0])
    jnb = jnp.asarray(nb.view(torch.int16).numpy().view(ml_dtypes.bfloat16))
    t, p = tpt.packet_traverse(nb, *_t(tables[1], tables[2], ro, rd, ti, active),
                               version=version)
    tj, pj = jpt.packet_traverse(jnb, *_j(tables[1], tables[2], ro, rd, ti, active),
                                 interpret=True, sort_rays=False, version=version)
    tp, pp, tj, pj = t.numpy(), p.numpy(), np.asarray(tj), np.asarray(pj)
    assert _agree(tp, pp, tj, pj, _tri_explain(v, ro, rd, tp, pp, tj, pj), atol=2e-6) > 100
    tf, pf = _port(tables, ro, rd, ti, active, version=version)
    np.testing.assert_array_equal(pp, pf)
    np.testing.assert_array_equal(tp.view(np.int32), tf.view(np.int32))
    if version != 2:   # the widened table, bit for bit
        t2, p2 = tpt.packet_traverse(nb.to(torch.float32), *_t(tables[1], tables[2], ro, rd,
                                                                ti, active), version=version)
        assert torch.equal(t, t2) and torch.equal(p, p2)


def _bf16_walk_oracle(nodes16, entries, runs, ro, rd, ti, active, eps=1e-4):
    """K2h's walk in numpy, one ray at a time, every bf16 operation an f32
    operation rounded by ml_dtypes to the nearest even bf16 (the leaf test
    is the twin's ``_leaf_candidates``: this checks the walk and the slab
    test). Returns ``(t, prim, iters)``."""
    f, bf = np.float32, ml_dtypes.bfloat16

    def rn(x):
        return np.asarray(x, f).astype(bf).astype(f)

    boxes = nodes16[:, :48].astype(f).reshape(-1, 6, 8)
    eps_f = f(eps)
    eps16, bmax = rn(eps_f), rn(f(3.0e38))
    runs_t = torch.as_tensor(runs)
    t_out, p_out, i_out = ti.astype(f).copy(), np.full(len(ro), -1, np.int32), np.zeros(
        len(ro), np.int32)
    for i in np.flatnonzero(active):
        tb, pb, it = f(ti[i]), -1, 0
        inv = f(1) / rd[i]
        inv16, roinv16 = rn(inv), rn(ro[i] * inv)
        stack = [(0, f(0))]
        while stack:
            code, t_pop = stack.pop()
            it += 1
            if not t_pop < tb + eps_f:
                continue
            t0, t1 = np.full(8, -bmax, f), np.full(8, bmax, f)
            for d in range(3):
                ta = rn(rn(boxes[code, d] * inv16[d]) - roinv16[d])
                tc = rn(rn(boxes[code, 3 + d] * inv16[d]) - roinv16[d])
                t0, t1 = np.maximum(t0, np.minimum(ta, tc)), np.minimum(t1, np.maximum(ta, tc))
            ent = entries[code, :8]
            hit = ((t1 > rn(t0 - eps16)) & (t1 > 0) & (t0 < rn(rn(tb) + eps16))
                   & (ent != tpt._PAD))
            key = np.maximum(t0, f(0))
            order = sorted(np.flatnonzero(hit), key=lambda c: (key[c], c))
            for c in order:
                if ent[c] >= 0 or not key[c] < tb + eps_f:
                    continue
                v = -(int(ent[c]) + 1)
                row, cnt = v // 64, v % 64
                for extra in range(2 if cnt > 8 else 1):
                    tc_, pc = tpt._leaf_candidates(
                        runs_t[row + extra][None], torch.tensor([min(cnt - 8 * extra, 8)]),
                        torch.as_tensor(ro[i:i + 1]), torch.as_tensor(rd[i:i + 1]),
                        torch.tensor(eps_f), "tri")
                    tc_, pc = f(tc_[0]), int(pc[0])
                    if tc_ < tb or (tc_ == tb and 0 <= pc < pb):
                        tb, pb = tc_, pc
            for c in reversed([c for c in order if ent[c] >= 0]):
                stack.append((int(ent[c]), key[c]))
        t_out[i], p_out[i], i_out[i] = tb, pb, it
    return t_out, p_out, i_out


def _surface_rays(v, n, seed):
    """Rays from triangle centroids in random directions: bounce rays, whose
    bf16 ray terms are far coarser than their short hits."""
    r = np.random.default_rng(seed)
    k = r.integers(len(v[0]), size=n)
    ro = ((v[0][k] + v[1][k] + v[2][k]) / 3).astype(np.float32)
    rd = r.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return ro, rd.astype(np.float32)


@pytest.mark.parametrize("rays", ["surface", "random"])
def test_bf16_twin_is_the_oracle(rays):
    """K2h's twin against the numpy oracle, bit for bit in ``(t, prim,
    iters)``."""
    v, tables, _, _, _ = _case("full tree")
    if rays == "surface":
        ro, rd = _surface_rays(v, 300, 1)
        ti, active = np.full(300, np.inf, np.float32), np.ones(300, bool)
    else:
        ro, rd, ti, active = _rays(6, 300, scale=4.0, t_init=True, inactive=True)
    nb = tpt.nodes_to_bf16(tables[0])
    t, p, it = tpt.traverse(nb, *_t(tables[1], tables[2], ro, rd, ti, active))
    to, po, io = _bf16_walk_oracle(nb.to(torch.float32).numpy().astype(ml_dtypes.bfloat16),
                                   tables[1], tables[2], ro, rd, ti, active)
    np.testing.assert_array_equal(p.numpy(), po)
    np.testing.assert_array_equal(t.numpy().view(np.int32), to.view(np.int32))
    np.testing.assert_array_equal(it.numpy(), io)
    assert (po >= 0).sum() > 10


def test_bf16_surface_rays_against_jax():
    """Bounce rays, where the bf16 slab test loses hits: the JAX package's
    bf16 kernel walks a 1024-ray packet, every lane slab-testing every node
    any lane entered, so near a box face a lane gets chances its own walk
    did not give it. Away from the faces (rays whose bf16 walk finds the f32
    walk's hit, or its miss) the two agree to the stated tolerance; every
    other ray is counted, and none that the port hits does JAX miss."""
    v, tables, _, _, _ = _case("full tree")
    ro, rd = _surface_rays(v, 2048, 2)
    ti, active = np.full(2048, np.inf, np.float32), np.ones(2048, bool)
    nb = tpt.nodes_to_bf16(tables[0])
    t, p = tpt.packet_traverse(nb, *_t(tables[1], tables[2], ro, rd, ti, active))
    tf, pf = _port(tables, ro, rd, ti, active)
    tj, pj = jpt.packet_traverse(jnp.asarray(nb.view(torch.int16).numpy().view(
        ml_dtypes.bfloat16)), *_j(tables[1], tables[2], ro, rd, ti, active),
        interpret=True, sort_rays=False)
    tp, pp, tj, pj = t.numpy(), p.numpy(), np.asarray(tj), np.asarray(pj)
    away = (pp == pf) & ((tp == tf) | (pp < 0))
    print(f"{int(away.sum())} of 2048 rays away from box faces; f32 hits {(pf >= 0).sum()}, "
          f"bf16 {(pp >= 0).sum()}, JAX bf16 {(pj >= 0).sum()}")
    assert away.sum() > 1000
    sel = np.flatnonzero(away)
    _agree(tp[sel], pp[sel], tj[sel], pj[sel],
           _tri_explain(v, ro[sel], rd[sel], tp[sel], pp[sel], tj[sel], pj[sel]), atol=2e-6)
    assert not ((pp >= 0) & (pj < 0)).any()


def test_bf16_restart_combines_both_modes():
    """K2rh's twin: the bf16 walk seeded; on these beams bit for bit the
    bf16 root walk. (Not so in general: the seeds skip the top two levels'
    bf16 slab tests, so near a box face a seeded walk can reach a hit that
    the root walk's bf16 tests lost, as in the JAX package.)"""
    _, tables, ro, rd, active = _case("full tree")
    args = [tpt.nodes_to_bf16(tables[0]), *_t(tables[1], tables[2], ro, rd, active)]
    a = tpt.packet_traverse_sorted(*args, restart=True)
    b = tpt.packet_traverse_sorted(*args)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert int((a[1] >= 0).sum()) > 50


def test_modes_are_k2_modes():
    _, tables = _tri_tables(1, 60, 4)
    ro, rd, ti, active = _rays(2, 64)
    nb = tpt.nodes_to_bf16(tables[0])
    with pytest.raises(ValueError, match="modes of K2"):
        tpt.traverse(nb, *_t(tables[1], tables[2], ro, rd, ti, active), leaf_kind="sphere")
    assert tpt.kernel_of("tri", 2, seeded=True) == "k2r"
    assert tpt.kernel_of("tri", 2, bf16=True) == "k2h"
    assert tpt.kernel_of("tri", 2, True, True) == "k2rh"
    assert tpt.kernel_of("tri", 1, bf16=True) == "k5a"
    assert set(tpt.traverse.launches) >= {"k2", "k2r", "k2h", "k2rh", "k3", "k5a", "k5b"}


# ------------------------------------------------------ sort keys and checks --

def test_morton_key_matches_jax_and_keeps_hits_exact():
    v, tables = _tri_tables(2, 250, 8)
    ro, rd, ti, active = _rays(31, 3000, t_init=True, inactive=True)
    jkey = jpt._coherence_key(*_j(*tables[:2], ro, rd), kind="morton")
    key = tpt._coherence_key(*_t(tables[0], ro, rd), None, kind="morton")
    np.testing.assert_array_equal(key.numpy(), np.asarray(jkey))
    assert len(np.unique(key.numpy())) > 100
    for version in (1, 2, 3):
        lane = _port(tables, ro, rd, ti, active, version=version)
        t, p = tpt.packet_traverse(*_t(*tables, ro, rd, ti, active), sort_rays=True,
                                   sort_key="morton", version=version)
        np.testing.assert_array_equal(p.numpy(), lane[1])
        np.testing.assert_array_equal(t.numpy().view(np.int32), lane[0].view(np.int32))
    with pytest.raises(ValueError, match="unknown sort key"):
        tpt.packet_traverse(*_t(*tables, ro, rd, ti, active), sort_rays=True, sort_key="x")


def test_the_jax_packages_checks_raise():
    _, tables = _tri_tables(1, 60, 4)
    ro, rd, ti, active = _rays(2, 64)
    args = _t(*tables, ro, rd, ti, active)
    sargs = _t(*tables, ro, rd, active)
    with pytest.raises(ValueError, match="requires sort_key='treelet'"):
        tpt.packet_traverse_sorted(*sargs, sort_key="morton")
    for version in (1, 3):
        with pytest.raises(ValueError, match="restart seeding requires the v2 kernel"):
            tpt.packet_traverse_sorted(*sargs, restart=True, version=version)
        with pytest.raises(ValueError, match="nstacks > 1 requires version=2"):
            tpt.packet_traverse(*args, nstacks=2, version=version)
    for nstacks in (3, 0, 2048):
        with pytest.raises(ValueError, match="must divide block 1024"):
            tpt.packet_traverse(*args, nstacks=nstacks)


@pytest.mark.parametrize("nstacks", [2, 8, 1024])
def test_nstacks_takes_jax_values_and_returns_the_walk(nstacks):
    """Every divisor of 1024 gives the one-stack result, as ``_kernel_v2``
    does for every value (its sub-packets only interleave the walks); the
    JAX kernel with 2 sub-packets agrees to the stated tolerance."""
    v, tables = _tri_tables(4, 120, 4)
    ro, rd, ti, active = _rays(5, 1024, t_init=True, inactive=True)
    ref = _port(tables, ro, rd, ti, active)
    t, p = tpt.packet_traverse(*_t(*tables, ro, rd, ti, active), nstacks=nstacks)
    np.testing.assert_array_equal(p.numpy(), ref[1])
    np.testing.assert_array_equal(t.numpy().view(np.int32), ref[0].view(np.int32))
    if nstacks == 2:
        tj, pj = jpt.packet_traverse(*_j(*tables, ro, rd, ti, active), interpret=True,
                                     sort_rays=False, nstacks=2)
        tp, pp, tj, pj = ref[0], ref[1], np.asarray(tj), np.asarray(pj)
        _agree(tp, pp, tj, pj, _tri_explain(v, ro, rd, tp, pp, tj, pj))
        np.testing.assert_array_equal(np.asarray(pj), np.asarray(_jax(tables, ro, rd, ti,
                                                                      active)[1]))
