"""The mega engine: ``render_persistent(engine='mega')`` and its pass
``mega_pass``, which on CPU tensors runs kernel K4's plain version
(``integrator.persistent.bounce_pass_plain``), against the JAX package, on
the CPU at a small size (the cover scene at 32x18, spp 4, limit 8).

Tolerances, with their reasons:

- The JAX package's own mega engine against its modular engine (the
  reference-side test the JAX package lacks): ``utils.checks.
  render_agreement``. The megakernel's polynomial acos and expanded
  quadratic move a few discrete events.
- ``pack_camera`` against JAX's: within 4 ulps of the largest magnitude
  (the same f32 operations; XLA contracts multiply-adds).
- One ``mega_pass`` (over the state's lane list, in place) against JAX's
  ``bounce_pass(interpret=True)`` from the same state, a primary one and
  one after three passes: the integer rows
  (k, bounce) and the alive row equal on every lane (measured: 0 lanes
  differ), the contributions within 1e-6 (they depend only on the input
  ray; measured 6e-8). Positions within 1e-2 of ``max(|ro|, 1)`` on every
  lane and within 1e-3 on 95 % of them (measured at most 4.3e-3 and
  5.3e-4): the TPU kernel's expanded quadratic loses about 1e-3 relative in
  ``t`` on the r=10000 ground. Directions within 5e-2 on every lane and
  1e-3 on 95 % (measured 1.2e-2 and 7.4e-4), throughputs within 5e-3 and
  1e-4 on 99 % (measured 1.2e-3 and 4.3e-5): its polynomial acos
  (|err| <= 6.7e-5) is amplified by slerp's 1/sin ω near parallel
  directions, and the Fresnel weight follows the perturbed normal.
- The port's mega engine against its modular engine: segments equal and
  the image bit for bit. Both run the one ``step``, on two lane layouts,
  and both deposit into the order-free int64 fixed-point accumulator.
- Passes over the shrinking lane list (``LaneList``, in place) against the
  all-lanes passes: every state row, live count and deposit bit for bit
  after every pass. Each lane's arithmetic is its own, the deposits are
  integer adds, and a settled dead lane's rows are a fixed point of a pass.
- The port's mega engine against JAX's mega and modular engines:
  ``render_agreement`` (segments within 0.5 %, mean difference at most 1 %
  of the mean, 80 % of pixels within 1e-4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learn_path_tracing_tpu import camera as jcam
from learn_path_tracing_tpu.integrator.persistent import render_persistent as j_render_persistent
from learn_path_tracing_tpu.models import random_scene as j_random_scene
from learn_path_tracing_tpu.models import stage10_camera as j_stage10_camera
from learn_path_tracing_tpu.ops import bounce_megakernel as jmk
from learn_path_tracing_tpu_torch import camera as tcam
from learn_path_tracing_tpu_torch.bsdf.sampling import sum3
from learn_path_tracing_tpu_torch.camera.camera import generate_rays_for_pixels
from learn_path_tracing_tpu_torch.core.types import Rays
from learn_path_tracing_tpu_torch.integrator import persistent as tper
from learn_path_tracing_tpu_torch.integrator.persistent import (bounce_pass_plain, mega_pass,
                                                                render_persistent)
from learn_path_tracing_tpu_torch.models import random_scene, stage10_camera
from learn_path_tracing_tpu_torch.ops import bounce_megakernel as mk
from learn_path_tracing_tpu_torch.ops.sphere_scan import intersect_spheres_scan_plain
from learn_path_tracing_tpu_torch.scene import world as tworld
from learn_path_tracing_tpu_torch.utils.checks import render_agreement

torch.set_num_threads(2)

RES = (32, 18)
N = RES[0] * RES[1]
SPP, LIMIT = 4, 8
SEED = 20230328
JAX_LANES = jmk.RAY_BLOCK   # the TPU kernel's state is padded to its block


@pytest.fixture(scope="module")
def port_world():
    return random_scene(seed=SEED).device("cpu"), stage10_camera(RES).params("cpu")


@pytest.fixture(scope="module")
def jax_world():
    return j_random_scene(seed=SEED).device(), j_stage10_camera(RES).params()


@pytest.fixture(scope="module")
def jax_renders(jax_world):
    """JAX's mega (Pallas interpret mode) and modular renders, once."""
    wd, cp = jax_world
    out = {}
    for engine in ("mega", "modular"):
        img, segs = j_render_persistent(wd, cp, RES, spp=SPP, limit=LIMIT, engine=engine)[:2]
        out[engine] = (np.asarray(img), float(segs))
    return out


@pytest.fixture(scope="module")
def port_mega(port_world):
    wd, cp = port_world
    img, segs, st = render_persistent(wd, cp, RES, spp=SPP, limit=LIMIT, engine="mega",
                                      stats=True)
    return img, segs, st


def test_jax_mega_matches_jax_modular(jax_renders):
    (m_img, m_segs), (p_img, p_segs) = jax_renders["mega"], jax_renders["modular"]
    rep = render_agreement(m_img, p_img, m_segs, p_segs)
    assert rep["ok"], rep
    assert m_img.shape == (32, 18, 3) and 0.2 < m_img.mean() < 0.8


def _camera_pair(kind):
    cams = []
    for mod in (jcam, tcam):
        if kind == "stage10":
            cams.append((j_stage10_camera if mod is jcam else stage10_camera)(RES))
            continue
        c = mod.Camera(RES, fov=40.0)
        c.set_position((1.5, 2.0, -3.0))
        c.set_direction(35.0, -12.0, 7.5)
        c.set_len(focal_length=4.0, aperture=0.3)
        cams.append(c)
    return cams[0].params(), cams[1].params("cpu")


@pytest.mark.parametrize("kind", ["stage10", "rolled"])
def test_pack_camera_matches_jax(kind):
    jp, tp = _camera_pair(kind)
    want = np.asarray(jmk.pack_camera(jp, RES))
    got = mk.pack_camera(tp, RES).numpy()
    assert got.dtype == want.dtype == np.float32 and got.shape == (16,)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=4 * np.spacing(np.float32(np.abs(want).max())))
    # the unpacked frame is what the twin's thin-lens regeneration reads
    f = mk.unpack_camera(torch.as_tensor(got))
    assert torch.equal(f.direction, torch.as_tensor(got[3:6]))
    assert float(f.focal_length) == got[15] and float(f.half_aperture) == got[14]


def _state_after(port_world, passes):
    wd, cp = port_world
    scalf = mk.pack_camera(cp, RES)
    stf, sti = mk.initial_state(cp, RES, SPP, 0)
    lanes = mk.LaneList.of_state(stf, sti)
    for _ in range(passes):
        mega_pass(stf, sti, wd, scalf, 0, RES, SPP, lanes, limit=LIMIT)
        lanes.advance()
    return stf, sti


def _pass_from(port_world, stf, sti, acc=None):
    """One ``mega_pass`` from ``(stf, sti)`` on a copy, over the state's
    lane list → ``(stf', sti', live)``."""
    wd, cp = port_world
    stf2, sti2 = stf.clone(), sti.clone()
    lanes = mk.LaneList.of_state(stf2, sti2)
    mega_pass(stf2, sti2, wd, mk.pack_camera(cp, RES), 0, RES, SPP, lanes, limit=LIMIT,
              acc=acc)
    return stf2, sti2, lanes.advance()


def _share_within(diff, tol):
    return float((diff <= tol).mean())


@pytest.mark.parametrize("passes", [0, 3], ids=["primary", "mid"])
def test_bounce_pass_matches_jax(port_world, jax_world, passes):
    stf, sti = _state_after(port_world, passes)
    stf2, sti2, live = _pass_from(port_world, stf, sti)

    jwd, jcp = jax_world
    table, attrs = jmk.pack_scene(jwd)
    j_stf = np.zeros((16, JAX_LANES), np.float32)
    j_sti = np.zeros((8, JAX_LANES), np.int32)
    j_stf[:, :N], j_sti[:, :N] = stf.numpy(), sti.numpy()
    o_stf, o_sti = jmk.bounce_pass(jnp.asarray(j_stf), jnp.asarray(j_sti), table, attrs,
                                   jmk.pack_camera(jcp, RES), jnp.asarray([0], jnp.int32),
                                   RES, SPP, limit=LIMIT, interpret=True)
    o_stf, o_sti = np.asarray(o_stf)[:, :N], np.asarray(o_sti)[:, :N]
    p_stf, p_sti = stf2.numpy(), sti2.numpy()

    np.testing.assert_array_equal(p_sti[mk.K:mk.BOUNCE + 1], o_sti[:2])
    np.testing.assert_array_equal(p_stf[mk.ALIVE], o_stf[jmk._ALIVE])
    assert live == int((o_stf[jmk._ALIVE] > 0.5).sum())
    np.testing.assert_allclose(p_stf[mk.CONTRIB:mk.CONTRIB + 3],
                               o_stf[jmk._CONTRIB:jmk._CONTRIB + 3], rtol=0, atol=1e-6)
    assert not p_stf[13:].any() and not o_stf[13:].any()

    scale = np.maximum(np.abs(p_stf[0:3]).max(0), 1.0)
    ro = np.abs(p_stf[0:3] - o_stf[0:3]).max(0) / scale
    rd = np.abs(p_stf[3:6] - o_stf[3:6]).max(0)
    thp = np.abs(p_stf[6:9] - o_stf[6:9]).max(0)
    assert ro.max() <= 1e-2 and _share_within(ro, 1e-3) >= 0.95, np.quantile(ro, [0.95, 1])
    assert rd.max() <= 5e-2 and _share_within(rd, 1e-3) >= 0.95, np.quantile(rd, [0.95, 1])
    assert thp.max() <= 5e-3 and _share_within(thp, 1e-4) >= 0.99, np.quantile(thp, [0.99, 1])


@pytest.mark.parametrize("seed", [0, -1])     # -1 wraps to 0xFFFFFFFF, as in core.rng
def test_mega_matches_modular(port_world, seed):
    wd, cp = port_world
    a_img, a_segs = render_persistent(wd, cp, RES, spp=SPP, limit=LIMIT, seed=seed)
    b_img, b_segs = render_persistent(wd, cp, RES, spp=SPP, limit=LIMIT, seed=seed,
                                      engine="mega")
    assert a_segs == b_segs and isinstance(b_segs, int)
    assert torch.equal(a_img.view(torch.int32), b_img.view(torch.int32))


def test_mega_matches_jax(port_mega, jax_renders):
    img, segs, _ = port_mega
    for engine in ("mega", "modular"):
        j_img, j_segs = jax_renders[engine]
        rep = render_agreement(img.numpy(), j_img, segs, j_segs)
        assert rep["ok"], (engine, rep)


def _counts(st):
    """The stats with each span's count and not its host seconds, which
    vary from run to run."""
    return {**st, "spans": {k: count for k, (count, _) in st["spans"].items()}}


def test_mega_runs_are_bitwise_identical(port_world, port_mega):
    wd, cp = port_world
    img, segs, st = render_persistent(wd, cp, RES, spp=SPP, limit=LIMIT, engine="mega",
                                      stats=True)
    assert (segs, _counts(st)) == (port_mega[1], _counts(port_mega[2]))
    assert torch.equal(img, port_mega[0])


def test_mega_pass_count(port_world):
    """With limit 1 every path ends at its first hit or escape, so each pass
    advances every lane by one item: spp passes of n segments each."""
    wd, cp = port_world
    _, segs, st = render_persistent(wd, cp, RES, spp=SPP, limit=1, engine="mega",
                                    stats=True)
    assert _counts(st) == {"passes": SPP, "listed": [N] * SPP, "host_reads": SPP + 2,
                           "kernels": {}, "spans": {"lpt.render.mega": 1,
                                                    "lpt.sync": SPP + 2}}
    assert segs == N * SPP


@pytest.mark.parametrize("kw,match", [
    ({"bsdf": "diffuse"}, "bsdf"),
    ({"camera_model": "jitter"}, "camera_model"),
    ({"scene": "legacy"}, "scene"),
    ({"hit_backend": "xla"}, "hit_backend"),
    ({"spp": 5}, "spp"),                       # 5 does not divide 32*18
])
def test_mega_rejects_what_it_cannot_render(port_world, kw, match):
    wd, cp = port_world
    args = {"spp": SPP, "limit": LIMIT, **kw}
    with pytest.raises(ValueError, match=match):
        render_persistent(wd, cp, RES, engine="mega", **args)


def test_bounce_pass_deposits_and_counts(port_world):
    """The deposit adds round(contrib * 2**32) at pixel g + k*(n/spp) of
    the input k, the live count is the alive row's, and a CPU pass launches
    no kernel."""
    stf, sti = _state_after(port_world, 2)
    acc = torch.zeros((N, 3), dtype=torch.int64)
    before = mk.bounce_pass.launches
    stf2, sti2, live = _pass_from(port_world, stf, sti, acc)
    assert mk.bounce_pass.launches == before
    lane = torch.arange(N)
    pixel = lane // SPP + sti[mk.K].long() * (N // SPP)
    contrib = stf2[mk.CONTRIB:mk.CONTRIB + 3].T
    escaped = contrib.abs().sum(1) > 0
    assert bool(escaped.any()) and int(pixel[escaped].max()) < N
    want = torch.zeros((N, 3), dtype=torch.int64)
    want.index_add_(0, pixel[escaped], torch.round(contrib[escaped] * 2.0 ** 32).long())
    assert torch.equal(acc, want)
    assert live == int(stf2[mk.ALIVE].sum())
    # dead lanes keep their counter and hit nothing
    dead = stf[mk.ALIVE] == 0
    assert torch.equal(sti2[mk.K][dead], sti[mk.K][dead])
    assert bool((sti2[mk.OBJ][dead] == -1).all())


@pytest.mark.parametrize("pass_fn", [mega_pass, mk.bounce_pass], ids=["mega_pass", "kernel"])
def test_bounce_pass_checks_its_operands(port_world, pass_fn):
    wd, cp = port_world
    stf, sti = mk.initial_state(cp, RES, SPP, 0)
    scalf = mk.pack_camera(cp, RES)
    lanes = mk.LaneList.of_state(stf, sti)
    with pytest.raises(ValueError, match="sti"):
        pass_fn(stf, sti.to(torch.int64), wd, scalf, 0, RES, SPP, lanes)
    with pytest.raises(ValueError, match="stf"):
        pass_fn(stf[:, :-SPP], sti, wd, scalf, 0, RES, SPP, lanes)
    with pytest.raises(ValueError, match="acc"):
        pass_fn(stf, sti, wd, scalf, 0, RES, SPP, lanes, acc=torch.zeros((N, 3)))
    with pytest.raises(ValueError, match="spp"):
        pass_fn(stf, sti, wd, scalf, 0, RES, 7, lanes)
    with pytest.raises(ValueError, match="lanes"):
        pass_fn(stf, sti, wd, scalf, 0, RES, SPP, mk.LaneList.of_state(stf[:, :SPP],
                                                                       sti[:, :SPP]))


def test_kernel_takes_no_cpu_state(port_world):
    """K4's wrapper launches on CUDA tensors only: a CPU state raises rather
    than running the plain version, which ``mega_pass`` picks by device."""
    wd, cp = port_world
    stf, sti = mk.initial_state(cp, RES, SPP, 0)
    before = mk.bounce_pass.launches
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        mk.bounce_pass(stf, sti, wd, mk.pack_camera(cp, RES), 0, RES, SPP,
                       mk.LaneList.of_state(stf, sti))
    assert mk.bounce_pass.launches == before


def test_mega_schedule_is_the_grouped_pool_of_all_lanes():
    """The mega layout is the grouped schedule with pool = n and no drain:
    lane L's item k is pixel L // spp + k * (n / spp), valid for k < spp."""
    sched = tper.mega_schedule(N, SPP)
    assert sched == tper.Schedule(True, N, SPP, ())
    item_of = tper.item_fn(sched, N, SPP, "cpu")
    lane = torch.arange(N)
    for k in range(SPP + 1):
        valid, pixel, sample = item_of(torch.full((N,), k))
        assert bool((valid == (k < SPP)).all())
        assert torch.equal(pixel, torch.clamp_max(lane // SPP + k * (N // SPP), N - 1))
        assert torch.equal(sample, lane % SPP)


def test_initial_state_is_the_modular_primary(port_world):
    _, cp = port_world
    stf, sti = mk.initial_state(cp, RES, SPP, 5)
    lane = torch.arange(N)
    rays = generate_rays_for_pixels(cp, RES, lane // SPP, 5, lane % SPP)
    assert torch.equal(stf[mk.RO:mk.RO + 3].T, rays.ro)
    assert torch.equal(stf[mk.RD:mk.RD + 3].T, rays.rd)
    assert bool((stf[mk.THP:mk.ALIVE + 1] == 1).all()) and not stf[mk.CONTRIB:].any()
    assert not sti.any()


def test_sum3_is_the_cpu_sum_order():
    """The written-out 3-sums of the sphere path add as torch.sum does on
    the CPU, so they changed no CPU result."""
    v = torch.as_tensor(np.random.default_rng(3).normal(size=(4099, 3)).astype(np.float32))
    p = v * v
    assert torch.equal(sum3(p)[:, 0], torch.sum(p, dim=-1))
    assert not torch.equal(sum3(p)[:, 0], (p[:, 0] + p[:, 2]) + p[:, 1])   # the order matters


def test_hit_record_of_the_plain_scan_is_the_cpu_hit(port_world):
    """The plain version's hit (the plain scan and ``hit_record``) is
    ``world.hit``'s on the CPU, materials included."""
    wd, cp = port_world
    rays = generate_rays_for_pixels(cp, RES, torch.arange(N), 0, 0)
    rays = Rays(ro=rays.ro, rd=rays.rd, throughput=rays.throughput, alive=rays.alive)
    a = tworld.hit(wd, rays)
    b = tworld.hit_record(rays, *intersect_spheres_scan_plain(rays.ro, rays.rd, wd.scan_table,
                                                              wd.scan_attrs))
    assert bool(a.hit.any()) and bool((~a.hit).any())
    for name in ("t", "point", "normal", "obj", "hit"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    for name in ("albedo", "roughness", "metallic", "ior", "transparency", "absorptivity"):
        assert torch.equal(getattr(a.material, name), getattr(b.material, name)), name


def test_lane_list_passes_equal_the_all_lanes_passes(port_world):
    """K4's list contract, through its plain version: a whole render run
    over the shrinking lane list, in place, gives the all-lanes pass's state
    after every pass (every row, bit for bit), the same live counts and the
    same deposits. The list holds the lanes alive on entry first, then, for
    one pass, those that died in the pass before; at the end the only lanes
    a pass would still change are those that died in the last one."""
    wd, cp = port_world
    scalf = mk.pack_camera(cp, RES)
    stf, sti = mk.initial_state(cp, RES, SPP, 0)
    l_stf, l_sti = stf.clone(), sti.clone()
    accs = [torch.zeros((N, 3), dtype=torch.int64) for _ in range(2)]
    lanes = mk.LaneList.of_state(l_stf, l_sti)
    assert (lanes.count, lanes.alive) == (N, N)
    counts, live, passes = [], N, 0
    while live > 0:
        alive_in = stf[mk.ALIVE] > 0.5
        listed = lanes.lanes[:lanes.count].long()
        assert torch.equal(torch.sort(listed[:lanes.alive]).values,
                           torch.nonzero(alive_in).flatten())
        assert not bool(alive_in[listed[lanes.alive:]].any())
        stf, sti, want = bounce_pass_plain(stf, sti, wd, scalf, 0, RES, SPP, limit=LIMIT,
                                           acc=accs[0])
        mega_pass(l_stf, l_sti, wd, scalf, 0, RES, SPP, lanes, limit=LIMIT, acc=accs[1])
        assert torch.equal(l_stf.view(torch.int32), stf.view(torch.int32)), passes
        assert torch.equal(l_sti, sti), passes
        counts.append(lanes.count)
        live = lanes.advance()
        assert live == int(want), passes
        passes += 1
    assert torch.equal(accs[0], accs[1])
    assert counts == sorted(counts, reverse=True) and counts[-1] < N
    end = mk.LaneList.of_state(l_stf, l_sti)
    assert (end.count, end.alive) == (lanes.count, 0) and end.count > 0
    assert torch.equal(torch.sort(end.lanes[:end.count]).values,
                       torch.sort(lanes.lanes[:lanes.count]).values)


def test_lane_list_needs_the_pass_after_death(port_world):
    """Dropping the lanes that just died from the list (listing only the
    alive ones) leaves their contributions and spheres in the state, so the
    state differs from the all-lanes pass's: the one pass after death is
    what keeps the contract."""
    wd, cp = port_world
    scalf = mk.pack_camera(cp, RES)
    stf, sti = mk.initial_state(cp, RES, SPP, 0)
    lanes = mk.LaneList.of_state(stf, sti)
    while not lanes.count > lanes.alive > 0:      # the first pass after deaths
        stf, sti, _ = bounce_pass_plain(stf, sti, wd, scalf, 0, RES, SPP, limit=LIMIT)
        lanes = mk.LaneList.of_state(stf, sti)
    alive_only = mk.LaneList(lanes.lanes, lanes.alive, lanes.alive)
    want = bounce_pass_plain(stf, sti, wd, scalf, 0, RES, SPP, limit=LIMIT)
    full, short = (stf.clone(), sti.clone()), (stf.clone(), sti.clone())
    mega_pass(*full, wd, scalf, 0, RES, SPP, lanes, limit=LIMIT)
    mega_pass(*short, wd, scalf, 0, RES, SPP, alive_only, limit=LIMIT)
    assert torch.equal(full[0], want[0]) and torch.equal(full[1], want[1])
    assert not (torch.equal(short[0], want[0]) and torch.equal(short[1], want[1]))
