"""Port parity: the strip-packed atlas (``io.texture.pack_strips``,
``sample_bilinear_strips``), the row gathers under it (``ops.row_gather``,
kernels K6a/K6b, whose plain version runs on the CPU) and the l13 stage,
against the JAX package.

Tolerances, with their reasons:

- ``pack_strips``' tables (f32 and bf16 pair rows, ``info``, ``base``,
  ``spr``, the rects): equal byte for byte.
- ``gather_plain`` against ``jnp.take(tab, idx, axis=0)``: equal bit for bit
  (bf16 compared as bits), fill rows included.
- ``sample_bilinear_strips`` against JAX's on the same taps: bit for bit
  (XLA on the CPU keeps the tap's operation order: measured 0 ulp on every
  case), and so for out-of-range texture ids (NaN on a multi-texture atlas,
  rect 0 on a single-texture one).
- The port's strip tap against a literal evaluation of JAX's one-hot
  texel-pair sum in PyTorch: bit for bit, signed zeros included.
- The port's strip tap against its own classic 4-texel tap: 1e-5 relative,
  as the JAX package's own test holds its two taps.
- The l13 stage against JAX's l13 scene rendered the same way:
  ``utils.checks.render_agreement``.
"""

import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learn_path_tracing_tpu.camera import LegacyCamera as JLegacyCamera
from learn_path_tracing_tpu.integrator.wavefront import render as j_render
from learn_path_tracing_tpu.io import exr as jexr
from learn_path_tracing_tpu.io import texture as jtex
from learn_path_tracing_tpu.scene.legacy_world import LegacyWorld as JLegacyWorld
from learn_path_tracing_tpu_torch.io import texture
from learn_path_tracing_tpu_torch.ops import row_gather
from learn_path_tracing_tpu_torch.stages import l13_texture
from learn_path_tracing_tpu_torch.utils.checks import render_agreement

torch.set_num_threads(2)

# the 40x16x8 three-rect atlas of tests/test_legacy.py (test_strip_sampler_
# matches_classic): a rect narrower than a strip, one spanning strips, and
# one of 16 texels, each wrapping in u and v
RECTS = ([[0, 0], [19, 0], [24, 3]], [[19, 16], [24, 5], [40, 11]])
# a 3-channel environment-style atlas for 42-texel strips: one rect of
# several strips, one narrower than a strip
ENV_RECTS = ([[0, 0], [90, 0]], [[90, 20], [120, 14]])


def _atlas(seed, shape, lo=0.0, hi=2.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _both(img, rects, texels, bf16=False):
    low, high = (np.array(r, np.int32) for r in rects)
    mine = texture.pack_strips(img, low, high, texels=texels,
                               dtype=torch.bfloat16 if bf16 else None)
    ref = jtex.pack_strips(img, jnp.asarray(low), jnp.asarray(high), texels=texels,
                           dtype=jnp.bfloat16 if bf16 else None)
    return mine, ref


def _bits(x):
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy().tobytes()
    return np.asarray(x).tobytes()


def _taps(seed, n, k):
    r = np.random.default_rng(seed)
    return (r.integers(0, k, n).astype(np.int32), r.uniform(-0.4, 1.7, n).astype(np.float32),
            r.uniform(-0.4, 1.7, n).astype(np.float32))


def _tap_both(mine, ref, tex, u, v, channels):
    out = texture.sample_bilinear_strips(mine, torch.tensor(tex), torch.tensor(u),
                                         torch.tensor(v), channels=channels).numpy()
    exp = np.asarray(jtex.sample_bilinear_strips(ref, jnp.asarray(tex), jnp.asarray(u),
                                                 jnp.asarray(v), channels=channels))
    return out, exp


# ------------------------------------------------------------ pack_strips --

@pytest.mark.parametrize("max_id", [None, 1, 6])
def test_make_info_arrays_and_clear_match_jax(max_id):
    """``make_info_arrays(configs, max_id)`` equals JAX's arrays (rows past
    the last config, up to ``max_id``, get ``low = 0``, ``high = 1``), and
    ``TextureManager.clear`` empties the configs as JAX's does."""
    managers = [m((64, 32)) for m in (texture.TextureManager, jtex.TextureManager)]
    for m in managers:
        m.add("a", 2, size=(16, 8))
        m.add("b", 0, size=(30, 20))
        m.build()
    (low, high), (jlow, jhigh) = (mod.make_info_arrays(m.configs, max_id=max_id)
                                  for mod, m in zip((texture, jtex), managers))
    assert low.shape == (max(3, (max_id or 0) + 1), 2)
    np.testing.assert_array_equal(low, np.asarray(jlow))
    np.testing.assert_array_equal(high, np.asarray(jhigh))
    for m in managers:
        m.clear()
    assert managers[0].configs == managers[1].configs == []


@pytest.mark.parametrize("channels,texels,bf16", [(8, 16, False), (8, 16, True), (3, 42, False)])
def test_pack_strips_matches_jax(channels, texels, bf16):
    if channels == 8:
        img, rects = _atlas(11, (40, 16, 8)), RECTS
    else:
        img, rects = _atlas(12, (120, 20, 3), 0.0, 40.0), ENV_RECTS
    mine, ref = _both(img, rects, texels, bf16)
    assert mine.table.dtype == (torch.bfloat16 if bf16 else torch.float32)
    assert tuple(mine.table.shape) == ref.table.shape
    for f in ("table", "info_low", "info_high", "base", "spr", "info"):
        assert _bits(getattr(mine, f)) == _bits(getattr(ref, f)), f
    assert mine.table.data_ptr() % row_gather.VEC_BYTES == 0


# ---------------------------------------------------------------- the tap --

@pytest.mark.parametrize("case", ["f32", "bf16", "single", "env"])
def test_strip_tap_matches_jax(case):
    """The same 257 wrapped taps through both samplers: the multi-rect
    material atlas in f32 and bf16, a single-texture atlas (the info row
    broadcast, not gathered) and a 3-channel 42-texel atlas."""
    if case == "env":
        img, rects, texels, channels = _atlas(12, (120, 20, 3), 0.0, 40.0), ENV_RECTS, 42, 3
    elif case == "single":
        img, rects, texels, channels = _atlas(11, (40, 16, 8)), ([[0, 0]], [[19, 16]]), 16, 8
    else:
        img, rects, texels, channels = _atlas(11, (40, 16, 8)), RECTS, 16, 8
    mine, ref = _both(img, rects, texels, bf16=case == "bf16")
    out, exp = _tap_both(mine, ref, *_taps(11, 257, len(rects[0])), channels)
    assert np.isfinite(out).all() and out.std() > 0.1
    assert _bits(torch.tensor(out)) == _bits(torch.tensor(exp))


def test_strip_tap_matches_classic_tap():
    """The port's two taps, as the JAX package holds its own two."""
    img = _atlas(11, (40, 16, 8))
    low, high = (np.array(r, np.int32) for r in RECTS)
    strips = texture.pack_strips(img, low, high, texels=16)
    tex, u, v = (torch.tensor(a) for a in _taps(11, 257, 3))
    fast = texture.sample_bilinear_strips(strips, tex, u, v, channels=8)
    classic = texture.sample_bilinear(torch.tensor(img), torch.tensor(low),
                                      torch.tensor(high), tex, u, v)
    np.testing.assert_allclose(fast.numpy(), classic.numpy(), rtol=1e-5, atol=1e-5)


def test_nearest_tap_matches_jax():
    """The nearest tap on the classic atlas: the same texels, so bit for bit."""
    img = _atlas(11, (40, 16, 8))
    low, high = (np.array(r, np.int32) for r in RECTS)
    tex, u, v = _taps(13, 257, 3)
    out = texture.sample_nearest(torch.tensor(img), torch.tensor(low), torch.tensor(high),
                                 torch.tensor(tex), torch.tensor(u), torch.tensor(v))
    exp = jtex.sample_nearest(jnp.asarray(img), jnp.asarray(low), jnp.asarray(high),
                              jnp.asarray(tex), jnp.asarray(u), jnp.asarray(v))
    assert _bits(out) == _bits(exp)


def _one_hot_tap(atlas, tex, u, v, c):
    """JAX's ``sample_bilinear_strips`` written out op for op in PyTorch:
    the whole strip blended, then the texel pair selected by the one-hot
    sum over the ``stride`` static slices."""
    texels = atlas.table.shape[1] // (2 * c)
    stride = texels - 1
    info = row_gather.gather_plain(atlas.info, tex)
    wpix, hpix, base, spr = info.unbind(1)
    uu = u * wpix.float() - 0.5
    vv = v * hpix.float() - 0.5
    l, b = uu.to(torch.int32), vv.to(torch.int32)
    wl = ((l + 1).float() - uu)[:, None]
    wb = ((b + 1).float() - vv)[:, None]
    lm = texture._imod_f32(l, wpix)
    sx = torch.div(lm, stride, rounding_mode="floor")
    off = lm - sx * stride
    by = texture._imod_f32(b, hpix)
    pair_row = row_gather.gather_plain(atlas.table, (base + by * spr + sx).long())
    tc = texels * c
    row = wb * pair_row[:, :tc].float() + (1.0 - wb) * pair_row[:, tc:].float()
    pair = torch.zeros((u.shape[0], 2 * c))
    for j in range(stride):
        pair = pair + (off == j).float()[:, None] * row[:, j * c:(j + 2) * c]
    return wl * pair[:, :c] + (1.0 - wl) * pair[:, c:]


def test_direct_pair_equals_one_hot_sum():
    """Bit for bit, signed zeros included: texels of both signs with a
    sprinkling of +0 and -0, taps that extrapolate (negative weights)."""
    img = _atlas(5, (40, 16, 8), -2.0, 2.0)
    r = np.random.default_rng(6)
    img[r.uniform(size=img.shape) < 0.2] = 0.0
    img[r.uniform(size=img.shape) < 0.2] = -0.0
    low, high = (np.array(a, np.int32) for a in RECTS)
    strips = texture.pack_strips(img, low, high, texels=16)
    tex, u, v = (torch.tensor(a) for a in _taps(7, 2000, 3))
    got = texture.sample_bilinear_strips(strips, tex, u, v, channels=8)
    ref = _one_hot_tap(strips, tex, u, v, 8)
    assert (got == 0).any() and (got < 0).any()
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


@pytest.mark.parametrize("rects", [RECTS[0][:2], RECTS[0][:1]], ids=["2-rect", "1-rect"])
def test_out_of_range_texture_ids_match_jax(rects):
    """Ids past the last rect and below ``-K``: a NaN tap on a multi-texture
    atlas (the info row is a fill row, and so is the pair row it points
    at), rect 0 on a single-texture atlas (row 0 broadcast); ids in
    ``[-K, 0)`` wrap. Both sides, bit for bit."""
    img = _atlas(11, (40, 16, 8))
    k = len(rects)
    full = (rects, [RECTS[1][i] for i in range(k)])
    mine, ref = _both(img, full, 16)
    tex = np.array([0, k - 1, k, k + 3, 100, -1, -k, -k - 1, 2**20, -2**31], np.int32)
    _, u, v = _taps(3, tex.shape[0], 1)
    out, exp = _tap_both(mine, ref, tex, u, v, 8)
    if k == 1:
        assert np.isfinite(out).all()
        base, _ = _tap_both(mine, ref, np.zeros_like(tex), u, v, 8)
        assert _bits(torch.tensor(out)) == _bits(torch.tensor(base))
    else:
        bad = (tex >= k) | (tex < -k)
        assert np.isnan(out[bad]).all() and np.isfinite(out[~bad]).all()
    assert _bits(torch.tensor(out)) == _bits(torch.tensor(exp))


# ------------------------------------------------------------- row gather --

@pytest.mark.parametrize("dtype", ["f32", "bf16", "i32"])
@pytest.mark.parametrize("index", [torch.int32, torch.int64])
def test_gather_plain_matches_jnp_take(dtype, index):
    r = np.random.default_rng(9)
    rows, n = 37, 300
    if dtype == "i32":
        tab = r.integers(-2**31, 2**31, (rows, 8)).astype(np.int32)
        mine_tab, ref_tab = torch.tensor(tab), jnp.asarray(tab)
    else:
        tab = r.normal(size=(rows, 16)).astype(np.float32)
        ref_tab = jnp.asarray(tab, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
        mine_tab = torch.tensor(tab).to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    idx = np.concatenate([r.integers(0, rows, n), r.integers(-rows, 0, 40),
                          [rows, rows + 1, -rows - 1, 10**6, -10**6, 2**31 - 1, -2**31]])
    idx = idx.astype(np.int64 if index == torch.int64 else np.int32)
    got = row_gather.gather(mine_tab, torch.tensor(idx))
    assert got.dtype == mine_tab.dtype
    exp = np.asarray(jnp.take(ref_tab, jnp.asarray(idx.astype(np.int32)), axis=0))
    assert _bits(got) == _bits(exp)
    oob = (idx >= rows) | (idx < -rows)
    assert oob.sum() == 7 and _bits(got[torch.tensor(oob)]) == _bits(
        row_gather.fill_row(mine_tab.dtype, tab.shape[1]).expand(7, -1).contiguous())


def test_gather_checks_width_and_alignment():
    idx = torch.tensor([0, 1])
    with pytest.raises(ValueError, match="multiple of 16"):
        row_gather.gather(torch.zeros((4, 3)), idx)              # 12-byte rows
    with pytest.raises(ValueError, match="multiple of 16"):
        row_gather.gather(torch.zeros((4, 6), dtype=torch.bfloat16), idx)
    with pytest.raises(ValueError, match="aligned"):
        row_gather.gather(torch.zeros(68)[1:].reshape(1, 67)[:, :64].reshape(4, 16), idx)
    with pytest.raises(ValueError, match="f32, bf16 or i32"):
        row_gather.gather(torch.zeros((4, 4), dtype=torch.float64), idx)
    with pytest.raises(ValueError, match="int32 or int64"):
        row_gather.gather(torch.zeros((4, 4)), idx.float())
    assert row_gather.kernel_for(torch.zeros((1, 32))) == "k6a"            # 128 B
    assert row_gather.kernel_for(torch.zeros((1, 36))) == "k6b"            # 144 B
    assert row_gather.kernel_for(torch.zeros((1, 256), dtype=torch.bfloat16)) == "k6b"
    assert row_gather.gather(torch.zeros((0, 4)), idx).isnan().all()      # empty table
    # on the CPU the plain version runs: no kernel launch is counted
    assert all(v == 0 for v in row_gather.gather.launches.values())


# -------------------------------------------------------------- stage l13 --

def _assets(directory):
    """A small PBR texture set and an HDR EXR under ``<dir>/textures`` at
    the reference's names (the world resizes them to its rects)."""
    from PIL import Image

    d = os.path.join(directory, "textures")
    os.makedirs(d, exist_ok=True)
    r = np.random.default_rng(0)
    y, x = np.mgrid[0:32, 0:32] * (2 * np.pi / 32)
    for name, ch in (("albedo", 3), ("roughness", 1), ("metallic", 1), ("normal", 3)):
        ph = r.uniform(0, 2 * np.pi, (2, ch))
        a = 0.5 + 0.2 * np.sin(x[..., None] + ph[0]) + 0.2 * np.cos(y[..., None] + ph[1])
        a = (a * 255 + 0.5).astype(np.uint8)
        Image.fromarray(a[..., 0] if ch == 1 else a).save(
            os.path.join(d, f"sandyground1_{name}.png"))
    h, w = 32, 64
    ys = np.linspace(0, 1, h, dtype=np.float32)[:, None, None]
    env = np.zeros((h, w, 3), np.float32)
    env[:] = (1 - ys) * np.array([4.0, 2.0, 0.5]) + ys * np.array([0.2, 0.4, 1.5])
    env[:, 20:24] += 3.0
    jexr.write_exr(os.path.join(d, "cayley_interior_2k.exr"), env, half=False,
                   compression="zip")


def test_l13_matches_jax(tmp_path):
    """The stage at 32x18, spp 4, limit 8 on the CPU against JAX's l13
    scene (13_texture.py's sphere, assets, camera) rendered the same way."""
    _assets(str(tmp_path))
    res, spp, limit = (32, 18), 4, 8
    with warnings.catch_warnings():
        warnings.simplefilter("error")                 # both assets load
        img, rep = l13_texture.main(["--device", "cpu", "--assets", str(tmp_path),
                                     "--width", str(res[0]), "--height", str(res[1]),
                                     "--spp", str(spp), "--limit", str(limit),
                                     "--out", str(tmp_path / "l13.png")])
    assert not rep["env_gradient"] and rep["launches"] == {}
    assert torch.equal(img, rep["linear"] ** (1 / 2.2))

    world = JLegacyWorld()
    world.textures.add(str(tmp_path / "textures" / "sandyground1"), 0, size=(2048, 2048))
    world.environments.add(str(tmp_path / "textures" / "cayley_interior_2k.exr"), 0,
                           size=(2048, 1024))
    world.add_sphere((0, 0, 0), 1.0, transparency=0, texture_id=0)
    world.set_environment(0)
    wd = world.build()
    cam = JLegacyCamera(res)
    cam.set_fov(30)
    cam.set_position((13 * 0.3, 2 * 0.3, 3 * 0.3))
    cam.look_at((0, 0, 0))
    jimg, jsegs = j_render(wd, cam.params(), res, spp=spp, limit=limit, seed=0,
                           bsdf="legacy", scene="legacy")
    agree = render_agreement(rep["linear"].numpy(), np.asarray(jimg), rep["segments"],
                             int(jsegs))
    print(agree)
    assert agree["ok"], agree
    assert float(rep["linear"].std()) > 0.01
