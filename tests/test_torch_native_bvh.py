"""The port's native (C++) SAH builder (``accel.native``), its numpy builder
and the JAX package's ``build_bvh``: the same arrays byte for byte (values,
dtypes and ``max_leaf``), on random AABB sets and on the stand-in mesh of
``models.standin``. The C++ builder is compiled here with the system's
``g++`` (the card machine's host builds it the same way)."""

import numpy as np
import pytest

from learn_path_tracing_tpu.accel.bvh import build_bvh as j_build_bvh
from learn_path_tracing_tpu_torch.accel import native
from learn_path_tracing_tpu_torch.accel.bvh import build_bvh
from learn_path_tracing_tpu_torch.models.standin import STANDIN_SEED, standin_mesh

FIELDS = ("left", "right", "low", "high", "data", "cut", "prim")


def _random_prims(n, seed):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(n, 3)).astype(np.float32) * 5
    ext = rng.uniform(0.05, 1.0, size=(n, 3)).astype(np.float32)
    return base - ext, base + ext


def _same(a, b):
    for f in FIELDS:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes(), f
    assert (a.max_depth, a.max_leaf) == (b.max_depth, b.max_leaf)


@pytest.mark.parametrize("n,max_depth,max_leaf", [
    (1, 16, 4), (5, 16, 4), (5, 1, 1), (1000, 12, 4), (1000, 24, 1), (1000, 6, 8),
    (20000, 16, 4), (20000, 24, 8)])
def test_native_numpy_and_jax_builders_agree(n, max_depth, max_leaf):
    plow, phigh = _random_prims(n, seed=n + max_depth)
    kw = dict(max_depth=max_depth, max_leaf=max_leaf)
    a = build_bvh(plow, phigh, backend="native", **kw)
    _same(a, build_bvh(plow, phigh, backend="numpy", **kw))
    _same(a, j_build_bvh(plow, phigh, backend="numpy", **kw))


def test_standin_mesh_level_3():
    mesh = standin_mesh(3, STANDIN_SEED)
    tri = mesh.positions[mesh.face_p]
    args = (tri.min(axis=1), tri.max(axis=1))
    kw = dict(centroid=tri.mean(axis=1), max_depth=24, max_leaf=8)
    a = build_bvh(*args, backend="native", **kw)
    assert a.prim.shape[0] == tri.shape[0] > 1000
    _same(a, build_bvh(*args, backend="numpy", **kw))
    _same(a, j_build_bvh(*args, backend="numpy", **kw))


def test_auto_takes_the_native_builder():
    plow, phigh = _random_prims(64, seed=1)
    before = native.builds
    _same(build_bvh(plow, phigh), build_bvh(plow, phigh, backend="numpy"))
    assert native.builds == before + 1


def test_native_available_matches_jax():
    """The JAX package's answer (``tests/test_native_bvh.py`` skips on its
    False): both build with the system's ``g++``."""
    from learn_path_tracing_tpu.accel.native import native_available as j_native_available

    assert native.native_available() is j_native_available()


def test_native_raises_without_the_compiler(monkeypatch, tmp_path):
    """With no compiler and no built library, ``native_available()`` is
    False, 'native' raises and 'auto' falls back to the numpy builder."""
    monkeypatch.setattr(native, "CXX", "no-such-compiler-g++")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    assert native.native_available() is False
    plow, phigh = _random_prims(100, seed=2)
    with pytest.raises(RuntimeError, match="no-such-compiler-g\\+\\+"):
        build_bvh(plow, phigh, backend="native")
    _same(build_bvh(plow, phigh), build_bvh(plow, phigh, backend="numpy"))
    with pytest.raises(ValueError, match="backend"):
        build_bvh(plow, phigh, backend="cuda")


def test_library_is_named_by_source_and_flags(monkeypatch):
    path = native.library_path()
    assert path.parent == native.BUILD_DIR and path.name.startswith("bvh_builder_")
    assert "-march=native" not in native.CXX_FLAGS
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-g",))
    assert native.library_path() != path
