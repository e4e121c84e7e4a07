"""The legacy BSDF's dispatch to kernel K7 (``ops.legacy_scatter``), on the
CPU: ``scatter_legacy`` on CPU tensors runs its plain body and never loads
the kernel, its output is the benchmark's frozen plain reference's bit for
bit, the kernel counters list K7, and K7's wrapper refuses operands off its
layout before it touches CUDA. The card cases (K7 against its twin, an l11
frame through it) are in ``test_torch_gpu.py``. This file imports neither
JAX nor the JAX package.
"""

import dataclasses

import pytest
import torch

import chip_smoke
from benchmark.reference import shading
from learn_path_tracing_tpu_torch.bsdf.bsdf import (SCATTERERS, scatter_legacy,
                                                    scatter_legacy_plain)
from learn_path_tracing_tpu_torch.integrator import wavefront as wf
from learn_path_tracing_tpu_torch.ops import build, kernel_counters
from learn_path_tracing_tpu_torch.ops import legacy_scatter as tls
from learn_path_tracing_tpu_torch.stages.l11_bvh import legacy_random_scene, orbit_camera

torch.set_num_threads(2)


@pytest.fixture
def no_kernel(monkeypatch):
    """Fails the test if anything would build, load or launch K7."""
    def touched(*args, **kw):
        raise AssertionError("K7 was touched")

    monkeypatch.setattr(tls, "load_kernel", touched)
    monkeypatch.setattr(build, "load", touched)


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("seed,strided", [(1, False), (2, True), (3, False)])
def test_scatter_legacy_on_the_cpu_is_the_plain_reference(no_kernel, seed, strided):
    """On CPU tensors ``scatter_legacy`` runs the plain body, launches
    nothing, and gives the frozen reference's bits (``benchmark.reference.
    shading.scatter_legacy``, a copy of the body before K7)."""
    rays, hits, base = chip_smoke.legacy_lanes(997, seed, "cpu", strided=strided)
    before = (tls.scatter.launches, tls.scatter.lanes)
    got = scatter_legacy(rays, hits, base)
    assert (tls.scatter.launches, tls.scatter.lanes) == before
    assert SCATTERERS["legacy"] is scatter_legacy
    mat = {f.name: getattr(hits.material, f.name)
           for f in dataclasses.fields(hits.material)}
    want = shading.scatter_legacy(rays.rd, rays.throughput, hits.point, hits.normal, mat, base)
    plain = scatter_legacy_plain(rays, hits, base)
    for field, w in zip(("ro", "rd", "throughput"), want):
        assert torch.equal(_bits(getattr(got, field)), _bits(w)), field
        assert torch.equal(_bits(getattr(plain, field)), _bits(w)), field
    assert got.alive is rays.alive


def test_kernel_counters_list_k7_and_a_cpu_render_launches_none(no_kernel):
    """``kernel_counters()`` has K7's launches and lanes; an l11 render on
    the CPU (the legacy BSDF every pass) adds nothing to them, and its
    stats' ``kernels`` leave K7 out."""
    res = (16, 9)
    wd = legacy_random_scene().device("cpu", use_bvh=True)
    before = kernel_counters()["k7"]
    assert set(before) == {"launches", "lanes"}
    _, _, st = wf.render(wd, orbit_camera(res, 0).params("cpu"), res, 2, limit=4, seed=7,
                         bsdf="legacy", hit_backend="bvh", stats=True)
    assert st["passes"] > 0 and st["spans"]["lpt.bsdf.scatter"][0] == st["passes"]
    assert kernel_counters()["k7"] == before == {"launches": 0, "lanes": 0}
    assert "k7" not in st["kernels"]


def _retyped(rays, hits, base, where, field, fn):
    """The operands with ``fn`` applied to one field of ``rays``,
    ``hits``, ``hits.material`` or to ``base``."""
    if where == "base":
        return rays, hits, fn(base)
    if where == "material":
        mat = dataclasses.replace(hits.material, **{field: fn(getattr(hits.material, field))})
        return rays, dataclasses.replace(hits, material=mat), base
    obj = {"rays": rays, "hits": hits}[where]
    new = dataclasses.replace(obj, **{field: fn(getattr(obj, field))})
    return (new, hits, base) if where == "rays" else (rays, new, base)


@pytest.mark.parametrize("where,field,fn,message", [
    ("rays", "rd", lambda x: x.double(), "rd must be torch.float32"),
    ("rays", "throughput", lambda x: x[:, :2], r"throughput must be torch.float32\[50, 3\]"),
    ("hits", "normal", lambda x: x[:-1], r"normal must be torch.float32\[50, 3\]"),
    ("hits", "point", lambda x: x.to("meta"), "point is on meta"),
    ("material", "albedo", lambda x: x.half(), "albedo must be torch.float32"),
    ("material", "ior", lambda x: x[:, None], r"ior must be torch.float32\[50\]"),
    ("material", "absorptivity", lambda x: x.to("meta"), "absorptivity is on meta"),
    ("base", None, lambda x: x.to(torch.int32), "base must be a torch.int64"),
    ("base", None, lambda x: x[:, None], "base must be a torch.int64"),
    ("base", None, lambda x: 12345, "base must be a torch.int64.*got int"),
    ("base", None, lambda x: x, "no kernel for device cpu"),
])
def test_legacy_scatter_wrapper_refuses_before_touching_cuda(no_kernel, where, field, fn,
                                                             message):
    """K7's wrapper raises ``ValueError`` for a wrong dtype, shape or device
    (CPU operands included: the kernel runs only on the card) before it
    builds, loads or launches anything."""
    operands = _retyped(*chip_smoke.legacy_lanes(50, 4, "cpu"), where, field, fn)
    with pytest.raises(ValueError, match=message):
        tls.scatter(*operands)
