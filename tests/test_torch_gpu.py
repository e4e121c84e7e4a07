"""Card-only tests of the port (marker ``gpu``): they skip where
``torch.cuda.is_available()`` is false. This file imports neither JAX nor
the JAX package, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_gpu.py -m gpu -q

Tolerances: the sphere-scan kernel equals its plain twin bit for bit (the
same IEEE-rounded operations in the same order); a GPU render equals a
rerun bit for bit (fixed-point accumulation); a GPU render agrees with the
CPU render within ``utils.checks.render_agreement``'s bounds (the
transcendental functions of the two devices differ by ulps).
"""

import numpy as np
import pytest
import torch

from learn_path_tracing_tpu_torch.integrator.persistent import render_persistent
from learn_path_tracing_tpu_torch.models import random_scene, stage10_camera
from learn_path_tracing_tpu_torch.ops import sphere_scan as tss
from learn_path_tracing_tpu_torch.utils.checks import render_agreement

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return "cuda"


def _setup(seed, n, s, device):
    r = np.random.default_rng(seed)
    ro = (r.normal(size=(n, 3)) * 2).astype(np.float32)
    rd = r.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    centers = (r.normal(size=(s, 3)) * 3).astype(np.float32)
    radii = r.uniform(0.05, 1.0, size=s).astype(np.float32)
    radii[::13] = 0.0                                   # padding rows
    transparency = (r.uniform(size=s) < 0.3).astype(np.float32)
    attrs = r.normal(size=(s, 16)).astype(np.float32)

    def t(a):
        return torch.as_tensor(a, device=device)

    table = tss.pack_spheres(t(centers), t(radii), t(transparency))
    return t(ro), t(rd.astype(np.float32)), table, t(attrs)


# ray counts off the 256-thread block; sphere counts inside one shared-memory
# chunk and across two (1024 spheres per chunk)
@pytest.mark.parametrize("n,s", [(1, 1), (1000, 512), (5000, 1500)])
def test_kernel_matches_twin_bitwise(cuda, n, s):
    args = _setup(n + s, n, s, cuda)
    before = tss.intersect_spheres_scan.launches
    t, idx, attr = tss.intersect_spheres_scan(*args)
    assert tss.intersect_spheres_scan.launches == before + 1
    t2, idx2, attr2 = tss.intersect_spheres_scan_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(t.view(torch.int32), t2.view(torch.int32))
    assert torch.equal(idx, idx2) and torch.equal(attr, attr2)


def test_kernel_rejects_non_contiguous(cuda):
    ro, rd, table, attrs = _setup(0, 64, 32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        tss.intersect_spheres_scan(ro, rd.t().contiguous().t(), table, attrs)


def test_gpu_render_is_deterministic_and_matches_cpu(cuda):
    res = (48, 27)
    world = random_scene(seed=20230328)
    cam = stage10_camera(res)
    runs = [render_persistent(world.device(cuda), cam.params(cuda), res, spp=4, limit=8)
            for _ in range(2)]
    assert runs[0][1] == runs[1][1] and torch.equal(runs[0][0], runs[1][0])
    cpu_img, cpu_segs = render_persistent(world.device("cpu"), cam.params("cpu"), res,
                                          spp=4, limit=8)
    rep = render_agreement(runs[0][0].cpu().numpy(), cpu_img.numpy(), runs[0][1], cpu_segs)
    assert rep["ok"], rep
