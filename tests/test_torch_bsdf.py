"""Port parity: sampling primitives and BSDF scatter of
learn_path_tracing_tpu_torch against the JAX package's, on identical
numpy-seeded uniforms, rays, hits and RNG bases.

Tolerance: 2e-6 absolute on unit vectors and throughputs (about 16 ulps of
1.0) for the primitives. Both sides evaluate the same f32 formulas; they
differ by the ulp-level error of the f32 acos/sin/cos/sqrt implementations
(XLA's and PyTorch's), which the slerp's angle arithmetic and the final
normalize can amplify a few times. The scatter functions get 2e-5: their
slerp runs between the mirror direction and a cosine sample that can be
nearly parallel, where dividing by sin ω (down to 1e-6) amplifies the acos
difference further (measured at most 6.7e-6 on 7 of 9,000 components).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learn_path_tracing_tpu.bsdf import bsdf as jbsdf
from learn_path_tracing_tpu.bsdf import sampling as jsp
from learn_path_tracing_tpu.core.types import Hits as JHits
from learn_path_tracing_tpu.core.types import Materials as JMaterials
from learn_path_tracing_tpu.core.types import Rays as JRays
from learn_path_tracing_tpu_torch.bsdf import bsdf as tbsdf
from learn_path_tracing_tpu_torch.bsdf import sampling as tsp
from learn_path_tracing_tpu_torch.core.types import Hits as THits
from learn_path_tracing_tpu_torch.core.types import Materials as TMaterials
from learn_path_tracing_tpu_torch.core.types import Rays as TRays

torch.set_num_threads(2)

N = 3000
ATOL = 2e-6
ATOL_SCATTER = 2e-5


def _unit(r, n):
    v = r.normal(size=(n, 3)).astype(np.float32)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _inputs(seed=0):
    r = np.random.default_rng(seed)
    u = [r.random(N, dtype=np.float32) for _ in range(4)]
    d = _unit(r, N)
    n = _unit(r, N)
    n = np.where((d * n).sum(-1, keepdims=True) > 0, -n, n)   # front faces
    # a few nearly parallel pairs exercise slerp's linear fallback
    b = _unit(r, N)
    b[:50] = n[:50]
    rough = r.random(N, dtype=np.float32)
    ior = np.where(r.random(N) < 0.5, 1.5, 1 / 1.5).astype(np.float32)
    return u, d, n, b, rough, ior


SAMPLERS = {
    "sample_at_sphere": lambda m, u, d, n, b, rough, ior: m.sample_at_sphere(u[0], u[1]),
    "sample_in_disk": lambda m, u, d, n, b, rough, ior: m.sample_in_disk(u[0], u[1]),
    "sample_in_sphere": lambda m, u, d, n, b, rough, ior: m.sample_in_sphere(u[0], u[1], u[2]),
    "ball_radius": lambda m, u, d, n, b, rough, ior: m.ball_radius(u[0], u[1], u[2]),
    "sample_lambertian": lambda m, u, d, n, b, rough, ior: m.sample_lambertian(n, u[0], u[1]),
    "slerp": lambda m, u, d, n, b, rough, ior: m.slerp(n, b, u[2]),
    "reflect": lambda m, u, d, n, b, rough, ior: m.reflect(d, n),
    "sample_normal": lambda m, u, d, n, b, rough, ior: m.sample_normal(
        d, n, rough[:, None], u[0], u[1]),
    "refract": lambda m, u, d, n, b, rough, ior: m.refract(d, n, ior),
    "refract_legacy": lambda m, u, d, n, b, rough, ior: m.refract_legacy(d, n, ior),
    "schlick": lambda m, u, d, n, b, rough, ior: m.schlick(u[3], rough),
    "roughen": lambda m, u, d, n, b, rough, ior: m.roughen(d, rough, u[0], u[1], u[2]),
}


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_sampling_matches_jax(name):
    args = _inputs()
    f = SAMPLERS[name]
    want = jax.jit(lambda *a: f(jsp, *a))(*jax.tree_util.tree_map(jnp.asarray, args))
    got = f(tsp, *jax.tree_util.tree_map(torch.as_tensor, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def _scene_hits(seed):
    """Identical rays, hits and RNG bases for both packages: a mix of
    diffuse, metal and glass hits, some of them back faces."""
    r = np.random.default_rng(seed)
    u, d, n, _, rough, _ = _inputs(seed)
    kind = r.integers(0, 3, size=N)            # 0 diffuse, 1 metal, 2 glass
    back = r.random(N) < 0.2
    ior = np.where(kind == 1, 0.0, 1.5).astype(np.float32)
    ior = np.where(back & (kind != 1), 1.0 / np.maximum(ior, 1e-9), ior).astype(np.float32)
    n = np.where(back[:, None], -n, n).astype(np.float32)
    mats = dict(
        albedo=r.random((N, 3), dtype=np.float32),
        roughness=np.where(kind == 2, 0.2, 1.0).astype(np.float32) * rough,
        metallic=(kind == 1).astype(np.float32),
        ior=ior,
        transparency=(kind == 2).astype(np.float32),
        absorptivity=np.zeros(N, np.float32),
    )
    rays = dict(ro=r.normal(size=(N, 3)).astype(np.float32), rd=d,
                throughput=r.random((N, 3), dtype=np.float32),
                alive=np.ones(N, bool))
    hits = dict(t=r.random(N, dtype=np.float32) + 0.5,
                point=r.normal(size=(N, 3)).astype(np.float32), normal=n,
                uv=np.zeros((N, 2), np.float32), obj=np.zeros(N, np.int32),
                hit=np.ones(N, bool))
    base = r.integers(0, 2 ** 32, size=N, dtype=np.uint64).astype(np.uint32)
    jr = JRays(**{k: jnp.asarray(v) for k, v in rays.items()})
    jh = JHits(**{k: jnp.asarray(v) for k, v in hits.items()},
               material=JMaterials(**{k: jnp.asarray(v) for k, v in mats.items()}))
    tr = TRays(**{k: torch.as_tensor(v) for k, v in rays.items()})
    th = THits(**{k: torch.as_tensor(v) for k, v in hits.items()},
               material=TMaterials(**{k: torch.as_tensor(v) for k, v in mats.items()}))
    return (jr, jh, jnp.asarray(base)), (tr, th, torch.as_tensor(base.astype(np.int64)))


@pytest.mark.parametrize("name", ["diffuse", "modern"])
def test_scatter_matches_jax(name):
    (jr, jh, jb), (tr, th, tb) = _scene_hits(seed=11)
    want = jax.jit(jbsdf.SCATTERERS[name])(jr, jh, jb)
    got = tbsdf.SCATTERERS[name](tr, th, tb)
    np.testing.assert_array_equal(got.ro.numpy(), np.asarray(want.ro))
    np.testing.assert_allclose(got.rd.numpy(), np.asarray(want.rd), rtol=0,
                               atol=ATOL_SCATTER)
    np.testing.assert_allclose(got.throughput.numpy(), np.asarray(want.throughput),
                               rtol=0, atol=ATOL_SCATTER)
    np.testing.assert_array_equal(got.alive.numpy(), np.asarray(want.alive))
