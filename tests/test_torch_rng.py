"""Port parity: the counter RNG of learn_path_tracing_tpu_torch against the
JAX package's, on the same random uint32 counters (numpy-seeded, including
values with the high bit set). Tolerance: the bits are exactly equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learn_path_tracing_tpu.core import rng as jrng
from learn_path_tracing_tpu_torch.core import rng as trng

torch.set_num_threads(2)

N = 4096


def _counters(seed):
    r = np.random.default_rng(seed)
    x = r.integers(0, 2 ** 32, size=N, dtype=np.uint64).astype(np.uint32)
    x[:4] = [0, 1, 0x7FFFFFFF, 0xFFFFFFFF]
    x[4:1024] |= np.uint32(0x80000000)   # high bit set
    return x


def _j(x):
    return np.asarray(x).astype(np.uint32)


def _t(x):
    y = x.numpy()
    assert y.dtype == np.int64 and y.min() >= 0 and y.max() < 2 ** 32
    return y.astype(np.uint32)


CASES = {
    "pcg": (lambda a, b: jrng.pcg(a), lambda a, b: trng.pcg(a)),
    "fold": (jrng.fold, trng.fold),
    "base": (jrng.base, trng.base),
    "bits_dim0": (lambda a, b: jrng.bits(a, 0), lambda a, b: trng.bits(a, 0)),
    "bits_dim7": (lambda a, b: jrng.bits(a, 7), lambda a, b: trng.bits(a, 7)),
    "stream_per_lane": (lambda a, b: jrng.stream(5, a, b % 33, 1),
                        lambda a, b: trng.stream(5, a, b % 33, 1)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_hash_bits_exact(name):
    a, b = _counters(1), _counters(2)
    jf, tf = CASES[name]
    want = _j(jf(jnp.asarray(a), jnp.asarray(b)))
    got = _t(tf(torch.as_tensor(a.astype(np.int64)), torch.as_tensor(b.astype(np.int64))))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed,sample,bounce,stream_id",
                         [(0, 0, 0, 0), (7, 3, 2, 1), (-1, 63, 31, 2),
                          (2 ** 31 + 5, 2 ** 32 - 1, 0, 1)])
def test_stream_scalar_exact(seed, sample, bounce, stream_id):
    def jax_int(v):   # JAX takes Python ints up to int32 only
        return np.uint32(v) if v >= 2 ** 31 else v

    want = int(np.asarray(jrng.stream(jax_int(seed), jax_int(sample), bounce,
                                      stream_id)))
    assert int(trng.stream(seed, sample, bounce, stream_id)) == want


@pytest.mark.parametrize("dim", [0, 1, 2, 5])
def test_uniform_exact(dim):
    b = _counters(3)
    want = np.asarray(jrng.uniform(jnp.asarray(b), dim))
    got = trng.uniform(torch.as_tensor(b.astype(np.int64)), dim).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0.0 and got.max() < 1.0


def test_uniform2_uniform3_exact():
    b = _counters(4)
    jb, tb = jnp.asarray(b), torch.as_tensor(b.astype(np.int64))
    for jf, tf in ((jrng.uniform2, trng.uniform2), (jrng.uniform3, trng.uniform3)):
        for w, g in zip(jf(jb, 3), tf(tb, 3)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("stream_id", [trng.STREAM_CAMERA, trng.STREAM_BSDF])
@pytest.mark.parametrize("seed,sample,bounce",
                         [(0, 0, 0), (2 ** 32 - 1, 127, 9), (20261018, 3, 1),
                          (2 ** 31 + 11, 2 ** 32 - 1, 31)])
def test_base_of_a_tensor_stream_is_the_int_streams(seed, sample, bounce, stream_id):
    """A CUDA graph reads its stream hash from a 0-d int64 tensor: ``base``
    of that tensor is ``base`` of the host's int, bit for bit, on pixel ids
    with the high bit set too; and the camera's rays from the camera
    stream's tensor are those of ``(seed, sample)``."""
    from learn_path_tracing_tpu_torch.camera.camera import Camera, generate_rays_for_pixels

    h = trng.stream(seed, sample, bounce, stream_id)
    assert isinstance(h, int) and 0 <= h < 2 ** 32
    pix = torch.as_tensor(_counters(5).astype(np.int64))
    want = trng.base(h, pix)
    got = trng.base(torch.tensor(h, dtype=torch.int64), pix)
    assert got.dtype == torch.int64 and torch.equal(got, want)
    if stream_id == trng.STREAM_CAMERA and bounce == 0:
        res = (64, 64)
        cam = Camera(res, fov=40, focal_length=10.0, aperture=0.2).params("cpu")
        for model in ("jitter", "thinlens"):
            a = generate_rays_for_pixels(cam, res, pix % 4096, seed, sample, model=model)
            b = generate_rays_for_pixels(cam, res, pix % 4096, None, None, model=model,
                                         stream_h=torch.tensor(h, dtype=torch.int64))
            assert torch.equal(a.ro, b.ro) and torch.equal(a.rd, b.rd), model
