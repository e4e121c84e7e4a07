"""Kernels K6a and K6b: row gathers ``out[j] = tab[idx[j]]``, with their
plain version.

``gather`` is the port of the two row-gather kernels of the JAX package's
``scripts/profile_gather2.py`` (``vmem_kernel``, K6a, written for the
narrow f32 triangle-attribute table; ``dma_kernel``, K6b, for the wide bf16
strip-atlas pair rows) and of the ``jnp.take(tab, idx, axis=0)`` calls they
stand for on the mesh path: ``scene.legacy_world._attrs_block``'s
triangle-attribute row and ``io.texture.sample_bilinear_strips``' info row
and pair row. For a CUDA tensor it launches the hand-written kernel of
``csrc/row_gather.cu`` picked by the row width (K6a up to
``NARROW_MAX_BYTES``, K6b above) and counts the launch in
``gather.launches`` and the bytes of the rows it writes in
``gather.bytes``; for a CPU tensor it runs ``gather_plain``. There is no
fallback between the two: a CUDA tensor launches the kernel or raises.

Semantics (``jnp.take``'s fill rule, as the JAX package's callers get it):
an index in ``[-R, 0)`` wraps to ``idx + R``; any other index outside
``[0, R)`` gives a fill row, NaN for f32 and bf16 tables and ``INT32_MIN``
for i32 tables. Tables are ``[R, C]`` of f32, bf16 or i32 whose rows are a
multiple of 16 bytes, 16-byte aligned (the kernels move rows as 16-byte
vectors); indices int32 or int64 ``[N]``. The output is ``[N, C]`` of the
table's type.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

NARROW_MAX_BYTES = 128     # K6a up to this row width, K6b above
VEC_BYTES = 16
# every 32-bit word of a fill row: the NaN that PyTorch and JAX write for
# f32 (0x7FC00000) and bf16 (0x7FC0, twice), and INT32_MIN for i32
FILL_WORDS = {torch.float32: 0x7FC00000, torch.bfloat16: 0x7FC07FC0,
              torch.int32: 0x80000000}
INDEX_TYPES = (torch.int32, torch.int64)


def kernel_for(tab) -> str:
    """The kernel that gathers rows of ``tab``: ``'k6a'`` for rows of at
    most ``NARROW_MAX_BYTES``, ``'k6b'`` for wider ones."""
    return "k6a" if tab.shape[1] * tab.element_size() <= NARROW_MAX_BYTES else "k6b"


def _check(tab, idx):
    if tab.dtype not in FILL_WORDS or tab.dim() != 2:
        raise ValueError(f"row gather: the table must be 2-D f32, bf16 or i32, "
                         f"got {tab.dtype}{list(tab.shape)}")
    if idx.dtype not in INDEX_TYPES or idx.dim() != 1:
        raise ValueError(f"row gather: the indices must be 1-D int32 or int64, "
                         f"got {idx.dtype}{list(idx.shape)}")
    if idx.device != tab.device:
        raise ValueError(f"row gather: the indices are on {idx.device}, "
                         f"the table on {tab.device}")
    row_bytes = tab.shape[1] * tab.element_size()
    if row_bytes == 0 or row_bytes % VEC_BYTES:
        raise ValueError(f"row gather: a row of {row_bytes} bytes is not a multiple "
                         f"of {VEC_BYTES} bytes")
    if tab.data_ptr() % VEC_BYTES:
        raise ValueError(f"row gather: the table is not {VEC_BYTES}-byte aligned")


def gather(tab, idx):
    """``out[j] = tab[idx[j]]`` with ``jnp.take``'s wrap and fill rule.

    CUDA tensors launch K6a or K6b (and count the launch in
    ``gather.launches``); CPU tensors take ``gather_plain``."""
    _check(tab, idx)
    if tab.device.type == "cpu":
        return gather_plain(tab, idx)
    if tab.device.type != "cuda":
        raise ValueError(f"row gather: no kernel for device {tab.device}")
    return _launch(tab, idx)


gather.launches = {"k6a": 0, "k6b": 0}
gather.bytes = {"k6a": 0, "k6b": 0}


def _launch(tab, idx):
    if not tab.is_contiguous():
        raise ValueError("row gather kernel: the table must be contiguous")
    idx = idx.contiguous()
    lib = load_kernel()
    n, rows = idx.shape[0], tab.shape[0]
    out = torch.empty((n, tab.shape[1]), dtype=tab.dtype, device=tab.device)
    if n == 0:
        return out
    kernel = kernel_for(tab)
    vecs = tab.shape[1] * tab.element_size() // VEC_BYTES
    with torch.cuda.device(tab.device):
        stream = torch.cuda.current_stream(tab.device).cuda_stream
        code = lib.lpt_row_gather(tab.data_ptr(), idx.data_ptr(), out.data_ptr(), n, rows,
                                  vecs, int(idx.dtype == torch.int64),
                                  FILL_WORDS[tab.dtype], int(kernel == "k6b"), stream)
    if code != 0:
        msg = lib.lpt_error_string(code).decode()
        raise RuntimeError(f"row gather kernel launch failed: {msg} ({code})")
    gather.launches[kernel] += 1
    gather.bytes[kernel] += out.numel() * out.element_size()
    return out


@functools.cache
def load_kernel() -> ctypes.CDLL:
    """Build (first use) and load the kernel library with its C signature."""
    lib = build.load("row_gather")
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.lpt_row_gather.argtypes = [vp, vp, vp, ll, ll, ci, ci, ctypes.c_uint, ci, vp]
    lib.lpt_row_gather.restype = ci
    lib.lpt_error_string.argtypes = [ci]
    lib.lpt_error_string.restype = ctypes.c_char_p
    return lib


def fill_row(dtype, width: int, device=None):
    """The fill row ``[width]`` of a table of ``dtype``: NaN (bits 0x7FC00000
    in f32, 0x7FC0 in bf16) or ``INT32_MIN``."""
    value = -2**31 if dtype == torch.int32 else float("nan")
    return torch.full((width,), value, dtype=dtype, device=device)


def gather_plain(tab, idx):
    """Plain PyTorch version of the kernels, on any device: torch indexing
    plus ``jnp.take``'s wrap and fill rule. It agrees with the kernels bit
    for bit."""
    rows = tab.shape[0]
    idx = idx.to(torch.int64)
    r = torch.where(idx < 0, idx + rows, idx)
    ok = (r >= 0) & (r < rows)
    if rows == 0:
        out = torch.empty((idx.shape[0], tab.shape[1]), dtype=tab.dtype, device=tab.device)
    else:
        out = tab[torch.where(ok, r, 0)]
    fill = fill_row(tab.dtype, tab.shape[1], device=tab.device)
    return torch.where(ok[:, None], out, fill[None, :])
