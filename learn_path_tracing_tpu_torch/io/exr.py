"""Minimal OpenEXR scanline codec (pure numpy + zlib).

The same code as ``learn_path_tracing_tpu.io.exr`` (numpy only), kept in
the port so that it never imports the JAX package.

The reference lights its flagship character renders with an equirect HDR
environment loaded from ``cayley_interior_2k.exr`` via ``imageio``
(the reference's legacy/PT_in_one_weekend/15_module.py:118-132).  This
image ships no EXR backend (imageio has no plugin, cv2 built without EXR,
no OpenEXR module), so the IBL path needs its own decoder.

Scope — the subset real equirect environment maps use:

- single-part scanline files, version 2, increasing line order
- pixel types HALF / FLOAT / UINT
- compression NONE, ZIPS (1 line/block) and ZIP (16 lines/block); these
  are zlib + the OpenEXR byte predictor+interleave transform
- x/y sampling 1 (no chroma-subsampled luminance files)

``write_exr`` exists so tests can create fixtures and so HDR renders can
be exported; it writes the same subset it reads.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = b"\x76\x2f\x31\x01"
_PT_UINT, _PT_HALF, _PT_FLOAT = 0, 1, 2
_PT_DTYPE = {_PT_UINT: np.uint32, _PT_HALF: np.float16, _PT_FLOAT: np.float32}
_DTYPE_PT = {np.dtype(np.uint32): _PT_UINT, np.dtype(np.float16): _PT_HALF,
             np.dtype(np.float32): _PT_FLOAT}
# compression id -> scanlines per chunk (supported subset)
_LINES_PER_BLOCK = {0: 1, 2: 1, 3: 16}


def _predictor_decode(raw: bytes) -> np.ndarray:
    """Inverse of OpenEXR's ZIP pre-transform (ImfZip.cpp semantics):
    running-delta decode then de-interleave the two halves."""
    b = np.frombuffer(raw, np.uint8).astype(np.int64)
    b[1:] -= 128
    flat = np.cumsum(b) % 256
    n = flat.shape[0]
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[0::2] = flat[:half]
    out[1::2] = flat[half:]
    return out


def _predictor_encode(data: np.ndarray) -> bytes:
    n = data.shape[0]
    half = (n + 1) // 2
    s = np.empty(n, np.int64)
    s[:half] = data[0::2]
    s[half:] = data[1::2]
    s[1:] = s[1:] - s[:-1] + 128
    return (s % 256).astype(np.uint8).tobytes()


def _read_attr_blocks(buf: bytes, pos: int):
    """Yield (name, type, value_bytes) until the empty-name terminator."""
    attrs = {}
    while True:
        end = buf.index(b"\0", pos)
        name = buf[pos:end].decode("latin-1")
        pos = end + 1
        if not name:
            return attrs, pos
        end = buf.index(b"\0", pos)
        atype = buf[pos:end].decode("latin-1")
        pos = end + 1
        (size,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        attrs[name] = (atype, buf[pos:pos + size])
        pos += size


def _parse_chlist(raw: bytes):
    """-> list of (name, pixel_type, xs, ys) in file (alphabetical) order."""
    chans, pos = [], 0
    while raw[pos] != 0:
        end = raw.index(b"\0", pos)
        name = raw[pos:end].decode("latin-1")
        pos = end + 1
        ptype, xs, ys = struct.unpack_from("<i4xii", raw, pos)
        pos += 16
        chans.append((name, ptype, xs, ys))
    return chans


def read_exr(path: str) -> np.ndarray:
    """Decode an EXR into ``f32[H, W, C]`` (or ``[H, W]`` for 1 channel).

    R,G,B(,A) channels are returned in that order when present; other
    channel sets come back in file order. HALF/UINT are widened to f32.
    """
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:4] != _MAGIC:
        raise ValueError(f"not an EXR file: {path}")
    (version,) = struct.unpack_from("<i", buf, 4)
    if version & 0x200:
        raise ValueError("deep/multi-part EXR not supported")
    if version & 0x40000:
        raise ValueError("tiled EXR not supported")

    attrs, pos = _read_attr_blocks(buf, 8)
    chans = _parse_chlist(attrs["channels"][1])
    if any(xs != 1 or ys != 1 for _, _, xs, ys in chans):
        raise ValueError("subsampled channels not supported")
    comp = attrs["compression"][1][0]
    if comp not in _LINES_PER_BLOCK:
        raise ValueError(f"unsupported EXR compression id {comp} "
                         "(NONE/ZIPS/ZIP only)")
    lpb = _LINES_PER_BLOCK[comp]
    x0, y0, x1, y1 = struct.unpack("<4i", attrs["dataWindow"][1])
    w, h = x1 - x0 + 1, y1 - y0 + 1
    line_order = attrs["lineOrder"][1][0]

    n_chunks = -(-h // lpb)
    offsets = struct.unpack_from(f"<{n_chunks}Q", buf, pos)

    out = {name: np.empty((h, w), _PT_DTYPE[pt]) for name, pt, _, _ in chans}
    bytes_per_line = sum(w * np.dtype(_PT_DTYPE[pt]).itemsize
                         for _, pt, _, _ in chans)
    for off in offsets:
        y, size = struct.unpack_from("<ii", buf, off)
        data = buf[off + 8:off + 8 + size]
        ny = min(lpb, y1 - y + 1)
        raw_size = ny * bytes_per_line
        if comp and size < raw_size:
            data = _predictor_decode(zlib.decompress(data)).tobytes()
        # else: stored raw (OpenEXR keeps the smaller of raw/compressed)
        p = 0
        for dy in range(ny):
            for name, pt, _, _ in chans:
                dt = np.dtype(_PT_DTYPE[pt])
                row = np.frombuffer(data, dt, count=w, offset=p)
                row_y = (y - y0 + dy) if line_order == 0 else \
                    (y1 - (y + dy))
                out[name][row_y] = row
                p += w * dt.itemsize

    names = [c[0] for c in chans]
    if "R" in names and "G" in names and "B" in names:
        order = ["R", "G", "B"] + (["A"] if "A" in names else [])
    else:
        order = names
    planes = [out[n].astype(np.float32) for n in order]
    if len(planes) == 1:
        return planes[0]
    return np.stack(planes, axis=-1)


def _attr(name: str, atype: str, payload: bytes) -> bytes:
    return (name.encode() + b"\0" + atype.encode() + b"\0"
            + struct.pack("<i", len(payload)) + payload)


def write_exr(path: str, img: np.ndarray, half: bool = True,
              compression: str = "zip") -> None:
    """Write ``img`` (``[H, W]``, ``[H, W, 3]`` or ``[H, W, 4]``) as EXR."""
    comp_id = {"none": 0, "zips": 2, "zip": 3}[compression]
    lpb = _LINES_PER_BLOCK[comp_id]
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    names = {1: ["Y"], 3: ["B", "G", "R"], 4: ["A", "B", "G", "R"]}[c]
    # map alphabetical file order back to img channel indices
    src = {1: [0], 3: [2, 1, 0], 4: [3, 2, 1, 0]}[c]
    dt = np.dtype(np.float16 if half else np.float32)
    pt = _DTYPE_PT[dt]
    planes = img.astype(dt)

    chl = b"".join(
        n.encode() + b"\0" + struct.pack("<i", pt) + b"\0\0\0\0"
        + struct.pack("<ii", 1, 1) for n in names) + b"\0"
    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header = (_MAGIC + struct.pack("<i", 2)
              + _attr("channels", "chlist", chl)
              + _attr("compression", "compression", bytes([comp_id]))
              + _attr("dataWindow", "box2i", box)
              + _attr("displayWindow", "box2i", box)
              + _attr("lineOrder", "lineOrder", b"\0")
              + _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
              + _attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0))
              + _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
              + b"\0")

    chunks = []
    for y in range(0, h, lpb):
        ny = min(lpb, h - y)
        rows = []
        for dy in range(ny):
            for si in src:
                rows.append(planes[y + dy, :, si].tobytes())
        raw = b"".join(rows)
        if comp_id:
            enc = zlib.compress(
                _predictor_encode(np.frombuffer(raw, np.uint8)), 6)
            data = enc if len(enc) < len(raw) else raw
        else:
            data = raw
        chunks.append(struct.pack("<ii", y, len(data)) + data)

    n_chunks = len(chunks)
    base = len(header) + 8 * n_chunks
    offsets, acc = [], base
    for ch in chunks:
        offsets.append(acc)
        acc += len(ch)
    with open(path, "wb") as f:
        f.write(header)
        f.write(struct.pack(f"<{n_chunks}Q", *offsets))
        for ch in chunks:
            f.write(ch)
