"""PNG image I/O.

Replaces the reference's vendored lodepng (`stereo_matching/lodepng.{h,cpp}`,
used via `lodepng::decode/encode` at `main.cpp:184-186,359`).  Decoding
yields float32 RGB in [0,1] on the UNORM8 grid — exactly the values the
reference's CL_UNORM_INT8 images present to kernels.

The native C++ codec (runtime/, built with libpng) backs the hot path
when it is built; otherwise a numpy + zlib codec handles the 8-bit,
non-interlaced PNGs (gray, gray+alpha, RGB, RGBA, palette) the engine
reads and writes.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}     # colour type -> samples/px


def _native_codec():
    try:
        from runtime import png_native  # noqa: F401
        return png_native
    except Exception:
        return None


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        yield kind, data[pos + 8:pos + 8 + n]
        pos += 12 + n


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters (RFC 2083 §6) on the inflated
    stream; returns (h, stride) uint8."""
    rows = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 1:            # Sub: running sum per byte lane
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).ravel() & 255
        elif ftype == 2:            # Up
            cur = (line + prev) & 255
        elif ftype in (3, 4):       # Average / Paeth: sequential in x
            cur = line.copy()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = prev[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                cur[x] = (cur[x] + pred) & 255
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def decode_png(data: bytes) -> np.ndarray:
    """Decode PNG bytes to (H, W, C) uint8 — C = 1, 2, 3 or 4 samples, a
    palette image expanded to RGB.  8-bit, non-interlaced only."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    idat, palette, header = [], None, None
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or interlace != 0 or ctype not in _CHANNELS:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type "
                         f"{ctype}, interlace {interlace}")
    c = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    img = _unfilter(raw, h, w * c, c).reshape(h, w, c)
    if ctype == 3:
        img = palette[img[..., 0]]
    return img


def encode_png(arr: np.ndarray, level: int = 1) -> bytes:
    """Encode (H, W) or (H, W, C) uint8, C in 1-4, as an 8-bit PNG with
    no row filter."""
    arr = np.ascontiguousarray(arr, np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           arr.reshape(h, w * c)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        crc = zlib.crc32(kind + body) & 0xFFFFFFFF
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", crc)

    return (_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + chunk(b"IEND", b""))


def _decode_rgb_u8(path) -> np.ndarray:
    native = _native_codec()
    if native is not None:
        return native.decode_rgba(str(path))[..., :3]
    with open(path, "rb") as fh:
        img = decode_png(fh.read())
    if img.shape[2] <= 2:                       # gray (+ alpha)
        return np.repeat(img[..., :1], 3, axis=2)
    return img[..., :3]


def read_rgb(path) -> np.ndarray:
    """Decode a PNG to (H, W, 3) float32 in [0,1] (UNORM8 grid)."""
    return (_decode_rgb_u8(path) / np.float32(255.0)).astype(np.float32)


def read_gray(path) -> np.ndarray:
    """Decode a PNG to (H, W) float32 in [0,1] using the R channel.

    The reference stores disparity maps as grayscale RGBA where R=G=B
    (e.g. init_disparity.cl:18), so the R channel is the value.
    """
    return read_rgb(path)[..., 0]


def write_gray(path, img01) -> None:
    """Encode an (H, W) [0,1] image as 8-bit grayscale RGB PNG (R=G=B),
    mirroring the reference's disparity dumps (main.cpp:357-367)."""
    u8 = np.clip(np.round(np.asarray(img01) * 255.0), 0, 255).astype(np.uint8)
    write_rgb(path, np.stack([u8, u8, u8], axis=-1))


def write_rgb(path, arr_u8) -> None:
    """Encode an (H, W, 3) uint8 (or [0,1] float) array as PNG."""
    arr = np.asarray(arr_u8)
    if arr.dtype != np.uint8:
        arr = np.clip(np.round(arr * 255.0), 0, 255).astype(np.uint8)
    native = _native_codec()
    if native is not None:
        rgba = np.concatenate(
            [arr, np.full(arr.shape[:2] + (1,), 255, np.uint8)], axis=-1
        )
        native.encode_rgba(str(path), rgba)
        return
    with open(path, "wb") as fh:
        fh.write(encode_png(arr))
