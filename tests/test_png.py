"""The numpy + zlib PNG codec (io/png.py), the fallback where the native
libpng runtime is not built: round trips and every row filter."""

import struct
import zlib

import numpy as np
import pytest

from stereo_matchin_tpu.io import png


@pytest.mark.parametrize("shape", [(5, 7), (6, 3, 2), (9, 11, 3), (4, 13, 4)],
                         ids=["gray", "gray_alpha", "rgb", "rgba"])
def test_numpy_codec_round_trip(shape):
    a = np.random.default_rng(sum(shape)).integers(0, 256, shape,
                                                   dtype=np.uint8)
    b = png.decode_png(png.encode_png(a))
    np.testing.assert_array_equal(b.reshape(a.shape), a)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _encode_filtered(img, ftype, ctype=2, palette=None):
    """Reference encoder applying one PNG row filter to every row."""
    h, w, c = img.shape
    px = img.astype(np.int64)
    rows = []
    for y in range(h):
        line = px[y].ravel()
        prev = px[y - 1].ravel() if y else np.zeros_like(line)
        out = np.zeros_like(line)
        for x in range(line.size):
            a = line[x - c] if x >= c else 0
            b = prev[x]
            cc = prev[x - c] if x >= c else 0
            pred = [0, a, b, (a + b) >> 1, _paeth(a, b, cc)][ftype]
            out[x] = (line[x] - pred) & 255
        rows.append(bytes([ftype]) + out.astype(np.uint8).tobytes())

    def chunk(kind, body):
        crc = zlib.crc32(kind + body) & 0xFFFFFFFF
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", crc)

    data = png._SIGNATURE + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
    if palette is not None:
        data += chunk(b"PLTE", palette.tobytes())
    return data + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(
        b"IEND", b"")


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4],
                         ids=["none", "sub", "up", "average", "paeth"])
def test_numpy_codec_decodes_every_filter(ftype):
    img = np.random.default_rng(ftype).integers(0, 256, (6, 5, 3),
                                                dtype=np.uint8)
    np.testing.assert_array_equal(png.decode_png(_encode_filtered(img, ftype)),
                                  img)


def test_numpy_codec_expands_palette():
    r = np.random.default_rng(7)
    palette = r.integers(0, 256, (4, 3), dtype=np.uint8)
    idx = r.integers(0, 4, (5, 6, 1), dtype=np.uint8)
    got = png.decode_png(_encode_filtered(idx, 1, ctype=3, palette=palette))
    np.testing.assert_array_equal(got, palette[idx[..., 0]])


def test_numpy_codec_rejects_unsupported():
    data = bytearray(png.encode_png(np.zeros((2, 2, 3), np.uint8)))
    data[24] = 16                                  # IHDR bit depth
    with pytest.raises(ValueError, match="bit depth 16"):
        png.decode_png(bytes(data))
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode_png(b"GIF89a")


def test_read_write_without_native_codec(tmp_path, monkeypatch):
    """read_rgb/write_gray round trip through the numpy codec alone."""
    monkeypatch.setattr(png, "_native_codec", lambda: None)
    img01 = np.linspace(0, 1, 24 * 16).reshape(24, 16).astype(np.float32)
    p = str(tmp_path / "g.png")
    png.write_gray(p, img01)
    np.testing.assert_allclose(png.read_gray(p), np.round(img01 * 255) / 255,
                               atol=1e-7)
    rgb = png.read_rgb(p)
    assert rgb.shape == (24, 16, 3) and rgb.dtype == np.float32
