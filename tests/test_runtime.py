"""Native runtime (C++ PNG codec + prefetching loader) tests.

Builds the shared library on demand; codec output is pinned to PIL's.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIB = os.path.join(REPO, "runtime", "libstereo_runtime.so")


@pytest.fixture(scope="module")
def native():
    if not os.path.exists(LIB):
        r = subprocess.run(["make", "-C", os.path.join(REPO, "runtime", "cpp")],
                           capture_output=True, text=True)
        if r.returncode != 0:
            pytest.skip(f"native build failed: {r.stderr[-500:]}")
    sys.path.insert(0, REPO)
    from runtime import png_native
    return png_native


def test_codec_roundtrip(native, tmp_path):
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (37, 53, 4), dtype=np.uint8)
    img[..., 3] = 255
    p = str(tmp_path / "t.png")
    native.encode_rgba(p, img)
    back = native.decode_rgba(p)
    np.testing.assert_array_equal(back, img)


def test_codec_matches_pil(native):
    path = "/root/reference/stereo_matching/tsukuba/im1.png"
    if not os.path.exists(path):
        pytest.skip("reference not mounted")
    from PIL import Image

    got = native.decode_rgba(path)
    want = np.asarray(Image.open(path).convert("RGB"))
    np.testing.assert_array_equal(got[..., :3], want)


def test_io_uses_native_codec(native, tmp_path):
    from stereo_matchin_tpu.io import png

    assert png._native_codec() is not None
    img01 = np.linspace(0, 1, 24 * 16).reshape(24, 16).astype(np.float32)
    p = str(tmp_path / "g.png")
    png.write_gray(p, img01)
    back = png.read_gray(p)
    np.testing.assert_allclose(back, np.round(img01 * 255) / 255, atol=1e-7)


def test_pair_loader(native):
    from runtime.loader import PairLoader

    pairs = [("/root/reference/stereo_matching/tsukuba/im1.png",
              "/root/reference/stereo_matching/tsukuba/im5.png")] * 3
    if not os.path.exists(pairs[0][0]):
        pytest.skip("reference not mounted")
    seen = 0
    for left, right in PairLoader(pairs, depth=2):
        assert left.shape == (288, 384, 3) and right.shape == (288, 384, 3)
        assert left.dtype == np.float32
        seen += 1
    assert seen == 3


def test_compilation_cache_helper(tmp_path, monkeypatch):
    """JAX_COMPILATION_CACHE_DIR, where set, wins and nothing is set in
    code; otherwise the cache goes to the given (default: fixed) path."""
    import jax

    from stereo_matchin_tpu.utils import compilation_cache as cc

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    assert cc.enable_compilation_cache() == str(tmp_path / "env")
    assert jax.config.jax_compilation_cache_dir == before
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    d = str(tmp_path / "xla")
    try:
        assert cc.enable_compilation_cache(d) == d
        assert os.path.isdir(d)
        assert jax.config.jax_compilation_cache_dir == d
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compilation_cache_default_is_fixed_checkout_path():
    """The default lives at <checkout>/.jax_cache, which .gitignore lists."""
    from stereo_matchin_tpu.utils import compilation_cache as cc

    assert cc.DEFAULT_DIR == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()
