import os

import numpy as np

from enarf_gan_tpu import native


def test_native_builds_and_normalizes(rng):
    imgs = (rng.rand(2, 3, 16, 16) * 255).astype(np.uint8)
    out = native.normalize_images(imgs)
    np.testing.assert_allclose(out, imgs.astype(np.float32) / 127.5 - 1,
                               rtol=1e-5, atol=1e-6)
    assert out.dtype == np.float32


def test_native_mask_and_gather(rng):
    alpha = (rng.rand(4, 8, 8) * 255).astype(np.uint8)
    m = native.mask_from_alpha(alpha)
    np.testing.assert_allclose(m, alpha / 255.0, rtol=1e-6)

    table = rng.randn(100, 7).astype(np.float32)
    idx = rng.randint(0, 100, 33)
    out = native.gather_rows(table, idx)
    np.testing.assert_allclose(out, table[idx])


def test_native_available():
    # g++ is baked into the image; the native path should be active
    assert native.available()


def test_native_lib_named_by_source_content(tmp_path):
    """A changed batcher.cpp maps to a new library name (so it is rebuilt);
    an unchanged one to the same name (so it is not)."""
    src = tmp_path / "batcher.cpp"
    with open(native._SRC) as f:
        text = f.read()
    src.write_text(text)
    first = native.lib_path(str(src))
    assert native.lib_path(str(src)) == first
    assert os.path.dirname(first) == str(tmp_path)
    src.write_text(text + "\n// edited\n")
    assert native.lib_path(str(src)) != first
