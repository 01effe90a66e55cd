import numpy as np
import pytest

from rgk.io import exr


@pytest.mark.parametrize("compression", ["none", "zips", "zip"])
@pytest.mark.parametrize("pixel_type", ["float", "half"])
def test_exr_round_trip(tmp_path, compression, pixel_type):
    rng = np.random.default_rng(0)
    img = rng.random((33, 17, 3), dtype=np.float32) * 10.0
    path = str(tmp_path / "t.exr")
    exr.write_exr(path, img, pixel_type=pixel_type, compression=compression)
    back = exr.read_exr(path)
    tol = 1e-6 if pixel_type == "float" else 1e-2
    assert back.shape == img.shape
    np.testing.assert_allclose(back, img, rtol=tol, atol=tol)


def test_exr_rgba(tmp_path):
    img = np.random.default_rng(1).random((8, 8, 4)).astype(np.float32)
    path = str(tmp_path / "t.exr")
    exr.write_exr(path, img)
    back = exr.read_exr(path)
    np.testing.assert_allclose(back, img, atol=1e-6)


def test_accumulation_image():
    acc = exr.AccumulationImage(4, 2)
    ones = np.ones((2, 4, 3))
    acc.add(ones * 4.0, np.full((2, 4), 2.0))
    img = acc.resolve()
    np.testing.assert_allclose(img, 2.0)
    # Auto exposure maps the max channel to 1.
    scaled = acc.normalize(-1.0)
    np.testing.assert_allclose(scaled.max(), 1.0)


def test_png_bmp_writers(tmp_path):
    # Reference FileTexture::Write (texture.cpp:109-187): PNG and
    # 24-bit bottom-up BGR BMP, 255*clamp per channel.
    import numpy as np
    from rgk.io.texture_io import (load_texture, write_bmp, write_png,
                                   write_texture)
    rng = np.random.RandomState(3)
    img = rng.rand(21, 13, 3).astype(np.float32)  # odd width -> row pad
    # the writer truncates like the reference's (char)(255*clamp)
    q = np.floor(np.clip(img, 0, 1) * 255) / 255

    p = str(tmp_path / "x.png")
    write_png(p, img)
    back = load_texture(p)  # loader gamma-decodes 8-bit formats
    assert np.abs(back - np.power(q, 2.2)).max() < 1e-2

    b = str(tmp_path / "x.bmp")
    write_bmp(b, img)
    with open(b, "rb") as f:
        head = f.read(54)
    assert head[:2] == b"BM"
    import struct
    w, h = struct.unpack("<ii", head[18:26])
    assert (w, h) == (13, 21)
    bpp = struct.unpack("<H", head[28:30])[0]
    assert bpp == 24
    # bottom-up BGR: last row of file == first image row
    from PIL import Image
    arr = np.asarray(Image.open(b), np.float32) / 255.0
    assert np.abs(arr - q).max() < 1e-6

    write_texture(str(tmp_path / "y.exr"), img)
    import pytest
    with pytest.raises(ValueError):
        write_texture(str(tmp_path / "y.gif"), img)
