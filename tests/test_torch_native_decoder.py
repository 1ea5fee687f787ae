"""The port's native JPEG decoder (hawkeye_tpu_torch/data/native_decoder.py
and its own copy of decoder.cpp) against the JAX package's: the port's
``FGDataset(decode_size=...)`` gives the JAX one's bytes on a seeded
CUB-sized JPEG (PIL's two-step resize, which the port used before, differs
from them in about half the values); a PNG falls back to PIL in both, and
garbage is refused."""

import torch_threads  # noqa: F401  (PyTorch's thread count: see the module)
import os

import numpy as np
import pytest
from PIL import Image

from hawkeye_tpu.data import FGDataset as JaxFGDataset
from hawkeye_tpu.data import native_decoder as jax_native
from hawkeye_tpu_torch.data import FGDataset
from hawkeye_tpu_torch.data import native_decoder
from hawkeye_tpu_torch.data.transforms_host import center_crop, resize_shorter


@pytest.fixture(scope="module")
def jpeg_dir(tmp_path_factory):
    """A seeded 500x375 JPEG (CUB's common size) with texture and a
    grayscale one, each listed in a metadata file."""
    d = tmp_path_factory.mktemp("jpegs")
    rs = np.random.RandomState(0)
    base = rs.rand(15, 20, 3)
    smooth = np.kron(base, np.ones((25, 25, 1)))  # 375x500
    arr = np.clip(smooth * 200 + rs.randn(375, 500, 3) * 20, 0, 255).astype(np.uint8)
    Image.fromarray(arr).save(d / "bird.jpg", quality=90)
    gray = np.clip(smooth[..., 0] * 255, 0, 255).astype(np.uint8)[:, :333]
    Image.fromarray(gray, mode="L").save(d / "gray.jpg", quality=90)
    (d / "meta.txt").write_text("3 bird.jpg\n1 gray.jpg\n")
    return d


def test_native_builds_into_the_port(jpeg_dir):
    assert native_decoder.native_available(), native_decoder.describe()
    path = native_decoder.lib_path()
    assert os.path.exists(path)
    assert os.sep + os.path.join("hawkeye_tpu_torch", "_build") + os.sep in path
    assert "native libjpeg" in native_decoder.describe()
    with open(native_decoder.SRC) as f:
        assert "hawkeye_tpu/" not in f.read()  # the port's own copy


@pytest.mark.parametrize("size", [512, 96])
def test_fgdataset_decode_equals_jax_byte_for_byte(jpeg_dir, size):
    assert jax_native.native_available()
    meta = str(jpeg_dir / "meta.txt")
    port = FGDataset(str(jpeg_dir), meta, decode_size=size)
    ref = JaxFGDataset(str(jpeg_dir), meta, decode_size=size)
    for i in range(len(ref)):
        got, want = port[i], ref[i]
        assert got["label"] == want["label"]
        assert got["img"].dtype == np.uint8 and got["img"].shape == (size, size, 3)
        np.testing.assert_array_equal(got["img"], want["img"])
    # the PIL path the port took before differs from these bytes
    pil = np.asarray(center_crop(resize_shorter(
        Image.open(jpeg_dir / "bird.jpg").convert("RGB"), size), size))
    assert (pil != port[0]["img"]).mean() > 0.2


def test_png_falls_back_to_pil_and_garbage_is_refused(tmp_path):
    arr = np.random.RandomState(1).randint(0, 256, (50, 60, 3)).astype(np.uint8)
    Image.fromarray(arr).save(tmp_path / "img.png")
    (tmp_path / "meta.txt").write_text("0 img.png\n")
    port = FGDataset(str(tmp_path), str(tmp_path / "meta.txt"), decode_size=32)[0]
    ref = JaxFGDataset(str(tmp_path), str(tmp_path / "meta.txt"), decode_size=32)[0]
    assert port["img"].shape == (32, 32, 3)
    np.testing.assert_array_equal(port["img"], ref["img"])
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"definitely not a jpeg")
    assert native_decoder.decode_resize_center(str(bad), 64) is None
    assert native_decoder.decode_resize_center(str(tmp_path / "img.png"), 32) is None
