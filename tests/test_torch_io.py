"""The port's host I/O against the JAX package's: the EXR codec (every
compression, written byte for byte as JAX writes it and read both ways),
PIZ's pure-Python Huffman path, EXR image textures, and PNG output."""
import numpy as np
import pytest
from PIL import Image as PILImage

from tpu_raytracing.materials import Image as JImage
from tpu_raytracing.utils import exr as jexr
from tpu_raytracing.utils import exr_piz as jpiz
from tpu_raytracing.utils import png as jpng
from tpu_raytracing_torch.materials import Image
from tpu_raytracing_torch.utils import exr, exr_piz, png

COMPRESSIONS = {
    "none": (exr.COMP_NONE, False), "rle": (exr.COMP_RLE, False),
    "zips": (exr.COMP_ZIPS, False), "zip": (exr.COMP_ZIP, False),
    "piz": (exr.COMP_PIZ, False), "piz_half": (exr.COMP_PIZ, True),
    "pxr24": (exr.COMP_PXR24, False), "b44": (exr.COMP_B44, True),
    "b44a": (exr.COMP_B44A, True),
}


def _channels(seed: int = 42, h: int = 37, w: int = 53) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "R": rng.standard_normal((h, w)).astype(np.float32),
        "G": np.repeat(rng.random((h, 1)), w, axis=1).astype(np.float32),
        "B": rng.standard_normal((h, w)).astype(np.float32),
        "ID": rng.integers(0, 1000, (h, w)).astype(np.uint32),
    }


@pytest.mark.parametrize("comp", list(COMPRESSIONS))
def test_write_exr_bytes_equal_jax(tmp_path, comp):
    """The port writes the JAX package's bytes, and each package reads the
    other's file to the same channels."""
    code, half = COMPRESSIONS[comp]
    ch = _channels()
    exr.write_exr(tmp_path / "port.exr", ch, compression=code, half=half)
    jexr.write_exr(tmp_path / "jax.exr", ch, compression=code, half=half)
    raw = (tmp_path / "port.exr").read_bytes()
    assert raw == (tmp_path / "jax.exr").read_bytes()
    mine, w, h = exr.read_exr(tmp_path / "jax.exr")
    theirs, w2, h2 = jexr.read_exr(tmp_path / "port.exr")
    assert (w, h) == (w2, h2) == (53, 37)
    assert set(mine) == set(theirs) == set(ch)
    for k in ch:
        assert mine[k].dtype == theirs[k].dtype
        assert mine[k].tobytes() == theirs[k].tobytes(), k
    if not half and code != exr.COMP_PXR24:  # lossless: the inputs back
        for k, v in ch.items():
            np.testing.assert_array_equal(mine[k], v)


@pytest.mark.parametrize("n", [1, 300, 5000])
def test_piz_huffman_roundtrip(n):
    """The port's Huffman decode (pure Python) inverts JAX's encode and
    its own, and agrees with JAX's decode."""
    rng = np.random.default_rng(n)
    data = rng.integers(0, 50 if n < 1000 else 65536, n).astype(np.uint16)
    comp = jpiz.huf_compress(data)
    assert exr_piz.huf_compress(data) == comp
    np.testing.assert_array_equal(exr_piz.huf_uncompress(comp, n), data)
    np.testing.assert_array_equal(jpiz.huf_uncompress(comp, n), data)


def test_piz_block_roundtrip():
    rng = np.random.default_rng(3)
    raw = rng.integers(0, 65536, 3 * 16 * 4).astype("<u2").tobytes()
    block = exr_piz.piz_compress(raw, [2, 1, 1], 16, 3)
    assert block == jpiz.piz_compress(raw, [2, 1, 1], 16, 3)
    assert exr_piz.piz_uncompress(block, [2, 1, 1], 16, 3) == raw


def test_exr_image_texture_decodes(tmp_path):
    """An EXR image texture decodes in the port as in JAX (the port's
    materials.py imports its own utils.exr)."""
    rng = np.random.default_rng(0)
    ch = {k: rng.random((5, 7), dtype=np.float32) for k in ("R", "G", "B")}
    jexr.write_exr(tmp_path / "t.exr", ch)
    raw = (tmp_path / "t.exr").read_bytes()
    got = Image.load_from_bytes(raw).data
    want = JImage.load_from_bytes(raw).data
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("exposure", [1.0, 1000.0])
def test_save_png_equals_jax(tmp_path, exposure):
    """The port's save_png writes JAX's file, byte for byte: the same
    pixels and the same gamma. Neither writes a gAMA chunk: Pillow's PNG
    writer ignores the `gamma` argument that save_png passes it."""
    rgb = (np.random.default_rng(5).random((9, 11, 3)) * 2 * exposure
           ).astype(np.float32)
    png.save_png(tmp_path / "port.png", rgb, exposure=exposure)
    jpng.save_png(tmp_path / "jax.png", rgb, exposure=exposure)
    assert ((tmp_path / "port.png").read_bytes()
            == (tmp_path / "jax.png").read_bytes())
    with PILImage.open(tmp_path / "port.png") as img, PILImage.open(
            tmp_path / "jax.png") as want:
        assert img.info.get("gamma") == want.info.get("gamma")
        np.testing.assert_array_equal(np.asarray(img), np.asarray(want))
        assert np.asarray(img).shape == (9, 11, 3)
    np.testing.assert_array_equal(png.normals_to_rgb(rgb),
                                  jpng.normals_to_rgb(rgb))
    np.testing.assert_array_equal(png.uvs_to_rgb(rgb[..., :2]),
                                  jpng.uvs_to_rgb(rgb[..., :2]))
