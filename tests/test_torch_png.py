"""The port's PNG codec (``nope_tpu_torch.data.png``, 8-bit and 16-bit
greyscale) against Pillow, and the ShapeNet reader on a host without
Pillow (a subprocess with Pillow blocked) against the reader with Pillow."""

import io
import os
import subprocess
import sys
import textwrap
import zlib

import numpy as np
import pytest
from PIL import Image

from nope_tpu_torch.data import png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = {"L": (23, 31), "RGB": (23, 31, 3), "RGBA": (23, 31, 4)}


def _array(mode, seed=0, smooth=False):
    rng = np.random.default_rng(seed)
    shape = MODES[mode]
    if smooth:  # a gradient with noise: Pillow's adaptive filter then mixes filter types
        base = np.add.outer(np.arange(shape[0]) * 5, np.arange(shape[1]) * 3)
        base = base.reshape(shape[:2] + (1,) * (len(shape) - 2))
        return ((base + rng.integers(0, 6, shape)) % 256).astype(np.uint8)
    return rng.integers(0, 256, shape, dtype=np.uint8)


def _pillow_bytes(arr, mode, **kw):
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, "PNG", **kw)
    return buf.getvalue()


def _png_bytes(w, h, depth, colour, raw):
    """A PNG of one IDAT chunk holding ``raw`` (filter bytes included)."""
    def chunk(kind, payload):
        return len(payload).to_bytes(4, "big") + kind + payload + zlib.crc32(kind + payload).to_bytes(4, "big")

    header = w.to_bytes(4, "big") + h.to_bytes(4, "big") + bytes([depth, colour, 0, 0, 0])
    return b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header) + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


def _filters_used(data):
    """The filter byte of every row of a non-interlaced PNG (8-bit, or
    16-bit greyscale)."""
    w, h = int.from_bytes(data[16:20], "big"), int.from_bytes(data[20:24], "big")
    c = {0: 1, 2: 3, 6: 4}[data[25]] * data[24] // 8
    pos, idat = 8, b""
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += n + 12
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, w * c + 1)
    return set(raw[:, 0].tolist())


@pytest.mark.parametrize("smooth", [False, True])
@pytest.mark.parametrize("mode", list(MODES))
def test_read_png_matches_pillow_on_pillow_files(mode, smooth, tmp_path):
    arr = _array(mode, smooth=smooth)
    data = _pillow_bytes(arr, mode)
    (tmp_path / "a.png").write_bytes(data)
    want = np.asarray(Image.open(tmp_path / "a.png"))
    for got in (png.read_png(data), png.read_png(str(tmp_path / "a.png"))):
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(want, arr)


def test_pillow_files_cover_several_filters():
    """The adaptive filter of Pillow's encoder: the smooth images above
    use more than one filter type, so mixed-filter files are read."""
    used = set()
    for mode in MODES:
        used |= _filters_used(_pillow_bytes(_array(mode, smooth=True), mode))
    assert len(used) >= 2, used


@pytest.mark.parametrize("filter_type", range(5))
@pytest.mark.parametrize("mode", list(MODES))
def test_each_filter_type_round_trips(mode, filter_type, tmp_path):
    arr = _array(mode, seed=filter_type)
    png.write_png(str(tmp_path / "a.png"), arr, filter_type=filter_type)
    data = (tmp_path / "a.png").read_bytes()
    assert _filters_used(data) == {filter_type}
    np.testing.assert_array_equal(png.read_png(data), arr)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "a.png")), arr)  # Pillow reads what we write


def _depth16(seed=0, smooth=False):
    rng = np.random.default_rng(seed)
    if smooth:  # a depth-like ramp: Pillow's adaptive filter mixes filter types
        base = np.add.outer(np.arange(23) * 700, np.arange(31) * 300) + 4000
        return (base + rng.integers(0, 40, (23, 31))).astype(np.uint16)
    return rng.integers(0, 65536, (23, 31), dtype=np.uint16)


@pytest.mark.parametrize("smooth", [False, True])
def test_16bit_greyscale_matches_pillow(smooth, tmp_path):
    """A Pillow-written ``I;16`` PNG (BOP's depth maps) decodes to Pillow's
    uint16 array."""
    arr = _depth16(smooth=smooth)
    Image.fromarray(arr).save(tmp_path / "d.png")
    want = np.asarray(Image.open(tmp_path / "d.png"))
    assert Image.open(tmp_path / "d.png").mode == "I;16" and want.dtype == np.uint16
    got = png.read_png(str(tmp_path / "d.png"))
    assert got.dtype == np.uint16 and got.shape == (23, 31)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, arr)
    if smooth:
        assert len(_filters_used((tmp_path / "d.png").read_bytes())) >= 2


@pytest.mark.parametrize("filter_type", range(5))
def test_16bit_greyscale_round_trips(filter_type, tmp_path):
    arr = _depth16(seed=filter_type)
    png.write_png(str(tmp_path / "d.png"), arr, filter_type=filter_type)
    data = (tmp_path / "d.png").read_bytes()
    assert _filters_used(data) == {filter_type} and data[24:26] == bytes([16, 0])
    np.testing.assert_array_equal(png.read_png(data), arr)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "d.png")), arr)  # Pillow reads what we write
    with pytest.raises(ValueError, match="greyscale only"):
        png.write_png(str(tmp_path / "e.png"), np.zeros((4, 4, 3), np.uint16))


@pytest.mark.parametrize("kind, expect", [
    ("palette", "palette"),
    ("16-bit", "bit depth 16"),
    ("interlaced", "Adam7"),
    ("greyscale+alpha", "greyscale with alpha"),
])
def test_unsupported_pngs_raise(kind, expect):
    rng = np.random.default_rng(1)
    if kind == "palette":
        data = _pillow_bytes(rng.integers(0, 4, (8, 8), dtype=np.uint8), "L")
        img = Image.open(io.BytesIO(data)).convert("P")
        buf = io.BytesIO()
        img.save(buf, "PNG")
        data = buf.getvalue()
    elif kind == "16-bit":  # 16-bit colour (16-bit greyscale is read: test_16bit_greyscale_*)
        data = _png_bytes(8, 8, 16, 2, np.zeros((8, 1 + 8 * 6), np.uint8).tobytes())
    elif kind == "interlaced":  # Pillow writes no Adam7 file: mark one interlaced in its header
        data = bytearray(_pillow_bytes(_array("RGB"), "RGB"))
        data[28] = 1
        data[29:33] = zlib.crc32(bytes(data[12:29])).to_bytes(4, "big")
        data = bytes(data)
    else:
        data = _pillow_bytes(rng.integers(0, 256, (8, 8, 2), dtype=np.uint8), "LA")
    with pytest.raises(ValueError, match=expect):
        png.read_png(data)


def test_corrupted_files_raise():
    data = bytearray(_pillow_bytes(_array("RGB"), "RGB"))
    with pytest.raises(ValueError, match="signature"):
        png.read_png(b"GIF89a" + bytes(data[6:]))
    with pytest.raises(ValueError, match="truncated"):
        png.read_png(bytes(data[: len(data) // 2]))
    flipped = bytearray(data)
    flipped[60] ^= 0xFF  # inside the IDAT payload
    with pytest.raises(ValueError, match="CRC"):
        png.read_png(bytes(flipped))
    with pytest.raises(ValueError, match="uint8"):
        png.write_png("unused.png", np.zeros((4, 4), np.float32))


def test_shapenet_reader_without_pillow_gives_the_same_items(tmp_path):
    """The same root read in a process where Pillow cannot be imported
    (the port's codec decodes) and in this one (Pillow decodes), cv2
    cropping both: equal items."""
    from tests.fixtures import make_mini_shapenet
    from nope_tpu_torch.data.shapenet import ShapeNetDataset, decoder

    root = make_mini_shapenet(str(tmp_path / "root"), categories=("bottle",), objects_per_cat=1)
    assert decoder() == "pillow"
    want = ShapeNetDataset(root, "bottle", img_size=32, load_gt_templates=True)
    np.savez(tmp_path / "want.npz", **{f"{i}/{k}": v for i in range(len(want)) for k, v in want[i].items()})
    code = textwrap.dedent(f"""
        import sys
        sys.modules["PIL"] = None
        import numpy as np
        from nope_tpu_torch.data.shapenet import ShapeNetDataset, decoder
        assert decoder() == "png"
        ds = ShapeNetDataset({root!r}, "bottle", img_size=32, load_gt_templates=True)
        np.savez({str(tmp_path / 'got.npz')!r}, **{{f"{{i}}/{{k}}": v for i in range(len(ds)) for k, v in ds[i].items()}})
        assert "PIL" not in [m.split(".")[0] for m, v in sys.modules.items() if v is not None]
        print("ok")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-3000:]
    with np.load(tmp_path / "want.npz") as w, np.load(tmp_path / "got.npz") as g:
        assert sorted(w.files) == sorted(g.files)
        for k in w.files:
            np.testing.assert_array_equal(w[k], g[k], err_msg=k)
