"""A small PNG codec on the standard library (``zlib``, ``struct``) and numpy.

The dataset readers decode with Pillow where it is installed, as the JAX
package does; on a host without Pillow they read the same files with
:func:`read_png`.  Scope: 8-bit greyscale, RGB and RGBA, non-interlaced,
with all five scanline filters.  Any other PNG (palette, greyscale with
alpha, a bit depth other than 8, Adam7 interlacing) raises a
``ValueError`` that names the missing feature.  A chunk whose CRC does
not match, or a stream that ends early, raises too, as Pillow does, so
a corrupted file is never decoded into a wrong image.

Arrays have Pillow's shapes and types: (H, W) for greyscale, (H, W, 3)
for RGB, (H, W, 4) for RGBA, uint8; (H, W) uint16 for 16-bit greyscale
(big-endian samples in the file, native order in the array).

Filters None, Sub and Up unfilter a whole row at once in numpy.  Average
and Paeth depend on the pixel to their left after it is unfiltered, so
they run a Python loop over the row's bytes, far slower than the
other three (PERF.md gives the cost); :func:`write_png` writes filter
None unless told otherwise.
"""

from __future__ import annotations

import struct
import zlib
from typing import Union

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: colour type → channels, for the types this codec reads
_CHANNELS = {0: 1, 2: 3, 6: 4}
_COLOUR_NAMES = {3: "palette (colour type 3)", 4: "greyscale with alpha (colour type 4)"}


def _chunks(data: bytes):
    """(type, payload) of every chunk, CRC-checked, up to IEND."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos = 8
    while True:
        if pos + 8 > len(data):
            raise ValueError("truncated PNG: the stream ends before IEND")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 8 + length
        if end + 4 > len(data):
            raise ValueError(f"truncated PNG: chunk {kind!r} runs past the end of the file")
        payload = data[pos + 8:end]
        (crc,) = struct.unpack(">I", data[end:end + 4])
        if zlib.crc32(kind + payload) != crc:
            raise ValueError(f"corrupted PNG: CRC mismatch in chunk {kind!r}")
        yield kind, payload
        if kind == b"IEND":
            return
        pos = end + 4


def _paeth_row(line: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        line[i] = (line[i] + pred) & 0xFF


def _average_row(line: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        line[i] = (line[i] + ((a + prev[i]) >> 1)) & 0xFF


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters: ``raw`` holds ``height`` rows of one
    filter byte and ``stride`` bytes each."""
    if len(raw) < height * (stride + 1):
        raise ValueError("truncated PNG: the image data holds fewer rows than the header says")
    rows = np.frombuffer(raw, np.uint8, height * (stride + 1)).reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            out[y] = line
        elif kind == 1:  # Sub: a running sum over the row, per byte of a pixel, mod 256
            out[y] = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            out[y] = line + prev
        elif kind in (3, 4):
            buf = bytearray(line.tobytes())
            (_average_row if kind == 3 else _paeth_row)(buf, prev.tobytes(), bpp)
            out[y] = np.frombuffer(buf, np.uint8)
        else:
            raise ValueError(f"corrupted PNG: unknown filter type {kind} in row {y}")
        prev = out[y]
    return out


def read_png(source: Union[str, bytes, bytearray]) -> np.ndarray:
    """Decode a PNG file (a path, or the file's bytes) into an array of
    Pillow's shape: uint8 (H, W), (H, W, 3) or (H, W, 4); uint16 (H, W)."""
    if isinstance(source, (bytes, bytearray)):
        data = bytes(source)
    else:
        with open(source, "rb") as f:
            data = f.read()
    header, idat = None, []
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError("corrupted PNG: no IHDR chunk")
    width, height, depth, colour, compression, filter_method, interlace = header
    if colour not in _CHANNELS:
        raise ValueError(f"unsupported PNG: {_COLOUR_NAMES.get(colour, f'colour type {colour}')}; "
                         "this codec reads 8-bit greyscale, RGB and RGBA")
    if depth != 8 and not (depth == 16 and colour == 0):
        raise ValueError(f"unsupported PNG: bit depth {depth} in colour type {colour}; this codec reads 8-bit "
                         "samples and 16-bit greyscale only")
    if interlace != 0:
        raise ValueError("unsupported PNG: Adam7 interlacing; this codec reads non-interlaced files only")
    if compression != 0 or filter_method != 0:
        raise ValueError(f"corrupted PNG: compression method {compression}, filter method {filter_method}")
    if not idat:
        raise ValueError("corrupted PNG: no IDAT chunk")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"corrupted PNG: {e}") from None
    c = _CHANNELS[colour]
    if depth == 16:  # greyscale: 2 bytes a pixel, big-endian
        rows = _unfilter(raw, height, width * 2, 2)
        return rows.view(">u2").reshape(height, width).astype(np.uint16)
    pixels = _unfilter(raw, height, width * c, c).reshape(height, width, c)
    return pixels[..., 0] if c == 1 else pixels


def write_png(path: str, array: np.ndarray, filter_type: int = 0, level: int = 6) -> None:
    """Write a uint8 (H, W), (H, W, 1), (H, W, 3) or (H, W, 4) array as an
    8-bit greyscale, RGB or RGBA PNG, or a uint16 (H, W) or (H, W, 1)
    array as a 16-bit greyscale one, every row with ``filter_type``
    (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth), deflated at ``level``."""
    arr = np.asarray(array)
    if arr.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"write_png takes uint8 or uint16 arrays, got {arr.dtype}")
    if arr.ndim == 2:
        arr = arr[..., None]
    if arr.ndim != 3 or arr.shape[2] not in (1, 3, 4):
        raise ValueError(f"write_png takes (H, W), (H, W, 1), (H, W, 3) or (H, W, 4), got {arr.shape}")
    if arr.dtype == np.uint16 and arr.shape[2] != 1:
        raise ValueError(f"write_png writes uint16 as greyscale only, got {arr.shape}")
    if filter_type not in range(5):
        raise ValueError(f"filter_type {filter_type}: PNG has filters 0-4")
    h, w, c = arr.shape
    colour = {1: 0, 3: 2, 4: 6}[c]
    depth = 8 * arr.dtype.itemsize
    bpp = c * arr.dtype.itemsize  # the filters' "pixel to the left", in bytes
    raw = np.ascontiguousarray(arr.astype(arr.dtype.newbyteorder(">"))).view(np.uint8)
    rows = raw.reshape(h, w * bpp).astype(np.int16)
    left = np.zeros_like(rows)
    left[:, bpp:] = rows[:, :-bpp]
    up = np.zeros_like(rows)
    up[1:] = rows[:-1]
    if filter_type == 0:
        pred = np.zeros_like(rows)
    elif filter_type == 1:
        pred = left
    elif filter_type == 2:
        pred = up
    elif filter_type == 3:
        pred = (left + up) >> 1
    else:
        upleft = np.zeros_like(rows)
        upleft[1:, bpp:] = rows[:-1, :-bpp]
        pa, pb, pc = np.abs(up - upleft), np.abs(left - upleft), np.abs(left + up - 2 * upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    body = np.empty((h, w * bpp + 1), np.uint8)
    body[:, 0] = filter_type
    body[:, 1:] = (rows - pred) & 0xFF

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return struct.pack(">I", len(payload)) + kind + payload + struct.pack(">I", zlib.crc32(kind + payload))

    data = (_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(body.tobytes(), level)) + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)
