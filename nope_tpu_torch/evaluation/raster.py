"""Depth rasterisation for VSD without GL, numpy only
(``nope_tpu/evaluation/raster.py``).

A z-buffer triangle rasteriser and small OBJ / PLY mesh loaders (PLY
ascii and binary little-endian), the renderer that
:func:`nope_tpu_torch.evaluation.vsd.make_renderer` takes where pyrender
is not installed or cannot open an offscreen context, and with
``renderer="numpy"``.

It renders what the pyrender route renders: an OpenCV camera at the
origin, the object moved by each 4x4 pose, depth = camera-space z
(perspective-correct through screen-space 1/z interpolation), 0 where no
surface projects.
"""

from __future__ import annotations

import struct
from typing import List, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# minimal mesh IO (OBJ ascii + PLY ascii/binary_little_endian)
# ---------------------------------------------------------------------------


def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Vertices (V, 3) float64 and triangle faces (F, 3) int32 from a
    Wavefront OBJ (v/f records; polygons are fan-triangulated)."""
    verts: List[List[float]] = []
    faces: List[List[int]] = []
    with open(path, "r") as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                idx = [int(p.split("/")[0]) - 1 for p in parts[1:]]
                for i in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[i], idx[i + 1]])
    return np.asarray(verts, dtype=np.float64), np.asarray(faces, dtype=np.int32)


_PLY_TYPES = {
    "char": ("b", 1), "int8": ("b", 1),
    "uchar": ("B", 1), "uint8": ("B", 1),
    "short": ("h", 2), "int16": ("h", 2),
    "ushort": ("H", 2), "uint16": ("H", 2),
    "int": ("i", 4), "int32": ("i", 4),
    "uint": ("I", 4), "uint32": ("I", 4),
    "float": ("f", 4), "float32": ("f", 4),
    "double": ("d", 8), "float64": ("d", 8),
}


def load_ply(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Vertices + triangle faces from an ascii or binary_little_endian
    PLY (the BOP CAD model format).  Only x/y/z and the face index list
    are read; extra per-vertex properties are skipped."""
    with open(path, "rb") as fh:
        if fh.readline().strip() != b"ply":
            raise ValueError(f"not a PLY file: {path}")
        fmt = None
        elements: List[Tuple[str, int, list]] = []  # (name, count, props)
        while True:
            line = fh.readline()
            if not line:
                raise ValueError("unterminated PLY header")
            tokens = line.decode("ascii", "replace").split()
            if not tokens:
                continue
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "element":
                elements.append((tokens[1], int(tokens[2]), []))
            elif tokens[0] == "property":
                if tokens[1] == "list":
                    elements[-1][2].append(("list", tokens[2], tokens[3], tokens[4]))
                else:
                    elements[-1][2].append(("scalar", tokens[1], tokens[2]))
            elif tokens[0] == "end_header":
                break
        if fmt not in ("ascii", "binary_little_endian"):
            raise ValueError(f"unsupported PLY format {fmt!r}")

        verts = np.zeros((0, 3))
        faces: List[List[int]] = []
        for name, count, props in elements:
            if fmt == "ascii":
                rows = [fh.readline().split() for _ in range(count)]
                if name == "vertex":
                    names = [p[2] for p in props if p[0] == "scalar"]
                    xi, yi, zi = names.index("x"), names.index("y"), names.index("z")
                    verts = np.array(
                        [[float(r[xi]), float(r[yi]), float(r[zi])] for r in rows]
                    )
                elif name == "face":
                    for r in rows:
                        n = int(r[0])
                        idx = [int(v) for v in r[1 : 1 + n]]
                        for i in range(1, n - 1):
                            faces.append([idx[0], idx[i], idx[i + 1]])
                continue
            # binary_little_endian
            if name == "vertex":
                scalar_fmt = "<" + "".join(
                    _PLY_TYPES[p[1]][0] for p in props if p[0] == "scalar"
                )
                row_size = struct.calcsize(scalar_fmt)
                names = [p[2] for p in props if p[0] == "scalar"]
                xi, yi, zi = names.index("x"), names.index("y"), names.index("z")
                raw = fh.read(row_size * count)
                rows = list(struct.iter_unpack(scalar_fmt, raw))
                verts = np.array(
                    [[r[xi], r[yi], r[zi]] for r in rows], dtype=np.float64
                )
            elif name == "face":
                (kind, cnt_t, idx_t, _), = [p for p in props if p[0] == "list"] or [
                    (None, None, None, None)
                ]
                if kind is None:
                    continue
                cfmt, csz = _PLY_TYPES[cnt_t]
                ifmt, isz = _PLY_TYPES[idx_t]
                for _ in range(count):
                    (n,) = struct.unpack("<" + cfmt, fh.read(csz))
                    idx = struct.unpack("<" + ifmt * n, fh.read(isz * n))
                    for i in range(1, n - 1):
                        faces.append([idx[0], idx[i], idx[i + 1]])
            else:  # skip unknown scalar-only elements
                scalar_fmt = "<" + "".join(
                    _PLY_TYPES[p[1]][0] for p in props if p[0] == "scalar"
                )
                fh.seek(struct.calcsize(scalar_fmt) * count, 1)
    return verts, np.asarray(faces, dtype=np.int32)


def load_mesh_arrays(path: str) -> Tuple[np.ndarray, np.ndarray]:
    if path.lower().endswith(".obj"):
        return load_obj(path)
    if path.lower().endswith(".ply"):
        return load_ply(path)
    raise ValueError(f"unsupported mesh format: {path}")


def box_mesh(extents: Sequence[float] = (1.0, 1.0, 1.0)) -> Tuple[np.ndarray, np.ndarray]:
    """Axis-aligned box centered at the origin (12 triangles)."""
    ex, ey, ez = [e / 2.0 for e in extents]
    verts = np.array(
        [[sx * ex, sy * ey, sz * ez]
         for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
        dtype=np.float64,
    )  # index = 4*x + 2*y + z with bits in {0,1}
    quads = [
        (0, 1, 3, 2),  # -x
        (4, 6, 7, 5),  # +x
        (0, 4, 5, 1),  # -y
        (2, 3, 7, 6),  # +y
        (0, 2, 6, 4),  # -z
        (1, 5, 7, 3),  # +z
    ]
    faces = []
    for a, b, c, d in quads:
        faces.append([a, b, c])
        faces.append([a, c, d])
    return verts, np.asarray(faces, dtype=np.int32)


# ---------------------------------------------------------------------------
# z-buffer rasteriser
# ---------------------------------------------------------------------------


def rasterize_depth(
    vertices: np.ndarray,
    faces: np.ndarray,
    pose: np.ndarray,
    K: np.ndarray,
    img_shape: Tuple[int, int],
) -> np.ndarray:
    """(H, W) depth map of the mesh under ``pose`` (object→camera 4x4)
    seen by an OpenCV pinhole camera ``K`` at the origin.  Depth is
    camera-space z; 0 = background."""
    H, W = int(img_shape[0]), int(img_shape[1])
    v_cam = vertices @ np.asarray(pose)[:3, :3].T + np.asarray(pose)[:3, 3]
    z = v_cam[:, 2]
    K = np.asarray(K, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        u = (K[0, 0] * v_cam[:, 0] + K[0, 2] * z) / z
        v = (K[1, 1] * v_cam[:, 1] + K[1, 2] * z) / z

    depth = np.zeros((H, W), dtype=np.float64)
    for f in np.asarray(faces):
        tz = z[f]
        if np.any(tz <= 1e-9):  # triangle behind the camera: skip
            continue
        tu, tv = u[f], v[f]
        u_lo = max(int(np.floor(tu.min())), 0)
        u_hi = min(int(np.ceil(tu.max())), W - 1)
        v_lo = max(int(np.floor(tv.min())), 0)
        v_hi = min(int(np.ceil(tv.max())), H - 1)
        if u_lo > u_hi or v_lo > v_hi:
            continue
        denom = (tv[1] - tv[2]) * (tu[0] - tu[2]) + (tu[2] - tu[1]) * (tv[0] - tv[2])
        if abs(denom) < 1e-12:  # degenerate in screen space
            continue
        gu, gv = np.meshgrid(
            np.arange(u_lo, u_hi + 1) + 0.5, np.arange(v_lo, v_hi + 1) + 0.5
        )
        w0 = ((tv[1] - tv[2]) * (gu - tu[2]) + (tu[2] - tu[1]) * (gv - tv[2])) / denom
        w1 = ((tv[2] - tv[0]) * (gu - tu[2]) + (tu[0] - tu[2]) * (gv - tv[2])) / denom
        w2 = 1.0 - w0 - w1
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        if not inside.any():
            continue
        # perspective-correct: 1/z is linear in screen space
        zinv = w0 / tz[0] + w1 / tz[1] + w2 / tz[2]
        with np.errstate(divide="ignore"):
            zpix = 1.0 / zinv
        tile = depth[v_lo : v_hi + 1, u_lo : u_hi + 1]
        closer = inside & ((tile == 0.0) | (zpix < tile))
        tile[closer] = zpix[closer]
    return depth


def sample_surface(
    vertices: np.ndarray, faces: np.ndarray, n: int, rng=None
) -> np.ndarray:
    """(n, 3) area-weighted uniform surface samples (the trimesh
    ``sample_surface`` analogue, dependency-free)."""
    rng = np.random.default_rng() if rng is None else rng
    tri = np.asarray(vertices)[np.asarray(faces)]  # (F, 3, 3)
    areas = 0.5 * np.linalg.norm(
        np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=1
    )
    total = areas.sum()
    probs = np.full(len(areas), 1.0 / len(areas)) if total <= 0 else areas / total
    idx = rng.choice(len(tri), size=n, p=probs)
    u = rng.uniform(size=n)
    v = rng.uniform(size=n)
    flip = u + v > 1.0
    u[flip], v[flip] = 1.0 - u[flip], 1.0 - v[flip]
    t = tri[idx]
    return t[:, 0] + u[:, None] * (t[:, 1] - t[:, 0]) + v[:, None] * (t[:, 2] - t[:, 0])


class NumpyDepthRenderer:
    """Injectable renderer with the ``vsd._render_depths`` contract:
    ``renderer(poses, K, img_shape) -> [depth, ...]``."""

    backend = "numpy"

    def __init__(self, vertices: np.ndarray, faces: np.ndarray):
        self.vertices = np.asarray(vertices, dtype=np.float64)
        self.faces = np.asarray(faces, dtype=np.int32)

    @classmethod
    def from_file(cls, path: str) -> "NumpyDepthRenderer":
        return cls(*load_mesh_arrays(path))

    def __call__(self, poses: np.ndarray, K: np.ndarray, img_shape) -> List[np.ndarray]:
        return [
            rasterize_depth(self.vertices, self.faces, p, K, img_shape)
            for p in np.asarray(poses).reshape(-1, 4, 4)
        ]
