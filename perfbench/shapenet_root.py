"""A ShapeNet-layout root of 512-px RGBA PNGs, written from the seed.

The layout is the renderer's, as ``chip_smoke.write_shapenet_root``
writes it and the port's ``data/shapenet.py`` reads it (frozen here)::

    root/cad_names.txt                         "<synset>_cad<j>" per line
    root/images/obj_<id>/query_<i>.png         ``queries`` an object
    root/images/obj_<id>/reference_<i>.png     ``references`` an object
    root/images/obj_<id>/templates_<g>.png     the 642 level-2 grid poses
    root/object_{query,reference,template}_poses/obj_<id>.npy

Only the objects of the training split are written: of ``listed`` cads a
category, those past the first 50 of the split's seeded shuffle
(``random.Random(2023)``, one stream over the categories in the order the
split takes them).  Poses are level-2 grid poses with the translation
doubled, 1 m in front of the camera; a query's and a reference's are
drawn from the seed, a template's is its grid pose.  Every image is one
of ``distinct_images`` drawn from the seed (colour cells with noise under
an alpha disc) and hard-linked, so an epoch can outlast the window while
a run writes a few MB; each path has a pose of its own, so each crop
differs.  The PNGs are written here (zlib level 1, no filter), not by the
program's codec, which reads them.
"""

from __future__ import annotations

import os
import random
import struct
import zlib
from pathlib import Path

import numpy as np

from perfbench import inputs

SPLIT_SEED, SPLIT_HELD_OUT = 2023, 50
GRID_POSES = 642


def write_png(path, image: np.ndarray, level: int = 1) -> None:
    """(H, W, 3 or 4) uint8 → an 8-bit RGB or RGBA PNG, every row unfiltered."""
    h, w, c = image.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), image.reshape(h, w * c)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    header = struct.pack(">IIBBBBB", w, h, 8, {3: 2, 4: 6}[c], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header) + chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
                + chunk(b"IEND", b""))


def training_objects(categories: int, listed: int) -> list:
    """The object ids of the training split: category c lists ids
    c·listed .. (c+1)·listed - 1; each list shuffled in turn by one
    ``random.Random(2023)``, and all but its first 50 kept."""
    rng = random.Random(SPLIT_SEED)
    out = []
    for c in range(categories):
        ids = list(range(c * listed, (c + 1) * listed))
        rng.shuffle(ids)
        out.extend(ids[SPLIT_HELD_OUT:])
    return out


def grid_poses() -> np.ndarray:
    """(642, 4, 4) level-2 object poses (the program's asset, read as a raw
    file), the translation doubled."""
    poses = np.load(inputs.ASSETS / "obj_poses_level2.npy").astype(np.float64)
    poses[:, :3, 3] *= 2.0
    return poses


def image(gen: np.random.Generator, px: int) -> np.ndarray:
    """16 x 16 colour cells with noise, under an alpha disc of radius 0.35 px."""
    yy, xx = np.mgrid[:px, :px]
    alpha = (((yy - px / 2) ** 2 + (xx - px / 2) ** 2 <= (0.35 * px) ** 2) * 255).astype(np.uint8)
    cells = gen.integers(0, 248, (16, 16, 3), dtype=np.uint8)
    rgb = np.repeat(np.repeat(cells, px // 16, 0), px // 16, 1)
    return np.dstack([rgb + gen.integers(0, 8, rgb.shape, dtype=np.uint8), alpha])


def write(root: Path, spec: dict, seed: int) -> dict:
    """Write the root of ``spec`` (``categories``: [[name, synset], ...] in
    the split's order, ``listed``, ``queries``, ``references``,
    ``distinct_images``, ``image_px``) from ``seed``.  Returns what was
    written: {"queries": training queries, "pool": the distinct RGBA
    images, "views": {object id: {kind: (grid pose index, pool index) of
    each path}}} with kind "query", "reference" or "template"."""
    root = Path(root)
    root.mkdir(parents=True)
    cats, listed = spec["categories"], spec["listed"]
    (root / "cad_names.txt").write_text("".join(f"{synset}_cad{j}\n" for _, synset in cats for j in range(listed)))
    (root / "pool").mkdir()
    gen = inputs.rng(seed, 11)
    pool = [image(gen, spec["image_px"]) for _ in range(spec["distinct_images"])]
    for k, rgba in enumerate(pool):
        write_png(root / "pool" / f"{k:03d}.png", rgba)
    grid = grid_poses()
    gen = inputs.rng(seed, 12)
    for kind in ("query", "reference", "template"):
        (root / f"object_{kind}_poses").mkdir()
    views = {}
    for obj in training_objects(len(cats), listed):
        name = f"obj_{obj:06d}"
        folder = root / "images" / name
        folder.mkdir(parents=True)
        views[obj] = {kind: (gen.integers(0, GRID_POSES, n), gen.integers(0, len(pool), n))
                      for kind, n in (("query", spec["queries"]), ("reference", spec["references"]))}
        views[obj]["template"] = (np.arange(GRID_POSES), gen.integers(0, len(pool), GRID_POSES))
        for kind, stem in (("query", "query"), ("reference", "reference"), ("template", "templates")):
            poses, images = views[obj][kind]
            np.save(root / f"object_{kind}_poses" / f"{name}.npy", grid if kind == "template" else grid[poses])
            for i, k in enumerate(images):
                os.link(root / "pool" / f"{k:03d}.png", folder / f"{stem}_{i:06d}.png")
    return {"queries": len(views) * spec["queries"], "pool": pool, "views": views}
