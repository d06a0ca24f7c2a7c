"""Seeded inputs and weights.  Everything a run feeds both the program
and the reference is made here from ``--seed``: the template grids (read
from the program's ``.npy`` assets as raw files), the evaluation
batches (a copy of ``chip_smoke.py``'s ``eval_batch`` in numpy), the
images, and the weights, drawn on the device in one call over the
reference's parameters and loaded, the same, into both sides.
"""

from __future__ import annotations

import importlib
import math
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
ASSETS = ROOT / "nope_tpu_torch" / "geometry" / "assets"


def rng(seed: int, *stream: int) -> np.random.Generator:
    """An independent numpy stream per (seed, stream...)."""
    return np.random.default_rng(np.random.SeedSequence([int(seed) % 2**64, *stream]))


def template_grid(protocol: str) -> np.ndarray:
    """(N, 3, 3) float32 object rotations of the level-2 grid: "full" keeps
    the upper hemisphere (341), "fast" the level-0 poses within it (26)."""
    obj = np.load(ASSETS / "obj_poses_level2.npy")
    if protocol == "full":
        cam = np.load(ASSETS / "sphere_poses_level2.npy")
        poses = obj[cam[:, 2, 3] >= 0]
    elif protocol == "fast":
        poses = obj[np.load(ASSETS / "idx_upper_level0_in_level2.npy")]
    else:
        raise ValueError(f"unknown protocol {protocol!r}")
    return np.ascontiguousarray(poses[:, :3, :3], dtype=np.float32)


def rotation_6d(r: np.ndarray) -> np.ndarray:
    """The first two rows of each rotation, flattened."""
    return np.ascontiguousarray(r[..., :2, :].reshape(*r.shape[:-2], 6))


def eval_batch(grid: np.ndarray, b: int, img: int, gen: np.random.Generator) -> dict:
    """One evaluation batch: the reference at grid pose 0, queries at
    seeded grid poses, seeded images in [-1, 1], symmetry 0/1/2."""
    n = len(grid)
    query_pose = grid[gen.integers(0, n, b)]
    ref_t = grid[0].T
    return {
        "query": gen.uniform(-1, 1, (b, img, img, 3)).astype(np.float32),
        "reference": gen.uniform(-1, 1, (b, img, img, 3)).astype(np.float32),
        "gt_relativeR": rotation_6d(query_pose @ ref_t),
        "all_relativeR": np.ascontiguousarray(np.broadcast_to(rotation_6d(grid @ ref_t), (b, n, 6))),
        "query_pose": query_pose,
        "template_poses": np.ascontiguousarray(np.broadcast_to(grid, (b, n, 3, 3))),
        "symmetry": np.arange(b) % 3,
    }


def images(gen: np.random.Generator, count: int, img: int) -> np.ndarray:
    """(count, img, img, 3) uint8 images."""
    return gen.integers(0, 256, (count, img, img, 3), dtype=np.uint8)


def resolve(path: str):
    """``"package.module:Name"`` → the object; a path without a package
    (``"unet:PoseUNet"``) is a module of ``perfbench.reference``."""
    module, name = path.split(":")
    if "." not in module:
        module = f"perfbench.reference.{module}"
    return getattr(importlib.import_module(module), name)


def meta_modules(cfg: dict, side: str) -> dict:
    """The configuration's ``parts`` of ``side`` ("program" or
    "reference"), built on the meta device."""
    with torch.device("meta"):
        return {part: resolve(cfg[part][side])(**cfg[part]["args"]) for part in cfg["parts"]}


def seeded_state(modules: dict, seed: int, device: torch.device) -> dict:
    """One state dict for ``modules`` ({prefix: module}), drawn on
    ``device`` by one ``torch.randn`` from ``seed`` over the parameters in
    sorted name order (so the order in which a module registers them does
    not matter): conv and linear weights N(0, 1/fan_in), norm scales
    1 + N(0, 0.01), biases N(0, 0.01).  Every layer is drawn, so none is
    left at zero."""
    entries = sorted((f"{prefix}.{name}", tuple(p.shape)) for prefix, m in modules.items()
                     for name, p in m.named_parameters())
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**63)
    flat = torch.randn(sum(math.prod(s) for _, s in entries), generator=gen, device=device)
    state, off = {}, 0
    for name, shape in entries:
        v = flat[off:off + math.prod(shape)].view(shape)
        off += v.numel()
        if len(shape) >= 2:
            v.mul_(1.0 / math.sqrt(math.prod(shape[1:])))
        elif name.endswith("weight"):
            v.mul_(0.1).add_(1.0)
        else:
            v.mul_(0.1)
        state[name] = v
    return state


def state_for(cfg: dict, seed: int, device: torch.device) -> dict:
    """The one state dict of a run: drawn over the reference's modules and
    loaded, the same, into the program's and the reference's."""
    return seeded_state(meta_modules(cfg, "reference"), seed, device)


def load(modules: dict, state: dict, device: torch.device, frozen: bool = False) -> dict:
    """Meta modules made real on ``device`` and given ``state`` strictly
    (each module's tensors are exactly the state's under its prefix), in
    eval mode; ``frozen`` turns their gradients off."""
    out = {}
    for prefix, m in modules.items():
        m = m.to_empty(device=device)
        m.load_state_dict({k[len(prefix) + 1:]: v for k, v in state.items() if k.startswith(prefix + ".")},
                          strict=True)
        out[prefix] = m.eval().requires_grad_(not frozen)
    return out
