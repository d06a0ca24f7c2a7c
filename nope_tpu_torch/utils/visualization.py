"""The retrieval panel of ``evaluation.geodesic`` (``nope_tpu/utils/visualization.py``).

Numpy and PIL only: ``unnormalize``, ``save_image_grid`` (with its grid
helpers) and ``draw_grid_text``, which needs matplotlib and imports it
when called.  Images are numpy NHWC float in [0, 1] (or [-1, 1], see
``unnormalize``).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def unnormalize(img: np.ndarray) -> np.ndarray:
    """[-1, 1] → [0, 1] clipped (the reference's ``src/model/utils.py:12-15``)."""
    return np.clip((np.asarray(img) + 1.0) * 0.5, 0.0, 1.0)


def put_image_to_grid(
    list_imgs: Sequence[np.ndarray], adding_margin: bool = True
) -> tuple[np.ndarray, int]:
    """Interleave k image stacks row-major so sample i shows its k
    variants side by side (``visualization_utils.py:43-57``): returns a
    (B * (k[+1]), H, W, 3) stack plus the column count."""
    num_col = len(list_imgs)
    b, h, w, _ = list_imgs[0].shape
    ncols = num_col + 1 if adding_margin else num_col
    grid = np.zeros((b * ncols, h, w, 3), dtype=np.float32)
    for i, imgs in enumerate(list_imgs):
        grid[i::ncols][:b] = imgs[..., :3]
    return grid, num_col + 1


def tile_images(images: np.ndarray, nrow: int) -> np.ndarray:
    """(N, H, W, C) → single (rows*H, nrow*W, C) montage (torchvision
    ``make_grid`` spirit)."""
    n, h, w, c = images.shape
    rows = -(-n // nrow)
    canvas = np.zeros((rows * h, nrow * w, c), dtype=images.dtype)
    for i in range(n):
        r, col = divmod(i, nrow)
        canvas[r * h : (r + 1) * h, col * w : (col + 1) * w] = images[i]
    return canvas


def save_image_grid(
    list_imgs: Sequence[np.ndarray], path: str, nrow: Optional[int] = None
) -> str:
    """Save an interleaved comparison grid as PNG."""
    from PIL import Image

    grid, ncol = put_image_to_grid(list_imgs)
    nrow = nrow if nrow is not None else ncol * 4
    canvas = tile_images(grid, nrow)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    Image.fromarray((np.clip(canvas, 0, 1) * 255).astype(np.uint8)).save(path)
    return path


def draw_grid_text(
    images: np.ndarray,
    texts: np.ndarray,
    save_path: str,
    dpi: int = 50,
) -> str:
    """Text-labelled retrieval panel (``visualization_utils.py:60-78``).

    ``images`` is (B, N, H, W, 3) in [0, 1]: per row a query, a
    reference, then retrieved templates; ``texts`` holds the retrieval
    scores for the template columns. Reproduces the reference layout —
    column 0 titled "Query", column 1 "Reference", columns >= 3 titled
    ``Top {n-2}: {texts[b, n-3]:.03f}`` — including its quirk of leaving
    cell 2 blank (the reference's ``if n != 2`` skips that subplot, so
    the first retrieved template never renders; scores still index from
    ``texts[b, 0]`` at column 3). Matplotlib-gated like the reference.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    images = np.asarray(images)
    texts = np.asarray(texts)
    B, N = images.shape[:2]
    plt.figure(figsize=(5 * N, 5 * B))
    for b in range(B):
        for n in range(N):
            if n == 2:
                continue
            plt.subplot(B, N, b * N + n + 1)
            plt.imshow(np.clip(images[b, n], 0.0, 1.0))
            plt.axis("off")
            if n == 0:
                plt.title("Query", fontsize=20)
            elif n == 1:
                plt.title("Reference", fontsize=20)
            else:
                plt.title(f"Top {n - 2}: {float(texts[b, n - 3]):.03f}", fontsize=30)
    plt.subplots_adjust(wspace=0.1, hspace=0.15)
    os.makedirs(os.path.dirname(os.path.abspath(save_path)), exist_ok=True)
    plt.savefig(save_path, bbox_inches="tight", dpi=dpi)
    plt.close("all")
    return save_path
