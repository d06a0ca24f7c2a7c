"""Visualization helpers (``nope_tpu/utils/visualization.py``).

The reference's ``visualization_utils.py``: interleaved image grids
(reference | query | prediction columns), the labelled retrieval panel
of ``evaluation.geodesic``, similarity heatmaps, uncertainty maps,
captions on a saved montage, pose-axis overlays and template-sweep
videos.  numpy only at import: Pillow, matplotlib, cv2 and imageio are
imported by the functions that need them.  Images are numpy NHWC float
in [0, 1] (or [-1, 1], see ``unnormalize``).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

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


def similarity_heatmap(similarity: np.ndarray) -> np.ndarray:
    """(N,) viewpoint similarities → (N, 3) magma-style colors without
    matplotlib: a compact 5-stop colormap interpolation."""
    sim = np.asarray(similarity, dtype=np.float64)
    lo, hi = sim.min(), sim.max()
    t = (sim - lo) / (hi - lo + 1e-12)
    stops = np.array(
        [
            [0.001, 0.000, 0.014],
            [0.283, 0.121, 0.443],
            [0.717, 0.215, 0.475],
            [0.987, 0.535, 0.382],
            [0.987, 0.991, 0.750],
        ]
    )
    idx = t * (len(stops) - 1)
    i0 = np.clip(idx.astype(int), 0, len(stops) - 2)
    frac = (idx - i0)[..., None]
    return stops[i0] * (1 - frac) + stops[i0 + 1] * frac


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


def visualize_uncertainty(
    uncertainty: np.ndarray, img_size: Sequence[int], apply_cmap: bool = True
) -> np.ndarray:
    """Per-pixel uncertainty maps (``visualization_utils.py:118-127``):
    bilinear-upsample a (B, h, w, C) map to ``img_size``, take the
    channel L2 norm, and either magma-colormap it or replicate to RGB.
    Channel-last instead of the reference's NCHW; cv2-based resize."""
    import cv2

    u = np.asarray(uncertainty, dtype=np.float32)
    H, W = int(img_size[0]), int(img_size[1])
    out = np.empty((u.shape[0], H, W, u.shape[-1]), np.float32)
    for i in range(u.shape[0]):
        resized = cv2.resize(u[i], (W, H), interpolation=cv2.INTER_LINEAR)
        out[i] = resized if resized.ndim == 3 else resized[..., None]
    norm = np.linalg.norm(out, axis=-1)  # (B, H, W)
    if apply_cmap:
        lo, hi = norm.min(), norm.max()
        return similarity_heatmap(
            ((norm - lo) / (hi - lo + 1e-12)).reshape(-1)
        ).reshape(norm.shape + (3,)).astype(np.float32)
    return np.repeat(norm[..., None], 3, axis=-1)


def write_text_on_grid(
    img_path: str,
    errors: Sequence[float],
    sample_size: int = 128,
    color: tuple = (255, 0, 0),
    font_scale: float = 0.5,
    thickness: int = 1,
    idx_cols: Sequence[int] = (1,),
    text_prefix: str = "err",
    additional_info: Optional[Sequence[float]] = None,
) -> np.ndarray:
    """Stamp per-sample error captions onto a saved montage
    (``visualization_utils.py:130-170``): the grid is ``sample_size``
    cells; one ``{prefix}={err:.01f}`` caption per row at each column
    in ``idx_cols``, sample index advancing per caption like the
    reference. Returns the annotated RGB array (uint8)."""
    import cv2
    from PIL import Image

    img = np.array(Image.open(img_path).convert("RGB")).copy()
    nrow = img.shape[0] // sample_size
    font = cv2.FONT_HERSHEY_SIMPLEX
    idx_sample = 0
    for idx_row in range(nrow):
        for idx_col in idx_cols:
            pos = (
                int((idx_col + 0.35) * sample_size),
                int((idx_row + 0.95) * sample_size),
            )
            caption = f"{text_prefix}={float(errors[idx_sample]):.01f}"
            if additional_info is not None:
                caption += f", err={float(additional_info[idx_sample]):.01f}"
            img = cv2.putText(
                img, caption, pos, font, font_scale, color, thickness, cv2.LINE_AA
            )
            idx_sample += 1
    return img


def draw_pose_axes(
    img: np.ndarray, K: np.ndarray, pose: np.ndarray, length: float = 0.1
) -> np.ndarray:
    """Overlay XYZ axes of an object pose (RGB = XYZ), cv2-based."""
    import cv2

    img = (np.clip(np.asarray(img), 0, 1) * 255).astype(np.uint8).copy()
    R, t = pose[:3, :3], pose[:3, 3]
    pts = np.float32([[0, 0, 0], [length, 0, 0], [0, length, 0], [0, 0, length]])
    cam = pts @ R.T + t
    uv = (cam @ np.asarray(K).T)
    uv = (uv[:, :2] / uv[:, 2:3]).astype(int)
    for end, color in zip(uv[1:], [(255, 0, 0), (0, 255, 0), (0, 0, 255)]):
        cv2.line(img, tuple(uv[0]), tuple(end), color, 2)
    return img.astype(np.float32) / 255.0


def write_video(frames: List[np.ndarray], path: str, fps: int = 5) -> str:
    """Template-sweep video (``model.py:243-249``); imageio-gated."""
    import imageio

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    frames8 = [
        (np.clip(f, 0, 1) * 255).astype(np.uint8) if f.dtype != np.uint8 else f
        for f in frames
    ]
    imageio.mimwrite(path, frames8, fps=fps)
    return path
