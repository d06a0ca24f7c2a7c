"""VSD evaluation on the host (``nope_tpu/evaluation/vsd.py``).

The device side (template bank and retrieval, ``cli.test_bop``) gives
each query's top-k template indices; :func:`build_vsd_frames` turns a
batch and those indices into per-frame records, and
:func:`evaluate_vsd_batch` scores them, in this process or over a
``spawn`` process pool: each frame renders the GT and the retrieved
poses' depths and scores them with the numpy metric of
:mod:`nope_tpu_torch.evaluation.vsd_metrics`.

Rendering is host work by design, on one of two host renderers
(:func:`make_renderer`): pyrender's offscreen GL (the reference's) or
the numpy z-buffer rasteriser of :mod:`nope_tpu_torch.evaluation.raster`.
``"auto"`` takes pyrender where it imports and an offscreen context
opens, else the rasteriser, and logs which.  The test depth map is read
with cv2 where it imports, else with the port's PNG codec
(:func:`nope_tpu_torch.data.png.read_png`, 16-bit greyscale): the same
uint16 array.
"""

from __future__ import annotations

import dataclasses
import logging
import multiprocessing
import os
from typing import Dict, List, Sequence

import numpy as np

from nope_tpu_torch.evaluation.vsd_metrics import vsd_error_from_depths, vsd_scores


@dataclasses.dataclass
class VSDFrame:
    """One test frame: everything a worker needs, nothing batched."""

    cad_path: str
    intrinsic: np.ndarray  # (3, 3)
    depth_path: str
    pred_poses: np.ndarray  # (k, 4, 4) retrieved R + GT t
    gt_pose: np.ndarray  # (4, 4)
    depth_scale: float = 0.1  # BOP depth units (0.1 mm) → mm


def build_vsd_frames(
    batch: Dict[str, np.ndarray],
    nearest_idx: np.ndarray,
    template_poses: np.ndarray,
    cad_paths: Dict[int, str],
) -> List[VSDFrame]:
    """Per-frame records from a batch (host arrays) and its retrieval's
    (B, k) template indices into ``template_poses`` (N, 3, 3): each
    retrieved rotation with the query's GT translation."""
    frames: List[VSDFrame] = []
    b, k = nearest_idx.shape
    for i in range(b):
        retrieved_R = template_poses[nearest_idx[i]]  # (k, 3, 3)
        t = np.asarray(batch["query_translation"][i]).reshape(3)
        pred = np.tile(np.eye(4, dtype=np.float64), (k, 1, 1))
        pred[:, :3, :3] = retrieved_R
        pred[:, :3, 3] = t
        gt = np.eye(4, dtype=np.float64)
        gt[:3, :3] = np.asarray(batch["query_pose"][i])
        gt[:3, 3] = t
        frames.append(
            VSDFrame(
                cad_path=cad_paths[int(batch["obj_id"][i])],
                intrinsic=np.asarray(batch["intrinsic"][i]).reshape(3, 3),
                depth_path=str(batch["depth_path"][i]),
                pred_poses=pred,
                gt_pose=gt,
            )
        )
    return frames


def read_depth(path: str) -> np.ndarray:
    """A depth PNG as stored (uint16 for BOP): cv2 where it imports,
    else the port's PNG codec."""
    try:
        import cv2
    except ImportError:
        from nope_tpu_torch.data.png import read_png

        return read_png(path)
    depth = cv2.imread(path, -1)
    if depth is None:
        raise FileNotFoundError(f"cannot read depth image {path}")
    return depth


def _render_depths(mesh, poses: np.ndarray, K: np.ndarray, img_size) -> List[np.ndarray]:
    """Offscreen depth-only renders, the camera fixed at the origin
    (OpenCV → GL flip), the object moved by each pose."""
    os.environ.setdefault("PYOPENGL_PLATFORM", "egl")
    import pyrender

    cam_pose = np.eye(4)
    cam_pose[1, 1] = -1
    cam_pose[2, 2] = -1
    scene = pyrender.Scene(bg_color=np.zeros(4))
    camera = pyrender.IntrinsicsCamera(fx=K[0][0], fy=K[1][1], cx=K[0][2], cy=K[1][2], znear=0.05, zfar=100000)
    scene.add(camera, pose=cam_pose)
    engine = pyrender.OffscreenRenderer(img_size[1], img_size[0])
    node = scene.add(mesh, pose=np.eye(4), name="cad")
    depths = []
    for pose in np.atleast_3d(poses).reshape(-1, 4, 4):
        scene.set_pose(node, pose)
        depths.append(engine.render(scene, flags=pyrender.RenderFlags.DEPTH_ONLY))
    engine.delete()
    return depths


class PyrenderDepthRenderer:
    """pyrender's offscreen GL with the ``(poses, K, img_shape) ->
    [depth, ...]`` contract of :class:`~nope_tpu_torch.evaluation.raster.
    NumpyDepthRenderer`."""

    backend = "pyrender"

    def __init__(self, mesh):
        self.mesh = mesh

    def __call__(self, poses: np.ndarray, K: np.ndarray, img_shape) -> List[np.ndarray]:
        return _render_depths(self.mesh, poses, K, img_shape)


def make_renderer(cad_path: str, backend: str = "auto"):
    """A renderer of ``cad_path`` with the ``(poses, K, img_shape) ->
    [depth, ...]`` contract; its ``backend`` attribute says which.
    ``"pyrender"`` = GL offscreen (trimesh loads the mesh; an
    ``ImportError`` when either is missing), ``"numpy"`` = the z-buffer
    rasteriser, ``"auto"`` = pyrender where it imports and an offscreen
    context opens, else the rasteriser."""
    if backend not in ("auto", "pyrender", "numpy"):
        raise ValueError(f"unknown renderer backend {backend!r}")
    if backend in ("auto", "pyrender"):
        try:
            import pyrender

            from nope_tpu_torch.utils.mesh import load_mesh

            mesh = pyrender.Mesh.from_trimesh(load_mesh(cad_path))
            # GL / EGL failures show only when an OffscreenRenderer is
            # made, not at import: probe one, so that "auto" on a host
            # without GL takes the rasteriser instead of failing per frame
            probe = pyrender.OffscreenRenderer(4, 4)
            probe.delete()
            logging.info("VSD renderer: pyrender")
            return PyrenderDepthRenderer(mesh)
        except ImportError:
            if backend == "pyrender":
                raise
            logging.info("VSD renderer: numpy (pyrender or trimesh does not import)")
        except Exception as e:
            if backend == "pyrender":
                raise
            logging.info("VSD renderer: numpy (pyrender's GL context failed: %s)", e)
    from nope_tpu_torch.evaluation.raster import NumpyDepthRenderer

    return NumpyDepthRenderer.from_file(cad_path)


def vsd_frame_error(
    frame: VSDFrame,
    delta: float = 15.0,
    tau: float = 20.0,
    cost_type: str = "step",
    renderer=None,
    renderer_backend: str = "auto",
) -> np.ndarray:
    """(k,) VSD errors of one frame's retrieved poses.  ``renderer`` may
    be any ``(poses, K, img_shape) -> [depth, ...]`` callable."""
    depth_test = read_depth(frame.depth_path) * frame.depth_scale
    if renderer is None:
        renderer = make_renderer(frame.cad_path, renderer_backend)
    K = np.asarray(frame.intrinsic, dtype=np.float64)

    k = frame.pred_poses.shape[0]
    gt_poses = np.tile(frame.gt_pose[None], (k, 1, 1))
    # the predictions take the GT translation (the reference's vsd.py:86-87)
    pred_poses = frame.pred_poses.copy()
    pred_poses[:, :3, 3] = gt_poses[:, :3, 3]

    gt_depths = renderer(gt_poses, K, depth_test.shape)
    pred_depths = renderer(pred_poses, K, depth_test.shape)
    return np.array(
        [
            vsd_error_from_depths(depth_test, gt_depths[i], pred_depths[i], K, delta, tau, cost_type)
            for i in range(k)
        ]
    )


def evaluate_vsd_batch(
    frames: Sequence[VSDFrame],
    num_workers: int = 0,
    delta: float = 15.0,
    tau: float = 20.0,
    renderer_backend: str = "auto",
) -> np.ndarray:
    """(num_frames, k) errors, over a ``spawn`` pool of ``num_workers``
    processes when it is more than 1."""
    if num_workers and num_workers > 1:
        with multiprocessing.get_context("spawn").Pool(num_workers) as pool:
            results = pool.starmap(
                vsd_frame_error,
                [(f, delta, tau, "step", None, renderer_backend) for f in frames],
            )
    else:
        results = [vsd_frame_error(f, delta, tau, renderer_backend=renderer_backend) for f in frames]
    return np.stack(results, axis=0)


def summarize(vsd_errors: np.ndarray) -> dict:
    return vsd_scores(vsd_errors)
