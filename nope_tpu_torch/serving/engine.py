"""Object-centric serving (``nope_tpu/serving/engine.py``).

One reference image registers an object: one VAE encode and N U-Net
forwards, once.  The bank stays on the device in the serving dtype,
dense (1, N, h, w, C).  Each request costs one VAE encode of the query
batch and one scoring pass (K1) against the bank::

    est = PoseEstimator(task, level=2, pose_distribution="upper")
    est.register_object("mug0", reference_image)        # once per object
    result = est.estimate("mug0", query_images)          # many times
    result.relative_rotations  # (B, k, 3, 3) ΔR reference→query
    result.similarity          # (B, N) viewpoint-bin pose distribution

The task's modules fix the device.  With ``half_precision_eval`` the
estimator serves a bfloat16 copy of them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from nope_tpu_torch.geometry import so3_grid
from nope_tpu_torch.geometry.rotations import matrix_to_rotation_6d
from nope_tpu_torch.geometry.transforms import relative_rotation


@dataclasses.dataclass
class PoseEstimate:
    nearest_idx: np.ndarray  # (B, k) indices into the template grid
    #: (B, k, 3, 3) relative rotations ΔR = T_i · R_refᵀ: the rotation
    #: taking the reference view to the query view
    relative_rotations: np.ndarray
    #: (B, k, 3, 3) the retrieved grid poses themselves
    rotations: np.ndarray
    similarity: np.ndarray  # (B, N) float32 pose distribution over viewpoint bins
    template_poses: np.ndarray  # (N, 3, 3) the grid (shared)


class PoseEstimator:
    """Pose estimation service around a :class:`PoseConditionalTask`.

    ``reference_pose`` at registration defaults to the canonical grid
    pose 0: the reference image is the canonical view and retrieved
    rotations are relative to it."""

    def __init__(
        self,
        task,
        level: int = 2,
        pose_distribution: str = "upper",
        fast_evaluation: bool = False,
        chunk_size: Optional[int] = None,
        bank_dtype: str = "auto",
    ):
        if bank_dtype != "auto":
            raise NotImplementedError(
                f"bank_dtype {bank_dtype!r}: int8 banks are ROADMAP queue 1 item 11")
        self._half = bool(task.config.half_precision_eval)
        self.task = task.half() if self._half else task
        self.device = self.task.device
        self.dtype = torch.bfloat16 if self._half else torch.float32
        self.chunk_size = chunk_size
        if fast_evaluation:
            indexes = so3_grid.load_index_level0_in_level2(pose_distribution)
            grid = so3_grid.get_obj_poses_from_template_level(2, "all")[indexes]
        else:
            grid = so3_grid.get_obj_poses_from_template_level(level, pose_distribution)
        self.template_poses = grid[:, :3, :3].astype(np.float32)
        self._templates = torch.as_tensor(self.template_poses, device=self.device)
        #: oid → (1, N, h, w, C) bank on the device, serving dtype
        self._banks: Dict[str, torch.Tensor] = {}
        self._ref_poses: Dict[str, np.ndarray] = {}

    @property
    def num_templates(self) -> int:
        return len(self.template_poses)

    def _device_images(self, images) -> torch.Tensor:
        """uint8 is normalised to [-1, 1] on the device (in float32, then
        cast); float input is taken as already in [-1, 1]."""
        arr = np.asarray(images)
        if arr.dtype == np.uint8:
            t = torch.from_numpy(arr).to(self.device)
            return (t.float() / 127.5 - 1.0).to(self.dtype)
        if np.issubdtype(arr.dtype, np.integer):
            raise TypeError(
                f"integer image dtype {arr.dtype} unsupported: pass uint8 "
                "(normalised on the device) or float images already in [-1, 1]")
        return torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(self.device, self.dtype)

    def _pose_representation(self, rel: torch.Tensor) -> torch.Tensor:
        dim = self.task.unet.rot_representation_dim
        if dim != 6:
            raise NotImplementedError(
                f"rotation representation dim {dim}: only rotation-6d is ported (ROADMAP queue 1 item 2)")
        return matrix_to_rotation_6d(rel)

    def register_object(self, object_id: str, reference_image: np.ndarray,
                        reference_pose: Optional[np.ndarray] = None) -> None:
        """Build and keep the template bank of one object from a single
        (H, W, 3) reference image."""
        self.register_objects(
            [object_id], np.asarray(reference_image)[None],
            None if reference_pose is None else np.asarray(reference_pose)[None],
        )

    @torch.no_grad()
    def register_objects(self, object_ids: Sequence[str], reference_images: np.ndarray,
                         reference_poses: Optional[np.ndarray] = None) -> None:
        """Batch registration: one bank sweep over an (M, H, W, 3) gallery."""
        m = len(object_ids)
        reference_images = np.asarray(reference_images)
        if len(reference_images) != m:
            raise ValueError(f"{m} object ids but {len(reference_images)} reference images")
        if reference_poses is None:
            reference_poses = np.broadcast_to(self.template_poses[0], (m, 3, 3))
        reference_poses = np.array(reference_poses, np.float32)  # a writable copy
        if len(reference_poses) != m:
            raise ValueError(f"{m} object ids but {len(reference_poses)} reference poses")
        ref_R = torch.as_tensor(reference_poses, device=self.device)
        rel = relative_rotation(self._templates[None], ref_R[:, None])  # (M, N, 3, 3)
        bank_R = self._pose_representation(rel).to(self.dtype)
        ref_lat = self.task.encode(self._device_images(reference_images))
        banks = self.task.generate_template_bank(
            None, bank_R, chunk_size=self.chunk_size, reference_latent=ref_lat)
        for i, object_id in enumerate(object_ids):
            self._banks[object_id] = banks[i:i + 1]
            self._ref_poses[object_id] = reference_poses[i]

    def deregister_object(self, object_id: str) -> None:
        self._banks.pop(object_id, None)
        self._ref_poses.pop(object_id, None)

    @torch.no_grad()
    def estimate(self, object_id: str, query_images: np.ndarray,
                 refine_steps: int = 0) -> PoseEstimate:
        """Score (B, H, W, 3) query images (or one (H, W, 3)) against the
        object's bank."""
        if refine_steps:
            raise NotImplementedError("pose refinement is ROADMAP queue 1 item 10")
        if object_id not in self._banks:
            raise KeyError(f"object {object_id!r} is not registered")
        queries = self._device_images(query_images)
        if queries.dim() == 3:
            queries = queries[None]
        sim, idx = self.task.retrieval(queries, self._banks[object_id])
        ref_pose = np.broadcast_to(self._ref_poses[object_id], (queries.shape[0], 3, 3))
        return self._assemble(sim, idx, ref_pose)

    def estimate_many(self, *args, **kwargs):
        raise NotImplementedError("estimate_many is ROADMAP queue 1 item 11")

    def save_registry(self, path: str) -> None:
        raise NotImplementedError("the bank registry is ROADMAP queue 1 item 11")

    def load_registry(self, path: str) -> None:
        raise NotImplementedError("the bank registry is ROADMAP queue 1 item 11")

    def _assemble(self, sim: torch.Tensor, idx: torch.Tensor, ref_poses: np.ndarray) -> PoseEstimate:
        idx_np = idx.cpu().numpy()
        retrieved = self.template_poses[idx_np]  # (B, k, 3, 3)
        rel = retrieved @ np.swapaxes(ref_poses, -1, -2)[:, None]  # ΔR_i = T_i · R_refᵀ
        return PoseEstimate(
            nearest_idx=idx_np,
            relative_rotations=rel,
            rotations=retrieved,
            similarity=sim.float().cpu().numpy(),
            template_poses=self.template_poses,
        )
