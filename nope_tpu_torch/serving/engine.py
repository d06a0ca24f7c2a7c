"""Object-centric serving (``nope_tpu/serving/engine.py``).

One reference image registers an object: one VAE encode and N U-Net
forwards, once.  The bank stays on the device, dense (1, N, h, w, C):
in the serving dtype, or with ``bank_dtype="int8"`` as int8 values and
a float32 scale per (template, channel), dequantised to the serving
dtype before scoring.  Each request costs one VAE encode of the query
batch and one scoring pass (K1) against the bank::

    est = PoseEstimator(task, level=2, pose_distribution="upper")
    est.register_object("mug0", reference_image)        # once per object
    result = est.estimate("mug0", query_images)          # many times
    result.relative_rotations  # (B, k, 3, 3) ΔR reference→query
    result.similarity          # (B, N) viewpoint-bin pose distribution
    est.estimate_many(["mug0", "cup1", ...], query_images)  # mixed objects
    est.estimate("mug0", query_images, refine_steps=24)  # + continuous ΔR
    est.save_registry("gallery.npz")  # the JAX package's .npz format

With ``refine_steps`` > 0 the retrieved top-1 (or top-K) pose is refined
by gradient descent through the U-Net (``tasks.refinement``) into a
continuous ΔR.  The task's modules fix the device.  With
``half_precision_eval`` the estimator serves a bfloat16 copy of them.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from nope_tpu_torch.geometry import so3_grid
from nope_tpu_torch.geometry.rotations import (
    matrix_to_euler_angles,
    matrix_to_quaternion,
    matrix_to_rotation_6d,
    rotation_6d_to_matrix,
)
from nope_tpu_torch.geometry.transforms import relative_rotation
from nope_tpu_torch.tasks.refinement import make_multistart_refiner, make_pose_refiner

#: a stored bank: (M, N, h, w, C) in the serving dtype, or for int8
#: ((M, N, h, w, C) int8, (M, N, 1, 1, C) float32 scale)
Bank = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


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
    #: (B, 3, 3) the continuous ΔR from refinement; None unless it ran
    refined_relative_rotation: Optional[np.ndarray] = None
    #: (B, 3, 3) the refined absolute query rotation ΔR̂ · R_ref
    refined_rotation: Optional[np.ndarray] = None
    #: (B,) the refinement objective at the refined pose (lower is better)
    refined_distance: Optional[np.ndarray] = None


def quantize_bank(bank: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(M, N, h, w, C) → int8 values and a float32 scale per (template,
    channel), (M, N, 1, 1, C): absmax / 127, in float32, rounded half to
    even as ``jnp.round``."""
    b32 = bank.float()
    scale = torch.clamp(b32.abs().amax(dim=(2, 3), keepdim=True), min=1e-12) / 127.0
    return torch.clamp(torch.round(b32 / scale), -127, 127).to(torch.int8), scale


def dequantize_bank(q8: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int8 values × scale in float32, then cast to ``dtype``."""
    return (q8.float() * scale).to(dtype)


def _gather(bank: Bank, idx: torch.Tensor) -> Bank:
    """The banks of objects ``idx`` (B,) of a stacked bank: (B, N, ...)."""
    if isinstance(bank, tuple):
        return tuple(t.index_select(0, idx) for t in bank)
    return bank.index_select(0, idx)


def _slice(bank: Bank, i: int) -> Bank:
    """Object ``i`` of a stacked bank, (1, N, ...), a view."""
    if isinstance(bank, tuple):
        return tuple(t[i:i + 1] for t in bank)
    return bank[i:i + 1]


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
        if bank_dtype not in ("auto", "int8"):
            raise ValueError(f"bank_dtype must be 'auto' or 'int8', got {bank_dtype!r}")
        self.bank_dtype = bank_dtype
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
        #: oid → (1, N, h, w, C) bank on the device (see ``Bank``)
        self._banks: Dict[str, Bank] = {}
        self._ref_poses: Dict[str, np.ndarray] = {}
        #: oid → (1, h, w, C) reference latent (serving dtype) and (N,
        #: pose_dim) float32 conditioning reps, on the device, kept for the
        #: registry and for refinement; None for objects loaded from a
        #: registry that has none
        self._ref_latents: Dict[str, Optional[torch.Tensor]] = {}
        self._bank_reps: Dict[str, Optional[torch.Tensor]] = {}
        #: latent geometry (h, w, C) of every bank; pinned by the first
        #: registration or registry load, checked by later ones (kept after
        #: deregistration, as the JAX package keeps it)
        self._latent_hwc: Optional[tuple] = None
        #: (unique-id tuple, banks stacked over them) of the last
        #: estimate_many; dropped on register, deregister and load
        self._stacked_cache: tuple = (None, None)

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

    def _queries(self, query_images) -> torch.Tensor:
        queries = self._device_images(query_images)
        return queries[None] if queries.dim() == 3 else queries

    def _pose_representation(self, rel: torch.Tensor) -> torch.Tensor:
        """ΔR in the U-Net's representation: rotation-6d (dim 6),
        quaternion (4) or Euler XYZ (3)."""
        dim = self.task.unet.rot_representation_dim
        if dim == 6:
            return matrix_to_rotation_6d(rel)
        if dim == 4:
            return matrix_to_quaternion(rel)
        if dim == 3:
            return matrix_to_euler_angles(rel, "XYZ")
        raise ValueError(f"unsupported rotation representation dim {dim}")

    def _store(self, bank: torch.Tensor) -> Bank:
        return quantize_bank(bank) if self.bank_dtype == "int8" else bank

    def _dense(self, bank: Bank) -> torch.Tensor:
        """A stored bank in the serving dtype, as K1 reads it."""
        return dequantize_bank(*bank, self.dtype) if isinstance(bank, tuple) else bank

    def _pin_latent_hwc(self, image_hw) -> None:
        """Pin the latent geometry (h, w, C) of (H, W) reference images, or
        check it against the pinned one: banks of two geometries cannot be
        stacked (``estimate_many``).  From the VAE config (downscale
        2**(n_blocks - 1)), so no device work."""
        vae = self.task.vae
        f = 2 ** (len(vae.block_out_channels) - 1)
        hwc = (int(image_hw[0]) // f, int(image_hw[1]) // f, int(vae.latent_channels))
        if self._latent_hwc is None:
            self._latent_hwc = hwc
        elif self._latent_hwc != hwc:
            raise ValueError("mixed latent geometries in one estimator: "
                             f"{self._latent_hwc} vs {hwc}")

    def _forget_stacks(self) -> None:
        self._stacked_cache = (None, None)

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
        rel_rep = self._pose_representation(rel)  # (M, N, dim) float32
        refs = self._device_images(reference_images)
        self._pin_latent_hwc(reference_images.shape[1:3])
        ref_lat = self.task.encode(refs)
        banks = self.task.generate_template_bank(
            None, rel_rep.to(self.dtype), chunk_size=self.chunk_size, reference_latent=ref_lat)
        stored = self._store(banks)
        for i, object_id in enumerate(object_ids):
            self._banks[object_id] = _slice(stored, i)
            self._ref_poses[object_id] = reference_poses[i]
            self._ref_latents[object_id] = ref_lat[i:i + 1]
            self._bank_reps[object_id] = rel_rep[i]
        self._forget_stacks()

    def deregister_object(self, object_id: str) -> None:
        for table in (self._banks, self._ref_poses, self._ref_latents, self._bank_reps):
            table.pop(object_id, None)
        self._forget_stacks()

    # -- persistence --------------------------------------------------------

    def save_registry(self, path: str) -> None:
        """Every registered object's bank, reference pose, reference latent
        and conditioning reps as one ``.npz``, in the JAX package's format
        (dense float32 banks, or int8 values with their scales), so either
        package loads what the other wrote."""
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        payload = {"__template_poses__": self.template_poses,
                   "__bank_dtype__": np.asarray(self.bank_dtype)}
        for oid, bank in self._banks.items():
            if isinstance(bank, tuple):
                payload[f"bank_q8:{oid}"] = bank[0].cpu().numpy()
                payload[f"scale:{oid}"] = bank[1].cpu().numpy()
            else:  # float32 whatever the serving dtype: bf16 has no portable npz form
                payload[f"bank:{oid}"] = bank.float().cpu().numpy()
            payload[f"pose:{oid}"] = self._ref_poses[oid]
            if self._ref_latents.get(oid) is not None:
                payload[f"reflat:{oid}"] = self._ref_latents[oid].float().cpu().numpy()
                payload[f"bankrep:{oid}"] = self._bank_reps[oid].cpu().numpy()
        np.savez_compressed(path, **payload)

    def load_registry(self, path: str) -> None:
        """Restore the banks of a registry written by :meth:`save_registry`
        of either package (additive: other registrations stay)."""
        self._forget_stacks()
        with np.load(path) as data:
            saved_grid = data["__template_poses__"]
            if saved_grid.shape != self.template_poses.shape or not np.allclose(
                    saved_grid, self.template_poses):
                raise ValueError(
                    "saved registry was built on a different template grid "
                    f"({saved_grid.shape} vs {self.template_poses.shape}); "
                    "construct the estimator with the same level/distribution")
            saved_dtype = str(data["__bank_dtype__"]) if "__bank_dtype__" in data.files else "auto"
            if saved_dtype != self.bank_dtype:
                raise ValueError(f"saved registry layout (bank_dtype={saved_dtype!r}) does "
                                 f"not match this estimator ({self.bank_dtype!r})")
            for key in data.files:
                kind, _, oid = key.partition(":")
                if kind not in ("bank", "bank_q8"):
                    continue
                dense = data[key]  # (1, N, h, w, C)
                h, w, c = (int(d) for d in dense.shape[-3:])
                if self._latent_hwc is None:
                    self._latent_hwc = (h, w, c)
                elif self._latent_hwc != (h, w, c):
                    raise ValueError("registry latent geometry does not match this "
                                     f"estimator: {(h, w, c)} vs {self._latent_hwc}")
                if kind == "bank":
                    bank = torch.from_numpy(dense).to(self.device, self.dtype)
                else:
                    bank = (torch.from_numpy(dense).to(self.device),
                            torch.from_numpy(data[f"scale:{oid}"].astype(np.float32)).to(self.device))
                n = self.num_templates
                self._banks[oid] = bank
                self._ref_poses[oid] = np.asarray(data[f"pose:{oid}"], np.float32)
                if f"reflat:{oid}" in data.files:
                    self._ref_latents[oid] = torch.from_numpy(
                        data[f"reflat:{oid}"].reshape(1, h, w, c)).to(self.device, self.dtype)
                    self._bank_reps[oid] = torch.from_numpy(
                        data[f"bankrep:{oid}"].astype(np.float32).reshape(n, -1)).to(self.device)
                else:  # registries from before refinement carry no latents
                    self._ref_latents[oid] = self._bank_reps[oid] = None

    # -- requests -----------------------------------------------------------

    def _check_topk(self, topk: int) -> None:
        k = int(self.task.config.retrieval_k)
        if not 1 <= int(topk) <= k:
            raise ValueError(
                f"refine_topk={topk} outside [1, {k}] (retrieval returns "
                f"the top-{k} templates; raise task config retrieval_k "
                "for wider multi-start)")

    def _refine(self, q_lat: torch.Tensor, ref_lat: torch.Tensor, reps: torch.Tensor, idx: torch.Tensor,
                steps: int, lr: float, objective: str, topk: int) -> Tuple[np.ndarray, np.ndarray]:
        """Refine from the retrieved top-``topk`` of each query: ref_lat
        (B, h, w, C) and reps (B, N, dim) float32 per query.  Returns the
        refined ΔR (B, 3, 3) and its objective (B,), float32 on the host."""
        init_R = rotation_6d_to_matrix(torch.gather(reps, 1, idx[:, :topk, None].expand(-1, -1, reps.shape[2])))
        if topk > 1:
            rel, dist, _ = make_multistart_refiner(self.task, steps, lr, objective)(q_lat, ref_lat, init_R)
        else:
            rel, dist = make_pose_refiner(self.task, steps, lr, objective)(q_lat, ref_lat, init_R[:, 0])
        return rel.cpu().numpy(), dist.cpu().numpy()

    @torch.no_grad()
    def estimate(self, object_id: str, query_images: np.ndarray, refine_steps: int = 0,
                 refine_lr: float = 2e-2, refine_objective: str = "l2", refine_topk: int = 1) -> PoseEstimate:
        """Score (B, H, W, 3) query images (or one (H, W, 3)) against the
        object's bank.

        ``refine_steps`` > 0 also refines each query's retrieved top-1
        ΔR by gradient descent (:mod:`nope_tpu_torch.tasks.refinement`)
        or, with ``refine_topk`` > 1, from each of its top-K and keeps
        the start with the lowest final objective; the estimate then
        carries ``refined_relative_rotation`` and ``refined_rotation``."""
        if object_id not in self._banks:
            raise KeyError(f"object {object_id!r} is not registered")
        if refine_steps:
            if self._ref_latents.get(object_id) is None:
                raise ValueError(
                    f"object {object_id!r} was loaded from a registry without "
                    "reference latents; re-register it to enable refinement")
            self._check_topk(refine_topk)
        q_lat = self.task.encode(self._queries(query_images))
        sim, idx = self.task.retrieval(None, self._dense(self._banks[object_id]), query_latent=q_lat)
        b = q_lat.shape[0]
        ref_pose = np.broadcast_to(self._ref_poses[object_id], (b, 3, 3))
        if not refine_steps:
            return self._assemble(sim, idx, ref_pose)
        rel, dist = self._refine(q_lat, self._ref_latents[object_id].expand(b, -1, -1, -1),
                                 self._bank_reps[object_id].expand(b, -1, -1), idx,
                                 refine_steps, refine_lr, refine_objective, refine_topk)
        return self._assemble(sim, idx, ref_pose, rel, dist)

    @torch.no_grad()
    def estimate_many(self, object_ids: Sequence[str], query_images: np.ndarray, refine_steps: int = 0,
                      refine_lr: float = 2e-2, refine_objective: str = "l2",
                      refine_topk: int = 1) -> PoseEstimate:
        """Mixed-object batch: query i is scored against the bank of
        ``object_ids[i]``.  The banks of the unique objects are stacked
        once (and kept while the gallery does not change); each request
        gathers a bank per query from that stack on the device, and K1
        scores all queries in one launch.  ``refine_steps`` > 0 refines
        as :meth:`estimate` does, each query against its own object's
        reference latent."""
        queries = self._queries(query_images)
        if len(object_ids) != queries.shape[0]:
            raise ValueError(f"{len(object_ids)} object ids for {queries.shape[0]} queries")
        missing = [oid for oid in object_ids if oid not in self._banks]
        if missing:
            raise KeyError(f"objects not registered: {missing!r}")
        uniq = list(dict.fromkeys(object_ids))  # order-preserving
        pos = {oid: i for i, oid in enumerate(uniq)}
        inv = torch.tensor([pos[oid] for oid in object_ids], device=self.device)
        key = tuple(uniq)
        if self._stacked_cache[0] == key:
            stacked = self._stacked_cache[1]
        else:
            parts = [self._banks[oid] for oid in uniq]
            stacked = (tuple(torch.cat(p) for p in zip(*parts)) if self.bank_dtype == "int8"
                       else torch.cat(parts))
            self._stacked_cache = (key, stacked)
        if refine_steps:
            bare = [oid for oid in uniq if self._ref_latents.get(oid) is None]
            if bare:
                raise ValueError(
                    f"objects {bare!r} were loaded from a registry without "
                    "reference latents; re-register them to enable refinement")
            self._check_topk(refine_topk)
        q_lat = self.task.encode(queries)
        sim, idx = self.task.retrieval(None, self._dense(_gather(stacked, inv)), query_latent=q_lat)
        ref_poses = np.stack([self._ref_poses[oid] for oid in object_ids])
        if not refine_steps:
            return self._assemble(sim, idx, ref_poses)
        ref_lats = torch.cat([self._ref_latents[oid] for oid in uniq]).index_select(0, inv)
        reps = torch.stack([self._bank_reps[oid] for oid in uniq]).index_select(0, inv)
        rel, dist = self._refine(q_lat, ref_lats, reps, idx, refine_steps, refine_lr, refine_objective,
                                 refine_topk)
        return self._assemble(sim, idx, ref_poses, rel, dist)

    def _assemble(self, sim: torch.Tensor, idx: torch.Tensor, ref_poses: np.ndarray,
                  refined_rel: Optional[np.ndarray] = None,
                  refined_distance: Optional[np.ndarray] = None) -> PoseEstimate:
        idx_np = idx.cpu().numpy()
        retrieved = self.template_poses[idx_np]  # (B, k, 3, 3)
        rel = retrieved @ np.swapaxes(ref_poses, -1, -2)[:, None]  # ΔR_i = T_i · R_ref,iᵀ
        return PoseEstimate(
            nearest_idx=idx_np,
            relative_rotations=rel,
            rotations=retrieved,
            similarity=sim.float().cpu().numpy(),
            template_poses=self.template_poses,
            refined_relative_rotation=refined_rel,
            refined_rotation=None if refined_rel is None else refined_rel @ ref_poses,
            refined_distance=refined_distance,
        )
