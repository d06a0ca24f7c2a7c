"""BOP-format dataset base reader (``nope_tpu/data/base_bop.py``), without
pandas.

Walks a BOP-layout dataset (per-scene ``scene_gt``, ``scene_gt_info``
and ``scene_camera`` JSONs beside ``rgb/``, ``mask/``, ``mask_visib/``
and ``depth/``) into a table of one row per object instance, cached as
``{split}_metaData.json``.  The JAX package holds that table in a pandas
frame; here it is a :class:`MetaTable` of the same columns, rows and
order:

- a fresh scan gives the rows scene by scene, frame by frame, instance
  by instance, and writes the cache as ``{column: [value, ...]}``
  (the file the JAX reader writes, read by either package);
- the rows are then shuffled by ``np.random.RandomState(2021).
  permutation(n)``, which is what pandas' ``sample(frac=1,
  random_state=2021)`` draws.

CAD meshes are optional (trimesh loads them where it is installed, for
VSD's pyrender route); object diameters for the crop come from
``models_info.json``.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import os.path as osp
import time
from typing import Any, Dict, List, Sequence

import numpy as np

from nope_tpu_torch.geometry.transforms import combine_R_and_T

_METADATA_SHUFFLE_SEED = 2021  # baseBOP.py:253


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def save_json(path: str, obj) -> None:
    def _cast(o):
        if isinstance(o, np.ndarray):
            return o.tolist()
        if isinstance(o, (np.floating, np.integer)):
            return o.item()
        raise TypeError(type(o))

    with open(path, "w") as f:
        json.dump(obj, f, indent=4, default=_cast)


class MetaTable:
    """Rows of named columns in a fixed order: the part of a pandas frame
    the BOP readers use.  ``column(name)`` is a numpy array of a column
    (made once), ``row(i)`` a dict, ``take(indices)`` a new table of those
    rows in that order."""

    def __init__(self, columns: Dict[str, List[Any]]):
        lengths = {len(v) for v in columns.values()}
        if len(lengths) > 1:
            raise ValueError(f"columns of different lengths: {sorted(lengths)}")
        self._columns = {k: list(v) for k, v in columns.items()}
        self._arrays: Dict[str, np.ndarray] = {}

    @classmethod
    def from_rows(cls, rows: Sequence[Dict[str, Any]]) -> "MetaTable":
        """Columns in the order of first appearance over the rows, as
        ``pd.DataFrame(rows)``."""
        names: Dict[str, None] = {}
        for r in rows:
            names.update(dict.fromkeys(r))
        return cls({k: [r.get(k) for r in rows] for k in names})

    def __len__(self) -> int:
        return len(next(iter(self._columns.values()), ()))

    def column(self, name: str) -> np.ndarray:
        if name not in self._arrays:
            self._arrays[name] = np.asarray(self._columns[name])
        return self._arrays[name]

    def values(self, name: str) -> List[Any]:
        return list(self._columns[name])

    def row(self, i: int) -> Dict[str, Any]:
        return {k: v[i] for k, v in self._columns.items()}

    def rows(self) -> List[Dict[str, Any]]:
        return [self.row(i) for i in range(len(self))]

    def take(self, indices) -> "MetaTable":
        idx = [int(i) for i in indices]
        return MetaTable({k: [v[i] for i in idx] for k, v in self._columns.items()})

    def where(self, mask) -> "MetaTable":
        return self.take(np.flatnonzero(np.asarray(mask, dtype=bool)))

    def with_index(self) -> "MetaTable":
        """An ``index`` column 0..n-1 in front (``reset_index()``)."""
        return MetaTable({"index": list(range(len(self))), **self._columns})

    def to_dict(self) -> Dict[str, List[Any]]:
        return {k: list(v) for k, v in self._columns.items()}


class BaseBOP:
    def __init__(self, root_dir: str, split: str, **kwargs):
        self.root_dir = root_dir
        self.split = split

    # -- scenes ----------------------------------------------------------------

    def load_list_scene(self, split=None) -> None:
        if isinstance(split, str):
            split_folder = osp.join(self.root_dir, split)
            self.list_scenes = sorted(
                osp.join(split_folder, s)
                for s in os.listdir(split_folder)
                if osp.isdir(osp.join(split_folder, s)) and s != "models"
            )
        elif isinstance(split, (list, tuple)):
            self.list_scenes = sorted(
                osp.join(self.root_dir, s if isinstance(s, str) else f"{s:06d}")
                for s in split
                if osp.isdir(osp.join(self.root_dir, s if isinstance(s, str) else f"{s:06d}"))
            )
        else:
            raise NotImplementedError(type(split))
        logging.info("found %d scenes", len(self.list_scenes))

    # -- metaData ---------------------------------------------------------------

    def load_metaData(self, reset_metaData: bool = False, mode: str = "query",
                      split: str = "test", level: int = 2) -> MetaTable:
        """Build (or load the cached) per-object-instance table
        (``baseBOP.py:93-260``), shuffled with seed 2021.  The template
        columns (idx_template, inplane) are filled where a scene has a
        ``template_level{level}.json``, else None."""
        start = time.time()
        if mode == "template":
            rows = [
                {"obj_id": obj_id, "idx_template": i}
                for obj_id in self.obj_ids
                for i in range(len(self.templates_poses))
            ]
            table = MetaTable.from_rows(rows)
        else:
            cache_path = osp.join(self.root_dir, f"{split}_metaData.json")
            if not reset_metaData and osp.exists(cache_path):
                table = MetaTable(load_json(cache_path))
            else:
                table = MetaTable.from_rows(self._scan_scenes(level))
                save_json(cache_path, table.to_dict())
        self.metaData = table.take(np.random.RandomState(_METADATA_SHUFFLE_SEED).permutation(len(table)))
        logging.info("metaData: %d rows in %.2fs", len(self.metaData), time.time() - start)
        return self.metaData

    def _scan_scenes(self, level: int) -> List[Dict]:
        rows: List[Dict] = []
        for scene_path in self.list_scenes:
            scene_id = scene_path.split("/")[-1]
            rgb_paths = sorted(glob.glob(osp.join(scene_path, "rgb", "*.png")))
            mask_paths = set(glob.glob(osp.join(scene_path, "mask", "*.png")))
            mask_visib_paths = set(glob.glob(osp.join(scene_path, "mask_visib", "*.png")))
            depth_paths = set(glob.glob(osp.join(scene_path, "depth", "*.png")))

            meta = {}
            for name in ("scene_gt", "scene_gt_info", "scene_camera"):
                p = osp.join(scene_path, name + ".json")
                meta[name] = load_json(p) if osp.exists(p) else None
            template_path = osp.join(scene_path, f"template_level{level}.json")
            templates_meta = load_json(template_path) if osp.exists(template_path) else None

            for rgb_path in rgb_paths:
                frame_id = int(osp.basename(rgb_path).split(".")[0])
                frame_gt = meta["scene_gt"][str(frame_id)]
                frame_info = (
                    meta["scene_gt_info"][str(frame_id)]
                    if meta["scene_gt_info"] is not None
                    else [{}] * len(frame_gt)
                )
                templates_frame = templates_meta[str(frame_id)] if templates_meta else None
                for idx_obj, gt in enumerate(frame_gt):
                    obj_id = int(gt["obj_id"])
                    pose = combine_R_and_T(gt["cam_R_m2c"], gt["cam_t_m2c"])
                    mask_path = osp.join(scene_path, "mask", f"{frame_id:06d}_{idx_obj:06d}.png")
                    mask_scene = osp.join(scene_path, "mask", f"{frame_id:06d}.png")
                    mask_visib = osp.join(scene_path, "mask_visib", f"{frame_id:06d}_{idx_obj:06d}.png")
                    depth = osp.join(scene_path, "depth", f"{frame_id:06d}.png")
                    info = frame_info[idx_obj] if idx_obj < len(frame_info) else {}
                    rows.append(
                        {
                            "scene_id": scene_id,
                            "frame_id": frame_id,
                            "obj_id": obj_id,
                            "idx_obj": idx_obj,
                            "pose": pose.reshape(-1).tolist(),
                            "rgb_path": rgb_path,
                            "mask_path": (
                                mask_path if mask_path in mask_paths
                                else mask_scene if mask_scene in mask_paths
                                else None
                            ),
                            "mask_visib_path": mask_visib if mask_visib in mask_visib_paths else None,
                            "depth_path": depth if depth in depth_paths else None,
                            "intrinsic": list(meta["scene_camera"][str(frame_id)]["cam_K"]),
                            "visib_fract": info.get("visib_fract", 1.0),
                            "bbox_obj": info.get("bbox_obj"),
                            "bbox_visib": info.get("bbox_visib"),
                            "idx_template": templates_frame[idx_obj]["idx_template"] if templates_frame else None,
                            "inplane": templates_frame[idx_obj]["inplane"] if templates_frame else None,
                        }
                    )
        return rows

    def check_scene(
        self,
        scene_id: str,
        save_path: str,
        n_frames: int = 5,
        points_per_object: int = 500,
        seed: int = 0,
    ) -> List[str]:
        """Debug view of a scene (``baseBOP.py:309-343``): area-sampled CAD
        surface points projected through each instance's GT pose onto
        random frames, one colour per object.  trimesh samples where a
        mesh is loaded, else :mod:`nope_tpu_torch.evaluation.raster`.
        Needs cv2.  Returns the written paths."""
        import cv2

        from nope_tpu_torch.evaluation import raster

        os.makedirs(save_path, exist_ok=True)
        rng = np.random.default_rng(seed)
        scene = self.metaData.where(self.metaData.column("scene_id") == scene_id)
        if not len(scene):
            raise ValueError(f"no metaData rows for scene {scene_id!r}")
        frame_ids = sorted(set(int(f) for f in scene.values("frame_id")))
        chosen = rng.choice(frame_ids, size=min(n_frames, len(frame_ids)), replace=False)
        colors = {cad_id: tuple(int(c) for c in rng.integers(0, 254, 3)) for cad_id in self.cads}
        written: List[str] = []
        for frame_id in chosen:
            fd = scene.where(scene.column("frame_id").astype(np.int64) == int(frame_id))
            img = cv2.imread(str(fd.values("rgb_path")[0]))
            K = np.asarray(fd.values("intrinsic")[0], dtype=np.float64).reshape(3, 3)
            h, w = img.shape[:2]
            for row in fd.rows():
                cad = self.cads[int(row["obj_id"])]
                if cad.get("mesh") is not None:
                    import trimesh

                    pts = trimesh.sample.sample_surface(cad["mesh"], points_per_object)[0]
                else:
                    verts, faces = raster.load_mesh_arrays(cad["cad_path"])
                    pts = raster.sample_surface(verts, faces, points_per_object, rng)
                pose = np.asarray(row["pose"], dtype=np.float64).reshape(4, 4)
                cam = pts @ pose[:3, :3].T + pose[:3, 3]
                front = cam[:, 2] > 1e-6
                uv = cam[front] @ K.T
                uv = (uv[:, :2] / uv[:, 2:3]).astype(int)
                for u, v in uv:
                    if 0 <= u < w and 0 <= v < h:
                        cv2.circle(img, (int(u), int(v)), 1, colors[int(row["obj_id"])], -1)
            out = osp.join(save_path, f"{scene_id}_{int(frame_id)}.png")
            cv2.imwrite(out, img)
            written.append(out)
        return written

    # -- CAD models ---------------------------------------------------------------

    def load_cad(self, cad_name: str = "models") -> Dict[int, Dict]:
        """Model info (diameters) always; trimesh meshes where trimesh
        imports (``baseBOP.py:275-301``)."""
        cad_dir = osp.join(self.root_dir, "models", cad_name)
        models_info = load_json(osp.join(cad_dir, "models_info.json"))
        try:
            import trimesh  # noqa: F401

            from nope_tpu_torch.utils.mesh import load_mesh

            have_trimesh = True
        except Exception:  # not installed, or a broken install: no meshes
            have_trimesh = False
        self.cads: Dict[int, Dict] = {}
        for fname in sorted(os.listdir(cad_dir)):
            if not fname.endswith(".ply") or fname.endswith("_old.ply"):
                continue
            cad_id = int(fname.split(".")[0].replace("obj_", ""))
            cad_path = osp.join(cad_dir, fname)
            mesh = load_mesh(cad_path) if have_trimesh else None
            info = models_info.get(str(cad_id), models_info.get(cad_id))
            self.cads[cad_id] = {"mesh": mesh, "cad_path": cad_path, "model_info": info}
        logging.info("loaded %d CAD entries", len(self.cads))
        return self.cads
