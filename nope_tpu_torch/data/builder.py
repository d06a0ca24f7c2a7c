"""DatasetConfig → dataset and loader construction
(``nope_tpu/data/builder.py``): ShapeNet, Objaverse, the BOP readers
(``tless``/``bop``) and the ``bop_texture`` group of BOP sets, on the
thread loader (``machine.loader=threads``) or the grain loader
(``machine.loader=grain``, :mod:`nope_tpu_torch.data.grain_pipeline`).
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Dict

from nope_tpu_torch.configs.config import DatasetConfig, ExperimentConfig
from nope_tpu_torch.data.pipeline import ConcatDataset, DataLoader, make_native_collate
from nope_tpu_torch.data.shapenet import NativeCollateView, ShapeNetDataset


def build_dataset(cfg: DatasetConfig):
    if cfg.name == "shapeNet":
        return ShapeNetDataset(
            root_dir=cfg.root_dir,
            split=cfg.split or "training",
            pose_distribution=cfg.pose_distribution,
            rot_representation=cfg.rot_representation,
            fast_evaluation=cfg.fast_evaluation,
            img_size=cfg.img_size,
            load_gt_templates=cfg.load_gt_templates,
            wire_dtype=getattr(cfg, "wire_dtype", "float32"),
            cache_crops=getattr(cfg, "cache_crops", False),
        )
    if cfg.name == "objaverse":
        from nope_tpu_torch.data.objaverse import ObjaverseDataset

        return ObjaverseDataset(
            root_dir=cfg.root_dir,
            img_size=cfg.img_size,
            rot_representation=cfg.rot_representation,
        )
    if cfg.name in ("tless", "bop"):
        from nope_tpu_torch.data.bop import BOPDataset

        return BOPDataset(
            root_dir=cfg.root_dir,
            template_dir=cfg.template_dir,
            split=cfg.split or "test",
            obj_ids=cfg.obj_ids,
            img_size=cfg.img_size,
            reset_metaData=cfg.reset_metaData,
            pose_distribution=cfg.pose_distribution,
            rot_representation=cfg.rot_representation,
            **cfg.extra,
        )
    raise ValueError(f"unknown dataset {cfg.name!r}")


def _detect_train_split(root_dir: str) -> str:
    """The single train/val split folder of a BOP dataset (the
    reference's train.py:78-91)."""
    splits = [
        s
        for s in os.listdir(root_dir)
        if os.path.isdir(os.path.join(root_dir, s)) and (s.startswith("train") or s.startswith("val"))
    ]
    if len(splits) != 1:
        raise ValueError(f"expected exactly one train/val split in {root_dir}, got {splits}")
    return splits[0]


def build_bop_texture_group(cfg: ExperimentConfig, group: DatasetConfig) -> ConcatDataset:
    """The ``bop_texture`` group: its member BOP datasets, named in
    ``group.extra['members']`` as entries of cfg.data.datasets, each on
    its single train/val split, concatenated (train.py:73-98)."""
    datasets = []
    for member in group.extra.get("members", []):
        m_cfg = dataclasses.replace(cfg.data.datasets[member])
        m_cfg.split = _detect_train_split(m_cfg.root_dir)
        m_cfg.reset_metaData = False
        datasets.append(build_dataset(m_cfg))
    return ConcatDataset(datasets)


def build_train_loaders(cfg: ExperimentConfig) -> Dict[str, DataLoader]:
    """Training loaders for each name in cfg.train_data_name, with the
    reference's split fixups (train.py:64-121)."""
    loaders: Dict[str, DataLoader] = {}
    for name in cfg.train_data_name:
        ds_cfg = cfg.data.datasets[name]
        if name == "shapeNet":
            ds_cfg.split = "training"
        if name in ("tless", "bop") and not ds_cfg.split:
            # the reference's train.py:70-71 never fills the split its
            # BOPDataset requires: take the single train/val folder
            # (train_primesense for T-LESS) rather than 'test'
            ds_cfg.split = _detect_train_split(ds_cfg.root_dir)
        if name == "bop_texture":
            dataset = build_bop_texture_group(cfg, ds_cfg)
        else:
            dataset = build_dataset(ds_cfg)
        loader_kind = getattr(cfg.machine, "loader", "threads")
        if loader_kind not in ("threads", "grain"):
            # fail fast: a typo here would silently fall back to the thread
            # loader (no record shard per rank), so every rank would read
            # the whole dataset
            raise ValueError(f"machine.loader={loader_kind!r}: expected 'threads' or 'grain'")
        use_grain = loader_kind == "grain"
        collate_fn = post_batch_fn = None
        if ds_cfg.native_preprocess and getattr(ds_cfg, "wire_dtype", "float32") == "uint8":
            # the C++ fused path bakes normalization into its output;
            # the uint8 wire wants it deferred to the device
            raise ValueError(
                "native_preprocess and wire_dtype='uint8' are mutually "
                "exclusive (the native batch op emits normalized f32)"
            )
        if ds_cfg.native_preprocess and name == "shapeNet":
            dataset = NativeCollateView(dataset)
            if use_grain:
                from nope_tpu_torch.data.grain_pipeline import make_native_post_batch

                post_batch_fn = make_native_post_batch(ds_cfg.img_size)
            else:
                collate_fn = make_native_collate(ds_cfg.img_size)
            logging.info("native fused preprocessing enabled for %s", name)
        if use_grain:
            from nope_tpu_torch.data.grain_pipeline import GrainLoader

            # machine.batch_size is the step's global batch on either loader
            # (GrainLoader's docstring)
            loaders[name] = GrainLoader(
                dataset,
                batch_size=cfg.machine.batch_size,
                shuffle=True,
                num_workers=cfg.machine.num_workers,
                shard_by_process=True,
                post_batch_fn=post_batch_fn,
            )
        else:
            loaders[name] = DataLoader(
                dataset,
                batch_size=cfg.machine.batch_size,
                shuffle=True,
                num_workers=cfg.machine.num_workers,
                collate_fn=collate_fn,
            )
        logging.info("train loader %s: %d batches", name, len(loaders[name]))
    return loaders


def build_val_loaders(cfg: ExperimentConfig) -> Dict[str, DataLoader]:
    loaders: Dict[str, DataLoader] = {}
    for name in cfg.test_data_name:
        ds_cfg = cfg.data.datasets[name]
        if name == "shapeNet":
            ds_cfg.split = "unseen_training"
        dataset = build_dataset(ds_cfg)
        loaders[name] = DataLoader(
            dataset,
            batch_size=cfg.machine.batch_size,
            shuffle=False,
            num_workers=cfg.machine.num_workers,
        )
        logging.info("val loader %s: %d batches", name, len(loaders[name]))
    return loaders
