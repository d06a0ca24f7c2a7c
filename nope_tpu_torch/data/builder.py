"""DatasetConfig → dataset and loader construction
(``nope_tpu/data/builder.py``), for ShapeNet on the thread loader.

The Objaverse and BOP readers (``objaverse``, ``tless``/``bop`` and the
``bop_texture`` group) come with ROADMAP queue 1 item 14; the ``grain``
loader is not ported (ROADMAP "Not ported": the thread loader does the
same job).  Each raises ``NotImplementedError`` naming that.
"""

from __future__ import annotations

import logging
from typing import Dict

from nope_tpu_torch.configs.config import DatasetConfig, ExperimentConfig
from nope_tpu_torch.data.pipeline import DataLoader, make_native_collate
from nope_tpu_torch.data.shapenet import NativeCollateView, ShapeNetDataset

_LATER = ("objaverse", "tless", "bop", "bop_texture")


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
    if cfg.name in _LATER:
        raise NotImplementedError(
            f"dataset {cfg.name!r}: the Objaverse and BOP readers come with ROADMAP queue 1 item 14")
    raise ValueError(f"unknown dataset {cfg.name!r}")


def _check_loader_kind(cfg: ExperimentConfig) -> None:
    loader_kind = getattr(cfg.machine, "loader", "threads")
    if loader_kind not in ("threads", "grain"):
        # fail fast: a typo here would silently fall back to another loader
        raise ValueError(f"machine.loader={loader_kind!r}: expected 'threads' or 'grain'")
    if loader_kind == "grain":
        raise NotImplementedError(
            "machine.loader='grain' is not ported (ROADMAP 'Not ported'); use machine.loader=threads")


def build_train_loaders(cfg: ExperimentConfig) -> Dict[str, DataLoader]:
    """Training loaders for each name in cfg.train_data_name, with the
    reference's split fixups (train.py:64-121)."""
    loaders: Dict[str, DataLoader] = {}
    for name in cfg.train_data_name:
        ds_cfg = cfg.data.datasets[name]
        if name == "bop_texture":
            raise NotImplementedError(
                "the 'bop_texture' group: the BOP readers come with ROADMAP queue 1 item 14")
        if name == "shapeNet":
            ds_cfg.split = "training"
        dataset = build_dataset(ds_cfg)
        _check_loader_kind(cfg)
        collate_fn = None
        if ds_cfg.native_preprocess and getattr(ds_cfg, "wire_dtype", "float32") == "uint8":
            # the C++ fused path bakes normalization into its output;
            # the uint8 wire wants it deferred to the device
            raise ValueError(
                "native_preprocess and wire_dtype='uint8' are mutually "
                "exclusive (the native batch op emits normalized f32)"
            )
        if ds_cfg.native_preprocess and name == "shapeNet":
            dataset = NativeCollateView(dataset)
            collate_fn = make_native_collate(ds_cfg.img_size)
            logging.info("native fused preprocessing enabled for %s", name)
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
